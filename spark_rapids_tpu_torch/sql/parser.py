"""Recursive-descent SQL parser: SELECT statements -> AST dataclasses.

Counterpart of ``spark_rapids_tpu/sql/parser.py``, copied unchanged (the
port keeps its own copy of this pure-Python module rather than import
the JAX package), so both packages parse a statement into equal trees.

Hand-rolled (no parser library in the image) with a conventional
precedence ladder: OR < AND < NOT < comparison/IS/IN/BETWEEN/LIKE <
additive < multiplicative < unary < primary.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------- AST --


@dataclasses.dataclass
class Lit:
    value: object
    kind: str = "plain"  # plain | date | timestamp


@dataclasses.dataclass
class ColRef:
    parts: Tuple[str, ...]  # ("t", "c") or ("c",)


@dataclasses.dataclass
class Star:
    table: Optional[str] = None


@dataclasses.dataclass
class BinOp:
    op: str
    left: object
    right: object


@dataclasses.dataclass
class UnOp:
    op: str  # '-', 'NOT'
    child: object


@dataclasses.dataclass
class IsNull:
    child: object
    negated: bool


@dataclasses.dataclass
class Between:
    child: object
    lo: object
    hi: object
    negated: bool


@dataclasses.dataclass
class InList:
    child: object
    items: List[object]
    negated: bool


@dataclasses.dataclass
class InSubquery:
    child: object
    query: "SelectStmt"
    negated: bool


@dataclasses.dataclass
class ScalarSubquery:
    query: "SelectStmt"


@dataclasses.dataclass
class LikeOp:
    child: object
    pattern: str
    negated: bool


@dataclasses.dataclass
class FuncCall:
    name: str
    args: List[object]
    distinct: bool = False
    window: Optional["WindowDef"] = None


@dataclasses.dataclass
class WindowDef:
    partition_by: List[object]
    order_by: List["OrderItem"]
    rows: Optional[Tuple[Optional[int], Optional[int]]] = None


@dataclasses.dataclass
class CaseExpr:
    whens: List[Tuple[object, object]]
    else_: Optional[object]


@dataclasses.dataclass
class CastExpr:
    child: object
    type_name: str


@dataclasses.dataclass
class Projection:
    expr: object
    alias: Optional[str]


@dataclasses.dataclass
class OrderItem:
    expr: object
    desc: bool = False
    nulls_first: Optional[bool] = None


@dataclasses.dataclass
class TableRef:
    name: str
    alias: Optional[str]


@dataclasses.dataclass
class SubqueryRef:
    query: "SelectStmt"
    alias: str


@dataclasses.dataclass
class JoinClause:
    how: str  # inner/left/right/full/semi/anti/cross
    right: object  # TableRef | SubqueryRef
    on: Optional[object] = None
    using: Optional[List[str]] = None


@dataclasses.dataclass
class SelectStmt:
    projections: List[Projection]
    from_: Optional[object]  # TableRef | SubqueryRef | None
    joins: List[JoinClause]
    where: Optional[object]
    group_by: List[object]
    having: Optional[object]
    order_by: List[OrderItem]
    limit: Optional[int]
    distinct: bool
    union_all: Optional["SelectStmt"] = None
    # ROLLUP/CUBE/GROUPING SETS: per output replica, the indices into
    # group_by that stay live (None = plain GROUP BY)
    group_sets: Optional[List[List[int]]] = None


# -------------------------------------------------------------------- lexer --

_TOKEN_RE = re.compile(r"""
    \s+
  | (?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<ident>[A-Za-z_][A-Za-z_0-9]*|`[^`]+`)
  | (?P<op><>|!=|>=|<=|=|<|>|\|\||[-+*/%(),.])
""", re.VERBOSE)

KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having",
    "order", "limit", "as", "and", "or", "not", "in", "is", "null",
    "like", "between", "case", "when", "then", "else", "end", "cast",
    "join", "inner", "left", "right", "full", "outer", "semi", "anti",
    "cross", "on", "using", "union", "all", "true", "false", "asc",
    "desc", "nulls", "first", "last", "date", "timestamp", "interval",
    "over", "partition", "rows", "unbounded", "preceding", "following",
    "current", "row", "with",
}


class Token:
    __slots__ = ("kind", "value")

    def __init__(self, kind, value):
        self.kind = kind  # num | str | ident | kw | op | eof
        self.value = value

    def __repr__(self):
        return f"{self.kind}:{self.value}"


def tokenize(text: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ValueError(
                f"SQL syntax error at {text[pos:pos + 20]!r}")
        pos = m.end()
        if m.lastgroup is None:
            continue
        v = m.group(m.lastgroup)
        if m.lastgroup == "num":
            out.append(Token("num", v))
        elif m.lastgroup == "str":
            out.append(Token("str", v[1:-1].replace("''", "'")))
        elif m.lastgroup == "ident":
            if v.startswith("`"):
                out.append(Token("ident", v[1:-1]))
            elif v.lower() in KEYWORDS:
                out.append(Token("kw", v.lower()))
            else:
                out.append(Token("ident", v))
        else:
            out.append(Token("op", v))
    out.append(Token("eof", ""))
    return out


# ------------------------------------------------------------------- parser --


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    # -- token helpers -----------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def advance(self) -> Token:
        t = self.cur
        self.i += 1
        return t

    def at_kw(self, *kws) -> bool:
        return self.cur.kind == "kw" and self.cur.value in kws

    def eat_kw(self, *kws) -> bool:
        if self.at_kw(*kws):
            self.advance()
            return True
        return False

    def expect_kw(self, kw):
        if not self.eat_kw(kw):
            raise ValueError(f"expected {kw.upper()}, got {self.cur}")

    def at_op(self, *ops) -> bool:
        return self.cur.kind == "op" and self.cur.value in ops

    def eat_op(self, *ops) -> bool:
        if self.at_op(*ops):
            self.advance()
            return True
        return False

    def expect_op(self, op):
        if not self.eat_op(op):
            raise ValueError(f"expected {op!r}, got {self.cur}")

    def ident(self) -> str:
        if self.cur.kind == "ident":
            return self.advance().value
        # non-reserved keywords usable as identifiers in practice
        if self.cur.kind == "kw" and self.cur.value in (
                "date", "timestamp", "first", "last", "left", "right",
                "row", "rows"):
            return self.advance().value
        raise ValueError(f"expected identifier, got {self.cur}")

    # -- statements --------------------------------------------------------
    def parse(self) -> SelectStmt:
        ctes: Dict[str, SelectStmt] = {}
        if self.eat_kw("with"):
            # non-recursive CTEs, substituted as derived tables at parse
            # time (each reference gets its own deep copy: the resolver
            # mutates ASTs in place when lifting aggregates)
            while True:
                name = self.ident().lower()
                self.expect_kw("as")
                self.expect_op("(")
                q = self.select_stmt()
                self.expect_op(")")
                if name in ctes:
                    raise ValueError(f"duplicate CTE name {name!r}")
                _substitute_ctes(q, ctes)  # earlier CTEs visible here
                ctes[name] = q
                if not self.eat_op(","):
                    break
        stmt = self.select_stmt()
        if self.cur.kind != "eof":
            raise ValueError(f"unexpected trailing input at {self.cur}")
        if ctes:
            _substitute_ctes(stmt, ctes)
        return stmt

    def select_stmt(self) -> SelectStmt:
        self.expect_kw("select")
        distinct = self.eat_kw("distinct")
        projections = [self.projection()]
        while self.eat_op(","):
            projections.append(self.projection())
        from_ = None
        joins: List[JoinClause] = []
        if self.eat_kw("from"):
            from_ = self.from_item()
            while True:
                j = self.join_clause()
                if j is None:
                    break
                joins.append(j)
        where = self.expr() if self.eat_kw("where") else None
        group_by: List[object] = []
        group_sets: Optional[List[List[int]]] = None
        if self.eat_kw("group"):
            self.expect_kw("by")
            # ROLLUP/CUBE/GROUPING are contextual (not reserved): they
            # only take effect as the head of the GROUP BY list followed
            # by "(", so columns named rollup/cube/grouping still work
            if (self.cur.kind == "ident"
                    and self.cur.value.lower() in ("rollup", "cube")
                    and self.i + 1 < len(self.toks)
                    and self.toks[self.i + 1].kind == "op"
                    and self.toks[self.i + 1].value == "("):
                kind = self.advance().value.lower()
                self.expect_op("(")
                group_by.append(self.expr())
                while self.eat_op(","):
                    group_by.append(self.expr())
                self.expect_op(")")
                n = len(group_by)
                if kind == "rollup":
                    group_sets = [list(range(k))
                                  for k in range(n, -1, -1)]
                else:
                    group_sets = [
                        [i for i in range(n) if m & (1 << (n - 1 - i))]
                        for m in range((1 << n) - 1, -1, -1)]
            elif (self.cur.kind == "ident"
                  and self.cur.value.lower() == "grouping"
                  and self.i + 1 < len(self.toks)
                  and self.toks[self.i + 1].kind == "ident"
                  and self.toks[self.i + 1].value.lower() == "sets"):
                self.advance()  # GROUPING (contextual, stays a valid
                self.advance()  # function name elsewhere) + SETS
                self.expect_op("(")
                group_sets = []
                key_reprs: List[str] = []
                while True:
                    self.expect_op("(")
                    one: List[int] = []
                    if not self.at_op(")"):
                        while True:
                            e = self.expr()
                            r = repr(e)
                            if r not in key_reprs:
                                key_reprs.append(r)
                                group_by.append(e)
                            one.append(key_reprs.index(r))
                            if not self.eat_op(","):
                                break
                    self.expect_op(")")
                    group_sets.append(one)
                    if not self.eat_op(","):
                        break
                self.expect_op(")")
            else:
                group_by.append(self.expr())
                while self.eat_op(","):
                    group_by.append(self.expr())
        having = self.expr() if self.eat_kw("having") else None
        order_by: List[OrderItem] = []
        if self.eat_kw("order"):
            self.expect_kw("by")
            order_by.append(self.order_item())
            while self.eat_op(","):
                order_by.append(self.order_item())
        limit = None
        if self.eat_kw("limit"):
            limit = int(self.advance().value)
        union_all = None
        if self.eat_kw("union"):
            self.expect_kw("all")
            union_all = self.select_stmt()
        return SelectStmt(projections, from_, joins, where, group_by,
                          having, order_by, limit, distinct, union_all,
                          group_sets=group_sets)

    def projection(self) -> Projection:
        if self.at_op("*"):
            self.advance()
            return Projection(Star(), None)
        e = self.expr()
        alias = None
        if self.eat_kw("as"):
            alias = self.ident()
        elif self.cur.kind == "ident":
            alias = self.advance().value
        return Projection(e, alias)

    def from_item(self):
        if self.eat_op("("):
            q = self.select_stmt()
            self.expect_op(")")
            self.eat_kw("as")
            return SubqueryRef(q, self.ident())
        name = self.ident()
        alias = None
        if self.eat_kw("as"):
            alias = self.ident()
        elif self.cur.kind == "ident":
            alias = self.advance().value
        return TableRef(name, alias)

    def join_clause(self) -> Optional[JoinClause]:
        how = None
        if self.eat_kw("join"):
            how = "inner"
        elif self.at_kw("inner", "left", "right", "full", "cross"):
            kw = self.advance().value
            if kw == "left" and self.at_kw("semi", "anti"):
                kw = self.advance().value
            elif kw in ("left", "right", "full"):
                self.eat_kw("outer")
            self.expect_kw("join")
            how = {"inner": "inner", "left": "left", "right": "right",
                   "full": "full", "semi": "semi", "anti": "anti",
                   "cross": "cross"}[kw]
        else:
            return None
        right = self.from_item()
        on = None
        using = None
        if self.eat_kw("on"):
            on = self.expr()
        elif self.eat_kw("using"):
            self.expect_op("(")
            using = [self.ident()]
            while self.eat_op(","):
                using.append(self.ident())
            self.expect_op(")")
        return JoinClause(how, right, on, using)

    def order_item(self) -> OrderItem:
        e = self.expr()
        desc = False
        if self.eat_kw("asc"):
            pass
        elif self.eat_kw("desc"):
            desc = True
        nulls_first = None
        if self.eat_kw("nulls"):
            if self.eat_kw("first"):
                nulls_first = True
            else:
                self.expect_kw("last")
                nulls_first = False
        return OrderItem(e, desc, nulls_first)

    # -- expressions -------------------------------------------------------
    def expr(self):
        return self.or_expr()

    def or_expr(self):
        e = self.and_expr()
        while self.eat_kw("or"):
            e = BinOp("or", e, self.and_expr())
        return e

    def and_expr(self):
        e = self.not_expr()
        while self.eat_kw("and"):
            e = BinOp("and", e, self.not_expr())
        return e

    def not_expr(self):
        if self.eat_kw("not"):
            return UnOp("NOT", self.not_expr())
        return self.predicate()

    def predicate(self):
        e = self.additive()
        while True:
            if self.cur.kind == "op" and self.cur.value in (
                    "=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.advance().value
                e = BinOp(op, e, self.additive())
                continue
            if self.at_kw("is"):
                self.advance()
                negated = self.eat_kw("not")
                self.expect_kw("null")
                e = IsNull(e, negated)
                continue
            negated = False
            if self.at_kw("not") and self.toks[self.i + 1].kind == "kw" \
                    and self.toks[self.i + 1].value in (
                        "between", "in", "like"):
                self.advance()
                negated = True
            if self.eat_kw("between"):
                lo = self.additive()
                self.expect_kw("and")
                hi = self.additive()
                e = Between(e, lo, hi, negated)
                continue
            if self.eat_kw("in"):
                self.expect_op("(")
                if self.at_kw("select"):
                    q = self.select_stmt()
                    self.expect_op(")")
                    e = InSubquery(e, q, negated)
                    continue
                items = [self.expr()]
                while self.eat_op(","):
                    items.append(self.expr())
                self.expect_op(")")
                e = InList(e, items, negated)
                continue
            if self.eat_kw("like"):
                pat = self.advance()
                if pat.kind != "str":
                    raise ValueError("LIKE needs a string literal")
                e = LikeOp(e, pat.value, negated)
                continue
            if negated:
                raise ValueError(f"unexpected NOT at {self.cur}")
            return e

    def additive(self):
        e = self.multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.advance().value
                e = BinOp(op, e, self.multiplicative())
            elif self.at_op("||"):
                self.advance()
                e = FuncCall("concat", [e, self.multiplicative()])
            else:
                return e

    def multiplicative(self):
        e = self.unary()
        while self.at_op("*", "/", "%"):
            op = self.advance().value
            e = BinOp(op, e, self.unary())
        return e

    def unary(self):
        if self.eat_op("-"):
            return UnOp("-", self.unary())
        if self.eat_op("+"):
            return self.unary()
        return self.primary()

    def primary(self):
        t = self.cur
        if t.kind == "num":
            self.advance()
            is_float = "." in t.value or "e" in t.value.lower()
            return Lit(float(t.value) if is_float else int(t.value))
        if t.kind == "str":
            self.advance()
            return Lit(t.value)
        if self.at_kw("true"):
            self.advance()
            return Lit(True)
        if self.at_kw("false"):
            self.advance()
            return Lit(False)
        if self.at_kw("null"):
            self.advance()
            return Lit(None)
        if self.at_kw("date"):
            # DATE 'yyyy-mm-dd'
            if self.toks[self.i + 1].kind == "str":
                self.advance()
                return Lit(self.advance().value, kind="date")
            return ColRef((self.ident(),))
        if self.at_kw("timestamp"):
            if self.toks[self.i + 1].kind == "str":
                self.advance()
                return Lit(self.advance().value, kind="timestamp")
            return ColRef((self.ident(),))
        if self.at_kw("interval"):
            raise ValueError("INTERVAL literals are not supported; "
                             "use date_add/date_sub")
        if self.at_kw("case"):
            return self.case_expr()
        if self.at_kw("cast"):
            self.advance()
            self.expect_op("(")
            child = self.expr()
            self.expect_kw("as")
            tname = self.type_name()
            self.expect_op(")")
            return CastExpr(child, tname)
        if self.eat_op("("):
            if self.at_kw("select"):
                # uncorrelated scalar subquery: one row, one column
                q = self.select_stmt()
                self.expect_op(")")
                return ScalarSubquery(q)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind in ("ident", "kw"):
            name = self.ident()
            if self.at_op("("):
                return self.func_call(name)
            parts = [name]
            while self.at_op(".") and (
                    self.toks[self.i + 1].kind in ("ident", "kw")
                    or self.toks[self.i + 1].value == "*"):
                self.advance()
                if self.at_op("*"):
                    self.advance()
                    return Star(table=parts[0])
                parts.append(self.ident())
            return ColRef(tuple(parts))
        raise ValueError(f"unexpected token {t}")

    def type_name(self) -> str:
        base = self.ident().lower()
        if self.eat_op("("):
            args = [self.advance().value]
            while self.eat_op(","):
                args.append(self.advance().value)
            self.expect_op(")")
            return f"{base}({','.join(args)})"
        return base

    def case_expr(self) -> CaseExpr:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.expr()  # CASE x WHEN v THEN ...
        whens = []
        while self.eat_kw("when"):
            cond = self.expr()
            if operand is not None:
                cond = BinOp("=", operand, cond)
            self.expect_kw("then")
            whens.append((cond, self.expr()))
        else_ = self.expr() if self.eat_kw("else") else None
        self.expect_kw("end")
        return CaseExpr(whens, else_)

    def func_call(self, name: str) -> FuncCall:
        self.expect_op("(")
        distinct = False
        args: List[object] = []
        if self.at_op("*"):
            self.advance()
            args.append(Star())
        elif not self.at_op(")"):
            distinct = self.eat_kw("distinct")
            args.append(self.expr())
            while self.eat_op(","):
                args.append(self.expr())
        self.expect_op(")")
        window = None
        if self.eat_kw("over"):
            window = self.window_def()
        return FuncCall(name.lower(), args, distinct, window)

    def window_def(self) -> WindowDef:
        self.expect_op("(")
        partition: List[object] = []
        orders: List[OrderItem] = []
        rows = None
        if self.eat_kw("partition"):
            self.expect_kw("by")
            partition.append(self.expr())
            while self.eat_op(","):
                partition.append(self.expr())
        if self.eat_kw("order"):
            self.expect_kw("by")
            orders.append(self.order_item())
            while self.eat_op(","):
                orders.append(self.order_item())
        if self.eat_kw("rows"):
            self.expect_kw("between")
            rows = (self.frame_bound(), None)
            self.expect_kw("and")
            rows = (rows[0], self.frame_bound())
        self.expect_op(")")
        return WindowDef(partition, orders, rows)

    def frame_bound(self) -> Optional[int]:
        if self.eat_kw("unbounded"):
            if not self.eat_kw("preceding"):
                self.expect_kw("following")
            return None
        if self.eat_kw("current"):
            self.expect_kw("row")
            return 0
        n = int(self.advance().value)
        if self.eat_kw("preceding"):
            return -n
        self.expect_kw("following")
        return n


def _substitute_ctes(node, ctes: Dict[str, SelectStmt]) -> None:
    """Replace TableRefs naming a CTE with SubqueryRef copies, walking
    every nested SelectStmt (joins, derived tables, IN/scalar
    subqueries, UNION ALL branches)."""
    import copy

    def sub_table(ref):
        if isinstance(ref, TableRef) and ref.name.lower() in ctes:
            return SubqueryRef(copy.deepcopy(ctes[ref.name.lower()]),
                               ref.alias or ref.name)
        if isinstance(ref, SubqueryRef):
            _substitute_ctes(ref.query, ctes)
        return ref

    def walk_expr(e):
        if isinstance(e, (InSubquery,)):
            _substitute_ctes(e.query, ctes)
        elif isinstance(e, ScalarSubquery):
            _substitute_ctes(e.query, ctes)
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, list):
                for x in v:
                    if hasattr(x, "__dataclass_fields__"):
                        walk_expr(x)
            elif hasattr(v, "__dataclass_fields__") and \
                    not isinstance(v, SelectStmt):
                walk_expr(v)

    stmt = node
    while stmt is not None:
        stmt.from_ = sub_table(stmt.from_) if stmt.from_ is not None \
            else None
        for j in stmt.joins:
            j.right = sub_table(j.right)
            if j.on is not None:
                walk_expr(j.on)
        for p in stmt.projections:
            if hasattr(p.expr, "__dataclass_fields__"):
                walk_expr(p.expr)
        if stmt.where is not None:
            walk_expr(stmt.where)
        if stmt.having is not None:
            walk_expr(stmt.having)
        stmt = stmt.union_all


def parse(text: str) -> SelectStmt:
    return Parser(tokenize(text)).parse()
