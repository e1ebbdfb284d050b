"""Date and time expressions: integer math on int32 days and int64
microseconds.

Counterpart of ``spark_rapids_tpu/ops/datetime_ops.py``: the date parts
(``Year`` ... ``DayOfYear``, ``Quarter``, ``DayOfWeek``, ``WeekDay``)
through the civil-from-days algorithm (branch-free integer math,
proleptic Gregorian, UTC as in the JAX package), ``LastDay``,
``NextDay``, ``Hour``/``Minute``/``Second``, date arithmetic
(``DateAdd``, ``DateSub``, ``DateDiff``, ``AddMonths``,
``MonthsBetween``), ``TruncDate``, epoch seconds (``UnixTimestamp``,
``ToUnixTimestamp``, ``FromUnixTime``), ``TimeAdd`` and
``DateFormatClass`` over its fixed-width pattern subset, and
``TimeWindow`` (the edges of ``F.window``'s (start, end) struct).  A
timestamp reads as its UTC day; a date meets the time functions at
midnight.

Where the JAX package departs from Spark the port keeps Spark's answer
(``ROADMAP.md`` queue 3): ``months_between`` takes Spark's end-of-month
rule, the seconds within the day and the rounding to 8 digits (the JAX
package divides the day difference by 31); ``next_day`` reads only the
two-letter, three-letter and full day names (else null);
``from_unixtime`` returns Spark's 'yyyy-MM-dd HH:mm:ss' string (the JAX
package returns a timestamp); ``trunc`` with an unknown format is null.
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch.columnar import dtypes as dts
from spark_rapids_tpu_torch.ops.cast import US_PER_DAY, US_PER_SEC
from spark_rapids_tpu_torch.ops.expressions import (
    BinaryExpression, ColVal, EmitContext, Expression, UnaryExpression,
    combine_validity)


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day), int64."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097                                  # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                             # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                     # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                 # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y, m, d):
    """(year, month, day) -> days since 1970-01-01 (proleptic
    Gregorian), int64."""
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = 365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _month_days(y, m):
    one = torch.ones_like(m)
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, one, m + 1)
    return _days_from_civil(ny, nm, one) - _days_from_civil(y, m, one)


def _to_days(c: ColVal) -> torch.Tensor:
    if c.dtype.is_timestamp:
        return _fdiv(c.values, US_PER_DAY)
    return c.values.to(torch.int64)


def _to_micros(c: ColVal) -> torch.Tensor:
    if c.dtype.is_date:
        return c.values.to(torch.int64) * US_PER_DAY
    return c.values.to(torch.int64)


class _DatePart(UnaryExpression):
    @property
    def dtype(self):
        return dts.INT32

    def eval_values(self, v, cv):
        days = _to_days(cv)
        y, m, d = _civil_from_days(days)
        return self.part(y, m, d, days).to(torch.int32)


class Year(_DatePart):
    def part(self, y, m, d, days):
        return y


class Month(_DatePart):
    def part(self, y, m, d, days):
        return m


class DayOfMonth(_DatePart):
    def part(self, y, m, d, days):
        return d


class Quarter(_DatePart):
    def part(self, y, m, d, days):
        return _fdiv(m - 1, 3) + 1


class DayOfWeek(_DatePart):
    """1 = Sunday ... 7 = Saturday."""

    def part(self, y, m, d, days):
        return torch.remainder(days + 4, 7) + 1


class WeekDay(_DatePart):
    """0 = Monday ... 6 = Sunday."""

    def part(self, y, m, d, days):
        return torch.remainder(days + 3, 7)


class DayOfYear(_DatePart):
    def part(self, y, m, d, days):
        one = torch.ones_like(m)
        return days - _days_from_civil(y, one, one) + 1


class LastDay(UnaryExpression):
    """The month's last day, as a date."""

    @property
    def dtype(self):
        return dts.DATE32

    def eval_values(self, v, cv):
        y, m, d = _civil_from_days(_to_days(cv))
        one = torch.ones_like(m)
        return (_days_from_civil(y, m, one) + _month_days(y, m) - 1).to(
            torch.int32)


# Monday = 0 ... Sunday = 6, under each name Spark reads
_DOW_NAMES = {}
for _i, _full in enumerate(("MONDAY", "TUESDAY", "WEDNESDAY", "THURSDAY",
                            "FRIDAY", "SATURDAY", "SUNDAY")):
    for _name in (_full[:2], _full[:3], _full):
        _DOW_NAMES[_name] = _i


class NextDay(UnaryExpression):
    """next_day(date, dow): the first later date on that weekday; the day
    is a literal name (two letters, three, or in full, any case), any
    other name gives null."""

    def __init__(self, child, day_of_week: str):
        super().__init__(child)
        self.day_of_week = str(day_of_week)
        self.target = _DOW_NAMES.get(self.day_of_week.upper())

    def with_children(self, children):
        return NextDay(children[0], self.day_of_week)

    def cache_key(self):
        return ("NextDay", self.day_of_week, self.child.cache_key())

    @property
    def dtype(self):
        return dts.DATE32

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        days = _to_days(c)
        if self.target is None:
            shape = days.shape
            return ColVal(dts.DATE32,
                          torch.zeros(shape, dtype=torch.int32,
                                      device=ctx.device),
                          torch.zeros(shape, dtype=torch.bool,
                                      device=ctx.device))
        dow = torch.remainder(days + 3, 7)      # 1970-01-01 was a Thursday
        ahead = torch.remainder(self.target - dow + 7, 7)
        ahead = torch.where(ahead == 0, 7, ahead)
        return ColVal(dts.DATE32, (days + ahead).to(torch.int32),
                      c.validity)


class _TimePart(UnaryExpression):
    """A field of the time of day (a date reads as midnight)."""

    unit = 1
    modulus = 1

    @property
    def dtype(self):
        return dts.INT32

    def eval_values(self, v, cv):
        us = torch.remainder(_to_micros(cv), self.modulus)
        return _fdiv(us, self.unit).to(torch.int32)


class Hour(_TimePart):
    unit = 3_600_000_000
    modulus = US_PER_DAY


class Minute(_TimePart):
    unit = 60_000_000
    modulus = 3_600_000_000


class Second(_TimePart):
    unit = US_PER_SEC
    modulus = 60_000_000


class _DateShift(BinaryExpression):
    """date plus or minus n days, as a DATE."""
    sign = 1

    @property
    def dtype(self):
        return dts.DATE32

    def emit(self, ctx: EmitContext) -> ColVal:
        l = self.left.emit(ctx)
        r = self.right.emit(ctx)
        out = _to_days(l).to(torch.int32) + \
            self.sign * r.values.to(torch.int32)
        return ColVal(dts.DATE32, out,
                      combine_validity(l.validity, r.validity))


class DateAdd(_DateShift):
    sign = 1


class DateSub(_DateShift):
    sign = -1


class DateDiff(BinaryExpression):
    """datediff(end, start) in days."""

    @property
    def dtype(self):
        return dts.INT32

    def emit(self, ctx: EmitContext) -> ColVal:
        l = self.left.emit(ctx)
        r = self.right.emit(ctx)
        return ColVal(dts.INT32, (_to_days(l) - _to_days(r)).to(torch.int32),
                      combine_validity(l.validity, r.validity))


class AddMonths(BinaryExpression):
    """add_months(date, n): the day kept, cut to the target month's
    length."""

    @property
    def dtype(self):
        return dts.DATE32

    def emit(self, ctx: EmitContext) -> ColVal:
        l = self.left.emit(ctx)
        r = self.right.emit(ctx)
        y, m, d = _civil_from_days(_to_days(l))
        months = y * 12 + (m - 1) + r.values.to(torch.int64)
        ny = _fdiv(months, 12)
        nm = torch.remainder(months, 12) + 1
        nd = torch.minimum(d, _month_days(ny, nm))
        out = _days_from_civil(ny, nm, nd).to(torch.int32)
        return ColVal(dts.DATE32, out,
                      combine_validity(l.validity, r.validity))


def _exact_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    # a tensor divisor: CUDA multiplies by a Python scalar's reciprocal
    return x / torch.tensor(divisor, dtype=x.dtype, device=x.device)


class MonthsBetween(BinaryExpression):
    """months_between(a, b): whole months when the days of month are
    equal or both are their month's last day, else the month difference
    plus the difference in seconds over 31 days, rounded to 8 digits
    (Spark's ``DateTimeUtils.monthsBetween``, UTC)."""

    def __init__(self, left: Expression, right: Expression,
                 round_off: bool = True):
        super().__init__(left, right)
        self.round_off = round_off

    def with_children(self, children):
        return MonthsBetween(children[0], children[1], self.round_off)

    def cache_key(self):
        return ("MonthsBetween", self.round_off,
                tuple(c.cache_key() for c in self.children))

    @property
    def dtype(self):
        return dts.FLOAT64

    def emit(self, ctx: EmitContext) -> ColVal:
        a = self.left.emit(ctx)
        b = self.right.emit(ctx)
        ua, ub = _to_micros(a), _to_micros(b)
        da, db = _fdiv(ua, US_PER_DAY), _fdiv(ub, US_PER_DAY)
        ya, ma, dya = _civil_from_days(da)
        yb, mb, dyb = _civil_from_days(db)
        month_diff = ((ya * 12 + ma) - (yb * 12 + mb)).to(torch.float64)
        whole = (dya == dyb) | ((dya == _month_days(ya, ma)) &
                                (dyb == _month_days(yb, mb)))
        secs = (dya - dyb) * 86400 + _fdiv(ua - da * US_PER_DAY, US_PER_SEC) \
            - _fdiv(ub - db * US_PER_DAY, US_PER_SEC)
        diff = month_diff + _exact_div(secs.to(torch.float64),
                                       float(31 * 86400))
        if self.round_off:
            diff = _exact_div(torch.floor(diff * 1e8 + 0.5), 1e8)
        out = torch.where(whole, month_diff, diff)
        return ColVal(dts.FLOAT64, out,
                      combine_validity(a.validity, b.validity))


_TRUNC_FORMATS = {"year": "year", "yyyy": "year", "yy": "year",
                  "month": "month", "mon": "month", "mm": "month",
                  "quarter": "quarter", "week": "week"}


class TruncDate(Expression):
    """trunc(date, fmt) for year/yyyy/yy, month/mon/mm, quarter and week
    (Monday); any other format gives null."""

    def __init__(self, child: Expression, fmt: str):
        self.children = (child,)
        self.fmt = str(fmt).lower()

    @property
    def child(self):
        return self.children[0]

    def with_children(self, children):
        return TruncDate(children[0], self.fmt)

    @property
    def dtype(self):
        return dts.DATE32

    def cache_key(self):
        return ("TruncDate", self.fmt, self.child.cache_key())

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        days = _to_days(c)
        y, m, d = _civil_from_days(days)
        one = torch.ones_like(m)
        unit = _TRUNC_FORMATS.get(self.fmt)
        if unit == "year":
            out = _days_from_civil(y, one, one)
        elif unit == "month":
            out = _days_from_civil(y, m, one)
        elif unit == "quarter":
            out = _days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
        elif unit == "week":
            out = days - torch.remainder(days + 3, 7)
        else:
            return ColVal(dts.DATE32, torch.zeros_like(days, dtype=torch.int32),
                          torch.zeros(days.shape, dtype=torch.bool,
                                      device=days.device))
        return ColVal(dts.DATE32, out.to(torch.int32), c.validity)


def _string_to_timestamp(bound: Expression) -> Expression:
    from spark_rapids_tpu_torch.ops.cast import Cast
    return Cast(bound, dts.TIMESTAMP_US) if bound.dtype.is_string else bound


class UnixTimestamp(UnaryExpression):
    """Seconds since the epoch of a timestamp or date (a string first
    casts to a timestamp)."""

    @property
    def dtype(self):
        return dts.INT64

    def bind(self, schema):
        return UnixTimestamp(_string_to_timestamp(self.child.bind(schema)))

    def eval_values(self, v, cv):
        return _fdiv(_to_micros(cv), US_PER_SEC)


class ToUnixTimestamp(UnaryExpression):
    """to_unix_timestamp(x): binds to ``UnixTimestamp`` (over a cast for a
    string), so the planner only sees registered expressions."""

    @property
    def dtype(self):
        return dts.INT64

    def bind(self, schema):
        return UnixTimestamp(_string_to_timestamp(self.child.bind(schema)))


class TimeAdd(BinaryExpression):
    """timestamp + an interval in microseconds."""

    @property
    def dtype(self):
        return dts.TIMESTAMP_US

    def emit(self, ctx: EmitContext) -> ColVal:
        l = self.left.emit(ctx)
        r = self.right.emit(ctx)
        return ColVal(dts.TIMESTAMP_US,
                      _to_micros(l) + r.values.to(torch.int64),
                      combine_validity(l.validity, r.validity))


def _format_tokens(fmt: str):
    """(tokens, supported): a Java date pattern as fixed-width fields
    (yyyy MM dd HH mm ss) and literal bytes.  A quoted run is literal
    text ('' is one quote); any other letter is outside the subset (the
    JAX package's rule, which also counts a quoted letter)."""
    tokens, supported, i = [], True, 0
    quoted = False
    while i < len(fmt):
        ch = fmt[i]
        if ch == "'":
            if fmt.startswith("''", i):
                tokens.extend(("lit", b) for b in b"'")
                i += 2
                continue
            quoted = not quoted
            i += 1
            continue
        if not quoted:
            for tok in ("yyyy", "MM", "dd", "HH", "mm", "ss"):
                if fmt.startswith(tok, i):
                    tokens.append(("tok", tok))
                    i += len(tok)
                    break
            else:
                tok = None
            if tok is not None:
                continue
        if ch.isalpha():
            supported = False
        tokens.extend(("lit", b) for b in ch.encode("utf-8"))
        i += 1
    return tokens, supported


_TOKEN_WIDTH = {"yyyy": 4, "MM": 2, "dd": 2, "HH": 2, "mm": 2, "ss": 2}


def format_micros(us: torch.Tensor, tokens, capacity: int):
    """(chars, offsets) of timestamps (UTC microseconds) through a
    fixed-width token list: every row is as wide as the pattern."""
    days = _fdiv(us, US_PER_DAY)
    y, m, d = _civil_from_days(days)
    rem = us - days * US_PER_DAY
    vals = {"yyyy": y.clamp(0, 9999), "MM": m, "dd": d,
            "HH": _fdiv(rem, 3_600_000_000),
            "mm": _fdiv(torch.remainder(rem, 3_600_000_000), 60_000_000),
            "ss": _fdiv(torch.remainder(rem, 60_000_000), US_PER_SEC)}
    cols = []
    for kind, t in tokens:
        if kind == "lit":
            cols.append(torch.full_like(y, t))
            continue
        v = vals[t]
        for p in range(_TOKEN_WIDTH[t] - 1, -1, -1):
            cols.append(torch.remainder(_fdiv(v, 10 ** p), 10) + 48)
    width = len(cols)
    if width == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=us.device),
                torch.zeros(capacity + 1, dtype=torch.int32,
                            device=us.device))
    mat = torch.stack(cols, dim=1).to(torch.uint8)
    offsets = torch.arange(capacity + 1, dtype=torch.int32,
                           device=us.device) * width
    return mat.reshape(-1), offsets


class DateFormatClass(UnaryExpression):
    """date_format(ts_or_date, pattern) on the device for fixed-width
    patterns (yyyy, MM, dd, HH, mm, ss and literal text); another pattern
    letter is outside the subset (``supported``) and the planner tags it
    for the CPU fallback."""

    def __init__(self, child: Expression, fmt: str):
        super().__init__(child)
        self.fmt = fmt
        self.tokens, self.supported = _format_tokens(fmt)

    def with_children(self, children):
        return DateFormatClass(children[0], self.fmt)

    @property
    def dtype(self):
        return dts.STRING

    def cache_key(self):
        return ("DateFormatClass", self.child.cache_key(), self.fmt)

    def emit(self, ctx: EmitContext) -> ColVal:
        if not self.supported:
            raise NotImplementedError(
                f"date_format pattern {self.fmt!r} outside the device "
                "subset")
        c = self.child.emit(ctx)
        us = _to_micros(c)
        if us.dim() == 0:
            us = us.expand(ctx.capacity)
        chars, offsets = format_micros(us, self.tokens, ctx.capacity)
        v = c.validity
        if v is not None and v.dim() == 0:
            v = v.expand(ctx.capacity)
        return ColVal(dts.STRING, chars, v, offsets)


_FROM_UNIXTIME_TOKENS, _ = _format_tokens("yyyy-MM-dd HH:mm:ss")


class FromUnixTime(UnaryExpression):
    """from_unixtime(seconds): Spark's 'yyyy-MM-dd HH:mm:ss' string (UTC)."""

    @property
    def dtype(self):
        return dts.STRING

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        us = c.values.to(torch.int64) * US_PER_SEC
        if us.dim() == 0:
            us = us.expand(ctx.capacity)
        chars, offsets = format_micros(us, _FROM_UNIXTIME_TOKENS,
                                       ctx.capacity)
        v = c.validity
        if v is not None and v.dim() == 0:
            v = v.expand(ctx.capacity)
        return ColVal(dts.STRING, chars, v, offsets)


class TimeWindow(UnaryExpression):
    """window(ts, windowDuration[, slideDuration[, startTime]]): one edge
    of a row's time window (the reference's GpuTimeWindow): the timestamp
    floored to its slide bucket, the start or the end.
    ``functions.window`` pairs a start and an end into the (start, end)
    struct.  ``shift_us``: a sliding window's i-th overlap is its bucket
    shifted back by i slides (the DataFrame expands one row per overlap
    through an Expand, as Spark does)."""

    def __init__(self, child: Expression, window_us: int, slide_us: int,
                 start_us: int = 0, field: str = "start",
                 shift_us: int = 0):
        super().__init__(child)
        self.window_us = int(window_us)
        self.slide_us = int(slide_us)
        self.start_us = int(start_us)
        self.field = field
        self.shift_us = int(shift_us)

    def with_children(self, children):
        return TimeWindow(children[0], self.window_us, self.slide_us,
                          self.start_us, self.field, self.shift_us)

    @property
    def dtype(self):
        return dts.TIMESTAMP_US

    def cache_key(self):
        return ("TimeWindow", self.child.cache_key(), self.window_us,
                self.slide_us, self.start_us, self.field, self.shift_us)

    def edge(self, ts: torch.Tensor) -> torch.Tensor:
        """The window edge of int64 microseconds ``ts``."""
        start = ts - torch.remainder(ts - self.start_us, self.slide_us) \
            - self.shift_us
        return start if self.field == "start" else start + self.window_us

    def emit(self, ctx: EmitContext) -> ColVal:
        c = self.child.emit(ctx)
        return ColVal(dts.TIMESTAMP_US, self.edge(_to_micros(c)),
                      c.validity)
