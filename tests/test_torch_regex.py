"""The PyTorch port's regex family (``ops/regexops.py``) against the JAX
package and Python's ``re`` on the CPU.

The cases of the reference's ``tests/test_regex.py``: ``rlike`` over the
device subset (literals, anchors, classes, repetition, gaps, escapes) and
outside it (the CPU fallback with Python's ``re``), ``regexp_replace``
on the device (growing, shrinking and multi-byte replacements) and in
the fallback (self-overlapping patterns, ``$n`` group references),
``replace``, ``concat_ws``, ``translate`` and ``split(...).getItem(n)``.
Every answer equals Python's exactly and the JAX package's; the pattern
compiler gives the JAX package's program; the planner tags the same
expressions with the same reasons under ``spark.rapids.sql.regexp.
enabled`` and ``incompatibleOps.enabled`` set to false, and the fallback
then gives the same answers.
"""

import re

import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_overrides import tagged
from test_torch_strings import _assert_same
from spark_rapids_tpu.api import functions as JF
from spark_rapids_tpu.api.session import TpuSession as JaxSession
from spark_rapids_tpu.ops import regexops as jax_rx
from spark_rapids_tpu_torch.api import functions as TF
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.ops import regexops as port_rx

STRINGS = ["hello world", "", "Spark-3.2", "a1b2c3", "  pad  ", None,
           "2021-09-15", "xyz", "aaa", "foo_bar_baz", "the cat sat",
           "UPPER lower", "192.168.0.1", "no digits here!",
           "special packages requests", "furiously special requests",
           "abcly", "blithely", "ab ly", "héllo wörld", "日本語 cat"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(n=240, seed=7):
    rng = np.random.default_rng(seed)
    return {"s": [STRINGS[i] for i in rng.integers(len(STRINGS), size=n)],
            "k": [int(v) for v in rng.integers(0, 5, n)]}


@pytest.fixture(scope="module")
def data():
    return _rows()


def both(build, data, conf=None):
    """(port DataFrame, JAX answer, JAX explain) of ``build(F, df)``."""
    port = TpuSession(conf or {}, device="cpu")
    pdf = build(TF, port.create_dataframe(data))
    jax = JaxSession(conf or {})
    try:
        jdf = build(JF, jax.create_dataframe(data))
        jax.plan(jdf.plan)
        return pdf, jdf.to_pandas(), jax.overrides.last_explain
    finally:
        jax.stop()


def _python(values, fn):
    return [None if v is None else fn(v) for v in values]


def _same_list(got, want):
    assert [None if v is None or v is pd.NA or (isinstance(v, float)
                                                and np.isnan(v)) else v
            for v in got] == want


DEVICE_PATTERNS = [
    "cat", "^hello", "xyz$", "^aaa$", r"\d", r"\d{4}-\d{2}-\d{2}", "a.b",
    "[0-9][a-z]", "[^a-z ]", r"foo.*baz", r"cat.+sat", r"\w\s\w",
    r"192\.168", "special.*requests", "^[a-z]{3}.+ly$", "ö", "^$",
]
FALLBACK_PATTERNS = [r"a|b", r"(ab)+", r"\d+", r"colou?r", r"\bword\b",
                     ".*cat"]


@pytest.mark.parametrize("pat", DEVICE_PATTERNS + FALLBACK_PATTERNS)
def test_rlike_parity(pat, data):
    def build(F, df):
        return df.select(F.rlike("s", pat).alias("m"),
                         F.col("s").rlike(pat).alias("c"))
    df, want, jexplain = both(build, data)
    on_device = port_rx.compile_pattern(pat) is not None
    assert ("CpuFallbackExec" not in df.explain().split("==")[0]) == \
        on_device
    assert tagged(df.session.overrides.last_explain) == tagged(jexplain)
    got = df.to_pandas()
    # Java's classes are ASCII (\w, \d, \s), as re.ASCII makes Python's
    rx = re.compile(pat, re.ASCII)
    _same_list(got["m"].tolist(), _python(data["s"], lambda v: bool(
        rx.search(v))))
    _assert_same(got, want)


@pytest.mark.parametrize("pat", DEVICE_PATTERNS + FALLBACK_PATTERNS)
def test_compile_pattern_matches_jax(pat):
    got, want = port_rx.compile_pattern(pat), jax_rx.compile_pattern(pat)
    assert (got is None) == (want is None)
    if got is None:
        return
    assert (got.anchored_start, got.anchored_end, got.gap_min) == \
        (want.anchored_start, want.anchored_end, want.gap_min)
    assert [[m.tolist() for m in seg] for seg in got.segments] == \
        [[m.tolist() for m in seg] for seg in want.segments]
    assert got.no_self_overlap() == want.no_self_overlap()


REPLACE_CASES = {
    # (pattern, replacement, runs on the device)
    "literal": ("a", "A", True),
    "growing": ("o", "<0>", True),
    "shrinking": (r"\d", "", True),
    "class_pair": (r"[a-z]\d", "#", True),
    "multibyte_replacement": ("l", "é", True),
    "multibyte_pattern": ("ö", "o", True),
    "escaped_replacement": ("-", r"\$", False),
    "self_overlapping": ("aa", "b", False),
    "group_reference": (r"(a)(\d)", "$2$1", False),
    "alternation": ("Customer (Complaints|Recommends)", "C", False),
}


@pytest.mark.parametrize("name", list(REPLACE_CASES))
def test_regexp_replace_parity(name, data):
    pat, repl, on_device = REPLACE_CASES[name]

    def build(F, df):
        return df.select(F.regexp_replace("s", pat, repl).alias("r"))
    df, want, jexplain = both(build, data)
    assert ("CpuFallbackExec" not in df.explain().split("==")[0]) == \
        on_device
    assert tagged(df.session.overrides.last_explain) == tagged(jexplain)
    got = df.to_pandas()
    py_repl = re.sub(r"\$(\d+)", r"\\\1", repl).replace(r"\$", "$")
    rx = re.compile(pat, re.ASCII)
    _same_list(got["r"].tolist(), _python(data["s"], lambda v: rx.sub(
        py_repl, v)))
    if name != "escaped_replacement":   # the JAX fallback keeps the '\'
        _assert_same(got, want)


OTHER_CASES = {
    "replace": (lambda F: F.replace("s", " ", ""),
                lambda v: v.replace(" ", "")),
    "replace_growing": (lambda F: F.replace("s", "a", "aaa"),
                        lambda v: v.replace("a", "aaa")),
    "replace_multibyte": (lambda F: F.replace("s", "wö", "W"),
                          lambda v: v.replace("wö", "W")),
    "translate": (lambda F: F.translate("s", "aeiou", "AEIOU"),
                  lambda v: v.translate(str.maketrans("aeiou", "AEIOU"))),
    "translate_delete": (lambda F: F.translate("s", "abc-", "AB"),
                         lambda v: v.translate({97: "A", 98: "B", 99: None,
                                                45: None})),
    "translate_first_wins": (lambda F: F.translate("s", "aba", "12"),
                             lambda v: v.translate({97: "1", 98: "2"})),
    "split_0": (lambda F: F.split("s", " ").getItem(0),
                lambda v: v.split(" ")[0]),
    "split_1": (lambda F: F.split("s", "-").getItem(1),
                lambda v: (v.split("-") + [None])[1]
                if len(v.split("-")) > 1 else None),
    "split_multibyte": (lambda F: F.split("s", "ö").getItem(1),
                        lambda v: v.split("ö")[1] if "ö" in v else None),
}


@pytest.mark.parametrize("name", list(OTHER_CASES))
def test_replace_translate_split_parity(name, data):
    build_expr, fn = OTHER_CASES[name]

    def build(F, df):
        return df.select(build_expr(F).alias("x"))
    df, want, jexplain = both(build, data)
    assert "CpuFallbackExec" not in df.explain().split("==")[0]
    got = df.to_pandas()
    _same_list(got["x"].tolist(), _python(data["s"], fn))
    _assert_same(got, want)


def test_concat_ws_skips_nulls(data):
    t = list(reversed(data["s"]))
    frame = dict(data, t=t)

    def build(F, df):
        return df.select(F.concat_ws("-", "s", F.lit("x"), "t").alias("a"),
                         F.concat_ws("", "s", "t").alias("b"))
    df, want, _ = both(build, frame)
    got = df.to_pandas()
    assert got["a"].tolist() == ["-".join(v for v in (a, "x", b)
                                          if v is not None)
                                 for a, b in zip(data["s"], t)]
    assert got["b"].tolist() == ["".join(v for v in (a, b) if v is not None)
                                 for a, b in zip(data["s"], t)]
    _assert_same(got, want)


@pytest.mark.parametrize("conf, off", [
    ({"spark.rapids.sql.regexp.enabled": "false"},
     "disabled by spark.rapids.sql.regexp.enabled"),
    ({"spark.rapids.sql.incompatibleOps.enabled": "false"},
     "spark.rapids.sql.incompatibleOps.enabled is false")])
def test_regex_gates_tag_like_jax(conf, off, data):
    """rlike, regexp_replace and split().getItem() are tagged off by both
    keys (``replace`` and ``translate`` by neither), with the JAX
    package's reason text; the fallback then answers the same."""
    def build(F, df):
        return df.select(F.rlike("s", "cat").alias("a"),
                         F.regexp_replace("s", "a", "b").alias("b"))

    def build_plain(F, df):
        return df.select(F.replace("s", "a", "b").alias("b"),
                         F.translate("s", "ab", "ba").alias("c"))
    df, want, jexplain = both(build, data, conf)
    assert df.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    explain = df.session.overrides.last_explain
    assert off in explain
    assert tagged(explain) == tagged(jexplain) == ["Project"]
    for name in ("RLike", "RegExpReplace"):
        assert f"{name} " in explain.split(off)[0] or name in explain
    _assert_same(df.to_pandas(), want)
    df, want, jexplain = both(build_plain, data, conf)
    assert tagged(df.session.overrides.last_explain) == tagged(jexplain) \
        == []
    _assert_same(df.to_pandas(), want)


def test_outside_subset_reason_text(data):
    """The reason of a pattern outside the subset is the JAX package's
    (its "TPU regex subset" reads "device regex subset" here)."""
    def build(F, df):
        return df.select(F.rlike("s", "a|b").alias("m"))
    df, _, jexplain = both(build, data)
    df.explain()
    reason = "RLike arguments outside the {} regex subset (falls back to " \
        "CPU, like the reference's regex incompat flag)"
    assert reason.format("TPU") in jexplain
    assert reason.format("device") in df.session.overrides.last_explain


def test_fallback_semantics_match_spark():
    """Spark's answers in the fallback-only cases: an empty search leaves
    the input, repeated translate characters keep the first mapping, a
    negative split index is null, ``$n`` names a group."""
    s = TpuSession({}, device="cpu")
    df = s.create_dataframe({"s": ["abc", "a1b2"]})
    assert df.select(TF.replace("s", "", "x").alias("r")).to_pandas()[
        "r"].tolist() == ["abc", "a1b2"]
    assert df.select(TF.translate("s", "aba", "12").alias("t")).to_pandas()[
        "t"].tolist() == ["12c", "1122"]
    assert df.select(TF.split("s", "1").getItem(-1).alias("p")).to_pandas()[
        "p"].isna().all()
    assert df.select(TF.regexp_replace("s", r"(a)(\d)", "$2$1").alias(
        "g")).to_pandas()["g"].tolist() == ["abc", "1ab2"]


def test_regex_fallback_equals_device(data):
    """Device patterns evaluated in the fallback (the expressions
    switched off) equal the device's answers."""
    def build(F, df):
        return df.select(F.rlike("s", "special.*requests").alias("a"),
                         F.rlike("s", "^[a-z]{3}.+ly$").alias("b"),
                         F.regexp_replace("s", r"\d", "#").alias("c"),
                         F.replace("s", " ", "").alias("d"),
                         F.translate("s", "abc", "A").alias("e"),
                         F.split("s", " ").getItem(1).alias("f"))
    on = build(TF, TpuSession({}, device="cpu").create_dataframe(data))
    off = TpuSession({f"spark.rapids.sql.expression.{n}": "false" for n in
                      ("RLike", "RegExpReplace", "StringReplace",
                       "Translate", "SplitPart")}, device="cpu")
    dff = build(TF, off.create_dataframe(data))
    assert dff.explain().splitlines()[0] == "CpuFallbackExec[Project]"
    _assert_same(dff.to_pandas(), on.to_pandas())
