"""Host-side (pandas) multi-key sort with a null placement per key.

Counterpart of ``spark_rapids_tpu/utils/hostsort.py``.  pandas
``sort_values`` takes one ``na_position`` for all keys, while Spark orders
place nulls first or last per key.  When the placement is the same for
every key this is one multi-key call; otherwise stable single-key passes
compose in reverse key order (lexicographic composition).  The CPU
fallback's external sort (``exec/fallback.py``) sorts its runs with it.
"""

from typing import Sequence

import pandas as pd


def sort_per_key_nulls(df: pd.DataFrame, names: Sequence[str],
                       ascending: Sequence[bool],
                       nulls_first: Sequence[bool],
                       reset_index: bool = True) -> pd.DataFrame:
    if len(set(nulls_first)) <= 1:
        out = df.sort_values(
            by=list(names), ascending=list(ascending),
            na_position="first" if (not nulls_first or nulls_first[0])
            else "last",
            kind="stable")
    else:
        out = df
        for name, asc, nf in zip(reversed(list(names)),
                                 reversed(list(ascending)),
                                 reversed(list(nulls_first))):
            out = out.sort_values(
                name, ascending=asc,
                na_position="first" if nf else "last",
                kind="stable")
    return out.reset_index(drop=True) if reset_index else out
