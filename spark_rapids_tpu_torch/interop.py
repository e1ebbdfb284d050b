"""Data handed over from the JAX engine's form.

``batch_from_arrays`` builds the port's ColumnarBatch from what
``np.asarray`` on a JAX ``Column``'s buffers gives: per column a type
name, a values array and a validity array (or None).  Tests feed one
numpy-seeded table to both engines this way; a table is the database's
counterpart of a model's weights.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import Column
from spark_rapids_tpu_torch.columnar.dtypes import dtype_from_name


def batch_from_arrays(
        columns: Dict[str, Tuple[str, np.ndarray, Optional[np.ndarray]]],
        device) -> ColumnarBatch:
    """``{name: (dtype_name, values, validity or None)}`` -> a batch on
    ``device``.  All columns must have the same length."""
    cols = {}
    nrows = None
    for name, (type_name, values, validity) in columns.items():
        col = Column.from_numpy(np.asarray(values),
                                dtype=dtype_from_name(type_name),
                                validity=validity, device=device)
        if nrows is None:
            nrows = col.nrows
        elif col.nrows != nrows:
            raise ValueError(f"column {name!r} has {col.nrows} rows, "
                             f"expected {nrows}")
        cols[name] = col
    if nrows is None:
        raise ValueError("batch_from_arrays needs at least one column")
    return ColumnarBatch(cols, nrows)
