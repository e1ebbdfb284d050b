"""SQL string front end: parse -> resolve onto the port's DataFrame
algebra.

Counterpart of ``spark_rapids_tpu/sql/``: ``parser.py`` is its copy,
``resolver.py`` lowers the AST onto ``spark_rapids_tpu_torch.api``, so
SQL and DataFrame queries share the planner and the operators.
"""

from spark_rapids_tpu_torch.sql.parser import parse
from spark_rapids_tpu_torch.sql.resolver import resolve

__all__ = ["parse", "resolve"]
