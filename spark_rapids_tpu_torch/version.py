"""The port's version (counterpart of ``spark_rapids_tpu/version.py``)."""

__version__ = "0.1.0"
