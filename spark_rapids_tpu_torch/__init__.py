"""spark_rapids_tpu_torch: the engine's PyTorch/CUDA port.

A second package beside the JAX engine (``spark_rapids_tpu``), holding the
same module paths and public names, written in PyTorch for one NVIDIA
Hopper GPU.  It imports neither ``jax`` nor anything of the JAX package.
Entry points run on ``cuda:0`` unless the caller passes ``device="cpu"``.
"""

from spark_rapids_tpu_torch.version import __version__  # noqa: F401
