"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``, built
by ``_build.py``), their plain PyTorch versions (``ref.py``) and the
device-routed entry points (``ops.py``)."""
from . import ops, ref

__all__ = ["ops", "ref"]
