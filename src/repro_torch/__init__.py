"""PyTorch/CUDA port of the MUDAP/RASK reproduction (``repro`` is the
JAX reference and stays untouched). This package imports ``torch`` and
nothing of ``jax`` or ``repro``; see ROADMAP.md for the slices ported."""
__version__ = "0.1.0"
