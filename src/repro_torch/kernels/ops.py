"""The attention entry points the model calls, with the layouts of
``repro/kernels/ops.py``.

The tensor's device picks the implementation and nothing else does: a CUDA
tensor goes to the hand-written kernel (which launches or raises), a CPU
tensor goes to the plain PyTorch version in ``ref.py``. There is no
fallback between them.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention_cuda
from .flash_attention import flash_attention_cuda


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the CUDA kernel, False for the plain CPU version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no implementation for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,S,D); k,v: (B,KH,T,D). Tiled online-softmax attention."""
    if _route(q, "flash_attention"):
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return ref.flash_attention_reference(q, k, v, causal=causal,
                                         window=window)


def decode_attention(q, k_cache, v_cache, length, start):
    """q: (B,H,D) one new token per row; caches: (B,S,KH,D); attend to
    [start, length) of each row (``length``/``start``: (B,) int32)."""
    if _route(q, "decode_attention"):
        return decode_attention_cuda(q, k_cache, v_cache, length, start)
    return ref.decode_attention_reference(q, k_cache, v_cache, length,
                                          start=start)
