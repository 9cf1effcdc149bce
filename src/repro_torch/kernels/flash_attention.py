"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro/kernels/flash_attention.py::flash_attention_pallas``:
causal and/or sliding-window grouped-query attention with query positions
right-aligned at offset T - S, forward only. Unlike the TPU kernel, S and T
need not be multiples of a block: the kernel masks the ragged edges. The
source note in the ``.cu`` file says what bounds it on the H100 and why its
tiles have the sizes they have.

Plain version: ``kernels/ref.py::flash_attention_reference``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MAX_D = 256


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """q: (B,H,S,D); k, v: (B,KH,T,D) with T >= S. Returns (B,H,S,D).

    Raises on anything the kernel does not take; never computes on another
    path.
    """
    _build.require_cuda("flash_attention", q, k, v)
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k and v differ in dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: want q (B,H,S,D) and k, v "
                         "(B,KH,T,D) of one shape")
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KH:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if D > MAX_D or T < S:
        raise ValueError(f"flash_attention: needs D <= {MAX_D} and T >= S")
    if window < 0:
        raise ValueError("flash_attention: window must be >= 0")
    out = torch.empty_like(q)
    lib = _lib()
    code = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KH, S, T, D, int(bool(causal)), int(window),
        _build.DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(lib, "flash_attention", code)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
