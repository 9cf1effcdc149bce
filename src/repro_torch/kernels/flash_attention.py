"""Wrapper of the CUDA flash-attention kernels.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention_pallas``:
causal and/or sliding-window grouped-query attention with query positions
right-aligned at offset T - S, forward only. Unlike the TPU kernel, S and T
need not be multiples of a block: the kernels mask the ragged edges. The
dtype picks the kernel, and nothing else does:

* bf16: ``csrc/flash_attention_sm90.cu``, ``wgmma`` on TMA-fed tiles
  (variant ``"tensor_core"``); it needs D % 8 == 0 (TMA's 16-byte rows).
  Where it splits a long kv range across CTAs, the wrapper allocates the
  float32 partial rows it merges.
* float32: ``csrc/flash_attention.cu``, on the CUDA cores (variant
  ``"cuda_core"``); ``wgmma`` takes no float32 operands.

The source notes say what bounds each on the H100 and how it is tiled.

Plain version: ``kernels/ref.py::flash_attention_reference``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MAX_D = 256


# variant -> library, and the name of its C entry point
_ENTRY = {"tensor_core": "flash_attention_sm90",
          "cuda_core": "flash_attention"}


@functools.cache
def _lib(variant: str) -> ctypes.CDLL:
    lib = _build.load(_ENTRY[variant])
    fn = getattr(lib, _ENTRY[variant])
    if variant == "tensor_core":     # + the split kv range's scratch, splits
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        lib.flash_attention_sm90_splits.argtypes = [ctypes.c_int] * 8
        lib.flash_attention_sm90_splits.restype = ctypes.c_int
    else:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
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
    variant = "tensor_core" if q.dtype == torch.bfloat16 else "cuda_core"
    if variant == "tensor_core" and D % 8:
        raise ValueError(f"flash_attention: the bf16 kernel needs D % 8 == 0 "
                         f"(TMA's 16-byte rows), got D = {D}")
    out = torch.empty_like(q)
    lib = _lib(variant)
    entry = _ENTRY[variant]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if variant == "tensor_core":
        splits = lib.flash_attention_sm90_splits(
            B, H, KH, S, T, int(bool(causal)), int(window), q.device.index)
        part = ml = None
        if splits > 1:       # float32 partial rows and their (max, sum)
            part = torch.empty((splits, B, H, S, D), dtype=torch.float32,
                               device=q.device)
            ml = torch.empty((splits, B, H, S, 2), dtype=torch.float32,
                             device=q.device)
        code = lib.flash_attention_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if ml is None else ml.data_ptr(),
            B, H, KH, S, T, D, int(bool(causal)), int(window), splits, stream)
    else:
        code = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KH, S, T, D, int(bool(causal)), int(window), stream)
    _build.check_launch(lib, entry, code)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variant_launches[variant] += 1
    return out


def reset_launches() -> None:
    """Set the total and every per-variant launch count to 0."""
    flash_attention_cuda.launches = 0
    for v in flash_attention_cuda.variant_launches:
        flash_attention_cuda.variant_launches[v] = 0


flash_attention_cuda.launches = 0
flash_attention_cuda.variant_launches = dict.fromkeys(_ENTRY, 0)
