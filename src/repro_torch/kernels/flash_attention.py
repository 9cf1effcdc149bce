"""Wrapper of the CUDA flash-attention kernels.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention_pallas``:
causal and/or sliding-window grouped-query attention with query positions
right-aligned at offset T - S, forward only. Unlike the TPU kernel, S and T
need not be multiples of a block: the kernels mask the ragged edges. The
dtype picks the kernel, and nothing else does:

* bf16: ``csrc/flash_attention_sm90.cu``, ``wgmma`` on TMA-fed tiles
  (variant ``"wgmma"``); it needs D % 8 == 0 (TMA's 16-byte rows).
* float32: ``csrc/flash_attention.cu``, split-precision TF32 on
  ``mma.sync`` (variant ``"tf32x3"``): three TF32 products for each float32
  one, accurate to float32's bar; any D <= 256.

Both split a long kv range across CTAs where the grid is small; the
wrapper then allocates the float32 partial rows a second kernel merges, so
a call launches one or two CUDA kernels. The source notes say what bounds
each on the H100 and how it is tiled.

Plain version: ``kernels/ref.py::flash_attention_reference``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MAX_D = 256


# variant -> library, and the name of its C entry point
_ENTRY = {"wgmma": "flash_attention_sm90", "tf32x3": "flash_attention"}


def _variant(dtype: torch.dtype) -> str:
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


@functools.cache
def _lib(variant: str) -> ctypes.CDLL:
    lib = _build.load(_ENTRY[variant])
    fn = getattr(lib, _ENTRY[variant])
    # q, k, v, o, the split kv range's scratch; 9 ints; the stream
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    splits = getattr(lib, f"{_ENTRY[variant]}_splits")
    splits.argtypes = [ctypes.c_int] * 8
    splits.restype = ctypes.c_int
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
    variant = _variant(q.dtype)
    if variant == "wgmma" and D % 8:
        raise ValueError(f"flash_attention: the bf16 kernel needs D % 8 == 0 "
                         f"(TMA's 16-byte rows), got D = {D}")
    out = torch.empty_like(q)
    lib = _lib(variant)
    entry = _ENTRY[variant]
    splits = kv_splits(q, k, causal=causal, window=window)
    part = ml = None
    if splits > 1:           # float32 partial rows and their (max, sum)
        part = torch.empty((splits, B, H, S, D), dtype=torch.float32,
                           device=q.device)
        ml = torch.empty((splits, B, H, S, 2), dtype=torch.float32,
                         device=q.device)
    code = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if ml is None else ml.data_ptr(),
        B, H, KH, S, T, D, int(bool(causal)), int(window), splits,
        _build.current_stream(q.device))
    _build.check_launch(lib, entry, code)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variant_launches[variant] += 1
    return out


def kv_splits(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
              window: int = 0) -> int:
    """How many CTAs share a query block's kv range in the kernel that
    ``flash_attention_cuda(q, k, v, ...)`` launches: 1 is one CUDA kernel
    a call, more is the split kernel and the merge kernel."""
    variant = _variant(q.dtype)
    B, H, S, _ = q.shape
    KH, T = k.shape[1], k.shape[2]
    fn = getattr(_lib(variant), f"{_ENTRY[variant]}_splits")
    return fn(B, H, KH, S, T, int(bool(causal)), int(window), q.device.index)


def reset_launches() -> None:
    """Set the total and every per-variant launch count to 0."""
    flash_attention_cuda.launches = 0
    for v in flash_attention_cuda.variant_launches:
        flash_attention_cuda.variant_launches[v] = 0


flash_attention_cuda.launches = 0
flash_attention_cuda.variant_launches = dict.fromkeys(_ENTRY, 0)
