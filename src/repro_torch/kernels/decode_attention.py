"""Wrapper of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Counterpart of ``repro/kernels/decode_attention.py::decode_attention_pallas``:
one new token per row attends, with grouped-query heads, to the cache slots
[start, length) of its row. Unlike the TPU kernel, ``length`` and ``start``
are per-row (B,) int32 vectors, since the batched engine decodes every slot
at its own length in one launch. The source note in the ``.cu`` file says
what bounds the kernel on the H100 and how a cluster of CTAs splits a row
and combines it (one launch a call, no scratch: only the output is
allocated).

Plain version: ``kernels/ref.py::decode_attention_reference``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MAX_CLUSTER = 16     # CTAs a (row, kv head): the flash-decoding split
MAX_D = 256
MAX_G = 8


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    props = torch.cuda.get_device_properties(device_index)
    return props.multi_processor_count


def cluster_size(pairs: int, sm_count: int) -> int:
    """CTAs to split each of ``pairs`` (row, kv head) ranges across: the
    largest power of two up to 16 that keeps the grid within one wave of
    the card's SMs (one CTA an SM: the ring takes most of its shared
    memory), at least 1."""
    c = 1
    while 2 * c <= MAX_CLUSTER and 2 * c * pairs <= sm_count:
        c *= 2
    return c


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, length: torch.Tensor,
                          start: torch.Tensor) -> torch.Tensor:
    """q: (B,H,D); caches: (B,S,KH,D); length, start: (B,) int32.

    Returns (B,H,D) in q's dtype. Raises on anything the kernel does not
    take; never computes on another path.
    """
    _build.require_cuda("decode_attention", q, k_cache, v_cache, length,
                        start)
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"decode_attention: dtype {q.dtype} not supported")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("decode_attention: q and caches differ in dtype")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("decode_attention: want q (B,H,D) and caches "
                         "(B,S,KH,D) of one shape")
    B, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs cache "
                         f"{tuple(k_cache.shape)}")
    if H % KH or H // KH > MAX_G or D > MAX_D:
        raise ValueError(f"decode_attention: needs H % KH == 0, "
                         f"H/KH <= {MAX_G}, D <= {MAX_D}")
    for name, t in (("length", length), ("start", start)):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError(f"decode_attention: {name} must be int32 of "
                             f"shape ({B},)")
    out = torch.empty_like(q)
    lib = _lib()
    code = lib.decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        length.data_ptr(), start.data_ptr(), out.data_ptr(),
        B, H, KH, S, D, cluster_size(B * KH, _sm_count(q.device.index)),
        _build.DTYPE_CODES[q.dtype],
        _build.current_stream(q.device))
    _build.check_launch(lib, "decode_attention", code)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
