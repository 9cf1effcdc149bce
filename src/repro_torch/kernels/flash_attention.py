"""Wrapper of the CUDA flash-attention kernels.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention_pallas``:
causal and/or sliding-window grouped-query attention with query positions
right-aligned at offset T - S. Unlike the TPU kernel, S and T
need not be multiples of a block: the kernels mask the ragged edges. The
dtype picks the kernel, and nothing else does:

* bf16: ``csrc/flash_attention_sm90.cu``, ``wgmma`` on TMA-fed tiles
  (variant ``"wgmma"``); it needs D % 8 == 0 (TMA's 16-byte rows).
* float32: ``csrc/flash_attention.cu``, split-precision TF32 on
  ``mma.sync`` (variant ``"tf32x3"``): three TF32 products for each float32
  one, accurate to float32's bar; any D <= 256.

Both split a long kv range across CTAs where the grid is small; the
wrapper then allocates the float32 partial rows a second kernel merges, so
a call launches one or two CUDA kernels. With ``return_lse`` either also
writes each row's log-sum-exp (float32 (B,H,S)), which the backward reads;
serving passes no ``lse`` buffer, and the kernels then write none.

The gradient: ``csrc/flash_attention_backward.cu`` (both dtypes; three
CUDA kernels a call, one count), the counterpart of ``repro``'s
hand-written ``kernels/ref.py::_ca_bwd``. ``FlashAttention`` is the
autograd function over the forward and that kernel, which
``kernels/ops.py`` runs where a CUDA input requires grad. The source notes
say what bounds each kernel on the H100 and how it is tiled.

Plain versions: ``kernels/ref.py::flash_attention_reference``,
``flash_attention_lse_reference`` and
``flash_attention_backward_reference``.
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
    # q, k, v, o, the split kv range's scratch, lse; 9 ints; the stream
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    splits = getattr(lib, f"{_ENTRY[variant]}_splits")
    splits.argtypes = [ctypes.c_int] * 8
    splits.restype = ctypes.c_int
    return lib


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, window: int) -> None:
    """Raise on q, k, v that no attention kernel here takes."""
    _build.require_cuda(name, q, k, v)
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v differ in dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: want q (B,H,S,D) and k, v (B,KH,T,D) of "
                         "one shape")
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KH:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if D > MAX_D or T < S:
        raise ValueError(f"{name}: needs D <= {MAX_D} and T >= S")
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """q: (B,H,S,D); k, v: (B,KH,T,D) with T >= S. Returns (B,H,S,D), or
    with ``return_lse`` (out, lse), lse the float32 (B,H,S) row
    log-sum-exp of the masked scaled scores.

    Raises on anything the kernel does not take; never computes on another
    path.
    """
    _check_shapes("flash_attention", q, k, v, window)
    B, H, S, D = q.shape
    variant = _variant(q.dtype)
    if variant == "wgmma" and D % 8:
        raise ValueError(f"flash_attention: the bf16 kernel needs D % 8 == 0 "
                         f"(TMA's 16-byte rows), got D = {D}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
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
        None if lse is None else lse.data_ptr(),
        B, H, k.shape[1], S, k.shape[2], D, int(bool(causal)), int(window),
        splits, _build.current_stream(q.device))
    _build.check_launch(lib, entry, code)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variant_launches[variant] += 1
    return (out, lse) if return_lse else out


@functools.cache
def _backward_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_backward")
    # q, k, v, o, lse, do, delta, dq, dk, dv; dtype and 8 ints; the stream
    lib.flash_attention_backward.argtypes = [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.flash_attention_backward.restype = ctypes.c_int
    return lib


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor, *,
                                  causal: bool = True, window: int = 0):
    """Attention's gradient on the card: (q, k, v, o, lse, do) -> (dq, dk,
    dv), q, o, do (B,H,S,D) and k, v (B,KH,T,D) of one dtype, lse the
    forward's float32 (B,H,S). Three CUDA kernels (delta, dK/dV, dQ), one
    count. Raises on anything the kernel does not take."""
    _check_shapes("flash_attention_backward", q, k, v, window)
    _build.require_cuda("flash_attention_backward", q, o, lse, do)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("flash_attention_backward: o and do must match q "
                         "in shape and dtype")
    B, H, S, D = q.shape
    if lse.dtype != torch.float32 or lse.shape != (B, H, S):
        raise ValueError(f"flash_attention_backward: lse must be float32 of "
                         f"shape {(B, H, S)}")
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    lib = _backward_lib()
    code = lib.flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _build.DTYPE_CODES[q.dtype], B, H,
        k.shape[1], S, k.shape[2], D, int(bool(causal)), int(window),
        _build.current_stream(q.device))
    _build.check_launch(lib, "flash_attention_backward", code)
    flash_attention_backward_cuda.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention differentiable on the card: the forward kernel (saving the
    output and its ``lse``), the backward kernel for the gradient. Only the
    CUDA kernels run; ``kernels/ops.py`` takes the plain version under
    ordinary autograd for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_cuda(
            q, k, v, out, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


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
    """Set the forward's total and per-variant launch counts and the
    backward's count to 0."""
    flash_attention_cuda.launches = 0
    for v in flash_attention_cuda.variant_launches:
        flash_attention_cuda.variant_launches[v] = 0
    flash_attention_backward_cuda.launches = 0


flash_attention_cuda.launches = 0
flash_attention_cuda.variant_launches = dict.fromkeys(_ENTRY, 0)
flash_attention_backward_cuda.launches = 0
