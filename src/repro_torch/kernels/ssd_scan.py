"""Wrapper of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``).

Counterpart of ``repro/kernels/ssd_scan.py::ssd_pallas``: the Mamba-2
chunked SSD scan with dt folded in, as three launches on the current
stream: the chunks' local states (chunk-parallel), the float32 state
passed across chunks, and each chunk's output (chunk-parallel). The source
note in the ``.cu`` file says what bounds the kernel on the H100 and how it
is split across CTAs. One call counts one launch.

Plain version: ``kernels/ref.py::ssd_reference``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

MAX_CHUNK = 128      # rows of a chunk (8 warps x 16 rows)
MAX_STATE = 128      # state width N (the shared memory of a chunk of 128)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ssd_scan_smem_limit.argtypes = [ctypes.c_int]
    for fn in (lib.ssd_scan, lib.ssd_scan_smem_bytes,
               lib.ssd_scan_smem_limit):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _smem_limit(device_index: int) -> int:
    return _lib().ssd_scan_smem_limit(device_index)


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,l,h,p), dt (b,l,h), A (h,), B/C (b,l,n), initial_state
    (b,h,p,n) or None for zeros; one dtype (float32 or bf16) for all.

    Returns (y (b,l,h,p), final_state (b,h,p,n)) in x's dtype, with
    ``ssd_pallas``'s chunking: ``ck = min(chunk, l)`` and ``l % ck == 0``.
    Raises on anything the kernel does not take, and where an input
    requires grad (there is no backward yet); never computes on another
    path.
    """
    tensors = [x, dt, A, B, C] + ([] if initial_state is None
                                  else [initial_state])
    dev = _build.require_cuda("ssd", *tensors)
    _build.refuse_autograd(
        "ssd", "training mamba2 or jamba on the card waits for the SSD "
        "scan's backward (ROADMAP item 27)", *tensors)
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"ssd: dtype {x.dtype} not supported")
    if any(t.dtype != x.dtype for t in tensors):
        raise ValueError("ssd: x, dt, A, B, C and initial_state differ in "
                         "dtype")
    if x.dim() != 4:
        raise ValueError("ssd: want x (b,l,h,p)")
    b, l, h, p = x.shape
    n = B.shape[-1]
    shapes = {"dt": (dt, (b, l, h)), "A": (A, (h,)), "B": (B, (b, l, n)),
              "C": (C, (b, l, n))}
    if initial_state is not None:
        shapes["initial_state"] = (initial_state, (b, h, p, n))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"ssd: {name} has shape {tuple(t.shape)}, "
                             f"want {want}")
    ck = min(chunk, l)
    if ck <= 0 or l % ck:
        raise ValueError(f"ssd: sequence {l} not divisible by chunk {ck}")
    if ck > MAX_CHUNK or n > MAX_STATE:
        raise ValueError(f"ssd: the kernel takes chunks of at most "
                         f"{MAX_CHUNK} and a state of at most {MAX_STATE}, "
                         f"got {ck} and {n}")
    lib = _lib()
    code_t = _build.DTYPE_CODES[x.dtype]
    smem = lib.ssd_scan_smem_bytes(ck, n, p, code_t)
    limit = _smem_limit(dev.index)
    if smem > limit:
        raise ValueError(f"ssd: chunk {ck}, state {n} and head dim {p} need "
                         f"{smem} bytes of shared memory per CTA; this card "
                         f"allows {limit}")
    y = torch.empty_like(x)
    fin = torch.empty((b, h, p, n), dtype=x.dtype, device=dev)
    cs = torch.empty((b, h, l), dtype=torch.float32, device=dev)
    states = torch.empty((b, l // ck, h, p, n), dtype=torch.float32,
                         device=dev)
    prev = torch.empty((b, l // ck, h, p, n), dtype=x.dtype, device=dev)
    code = lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), fin.data_ptr(), cs.data_ptr(), states.data_ptr(),
        prev.data_ptr(),
        b, l, h, p, n, ck, code_t,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, "ssd_scan", code)
    ssd_cuda.launches += 1
    return y, fin


ssd_cuda.launches = 0
