"""Wrappers of the CUDA RASK objective kernels (``csrc/rask_objective.cu``).

Counterpart of ``repro/kernels/rask_objective.py``: the forward replaces
``rask_objective_pallas`` and the backward gives ``rask_objective_grad``
(plain jnp in ``repro``) a kernel of its own. ``RaskObjective`` is the
``torch.autograd.Function`` whose forward is the forward kernel and whose
backward is the backward kernel; ``kernels/ops.py::rask_objective`` sends
CUDA tensors to it. The source note in the ``.cu`` file says what bounds
the kernels on the H100 and how they are laid out.

Plain versions: ``kernels/ref.py::rask_objective_reference`` and
``rask_objective_grad``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_INDEX_TABLES = ("rel_gather", "exponents", "slo_kind", "slo_service",
                 "slo_pidx", "slo_ridx")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rask_objective")
    lib.rask_objective_forward.argtypes = [_P] * 14 + [_I] * 7 + [_P]
    lib.rask_objective_backward.argtypes = [_P] * 15 + [_I] * 7 + [_P]
    lib.rask_objective_smem_bytes.argtypes = [_I] * 7
    lib.rask_objective_smem_limit.argtypes = [_I]
    lib.rask_objective_max_features.argtypes = []
    lib.rask_objective_empty.argtypes = [_P]
    for fn in (lib.rask_objective_forward, lib.rask_objective_backward,
               lib.rask_objective_smem_bytes, lib.rask_objective_smem_limit,
               lib.rask_objective_max_features, lib.rask_objective_empty):
        fn.restype = _I
    return lib


@functools.cache
def _shape_checks(name: str, device_index: int, D: int, R: int, F: int,
                  T: int, Q: int, S: int, backward: bool) -> None:
    """The checks that depend only on the sizes and the card, made once per
    (name, device, sizes, direction): a steady decide's call then makes no
    ctypes call besides its launch. Raises ValueError (never cached)."""
    lib = _lib()
    max_f = lib.rask_objective_max_features()
    if F > max_f:
        raise ValueError(f"{name}: {F} features per relation; the kernel "
                         f"takes at most {max_f}")
    if min(D, R, F, T, Q, S) <= 0:
        raise ValueError(f"{name}: empty table (D={D}, R={R}, F={F}, T={T}, "
                         f"Q={Q}, S={S})")
    smem = lib.rask_objective_smem_bytes(D, R, F, T, Q, S, int(backward))
    limit = lib.rask_objective_smem_limit(device_index)
    if smem > limit:
        raise ValueError(
            f"{name}: the tables need {smem} bytes of shared memory per CTA "
            f"(D={D}, R={R}, F={F}, T={T}, Q={Q}, S={S}); this card allows "
            f"{limit}")


_TABLES = ("rel_gather", "w", "exponents", "term_mask", "x_scale",
           "slo_kind", "slo_service", "slo_weight", "slo_target", "slo_pidx",
           "slo_ridx", "rps")
_TABLE_DTYPES = tuple(torch.int32 if key in _INDEX_TABLES else torch.float32
                      for key in _TABLES)


def _dims(name: str, A, rel_gather, w, exponents, term_mask, x_scale,
          slo_kind, slo_service, slo_weight, slo_target, slo_pidx, slo_ridx,
          rps, n_services: int, backward: bool, ct=None):
    """Check what the kernel takes (and the cotangent's device, for the
    backward); return (K, D, R, F, T, Q, S). Each check compares all
    tables at once and names the first that fails."""
    tables = (rel_gather, w, exponents, term_mask, x_scale, slo_kind,
              slo_service, slo_weight, slo_target, slo_pidx, slo_ridx, rps)
    dev = _build.require_cuda(name, A, *tables,
                              *(() if ct is None else (ct,)))
    dtypes = tuple(t.dtype for t in tables)
    if dtypes != _TABLE_DTYPES:
        key, got, want = next(x for x in zip(_TABLES, dtypes, _TABLE_DTYPES)
                              if x[1] != x[2])
        raise ValueError(f"{name}: {key} must be {want}, got {got}")
    if A.dtype != torch.float32 or A.dim() != 2:
        raise ValueError(f"{name}: A must be (K, D) float32")
    K, D = A.shape
    if exponents.dim() != 3:
        raise ValueError(f"{name}: exponents must be (R, T, F)")
    R, T, F = exponents.shape
    Q = slo_kind.shape[0]
    S = int(n_services)
    shapes = tuple(t.shape for t in tables)
    want = ((R, F), (R, T), (R, T, F), (R, T), (R, F), (Q,), (Q,), (Q,),
            (Q,), (Q,), (Q,), (S,))
    if shapes != want:
        key, got, shape = next(x for x in zip(_TABLES, shapes, want)
                               if x[1] != x[2])
        raise ValueError(f"{name}: {key} has shape {tuple(got)}, want "
                         f"{shape}")
    _shape_checks(name, dev.index, D, R, F, T, Q, S, backward)
    return K, D, R, F, T, Q, S


def rask_objective_forward_cuda(A, rel_gather, w, exponents, term_mask,
                                x_scale, slo_kind, slo_service, slo_weight,
                                slo_target, slo_pidx, slo_ridx, rps, *,
                                n_services: int) -> torch.Tensor:
    """(K, D) candidates -> (K, n_services) weighted SLO fulfilment, on the
    forward kernel. Shapes: ``ref.rask_objective_reference``. Raises on
    anything the kernel does not take; never computes on another path."""
    K, D, R, F, T, Q, S = _dims(
        "rask_objective", A, rel_gather, w, exponents, term_mask, x_scale,
        slo_kind, slo_service, slo_weight, slo_target, slo_pidx, slo_ridx,
        rps, n_services, backward=False)
    out = torch.empty((K, S), dtype=torch.float32, device=A.device)
    if K == 0:
        return out
    lib = _lib()
    code = lib.rask_objective_forward(
        A.data_ptr(), rel_gather.data_ptr(), w.data_ptr(),
        exponents.data_ptr(), term_mask.data_ptr(), x_scale.data_ptr(),
        slo_kind.data_ptr(), slo_service.data_ptr(), slo_weight.data_ptr(),
        slo_target.data_ptr(), slo_pidx.data_ptr(), slo_ridx.data_ptr(),
        rps.data_ptr(), out.data_ptr(), K, D, R, F, T, Q, S,
        _build.current_stream(A.device))
    _build.check_launch(lib, "rask_objective", code)
    rask_objective_forward_cuda.launches += 1
    return out


def rask_objective_backward_cuda(A, ct, rel_gather, w, exponents, term_mask,
                                 x_scale, slo_kind, slo_service, slo_weight,
                                 slo_target, slo_pidx, slo_ridx, rps, *,
                                 n_services: int) -> torch.Tensor:
    """Cotangent ct (K, n_services) -> dJ/dA (K, D), on the backward
    kernel (``ref.rask_objective_grad``'s function)."""
    K, D, R, F, T, Q, S = _dims(
        "rask_objective_grad", A, rel_gather, w, exponents, term_mask,
        x_scale, slo_kind, slo_service, slo_weight, slo_target, slo_pidx,
        slo_ridx, rps, n_services, backward=True, ct=ct)
    if ct.dtype != torch.float32 or tuple(ct.shape) != (K, S):
        raise ValueError(f"rask_objective_grad: ct must be ({K}, {S}) "
                         f"float32")
    dA = torch.empty((K, D), dtype=torch.float32, device=A.device)
    if K == 0:
        return dA
    lib = _lib()
    code = lib.rask_objective_backward(
        A.data_ptr(), ct.data_ptr(), rel_gather.data_ptr(), w.data_ptr(),
        exponents.data_ptr(), term_mask.data_ptr(), x_scale.data_ptr(),
        slo_kind.data_ptr(), slo_service.data_ptr(), slo_weight.data_ptr(),
        slo_target.data_ptr(), slo_pidx.data_ptr(), slo_ridx.data_ptr(),
        rps.data_ptr(), dA.data_ptr(), K, D, R, F, T, Q, S,
        _build.current_stream(A.device))
    _build.check_launch(lib, "rask_objective", code)
    rask_objective_backward_cuda.launches += 1
    return dA


rask_objective_forward_cuda.launches = 0
rask_objective_backward_cuda.launches = 0


def empty_launch_cuda(device: torch.device) -> None:
    """Launch one empty CTA on ``device``'s current stream (the practical
    floor of a launch, timed by ``chip_smoke.py``); counts nothing."""
    lib = _lib()
    code = lib.rask_objective_empty(_build.current_stream(device))
    _build.check_launch(lib, "rask_objective", code)


class RaskObjective(torch.autograd.Function):
    """The objective on the card: forward kernel forward, backward kernel
    backward. Only the candidates ``A`` get a gradient (the solver
    differentiates with respect to them alone)."""

    @staticmethod
    def forward(ctx, A, rel_gather, w, exponents, term_mask, x_scale,
                slo_kind, slo_service, slo_weight, slo_target, slo_pidx,
                slo_ridx, rps, n_services):
        tables = (rel_gather, w, exponents, term_mask, x_scale, slo_kind,
                  slo_service, slo_weight, slo_target, slo_pidx, slo_ridx,
                  rps)
        ctx.save_for_backward(A, *tables)
        ctx.n_services = n_services
        return rask_objective_forward_cuda(A, *tables, n_services=n_services)

    @staticmethod
    def backward(ctx, ct):
        A, *tables = ctx.saved_tensors
        dA = rask_objective_backward_cuda(A, ct.contiguous(), *tables,
                                          n_services=ctx.n_services)
        return (dA,) + (None,) * 13
