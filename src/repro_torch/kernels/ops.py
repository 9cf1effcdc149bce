"""The kernel entry points the port calls, with the layouts of
``repro/kernels/ops.py``: attention for the model, the RASK objective for
the solver.

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
from .rask_objective import RaskObjective


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


class _PlainRaskObjective(torch.autograd.Function):
    """The objective's plain versions as one differentiable function:
    ``ref.rask_objective_reference`` forward, the analytic
    ``ref.rask_objective_grad`` backward (as on the card, where both are
    kernels)."""

    @staticmethod
    def forward(ctx, A, rel_gather, w, exponents, term_mask, x_scale,
                slo_kind, slo_service, slo_weight, slo_target, slo_pidx,
                slo_ridx, rps, n_services, max_degree):
        tables = (rel_gather, w, exponents, term_mask, x_scale, slo_kind,
                  slo_service, slo_weight, slo_target, slo_pidx, slo_ridx,
                  rps)
        ctx.save_for_backward(A, *tables)
        ctx.kw = dict(n_services=n_services, max_degree=max_degree)
        return ref.rask_objective_reference(A, *tables, **ctx.kw)

    @staticmethod
    def backward(ctx, ct):
        A, *tables = ctx.saved_tensors
        dA = ref.rask_objective_grad(A, ct, *tables, **ctx.kw)
        return (dA,) + (None,) * 14


def rask_objective(A, rel_gather, w, exponents, term_mask, x_scale, slo_kind,
                   slo_service, slo_weight, slo_target, slo_pidx, slo_ridx,
                   rps, *, n_services: int, max_degree: int):
    """A: (K, D) candidate assignments -> (K, |S|) per-service weighted SLO
    fulfillment (autoscaler Eq. (4) inner evaluation; shapes in
    ``ref.rask_objective_reference``). Differentiable in ``A``: on a CUDA
    tensor through the forward and backward kernels, on a CPU tensor
    through the plain versions."""
    args = (A, rel_gather, w, exponents, term_mask, x_scale, slo_kind,
            slo_service, slo_weight, slo_target, slo_pidx, slo_ridx, rps)
    if _route(A, "rask_objective"):
        return RaskObjective.apply(*args, n_services)
    return _PlainRaskObjective.apply(*args, n_services, max_degree)
