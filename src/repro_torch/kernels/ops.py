"""The kernel entry points the port calls, with the layouts of
``repro/kernels/ops.py``: attention and the SSD scan for the models, the
RASK objective for the solver.

The tensor's device picks the implementation and nothing else does: a CUDA
tensor goes to the hand-written kernel (which launches or raises), a CPU
tensor goes to the plain PyTorch version in ``ref.py``. There is no
fallback between them.

Gradients: on a CPU tensor every entry point differentiates through its
plain version under ordinary autograd. On a CUDA tensor attention
differentiates through its backward kernel (``FlashAttention``), the SSD
scan through its own (``SSDScan``) and the RASK objective through its
own; the decode kernel has no backward and raises when asked for a graph.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention_cuda
from .flash_attention import FlashAttention, flash_attention_cuda
from .rask_objective import RaskObjective, rask_objective_backward_cuda
from .ssd_scan import SSDScan, ssd_cuda


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the CUDA kernel, False for the plain CPU version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no implementation for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,S,D); k,v: (B,KH,T,D). Tiled online-softmax attention.
    Where grad mode is on and an input requires grad, a CUDA call goes
    through ``FlashAttention`` (forward kernel with ``lse``, backward
    kernel); otherwise through the forward kernel alone."""
    if _route(q, "flash_attention"):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window)
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


def ssd(x, dt, A, B, C, *, chunk: int = 128, initial_state=None):
    """Mamba-2 chunked SSD scan: x (b,l,h,p), dt (b,l,h), A (h,), B/C
    (b,l,n) -> (y (b,l,h,p), final_state (b,h,p,n)). Shapes and dtype flow:
    ``ref.ssd_reference``. Where grad mode is on and an input requires
    grad, a CUDA call goes through ``SSDScan`` (forward kernel, keeping its
    states, then the backward kernel); otherwise through the forward kernel
    alone."""
    if _route(x, "ssd"):
        tensors = (x, dt, A, B, C) + (() if initial_state is None
                                      else (initial_state,))
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            return SSDScan.apply(x, dt, A, B, C, initial_state, chunk)
        return ssd_cuda(x, dt, A, B, C, chunk=chunk,
                        initial_state=initial_state)
    return ref.ssd_reference(x, dt, A, B, C, chunk=chunk,
                             initial_state=initial_state)


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
    ``ref.rask_objective_reference``), or (B, K, D) -> (B, K, |S|) over B
    problem rows whose tables carry a leading B. Differentiable in ``A``:
    on a CUDA tensor through the forward and backward kernels (one launch
    each, whatever B), on a CPU tensor through the plain versions."""
    args = (A, rel_gather, w, exponents, term_mask, x_scale, slo_kind,
            slo_service, slo_weight, slo_target, slo_pidx, slo_ridx, rps)
    if _route(A, "rask_objective"):
        return RaskObjective.apply(*args, n_services)
    return _PlainRaskObjective.apply(*args, n_services, max_degree)


def rask_objective_vjp(A, ct, rel_gather, w, exponents, term_mask, x_scale,
                       slo_kind, slo_service, slo_weight, slo_target,
                       slo_pidx, slo_ridx, rps, *, n_services: int,
                       max_degree: int):
    """The objective's vector-Jacobian product alone: cotangent ct (K, |S|)
    -> dJ/dA (K, D), or over B rows (B, K, |S|) -> (B, K, D), the gradient
    ``rask_objective``'s backward gives, with no forward and no autograd
    graph (on a CUDA tensor the backward kernel, on a CPU tensor
    ``ref.rask_objective_grad``)."""
    tables = (rel_gather, w, exponents, term_mask, x_scale, slo_kind,
              slo_service, slo_weight, slo_target, slo_pidx, slo_ridx, rps)
    if _route(A, "rask_objective_vjp"):
        return rask_objective_backward_cuda(A, ct, *tables,
                                            n_services=n_services)
    return ref.rask_objective_grad(A, ct, *tables, n_services=n_services,
                                   max_degree=max_degree)
