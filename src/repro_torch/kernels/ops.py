"""The kernel entry points the port calls, with the layouts of
``repro/kernels/ops.py``: attention and the SSD scan for the models, the
RASK objective for the solver.

The tensor's device picks the implementation and nothing else does: a CUDA
tensor goes to the hand-written kernel (which launches or raises), a CPU
tensor goes to the plain PyTorch version in ``ref.py``. There is no
fallback between them. A ``meta`` tensor takes the plain version too: it
holds no data, so nothing computes there, and the dry run reads the
shapes and counts (``launch/op_cost.py``). There attention and the SSD
scan run through ``_Priced``, which hands a count the work of the kernel
that the card runs in the plain version's place.

Gradients: on a CPU tensor every entry point differentiates through its
plain version under ordinary autograd. On a CUDA tensor attention
differentiates through its backward kernel (``FlashAttention``), the SSD
scan through its own (``SSDScan``) and the RASK objective through its
own; the decode kernel has no backward and raises when asked for a graph.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from . import flash_attention as _flash
from . import ref
from . import ssd_scan as _ssd
from .decode_attention import decode_attention_cuda
from .flash_attention import FlashAttention, flash_attention_cuda
from .rask_objective import RaskObjective, rask_objective_backward_cuda
from .ssd_scan import SSDScan, ssd_cuda

# The counts that ``launch/op_cost.py`` runs, innermost last.
COUNTS: list = []


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the CUDA kernel, False for the plain version (on the CPU,
    or shapes only on ``meta``)."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{name}: no implementation for device {t.device}")


@contextlib.contextmanager
def _priced(work):
    """Run the enclosed ops as the plain version of a kernel whose own
    work is ``work`` = (name, bytes, flops), or uncounted where ``work``
    is None, under the innermost count; outside a count, just run them."""
    if not COUNTS:
        yield
        return
    count = COUNTS[-1]
    count.enter(work)
    try:
        yield
    finally:
        count.leave(work)


class _Priced(torch.autograd.Function):
    """A kernel's plain version on ``meta`` tensors, priced as the kernels
    that the card runs in its place: the forward runs inside the forward
    kernel's work ``fwd``, the backward inside the backward kernel's
    (``bwd(cotangents)``), so a count takes the kernels' own bytes and
    flops and keeps the plain version's ops apart. The backward is the
    plain version's own under autograd, on its forward run again
    uncounted."""

    @staticmethod
    def forward(ctx, plain, fwd, bwd, *inputs):
        ctx.plain, ctx.bwd = plain, bwd
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        with _priced(fwd):
            return plain(*inputs)

    @staticmethod
    def backward(ctx, *cts):
        inputs = [t if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad[3:])]
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            with _priced(None):
                outs = ctx.plain(*inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            live = [(o, c) for o, c in zip(outs, cts) if c is not None]
            with _priced(ctx.bwd(cts)):
                grads = iter(torch.autograd.grad(
                    [o for o, _ in live], wrt, [c for _, c in live],
                    allow_unused=True))
        return (None, None, None) + tuple(
            next(grads) if t is not None and t.requires_grad else None
            for t in inputs)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


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
    if q.device.type == "meta":
        kw = dict(causal=causal, window=window)
        fwd = ("flash_attention", *_flash.forward_work(
            q, k, lse=_wants_grad(q, k, v), **kw))
        bwd = ("flash_attention_backward", *_flash.backward_work(q, k, **kw))
        return _Priced.apply(
            functools.partial(ref.flash_attention_reference, **kw), fwd,
            lambda cts: bwd, q, k, v)
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
    if x.device.type == "meta":
        b, l, h, p = x.shape
        shape = (b, l, h, p, B.shape[-1], min(chunk, l), x.element_size())
        fwd = ("ssd_scan", *_ssd.forward_work(
            *shape, initial_state=initial_state is not None,
            states=_wants_grad(x, dt, A, B, C, initial_state)))

        def bwd(cts):
            return ("ssd_scan_backward",
                    *_ssd.backward_work(*shape, dfinal=cts[1] is not None))

        def plain(x, dt, A, B, C, initial_state):
            return ref.ssd_reference(x, dt, A, B, C, chunk=chunk,
                                     initial_state=initial_state)
        return _Priced.apply(plain, fwd, bwd, x, dt, A, B, C, initial_state)
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
