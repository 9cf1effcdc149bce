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

DTensors (the decoder on a mesh, ``launch/steps.py``): attention's two
entry points run their kernel on each rank's local shards through
``torch.distributed.tensor.experimental.local_map``, with declared
placements (``_local_attention``): rows over every mesh dim but "model",
whole query heads over "model", kv heads over "model" where they split
with the query heads (else replicated, as gemma3's one kv head is), and
the decode cache's sequence gathered over "model" (the bytes each rank
receives for it are counted in ``GATHERED_KV_BYTES``). ``_route`` then
picks the kernel by the local tensor's device, and under autograd the
backward kernel runs on the local shards. The SSD scan runs so too
(``_local_ssd``): rows over every mesh dim but "model", heads over
"model", B and C (shared by every head) replicated, their gradients
``Partial()`` over "model".

Gradients: on a CPU tensor every entry point differentiates through its
plain version under ordinary autograd. On a CUDA tensor attention
differentiates through its backward kernel (``FlashAttention``), the SSD
scan through its own (``SSDScan``) and the RASK objective through its
own; the decode kernel has no backward and raises when asked for a graph.
"""
from __future__ import annotations

import contextlib
import functools
import math

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
# Bytes each rank has received to gather attention's kv inputs into the
# placements its kernel takes (``_local_attention``), by entry point: the
# decode cache's sequence gathered over "model". Callers zero and read it.
GATHERED_KV_BYTES = {"flash_attention": 0, "decode_attention": 0}


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


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient comes out contiguous (a DTensor's
    local shard, and its global strides with it)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if not _is_dtensor(g):
            return g.contiguous()
        if g.to_local().is_contiguous() and g.is_contiguous():
            return g
        from torch._prims_common import make_contiguous_strides_for
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(
            g.to_local().contiguous(), g.device_mesh, g.placements,
            run_check=False, shape=g.shape,
            stride=make_contiguous_strides_for(g.shape))


def contiguous_grad(t):
    """``t``, its gradient made contiguous where it requires one.
    ``local_map`` wraps a local gradient as a DTensor with strides taken
    from it, and a redistribute's backward may leave a strided local
    shard (an all-to-all's chunks) under contiguous global strides; either
    breaks the views that autograd takes upstream. So ``on_local_shards``
    passes every input through this, outside and inside."""
    if isinstance(t, torch.Tensor) and t.requires_grad:
        return _ContiguousGrad.apply(t)
    return t


def row_ranks(mesh) -> int:
    """Ranks the rows split over: every mesh dim but "model"."""
    return math.prod(s for n, s in zip(mesh.mesh_dim_names, mesh.shape)
                     if n != "model")


def model_ranks(mesh) -> int:
    """Ranks of the mesh's "model" dim (1 without one)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)


def mesh_placements(mesh, model, rows) -> list:
    """One placement a dim of ``mesh``: ``model`` on "model", ``rows`` on
    every other dim of more than one rank (the dims the rows split over),
    ``Replicate()`` on a dim of one (a shard of all the rows would stop
    views from merging them with the next dim)."""
    from torch.distributed.tensor import Replicate
    return [model if n == "model" else rows if k > 1 else Replicate()
            for n, k in zip(mesh.mesh_dim_names, mesh.shape)]


def on_local_shards(fn, args, in_pl, grad_pl, out_pl):
    """``fn(*args)`` on each rank's local shards, under ``local_map``:
    ``args`` redistributed to ``in_pl`` (a plain tensor counts as
    replicated on the mesh of the first DTensor), their gradients declared
    ``grad_pl``, the results placed ``out_pl``. Every input's gradient is
    made contiguous, outside ``fn`` and inside (``contiguous_grad``)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t.device_mesh for t in args if _is_dtensor(t))
    args = [DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
            if isinstance(t, torch.Tensor) and not _is_dtensor(t) else t
            for t in args]

    def local(*shards):
        return fn(*map(contiguous_grad, shards))
    return local_map(local, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, redistribute_inputs=True,
                     device_mesh=mesh)(*map(contiguous_grad, args))


def _local_attention(fn, q, kv, extra=()):
    """``fn(q, *kv, *extra)`` on each rank's local shards of DTensor ``q``
    (rows dim 0, heads dim 1), ``kv`` (flash's (B, KH, T, D) beside a
    4-d ``q``, caches (B, S, KH, D) beside a 3-d one) and ``extra``
    (per-row (B,) tensors). Rows shard over every mesh dim but "model"
    where they split evenly; query heads over "model" where they split
    and the kv heads split with them, or there is one kv head (then
    replicated); the rest is replicated (a cache's sequence gathered)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    kv_dim = 1 if q.dim() == 4 else 2
    H, KH, m = q.shape[1], kv[0].shape[kv_dim], model_ranks(mesh)
    q_heads = H % m == 0 and (KH % m == 0 or KH == 1)
    kv_heads = q_heads and KH % m == 0
    rows = Shard(0) if q.shape[0] % row_ranks(mesh) == 0 else Replicate()
    qp = mesh_placements(mesh, Shard(1) if q_heads else Replicate(), rows)
    kp = mesh_placements(mesh, Shard(kv_dim) if kv_heads else Replicate(),
                         rows)
    rp = mesh_placements(mesh, Replicate(), rows)
    # kv replicated over "model" beside split query heads: each rank's
    # gradient of kv is its heads' part
    kg = mesh_placements(mesh, Partial(), rows) \
        if q_heads and not kv_heads else kp
    entry = "flash_attention" if q.dim() == 4 else "decode_attention"
    GATHERED_KV_BYTES[entry] += sum(_gathered_bytes(t, kp) for t in kv)
    n_kv, n_extra = len(kv), len(extra)
    return on_local_shards(
        fn, (q, *kv, *extra), (qp,) + (kp,) * n_kv + (rp,) * n_extra,
        (qp,) + (kg,) * n_kv + (rp,) * n_extra, qp)


def _gathered_bytes(t, placements) -> int:
    """What this rank receives, in bytes, when ``t`` is redistributed to
    ``placements``: its new local shard less the part of it that its old
    shard holds (both are boxes of the global tensor). A gather receives
    what the shard grows by; an all-to-all (a cache's sequence shards to
    its kv heads' shards) what it does not hold of its new shard; 0 for a
    plain tensor, or one that stays or shrinks."""
    if not _is_dtensor(t):
        return 0
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    new, new_off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, placements)
    old, old_off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    held = math.prod(max(0, min(a + n, b + o) - max(a, b))
                     for n, a, o, b in zip(new, new_off, old, old_off))
    return (math.prod(new) - held) * t.element_size()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,H,S,D); k,v: (B,KH,T,D). Tiled online-softmax attention.
    Where grad mode is on and an input requires grad, a CUDA call goes
    through ``FlashAttention`` (forward kernel with ``lse``, backward
    kernel); otherwise through the forward kernel alone. DTensors run on
    their local shards (``_local_attention``)."""
    if _is_dtensor(q):
        return _local_attention(functools.partial(
            flash_attention, causal=causal, window=window), q, (k, v))
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
    [start, length) of each row (``length``/``start``: (B,) int32).
    DTensors run on their local shards, each cache gathered over "model"
    where its sequence is sharded (``_local_attention``)."""
    if _is_dtensor(q):
        return _local_attention(decode_attention, q, (k_cache, v_cache),
                                (length, start))
    if _route(q, "decode_attention"):
        return decode_attention_cuda(q, k_cache, v_cache, length, start)
    return ref.decode_attention_reference(q, k_cache, v_cache, length,
                                          start=start)


def _local_ssd(x, dt, A, B, C, chunk, initial_state):
    """``ssd`` on each rank's local shards of DTensor ``x``: rows over
    every mesh dim but "model" where they split evenly; x, dt, A, the
    initial state and both outputs by heads over "model" where the heads
    split (else replicated); B and C, shared by every head, replicated
    over "model". A rank's gradients of B and C are its heads' share, so
    they are declared ``Partial()`` over "model" where the heads split,
    and A's is its rows' share, ``Partial()`` over the dims its rows split
    over."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, R = x.device_mesh, Replicate()
    heads = x.shape[2] % model_ranks(mesh) == 0
    rows = x.shape[0] % row_ranks(mesh) == 0
    row = Shard(0) if rows else R

    def by_heads(dim):
        return Shard(dim) if heads else R
    xp = mesh_placements(mesh, by_heads(2), row)      # x, dt and y
    sp = mesh_placements(mesh, by_heads(1), row)      # the states
    ap = mesh_placements(mesh, by_heads(0), R)
    ag = mesh_placements(mesh, by_heads(0), Partial() if rows else R)
    bp = mesh_placements(mesh, R, row)                # B and C
    bg = mesh_placements(mesh, Partial() if heads else R, row)
    args = [x, dt, A, B, C] + ([] if initial_state is None
                               else [initial_state])
    n_init = len(args) - 5

    def scan(x, dt, A, B, C, *init):
        return ssd(x.contiguous(), dt.contiguous(), A.contiguous(),
                   B.contiguous(), C.contiguous(), chunk=chunk,
                   initial_state=init[0].contiguous() if init else None)
    return on_local_shards(scan, args, (xp, xp, ap, bp, bp) + (sp,) * n_init,
                           (xp, xp, ag, bg, bg) + (sp,) * n_init, (xp, sp))


def ssd(x, dt, A, B, C, *, chunk: int = 128, initial_state=None):
    """Mamba-2 chunked SSD scan: x (b,l,h,p), dt (b,l,h), A (h,), B/C
    (b,l,n) -> (y (b,l,h,p), final_state (b,h,p,n)). Shapes and dtype flow:
    ``ref.ssd_reference``. Where grad mode is on and an input requires
    grad, a CUDA call goes through ``SSDScan`` (forward kernel, keeping its
    states, then the backward kernel); otherwise through the forward kernel
    alone. DTensors run on their local shards, h / model heads a rank
    (``_local_ssd``)."""
    if _is_dtensor(x):
        return _local_ssd(x, dt, A, B, C, chunk, initial_state)
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
