"""Step builders: the train step, the prefill step and the decode step for
any config, as ``StepBundle``s over the port's trees (the counterpart of
``repro/launch/steps.py``).

A bundle holds the step callable, its abstract arguments (meta tensors:
shapes and dtypes, no data), and the shardings of its inputs and outputs
under ``launch/sharding.py``'s rules: the one object the dry run runs on
meta and the trainer runs on the card. The mesh decides the device: a
production mesh's placeholders put the step on ``meta``, a debug mesh on
its one device (the card, or the CPU).

On a distributed mesh (``mesh.make_debug_mesh`` inside a world) the
steps of every family run as DTensors: the step places its arguments by
``in_shardings`` (``sharding.place``; a donated argument must arrive
placed, so that the step writes into it), runs the model under DTensor's
sharding propagation (``implicit_replication``: plain tensors such as
positions count as replicated; ``models/spmd.py`` does what propagation
does not), and hands its results back with ``out_shardings``' placements.

The encoder-decoder's bundles take ``seq`` as the encoder's frame count,
as ``repro``'s do: the train step's tokens are seq // 8, and the prefill
and decode bundles size the cross cache as ``seq`` frames (its self cache
holds 448 positions whatever ``seq``). So a caller builds them with
``seq`` = the clips' frame count, not a token count. A mixed-cache
(gemma3) prefill step raises ``Model.prefill``'s ``ValueError`` when
called, on a mesh as on one device: the cache starts from ``init_cache``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..models import build, spmd
from ..models.config import ModelConfig
from ..models.model import ENCDEC_DEC_FRac
from ..train.optimizer import AdamWConfig, adamw, compressed_adamw
from ..train.tree import leaves, map_tree, structure, unflatten
from . import sharding as SH

META = torch.device("meta")
# the keys of a train step's metrics: the loss's, the optimizer's, "loss"
TRAIN_METRICS = ("ce", "aux", "grad_norm", "lr", "loss")


@dataclasses.dataclass
class StepBundle:
    """``fn`` the step callable; ``args`` its abstract arguments (meta
    tensors); ``in_shardings``/``out_shardings`` trees of
    ``sharding.NamedSharding`` shaped like the arguments and results.
    ``donate_argnums`` are ``repro``'s: the arguments whose storage the
    step takes over. In the port the step writes the new values into
    them (the train step's parameters and optimizer state, the decode
    step's cache), so a donated argument is the result afterwards."""
    fn: Any
    args: Tuple
    in_shardings: Tuple
    out_shardings: Any
    donate_argnums: Tuple = ()


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(t.shape), dtype=t.dtype, device=META)


def abstract_params(cfg: ModelConfig):
    """The parameter tree of ``cfg`` as meta tensors: ``model.init`` runs
    under ``FakeTensorMode`` (no memory, no arithmetic), then each leaf
    becomes a meta tensor of its shape and dtype."""
    with FakeTensorMode():
        fake = build(cfg).init(torch.Generator().manual_seed(0))
    return map_tree(_meta, fake)


def input_specs(cfg: ModelConfig, kind: str, batch: int, seq: int
                ) -> Dict[str, Any]:
    """Meta stand-ins for the step inputs of ``kind`` (``repro``'s
    ``models/model.py::input_specs``):

    kind = "train"   -> {tokens, labels [, frames]}
    kind = "prefill" -> {tokens [, frames]}
    kind = "decode"  -> {tokens, cache}   (cache sized for a seq-long context)
    """
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)
    if kind == "train":
        if cfg.family == "encdec":
            sd = max(seq // ENCDEC_DEC_FRac, 8)
            return {"frames": spec((batch, seq, cfg.d_model), dt),
                    "tokens": spec((batch, sd), i32),
                    "labels": spec((batch, sd), i32)}
        return {"tokens": spec((batch, seq), i32),
                "labels": spec((batch, seq), i32)}
    if kind == "prefill":
        if cfg.family == "encdec":
            return {"frames": spec((batch, seq, cfg.d_model), dt),
                    "tokens": spec((batch, 8), i32)}
        return {"tokens": spec((batch, seq), i32)}
    if kind == "decode":
        return {"tokens": spec((batch, 1), i32),
                "cache": build(cfg).cache_specs(batch, seq)}
    raise ValueError(kind)


def _tensor(v, device: torch.device):
    return v if spmd.is_dtensor(v) else torch.as_tensor(v, device=device)


def _on(device: torch.device, batch) -> Dict[str, torch.Tensor]:
    return {k: _tensor(v, device) for k, v in batch.items()}


def _placed(fn, on_mesh: bool, in_shardings, out_shardings):
    """``fn`` as a step on a distributed mesh where ``on_mesh``: arguments
    placed by ``in_shardings``, results by ``out_shardings``."""
    if not on_mesh:
        return fn
    from torch.distributed.tensor.experimental import implicit_replication

    def step(*args):
        args = tuple(SH.place(a, sh) for a, sh in zip(args, in_shardings))
        with implicit_replication():
            out = fn(*args)
        # result by result, so that a donated argument comes back as is
        return tuple(SH.place(o, sh) for o, sh in zip(out, out_shardings))
    return step


def _value_and_grad(model, params, batch):
    """(loss, metrics, grads): ``model.loss`` and its gradient for every
    leaf of ``params`` (in ``train/tree.py``'s order; zeros for a leaf the
    loss does not reach). The leaves require grad only for the call."""
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    try:
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    finally:
        for p in ps:
            p.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else spmd.placed_like(g, p)
             for p, g in zip(ps, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _replicated(tree, mesh):
    return map_tree(lambda _: SH.NamedSharding(mesh, SH.P()), tree)


def make_train_step(cfg: ModelConfig, mesh, batch: int = 256,
                    seq: int = 4096, *, fsdp: bool = True,
                    compressed_grads: bool = False, microbatches: int = 1,
                    opt_cfg: AdamWConfig = AdamWConfig()) -> StepBundle:
    """The full train step ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``: the loss's gradient, microbatched, then AdamW
    (``compressed_grads``: on int8 error-feedback gradients). The update
    writes into ``params`` and ``opt_state`` (``train/optimizer.py``).

    ``batch`` rows of ``seq`` tokens (an encoder-decoder: ``seq`` frames
    and seq // 8 tokens); with ``microbatches = M`` the inputs arrive as
    (M, batch/M, ...), and the M gradients are summed in float32 and
    divided by M (activation memory scales with batch/M). Then, as in
    ``repro``, ``metrics["ce"]`` is the whole loss, aux included. The
    inputs (numpy arrays or tensors) go to the mesh's device."""
    device, on_mesh = mesh.device, mesh.distributed
    if batch % microbatches:
        raise ValueError(f"batch {batch} is not a multiple of "
                         f"{microbatches} microbatches")
    model = build(cfg)
    opt_init, opt_update = (compressed_adamw if compressed_grads
                            else adamw)(opt_cfg)
    rows = (batch,) if microbatches == 1 \
        else (microbatches, batch // microbatches)
    length = max(seq // ENCDEC_DEC_FRac, 8) if cfg.family == "encdec" \
        else seq

    def train_step(params, opt_state, batch_in):
        b = _on(device, batch_in)
        if tuple(b["tokens"].shape) != rows + (length,):
            raise ValueError(f"tokens {tuple(b['tokens'].shape)}: the step "
                             f"was built for {rows + (length,)}")
        if microbatches == 1:
            loss, metrics, grads = _value_and_grad(model, params, b)
        else:
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in leaves(params)]
            lsum = torch.zeros((), dtype=torch.float32, device=device)
            asum = torch.zeros((), dtype=torch.float32, device=device)
            for m in range(microbatches):
                l, met, g = _value_and_grad(
                    model, params, {k: v[m] for k, v in b.items()})
                torch._foreach_add_(gsum, [x.float() for x in g])
                lsum = lsum + l
                asum = asum + met["aux"]
            grads = torch._foreach_div(gsum, microbatches)
            loss = lsum / microbatches
            metrics = {"ce": loss, "aux": asum / microbatches}
        new_params, new_opt, opt_metrics = opt_update(
            unflatten(params, grads), opt_state, params)
        return new_params, new_opt, {**metrics, **opt_metrics, "loss": loss}

    p_shapes = abstract_params(cfg)
    o_shapes = opt_init(p_shapes)
    b_shapes = input_specs(cfg, "train", batch=batch, seq=seq)
    if microbatches > 1:
        b_shapes = {k: torch.empty(rows + tuple(s.shape[1:]), dtype=s.dtype,
                                   device=META)
                    for k, s in b_shapes.items()}
    p_shard = SH.params_shardings(p_shapes, mesh, fsdp=fsdp)
    o_shard = _opt_shardings(o_shapes, p_shapes, p_shard, mesh)
    b_shard = SH.batch_shardings(b_shapes, mesh,
                                 dim=1 if microbatches > 1 else 0)
    m_shard = _replicated(dict.fromkeys(TRAIN_METRICS, 0), mesh)
    return StepBundle(
        fn=_placed(train_step, on_mesh, (p_shard, o_shard, b_shard),
                   (p_shard, o_shard, m_shard)),
        args=(p_shapes, o_shapes, b_shapes),
        in_shardings=(p_shard, o_shard, b_shard),
        out_shardings=(p_shard, o_shard, m_shard),
        donate_argnums=(0, 1))


def make_prefill_step(cfg: ModelConfig, mesh, batch: int, seq: int,
                      fsdp: bool = True) -> StepBundle:
    """``(params, batch_in) -> (next_tok (B,) int32, cache)``: a prompt of
    ``batch`` rows into a cache of ``seq`` positions, and its greedy next
    token (an encoder-decoder: ``batch_in`` holds ``seq`` frames a row and
    the cross cache ``seq`` frames)."""
    device, on_mesh = mesh.device, mesh.distributed
    model = build(cfg)

    @torch.no_grad()
    def prefill_step(params, batch_in):
        b = _on(device, batch_in)
        if b["tokens"].shape[0] != batch:
            raise ValueError(f"{b['tokens'].shape[0]} rows: the step was "
                             f"built for {batch}")
        logits, cache = model.prefill(params, b, max_seq=seq)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    p_shapes = abstract_params(cfg)
    b_shapes = input_specs(cfg, "prefill", batch=batch, seq=seq)
    p_shard = SH.params_shardings(p_shapes, mesh, fsdp=fsdp)
    b_shard = SH.batch_shardings(b_shapes, mesh)
    tok_shard = SH.batch_shardings(
        torch.empty((batch,), dtype=torch.int32, device=META), mesh)
    cache_shard = SH.cache_shardings(model.cache_specs(batch, seq), mesh)
    return StepBundle(
        _placed(prefill_step, on_mesh, (p_shard, b_shard),
                (tok_shard, cache_shard)),
        (p_shapes, b_shapes), (p_shard, b_shard), (tok_shard, cache_shard))


def make_decode_step(cfg: ModelConfig, mesh, batch: int, seq: int,
                     fsdp: bool = True) -> StepBundle:
    """``(params, tokens (B,1), cache) -> (next_tok (B,1) int32, cache)``:
    one greedy decode step of ``batch`` rows against a cache of ``seq``
    positions (written in place; an encoder-decoder's cross cache of
    ``seq`` frames)."""
    device, on_mesh = mesh.device, mesh.distributed
    model = build(cfg)

    @torch.no_grad()
    def serve_step(params, tokens, cache):
        tokens = _tensor(tokens, device)
        if tuple(tokens.shape) != (batch, 1):
            raise ValueError(f"tokens {tuple(tokens.shape)}: the step was "
                             f"built for {(batch, 1)}")
        logits, cache = model.decode(params, tokens, cache)
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32), cache

    p_shapes = abstract_params(cfg)
    specs = input_specs(cfg, "decode", batch=batch, seq=seq)
    t_shapes, c_shapes = specs["tokens"], specs["cache"]
    p_shard = SH.params_shardings(p_shapes, mesh, fsdp=fsdp)
    t_shard = SH.batch_shardings(t_shapes, mesh)
    c_shard = SH.cache_shardings(c_shapes, mesh)
    return StepBundle(
        _placed(serve_step, on_mesh, (p_shard, t_shard, c_shard),
                (t_shard, c_shard)),
        (p_shapes, t_shapes, c_shapes), (p_shard, t_shard, c_shard),
        (t_shard, c_shard), donate_argnums=(2,))


def _opt_shardings(opt_shapes, param_shapes, param_shardings, mesh):
    """Optimizer moments shard exactly like their parameters (ZeRO-style);
    scalars (step) replicate. Works for AdamWState and CompressedState."""
    p_struct = structure(param_shapes)

    def rec(node):
        if hasattr(node, "_fields"):       # NamedTuple states: the fields
            return type(node)(*[rec(getattr(node, f)) for f in node._fields])
        if structure(node) == p_struct:    # a params-shaped subtree
            return param_shardings
        return _replicated(node, mesh)

    return rec(opt_shapes)
