"""Step constructors: the train step, the prefill step and the decode step
for any config, as callables over the port's parameter trees (the
counterpart of ``repro/launch/steps.py``).

``repro`` returns a ``StepBundle``: the step with the abstract inputs and
shardings the dry run lowers. The port's constructors return the step
callable alone; the abstract shapes and the mesh come with ROADMAP item
16.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..device import resolve_device
from ..models import build
from ..models.config import ModelConfig
from ..train.optimizer import AdamWConfig, adamw, compressed_adamw
from ..train.tree import leaves, unflatten


def _on(device: torch.device, batch) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


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
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(ps, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, batch: int = 256, seq: int = 4096, *,
                    compressed_grads: bool = False, microbatches: int = 1,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    device: Optional[torch.device] = None):
    """The full train step ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``: the loss's gradient, microbatched, then AdamW
    (``compressed_grads``: on int8 error-feedback gradients). The update
    writes into ``params`` and ``opt_state`` (``train/optimizer.py``).

    ``batch`` rows of ``seq`` tokens (an encoder-decoder: ``seq`` frames
    and seq // 8 tokens); with ``microbatches = M`` the inputs arrive as
    (M, batch/M, ...), and the M gradients are summed in float32 and
    divided by M (activation memory scales with batch/M). Then, as in
    ``repro``, ``metrics["ce"]`` is the whole loss, aux included. The
    inputs (numpy arrays or tensors) go to ``device``."""
    device = resolve_device(device)
    if batch % microbatches:
        raise ValueError(f"batch {batch} is not a multiple of "
                         f"{microbatches} microbatches")
    model = build(cfg)
    _, opt_update = (compressed_adamw if compressed_grads
                     else adamw)(opt_cfg)
    rows = (batch,) if microbatches == 1 \
        else (microbatches, batch // microbatches)
    length = max(seq // 8, 8) if cfg.family == "encdec" else seq

    def train_step(params, opt_state, batch_in):
        b = _on(device, batch_in)
        if tuple(b["tokens"].shape) != rows + (length,):
            raise ValueError(f"tokens {tuple(b['tokens'].shape)}: the step "
                             f"was built for {rows + (length,)}")
        if microbatches == 1:
            loss, metrics, grads = _value_and_grad(model, params, b)
        else:
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=device)
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

    return train_step


def make_prefill_step(cfg: ModelConfig, batch: int, seq: int, *,
                      device: Optional[torch.device] = None):
    """``(params, batch_in) -> (next_tok (B,) int32, cache)``: a prompt of
    ``batch`` rows into a cache of ``seq`` positions, and its greedy next
    token."""
    device = resolve_device(device)
    model = build(cfg)

    @torch.no_grad()
    def prefill_step(params, batch_in):
        b = _on(device, batch_in)
        if b["tokens"].shape[0] != batch:
            raise ValueError(f"{b['tokens'].shape[0]} rows: the step was "
                             f"built for {batch}")
        logits, cache = model.prefill(params, b, max_seq=seq)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, batch: int, seq: int, *,
                     device: Optional[torch.device] = None):
    """``(params, tokens (B,1), cache) -> (next_tok (B,1) int32, cache)``:
    one greedy decode step of ``batch`` rows against a cache of ``seq``
    positions (written in place)."""
    device = resolve_device(device)
    model = build(cfg)

    @torch.no_grad()
    def serve_step(params, tokens, cache):
        tokens = torch.as_tensor(tokens, device=device)
        if tuple(tokens.shape) != (batch, 1):
            raise ValueError(f"tokens {tuple(tokens.shape)}: the step was "
                             f"built for {(batch, 1)}")
        logits, cache = model.decode(params, tokens, cache)
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32), cache

    return serve_step
