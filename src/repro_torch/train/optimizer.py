"""AdamW and int8 error-feedback gradient compression over the port's
parameter trees (the counterpart of ``repro/train/optimizer.py``).

``adamw(cfg)`` returns an (init, update) pair in the optax style:
``init(params) -> state`` and ``update(grads, state, params) -> (params,
state, {"grad_norm", "lr"})``. The state is ``AdamWState(step, mu, nu)``:
the step an int32 scalar tensor on the parameters' device (so an update
makes no host sync), the moments float32 trees shaped like the params.

The arithmetic is float32 in ``repro``'s order: clip by the global norm,
the two moments, the cosine schedule, bias correction, decoupled weight
decay. It runs as ``torch._foreach_*`` calls over all leaves at once (a
leaf-by-leaf update of gemma3-1b's ~340 leaves would be thousands of
launches). One difference in rounding only: each leaf's norm comes from
``_foreach_norm`` (a square root per leaf, squared again in the sum),
where ``repro`` sums the leaves' squares directly.

Unlike JAX's, the update writes the new parameters and moments INTO the
tensors of ``params`` and ``state`` and returns them: a functional update
would hold a second copy of each (4 GB apiece for gemma3-1b in float32).
``grads`` are left as they were.

On DTensor leaves (a step on a mesh, ``launch/steps.py``) the same calls
run shard by shard; the global norm and each stack's int8 scale are taken
over the whole tensors (``spmd.replicated`` reduces the ranks' partial
norms and maxima), so every rank clips and quantizes as one device does.

``compressed_adamw`` wraps the update with int8 quantization plus an
error-feedback accumulator: g_hat = Q(g + e), e <- (g + e) - g_hat, with
one scale for each tensor of ``repro``'s layout: where ``repro`` stacks
the layers on a leading axis, the port's per-layer leaves of one path share
the stack's scale (``tree.stack_keys``). ``quantize_int8`` rounds half to
even (``torch.round``, as ``jnp.round`` does): it is deterministic, as
``repro``'s is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..models import spmd
from .tree import leaves, map_tree, stack_keys, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; float32."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _global_norm(tree) -> torch.Tensor:
    """The norm of every leaf together; a DTensor leaf's norm is its whole
    tensor's (its ranks' partial norms reduced)."""
    xs = [x.float() for x in leaves(tree)]
    return torch.linalg.vector_norm(torch.stack(
        [spmd.replicated(n) for n in torch._foreach_norm(xs)]))


def _zeros_like(tree):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def adamw(cfg: AdamWConfig):
    def init(params) -> AdamWState:
        device = leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          _zeros_like(params), _zeros_like(params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        step = state.step + 1
        gnorm = _global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        g = torch._foreach_mul([x.float() for x in leaves(grads)], scale)
        mu, nu = leaves(state.mu), leaves(state.nu)
        t = torch._foreach_mul(g, 1 - cfg.b1)
        torch._foreach_mul_(mu, cfg.b1)
        torch._foreach_add_(mu, t)
        t = torch._foreach_mul(g, 1 - cfg.b2)
        torch._foreach_mul_(t, g)
        torch._foreach_mul_(nu, cfg.b2)
        torch._foreach_add_(nu, t)
        del g, t
        lr = _schedule(cfg, step)
        b1c = 1 - torch.pow(cfg.b1, step.float())
        b2c = 1 - torch.pow(cfg.b2, step.float())

        # u = (m / b1c) / (sqrt(v / b2c) + eps) + wd * p;  p <- p - lr * u
        p_leaves = leaves(params)
        p32 = [p if p.dtype == torch.float32 else p.float()
               for p in p_leaves]
        den = torch._foreach_div(nu, b2c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        u = torch._foreach_div(mu, b1c)
        torch._foreach_div_(u, den)
        del den
        torch._foreach_add_(u, torch._foreach_mul(p32, cfg.weight_decay))
        torch._foreach_mul_(u, lr)
        torch._foreach_sub_(p32, u)
        for p, x in zip(p_leaves, p32):
            if x is not p:
                p.copy_(x)
        return params, AdamWState(step, state.mu, state.nu), \
            {"grad_norm": gnorm, "lr": lr}

    return init, update


# -- int8 error-feedback compression ------------------------------------------

class CompressedState(NamedTuple):
    inner: AdamWState
    error: Any        # error-feedback accumulator (float32, like grads)


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, scale); ``amax`` (default max |x|) sets the scale,
    so that the slices of one stacked tensor can share it."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_adamw(cfg: AdamWConfig):
    """AdamW on int8-compressed gradients with error feedback.

    g_hat = Q(g + e);  e <- (g + e) - g_hat. Unbiased in the long run;
    bounds a cross-host reduce payload at 1 byte/param. The leaves of one
    stack key share a scale; the accumulator is updated in place, as the
    moments are."""
    inner_init, inner_update = adamw(cfg)

    def init(params) -> CompressedState:
        return CompressedState(inner_init(params), _zeros_like(params))

    @torch.no_grad()
    def update(grads, state: CompressedState, params):
        totals = [g.float() + e
                  for g, e in zip(leaves(grads), leaves(state.error))]
        keys = stack_keys(grads)
        amax = {}
        for key, t in zip(keys, totals):
            m = spmd.replicated(torch.max(torch.abs(t)))   # whole leaf's
            amax[key] = m if key not in amax else torch.maximum(amax[key], m)
        cgrads = []
        for key, total, e in zip(keys, totals, leaves(state.error)):
            q, s = quantize_int8(total, amax[key])
            deq = dequantize_int8(q, s)
            cgrads.append(deq)
            e.copy_(total - deq)
        new_params, inner, metrics = inner_update(
            unflatten(grads, cgrads), state.inner, params)
        return new_params, CompressedState(inner, state.error), metrics

    return init, update
