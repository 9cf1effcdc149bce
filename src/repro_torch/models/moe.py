"""Mixture-of-Experts FFN with GShard's dense dispatch: the counterpart of
``repro/models/moe.py``.

Tokens are routed within groups of at most ``group_size`` tokens. Each
token picks its top-k experts; each expert takes at most ``cap`` tokens of
a group, assigned choice by choice (every token's first choice before any
second choice) and, within a choice, in token order. A route past the
capacity is dropped: that expert adds nothing for the token, whose
residual passes through. Dispatch and combine are dense one-hot tensors
(G, Tg, E, C), so every expert's weights enter every product, whatever
the batch routes to it. That is ``repro``'s program, kept exactly here
(a gather over the routed experts only would give the same results and
read far fewer bytes; ROADMAP lists it as performance work).

Supports DBRX (16e top-4), Qwen2-MoE (60e top-4 + 4 shared experts fused
into one wide always-on expert) and, later, Jamba's FFN (16e top-2).

``recording_routes()`` is the instrumentation hook: inside it, every
``moe`` call appends its (T, k) expert choices and kept-route mask, so a
caller can count the routes dropped at capacity.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import activation, init_mlp, mlp

Params = Dict[str, torch.Tensor]

_ROUTES: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None


@contextlib.contextmanager
def recording_routes():
    """Collect ``(gate_idx, keep)``, each (T, k), of every ``moe`` call made
    inside the block, in call order (tensors on the call's device)."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> Params:
    """Random weights with ``repro``'s scales, drawn from ``gen``. Expert
    weights are (E, d, f) and (E, f, d), as in ``repro`` (no transpose);
    the router is (d, E) and stays float32."""
    d, f, e, dev = cfg.d_model, cfg.d_ff, cfg.n_experts, gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)
    p = {"router": randn(d, e) * d ** -0.5,
         "up": (randn(e, d, f) * d ** -0.5).to(dtype),
         "gate": (randn(e, d, f) * d ** -0.5).to(dtype),
         "down": (randn(e, f, d) * f ** -0.5).to(dtype)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, dtype,
                               d_ff=cfg.n_shared_experts * f)
    return p


def capacity(tg: int, cfg: ModelConfig,
             capacity_factor: float = 1.25) -> int:
    """Tokens an expert takes from a group of ``tg``: ``repro``'s Python
    float arithmetic, with a floor of min(tg, 16) so that small groups
    (decode batches) never drop a route."""
    return max(int((tg * cfg.top_k / cfg.n_experts) * capacity_factor),
               min(tg, 16))


def moe(p: Params, x, cfg: ModelConfig, capacity_factor: float = 1.25,
        group_size: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Group-wise GShard dispatch; the
    router runs in float32, the dispatch in ``x.dtype``, the combine
    weights in float32, cast to ``x.dtype`` for the last product."""
    B, S, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    T = B * S
    tg = min(group_size, T)
    if T % tg:
        raise ValueError(f"{T} tokens do not split into groups of {tg}")
    G = T // tg
    xg = x.reshape(G, tg, d)

    logits = torch.einsum("gtd,de->gte", xg.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)          # (G, Tg, k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)

    cap = capacity(tg, cfg, capacity_factor)

    # sequential-choice capacity assignment (GShard): earlier choices first
    dispatch = torch.zeros((G, tg, e, cap), dtype=x.dtype, device=x.device)
    combine = torch.zeros((G, tg, e, cap), dtype=torch.float32,
                          device=x.device)
    counts = torch.zeros((G, e), dtype=torch.long, device=x.device)
    keeps = []
    for choice in range(k):
        onehot = F.one_hot(gate_idx[..., choice], e)          # (G, Tg, E)
        pos = counts[:, None, :] + torch.cumsum(onehot, dim=1) - onehot
        keep = (pos < cap) & (onehot > 0)
        pos_oh = F.one_hot(torch.where(keep, pos, 0), cap).to(x.dtype) \
            * keep[..., None].to(x.dtype)
        dispatch = dispatch + pos_oh
        combine = combine + pos_oh.float() * gate_w[..., choice, None, None]
        counts = counts + (onehot * keep).sum(dim=1)
        if _ROUTES is not None:
            keeps.append(keep.any(dim=-1))                   # (G, Tg)
    if _ROUTES is not None:
        _ROUTES.append((gate_idx.reshape(T, k),
                        torch.stack(keeps, dim=-1).reshape(T, k)))

    expert_in = torch.einsum("gtec,gtd->gecd", dispatch, xg)  # (G, E, C, d)
    h = torch.einsum("gecd,edf->gecf", expert_in, p["up"])
    g = torch.einsum("gecd,edf->gecf", expert_in, p["gate"])
    h = h * activation(g, cfg.act)
    expert_out = torch.einsum("gecf,efd->gecd", h, p["down"])
    y = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), expert_out)
    y = y.reshape(B, S, d)

    if "shared" in p:
        y = y + mlp(p["shared"], x, cfg)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    frac = F.one_hot(gate_idx[..., 0], e).float().mean(dim=(0, 1))
    aux = e * torch.sum(frac * probs.mean(dim=(0, 1)))
    return y, aux
