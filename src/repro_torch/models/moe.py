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
into one wide always-on expert) and Jamba's FFN (16e top-2, every other
sublayer; its prompts route with ``ragged=True``, see ``moe``).

``recording_routes()`` is the instrumentation hook: inside it, every
``moe`` call appends its (T, k) expert choices and kept-route mask, so a
caller can count the routes dropped at capacity.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import spmd
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
        group_size: int = 512, ragged: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Group-wise GShard dispatch; the
    router runs in float32, the dispatch in ``x.dtype``, the combine
    weights in float32, cast to ``x.dtype`` for the last product.

    Tokens that do not split into groups of ``group_size`` raise, as in
    ``repro``, unless ``ragged``: then the last group holds the remainder
    and takes its own (smaller) capacity. The aux loss is over all
    tokens either way."""
    B, S, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    T = B * S
    tg = min(group_size, T)
    if T % tg and not ragged:
        raise ValueError(f"{T} tokens do not split into groups of {tg}")
    xt = spmd.group_rows(x.reshape(T, d), tg)
    full = T - T % tg
    parts = [_dispatch(p, xt[:full].reshape(full // tg, tg, d), cfg,
                       capacity_factor)]
    if full < T:
        parts.append(_dispatch(p, xt[full:][None], cfg, capacity_factor))
    ys, idx, prs, kept = zip(*parts)
    y = _rows(ys, d).reshape(B, S, d)
    gate_idx, probs = _rows(idx, k), _rows(prs, e)
    if _ROUTES is not None:
        _ROUTES.append((gate_idx, _rows(kept, k)))

    if "shared" in p:
        y = y + mlp(p["shared"], x, cfg)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    first = gate_idx[:, :1] == torch.arange(e, device=gate_idx.device)
    frac = first.float().mean(dim=0)
    aux = e * torch.sum(frac * probs.mean(dim=0))
    return y, aux


def _rows(parts, width: int):
    """The groups' (..., width) tensors as one (T, width) (a view where
    there is one group size)."""
    if len(parts) == 1:
        return parts[0].reshape(-1, width)
    return torch.cat([t.reshape(-1, width) for t in parts])


def _dispatch(p: Params, xg, cfg: ModelConfig, capacity_factor: float):
    """The routed experts over groups xg (G, Tg, d): (y (G, Tg, d),
    gate_idx (G, Tg, k), router probs (G, Tg, E), kept routes (G*Tg, k)).
    On a mesh (DTensor ``xg``) ``spmd.moe_dispatch`` runs the two halves
    on each rank's local shards."""
    if spmd.is_dtensor(xg):
        return spmd.moe_dispatch(
            functools.partial(_route, cfg=cfg,
                              capacity_factor=capacity_factor),
            functools.partial(_experts, act=cfg.act), p, xg)
    dispatch, combine, gate_idx, probs, kept = _route(
        xg, p["router"], cfg, capacity_factor,
        record=_ROUTES is not None)
    y = _experts(xg, dispatch, combine, p["up"], p["gate"], p["down"],
                 cfg.act)
    return y, gate_idx, probs, kept


def _route(xg, router, cfg: ModelConfig, capacity_factor: float,
           record: bool = True):
    """The routing of groups xg (G, Tg, d): (dispatch (G, Tg, E, C) in
    ``xg.dtype``, combine (G, Tg, E, C) float32, gate_idx (G, Tg, k),
    router probs (G, Tg, E), kept routes (G*Tg, k), or None where not
    ``record``)."""
    G, tg, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("gtd,de->gte", xg.float(), router)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)          # (G, Tg, k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp(min=1e-9)

    cap = capacity(tg, cfg, capacity_factor)

    # sequential-choice capacity assignment (GShard): earlier choices first
    dispatch = torch.zeros((G, tg, e, cap), dtype=xg.dtype, device=xg.device)
    combine = torch.zeros((G, tg, e, cap), dtype=torch.float32,
                          device=xg.device)
    counts = torch.zeros((G, e), dtype=torch.long, device=xg.device)
    keeps = []
    for choice in range(k):
        onehot = F.one_hot(gate_idx[..., choice], e)          # (G, Tg, E)
        pos = counts[:, None, :] + torch.cumsum(onehot, dim=1) - onehot
        keep = (pos < cap) & (onehot > 0)
        pos_oh = F.one_hot(torch.where(keep, pos, 0), cap).to(xg.dtype) \
            * keep[..., None].to(xg.dtype)
        dispatch = dispatch + pos_oh
        combine = combine + pos_oh.float() * gate_w[..., choice, None, None]
        counts = counts + (onehot * keep).sum(dim=1)
        if record:
            keeps.append(keep.any(dim=-1))                   # (G, Tg)
    kept = torch.stack(keeps, dim=-1).reshape(G * tg, k) if keeps else None
    return dispatch, combine, gate_idx, probs, kept


def _experts(xg, dispatch, combine, up, gate, down, act: str):
    """The expert FFNs over routed groups xg (G, Tg, d): dispatch and
    combine (G, Tg, E', C), up and gate (E', d, f), down (E', f, d) -> y
    (G, Tg, d), summed over the E' experts given (all of them on one
    device; a rank's own on a mesh, whose sums are then partial)."""
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch, xg)  # (G, E, C, d)
    h = torch.einsum("gecd,edf->gecf", expert_in, up)
    g = torch.einsum("gecd,edf->gecf", expert_in, gate)
    h = h * activation(g, act)
    expert_out = torch.einsum("gecf,efd->gecd", h, down)
    return torch.einsum("gtec,gecd->gtd", combine.to(xg.dtype), expert_out)
