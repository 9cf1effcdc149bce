"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract of
``repro/kernels/ref.py``): the two attention oracles, the RASK objective
(``rask_objective_reference``) and its analytic VJP (``rask_objective_grad``,
transcribed from ``repro/kernels/rask_objective.py``).

These are the semantics of record, transcribed from the JAX oracles: masked
scores take -1e30 (not -inf), the softmax runs in float32, and the
probabilities are cast to the value dtype before the second product. The
CPU path runs them (``kernels/ops.py``), the tests hold them against the
JAX package, and ``chip_smoke.py`` holds each CUDA kernel against them.
The objective's gathers and segment sums are indexed loads and
``index_add_`` here, where the JAX versions use one-hot matmuls; the
results are the same sums (``index_add_`` on a card adds in no fixed
order, which moves the last bits only).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              window: int = 0):
    """q: (B,H,S,D); k,v: (B,KH,T,D) with H = KH*G. Returns (B,H,S,D)."""
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, S, D)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k).float() * (D ** -0.5)
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)   # right-aligned
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v)
    return out.reshape(B, H, S, D)


def decode_attention_reference(q, k_cache, v_cache, length, start=0):
    """q: (B,H,D); caches: (B,S,KH,D); attend to cache slots [start, length).

    ``length``/``start`` are ints or (B,) integer tensors (one range per
    row, as the batched serving engine has). Returns (B,H,D).
    """
    B, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * (D ** -0.5)
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    start = torch.as_tensor(start, device=q.device).reshape(-1, 1)
    pos = torch.arange(S, device=q.device)[None, :]
    mask = (pos < length) & (pos >= start)                      # (B|1, S)
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache)
    return out.reshape(B, H, D)


# -- RASK batched objective (autoscaler Eq. (4) inner evaluation) -------------

def _powers(x, max_degree: int):
    """x^0..x^max_degree stacked on a new axis -2, by repeated products in
    the order of ``repro``'s cumulative product (no ``pow``, no 0**0)."""
    p = torch.ones_like(x)
    pows = [p]
    for _ in range(max_degree):
        p = p * x
        pows.append(p)
    return torch.stack(pows, dim=-2)


def _select(pows, exponents):
    """pows (K, R, d+1, F), exponents (R, T, F) -> x^e per (K, R, T, F)."""
    K, R, d1, F = pows.shape
    T = exponents.shape[1]
    idx = exponents.long()[None, :, :, None, :].expand(K, R, T, 1, F)
    return torch.gather(pows[:, :, None].expand(K, R, T, d1, F), 3,
                        idx)[:, :, :, 0, :]


def rask_objective_reference(A, rel_gather, w, exponents, term_mask, x_scale,
                             slo_kind, slo_service, slo_weight, slo_target,
                             slo_pidx, slo_ridx, rps, *, n_services: int,
                             max_degree: int):
    """Per-service weighted SLO fulfillment for K candidate assignments.

    A:          (K, D)        candidate decision vectors (raw parameter units)
    rel_gather: (R, F)  int32 indices of each relation's features in a
    w:          (R, T)        stacked polynomial weights (0 on padded terms)
    exponents:  (R, T, F) int32 term exponent tables (0 on padding)
    term_mask:  (R, T)        1.0 real term / 0.0 padding
    x_scale:    (R, F)        feature conditioning (1.0 on padding)
    slo_kind:   (Q,) int32    0 = parameter metric, 1 = completion, 2 = relation
    slo_service/slo_weight/slo_target: (Q,) per-SLO service index/weight/target
    slo_pidx:   (Q,) int32    decision index of the metric (kind 0)
    slo_ridx:   (Q,) int32    relation index of the metric (kinds 1 and 2)
    rps:        (S,)          per-service request load

    Returns (K, n_services): sum of weight * min(metric/target, 1) per
    service, where the completion SLO (kind 1) reads
    min(pred / (rps * target), 1).
    """
    A = A.float()
    svc = slo_service.long()
    xs = A[:, rel_gather.long()] / x_scale                    # (K, R, F)
    vals = _select(_powers(xs, max_degree), exponents)        # (K, R, T, F)
    terms = torch.prod(vals, dim=-1) * term_mask              # (K, R, T)
    preds = torch.sum(terms * w, dim=-1)                      # (K, R)
    numer = torch.where(slo_kind == 0, A[:, slo_pidx.long()],
                        preds[:, slo_ridx.long()])
    denom = torch.where(slo_kind == 1,
                        torch.clamp_min(rps[svc] * slo_target, 1e-9),
                        slo_target)
    phi = torch.minimum(numer / denom, torch.ones_like(numer))
    out = torch.zeros((A.shape[0], n_services), dtype=A.dtype,
                      device=A.device)
    return out.index_add_(1, svc, slo_weight * phi)


def rask_objective_grad(A, ct, rel_gather, w, exponents, term_mask, x_scale,
                        slo_kind, slo_service, slo_weight, slo_target,
                        slo_pidx, slo_ridx, rps, *, n_services: int,
                        max_degree: int):
    """Analytic VJP of the objective w.r.t. the candidates: cotangent
    ``ct`` (K, S) -> dJ/dA (K, D) (``repro``'s ``rask_objective_grad``).

    The per-SLO cotangent goes back onto the parameters (``slo_pidx``) and
    the predictions (``slo_ridx``), the polynomial product rule runs over
    the "product of the OTHER features" (exact at zeros, no division), and
    the per-feature cotangent goes back onto the decision vector
    (``rel_gather``); indices repeat, so both scatters add. At the clip
    boundary ``ratio == 1`` it takes the half-subgradient, as ``jax.grad``
    of the reference does."""
    del n_services
    A = A.float()
    ct = ct.float()
    K, D = A.shape
    R, T, F = exponents.shape
    svc, pidx, ridx = (slo_service.long(), slo_pidx.long(),
                       slo_ridx.long())
    wm = w * term_mask                                        # (R, T)
    xinv = 1.0 / x_scale                                      # (R, F)
    x = A[:, rel_gather.long()] * xinv                        # (K, R, F)
    pows = _powers(x, max_degree)                             # (K, R, d+1, F)
    vals = _select(pows, exponents)
    # power rule e * x^(e-1), from the same table (0 where e == 0)
    scale = torch.arange(1, max_degree + 1, dtype=x.dtype, device=x.device)
    dpows = torch.cat([torch.zeros_like(pows[:, :, :1]),
                       pows[:, :, :-1] * scale[:, None]], dim=2)
    dvals = _select(dpows, exponents)
    terms = torch.prod(vals, dim=-1)                          # (K, R, T)
    preds = torch.sum(terms * wm, dim=-1)                     # (K, R)

    is_p = (slo_kind == 0).to(A.dtype)
    is_c = (slo_kind == 1).to(A.dtype)
    numer = is_p * A[:, pidx] + (1 - is_p) * preds[:, ridx]
    denom = is_c * torch.clamp_min(rps[svc] * slo_target, 1e-9) \
        + (1 - is_c) * slo_target
    ratio = numer / denom

    dphi = ct[:, svc] * slo_weight                            # (K, Q)
    clip = torch.where(ratio < 1.0, 1.0,
                       torch.where(ratio == 1.0, 0.5, 0.0))   # min() subgrad
    dnumer = dphi * clip / denom
    dA = torch.zeros((K, D), dtype=A.dtype, device=A.device)
    dA.index_add_(1, pidx, dnumer * is_p)
    dpreds = torch.zeros((K, R), dtype=A.dtype, device=A.device)
    dpreds.index_add_(1, ridx, dnumer * (1 - is_p))
    dterms = dpreds[:, :, None] * wm                          # (K, R, T)
    dx = []
    for f in range(F):
        other = torch.ones_like(terms)
        for f2 in range(F):
            if f2 != f:
                other = other * vals[..., f2]
        dx.append(torch.sum(dterms * dvals[..., f] * other, dim=-1))
    dx = torch.stack(dx, dim=-1) * xinv                       # (K, R, F)
    dx_a = torch.zeros((K, D), dtype=A.dtype, device=A.device)
    dx_a.index_add_(1, rel_gather.long().reshape(-1), dx.reshape(K, -1))
    return dA + dx_a
