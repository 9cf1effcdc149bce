"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract of
``repro/kernels/ref.py``): the two attention oracles, attention's row
log-sum-exp and backward (``flash_attention_lse_reference``,
``flash_attention_backward_reference``: ``_ca_bwd``'s maths), the
Mamba-2 chunked SSD scan (``ssd_reference``) and its one-step recurrence
(``ssd_decode_reference``), the RASK objective (``rask_objective_reference``)
and its analytic VJP (``rask_objective_grad``, transcribed from
``repro/kernels/rask_objective.py``).

These are the semantics of record, transcribed from the JAX oracles: masked
scores take -1e30 (not -inf), the softmax runs in float32, and the
probabilities are cast to the value dtype before the second product. The
CPU path runs them (``kernels/ops.py``), the tests hold them against the
JAX package, and ``chip_smoke.py`` holds each CUDA kernel against them.
The objective's gathers and segment sums are ``gather`` and
``scatter_add_`` over a leading row axis here, where the JAX versions use
one-hot matmuls under ``vmap``; the results are the same sums
(``scatter_add_`` on a card adds in no fixed order, which moves the last
bits only).
"""
from __future__ import annotations

from typing import Optional, Tuple

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
    scores = scores.masked_fill(
        ~attention_mask(S, T, causal, window, q.device), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v)
    return out.reshape(B, H, S, D)


def attention_mask(S: int, T: int, causal: bool, window: int, device):
    """(S, T) True where a query (right-aligned at T - S) sees a key."""
    qpos = torch.arange(S, device=device)[:, None] + (T - S)
    kpos = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    return mask


def _scaled_scores(q, k, causal: bool, window: int):
    """float32 masked scores q k^T / sqrt(D), (B,KH,G,S,T), from the
    operands as given (no rounding of the product: ``repro``'s backward
    takes them at float32)."""
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KH, H // KH, S, D)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * (D ** -0.5)
    return scores.masked_fill(
        ~attention_mask(S, T, causal, window, q.device), NEG_INF)


def flash_attention_lse_reference(q, k, *, causal: bool = True,
                                  window: int = 0):
    """The row log-sum-exp of the masked scaled scores: q (B,H,S,D), k
    (B,KH,T,D) -> float32 (B,H,S), what the forward kernels return as
    ``lse`` (their m + log l)."""
    B, H, S, _ = q.shape
    return torch.logsumexp(_scaled_scores(q, k, causal, window),
                           dim=-1).reshape(B, H, S)


def flash_attention_backward_reference(q, k, v, o, lse, do, *,
                                       causal: bool = True, window: int = 0):
    """Attention's gradient from the forward's output and row log-sum-exp:
    (q, k, v, o, lse, do) -> (dq, dk, dv) in the inputs' dtypes.

    The maths of ``repro/kernels/ref.py::_ca_bwd`` in the port's (B,H,S,D)
    / (B,KH,T,D) layout, without its chunking: delta = sum(dO * O),
    P = exp(S scale - lse), dV = P^T dO, dS = P (dO V^T - delta) scale,
    dQ = dS K, dK = dS^T Q, dK and dV summed over the G query heads of a
    kv head. Masks are right-aligned at T - S as in the forward. The
    products take float32 operands; P and dS are rounded to dO's and q's
    dtype before the products that read them, as ``_ca_bwd`` rounds them
    (a no-op in float32). ``lse``: float32 (B,H,S)."""
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    G = H // KH
    qf = q.float().reshape(B, KH, G, S, D)
    dof = do.float().reshape(B, KH, G, S, D)
    kf, vf = k.float(), v.float()
    delta = (dof * o.float().reshape(B, KH, G, S, D)).sum(-1)   # (B,KH,G,S)
    p = torch.exp(_scaled_scores(q, k, causal, window)
                  - lse.float().reshape(B, KH, G, S)[..., None])
    dv = torch.einsum("bkgst,bkgsd->bktd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bkgsd,bktd->bkgst", dof, vf)
    ds = (p * (dp - delta[..., None]) * (D ** -0.5)).to(q.dtype).float()
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qf)
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


# -- Mamba-2 SSD (state-space duality) chunked scan ----------------------------

CUMSUM_RUN = 16     # rows a cumulative sum runs through before it carries


def _rounded_prefix(x, dtype):
    """Sequential partial sums over the last axis of float32 ``x``, each
    rounded to ``dtype`` (returned as float32)."""
    acc = x[..., 0]
    out = [acc]
    for i in range(1, x.shape[-1]):
        acc = (acc + x[..., i]).to(dtype).float()
        out.append(acc)
    return torch.stack(out, dim=-1)


def _cumsum(x):
    """Cumulative sum over the last axis, rounded where ``repro``'s rounds.

    In float32 it is a plain cumulative sum. In a lower precision every
    partial sum rounds to x's dtype: sequentially within runs of 16
    entries, then across the runs' totals, then once more where a run adds
    its offset. That is how XLA's CPU cumsum rounds a bf16 vector of up to
    a few hundred entries, so ``repro``'s bf16 scan. The rounding points
    matter: over a 128-row chunk the cumulative decay reaches ~-100, where
    one bf16 step is 0.5, and exp(cs_i - cs_j) moves by tens of percent
    with them (the CUDA kernel's scan rounds at the same points).
    """
    if x.dtype == torch.float32:
        return torch.cumsum(x, dim=-1)
    T = x.shape[-1]
    runs = -(-T // CUMSUM_RUN)
    xf = torch.nn.functional.pad(x.float(), (0, runs * CUMSUM_RUN - T))
    within = _rounded_prefix(xf.reshape(*x.shape[:-1], runs, CUMSUM_RUN),
                             x.dtype)
    offsets = _rounded_prefix(within[..., -1], x.dtype)
    offsets = torch.cat([torch.zeros_like(offsets[..., :1]),
                         offsets[..., :-1]], dim=-1)
    cs = (within + offsets[..., None]).to(x.dtype)
    return cs.reshape(*x.shape[:-1], runs * CUMSUM_RUN)[..., :T]


def _segsum(x):
    """(..., T) -> (..., T, T) lower-triangular segment sums cs_i - cs_j,
    -inf above the diagonal, so that ``exp`` gives 0 there (the upper
    triangle's ``exp(+large) * 0`` would be NaN)."""
    T = x.shape[-1]
    cs = _cumsum(x)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return ss.masked_fill(~mask, float("-inf"))


def ssd_reference(x, dt, A, B, C, *, chunk: int = 128,
                  initial_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Mamba-2, arXiv:2405.21060 Listing 1) with dt folded in.

    x:  (b, l, h, p)   input sequences per head
    dt: (b, l, h)      positive step sizes (softplus'd upstream)
    A:  (h,)           negative per-head decay
    B:  (b, l, n)      input projection (single group, shared across heads)
    C:  (b, l, n)      output projection
    Returns (y: (b,l,h,p), final_state: (b,h,p,n)), both in x's dtype.

    The dtype flow is ``repro``'s: the chunk-local products run in the
    input dtype, the inter-chunk recurrence in float32.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence {l} not divisible by chunk {chunk}")
    c = l // chunk

    dA = dt * A[None, None, :]                      # (b, l, h)
    xd = x * dt[..., None]                          # dt-weighted input

    xd = xd.reshape(b, c, chunk, h, p)
    dA = dA.reshape(b, c, chunk, h).permute(0, 3, 1, 2)        # (b,h,c,s)
    Bc = B.reshape(b, c, chunk, n)
    Cc = C.reshape(b, c, chunk, n)
    dA_cs = _cumsum(dA)                                         # (b,h,c,s)

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(dA))                                  # (b,h,c,s,s)
    Y_diag = torch.einsum("bcsn,bczn,bhcsz,bczhp->bcshp", Cc, Bc, L, xd)

    # 2. chunk-final states
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)           # (b,h,c,s)
    states = torch.einsum("bczn,bhcz,bczhp->bchpn", Bc, decay_states, xd)

    # 3. inter-chunk recurrence in float32
    chunk_decay = torch.exp(dA_cs[..., -1]).float()             # (b,h,c)
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=x.dtype,
                                    device=x.device)
    carry = initial_state.float()
    prev = []                                       # state entering chunk i
    for i in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, i, None, None] \
            + states[:, i].float()
    prev_states = torch.stack(prev, dim=1)                      # (b,c,h,p,n)

    # 4. state -> output
    state_decay = torch.exp(dA_cs)                              # (b,h,c,s)
    Y_off = torch.einsum("bcsn,bchpn,bhcs->bcshp", Cc,
                         prev_states.to(x.dtype), state_decay.to(x.dtype))

    y = (Y_diag + Y_off).reshape(b, l, h, p)
    return y.to(x.dtype), carry.to(x.dtype)


def ssd_backward_reference(x, dt, A, B, C, dy, dfinal=None, *,
                           chunk: int = 128,
                           initial_state: Optional[torch.Tensor] = None):
    """The SSD scan's gradient: cotangents dy (b,l,h,p) of y and dfinal
    (b,h,p,n) of the final state (None: zeros) -> (dx, ddt, dA, dB, dC,
    dinitial) in the inputs' dtypes (dinitial in x's where there is no
    initial state: the gradient of a zero state).

    The vector-Jacobian product of ``ssd_reference``, written out per
    (row, head, chunk) in the passes of the CUDA kernel
    (``csrc/ssd_scan_backward.cu``), with cs the chunk's cumulative sum of
    dt A, xd = x dt, prev_c the state entering chunk c, E_c = exp(cs_last)
    and L_ij = exp(cs_i - cs_j) for i >= j:

    1. off-diagonal output: dprev_c = sum_i exp(cs_i) dy_i (x) C_i;
       dC_i += exp(cs_i) prev_c^T dy_i, and cs_i gets C_i . that.
    2. reverse state passing: dS_last = dfinal, dS_{c-1} = dS_c E_c +
       dprev_c; dinitial = dS_{-1}; cs_last gets E_c <dS_c, prev_c>.
    3. local state (w_j = exp(cs_last - cs_j)): dxd_j += w_j dS_c B_j,
       dB_j += w_j dS_c^T xd_j; w_j's share goes to cs_last and cs_j.
    4. diagonal block (P = (C B^T) o L, M = (dy xd^T) o L): dxd += P^T dy,
       dC += M B, dB += M^T C; cs_i gets the row sums of P o (dy xd^T) and
       cs_j loses its column sums.
    5. a reverse cumulative sum in the chunk turns d cs into d(dt A):
       ddt = sum_p dxd x + A d(dt A), dA = sum dt d(dt A), dx = dxd dt.
    B and C are one group that every head shares: dB and dC sum over the
    heads.

    Arithmetic in float32 from the inputs as given; cs is rounded where
    the forward rounds it (``_cumsum``: in bf16 the backward reads the
    forward's cumulative sum), every other rounding of the bf16 forward is
    taken as the identity, as autograd takes a cast."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"sequence {l} not divisible by chunk {chunk}")
    c = l // chunk
    cs = _cumsum((dt * A[None, None, :]).reshape(b, c, chunk, h)
                 .permute(0, 3, 1, 2)).float()                  # (b,h,c,s)
    xf = x.float().reshape(b, c, chunk, h, p)
    dtf = dt.float().reshape(b, c, chunk, h)
    xd = xf * dtf[..., None]
    Bc = B.float().reshape(b, c, chunk, n)
    Cc = C.float().reshape(b, c, chunk, n)
    dyc = dy.float().reshape(b, c, chunk, h, p)
    last = cs[..., -1]                                          # (b,h,c)
    E = torch.exp(last)
    w = torch.exp(last[..., None] - cs)                         # (b,h,c,s)

    # the states entering the chunks, as the forward passes them
    local = torch.einsum("bczn,bhcz,bczhp->bchpn", Bc, w, xd)
    carry = (torch.zeros((b, h, p, n), device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * E[:, :, i, None, None] + local[:, i]
    prev = torch.stack(prev, dim=1)                             # (b,c,h,p,n)

    # 1. off-diagonal output
    ecs = torch.exp(cs)
    dprev = torch.einsum("bhcs,bcshp,bcsn->bchpn", ecs, dyc, Cc)
    dC = torch.einsum("bhcs,bchpn,bcshp->bcshn", ecs, prev, dyc)
    dcs = torch.einsum("bcshn,bcsn->bhcs", dC, Cc)

    # 2. reverse state passing
    g = (torch.zeros((b, h, p, n), device=x.device) if dfinal is None
         else dfinal.float())
    dS = [None] * c
    dlast = torch.zeros_like(last)
    for i in reversed(range(c)):
        dS[i] = g
        dlast[:, :, i] = E[:, :, i] * (g * prev[:, i]).sum((-2, -1))
        g = g * E[:, :, i, None, None] + dprev[:, i]
    dinit = g
    dS = torch.stack(dS, dim=1)                                 # (b,c,h,p,n)

    # 3. local state
    gb = torch.einsum("bchpn,bczn->bczhp", dS, Bc)
    wz = w.permute(0, 2, 3, 1)                                  # (b,c,s,h)
    dxd = wz[..., None] * gb
    dB = torch.einsum("bhcz,bchpn,bczhp->bczhn", w, dS, xd)
    wdw = wz * (xd * gb).sum(-1)                                # (b,c,s,h)
    wdw = wdw.permute(0, 3, 1, 2)                               # (b,h,c,s)
    dcs = dcs - wdw
    dlast = dlast + wdw.sum(-1)

    # 4. diagonal block
    seg = cs[..., :, None] - cs[..., None, :]
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    L = torch.exp(seg.masked_fill(~tril, float("-inf")))       # (b,h,c,i,j)
    P = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, None] * L
    DX = torch.einsum("bcihp,bcjhp->bhcij", dyc, xd)
    M = DX * L
    dxd = dxd + torch.einsum("bhcij,bcihp->bcjhp", P, dyc)
    dC = dC + torch.einsum("bhcij,bcjn->bcihn", M, Bc)
    dB = dB + torch.einsum("bhcij,bcin->bcjhn", M, Cc)
    Q = P * DX
    dcs = dcs + Q.sum(-1) - Q.sum(-2)
    dcs[..., -1] += dlast

    # 5. back to the inputs
    da = torch.flip(torch.cumsum(torch.flip(dcs, (-1,)), -1), (-1,))
    da = da.permute(0, 2, 3, 1).reshape(b, l, h)                # d(dt A)
    dxd = dxd.reshape(b, l, h, p)
    dx = dxd * dt.float()[..., None]
    ddt = (dxd * x.float()).sum(-1) + A.float() * da
    dA = (dt.float() * da).sum((0, 1))
    dB = dB.sum(-2).reshape(b, l, n)
    dC = dC.sum(-2).reshape(b, l, n)
    init_dtype = x.dtype if initial_state is None else initial_state.dtype
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB.to(B.dtype),
            dC.to(C.dtype), dinit.to(init_dtype))


def ssd_decode_reference(x, dt, A, B, C, state):
    """One recurrent SSD step, in the dtype of its inputs.

    x: (b,h,p); dt: (b,h); A: (h,); B,C: (b,n); state: (b,h,p,n).
    h_t = exp(dt A) h_{t-1} + dt * x (x) B ;  y = h_t . C
    """
    dA = torch.exp(dt * A[None, :])                             # (b,h)
    upd = (dt[..., None] * x)[..., None] * B[:, None, None, :]  # (b,h,p,n)
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, C)
    return y.to(x.dtype), state


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
    """pows (B, K, R, d+1, F), exponents (B, R, T, F) -> x^e per
    (B, K, R, T, F)."""
    B, K, R, d1, F = pows.shape
    T = exponents.shape[2]
    idx = exponents.long()[:, None, :, :, None, :].expand(B, K, R, T, 1, F)
    return torch.gather(pows[:, :, :, None].expand(B, K, R, T, d1, F), 4,
                        idx)[..., 0, :]


def _take(x, idx):
    """x (B, K, N) at per-row indices idx (B, M) -> (B, K, M)."""
    return torch.gather(x, 2, idx[:, None].expand(-1, x.shape[1], -1))


def _add_at(out, idx, src):
    """out (B, K, N) += src (B, K, M) at per-row indices idx (B, M); a
    repeated index adds in the order of M."""
    return out.scatter_add_(2, idx[:, None].expand(-1, src.shape[1], -1),
                            src)


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

    Over B problem rows at once (``repro``'s ``vmap`` of the kernel): A
    (B, K, D) with every table carrying a leading B -> (B, K, n_services),
    in tensor ops over the row axis.
    """
    tables = (rel_gather, w, exponents, term_mask, x_scale, slo_kind,
              slo_service, slo_weight, slo_target, slo_pidx, slo_ridx, rps)
    if A.dim() == 2:            # one problem: the row axis' case B = 1
        return rask_objective_reference(A[None], *(t[None] for t in tables),
                                        n_services=n_services,
                                        max_degree=max_degree)[0]
    A = A.float()
    B, K, _ = A.shape
    R, F = rel_gather.shape[1:]
    svc = slo_service.long()
    xs = _take(A, rel_gather.long().reshape(B, R * F)).reshape(
        B, K, R, F) / x_scale[:, None]                        # (B, K, R, F)
    vals = _select(_powers(xs, max_degree), exponents)     # (B, K, R, T, F)
    terms = torch.prod(vals, dim=-1) * term_mask[:, None]     # (B, K, R, T)
    preds = torch.sum(terms * w[:, None], dim=-1)             # (B, K, R)
    numer = torch.where((slo_kind == 0)[:, None],
                        _take(A, slo_pidx.long()),
                        _take(preds, slo_ridx.long()))        # (B, K, Q)
    denom = torch.where(slo_kind == 1,
                        torch.clamp_min(torch.gather(rps, 1, svc)
                                        * slo_target, 1e-9),
                        slo_target)                           # (B, Q)
    phi = torch.minimum(numer / denom[:, None], torch.ones_like(numer))
    out = torch.zeros((B, K, n_services), dtype=A.dtype, device=A.device)
    return _add_at(out, svc, slo_weight[:, None] * phi)


def rask_objective_grad(A, ct, rel_gather, w, exponents, term_mask, x_scale,
                        slo_kind, slo_service, slo_weight, slo_target,
                        slo_pidx, slo_ridx, rps, *, n_services: int,
                        max_degree: int):
    """Analytic VJP of the objective w.r.t. the candidates: cotangent
    ``ct`` (K, S) -> dJ/dA (K, D) (``repro``'s ``rask_objective_grad``), or
    over B rows, ct (B, K, S) -> (B, K, D) with batched tables.

    The per-SLO cotangent goes back onto the parameters (``slo_pidx``) and
    the predictions (``slo_ridx``), the polynomial product rule runs over
    the "product of the OTHER features" (exact at zeros, no division), and
    the per-feature cotangent goes back onto the decision vector
    (``rel_gather``); indices repeat, so both scatters add. At the clip
    boundary ``ratio == 1`` it takes the half-subgradient, as ``jax.grad``
    of the reference does."""
    tables = (rel_gather, w, exponents, term_mask, x_scale, slo_kind,
              slo_service, slo_weight, slo_target, slo_pidx, slo_ridx, rps)
    if A.dim() == 2:
        return rask_objective_grad(A[None], ct[None],
                                   *(t[None] for t in tables),
                                   n_services=n_services,
                                   max_degree=max_degree)[0]
    A = A.float()
    ct = ct.float()
    B, K, D = A.shape
    R, T, F = exponents.shape[1:]
    svc, pidx, ridx = (slo_service.long(), slo_pidx.long(),
                       slo_ridx.long())
    gather = rel_gather.long().reshape(B, R * F)
    wm = (w * term_mask)[:, None]                             # (B, 1, R, T)
    xinv = 1.0 / x_scale                                      # (B, R, F)
    x = _take(A, gather).reshape(B, K, R, F) * xinv[:, None]  # (B, K, R, F)
    pows = _powers(x, max_degree)                          # (B, K, R, d+1, F)
    vals = _select(pows, exponents)
    # power rule e * x^(e-1), from the same table (0 where e == 0)
    scale = torch.arange(1, max_degree + 1, dtype=x.dtype, device=x.device)
    dpows = torch.cat([torch.zeros_like(pows[:, :, :, :1]),
                       pows[:, :, :, :-1] * scale[:, None]], dim=3)
    dvals = _select(dpows, exponents)
    terms = torch.prod(vals, dim=-1)                          # (B, K, R, T)
    preds = torch.sum(terms * wm, dim=-1)                     # (B, K, R)

    is_p = (slo_kind == 0).to(A.dtype)[:, None]               # (B, 1, Q)
    is_c = (slo_kind == 1).to(A.dtype)
    numer = is_p * _take(A, pidx) + (1 - is_p) * _take(preds, ridx)
    denom = (is_c * torch.clamp_min(torch.gather(rps, 1, svc) * slo_target,
                                    1e-9)
             + (1 - is_c) * slo_target)[:, None]              # (B, 1, Q)
    ratio = numer / denom

    dphi = _take(ct, svc) * slo_weight[:, None]               # (B, K, Q)
    clip = torch.where(ratio < 1.0, 1.0,
                       torch.where(ratio == 1.0, 0.5, 0.0))   # min() subgrad
    dnumer = dphi * clip / denom
    dA = _add_at(torch.zeros((B, K, D), dtype=A.dtype, device=A.device),
                 pidx, dnumer * is_p)
    dpreds = _add_at(torch.zeros((B, K, R), dtype=A.dtype, device=A.device),
                     ridx, dnumer * (1 - is_p))
    dterms = dpreds[..., None] * wm                           # (B, K, R, T)
    dx = []
    for f in range(F):
        other = torch.ones_like(terms)
        for f2 in range(F):
            if f2 != f:
                other = other * vals[..., f2]
        dx.append(torch.sum(dterms * dvals[..., f] * other, dim=-1))
    dx = torch.stack(dx, dim=-1) * xinv[:, None]              # (B, K, R, F)
    dx_a = _add_at(torch.zeros((B, K, D), dtype=A.dtype, device=A.device),
                   gather, dx.reshape(B, K, R * F))
    return dA + dx_a
