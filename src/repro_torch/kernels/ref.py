"""Plain PyTorch versions of the port's attention kernels (the ``ref.py``
contract of ``repro/kernels/ref.py``).

These are the semantics of record, transcribed from the JAX oracles: masked
scores take -1e30 (not -inf), the softmax runs in float32, and the
probabilities are cast to the value dtype before the second product. The
CPU path runs them (``kernels/ops.py``), the tests hold them against the
JAX package, and ``chip_smoke.py`` holds each CUDA kernel against them.
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
