"""Shared neural building blocks: plain functions over dicts of tensors
(the counterpart of ``repro/models/layers.py``).

Conventions, as in the JAX package:
  * activations keep ``cfg.dtype``; norms and softmax compute in float32;
  * attention is grouped-query: H query heads share KH kv heads (G = H/KH);
  * a linear weight is stored (out, in) as PyTorch's ``F.linear`` wants it
    (the JAX package stores (in, out); ``convert.py`` transposes).

Self-attention only; cross-attention waits for the encoder-decoder slice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig

Params = Dict[str, torch.Tensor]


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype) -> Params:
    w = torch.randn((d_out, d_in), generator=gen, device=gen.device,
                    dtype=torch.float32) * d_in ** -0.5
    return {"w": w.to(dtype)}


def linear(p: Params, x):
    return F.linear(x, p["w"], p.get("b"))


def init_norm(d: int, dtype: torch.dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def norm(p: Params, x, eps: float = 1e-6):
    """RMSNorm in float32, times ``scale`` (not 1 + scale), cast back."""
    y = F.rms_norm(x.float(), (x.shape[-1],), eps=eps)
    return (y * p["scale"]).to(x.dtype)          # bf16 scale promotes to f32


def rope_angles(positions, d: int, theta: float):
    """(cos, sin) of the rotary angles, float32, shape positions + (d/2,).

    Every layer of a forward pass rotates at the same positions, so the
    decoder computes these once per pass, not once per layer."""
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, rot):
    """Rotate the two halves of the last axis of x (..., S, D) by
    ``rot = rope_angles(...)`` broadcastable to (..., S, D/2)."""
    cos, sin = rot
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., S, D); positions broadcastable to (..., S)."""
    return apply_rope(x, rope_angles(positions, x.shape[-1], theta))


def activation(x, kind: str):
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             d_ff: Optional[int] = None) -> Params:
    f = d_ff or cfg.d_ff
    p = {"up": init_linear(gen, cfg.d_model, f, dtype),
         "down": init_linear(gen, f, cfg.d_model, dtype)}
    if cfg.gated_mlp:
        p["gate"] = init_linear(gen, cfg.d_model, f, dtype)
    return p


def mlp(p: Params, x, cfg: ModelConfig):
    h = linear(p["up"], x)
    if "gate" in p:
        h = h * activation(linear(p["gate"], x), cfg.act)
    else:
        h = activation(h, cfg.act)
    return linear(p["down"], h)


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> Params:
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {"wq": init_linear(gen, d, h * dh, dtype),
         "wk": init_linear(gen, d, kh * dh, dtype),
         "wv": init_linear(gen, d, kh * dh, dtype),
         "wo": init_linear(gen, h * dh, d, dtype)}
    if cfg.qk_norm:
        p["q_norm"] = init_norm(dh, dtype, gen.device)
        p["k_norm"] = init_norm(dh, dtype, gen.device)
    return p


def attention(p: Params, x, cfg: ModelConfig, *, rot,
              window: Optional[int] = None,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: Optional[torch.Tensor] = None):
    """Causal self-attention, optionally against a KV cache.

    x: (B,S,d_model); ``rot``: ``rope_angles`` of the (B,S) positions.
    ``window`` is a plain int (None = unbounded), so prefill always takes
    the flash kernel.

    Prefill (``cache`` None): attends within x; returns (out, (k, v)) with
    k, v of shape (B,S,KH,D) for the caller's cache.

    Decode (S == 1): ``cache`` = (k_cache, v_cache), each (B,S_max,KH,D),
    is written IN PLACE at ``cache_pos`` (B,) (no second cache copy per
    step); the write index clamps to S_max - 1 as JAX's
    ``dynamic_update_slice`` does, so a free-running idle lane past S_max
    never indexes out of bounds. Row b then attends to
    [max(0, length - window), length) with length = cache_pos + 1.
    """
    B, S, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = linear(p["wq"], x).reshape(B, S, h, dh)
    k = linear(p["wk"], x).reshape(B, S, kh, dh)
    v = linear(p["wv"], x).reshape(B, S, kh, dh)
    if cfg.qk_norm:
        q = norm(p["q_norm"], q)
        k = norm(p["k_norm"], k)
    rot = (rot[0][:, None], rot[1][:, None])             # over heads
    q = apply_rope(q.transpose(1, 2), rot)               # (B, H, S, D)
    k = apply_rope(k.transpose(1, 2), rot)               # (B, KH, S, D)

    if cache is None:
        vt = v.transpose(1, 2).contiguous()
        out = kops.flash_attention(q.contiguous(), k.contiguous(), vt,
                                   causal=True, window=window or 0)
        out = out.transpose(1, 2)                           # (B,S,H,D)
        new_kv = (k.transpose(1, 2), v)
    else:
        if S != 1:
            raise ValueError("decode attends one new token per row")
        ck, cv = cache
        rows = torch.arange(B, device=x.device)
        idx = cache_pos.clamp(max=ck.shape[1] - 1)
        ck[rows, idx] = k[:, :, 0].to(ck.dtype)
        cv[rows, idx] = v[:, 0].to(cv.dtype)
        length = cache_pos + 1
        start = torch.zeros_like(length) if window is None \
            else (length - window).clamp(min=0)
        out = kops.decode_attention(
            q[:, :, 0].contiguous(), ck, cv, length.to(torch.int32),
            start.to(torch.int32))[:, None]                 # (B,1,H,D)
        new_kv = (ck, cv)
    out = out.reshape(B, S, h * dh).to(x.dtype)
    return linear(p["wo"], out), new_kv
