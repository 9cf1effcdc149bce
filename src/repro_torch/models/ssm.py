"""Mamba-2 block (state-space duality, arXiv:2405.21060): the counterpart of
``repro/models/ssm.py``.

in_proj -> [z | x | B | C | dt] -> causal conv over (x,B,C) -> SiLU ->
SSD(x dt, exp(dt A)) -> gate by SiLU(z) -> RMSNorm -> out_proj.

Prefill and the training loss run the chunked SSD (``kernels/ops.ssd``:
the CUDA kernel on the card, and under autograd its backward kernel too);
decode runs the O(1) recurrence (``ref.ssd_decode_reference``, plain
PyTorch, as ``repro`` runs it in plain jnp) with a (conv, ssm) state cache.
The casts are ``repro``'s: ``dt`` and ``A`` are computed in float32 and
cast to the activation dtype before the scan, and the decode recurrence and
its state stay in the model dtype.

On a mesh (DTensors, ``launch/steps.py``) ``in_proj``'s columns are
gathered over "model" before the split, the conv runs on the whole
channel axis with its weights gathered, the scan runs on each rank's
heads (``kernels/ops.py::_local_ssd``), and the gated output is gathered
over "model" before ``out_norm``, whose RMS is over the whole width.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels import ref as kref
from . import spmd
from .config import ModelConfig
from .layers import init_linear, init_norm, linear, norm

Params = Dict[str, torch.Tensor]


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> Params:
    """Random weights with ``repro``'s scales, drawn from ``gen`` on
    ``gen.device``. ``A_log`` and ``dt_bias`` are float32 whatever
    ``dtype`` is."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    dev = gen.device
    return {
        "in_proj": init_linear(gen, d, 2 * di + 2 * n + h, dtype),
        "conv_w": (torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                               device=dev) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "D": torch.ones((h,), dtype=dtype, device=dev),
        "out_norm": init_norm(di, dtype, dev),
        "out_proj": init_linear(gen, di, d, dtype),
    }


def _split(cfg: ModelConfig, proj):
    """[z | x B C | dt]. On a mesh the projection's columns are gathered
    over "model" first: its shards do not align with the segments."""
    proj = spmd.over_model(proj)
    di, n = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xBC = proj[..., di:di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xBC, dt


def _conv_weights(p: Params):
    """The depthwise conv's (w, b), whole on every rank on a mesh: their
    channels [x | B | C] are sharded over "model", and the conv runs on
    the whole channel axis (B and C are needed whole by every head), on
    each rank's rows (``spmd.shardwise``)."""
    return spmd.replicated(p["conv_w"]), spmd.replicated(p["conv_b"])


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, width K: (B,L,C) -> (B,L,C)."""
    K, L = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + L, :] * w[i] for i in range(K))
    return out + b


def _dt_A(p: Params, dt):
    """softplus(dt + dt_bias) and A = -exp(A_log), both float32."""
    return F.softplus(dt.float() + p["dt_bias"]), -torch.exp(p["A_log"])


def mamba_prefill(p: Params, x, cfg: ModelConfig,
                  initial: Optional[Tuple] = None):
    """x: (B,L,d) -> (y, (conv_state, ssm_state)).

    L is padded up to a multiple of ssm_chunk; padded positions get dt = 0,
    which makes their state update the identity (exp(0) = 1 decay, 0
    input), so the final state is exact. The conv state holds the last K-1
    raw inputs of the unpadded prompt, so a prompt needs at least K-1
    tokens.
    """
    Bsz, L, _ = x.shape
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    if L < cfg.ssm_conv - 1:
        raise ValueError(f"a Mamba-2 prefill needs at least ssm_conv - 1 = "
                         f"{cfg.ssm_conv - 1} tokens to fill its conv state, "
                         f"got {L}")
    proj = linear(p["in_proj"], x)
    z, xBC, dt = _split(cfg, proj)
    conv_in = xBC
    xBC = spmd.shardwise(lambda xBC, w, b: F.silu(_causal_conv(xBC, w, b)),
                         xBC, *_conv_weights(p))
    xs = xBC[..., :di].reshape(Bsz, L, h, hd)
    Bmat = xBC[..., di:di + n]
    Cmat = xBC[..., di + n:]
    dt, A = _dt_A(p, dt)

    pad = (-L) % cfg.ssm_chunk
    if pad:                                       # dt = 0 -> identity step
        xs, Bmat, Cmat, dt = (spmd.shardwise(
            lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)), t)
            for t in (xs, Bmat, Cmat, dt))

    init_state = initial[1] if initial is not None else None
    y, final_state = kops.ssd(
        xs.contiguous(), dt.to(xs.dtype).contiguous(), A.to(xs.dtype),
        Bmat.contiguous(), Cmat.contiguous(), chunk=cfg.ssm_chunk,
        initial_state=init_state)
    y = y[:, :L] + xs[:, :L] * p["D"][None, None, :, None]
    y = y.reshape(Bsz, L, di)
    y = spmd.over_model(y * F.silu(z))            # the norm's whole width
    y = norm(p["out_norm"], y)
    conv_state = conv_in[:, -(cfg.ssm_conv - 1):, :]   # last K-1 raw inputs
    return linear(p["out_proj"], y), (conv_state, final_state)


def mamba_decode(p: Params, x, cfg: ModelConfig, cache: Tuple):
    """x: (B,1,d); cache: (conv_state (B,K-1,C), ssm_state (B,h,hd,n)).
    Returns (y (B,1,d), (conv_state, ssm_state)), new tensors."""
    Bsz = x.shape[0]
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_state, ssm_state = cache
    proj = linear(p["in_proj"], x[:, 0, :])
    z, xBC, dt = _split(cfg, proj)
    window = torch.cat([conv_state, xBC[:, None, :]], dim=1)     # (B,K,C)
    conv_w, conv_b = _conv_weights(p)
    conv_out = torch.einsum("bkc,kc->bc", window, conv_w) + conv_b
    xBC_c = F.silu(conv_out)
    xs = xBC_c[..., :di].reshape(Bsz, h, hd)
    Bmat = xBC_c[..., di:di + n]
    Cmat = xBC_c[..., di + n:]
    dt, A = _dt_A(p, dt)
    y, ssm_state = kref.ssd_decode_reference(
        xs, dt.to(xs.dtype), A.to(xs.dtype), Bmat, Cmat, ssm_state)
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(Bsz, di)
    y = spmd.over_model(y * F.silu(z))
    y = norm(p["out_norm"], y)
    out = linear(p["out_proj"], y)[:, None, :]
    return out, (window[:, 1:, :], ssm_state)


def mamba_state_shapes(cfg: ModelConfig, batch: int):
    """(conv_state, ssm_state) shapes for cache allocation."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return ((batch, cfg.ssm_conv - 1, conv_dim),
            (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
