"""The decoder program (dense LMs, including gemma3's local:global
interleave) and the ssm program (Mamba-2 stacks): the counterparts of
those programs in ``repro/models/transformer.py``.

JAX scans one homogeneous layer body over stacked parameters and carries
each layer's window as a traced scalar. PyTorch runs eagerly, so the port
keeps a list of per-layer parameter dicts, loops over them in Python, and
gives each layer its window as a plain int, which lets prefill go through
the flash kernel on every layer.

The decoder's cache is ``{"k", "v": (L, B, S_max, KH, D), "pos": (B,)
int64}``: one write cursor per row (JAX keeps a scalar and vmaps rows in
the engine). The ssm program's cache is ``{"conv": (L, B, K-1, C), "ssm":
(L, B, h, p, n), "pos": (B,) int64}`` in the model dtype, as in ``repro``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .config import ModelConfig
from .layers import (attention, init_attention, init_mlp, init_norm, mlp,
                     norm, rope_angles)
from .ssm import init_mamba, mamba_decode, mamba_prefill, mamba_state_shapes

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer_windows(cfg: ModelConfig) -> List[Optional[int]]:
    """Per-layer attention window; None means unbounded (global)."""
    if cfg.local_global_period:
        return [None if (i + 1) % cfg.local_global_period == 0
                else cfg.window for i in range(cfg.n_layers)]
    return [cfg.window or None] * cfg.n_layers


def init_decoder(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights with the JAX package's scales, drawn from ``gen`` on
    ``gen.device`` (the numbers differ from ``jax.random``'s)."""
    dtype, dev = _dtype(cfg), gen.device
    layers = [{"ln1": init_norm(cfg.d_model, dtype, dev),
               "attn": init_attention(gen, cfg, dtype),
               "ln2": init_norm(cfg.d_model, dtype, dev),
               "ffn": init_mlp(gen, cfg, dtype)}
              for _ in range(cfg.n_layers)]
    params = {
        "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "layers": layers,
        "final_norm": init_norm(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                                      device=dev)
                          * cfg.d_model ** -0.5).to(dtype)
    return params


def _decoder_block(cfg: ModelConfig, lp: Params, x, rot,
                   window: Optional[int], cache_kv=None, cache_pos=None):
    """One pre-norm block. Returns (x, kv)."""
    h, kv = attention(lp["attn"], norm(lp["ln1"], x), cfg, rot=rot,
                      window=window, cache=cache_kv, cache_pos=cache_pos)
    x = x + h
    return x + mlp(lp["ffn"], norm(lp["ln2"], x), cfg), kv


def _logits(params: Params, x):
    """Tied (or separate) vocab projection in the activation dtype."""
    head = params.get("head", params["embed"])
    return x @ head.to(x.dtype).T


def _hidden(params: Params, cfg: ModelConfig, tokens):
    """Embed + every block + final norm over a whole prompt.

    Returns (hidden (B,S,d_model), [(k, v) per layer, each (B,S,KH,D)])."""
    B, S = tokens.shape
    x = params["embed"][tokens].to(_dtype(cfg))       # no sqrt(d) scaling
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    rot = rope_angles(positions, cfg.d_head, cfg.rope_theta)
    kvs = []
    for lp, window in zip(params["layers"], _layer_windows(cfg)):
        x, kv = _decoder_block(cfg, lp, x, rot, window)
        kvs.append(kv)
    return norm(params["final_norm"], x), kvs


def decoder_forward(params: Params, cfg: ModelConfig, tokens,
                    want_cache: bool = False):
    """Teacher-forced forward. tokens: (B,S) -> (logits (B,S,V), kvs)."""
    x, kvs = _hidden(params, cfg, tokens)
    return _logits(params, x), (kvs if want_cache else None)


def decoder_init_cache(cfg: ModelConfig, batch: int, max_seq: int,
                       device) -> Dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "pos": torch.zeros((batch,), dtype=torch.long, device=device)}


def decoder_prefill(params: Params, cfg: ModelConfig, tokens, max_seq: int,
                    length=None):
    """Run the prompt, build the cache, return last-position logits (B,V).

    ``length`` (int or (B,) tensor) marks the true prompt length when
    ``tokens`` is right-padded to a bucket: logits are taken at
    ``length - 1`` and the write cursor starts at ``length``. Causality
    makes this exact. Only the gathered position goes through the vocab
    projection, which gives the same numbers as projecting every position
    and gathering, without a (S x vocab) logits tensor.
    """
    B, S = tokens.shape
    x, kvs = _hidden(params, cfg, tokens)
    pos = torch.full((B,), S, dtype=torch.long, device=tokens.device) \
        if length is None else \
        torch.as_tensor(length, device=tokens.device).long().expand(B)
    last = x[torch.arange(B, device=tokens.device), pos - 1]      # (B,d)
    cache = decoder_init_cache(cfg, B, max_seq, tokens.device)
    for i, (k, v) in enumerate(kvs):
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    cache["pos"] = pos.clone()
    return _logits(params, last), cache


def decoder_decode(params: Params, cfg: ModelConfig, tokens, cache):
    """One decode step for every row. tokens: (B,1); returns (logits (B,V),
    cache). The cache tensors are updated in place and returned with the
    cursors advanced by one."""
    x = params["embed"][tokens].to(_dtype(cfg))
    pos = cache["pos"]
    rot = rope_angles(pos[:, None], cfg.d_head, cfg.rope_theta)
    for i, (lp, window) in enumerate(zip(params["layers"],
                                         _layer_windows(cfg))):
        x, _ = _decoder_block(cfg, lp, x, rot, window,
                              cache_kv=(cache["k"][i], cache["v"][i]),
                              cache_pos=pos)
    x = norm(params["final_norm"], x)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    return _logits(params, x[:, -1]), new_cache


# ===========================================================================
# ssm program (mamba2 -- attention-free stack)
# ===========================================================================

def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights with ``repro``'s scales, drawn from ``gen``."""
    dtype, dev = _dtype(cfg), gen.device
    params = {
        "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "layers": [{"ln": init_norm(cfg.d_model, dtype, dev),
                    "mamba": init_mamba(gen, cfg, dtype)}
                   for _ in range(cfg.n_layers)],
        "final_norm": init_norm(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                                      device=dev)
                          * cfg.d_model ** -0.5).to(dtype)
    return params


def ssm_forward(params: Params, cfg: ModelConfig, tokens):
    """Teacher-forced forward. tokens: (B,S) -> (logits (B,S,V), states):
    one (conv_state, ssm_state) per layer."""
    x, states = _ssm_hidden(params, cfg, tokens)
    return _logits(params, x), states


def _ssm_hidden(params: Params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens].to(_dtype(cfg))
    states = []
    for lp in params["layers"]:
        h, state = mamba_prefill(lp["mamba"], norm(lp["ln"], x), cfg)
        x = x + h
        states.append(state)
    return norm(params["final_norm"], x), states


def ssm_init_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   device) -> Dict[str, torch.Tensor]:
    del max_seq                    # a recurrent state does not grow
    conv_s, ssm_s = mamba_state_shapes(cfg, batch)
    return {"conv": torch.zeros((cfg.n_layers,) + conv_s, dtype=_dtype(cfg),
                                device=device),
            "ssm": torch.zeros((cfg.n_layers,) + ssm_s, dtype=_dtype(cfg),
                               device=device),
            "pos": torch.zeros((batch,), dtype=torch.long, device=device)}


def ssm_prefill(params: Params, cfg: ModelConfig, tokens, max_seq: int):
    """Run the exact-length prompt, return (last-position logits (B,V),
    cache). Only the last position goes through the vocab projection."""
    del max_seq
    B, S = tokens.shape
    x, states = _ssm_hidden(params, cfg, tokens)
    cache = {"conv": torch.stack([c for c, _ in states]),
             "ssm": torch.stack([s for _, s in states]),
             "pos": torch.full((B,), S, dtype=torch.long,
                               device=tokens.device)}
    return _logits(params, x[:, -1]), cache


def ssm_decode(params: Params, cfg: ModelConfig, tokens, cache):
    """One decode step for every row. tokens: (B,1); returns (logits (B,V),
    cache). Each layer's states are written back into the cache tensors in
    place, which are returned with the cursors advanced by one."""
    x = params["embed"][tokens].to(_dtype(cfg))
    for i, lp in enumerate(params["layers"]):
        h, (conv, state) = mamba_decode(
            lp["mamba"], norm(lp["ln"], x), cfg,
            (cache["conv"][i], cache["ssm"][i]))
        cache["conv"][i] = conv
        cache["ssm"][i] = state
        x = x + h
    x = norm(params["final_norm"], x)
    new_cache = {"conv": cache["conv"], "ssm": cache["ssm"],
                 "pos": cache["pos"] + 1}
    return _logits(params, x[:, -1]), new_cache
