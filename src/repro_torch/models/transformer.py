"""The block programs of ``repro/models/transformer.py``: the decoder
(dense and MoE LMs, including gemma3's local:global interleave and its
mixed ring cache), the ssm program (Mamba-2 stacks), the hybrid (jamba:
periods of attention and Mamba-2 sublayers, an MoE FFN on every other one)
and the encoder-decoder (whisper: a bidirectional encoder, a causal
decoder with cross-attention).

JAX scans one homogeneous layer body over stacked parameters and carries
each layer's window as a traced scalar. PyTorch runs eagerly, so the port
keeps a list of per-layer parameter dicts, loops over them in Python, and
gives each layer its window as a plain int, which lets prefill go through
the flash kernel on every layer.

The decoder's cache is ``{"k", "v": (L, B, S_max, KH, D), "pos": (B,)
int64}``: one write cursor per row (JAX keeps a scalar and vmaps rows in
the engine). The ssm program's cache is ``{"conv": (L, B, K-1, C), "ssm":
(L, B, h, p, n), "pos": (B,) int64}`` in the model dtype, as in ``repro``.

An MoE decoder's FFN is ``moe.py``'s GShard dispatch; the blocks return
its load-balancing loss, which forward, prefill and decode sum over the
layers as ``repro`` does (serving discards it). A prompt is routed in
groups of 512 tokens; a decode step routes each row as its own group,
as ``repro``'s engine does by vmapping a batch-1 decode over the slots.

The mixed cache (``decoder_init_cache_mixed``): global layers keep
``{"k_global", "v_global": (n_global, B, S_max, KH, D)}``, local layers a
ring of W = ``cfg.window`` slots ``{"k_local", "v_local": (n_local, B, W,
KH, D)}`` written at pos % W. As in ``repro`` there is no mixed prefill:
a mixed cache starts empty and decodes from token 0.

The hybrid's cache is ``{"kv_k", "kv_v": (n_periods, B, kv_len, KH, D),
"conv": (n_periods * (P-1), B, K-1, C), "ssm": (n_periods * (P-1), B, h,
p, n), "pos": (B,)}``: ``repro`` stacks the Mamba-2 states
(n_periods, P-1, B, ...); the port folds the two leading axes into one so
that the batch is axis 1 of every leaf, which is what the serving engine's
slot copy assumes. Its prompts route in groups of 512 with a smaller last
group (``moe(ragged=True)``): ``repro`` refuses a prompt longer than 512
tokens that 512 does not divide.

The encoder-decoder's cache is ``{"k", "v": (L, B, 448, KH, D),
"cross_k", "cross_v": (L, B, T_enc, KH, D), "pos": (B,)}``: the cross
K/V, sized by the encoder's output, in the decode kernel's layout.
Whisper takes no rope: positions are sinusoids added to the inputs.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import spmd
from .config import ModelConfig
from .layers import (attention, cross_attention, cross_kv, init_attention,
                     init_mlp, init_norm, mlp, norm, rope_angles)
from .moe import init_moe, moe
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
    ffn = init_moe if cfg.family == "moe" else init_mlp
    layers = [{"ln1": init_norm(cfg.d_model, dtype, dev),
               "attn": init_attention(gen, cfg, dtype),
               "ln2": init_norm(cfg.d_model, dtype, dev),
               "ffn": ffn(gen, cfg, dtype)}
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
    """One pre-norm block. Returns (x, aux, kv); aux is the MoE
    load-balancing loss (0.0 for a dense FFN)."""
    h, kv = attention(lp["attn"], norm(lp["ln1"], x), cfg, rot=rot,
                      window=window, cache=cache_kv, cache_pos=cache_pos)
    x = x + h
    hn = norm(lp["ln2"], x)
    if cfg.family == "moe":
        # a decode step (cache given) routes each row as its own group
        f, aux = moe(lp["ffn"], hn, cfg,
                     group_size=512 if cache_kv is None else 1)
    else:
        f, aux = mlp(lp["ffn"], hn, cfg), 0.0
    return x + f, aux, kv


def _logits(params: Params, x):
    """Tied (or separate) vocab projection in the activation dtype (on a
    mesh gathered over the vocab, ``spmd.full_vocab``)."""
    head = spmd.gathered(params.get("head", params["embed"]))
    return spmd.full_vocab(x @ head.to(x.dtype).T)


def _hidden(params: Params, cfg: ModelConfig, tokens):
    """Embed + every block + final norm over a whole prompt.

    Returns (hidden (B,S,d_model), aux summed over the layers, [(k, v) per
    layer, each (B,S,KH,D)])."""
    B, S = tokens.shape
    x = spmd.embed(params["embed"], tokens).to(_dtype(cfg))  # no sqrt(d)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    rot = rope_angles(positions, cfg.d_head, cfg.rope_theta)
    kvs, aux = [], 0.0
    for lp, window in zip(params["layers"], _layer_windows(cfg)):
        x, a, kv = _decoder_block(cfg, lp, x, rot, window)
        kvs.append(kv)
        aux = aux + a
    return norm(params["final_norm"], x), aux, kvs


def decoder_forward(params: Params, cfg: ModelConfig, tokens,
                    want_cache: bool = False):
    """Teacher-forced forward. tokens: (B,S) -> (logits (B,S,V), aux,
    kvs), as ``repro``'s."""
    x, aux, kvs = _hidden(params, cfg, tokens)
    return _logits(params, x), aux, (kvs if want_cache else None)


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
    makes this exact for attention. An MoE FFN is not causal: pad tokens
    route with the real ones and take expert capacity at choices >= 1, so
    they can push a real token's route out, as in ``repro``, which this
    reproduces. Only the gathered position goes through the vocab
    projection, which gives the same numbers as projecting every position
    and gathering, without a (S x vocab) logits tensor.
    """
    B, S = tokens.shape
    x, _, kvs = _hidden(params, cfg, tokens)
    pos = torch.full((B,), S, dtype=torch.long, device=tokens.device) \
        if length is None else \
        torch.as_tensor(length, device=tokens.device).long().expand(B)
    last = x[torch.arange(B, device=tokens.device), pos - 1]      # (B,d)
    return _logits(params, last), {**spmd.prefill_cache(kvs, max_seq),
                                   "pos": pos.clone()}


def decoder_decode(params: Params, cfg: ModelConfig, tokens, cache):
    """One decode step for every row. tokens: (B,1); returns (logits (B,V),
    cache). The cache tensors are updated in place and returned with the
    cursors advanced by one."""
    x = spmd.embed(params["embed"], tokens).to(_dtype(cfg))
    pos = cache["pos"]
    rot = rope_angles(pos[:, None], cfg.d_head, cfg.rope_theta)
    aux = 0.0
    for i, (lp, window) in enumerate(zip(params["layers"],
                                         _layer_windows(cfg))):
        x, a, _ = _decoder_block(cfg, lp, x, rot, window,
                                 cache_kv=(cache["k"][i], cache["v"][i]),
                                 cache_pos=pos)
        aux = aux + a                              # discarded, as in repro
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
    x = spmd.embed(params["embed"], tokens).to(_dtype(cfg))
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
    x = spmd.embed(params["embed"], tokens).to(_dtype(cfg))
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


# ===========================================================================
# mixed-cache decode (gemma3 local:global: ring caches for local layers)
# ===========================================================================

def _lg_layout(cfg: ModelConfig) -> List[bool]:
    """Per layer: True where the layer is global."""
    return [(i + 1) % cfg.local_global_period == 0
            for i in range(cfg.n_layers)]


def decoder_init_cache_mixed(cfg: ModelConfig, batch: int, max_seq: int,
                             device) -> Dict[str, torch.Tensor]:
    if not (cfg.local_global_period and cfg.window):
        raise ValueError("a mixed cache needs local_global_period and window")
    n_glob = sum(_lg_layout(cfg))
    n_loc = cfg.n_layers - n_glob

    def zeros(n, slots):
        return torch.zeros((n, batch, slots, cfg.n_kv_heads, cfg.d_head),
                           dtype=_dtype(cfg), device=device)
    return {"k_global": zeros(n_glob, max_seq),
            "v_global": zeros(n_glob, max_seq),
            "k_local": zeros(n_loc, cfg.window),
            "v_local": zeros(n_loc, cfg.window),
            "pos": torch.zeros((batch,), dtype=torch.long, device=device)}


def decoder_decode_mixed(params: Params, cfg: ModelConfig, tokens, cache):
    """One decode step on the mixed cache. Local layers write their ring at
    pos % W and attend to its min(pos + 1, W) valid slots (start 0);
    global layers attend to [0, pos + 1). Tensors are updated in place
    (on a mesh each rank writes the ring slot it holds)."""
    x = spmd.embed(params["embed"], tokens).to(_dtype(cfg))
    pos = cache["pos"]
    W = cfg.window
    rot = rope_angles(pos[:, None], cfg.d_head, cfg.rope_theta)
    ring_pos, ring_len = pos % W, (pos + 1).clamp(max=W)
    gi = li = 0
    for lp, is_global in zip(params["layers"], _lg_layout(cfg)):
        xn = norm(lp["ln1"], x)
        if is_global:
            h, _ = attention(lp["attn"], xn, cfg, rot=rot,
                             cache=(cache["k_global"][gi],
                                    cache["v_global"][gi]), cache_pos=pos)
            gi += 1
        else:
            h, _ = attention(lp["attn"], xn, cfg, rot=rot,
                             cache=(cache["k_local"][li],
                                    cache["v_local"][li]),
                             cache_pos=ring_pos, cache_length=ring_len)
            li += 1
        x = x + h
        x = x + mlp(lp["ffn"], norm(lp["ln2"], x), cfg)
    x = norm(params["final_norm"], x)
    return _logits(params, x[:, -1]), dict(cache, pos=pos + 1)


# ===========================================================================
# hybrid program (jamba: periods of [attn, mamba x (P-1)], MoE every other)
# ===========================================================================

def _hybrid_layout(cfg: ModelConfig):
    """(n_periods, P, MoE sublayers, dense-FFN sublayers) of a period."""
    P = cfg.attn_period
    if not P or cfg.n_layers % P:
        raise ValueError(f"hybrid n_layers {cfg.n_layers} must be a "
                         f"multiple of attn_period {P}")
    moe_slots = [j for j in range(P) if j % cfg.moe_every == cfg.moe_every - 1]
    dense_slots = [j for j in range(P) if j not in moe_slots]
    return cfg.n_layers // P, P, moe_slots, dense_slots


def init_hybrid(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights with ``repro``'s scales, drawn from ``gen``. A period
    keeps its sublayers' parameters in lists: ``mamba``/``mamba_ln`` (P-1),
    ``ffn_dense``/``ffn_dense_ln`` and ``ffn_moe``/``ffn_moe_ln``. The
    vocab head is separate, as in ``repro``."""
    dtype, dev = _dtype(cfg), gen.device
    n_periods, P, moe_slots, dense_slots = _hybrid_layout(cfg)

    def lns(n):
        return [init_norm(cfg.d_model, dtype, dev) for _ in range(n)]

    def period():
        return {"attn_ln": init_norm(cfg.d_model, dtype, dev),
                "attn": init_attention(gen, cfg, dtype),
                "mamba_ln": lns(P - 1),
                "mamba": [init_mamba(gen, cfg, dtype) for _ in range(P - 1)],
                "ffn_dense_ln": lns(len(dense_slots)),
                "ffn_dense": [init_mlp(gen, cfg, dtype) for _ in dense_slots],
                "ffn_moe_ln": lns(len(moe_slots)),
                "ffn_moe": [init_moe(gen, cfg, dtype) for _ in moe_slots]}
    return {
        "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "periods": [period() for _ in range(n_periods)],
        "final_norm": init_norm(cfg.d_model, dtype, dev),
        "head": (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                             device=dev) * cfg.d_model ** -0.5).to(dtype),
    }


def _hybrid_period(cfg: ModelConfig, pp: Params, x, rot, *, caches=None,
                   cache_pos=None):
    """One period: sublayer 0 attention, 1..P-1 Mamba-2; an FFN after each
    mixer (MoE on ``moe_slots``).

    ``caches`` (decode): {"kv": (k, v) each (B, kv_len, KH, D), "conv",
    "ssm": the period's P-1 states, each (B, ...)}. Returns (x, aux, new):
    new = {"kv": (k, v), "conv": [P-1], "ssm": [P-1]} (at prefill the
    prompt's K/V (B,S,KH,D) and final states). A prompt routes in groups
    of 512 (the last one smaller); a decode step routes each row alone."""
    _, P, moe_slots, _ = _hybrid_layout(cfg)
    aux = 0.0
    new = {"conv": [], "ssm": []}
    d_i = m_i = 0
    for j in range(P):
        if j == 0:
            xn = norm(pp["attn_ln"], x)
            h, new["kv"] = attention(
                pp["attn"], xn, cfg, rot=rot, window=cfg.window or None,
                cache=None if caches is None else caches["kv"],
                cache_pos=cache_pos)
        else:
            xn = norm(pp["mamba_ln"][j - 1], x)
            if caches is None:
                h, (conv, state) = mamba_prefill(pp["mamba"][j - 1], xn, cfg)
            else:
                h, (conv, state) = mamba_decode(
                    pp["mamba"][j - 1], xn, cfg,
                    (caches["conv"][j - 1], caches["ssm"][j - 1]))
            new["conv"].append(conv)
            new["ssm"].append(state)
        x = x + h
        if j in moe_slots:
            f, a = moe(pp["ffn_moe"][m_i], norm(pp["ffn_moe_ln"][m_i], x),
                       cfg, group_size=512 if caches is None else 1,
                       ragged=True)
            aux = aux + a
            m_i += 1
        else:
            f = mlp(pp["ffn_dense"][d_i], norm(pp["ffn_dense_ln"][d_i], x),
                    cfg)
            d_i += 1
        x = x + f
    return x, aux, new


def _hybrid_hidden(params: Params, cfg: ModelConfig, tokens):
    B, S = tokens.shape
    x = spmd.embed(params["embed"], tokens).to(_dtype(cfg))
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    rot = rope_angles(positions, cfg.d_head, cfg.rope_theta)
    aux, caches = 0.0, []
    for pp in params["periods"]:
        x, a, new = _hybrid_period(cfg, pp, x, rot)
        aux = aux + a
        caches.append(new)
    return norm(params["final_norm"], x), aux, caches


def hybrid_forward(params: Params, cfg: ModelConfig, tokens,
                   want_cache: bool = False):
    """Teacher-forced forward. tokens: (B,S) -> (logits (B,S,V), aux summed
    over the MoE sublayers, per-period caches or None)."""
    x, aux, caches = _hybrid_hidden(params, cfg, tokens)
    return _logits(params, x), aux, (caches if want_cache else None)


def _hybrid_kv_len(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.window) if cfg.window else max_seq


def hybrid_init_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device) -> Dict[str, torch.Tensor]:
    n_periods, P, _, _ = _hybrid_layout(cfg)
    conv_s, ssm_s = mamba_state_shapes(cfg, batch)
    kv_len = _hybrid_kv_len(cfg, max_seq)
    kv = (n_periods, batch, kv_len, cfg.n_kv_heads, cfg.d_head)
    n_mamba = n_periods * (P - 1)

    def zeros(shape):
        return torch.zeros(shape, dtype=_dtype(cfg), device=device)
    return {"kv_k": zeros(kv), "kv_v": zeros(kv),
            "conv": zeros((n_mamba,) + conv_s),
            "ssm": zeros((n_mamba,) + ssm_s),
            "pos": torch.zeros((batch,), dtype=torch.long, device=device)}


def hybrid_prefill(params: Params, cfg: ModelConfig, tokens, max_seq: int):
    """Run the exact-length prompt, return (last-position logits (B,V),
    cache). The attention cache keeps the prompt's last kv_len keys, as in
    ``repro``."""
    B, S = tokens.shape
    x, _, caches = _hybrid_hidden(params, cfg, tokens)
    kv_len = _hybrid_kv_len(cfg, max_seq)
    n = min(S, kv_len)
    kv = spmd.prefill_cache([(k[:, S - n:], v[:, S - n:])
                             for k, v in (new["kv"] for new in caches)],
                            kv_len)
    return _logits(params, x[:, -1]), {
        "kv_k": kv["k"], "kv_v": kv["v"],
        **{name: torch.cat([torch.stack(new[name]) for new in caches])
           for name in ("conv", "ssm")},
        "pos": torch.full((B,), S, dtype=torch.long, device=tokens.device)}


def hybrid_decode(params: Params, cfg: ModelConfig, tokens, cache):
    """One decode step for every row. tokens: (B,1); returns (logits (B,V),
    cache), its tensors updated in place. The attention write clamps to
    kv_len - 1, as ``repro``'s does."""
    x = spmd.embed(params["embed"], tokens).to(_dtype(cfg))
    pos = cache["pos"]
    write_pos = pos.clamp(max=cache["kv_k"].shape[2] - 1)
    rot = rope_angles(pos[:, None], cfg.d_head, cfg.rope_theta)
    P1 = cfg.attn_period - 1
    for i, pp in enumerate(params["periods"]):
        sl = slice(i * P1, (i + 1) * P1)
        caches = {"kv": (cache["kv_k"][i], cache["kv_v"][i]),
                  "conv": cache["conv"][sl], "ssm": cache["ssm"][sl]}
        x, _, new = _hybrid_period(cfg, pp, x, rot, caches=caches,
                                   cache_pos=write_pos)
        cache["conv"][sl] = torch.stack(new["conv"])
        cache["ssm"][sl] = torch.stack(new["ssm"])
    x = norm(params["final_norm"], x)
    return _logits(params, x[:, -1]), dict(cache, pos=pos + 1)


# ===========================================================================
# encdec program (whisper: encoder + causal decoder with cross-attention)
# ===========================================================================

DEC_LEN = 448            # whisper's decoder positions (its self cache)


@functools.lru_cache(maxsize=16)
def sinusoid_positions(S: int, d: int, dtype, device="cpu"):
    """(S, d) sinusoids [sin | cos], computed in float64 as ``repro``'s and
    cast to ``dtype`` on ``device``. Kept per arguments: a decode step
    gathers its rows from the table without copying it to the card again
    (callers must not write into it)."""
    pos = np.arange(S)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10_000.0, 2 * dim / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb).to(device=device, dtype=dtype)


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights with ``repro``'s scales, drawn from ``gen``: biased
    projections, LayerNorms, tied embeddings."""
    dtype, dev, kind = _dtype(cfg), gen.device, cfg.norm

    def ln():
        return init_norm(cfg.d_model, dtype, dev, kind)

    def enc_layer():
        return {"ln1": ln(), "attn": init_attention(gen, cfg, dtype, True),
                "ln2": ln(), "ffn": init_mlp(gen, cfg, dtype, bias=True)}

    def dec_layer():
        return {"ln1": ln(), "attn": init_attention(gen, cfg, dtype, True),
                "ln_x": ln(), "cross": init_attention(gen, cfg, dtype, True),
                "ln2": ln(), "ffn": init_mlp(gen, cfg, dtype, bias=True)}
    return {
        "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                              device=dev) * 0.02).to(dtype),
        "enc_layers": [enc_layer() for _ in range(cfg.encoder_layers)],
        "enc_norm": ln(),
        "dec_layers": [dec_layer() for _ in range(cfg.n_layers)],
        "final_norm": ln(),
    }


def encdec_encode(params: Params, cfg: ModelConfig, frames):
    """frames: (B, T, d_model) precomputed frame embeddings (the frontend
    is a stub, as in ``repro``) -> encoder states (B, T, d_model). Every
    layer attends over all T frames (flash, not causal)."""
    B, T, _ = frames.shape
    dtype, kind = _dtype(cfg), cfg.norm
    x = frames.to(dtype) + sinusoid_positions(T, cfg.d_model, dtype,
                                              frames.device)[None]
    for lp in params["enc_layers"]:
        h, _ = attention(lp["attn"], norm(lp["ln1"], x, kind), cfg, rot=None,
                         causal=False)
        x = x + h
        x = x + mlp(lp["ffn"], norm(lp["ln2"], x, kind), cfg)
    return norm(params["enc_norm"], x, kind)


def _encdec_cross_kvs(params: Params, cfg: ModelConfig, enc_out):
    """Every decoder layer's cross K/V, (k, v) each (B, T, KH, D), one
    layer at a time (a generator: a caller that stores them holds one
    layer's extra copy at most)."""
    return (cross_kv(lp["cross"], cfg, enc_out) for lp in params["dec_layers"])


def _encdec_decoder(params: Params, cfg: ModelConfig, tokens, cross_kvs):
    """The decoder over a prompt: causal self-attention, cross-attention to
    ``cross_kvs`` (one (k, v) a layer). Returns (hidden states (B, S,
    d_model), [each layer's self (k, v), each (B, S, KH, D)])."""
    B, S = tokens.shape
    dtype, kind = _dtype(cfg), cfg.norm
    x = spmd.embed(params["embed"], tokens).to(dtype) \
        + sinusoid_positions(S, cfg.d_model, dtype, tokens.device)[None]
    kvs = []
    for lp, ckv in zip(params["dec_layers"], cross_kvs):
        h, kv = attention(lp["attn"], norm(lp["ln1"], x, kind), cfg,
                          rot=None)
        kvs.append(kv)
        x = x + h
        x = x + cross_attention(lp["cross"], norm(lp["ln_x"], x, kind), cfg,
                                ckv)
        x = x + mlp(lp["ffn"], norm(lp["ln2"], x, kind), cfg)
    return norm(params["final_norm"], x, kind), kvs


def encdec_forward(params: Params, cfg: ModelConfig, frames, tokens):
    """Teacher-forced: encode frames, decode tokens. Returns (logits
    (B,S,V), aux 0.0, None), as ``repro``'s (without its cache)."""
    enc_out = encdec_encode(params, cfg, frames)
    x, _ = _encdec_decoder(params, cfg, tokens,
                           _encdec_cross_kvs(params, cfg, enc_out))
    return _logits(params, x), 0.0, None


def encdec_init_cache(cfg: ModelConfig, batch: int, max_seq: int,
                      device) -> Dict[str, torch.Tensor]:
    """Zeroed cache: the self K/V at ``DEC_LEN`` positions, the cross K/V
    at ``max_seq`` encoder frames (``repro``'s sizes)."""
    kv = (cfg.n_layers, batch, DEC_LEN, cfg.n_kv_heads, cfg.d_head)
    cross = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)

    def zeros(shape):
        return torch.zeros(shape, dtype=_dtype(cfg), device=device)
    return {"k": zeros(kv), "v": zeros(kv), "cross_k": zeros(cross),
            "cross_v": zeros(cross),
            "pos": torch.zeros((batch,), dtype=torch.long, device=device)}


def encdec_prefill(params: Params, cfg: ModelConfig, frames, tokens):
    """Encode the frames and run the decoder prompt; cache the self K/V
    (``DEC_LEN`` slots, the prompt's then zeros) and the cross K/V (the
    encoder's T frames), each made once in the layers' layout and filled
    a layer at a time (``spmd.prefill_cache``: DTensors on a mesh), so the
    cross K/V are never held twice. Returns (last-position logits (B,V),
    cache)."""
    B, S = tokens.shape
    if S > DEC_LEN:
        raise ValueError(f"a {S}-token prompt exceeds {DEC_LEN} positions")
    enc_out = encdec_encode(params, cfg, frames)
    L = len(params["dec_layers"])
    cross = spmd.prefill_cache(_encdec_cross_kvs(params, cfg, enc_out),
                               enc_out.shape[1], ("cross_k", "cross_v"),
                               layers=L)
    x, kvs = _encdec_decoder(
        params, cfg, tokens, ((cross["cross_k"][i], cross["cross_v"][i])
                              for i in range(L)))
    cache = {**spmd.prefill_cache(kvs, DEC_LEN), **cross,
             "pos": torch.full((B,), S, dtype=torch.long,
                               device=tokens.device)}
    return _logits(params, x[:, -1]), cache


def encdec_decode(params: Params, cfg: ModelConfig, tokens, cache):
    """One decode step for every row at its own ``pos`` (B,): sinusoid
    position pos (clamped to the table, as a gather in ``repro`` clamps),
    self-attention against the ``DEC_LEN`` cache, cross-attention over
    every encoder frame (the decode kernel, start 0, length T). Returns
    (logits (B,V), cache), its tensors updated in place. On a mesh the
    cursors index the plain sinusoid table as a plain copy
    (``spmd.whole``)."""
    dtype, kind = _dtype(cfg), cfg.norm
    pos = cache["pos"]
    table = sinusoid_positions(DEC_LEN, cfg.d_model, dtype, tokens.device)
    x = spmd.embed(params["embed"], tokens).to(dtype) \
        + table[spmd.whole(pos).clamp(max=DEC_LEN - 1)][:, None]
    for i, lp in enumerate(params["dec_layers"]):
        h, _ = attention(lp["attn"], norm(lp["ln1"], x, kind), cfg, rot=None,
                         cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
        x = x + h
        x = x + cross_attention(lp["cross"], norm(lp["ln_x"], x, kind), cfg,
                                (cache["cross_k"][i], cache["cross_v"][i]))
        x = x + mlp(lp["ffn"], norm(lp["ln2"], x, kind), cfg)
    x = norm(params["final_norm"], x, kind)
    return _logits(params, x[:, -1]), dict(cache, pos=pos + 1)
