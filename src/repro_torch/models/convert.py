"""Parameters of the JAX package, given as numpy arrays, turned into the
port's parameters, so that both packages can compute with one set of
weights (the tests do; numpy is the bridge, the port imports no JAX).

Layout differences handled here:
  * a JAX ``linear`` weight is (in, out); the port's is (out, in);
  * JAX stacks the layers' leaves on a leading L axis (one scan); the port
    keeps a list of per-layer dicts. The hybrid stacks twice: its
    ``periods`` on a period axis, and inside a period the ``mamba``,
    ``mamba_ln``, ``ffn_dense(_ln)`` and ``ffn_moe(_ln)`` leaves on a
    sublayer axis after it; the port keeps a list of periods, each with a
    list a sublayer kind;
  * a separate JAX vocab head is (d_model, vocab); the port's is
    (vocab, d_model), like the tied embedding.

Every leaf takes ``cfg.dtype`` except the Mamba-2 ``A_log`` and
``dt_bias`` and the MoE ``router``, which stay float32 as ``repro`` keeps
them. Only ``"w"`` leaves are transposed: a bias ``"b"`` (whisper's
projections) and a LayerNorm's ``"bias"`` are 1-D, the Mamba-2 ``conv_w``
is (K, C) in both, and an MoE FFN's ``router`` (d, E), ``up``/``gate``
(E, d, f) and ``down`` (E, f, d) keep ``repro``'s layout (its ``shared``
expert is an MLP of ``"w"`` leaves, transposed like any other).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple

import numpy as np
import torch

from ..train.optimizer import AdamWState, CompressedState
from .config import ModelConfig
from .transformer import Params

FLOAT32_LEAVES = ("A_log", "dt_bias", "router")
# a hybrid period's leaves stacked a second time, on a sublayer axis
SUBLAYER_STACKS = ("mamba", "mamba_ln", "ffn_dense", "ffn_dense_ln",
                   "ffn_moe", "ffn_moe_ln")


def _tensor(a, dtype, device) -> torch.Tensor:
    # a float32 copy: exact for bf16 leaves, which torch cannot take from
    # numpy directly, and writable, as torch.from_numpy wants
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _layer(tree: Mapping[str, Any], idx: Tuple[int, ...], dtype, device):
    """The slice ``idx`` of every stacked leaf of ``tree``."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out[key] = _layer(val, idx, dtype, device)
        elif key == "w":
            out[key] = _tensor(np.asarray(val)[idx].T, dtype, device)
        else:
            leaf_dtype = torch.float32 if key in FLOAT32_LEAVES else dtype
            out[key] = _tensor(np.asarray(val)[idx], leaf_dtype, device)
    return out


def _stack_len(tree, axis: int = 0) -> int:
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[axis]


def _layers(tree, dtype, device):
    return [_layer(tree, (i,), dtype, device) for i in range(_stack_len(tree))]


def _period(tree: Mapping[str, Any], i: int, dtype, device):
    """Hybrid period ``i``: its sublayer stacks become lists."""
    return {key: [_layer(val, (i, j), dtype, device)
                  for j in range(_stack_len(val, axis=1))]
            if key in SUBLAYER_STACKS else _layer(val, (i,), dtype, device)
            for key, val in tree.items()}


def _norm(tree, dtype, device):
    return {k: _tensor(v, dtype, device) for k, v in tree.items()}


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                      device="cpu") -> Params:
    """``tree``: the parameter pytree of any JAX program (decoder, ssm,
    hybrid, encoder-decoder) with numpy leaves (e.g.
    ``jax.tree.map(np.asarray, model.init(key))``)."""
    dtype = getattr(torch, cfg.dtype)
    params = {"embed": _tensor(tree["embed"], dtype, device),
              "final_norm": _norm(tree["final_norm"], dtype, device)}
    if "layers" in tree:
        params["layers"] = _layers(tree["layers"], dtype, device)
    if "periods" in tree:
        params["periods"] = [_period(tree["periods"], i, dtype, device)
                             for i in range(_stack_len(tree["periods"]))]
    if "enc_layers" in tree:
        params["enc_layers"] = _layers(tree["enc_layers"], dtype, device)
        params["dec_layers"] = _layers(tree["dec_layers"], dtype, device)
        params["enc_norm"] = _norm(tree["enc_norm"], dtype, device)
    if "head" in tree:
        params["head"] = _tensor(np.asarray(tree["head"]).T, dtype, device)
    return params


def opt_state_from_numpy(cfg: ModelConfig, state, device="cpu"):
    """``repro``'s optimizer state with numpy leaves (an ``AdamWState``
    (step, mu, nu) or a ``CompressedState`` (inner, error), as
    ``jax.tree.map(np.asarray, ...)`` leaves it) as the port's: the step an
    int32 scalar tensor, every params-shaped tree through
    ``params_from_numpy`` in float32, whatever ``cfg.dtype``."""
    f32 = dataclasses.replace(cfg, dtype="float32")

    def tree(t):
        return params_from_numpy(f32, t, device)
    if hasattr(state, "inner"):
        return CompressedState(opt_state_from_numpy(cfg, state.inner, device),
                               tree(state.error))
    return AdamWState(torch.tensor(np.asarray(state.step), dtype=torch.int32,
                                   device=device),
                      tree(state.mu), tree(state.nu))
