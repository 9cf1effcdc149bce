"""Parameters of the JAX package, given as numpy arrays, turned into the
port's parameters, so that both packages can compute with one set of
weights (the tests do; numpy is the bridge, the port imports no JAX).

Layout differences handled here:
  * a JAX ``linear`` weight is (in, out); the port's is (out, in);
  * JAX stacks the layers' leaves on a leading L axis (one scan); the port
    keeps a list of per-layer dicts;
  * a separate JAX vocab head is (d_model, vocab); the port's is
    (vocab, d_model), like the tied embedding.

Every leaf takes ``cfg.dtype`` except the Mamba-2 ``A_log`` and
``dt_bias`` and the MoE ``router``, which stay float32 as ``repro`` keeps
them. Only ``"w"`` leaves are transposed: the Mamba-2 ``conv_w`` is (K, C)
in both, and an MoE FFN's ``router`` (d, E), ``up``/``gate`` (E, d, f)
and ``down`` (E, f, d) keep ``repro``'s layout (its ``shared`` expert is
an MLP of ``"w"`` leaves, transposed like any other).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .config import ModelConfig
from .transformer import Params

FLOAT32_LEAVES = ("A_log", "dt_bias", "router")


def _tensor(a, dtype, device) -> torch.Tensor:
    # a float32 copy: exact for bf16 leaves, which torch cannot take from
    # numpy directly, and writable, as torch.from_numpy wants
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _layer(tree: Mapping[str, Any], i: int, dtype, device):
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out[key] = _layer(val, i, dtype, device)
        elif key == "w":
            out[key] = _tensor(np.asarray(val)[i].T, dtype, device)
        else:
            leaf_dtype = torch.float32 if key in FLOAT32_LEAVES else dtype
            out[key] = _tensor(np.asarray(val)[i], leaf_dtype, device)
    return out


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                      device="cpu") -> Params:
    """``tree``: the parameter pytree of the JAX decoder or ssm program
    with numpy leaves (e.g. ``jax.tree.map(np.asarray, model.init(key))``)."""
    dtype = getattr(torch, cfg.dtype)
    params = {
        "embed": _tensor(tree["embed"], dtype, device),
        "layers": [_layer(tree["layers"], i, dtype, device)
                   for i in range(cfg.n_layers)],
        "final_norm": {"scale": _tensor(tree["final_norm"]["scale"], dtype,
                                        device)},
    }
    if "head" in tree:
        params["head"] = _tensor(np.asarray(tree["head"]).T, dtype, device)
    return params
