"""Sharding rules: the rule engine of ``repro/launch/sharding.py`` over the
port's trees.

One generic rule engine instead of per-arch tables: tensors are classified
by their path (e.g. ``("layers", "attn", "wq", "w")``) and each class
lists candidate specs in priority order; the first whose sharded dims all
divide evenly into the mesh axes wins (vocab 50280 on a 16-way axis falls
back to replicated, qwen2-moe's 60 experts fall back from EP to TP, etc.):

  * 2D "hybrid FSDP x TP": matmul weights shard the parallel dim over
    ``model`` (TP) and the other dim over ``data`` (FSDP) when fsdp=True;
  * MoE experts shard over ``model`` (EP) when the expert count divides,
    otherwise per-expert FFN dims shard over ``model`` (TP);
  * batch dims shard over ("pod", "data"); KV caches shard batch over data
    and sequence over model (context-sharded decode).

The functions, their candidate lists and their order are ``repro``'s.
``PartitionSpec`` and ``NamedSharding`` are the port's own small classes:
a tuple of entries, and a (mesh, spec) pair. The specs are pure shape
logic; placing tensors by them over several cards is not ported
(``mesh.MULTI_CARD``).

The port lays its trees out otherwise than ``repro``, and the rules are
resolved on ``repro``'s layout so that every spec and every per-device
byte count is ``repro``'s:

  * a port linear ``"w"`` and the separate vocab ``"head"`` are (out, in)
    where ``repro``'s are (in, out) (``models/convert.py``);
  * the port keeps per-layer lists where ``repro`` stacks a leading axis
    (twice in the hybrid: periods, then sublayers);
  * the hybrid's decode cache folds ``repro``'s (n_periods, P-1) Mamba-2
    state axes into one (its ``kv_k`` leaf keeps n_periods in front).

``params_shardings`` resolves each port leaf against ``repro``'s rule for
the stacked shape of its path, drops the stacked prefix and swaps the two
entries of a transposed leaf; ``cache_shardings`` resolves a folded leaf
on the unfolded shape and merges the two entries.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np

from ..train.tree import leaves, stacked_paths, unflatten


class PartitionSpec(tuple):
    """One entry a dimension: None (replicated), an axis name or a tuple
    of axis names. Trailing dimensions left out are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + tuple.__repr__(tuple(self))


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec

    def num_devices_sharded_over(self, shape) -> int:
        """The shards a tensor of ``shape`` is cut into."""
        return _spec_shards(shape, self.spec, self.mesh)


def _fits(shape: Tuple[int, ...], spec: P, mesh) -> bool:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    for dim, entry in zip(shape, entries):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        k = int(np.prod([sizes[a] for a in axes]))
        if dim % k != 0:
            return False
    return True


def _pick(shape, mesh, *candidates) -> P:
    for spec in candidates:
        if _fits(shape, spec, mesh):
            return spec
    return P()


def _pad_rank(spec: P, rank: int, stacked: int) -> P:
    """Prefix ``stacked`` Nones (layer axes) and right-pad to rank."""
    inner = tuple(spec)
    return P(*((None,) * stacked + inner +
               (None,) * (rank - stacked - len(inner))))


def _transposed(path) -> bool:
    """The port's (out, in) leaves: a linear's ``"w"`` and the separate
    vocab head (``models/convert.py``)."""
    names = [p for p in path if isinstance(p, str)]
    return bool(names) and (names[-1] == "w" or names == ["head"])


def params_shardings(param_shapes, mesh, fsdp: bool = True):
    """Map a port parameter tree (tensors, meta or real) to a tree of
    ``NamedSharding``s, each spec of the leaf's own rank."""
    out = []
    for (path, stack), leaf in zip(stacked_paths(param_shapes),
                                   leaves(param_shapes)):
        shape = tuple(leaf.shape)
        flip = _transposed(path) and len(shape) == 2
        base = shape[::-1] if flip else shape
        full = stack + base
        spec = _pad_rank(param_spec_resolved(path, full, mesh, fsdp),
                         len(full), 0)
        entries = tuple(spec)[len(stack):]
        out.append(NamedSharding(mesh, P(*(entries[::-1] if flip
                                           else entries))))
    return unflatten(param_shapes, out)


def param_spec_resolved(path, shape, mesh, fsdp) -> P:
    """param_spec with shape-driven resolution of the stacked prefix;
    ``shape`` is the leaf's shape in ``repro``'s layout."""
    names = [p for p in path if isinstance(p, str)]
    leaf = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    # determine base rank from tensor kind. MoE expert tensors are *bare*
    # arrays named up/gate/down (E, d, f); dense MLP weights are nested one
    # level deeper as {"up": {"w": ...}} — so a leaf literally named
    # up/gate/down is always an expert stack.
    if leaf in ("conv_b", "A_log", "dt_bias", "D", "scale", "bias", "b"):
        base_rank = 1
    elif leaf in ("embed", "head", "router", "conv_w"):
        base_rank = 2
    elif leaf in ("up", "gate", "down"):
        base_rank = 3
    elif leaf == "w" or parent in ("wq", "wk", "wv", "wo", "up", "gate",
                                   "down", "in_proj", "out_proj"):
        base_rank = 2
    else:
        base_rank = min(len(shape), 2)
    stacked = max(len(shape) - base_rank, 0)
    base = shape[stacked:]
    f = "data" if (fsdp and "data" in mesh.axis_names) else None

    def pick(*cands):
        return _pad_rank(_pick(base, mesh, *cands), len(shape), stacked)

    if leaf == "embed":
        return pick(P("model", f), P("model", None), P(None, f), P())
    if leaf == "head":
        return pick(P(f, "model"), P(None, "model"), P(f, None), P())
    if leaf == "router":
        return pick(P(f, None), P())
    if leaf == "conv_w":
        return pick(P(None, "model"), P())
    if leaf in ("conv_b", "A_log", "dt_bias", "D"):
        return pick(P("model"), P())
    if parent == "out_norm" and leaf == "scale":
        return pick(P("model"), P())
    if leaf in ("scale", "bias"):
        return P()
    if base_rank == 3:                      # moe expert tensors
        if leaf in ("up", "gate"):
            return pick(P("model", f, None), P(None, f, "model"), P())
        if leaf == "down":
            return pick(P("model", None, f), P(None, "model", f), P())
    if parent in ("wq", "wk", "wv", "up", "gate", "in_proj"):
        if leaf == "b":
            return pick(P("model"), P())
        return pick(P(f, "model"), P(None, "model"), P(f, None), P())
    if parent in ("wo", "down", "out_proj"):
        if leaf == "b":
            return P()
        return pick(P("model", f), P("model", None), P(None, f), P())
    return P()


def batch_spec(mesh) -> P:
    return P(("pod", "data") if "pod" in mesh.axis_names else "data")


def batch_shardings(batch_shapes, mesh, dim: int = 0):
    """Inputs: shard the global-batch dim over (pod, data); rest replicated.
    ``dim=1`` handles the (microbatches, B/M, ...) layout. Falls back to
    fewer axes when the dim doesn't divide (e.g. 16-seq microbatches on a
    32-way pod x data product shard over data only)."""
    candidates = [tuple(batch_spec(mesh))[0]]
    if "pod" in mesh.axis_names:
        candidates += ["data", "pod"]

    def one(leaf):
        for b in candidates:
            if len(leaf.shape) > dim \
                    and leaf.shape[dim] % _axis_size(mesh, b) == 0:
                return NamedSharding(mesh, P(*((None,) * dim), b))
        return NamedSharding(mesh, P())

    return unflatten(batch_shapes, [one(x) for x in leaves(batch_shapes)])


_KV_LEAVES = ("k", "v", "kv_k", "kv_v", "cross_k", "cross_v", "k_global",
              "v_global", "k_local", "v_local")
_FOLDED_LEAVES = ("conv", "ssm")       # the hybrid's Mamba-2 states


def _cache_spec(name, shape, mesh, b) -> P:
    if not shape:                                       # pos scalar
        return P()
    if name in _KV_LEAVES:
        # batch over data + sequence over model; batch=1 (long_500k)
        # falls back to pure context sharding
        cands = [P(None, b, "model"), P(None, None, "model"),
                 P(None, b), P()]
    elif len(shape) >= 2:
        cands = [P(None, b), P()]
    else:
        cands = [P()]
    return _pick(shape, mesh, *cands)


def _merge(e0, e1):
    """One entry for two folded dimensions (the outer one first)."""
    axes = tuple(a for e in (e0, e1) if e is not None
                 for a in (e if isinstance(e, tuple) else (e,)))
    return None if not axes else axes[0] if len(axes) == 1 else axes


def cache_shardings(cache_shapes, mesh):
    """KV caches: (L, B, S, KH, D) -> batch over data, sequence over model.

    SSM states (L, B, ...): batch over data. Scalars replicated. A hybrid
    cache's states (n_periods * (P-1), B, ...) are resolved on ``repro``'s
    (n_periods, P-1, B, ...), with n_periods from its ``kv_k`` leaf."""
    b = tuple(batch_spec(mesh))[0]
    names = [path[-1] if path else None
             for path, _ in stacked_paths(cache_shapes)]
    by_name = dict(zip(names, leaves(cache_shapes)))
    periods = by_name["kv_k"].shape[0] if "kv_k" in by_name else None
    out = []
    for name, leaf in zip(names, leaves(cache_shapes)):
        shape = tuple(leaf.shape)
        if periods and name in _FOLDED_LEAVES:
            spec = _pad_rank(_cache_spec(
                name, (periods, shape[0] // periods) + shape[1:], mesh, b),
                len(shape) + 1, 0)
            spec = P(_merge(spec[0], spec[1]), *spec[2:])
        else:
            spec = _cache_spec(name, shape, mesh, b)
        out.append(NamedSharding(mesh, spec))
    return unflatten(cache_shapes, out)


def _axis_size(mesh, entry) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    axes = entry if isinstance(entry, tuple) else (entry,)
    return int(np.prod([sizes[a] for a in axes]))


def sharded_size_bytes(shapes, shardings) -> int:
    """Per-device bytes of a sharded tree (exact, backend-independent):
    ``shapes`` and ``shardings`` are trees (or lists) with the same leaves
    in the same order."""
    total = 0
    for leaf, sh in zip(leaves(shapes), leaves(shardings)):
        shape = tuple(leaf.shape)
        n = int(np.prod(shape)) if shape else 1
        total += n * leaf.dtype.itemsize // sh.num_devices_sharded_over(shape)
    return total


def _spec_shards(shape, spec, mesh) -> int:
    k = 1
    entries = tuple(spec)
    for dim, entry in zip(shape, entries):
        if entry is None:
            continue
        k *= _axis_size(mesh, entry)
    return k

