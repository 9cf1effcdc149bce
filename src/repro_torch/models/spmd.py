"""The decoder on a mesh: what DTensor's sharding propagation does not
carry by itself (the dense decoder's prefill, decode and loss on DTensor
parameters and inputs, ``launch/steps.py``).

Parameters arrive placed by ``launch/sharding.py``'s rules: a matmul
weight's parallel dim over "model" (TP) and its other dim over "data"
(FSDP), the vocab table over "model" and its width over "data". The
activations keep their rows over "data", as the batch is placed.

* ``gathered``: a weight is gathered over every mesh dim but "model"
  before it is used (FSDP); without it the planner meets a weight sharded
  over "data" on its contraction dim and rows sharded over "data" in one
  product, and shards the rows' reduction instead.
* ``embed``: the vocab-parallel lookup: each rank looks up its own vocab
  rows, and the partial rows are summed over "model" (indexing would
  gather the whole table).
* ``full_vocab``: the tied head's logits come out sharded over "model" by
  vocab; they are gathered before the log-softmax and the argmax, which
  reduce over the whole vocab (a redistribute, not ``loss_parallel``).
* ``split_heads``: a projection whose heads do not split evenly over
  "model" (gemma3's one kv head: "model" would cut its d_head) is
  replicated over "model" before it is viewed as heads.
* ``write_slot`` and ``prefill_cache``: the decode cache is sharded by
  rows over "data" and by sequence over "model" (context-sharded);
  each rank writes the new slot into its own shard, and the decode kernel
  reads the layer's cache gathered over "model" (``kernels/ops.py``).

On plain tensors every helper is the identity or the one-device code.
"""
from __future__ import annotations

import torch


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor())


def gathered(w):
    """``w`` gathered over every mesh dim but "model" (FSDP); a plain
    tensor (or None) as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    want = [p if n == "model" else Replicate()
            for n, p in zip(names, w.placements)]
    return w if want == list(w.placements) else w.redistribute(
        placements=want)


def over_model(x):
    """``x`` replicated over "model"."""
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names
    want = [Replicate() if n == "model" else p
            for n, p in zip(names, x.placements)]
    return x if want == list(x.placements) else x.redistribute(
        placements=want)


def replicated(x):
    """``x`` replicated over the whole mesh (a partial sum, norm or max
    reduced); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = [Replicate()] * x.device_mesh.ndim
    return x if list(x.placements) == want else x.redistribute(
        placements=want)


def placed_like(g, p):
    """A gradient with its parameter's placements (autograd may hand it
    back partial or otherwise laid out); plain tensors as they are."""
    if is_dtensor(g) and list(g.placements) != list(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def embed(table, tokens):
    """``table[tokens]``. On a DTensor table (vocab over "model", width
    gathered over "data") each rank looks up the tokens of its own vocab
    rows and zeros elsewhere, and the partial rows are summed over
    "model"; the table's gradient is partial over the mesh dims its rows
    split the tokens over."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    table = gathered(table)
    mesh, names = table.device_mesh, table.device_mesh.mesh_dim_names
    v0 = _shard_offset(table, 0)
    t_pl = list(tokens.placements)

    def lookup(tab, tok):
        j = tok.long() - v0
        inside = (j >= 0) & (j < tab.shape[0])
        rows = tab[j.clamp(0, tab.shape[0] - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))
    vocab_split = [p == Shard(0) for p in table.placements]
    out_pl = [Partial() if v else p for v, p in zip(vocab_split, t_pl)]
    grad_pl = [p if v else (Partial() if t != Replicate() else Replicate())
               for v, p, t in zip(vocab_split, table.placements, t_pl)]
    out = local_map(lookup, out_placements=out_pl,
                    in_placements=(list(table.placements), t_pl),
                    in_grad_placements=(grad_pl, t_pl),
                    device_mesh=mesh)(table, tokens)
    return out.redistribute(placements=t_pl)


def full_vocab(logits):
    """Logits gathered over "model" (vocab) on a mesh."""
    return over_model(logits) if is_dtensor(logits) else logits


def model_size(x) -> int:
    names = x.device_mesh.mesh_dim_names
    return x.device_mesh.size(names.index("model")) \
        if "model" in names else 1


def split_heads(x, n_heads: int):
    """(..., n_heads * d) ready to be viewed as heads: replicated over
    "model" where its heads do not split over it (one head, or a count
    that "model" does not divide), so that no view cuts a head's d."""
    if is_dtensor(x) and (n_heads == 1 or n_heads % model_size(x)):
        return over_model(x)
    return x


def _shard_offset(t, dim: int) -> int:
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, off = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return int(off[dim])


def _rows_like(x, cache):
    """``x`` (rows first) with the cache's placement of its rows, and
    replicated elsewhere: its local rows are the cache shard's."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = cache.device_mesh
    want = [Shard(0) if p == Shard(0) else Replicate()
            for p in cache.placements]
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, want).to_local()


def write_slot(cache, idx, new) -> None:
    """``cache[b, idx[b]] = new[b]`` in place: cache (B, S, KH, D), idx
    (B,), new (B, KH, D). On a DTensor cache each rank writes the rows and
    slots of its own shard (a slot outside it is left as it was)."""
    if not is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx] = new.to(cache.dtype)
        return
    local = cache.to_local()
    j = _rows_like(idx, cache) - _shard_offset(cache, 1)
    inside = (j >= 0) & (j < local.shape[1])
    j = j.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    new = _rows_like(over_model(new) if is_dtensor(new) else new, cache)
    local[rows, j] = torch.where(inside[:, None, None],
                                 new.to(local.dtype), local[rows, j])


def prefill_cache(kvs, max_seq: int):
    """The decoder's {"k", "v"} (L, B, max_seq, KH, D) from a prompt's
    per-layer (k, v), each (B, S, KH, D) DTensors: the prompt's slots,
    then zeros, in the layout the prompt's k and v have."""
    from torch.distributed.tensor import zeros
    out = {}
    for name, i in (("k", 0), ("v", 1)):
        full = torch.stack([kv[i] for kv in kvs])
        L, B, S, KH, D = full.shape
        pad = zeros((L, B, max_seq - S, KH, D), dtype=full.dtype,
                    device_mesh=full.device_mesh,
                    placements=full.placements)
        out[name] = torch.cat([full, pad], dim=2)
    return out
