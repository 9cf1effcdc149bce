"""The models on a mesh: what DTensor's sharding propagation does not
carry by itself (every family's prefill, decode and loss on DTensor
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
  gather the whole table). A vocab that "model" does not divide
  (whisper's 51,866 on 4) leaves the table whole over "model", and each
  rank looks up whole rows.
* ``whole``: a replicated DTensor as a plain tensor, to index a plain
  table with (whisper's sinusoid row at a decode step's cursor).
* ``full_vocab``: the tied head's logits come out sharded over "model" by
  vocab; they are gathered before the log-softmax and the argmax, which
  reduce over the whole vocab (a redistribute, not ``loss_parallel``).
* ``split_heads``: a projection whose heads do not split evenly over
  "model" (gemma3's one kv head: "model" would cut its d_head) is
  replicated over "model" before it is viewed as heads, in
  self-attention and in whisper's cross-attention alike.
* ``shardwise``: a function that keeps the sharded dims apart (the
  Mamba-2 block's causal conv and sequence padding) runs on each rank's
  own shard under ``local_map``, not op by op under propagation.
* ``group_rows`` and ``moe_dispatch``: the MoE's routing runs on each
  rank's whole groups (exact integers, as on one device), and its experts
  on the rank's own experts (expert parallel over "model"), whose sums
  are partial over "model".
* ``write_slot`` and ``prefill_cache``: the decode cache is sharded by
  rows over "data" and by sequence over "model" (context-sharded);
  each rank writes the new slot into its own shard, and the decode kernel
  reads the layer's cache gathered over "model" (``kernels/ops.py``).
  gemma3's ring of W slots is sharded so too: a write at pos % W lands on
  the rank that holds that slot, and a wrap writes slot 0 on the first
  "model" rank. whisper's prefill stacks its self K/V (padded to 448
  slots) and its cross K/V (the encoder's T frames) with
  ``prefill_cache``, and a decode step gathers both caches.
* Biases: a row-parallel product (``wo``, ``down``) comes out
  ``Partial()`` over "model", and its replicated bias is added once to
  the sum (propagation splits it over the partial ranks), not once a
  rank.

On plain tensors every helper is the identity or the one-device code.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops


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
    """``x`` replicated over "model"; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
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
    table = gathered(table)
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
    out = kops.on_local_shards(lookup, (table, tokens),
                               (list(table.placements), t_pl),
                               (grad_pl, t_pl), out_pl)
    return out.redistribute(placements=t_pl)


def whole(x):
    """``x`` as a plain tensor of every entry (a DTensor gathered); a
    plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def full_vocab(logits):
    """Logits gathered over "model" (vocab) on a mesh."""
    return over_model(logits) if is_dtensor(logits) else logits


def split_heads(x, n_heads: int):
    """(..., n_heads * d) ready to be viewed as heads: replicated over
    "model" where its heads do not split over it (one head, or a count
    that "model" does not divide), so that no view cuts a head's d."""
    if is_dtensor(x) and (n_heads == 1
                          or n_heads % kops.model_ranks(x.device_mesh)):
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


def prefill_cache(kvs, max_seq: int, names=("k", "v"), layers=None):
    """A cache's {names[0], names[1]} (L, B, max_seq, KH, D) from a
    prompt's per-layer (k, v), each (B, S, KH, D): the prompt's slots,
    then zeros. Each cache is made once, in the first layer's layout
    (DTensors on a mesh, the sequence whole on every rank), and each
    layer is laid out as it and copied into its slots as ``kvs`` yields
    it: an iterator of layers holds one layer beside the cache at most.
    ``layers`` is L where ``kvs`` has no length. The decoder's {"k",
    "v"}; whisper's self K/V and, at max_seq = T, its cross K/V
    ("cross_k", "cross_v")."""
    L = len(kvs) if layers is None else layers
    out, layout = {}, {}
    for i, kv in enumerate(kvs):
        for name, t in zip(names, kv):
            S = t.shape[1]
            if not is_dtensor(t):
                if name not in out:
                    out[name] = _stacked_zeros(t, L, max_seq)
                out[name][i, :, :S] = t
                continue
            if name not in out:
                layout[name] = _layer_layout(t)
                out[name] = _stacked_zeros(t, L, max_seq, layout[name])
            if list(t.placements) != layout[name]:
                t = t.redistribute(placements=layout[name])
            # rows, heads and d split alike in both: the local slots match
            out[name].to_local()[i, :, :S].copy_(t.to_local())
    return out


def _layer_layout(t):
    """A layer's (B, S, KH, D) k or v DTensor's placements with its
    sequence (dim 1) whole on every rank and partial sums reduced."""
    from torch.distributed.tensor import Replicate
    return [Replicate() if p.is_partial()
            or (p.is_shard() and p.dim % t.ndim == 1) else p
            for p in t.placements]


def _stacked_zeros(t, layers: int, max_seq: int, layout=None):
    """Zeros (layers, B, max_seq, KH, D) in the dtype of a layer's ``t``
    (B, S, KH, D), on its device or, for a DTensor, on its mesh with
    each dim split as in a layer's ``layout``."""
    B, _, KH, D = t.shape
    shape = (layers, B, max_seq, KH, D)
    if not is_dtensor(t):
        return torch.zeros(shape, dtype=t.dtype, device=t.device)
    from torch.distributed.tensor import Shard, zeros
    pl = [Shard(p.dim % t.ndim + 1) if p.is_shard() else p for p in layout]
    return zeros(shape, dtype=t.dtype, device_mesh=t.device_mesh,
                 placements=pl)


def shardwise(fn, x, *whole):
    """``fn(x, *whole)``. On a DTensor ``x``, ``fn`` runs on the rank's
    own shard of ``x`` (partial sums reduced first) with ``whole`` whole
    on every rank, and the result keeps ``x``'s placements: for a function
    that treats the dims ``x`` is sharded over independently and keeps
    their sizes (the Mamba-2 block's causal conv and its padding of the
    sequence). The gradients of ``whole`` are partial over the dims ``x``
    is sharded over."""
    if not is_dtensor(x):
        return fn(x, *whole)
    from torch.distributed.tensor import Partial, Replicate
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    rep = [Replicate()] * x.device_mesh.ndim
    grad = [Partial() if p.is_shard() else Replicate() for p in pl]
    n = len(whole)
    return kops.on_local_shards(fn, (x, *whole), (pl,) + (rep,) * n,
                                (pl,) + (grad,) * n, pl)


def group_rows(xt, tg: int):
    """Tokens (T, d) ready to be cut into groups of ``tg``: on a mesh,
    rows stay split where every rank holds whole groups, and are
    gathered otherwise (one group of a prompt, or a last ragged one)."""
    if not is_dtensor(xt):
        return xt
    T = xt.shape[0]
    if T % tg == 0 and (T // tg) % kops.row_ranks(xt.device_mesh) == 0:
        return xt
    return gathered(xt)


def moe_dispatch(route, experts, p, xg):
    """An MoE's dispatch on groups xg (G, Tg, d), a DTensor: (y, gate_idx,
    probs, kept) as ``moe._dispatch`` returns them.

    ``route(xg, router)`` runs on each rank's groups (over every mesh dim
    but "model" where G splits, else all of them; replicated over
    "model"), so its top-k, one-hots and cumsums are one device's on the
    same rows. ``experts(xg, dispatch, combine, up, gate, down)`` runs on
    the rank's experts where "model" divides them (expert parallel, as
    the sharding rules place them; else on all of them, gathered): the
    expert inputs take E over "model" and the combine's sum over E comes
    out ``Partial()`` over "model", reduced once where it meets the
    residual. Expert weights are gathered over the other dims first
    (FSDP). Gradients: a rank's routing sees its rows (the router's is
    partial over the dims they split over); its experts' share of xg's
    and of the combine weights' is partial over "model"."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, R = xg.device_mesh, Replicate()
    m = kops.model_ranks(mesh)
    n_exp = p["up"].shape[0]
    ep = n_exp % m == 0
    rows = xg.shape[0] % kops.row_ranks(mesh) == 0
    row, row_part = (Shard(0), Partial()) if rows else (R, R)
    rp = kops.mesh_placements(mesh, R, row)
    part = kops.mesh_placements(mesh, Partial() if ep else R, row)
    w_in = kops.mesh_placements(mesh, Shard(0) if ep else R, R)
    w_grad = kops.mesh_placements(mesh, Shard(0) if ep else R, row_part)
    dispatch, combine, gate_idx, probs, kept = kops.on_local_shards(
        route, (xg, replicated(p["router"])),
        (rp, kops.mesh_placements(mesh, R, R)),
        (rp, kops.mesh_placements(mesh, R, row_part)), (rp,) * 5)
    first = mesh.get_local_rank("model") * (n_exp // m) \
        if ep and "model" in mesh.mesh_dim_names else 0

    def mine(xg, dispatch, combine, up, gate, down):
        own = slice(first, first + up.shape[0])
        return experts(xg, dispatch[:, :, own], combine[:, :, own], up,
                       gate, down)
    y = kops.on_local_shards(
        mine, (xg, dispatch, combine, p["up"], p["gate"], p["down"]),
        (rp, rp, rp, w_in, w_in, w_in),
        (part, rp, part, w_grad, w_grad, w_grad), part)
    return y, gate_idx, probs, kept
