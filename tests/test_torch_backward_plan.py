"""The work lists of attention's backward kernel, computed with no card.

``kernels/flash_attention.py::backward_plan`` decides which CTA of the
backward's two passes (dK/dV over resident blocks of 64 keys, dQ over
resident blocks of 64 queries) walks which streamed blocks, and which
chains are split and summed by the reduce kernel. On the shapes of
``tests/test_torch_cuda.py::BWD_CASES`` (gemma3-1b's training layers,
whisper's decoder over its frames, ragged and grouped edges, the ragged
600-token row):

* coverage: for every query head, every (query, key) pair that
  ``ref.attention_mask`` lets through is covered exactly once in each
  pass, with the dQ pass in blocks of 64 keys (reading the dS tiles the
  dK/dV pass stores) and of 32 (computing them again), every resident
  block is written once (by its one entry, or by the reduce over its
  entries' slots), no step is out of range, and every allowed pair lies
  in a stored dS tile;
* balance: at least a wave of dK/dV CTAs on 132 SMs where the work allows
  (the ragged row: 132 or more, where one CTA a key block gives 10),
  entries heaviest first, no chain above twice the mean;
* semantics: the gradient that the lists describe, computed block by
  block on the CPU as the kernel computes it (P and dS per step, dS
  tiles stored and read back, float32 partials summed in slot order),
  against the plain backward
  (``ref.flash_attention_backward_reference``; 1e-5 of each gradient's
  largest entry, the same float32 sums in another order) and against
  ``jax.vjp`` of ``repro``'s ``chunked_attention`` (``_ca_bwd``; 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import chunked_attention
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (BWD_BLOCK_C, BWD_BLOCK_R,
                                                 backward_plan)
from test_torch_cuda import BWD_CASES

torch.set_num_threads(1)
SMS = 132          # the H100 SXM's streaming multiprocessors
RAGGED = (1, 4, 1, 600, 600, 256, True, 512)


def _cdiv(a, b):
    return -(-a // b)


def _plan(B, H, KH, S, T, D, causal, window, dq_block=BWD_BLOCK_R):
    return backward_plan(B, H, KH, S, T, causal, window, SMS, dq_block)


# the dQ pass from stored dS tiles (blocks of 64 keys) and computing them
# again (blocks of 32)
DQ_BLOCKS = pytest.mark.parametrize("dq_block", [BWD_BLOCK_R, BWD_BLOCK_C])


def _steps(items, count_heads):
    """(resident, head offset, streamed block) of every step of a list."""
    for resident, first, count, lo, hi, _ in items.tolist():
        for i in range(lo, hi):
            g, j = divmod(i, count) if count_heads else (0, i)
            yield resident, g, first + j


def test_ragged_row_is_in_the_cuda_cases():
    assert RAGGED in BWD_CASES


@DQ_BLOCKS
@pytest.mark.parametrize("B,H,KH,S,T,D,causal,window", BWD_CASES)
def test_each_allowed_pair_is_covered_once_in_each_pass(B, H, KH, S, T, D,
                                                        causal, window,
                                                        dq_block):
    plan = _plan(B, H, KH, S, T, D, causal, window, dq_block)
    G, R, C = H // KH, BWD_BLOCK_R, BWD_BLOCK_C
    mask = ref.attention_mask(S, T, causal, window, "cpu").numpy()
    nkb, nqb = _cdiv(T, R), _cdiv(S, R)

    cover = np.zeros((B, H, S, T), np.int16)
    for resident, g, qb in _steps(plan.kv_items, True):
        (b, kh), kb = divmod(resident // nkb, KH), resident % nkb
        assert 0 <= g < G and 0 <= qb < _cdiv(S, C)
        s0, k0 = qb * C, kb * R
        cover[b, kh * G + g, s0:s0 + C, k0:k0 + R] += \
            mask[s0:s0 + C, k0:k0 + R]
    assert np.array_equal(cover, np.broadcast_to(mask, cover.shape))

    cover[:] = 0
    K = plan.dq_block
    for resident, _, kb in _steps(plan.q_items, False):
        (b, h), qb = divmod(resident // nqb, H), resident % nqb
        assert 0 <= kb < _cdiv(T, K)
        s0, k0 = qb * R, kb * K
        cover[b, h, s0:s0 + R, k0:k0 + K] += mask[s0:s0 + R, k0:k0 + K]
    assert np.array_equal(cover, np.broadcast_to(mask, cover.shape))


@pytest.mark.parametrize("B,H,KH,S,T,D,causal,window", BWD_CASES)
def test_stored_ds_tiles_hold_every_allowed_pair(B, H, KH, S, T, D, causal,
                                                 window):
    """``kv_chains``: the dK/dV pass's step i of key block kb stores tile
    first-tile + i; the tiles are numbered without gaps or overlaps, and
    every allowed pair lies in a tile of its key block's chain (the dQ
    pass reads zeros for a 32-query block outside it)."""
    plan = _plan(B, H, KH, S, T, D, causal, window)
    G, R, C = H // KH, BWD_BLOCK_R, BWD_BLOCK_C
    chains = plan.kv_chains
    assert chains.shape == (B * KH * _cdiv(T, R), 3)
    counts = G * chains[:, 1].astype(np.int64)
    assert np.array_equal(chains[:, 2], np.cumsum(counts) - counts)
    assert plan.ds_tiles == counts.sum()
    mask = ref.attention_mask(S, T, causal, window, "cpu").numpy()
    for kb in range(_cdiv(T, R)):
        first, count, _ = chains[kb]            # alike for every (b, kh)
        seen = mask[:, kb * R:kb * R + R].any(axis=1)
        qbs = set(np.flatnonzero(seen) // C)
        assert qbs <= set(range(first, first + count))


@DQ_BLOCKS
@pytest.mark.parametrize("B,H,KH,S,T,D,causal,window", BWD_CASES)
def test_each_resident_block_is_written_once(B, H, KH, S, T, D, causal,
                                             window, dq_block):
    """A resident block's entries split its chain into disjoint step
    ranges; one entry writes the gradient itself (slot -1), several write
    consecutive slots that one reduce entry sums."""
    plan = _plan(B, H, KH, S, T, D, causal, window, dq_block)
    R = BWD_BLOCK_R
    for p, items, n_res, slots in (
            (0, plan.kv_items, B * KH * _cdiv(T, R), plan.kv_slots),
            (1, plan.q_items, B * H * _cdiv(S, R), plan.q_slots)):
        reduce = {r[1]: (r[2], r[3]) for r in plan.reduce.tolist()
                  if r[0] == p}
        by_res = {}
        for resident, first, count, lo, hi, slot in items.tolist():
            by_res.setdefault(resident, []).append((lo, hi, slot, count))
        assert sorted(by_res) == list(range(n_res))
        used = []
        for resident, parts in by_res.items():
            parts.sort()
            n = parts[0][3] * (H // KH if p == 0 else 1)
            assert [lo for lo, *_ in parts] == \
                [0] + [hi for _, hi, *_ in parts[:-1]]
            assert parts[-1][1] == n
            if len(parts) == 1:
                assert parts[0][2] == -1 and resident not in reduce
            else:
                slot0, count = reduce[resident]
                assert count == len(parts)
                assert [s for *_, s, _ in parts] == \
                    list(range(slot0, slot0 + count))
                used += range(slot0, slot0 + count)
        assert sorted(used) == list(range(slots))


@DQ_BLOCKS
@pytest.mark.parametrize("B,H,KH,S,T,D,causal,window", BWD_CASES)
def test_entries_run_heaviest_first_and_balanced(B, H, KH, S, T, D, causal,
                                                 window, dq_block):
    plan = _plan(B, H, KH, S, T, D, causal, window, dq_block)
    for items in (plan.kv_items, plan.q_items):
        lengths = items[:, 4] - items[:, 3]
        assert np.all(np.diff(lengths) <= 0)            # heaviest first
        assert lengths.max() <= 2 * lengths.mean() + 1
        steps = int(lengths.sum())
        assert len(items) >= min(SMS, steps)            # a wave if it can


def test_ragged_row_fills_the_card():
    B, H, KH, S, T, D, causal, window = RAGGED
    plan = _plan(*RAGGED)
    one_a_block = B * KH * _cdiv(T, BWD_BLOCK_R)
    assert one_a_block == 10
    assert len(plan.kv_items) >= SMS
    assert plan.kernels == 4                # its chains split: a reduce
    # fewer SMs, fewer CTAs: the plan follows the card
    assert len(backward_plan(B, H, KH, S, T, causal, window, 16)
               .kv_items) < len(plan.kv_items)


def _emulate(plan, q, k, v, o, lse, do, causal, window):
    """The gradient the work lists describe, as the kernel computes it:
    each entry's steps (P and dS of a block pair, masked), its partial
    written to the gradient or its slot, the slots summed in order; with
    ``dq_block`` 64 the dK/dV pass stores each step's dS tile (32 queries
    x 64 keys, at its chain's first tile + step) and the dQ pass reads
    the tiles of its key block's chain, zeros outside it."""
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    G, R, C = H // KH, BWD_BLOCK_R, BWD_BLOCK_C
    mask = ref.attention_mask(S, T, causal, window, "cpu")
    scale, delta = D ** -0.5, (do * o).sum(-1)
    nkb, nqb = _cdiv(T, R), _cdiv(S, R)
    dq, dk, dv = (torch.full_like(x, float("nan")) for x in (q, k, v))
    kv_ws = torch.full((plan.kv_slots, 2, R, D), float("nan"))
    q_ws = torch.full((plan.q_slots, R, D), float("nan"))
    tiles = torch.full((plan.ds_tiles, C, R), float("nan"))

    def probs(b, h, kh, s0, s1, k0, k1):
        x = q[b, h, s0:s1] @ k[b, kh, k0:k1].T
        p = torch.where(mask[s0:s1, k0:k1],
                        torch.exp(x * scale - lse[b, h, s0:s1, None]), 0.)
        dp = do[b, h, s0:s1] @ v[b, kh, k0:k1].T
        return p, p * (dp - delta[b, h, s0:s1, None]) * scale

    for resident, first, count, lo, hi, slot in plan.kv_items.tolist():
        (b, kh), kb = divmod(resident // nkb, KH), resident % nkb
        k0, k1 = kb * R, min(T, kb * R + R)
        pk, pv = torch.zeros(k1 - k0, D), torch.zeros(k1 - k0, D)
        for i in range(lo, hi):
            g, j = divmod(i, count)
            h, s0 = kh * G + g, (first + j) * C
            s1 = min(S, s0 + C)
            p, ds = probs(b, h, kh, s0, s1, k0, k1)
            pv += p.T @ do[b, h, s0:s1]
            pk += ds.T @ q[b, h, s0:s1]
            tile = torch.zeros(C, R)
            tile[:s1 - s0, :k1 - k0] = ds
            tiles[plan.kv_chains[resident, 2] + i] = tile
        if slot < 0:
            dk[b, kh, k0:k1], dv[b, kh, k0:k1] = pk, pv
        else:
            kv_ws[slot, 0, :k1 - k0], kv_ws[slot, 1, :k1 - k0] = pk, pv
    for resident, first, count, lo, hi, slot in plan.q_items.tolist():
        (b, h), qb = divmod(resident // nqb, H), resident % nqb
        s0, s1 = qb * R, min(S, qb * R + R)
        pq = torch.zeros(s1 - s0, D)
        K = plan.dq_block
        for i in range(lo, hi):
            k0 = (first + i) * K
            k1 = min(T, k0 + K)
            if K == C:
                _, ds = probs(b, h, h // G, s0, s1, k0, k1)
            else:                       # two tiles of the key block
                cf, cc, base = plan.kv_chains[(b * KH + h // G) * nkb
                                              + first + i]
                ds = torch.zeros(R, R)
                for half in range(2):
                    j = qb * R // C + half - cf
                    if 0 <= j < cc:
                        ds[half * C:half * C + C] = \
                            tiles[base + (h % G) * cc + j]
                ds = ds[:s1 - s0, :k1 - k0]
            pq += ds @ k[b, h // G, k0:k1]
        if slot < 0:
            dq[b, h, s0:s1] = pq
        else:
            q_ws[slot, :s1 - s0] = pq
    for p, resident, slot0, n in plan.reduce.tolist():
        if p == 0:
            (b, kh), kb = divmod(resident // nkb, KH), resident % nkb
            k0, k1 = kb * R, min(T, kb * R + R)
            sk, sv = kv_ws[slot0, 0], kv_ws[slot0, 1]
            for j in range(1, n):
                sk, sv = sk + kv_ws[slot0 + j, 0], sv + kv_ws[slot0 + j, 1]
            dk[b, kh, k0:k1], dv[b, kh, k0:k1] = sk[:k1 - k0], sv[:k1 - k0]
        else:
            (b, h), qb = divmod(resident // nqb, H), resident % nqb
            s0, s1 = qb * R, min(S, qb * R + R)
            sq = q_ws[slot0]
            for j in range(1, n):
                sq = sq + q_ws[slot0 + j]
            dq[b, h, s0:s1] = sq[:s1 - s0]
    return dq, dk, dv


def _inputs(B, H, KH, S, T, D, causal, window, seed):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, H, S, D))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, KH, T, D))
                             .astype(np.float32)) for _ in range(2))
    o = ref.flash_attention_reference(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse_reference(q, k, causal=causal,
                                            window=window)
    return q, k, v, o, lse, do


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


# BWD_CASES at d_head 8 (the lists do not depend on D) and fewer rows
@DQ_BLOCKS
@pytest.mark.parametrize("B,H,KH,S,T,D,causal,window", [
    (min(B, 2), H, KH, S, T, 8, causal, window)
    for B, H, KH, S, T, D, causal, window in BWD_CASES])
def test_work_lists_give_the_plain_gradient(B, H, KH, S, T, D, causal,
                                            window, dq_block):
    plan = _plan(B, H, KH, S, T, D, causal, window, dq_block)
    args = _inputs(B, H, KH, S, T, D, causal, window, S + T)
    got = _emulate(plan, *args, causal, window)
    want = ref.flash_attention_backward_reference(*args, causal=causal,
                                                  window=window)
    for a, b in zip(got, want):
        assert not a.isnan().any()
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 300),
                                           (False, 0)])
def test_work_lists_give_repro_ca_bwd(causal, window):
    """The lists' gradient against ``jax.vjp`` of ``repro``'s
    ``chunked_attention`` (its hand-written ``_ca_bwd``, in chunks of 128
    queries and 256 keys), repro's layout transposed."""
    B, H, KH, S, D = 1, 4, 2, 512, 8
    G = H // KH
    q, k, v, o, lse, do = _inputs(B, H, KH, S, S, D, causal, window, 5)
    got = _emulate(_plan(B, H, KH, S, S, D, causal, window), q, k, v, o,
                   lse, do, causal, window)
    jq = jnp.asarray(q.numpy().transpose(0, 2, 1, 3).reshape(B, S, KH, G, D))
    jk, jv = (jnp.asarray(x.numpy().transpose(0, 2, 1, 3)) for x in (k, v))
    jdo = jnp.asarray(do.numpy().transpose(0, 2, 1, 3).reshape(B, S, KH, G,
                                                               D))
    _, vjp = jax.vjp(lambda a, b, c: chunked_attention(
        a, b, c, causal, window or None, q_chunk=128, k_chunk=256),
        jq, jk, jv)
    jdq, jdk, jdv = vjp(jdo)
    want = (np.asarray(jdq).reshape(B, S, H, D).transpose(0, 2, 1, 3),
            np.asarray(jdk).transpose(0, 2, 1, 3),
            np.asarray(jdv).transpose(0, 2, 1, 3))
    for a, b in zip(got, want):
        assert _rel(a, torch.tensor(b)) <= 1e-4


def test_plan_of_stores_ds_under_the_cap(monkeypatch):
    """The wrapper's plan: dS tiles stored (the dQ pass in blocks of 64
    keys) while they fit under ``BWD_DS_CAP``, read at each call; above
    it, the dQ pass in blocks of 32 keys computes them again."""
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(fa, "_sm_count", lambda index: SMS)
    q, k = torch.zeros((4, 4, 1024, 8)), torch.zeros((4, 1, 1024, 8))
    plan = fa.plan_of(q, k, causal=True, window=512)
    assert plan.dq_block == BWD_BLOCK_R
    assert plan.ds_tiles * BWD_BLOCK_C * BWD_BLOCK_R * 4 <= fa.BWD_DS_CAP
    monkeypatch.setattr(fa, "BWD_DS_CAP", plan.ds_tiles * 2048 * 4 - 1)
    assert fa.plan_of(q, k, causal=True, window=512).dq_block == BWD_BLOCK_C
    # bf16 tiles are half the bytes
    assert fa.plan_of(q.bfloat16(), k.bfloat16(), causal=True,
                      window=512).dq_block == BWD_BLOCK_R
