"""Wrapper of the CUDA flash-attention kernels.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention_pallas``:
causal and/or sliding-window grouped-query attention with query positions
right-aligned at offset T - S. Unlike the TPU kernel, S and T
need not be multiples of a block: the kernels mask the ragged edges. The
dtype picks the kernel, and nothing else does:

* bf16: ``csrc/flash_attention_sm90.cu``, ``wgmma`` on TMA-fed tiles
  (variant ``"wgmma"``); it needs D % 8 == 0 (TMA's 16-byte rows).
* float32: ``csrc/flash_attention.cu``, split-precision TF32 on
  ``mma.sync`` (variant ``"tf32x3"``): three TF32 products for each float32
  one, accurate to float32's bar; any D <= 256.

Both split a long kv range across CTAs where the grid is small; the
wrapper then allocates the float32 partial rows a second kernel merges, so
a call launches one or two CUDA kernels. With ``return_lse`` either also
writes each row's log-sum-exp (float32 (B,H,S)), which the backward reads;
serving passes no ``lse`` buffer, and the kernels then write none.

The gradient: ``csrc/flash_attention_backward.cu`` (both dtypes, on the
tensor cores: split TF32 on ``mma.sync`` in float32, bf16 ``mma.sync`` in
bf16), the counterpart of ``repro``'s hand-written ``kernels/ref.py::
_ca_bwd``. Its two passes (dK/dV over resident key blocks, storing dS
tiles; dQ over resident query blocks, reading them back, or computing
them again where they would pass ``BWD_DS_CAP``) run from work lists
that ``backward_plan`` builds from the shape and the card's SM count,
cached per shape on the device: long chains split over several CTAs,
heaviest first, their float32 partials summed by a reduce kernel in a
fixed order (no atomics: two calls give bitwise-equal gradients). A call
is three or four CUDA kernels (``plan_of(q, k, ...).kernels``), one
count; the wrapper allocates the workspaces. ``FlashAttention`` is the
autograd function over the forward and that kernel, which
``kernels/ops.py`` runs where a CUDA input requires grad. The source
notes say what bounds each kernel on the H100 and how it is tiled.

Plain versions: ``kernels/ref.py::flash_attention_reference``,
``flash_attention_lse_reference`` and
``flash_attention_backward_reference``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import heapq
from typing import Tuple

import numpy as np
import torch

from . import _build

MAX_D = 256


# variant -> library, and the name of its C entry point
_ENTRY = {"wgmma": "flash_attention_sm90", "tf32x3": "flash_attention"}


def _variant(dtype: torch.dtype) -> str:
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


@functools.cache
def _lib(variant: str) -> ctypes.CDLL:
    lib = _build.load(_ENTRY[variant])
    fn = getattr(lib, _ENTRY[variant])
    # q, k, v, o, the split kv range's scratch, lse; 9 ints; the stream
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    splits = getattr(lib, f"{_ENTRY[variant]}_splits")
    splits.argtypes = [ctypes.c_int] * 8
    splits.restype = ctypes.c_int
    return lib


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, window: int) -> None:
    """Raise on q, k, v that no attention kernel here takes."""
    _build.require_cuda(name, q, k, v)
    if q.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v differ in dtype")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: want q (B,H,S,D) and k, v (B,KH,T,D) of "
                         "one shape")
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KH:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if D > MAX_D or T < S:
        raise ValueError(f"{name}: needs D <= {MAX_D} and T >= S")
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         return_lse: bool = False):
    """q: (B,H,S,D); k, v: (B,KH,T,D) with T >= S. Returns (B,H,S,D), or
    with ``return_lse`` (out, lse), lse the float32 (B,H,S) row
    log-sum-exp of the masked scaled scores.

    Raises on anything the kernel does not take; never computes on another
    path.
    """
    _check_shapes("flash_attention", q, k, v, window)
    B, H, S, D = q.shape
    variant = _variant(q.dtype)
    if variant == "wgmma" and D % 8:
        raise ValueError(f"flash_attention: the bf16 kernel needs D % 8 == 0 "
                         f"(TMA's 16-byte rows), got D = {D}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    lib = _lib(variant)
    entry = _ENTRY[variant]
    splits = kv_splits(q, k, causal=causal, window=window)
    part = ml = None
    if splits > 1:           # float32 partial rows and their (max, sum)
        part = torch.empty((splits, B, H, S, D), dtype=torch.float32,
                           device=q.device)
        ml = torch.empty((splits, B, H, S, 2), dtype=torch.float32,
                         device=q.device)
    code = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if ml is None else ml.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, H, k.shape[1], S, k.shape[2], D, int(bool(causal)), int(window),
        splits, _build.current_stream(q.device))
    _build.check_launch(lib, entry, code)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variant_launches[variant] += 1
    return (out, lse) if return_lse else out


# -- the backward ------------------------------------------------------------

# csrc/flash_attention_backward.cu's tiles: a CTA keeps BWD_BLOCK_R keys
# (dK/dV pass) or queries (dQ pass) resident and streams BWD_BLOCK_C rows of
# the other side a step
BWD_BLOCK_R, BWD_BLOCK_C = 64, 32
# a CTA's fixed cost in streamed steps (its resident tiles, its epilogue
# and, for a split chain, the reduce), for the plan's makespan model
_BWD_CTA_COST = 1
# bytes of dS tiles the dK/dV pass may store for the dQ pass (which then
# reads dS in blocks of 64 keys); above, the dQ pass computes S and dP
# again, in blocks of 32 keys
BWD_DS_CAP = 256 << 20


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """The backward kernel's work lists for one shape.

    ``kv_items`` (dK/dV pass) and ``q_items`` (dQ pass): int32 (n, 6), one
    row a CTA, heaviest first: (resident block, first streamed block,
    streamed blocks a head, begin, end, slot). The dK/dV pass's resident
    block ``(b * KH + kh) * ceil(T / 64) + kb`` holds keys 64 kb.. of kv
    head kh; its step i in [begin, end) is query head kh * G + i // count,
    queries 32 (first + i % count)... The dQ pass's resident ``(b * H + h)
    * ceil(S / 64) + qb`` holds queries 64 qb.. of head h; step i is keys
    ``dq_block`` (first + i)... (64 where the dQ pass reads the dS tiles
    the dK/dV pass stored, 32 where it computes them again). ``slot`` is
    -1 where the row covers its resident block's whole chain (it writes
    the gradient), else its float32 partial's place in the pass's
    workspace. ``reduce``: int32 (m, 4), one row a split chain: (pass 0
    dK/dV or 1 dQ, resident block, first slot, slots), summed in slot
    order. ``kv_chains``: int32 (resident blocks, 3), each key block's
    (first, count, first dS tile): the dK/dV pass's step i of it stores
    tile first-tile + i (32 queries x 64 keys); ``ds_tiles`` in all."""
    kv_items: np.ndarray
    q_items: np.ndarray
    reduce: np.ndarray
    kv_chains: np.ndarray
    kv_slots: int
    q_slots: int
    ds_tiles: int
    dq_block: int

    @property
    def kernels(self) -> int:
        """CUDA kernels a call: delta, the two passes, and the reduce where
        a chain splits."""
        return 3 + (len(self.reduce) > 0)


def _kv_chains(B, H, KH, S, T, causal, window):
    """The dK/dV pass's chains: per resident key block, (first, count) of
    the 32-query blocks that see some key of it (a superset: the kernel
    masks within a block), count steps for each of the G heads."""
    off, G, out = T - S, H // KH, []
    for kb in range(_cdiv(T, BWD_BLOCK_R)):
        k0 = kb * BWD_BLOCK_R
        k_last = min(k0 + BWD_BLOCK_R, T) - 1
        lo = max(0, k0 - off) if causal else 0           # qpos >= k0
        hi = min(S, k_last + window - off) if window > 0 else S
        first = lo // BWD_BLOCK_C
        count = _cdiv(hi, BWD_BLOCK_C) - first if hi > lo else 0
        out.append((first, count, G * count))
    return [((b * KH + kh) * len(out) + kb, *c)
            for b in range(B) for kh in range(KH)
            for kb, c in enumerate(out)]


def _q_chains(B, H, KH, S, T, causal, window, block):
    """The dQ pass's chains: per resident query block, (first, count) of
    the key blocks of ``block`` keys some query of it sees, one step
    each."""
    off, out = T - S, []
    for qb in range(_cdiv(S, BWD_BLOCK_R)):
        q_first = qb * BWD_BLOCK_R + off
        q_last = min((qb + 1) * BWD_BLOCK_R, S) - 1 + off
        lo = max(0, q_first - window + 1) if window > 0 else 0
        hi = min(T, q_last + 1) if causal else T
        first = lo // block
        count = _cdiv(hi, block) - first if hi > lo else 0
        out.append((first, count, count))
    return [((b * H + h) * len(out) + qb, *c)
            for b in range(B) for h in range(H)
            for qb, c in enumerate(out)]


def _makespan(lengths, sms: int) -> int:
    """When the last of CTAs of these chain lengths ends, taken in order
    by whichever of ``sms`` SMs frees first, each costing its length plus
    ``_BWD_CTA_COST``."""
    free = [0] * sms
    end = 0
    for n in lengths:
        t = heapq.heappop(free) + n + _BWD_CTA_COST
        heapq.heappush(free, t)
        end = max(end, t)
    return end


def _pieces(n: int, c: int):
    """A chain of n steps in ceil(n / c) near-equal ranges (one if n = 0)."""
    p = max(1, _cdiv(n, c))
    return [(i * n // p, (i + 1) * n // p) for i in range(p)]


def _split_chains(chains, sms: int):
    """The work list of one pass: each chain (resident, first, count, n)
    cut into ranges of at most c steps, c chosen so that the pass has at
    least a wave of ``sms`` CTAs where the work allows (every step its own
    CTA if not) and, among such c, the earliest modelled end (ties: the
    larger c, fewer partials); sorted longest first."""
    ns = [n for *_, n in chains]
    need = min(sms, sum(max(1, n) for n in ns))
    best = None
    for c in range(1, max(ns, default=0) + 1):
        lengths = sorted((hi - lo for n in ns for lo, hi in _pieces(n, c)),
                         reverse=True)
        if len(lengths) < need:
            break
        span = _makespan(lengths, sms)
        if best is None or span <= best[0]:
            best = (span, c)
    c = best[1] if best else 1
    items, reduce, slots = [], [], 0
    for resident, first, count, n in chains:
        pieces = _pieces(n, c)
        if len(pieces) > 1:
            reduce.append((resident, slots, len(pieces)))
        for j, (lo, hi) in enumerate(pieces):
            slot = slots + j if len(pieces) > 1 else -1
            items.append((resident, first, count, lo, hi, slot))
        if len(pieces) > 1:
            slots += len(pieces)
    # longest first; among equals, in resident and step order
    items.sort(key=lambda it: (it[3] - it[4], it[0], it[3]))
    return np.array(items, dtype=np.int32).reshape(-1, 6), reduce, slots


@functools.lru_cache(maxsize=256)
def backward_plan(B: int, H: int, KH: int, S: int, T: int, causal: bool,
                  window: int, sms: int,
                  dq_block: int = BWD_BLOCK_R) -> BackwardPlan:
    """The backward kernel's work lists for q (B,H,S,D) against k, v
    (B,KH,T,D) on a card of ``sms`` SMs (D does not change them), the dQ
    pass in blocks of ``dq_block`` keys (64: from stored dS; 32: computing
    it again). Plain Python: the CPU tests check that every (query, key)
    pair the masks let through is covered once in each pass."""
    chains = _kv_chains(B, H, KH, S, T, causal, window)
    kv, kv_red, kv_slots = _split_chains(chains, sms)
    q, q_red, q_slots = _split_chains(
        _q_chains(B, H, KH, S, T, causal, window, dq_block), sms)
    reduce = [(0, *r) for r in kv_red] + [(1, *r) for r in q_red]
    steps = np.array([n for *_, n in chains], dtype=np.int64)
    bases = np.concatenate([[0], np.cumsum(steps)[:-1]])
    kv_chains = np.array([(first, count, base) for (_, first, count, _), base
                          in zip(chains, bases)], dtype=np.int32)
    return BackwardPlan(kv, q, np.array(reduce, dtype=np.int32).reshape(
        -1, 4), kv_chains.reshape(-1, 3), kv_slots, q_slots,
        int(steps.sum()), dq_block)


@functools.lru_cache(maxsize=256)
def _ds_tiles(B, H, KH, S, T, causal, window) -> int:
    """The dS tiles (32 queries x 64 keys) the dK/dV pass stores."""
    return sum(n for *_, n in _kv_chains(B, H, KH, S, T, causal, window))


def _plan_key(q: torch.Tensor, k: torch.Tensor, causal: bool,
              window: int) -> tuple:
    B, H, S, _ = q.shape
    KH, T = k.shape[1], k.shape[2]
    key = (B, H, KH, S, T, bool(causal), int(window))
    ds_bytes = _ds_tiles(*key) * BWD_BLOCK_C * BWD_BLOCK_R * q.element_size()
    block = BWD_BLOCK_R if ds_bytes <= BWD_DS_CAP else BWD_BLOCK_C
    return key + (_sm_count(q.device.index), block)


def plan_of(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
            window: int = 0) -> BackwardPlan:
    """The plan ``flash_attention_backward_cuda`` runs for q, k on their
    card: stored dS (``dq_block`` 64) where the tiles fit under
    ``BWD_DS_CAP``."""
    return backward_plan(*_plan_key(q, k, causal, window))


@functools.lru_cache(maxsize=256)
def _device_lists(key: tuple, device: torch.device):
    """``backward_plan(*key)``'s four int32 lists on ``device`` (one copy
    a plan)."""
    plan = backward_plan(*key)
    parts = (plan.kv_items, plan.q_items, plan.reduce, plan.kv_chains)
    lists = torch.from_numpy(np.concatenate([a.ravel() for a in parts])
                             ).to(device)
    out, at = [], 0
    for a in parts:
        out.append(lists[at:at + a.size])
        at += a.size
    return out


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _backward_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_backward")
    # q, k, v, o, lse, do, delta, dq, dk, dv, the work lists, the reduce
    # list, the chains, the two partials' workspaces, the dS tiles; dtype
    # and 14 ints; the stream
    lib.flash_attention_backward.argtypes = [ctypes.c_void_p] * 17 \
        + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    lib.flash_attention_backward.restype = ctypes.c_int
    return lib


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor, *,
                                  causal: bool = True, window: int = 0):
    """Attention's gradient on the card: (q, k, v, o, lse, do) -> (dq, dk,
    dv), q, o, do (B,H,S,D) and k, v (B,KH,T,D) of one dtype, lse the
    forward's float32 (B,H,S). Three or four CUDA kernels (delta, the dK/dV
    pass, the dQ pass, the reduce where the plan splits a chain), one
    count; the dS tiles and the float32 partials of split chains go to
    workspaces allocated here. Raises on anything the kernel does not
    take."""
    _check_shapes("flash_attention_backward", q, k, v, window)
    _build.require_cuda("flash_attention_backward", q, o, lse, do)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("flash_attention_backward: o and do must match q "
                         "in shape and dtype")
    B, H, S, D = q.shape
    KH, T = k.shape[1], k.shape[2]
    if lse.dtype != torch.float32 or lse.shape != (B, H, S):
        raise ValueError(f"flash_attention_backward: lse must be float32 of "
                         f"shape {(B, H, S)}")
    key = _plan_key(q, k, causal, window)
    plan = backward_plan(*key)
    kv_items, q_items, reduce, chains = _device_lists(key, q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    kv_ws = torch.empty((plan.kv_slots, 2, BWD_BLOCK_R, D),
                        dtype=torch.float32, device=q.device) \
        if plan.kv_slots else None
    q_ws = torch.empty((plan.q_slots, BWD_BLOCK_R, D), dtype=torch.float32,
                       device=q.device) if plan.q_slots else None
    ds_ws = torch.empty((plan.ds_tiles, BWD_BLOCK_C, BWD_BLOCK_R),
                        dtype=q.dtype, device=q.device) \
        if plan.dq_block == BWD_BLOCK_R else None
    lib = _backward_lib()
    ptr = [None if t is None else t.data_ptr()
           for t in (kv_ws, q_ws, ds_ws)]
    code = lib.flash_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), kv_items.data_ptr(),
        q_items.data_ptr(), reduce.data_ptr() if len(plan.reduce) else None,
        chains.data_ptr(), *ptr, _build.DTYPE_CODES[q.dtype], B, H, KH, S,
        T, D, int(bool(causal)), int(window), len(plan.kv_items),
        len(plan.q_items), len(plan.reduce), BWD_BLOCK_R, BWD_BLOCK_C,
        plan.dq_block, _build.current_stream(q.device))
    _build.check_launch(lib, "flash_attention_backward", code)
    flash_attention_backward_cuda.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention differentiable on the card: the forward kernel (saving the
    output and its ``lse``), the backward kernel for the gradient. Only the
    CUDA kernels run; ``kernels/ops.py`` takes the plain version under
    ordinary autograd for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_cuda(
            q, k, v, out, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def mask_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """The (query, key) pairs that ``ref.attention_mask(S, T, causal,
    window)`` keeps, counted a row at a time in numpy (no (S, T) mask is
    made, and no torch op runs under a count)."""
    qpos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(qpos, T - 1) if causal else np.full_like(qpos, T - 1)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 \
        else np.zeros_like(qpos)
    return int(np.maximum(hi - lo + 1, 0).sum())


def forward_work(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                 window: int = 0, lse: bool = False) -> Tuple[int, int]:
    """(bytes, flops) that the forward function itself needs at q's and
    k's shapes: q, k and v read once, the output written once (with
    ``lse`` also the float32 row log-sum-exp); q k^T and P v over the
    pairs the mask keeps, two flops a multiply-add."""
    B, H, S, D = q.shape
    pairs = mask_pairs(S, k.shape[2], causal, window)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + (4 * B * H * S if lse else 0)
    return nbytes, 4 * B * H * D * pairs


def backward_work(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                  window: int = 0) -> Tuple[int, int]:
    """(bytes, flops) that the backward function itself needs: q, k, v,
    the output, its gradient and ``lse`` read once, dq, dk and dv written
    once; five products (q k^T, dO v^T, P^T dO, dS k, dS^T q) over the
    pairs the mask keeps."""
    B, H, S, D = q.shape
    pairs = mask_pairs(S, k.shape[2], causal, window)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + 4 * B * H * S
    return nbytes, 10 * B * H * D * pairs


def kv_splits(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
              window: int = 0) -> int:
    """How many CTAs share a query block's kv range in the kernel that
    ``flash_attention_cuda(q, k, v, ...)`` launches: 1 is one CUDA kernel
    a call, more is the split kernel and the merge kernel."""
    variant = _variant(q.dtype)
    B, H, S, _ = q.shape
    KH, T = k.shape[1], k.shape[2]
    fn = getattr(_lib(variant), f"{_ENTRY[variant]}_splits")
    return fn(B, H, KH, S, T, int(bool(causal)), int(window), q.device.index)


def reset_launches() -> None:
    """Set the forward's total and per-variant launch counts and the
    backward's count to 0."""
    flash_attention_cuda.launches = 0
    for v in flash_attention_cuda.variant_launches:
        flash_attention_cuda.variant_launches[v] = 0
    flash_attention_backward_cuda.launches = 0


flash_attention_cuda.launches = 0
flash_attention_cuda.variant_launches = dict.fromkeys(_ENTRY, 0)
flash_attention_backward_cuda.launches = 0
