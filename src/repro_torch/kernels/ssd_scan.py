"""Wrappers of the CUDA SSD scan kernels (``csrc/ssd_scan.cu`` and
``csrc/ssd_scan_backward.cu``).

Counterpart of ``repro/kernels/ssd_scan.py::ssd_pallas``: the Mamba-2
chunked SSD scan with dt folded in, as three launches on the current
stream: the chunks' local states (chunk-parallel), the float32 state
passed across chunks, and each chunk's output (chunk-parallel). The source
note in the ``.cu`` file says what bounds the kernel on the H100 and how it
is split across CTAs. One call counts one launch.

Its backward (``ssd_backward_cuda``, four launches, one count) has no
Pallas counterpart: ``repro`` differentiates ``ssd_reference`` with
``jax.vjp``. ``backward_plan`` splits each (row, chunk)'s heads between
its CTAs and clusters. ``SSDScan`` joins the two as one differentiable
function.

Plain versions: ``kernels/ref.py::ssd_reference`` and
``ssd_backward_reference``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from . import _build

MAX_CHUNK = 128      # rows of a chunk (8 warps x 16 rows)
MAX_STATE = 128      # state width N (the shared memory of a chunk of 128)
MAX_GROUP = 8        # heads a CTA of the backward's chunk kernels loops over
MAX_CLUSTER = 8      # CTAs a cluster (the portable limit)
# A chunk CTA's time that does not grow with its heads (C B^T, M B, M^T C,
# the cluster sums, the loads before the first head), in heads' time: 2.5
# on the H100 (chip_smoke.py's partitions at 2, 4 and 8 heads; PERF.md)
FIXED_HEADS = 2.5


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    lib.ssd_scan.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.ssd_scan_smem_limit.argtypes = [ctypes.c_int]
    for fn in (lib.ssd_scan, lib.ssd_scan_smem_bytes,
               lib.ssd_scan_smem_limit):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_backward")
    lib.ssd_scan_backward.argtypes = [ctypes.c_void_p] * 22 \
        + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.ssd_scan_backward_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.ssd_scan_backward_dot_partials.argtypes = [ctypes.c_int] * 2
    lib.ssd_scan_backward_max_ctas.argtypes = [ctypes.c_int] * 5
    for fn in (lib.ssd_scan_backward, lib.ssd_scan_backward_smem_bytes,
               lib.ssd_scan_backward_dot_partials,
               lib.ssd_scan_backward_max_ctas):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _smem_limit(device_index: int) -> int:
    return _lib().ssd_scan_smem_limit(device_index)


def _check(name: str, tensors, chunk: int, more=()):
    """Check what both kernels take: ``tensors`` (x, dt, A, B, C first) on
    one CUDA device, contiguous, of one dtype; the shapes of x, dt, A, B, C
    and of ``more``, (name, tensor, "state" for (b,h,p,n) or "x" for
    (b,l,h,p)); the chunking. Returns (device, (b, l, h, p, n), ck)."""
    dev = _build.require_cuda(name, *tensors)
    x, dt, A, B, C = tensors[:5]
    if x.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported")
    if any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"{name}: the inputs differ in dtype")
    if x.dim() != 4:
        raise ValueError(f"{name}: want x (b,l,h,p)")
    b, l, h, p = x.shape
    n = B.shape[-1]
    want = {"state": (b, h, p, n), "x": (b, l, h, p)}
    shapes = {"dt": (dt, (b, l, h)), "A": (A, (h,)), "B": (B, (b, l, n)),
              "C": (C, (b, l, n))}
    for key, t, kind in more:
        shapes[key] = (t, want[kind])
    for key, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"want {shape}")
    ck = min(chunk, l)
    if ck <= 0 or l % ck:
        raise ValueError(f"{name}: sequence {l} not divisible by chunk {ck}")
    if ck > MAX_CHUNK or n > MAX_STATE:
        raise ValueError(f"{name}: the kernel takes chunks of at most "
                         f"{MAX_CHUNK} and a state of at most {MAX_STATE}, "
                         f"got {ck} and {n}")
    return dev, (b, l, h, p, n), ck


def _check_smem(name: str, smem: int, dev, ck: int, n: int, p: int):
    limit = _smem_limit(dev.index)
    if smem > limit:
        raise ValueError(f"{name}: chunk {ck}, state {n} and head dim {p} "
                         f"need {smem} bytes of shared memory per CTA; this "
                         f"card allows {limit}")


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             initial_state: Optional[torch.Tensor] = None,
             return_states: bool = False):
    """x (b,l,h,p), dt (b,l,h), A (h,), B/C (b,l,n), initial_state
    (b,h,p,n) or None for zeros; one dtype (float32 or bf16) for all.

    Returns (y (b,l,h,p), final_state (b,h,p,n)) in x's dtype, with
    ``ssd_pallas``'s chunking: ``ck = min(chunk, l)`` and ``l % ck == 0``;
    with ``return_states`` also what the backward reads of the forward's
    scratch: cs, the chunks' cumulative sums of dt A (float32 (b,h,l)), and
    prev, the state entering each chunk ((b,l/ck,h,p,n) in x's dtype).
    Raises on anything the kernel does not take, and where an input
    requires grad (``ops.ssd`` differentiates through ``SSDScan``); never
    computes on another path.
    """
    tensors = [x, dt, A, B, C] + ([] if initial_state is None
                                  else [initial_state])
    more = [] if initial_state is None \
        else [("initial_state", initial_state, "state")]
    dev, (b, l, h, p, n), ck = _check("ssd", tensors, chunk, more)
    _build.refuse_autograd(
        "ssd", "call kernels/ops.py::ssd, which differentiates through "
        "SSDScan (the forward and backward kernels)", *tensors)
    lib = _lib()
    code_t = _build.DTYPE_CODES[x.dtype]
    _check_smem("ssd", lib.ssd_scan_smem_bytes(ck, n, p, code_t), dev, ck,
                n, p)
    y = torch.empty_like(x)
    fin = torch.empty((b, h, p, n), dtype=x.dtype, device=dev)
    cs = torch.empty((b, h, l), dtype=torch.float32, device=dev)
    states = torch.empty((b, l // ck, h, p, n), dtype=torch.float32,
                         device=dev)
    prev = torch.empty((b, l // ck, h, p, n), dtype=x.dtype, device=dev)
    code = lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), fin.data_ptr(), cs.data_ptr(), states.data_ptr(),
        prev.data_ptr(),
        b, l, h, p, n, ck, code_t,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, "ssd_scan", code)
    ssd_cuda.launches += 1
    if return_states:
        return y, fin, cs, prev
    return y, fin


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How the backward's two chunk kernels share out a (row, chunk)'s
    heads. CTA x of a (row, chunk), x < clusters * cluster, is rank
    x % cluster of cluster x // cluster and loops over heads
    [x group, x group + group) (fewer in the last, none past h). A cluster
    sums dB and dC over its ranks in rank order; with more than one
    cluster, the last kernel sums their float32 partials in cluster
    order."""
    group: int        # heads a CTA
    cluster: int      # CTAs a cluster
    clusters: int     # clusters a (row, chunk): the dB/dC partials left
    ctas: int         # CTAs of a chunk kernel's grid

    @classmethod
    def of(cls, pairs: int, h: int, group: int,
           cluster: int) -> "BackwardPlan":
        """The plan of ``group`` heads a CTA in clusters of ``cluster``
        for ``pairs`` (row, chunk) pairs of ``h`` heads."""
        groups = -(-h // group)
        clusters = -(-groups // cluster)
        return cls(group, cluster, clusters, pairs * clusters * cluster)

    def heads(self, x: int, h: int) -> range:
        """The heads CTA x of a (row, chunk) loops over, in order."""
        return range(min(x * self.group, h), min(x * self.group + self.group,
                                                 h))

    def sum_order(self):
        """(cluster, rank, CTA) in the order the sums of dB and dC run: the
        ranks of a cluster in order, then the clusters in order."""
        return [(k, r, k * self.cluster + r) for k in range(self.clusters)
                for r in range(self.cluster)]


def backward_plan(b: int, l: int, h: int, ck: int,
                  capacity: dict) -> BackwardPlan:
    """The partition of the backward's chunk kernels at these shapes.
    ``capacity`` maps a cluster size (1 to ``MAX_CLUSTER``) to the CTAs the
    card runs at once in clusters of that size (one CTA an SM: the kernels
    hold ~227 KB of shared memory; on the H100 clusters of 4 or 8 reach
    only 120 of its 132 SMs). Of every head group g up to ``MAX_GROUP``
    and cluster size, the plan takes the one whose waves of CTAs, each
    taking ``FIXED_HEADS`` + g heads' time, end first; then the fewest
    clusters a (row, chunk) (partials left), the fewest CTAs without a
    head, the widest group. The groups of a (row, chunk) form clusters of
    equal size; the last CTAs hold no head where the sizes do not
    divide."""
    pairs = b * (l // ck)
    best = None
    for g in range(1, min(h, MAX_GROUP) + 1):
        groups = -(-h // g)
        for cluster in range(1, min(groups, MAX_CLUSTER) + 1):
            if capacity.get(cluster, 0) <= 0:
                continue
            plan = BackwardPlan.of(pairs, h, g, cluster)
            waves = -(-plan.ctas // capacity[cluster])
            key = (waves * (FIXED_HEADS + g), plan.clusters,
                   plan.clusters * cluster - groups, -g)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is None:
        raise ValueError(f"ssd_backward: no cluster size fits the card "
                         f"(capacity {capacity})")
    return best[1]


def backward_scratch(b: int, l: int, h: int, p: int, n: int, ck: int,
                     dots: int, clusters: int) -> dict:
    """The float32 scratch of one backward call, name -> shape, in the
    order the C entry point takes it: dS (each chunk's dprev, then its
    state gradient), dxd (x dt's gradient, the diagonal share first), d cs,
    the reverse state passing's per-CTA partials of <dS_c, prev_c>
    (``dots`` a (row, head, chunk): the kernel's
    ``ssd_scan_backward_dot_partials``), dA's per (row, chunk) partials,
    dB's diagonal share a cluster (then its cluster partial), and, with
    more than one cluster a (row, chunk), dC's cluster partials. The
    partials are summed in a fixed order."""
    nc = l // ck
    plan = {"ds": (b, nc, h, p, n), "dxd": (b, l, h, p), "dcs": (b, h, l),
            "dot": (b, h, nc, dots), "dap": (b, nc, h),
            "dbd": (b, l, clusters, n)}
    if clusters > 1:
        plan["dcp"] = (b, l, clusters, n)
    return plan


SCRATCH = ("ds", "dxd", "dcs", "dot", "dap", "dbd", "dcp")


def forward_work(b: int, l: int, h: int, p: int, n: int, ck: int, es: int,
                 *, initial_state: bool = False,
                 states: bool = False) -> Tuple[int, int]:
    """(bytes, flops) that the forward function itself needs at these
    shapes, element size ``es``: every input read once and both outputs
    written once (with ``states`` also what the backward reads of the
    forward: cs in float32 and prev in the input type); the chunked
    algorithm's flops with C B^T formed once per (row, chunk) (B and C
    are shared by the heads) and only the lower triangles of C B^T and of
    its product with x dt."""
    nc = l // ck
    tri = ck * (ck + 1) // 2
    nbytes = es * (2 * b * l * h * p + b * l * h + h + 2 * b * l * n
                   + b * h * p * n * (2 if initial_state else 1))
    if states:
        nbytes += 4 * b * h * l + es * b * nc * h * p * n
    per_head = (2 * tri                  # L = exp(segsum), G = CB o L
                + 2 * tri * p            # G (x dt)
                + 2 * ck * p * n         # C S^T
                + 2 * ck * p * n         # (x dt decay)^T B
                + 2 * p * n              # S exp(cs_last) + ...
                + 3 * ck * p + 2 * ck)   # x dt, decay weights, scan
    return nbytes, nc * b * (2 * tri * n + h * per_head)


def backward_work(b: int, l: int, h: int, p: int, n: int, ck: int, es: int,
                  *, dfinal: bool = False) -> Tuple[int, int]:
    """(bytes, flops) that the backward function itself needs at these
    shapes, element size ``es``: the bound's work. Bytes: every input read
    once (x, dt, A, B, C, dy, dfinal where given, and the forward's float32
    cs and prev in the input type) and every gradient written once; the
    kernel's own scratch is not counted (``backward_partials_bytes``).
    Flops: per (row, head, chunk) dprev, dC's off-diagonal share, dS B and
    xd^T dS (ck p n each) and the lower triangles (ck (ck + 1) / 2 pairs)
    of dy xd^T and P^T dy (p each); per (row, chunk) the triangles of C B^T,
    M B and M^T C (n each), once for all heads: B and C are one group, so
    sum_h M_h^T C = (sum_h M_h)^T C and sum_h M_h B = (sum_h M_h) B; two
    flops a multiply-add."""
    nc = l // ck
    tri = ck * (ck + 1) // 2
    per_head = 4 * ck * p * n + tri * 2 * p
    flops = 2 * b * nc * (h * per_head + 3 * tri * n)
    xs, ss = b * l * h * p, b * h * p * n
    inputs = es * (2 * xs + b * l * h + h + 2 * b * l * n
                   + (ss if dfinal else 0) + b * nc * h * p * n) \
        + 4 * b * h * l
    grads = es * (xs + b * l * h + h + 2 * b * l * n + ss)
    return inputs + grads, flops


def backward_partials_bytes(b: int, l: int, n: int, clusters: int) -> int:
    """The bytes of dB and dC that the kernel's design adds to the
    function's own, float32: dB's diagonal share a cluster, written by the
    first chunk kernel and read by the second; with more than one cluster
    a (row, chunk), also dC's cluster partials (written, read by the sum
    kernel) and dB's (the share read and written back, then read).
    Reported beside the bound, not in it."""
    part = 4 * b * l * clusters * n
    return 2 * part if clusters == 1 else 6 * part


@functools.cache
def _capacity(index: int, ck: int, n: int, p: int, code: int) -> dict:
    """Cluster size -> the CTAs of the backward's chunk kernels that card
    ``index`` runs at once (the occupancy API, through the library)."""
    lib = _bwd_lib()
    out = {}
    with torch.cuda.device(index):
        for cluster in range(1, MAX_CLUSTER + 1):
            got = lib.ssd_scan_backward_max_ctas(cluster, ck, n, p, code)
            if got < 0:
                _build.check_launch(lib, "ssd_scan_backward", -got)
            out[cluster] = got
    return out


@functools.lru_cache(maxsize=256)
def _plan_of(index: int, b: int, l: int, h: int, ck: int, n: int, p: int,
             code: int) -> BackwardPlan:
    """``backward_plan`` on card ``index``'s capacity, once a shape."""
    return backward_plan(b, l, h, ck, _capacity(index, ck, n, p, code))


def ssd_backward_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                      cs: torch.Tensor, prev: torch.Tensor,
                      dfinal: Optional[torch.Tensor] = None, *,
                      chunk: int = 128):
    """The scan's gradient on the card: the forward's inputs, the
    cotangents dy (b,l,h,p) and dfinal (b,h,p,n) or None for zeros, and
    the forward's cs and prev (``ssd_cuda(..., return_states=True)``) ->
    (dx, ddt, dA, dB, dC, dinitial) in x's dtype. Four CUDA kernels, one
    count, split as ``backward_plan`` says; no atomics, so two calls are
    bitwise equal. Raises on anything the kernel does not take; never
    computes on another path."""
    return backward_with_plan(x, dt, A, B, C, dy, cs, prev, dfinal,
                              chunk=chunk, plan=None)


def backward_with_plan(x, dt, A, B, C, dy, cs, prev, dfinal=None, *,
                       chunk: int = 128,
                       plan: Optional[BackwardPlan] = None):
    """``ssd_backward_cuda`` with its partition given (None: the
    ``backward_plan`` of these shapes on this card), for timing partitions
    against each other."""
    tensors = [x, dt, A, B, C, dy, prev] + ([] if dfinal is None
                                            else [dfinal])
    more = [("dy", dy, "x")] + ([] if dfinal is None
                                else [("dfinal", dfinal, "state")])
    dev, (b, l, h, p, n), ck = _check("ssd_backward", tensors, chunk, more)
    nc = l // ck
    if cs.dtype != torch.float32 or tuple(cs.shape) != (b, h, l) \
            or cs.device != dev or not cs.is_contiguous():
        raise ValueError(f"ssd_backward: cs must be the forward's float32 "
                         f"(b,h,l) = {(b, h, l)}, got {cs.dtype} "
                         f"{tuple(cs.shape)}")
    if tuple(prev.shape) != (b, nc, h, p, n):
        raise ValueError(f"ssd_backward: prev has shape {tuple(prev.shape)},"
                         f" want {(b, nc, h, p, n)}")
    lib = _bwd_lib()
    code_t = _build.DTYPE_CODES[x.dtype]
    if plan is None:
        plan = _plan_of(dev.index, b, l, h, ck, n, p, code_t)
    _check_smem("ssd_backward", lib.ssd_scan_backward_smem_bytes(
        ck, n, p, plan.group, code_t), dev, ck, n, p)
    dots = lib.ssd_scan_backward_dot_partials(p, n)
    scratch = {name: torch.empty(shape, dtype=torch.float32, device=dev)
               for name, shape in backward_scratch(
                   b, l, h, p, n, ck, dots, plan.clusters).items()}
    dx, ddt, dA = torch.empty_like(x), torch.empty_like(dt), \
        torch.empty_like(A)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dinit = torch.empty((b, h, p, n), dtype=x.dtype, device=dev)
    code = lib.ssd_scan_backward(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), dy.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(), cs.data_ptr(),
        prev.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), dinit.data_ptr(),
        *(scratch[k].data_ptr() if k in scratch else None for k in SCRATCH),
        b, l, h, p, n, ck, plan.group, plan.cluster, plan.clusters, code_t,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, "ssd_scan_backward", code)
    ssd_backward_cuda.launches += 1
    return dx, ddt, dA, dB, dC, dinit


class SSDScan(torch.autograd.Function):
    """The scan differentiable on the card: the forward kernel (keeping its
    cs and prev for the backward), the backward kernel for the gradient of
    x, dt, A, B, C and the initial state. An unused output's cotangent is
    taken as zeros (the loss drops the final state). Only the CUDA kernels
    run; ``kernels/ops.py`` takes the plain version under ordinary autograd
    for CPU tensors."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state, chunk: int):
        y, fin, cs, prev = ssd_cuda(x, dt, A, B, C, chunk=chunk,
                                    initial_state=initial_state,
                                    return_states=True)
        ctx.save_for_backward(x, dt, A, B, C, cs, prev)
        ctx.chunk, ctx.has_init = chunk, initial_state is not None
        ctx.set_materialize_grads(False)
        return y, fin

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, cs, prev = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dfinal = None if dfinal is None else dfinal.contiguous()
        dx, ddt, dA, dB, dC, dinit = ssd_backward_cuda(
            x, dt, A, B, C, dy, cs, prev, dfinal, chunk=ctx.chunk)
        return (dx, ddt, dA, dB, dC, dinit if ctx.has_init else None, None)


ssd_cuda.launches = 0
ssd_backward_cuda.launches = 0
