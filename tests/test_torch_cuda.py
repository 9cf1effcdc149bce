"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU (the kernels have no CPU mode, so every test here is marked
``cuda`` and skips without a card). Run on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX (the machine with the card has none). Shapes
include the serving path's (d_head 256, G = 4, a 2048-slot cache) and the
edges the kernels mask themselves: ragged S and T, right-aligned queries,
a head dimension that is no power of two, per-row ranges, a length past
the cache. Tolerances are those of ``tests/test_kernels.py::_tol``: 2e-5
in float32 (same sums, other order), 5e-2 in bf16 (inputs and outputs
rounded to bf16); the SSD scan's are ``test_ssd_sweep``'s (1e-4/1e-3 in
float32, 1e-1 in bf16).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.regression import BatchedFitPlan
from repro_torch.core.solver import ServiceSpec, SolverProblem
from repro_torch.env import paper_profiles
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 kv_splits)
from repro_torch.kernels.rask_objective import (
    rask_objective_backward_cuda, rask_objective_forward_cuda)
from repro_torch.kernels.ssd_scan import ssd_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == torch.bfloat16 \
        else dict(atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,S,T,D,causal,window", [
    (1, 4, 1, 300, 300, 256, True, 512),   # ragged, window wider than S
    (2, 4, 2, 100, 100, 64, True, 16),
    (1, 8, 8, 64, 64, 16, False, 0),
    (1, 4, 1, 40, 97, 32, True, 24),       # right-aligned, ragged T
    (1, 2, 1, 129, 129, 200, False, 33),   # D not a power of two
    (1, 4, 1, 1024, 1024, 256, True, 512),  # the serving path: local layer
    (1, 4, 1, 1024, 1024, 256, True, 0),   # global layer
    (1, 4, 1, 128, 128, 256, True, 512),   # the shortest bucket
    (1, 8, 1, 200, 200, 64, True, 0),      # G = 8: 8 heads a CTA
    (2, 2, 1, 17, 17, 64, True, 8),        # S < 64, two batch rows
    (1, 2, 1, 700, 900, 64, False, 0),     # kv range split 3 ways, ragged
])
def test_flash_kernel_matches_plain(cuda_device, dtype, B, H, KH, S, T, D,
                                    causal, window):
    g = torch.Generator(cuda_device).manual_seed(S + T + D)
    q = torch.randn((B, H, S, D), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((B, KH, T, D), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((B, KH, T, D), generator=g, device=cuda_device).to(dtype)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_reference(q, k, v, causal=causal,
                                         window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def _kernels_a_call(fn, calls=3):
    """CUDA kernels one call of ``fn`` launches, from the launch API calls
    ``torch.profiler`` records (as chip_smoke.py counts them)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages() if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
        "cudaLaunchKernelExC"))
    return launches / calls


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KH,S,T,D,window,causal,must_split", [
    (1, 4, 1, 128, 128, 256, 512, True, False),   # gemma3-1b's buckets,
    (1, 4, 1, 128, 128, 256, 0, True, False),     # local and global
    (1, 4, 1, 512, 512, 256, 512, True, False),
    (1, 4, 1, 512, 512, 256, 0, True, False),
    (1, 4, 1, 1024, 1024, 256, 512, True, False),
    (1, 4, 1, 1024, 1024, 256, 0, True, False),
    (1, 4, 1, 300, 700, 128, 0, True, False),     # T > S, right-aligned
    (1, 8, 1, 200, 200, 64, 0, True, False),      # G = 8
    (2, 2, 1, 17, 17, 64, 8, True, False),        # ragged S = 17
    (1, 2, 1, 700, 900, 64, 0, False, True),      # kv range split 4 ways
])
def test_flash_fp32_kernel_matches_plain(cuda_device, B, H, KH, S, T, D,
                                         window, causal, must_split):
    """The float32 (split-TF32) kernel at 2e-5 of its plain version, and
    the CUDA kernels a call: one, or, where the kv range is split, the
    split kernel and its merge."""
    g = torch.Generator(cuda_device).manual_seed(S + T + D + window)
    q = torch.randn((B, H, S, D), generator=g, device=cuda_device)
    k = torch.randn((B, KH, T, D), generator=g, device=cuda_device)
    v = torch.randn((B, KH, T, D), generator=g, device=cuda_device)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_reference(q, k, v, causal=causal,
                                         window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **_tol(torch.float32))
    splits = kv_splits(q, k, causal=causal, window=window)
    assert splits > 1 or not must_split
    assert _kernels_a_call(lambda: flash_attention_cuda(
        q, k, v, causal=causal, window=window)) == (2 if splits > 1 else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "wgmma"),
                                           (torch.float32, "tf32x3")])
def test_flash_dtype_picks_the_kernel(cuda_device, dtype, variant):
    """bf16 runs the wgmma kernel, float32 the split-TF32 kernel; each call
    counts one launch in the total and one in its variant."""
    q = torch.randn((1, 4, 64, 64), device=cuda_device).to(dtype)
    k = torch.randn((1, 1, 64, 64), device=cuda_device).to(dtype)
    total = flash_attention_cuda.launches
    by_variant = dict(flash_attention_cuda.variant_launches)
    flash_attention_cuda(q, k, k, causal=True)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == total + 1
    by_variant[variant] += 1
    assert flash_attention_cuda.variant_launches == by_variant


@pytest.mark.cuda
def test_flash_bf16_refuses_rows_tma_cannot_load(cuda_device):
    """TMA needs 16-byte rows: the bf16 kernel refuses D % 8 != 0 and
    counts no launch; float32 takes such a D."""
    q = torch.randn((1, 2, 32, 12), device=cuda_device)
    total = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="D % 8"):
        flash_attention_cuda(q.bfloat16(), q[:, :1].bfloat16(),
                             q[:, :1].bfloat16())
    assert flash_attention_cuda.launches == total
    got = flash_attention_cuda(q, q[:, :1].contiguous(),
                               q[:, :1].contiguous())
    want = ref.flash_attention_reference(q, q[:, :1], q[:, :1])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **_tol(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KH,S,D", [(4, 1, 2048, 256), (16, 2, 100, 64),
                                      (8, 8, 64, 16),
                                      # D % 16 != 0: bf16 on the CUDA
                                      # cores; 37: rows copied by plain
                                      # loads (not 16-byte multiples)
                                      (4, 1, 300, 40), (12, 2, 130, 37)])
def test_decode_kernel_matches_plain(cuda_device, dtype, H, KH, S, D):
    B = 4
    g = torch.Generator(cuda_device).manual_seed(S + D)
    q = torch.randn((B, H, D), generator=g, device=cuda_device).to(dtype)
    kc = torch.randn((B, S, KH, D), generator=g, device=cuda_device).to(dtype)
    vc = torch.randn((B, S, KH, D), generator=g, device=cuda_device).to(dtype)
    length = torch.tensor([1, S // 3, S, S + 5], dtype=torch.int32,
                          device=cuda_device)
    start = torch.tensor([0, max(S // 3 - 40, 0), S // 2, 0],
                         dtype=torch.int32, device=cuda_device)
    got = decode_attention_cuda(q, kc, vc, length, start)
    want = ref.decode_attention_reference(q, kc, vc, length, start)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,H,KH,S,D,lengths,starts", [
    # a full cache: every CTA of the cluster streams 256 slots, more than
    # one pass of its ring (3 stages of 32 in float32)
    (torch.float32, 2, 4, 1, 2048, 256, [2048, 1500], [0, 0]),
    # rows shorter than one CTA's share (5 and 17 slots: some CTAs of the
    # cluster get none) starting mid-cache, two kv heads of 4 query heads
    (torch.float32, 3, 8, 2, 1100, 128, [300, 1029, 517], [0, 1024, 500]),
    (torch.bfloat16, 3, 8, 2, 1100, 128, [300, 1029, 517], [0, 1024, 500]),
])
def test_decode_kernel_ranges(cuda_device, dtype, B, H, KH, S, D, lengths,
                              starts):
    g = torch.Generator(cuda_device).manual_seed(B * S + D)
    q = torch.randn((B, H, D), generator=g, device=cuda_device).to(dtype)
    kc = torch.randn((B, S, KH, D), generator=g, device=cuda_device).to(dtype)
    vc = torch.randn((B, S, KH, D), generator=g, device=cuda_device).to(dtype)
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    start = torch.tensor(starts, dtype=torch.int32, device=cuda_device)
    launches = decode_attention_cuda.launches
    got = decode_attention_cuda(q, kc, vc, length, start)
    want = ref.decode_attention_reference(q, kc, vc, length, start)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == launches + 1
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_is_deterministic(cuda_device, dtype):
    """The cluster combines its partials in rank order, without atomics:
    two calls on the same inputs give the same bits."""
    g = torch.Generator(cuda_device).manual_seed(7)
    q = torch.randn((4, 4, 256), generator=g, device=cuda_device).to(dtype)
    kc = torch.randn((4, 2048, 1, 256), generator=g,
                     device=cuda_device).to(dtype)
    vc = torch.randn_like(kc)
    length = torch.tensor([108, 308, 708, 2048], dtype=torch.int32,
                          device=cuda_device)
    start = torch.tensor([0, 0, 196, 1536], dtype=torch.int32,
                         device=cuda_device)
    a = decode_attention_cuda(q, kc, vc, length, start)
    b = decode_attention_cuda(q, kc, vc, length, start)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _objective_case(replicas, K, seed, dev):
    """The paper's QR/CV/PC layout with ``replicas`` containers of each,
    ridge fits of degrees 1-3 on random data, K projected random candidates
    and random loads; exactly one candidate row sits on ratio == 1 of a
    parameter SLO (the half-subgradient). Returns the objective's
    arguments and sizes."""
    return _objective_setup(replicas, K, seed, dev)[:2]


def _objective_setup(replicas, K, seed, dev):
    """``_objective_case``, with the problem and the stacked models."""
    rng = np.random.default_rng(seed)
    specs = []
    for r in range(replicas):
        for p in paper_profiles().values():
            names = tuple(p.api.names)
            specs.append(ServiceSpec(
                name=f"{p.type}/c{r}", param_names=names,
                lower=tuple(x.min_value for x in p.api.parameters),
                upper=tuple(x.max_value for x in p.api.parameters),
                resource_mask=tuple(x.is_resource for x in p.api.parameters),
                slos=tuple(p.slos),
                relation_features=tuple(
                    (t, tuple(names.index(f) for f in fs))
                    for t, fs in p.knowledge.items())))
    problem = SolverProblem(specs, device=dev)
    rels, data = [], []
    for i, s in enumerate(specs):
        for target, feat in s.relation_features:
            hi = np.asarray([s.upper[j] for j in feat], np.float32)
            X = rng.uniform(0.1, 1.0, (40, len(feat))).astype(np.float32) * hi
            Y = (X @ rng.uniform(1, 20, len(feat))).astype(np.float32)
            rels.append(dict(n_features=len(feat), degree=1 + i % 3,
                             x_scale=hi))
            data.append((X, Y))
    sm = BatchedFitPlan(rels, row_capacity=64, device=dev).fit(data)
    A = np.stack([problem.random_assignment(rng, 8.0 * replicas)
                  for _ in range(K)])
    A[0, 1] = specs[0].slos[0].target         # QR quality at its target
    rps = rng.uniform(1, 100, len(specs)).astype(np.float32)
    t = problem.tables
    args = (torch.from_numpy(A).to(dev), t.rel_gather, sm.w, sm.exponents,
            sm.term_mask, sm.x_scale, t.slo_kind, t.slo_service,
            t.slo_weight, t.slo_target, t.slo_pidx, t.slo_ridx,
            torch.from_numpy(rps).to(dev))
    return args, dict(n_services=len(specs), max_degree=sm.max_degree), \
        problem, sm


@pytest.mark.cuda
@pytest.mark.parametrize("replicas", [1, 3, 9])
@pytest.mark.parametrize("K", [6, 7])
def test_rask_objective_kernels_match_plain(cuda_device, replicas, K):
    """Forward and backward kernels against their plain versions at the
    |S| = 3/9/27 layouts, K = 6 starts and an odd K: 1e-5 (float32, the
    same arithmetic; sums in another order)."""
    args, kw = _objective_case(replicas, K, replicas * 10 + K, cuda_device)
    A = args[0]
    ct = torch.randn((K, kw["n_services"]), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(K))
    n_fwd = rask_objective_forward_cuda.launches
    n_bwd = rask_objective_backward_cuda.launches
    got = rask_objective_forward_cuda(*args, n_services=kw["n_services"])
    gdA = rask_objective_backward_cuda(A, ct, *args[1:],
                                       n_services=kw["n_services"])
    want = ref.rask_objective_reference(*args, **kw)
    wdA = ref.rask_objective_grad(A, ct, *args[1:], **kw)
    torch.cuda.synchronize()
    assert rask_objective_forward_cuda.launches == n_fwd + 1
    assert rask_objective_backward_cuda.launches == n_bwd + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gdA, wdA, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_rask_objective_autograd_goes_through_both_kernels(cuda_device):
    from repro_torch.kernels import ops
    args, kw = _objective_case(1, 6, 5, cuda_device)
    A = args[0].clone().requires_grad_(True)
    n_fwd = rask_objective_forward_cuda.launches
    n_bwd = rask_objective_backward_cuda.launches
    seg = ops.rask_objective(A, *args[1:], **kw)
    g, = torch.autograd.grad(seg.sum(), A)
    torch.cuda.synchronize()
    assert rask_objective_forward_cuda.launches == n_fwd + 1
    assert rask_objective_backward_cuda.launches == n_bwd + 1
    want = ref.rask_objective_grad(args[0], torch.ones_like(seg), *args[1:],
                                   **kw)
    torch.testing.assert_close(g, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("replicas", [1, 3, 9])
def test_rask_objective_forward_is_deterministic(cuda_device, replicas):
    """Lane-group sums in a fixed order, no atomics: the forward repeats
    bit for bit."""
    args, kw = _objective_case(replicas, 7, 50 + replicas, cuda_device)
    a = rask_objective_forward_cuda(*args, n_services=kw["n_services"])
    b = rask_objective_forward_cuda(*args, n_services=kw["n_services"])
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_pgd_solve_on_the_card_launches_the_forward_once(cuda_device):
    """Each ascent step takes the backward kernel alone; the forward kernel
    runs once a solve, to score the finals."""
    from repro_torch.core.solver import pgd_solve
    args, kw, problem, sm = _objective_setup(3, 6, 61, cuda_device)
    t = problem.tables
    x0 = args[0][0]
    u = torch.rand((3, x0.shape[0]), device=cuda_device,
                   generator=torch.Generator(cuda_device).manual_seed(6))
    n_fwd = rask_objective_forward_cuda.launches
    n_bwd = rask_objective_backward_cuda.launches
    a, score = pgd_solve(x0, u, t, sm, args[-1], 24.0, n_starts=6,
                         iters=32, lr=0.18, n_services=kw["n_services"])
    torch.cuda.synchronize()
    assert rask_objective_forward_cuda.launches == n_fwd + 1
    assert rask_objective_backward_cuda.launches == n_bwd + 32
    assert torch.isfinite(score) and torch.isfinite(a).all()


@pytest.mark.cuda
def test_rask_objective_backward_is_deterministic(cuda_device):
    """Fixed-order sums, no atomics: a decide is reproducible bit for bit."""
    args, kw = _objective_case(3, 6, 31, cuda_device)
    ct = torch.randn((6, kw["n_services"]), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(3))
    a = rask_objective_backward_cuda(args[0], ct, *args[1:],
                                     n_services=kw["n_services"])
    b = rask_objective_backward_cuda(args[0], ct, *args[1:],
                                     n_services=kw["n_services"])
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _wide_case(dev, K=5, D=12, R=4, F=8, T=9, seed=0):
    """A synthetic table at the kernel's most features a relation (8), with
    indices repeated inside a relation and across relations, padded terms
    and every SLO kind; values near 1 keep the degree-2 products of 8
    features in range."""
    rng = np.random.default_rng(seed)
    rel = rng.integers(0, D, (R, F)).astype(np.int32)
    rel[0, :3] = [1, 1, 0]                       # repeats in one relation
    rel[1, :2] = [1, 0]
    E = rng.integers(0, 3, (R, T, F)).astype(np.int32)
    E[:, 0] = 0                                  # the constant term
    tm = (rng.random((R, T)) < 0.8).astype(np.float32)
    tm[:, 0] = 1.0
    w = (rng.standard_normal((R, T)) * tm).astype(np.float32)
    xs = rng.uniform(0.5, 2.0, (R, F)).astype(np.float32)
    S = 3
    kind = np.array([0, 1, 2, 0, 1, 2, 0], np.int32)
    Q = kind.size
    svc = np.array([0, 0, 1, 1, 2, 2, 2], np.int32)
    pidx = rng.integers(0, D, Q).astype(np.int32)
    ridx = rng.integers(0, R, Q).astype(np.int32)
    weight = rng.uniform(0.2, 1.0, Q).astype(np.float32)
    target = rng.uniform(0.5, 3.0, Q).astype(np.float32)
    rps = rng.uniform(0.5, 2.0, S).astype(np.float32)
    A = rng.uniform(0.5, 1.5, (K, D)).astype(np.float32)
    args = tuple(torch.from_numpy(x).to(dev) for x in (
        A, rel, w, E, tm, xs, kind, svc, weight, target, pidx, ridx, rps))
    return args, dict(n_services=S, max_degree=2)


@pytest.mark.cuda
def test_rask_objective_kernels_take_eight_features(cuda_device):
    args, kw = _wide_case(cuda_device)
    ct = torch.randn((args[0].shape[0], kw["n_services"]),
                     device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(1))
    got = rask_objective_forward_cuda(*args, n_services=kw["n_services"])
    gdA = rask_objective_backward_cuda(args[0], ct, *args[1:],
                                       n_services=kw["n_services"])
    want = ref.rask_objective_reference(*args, **kw)
    wdA = ref.rask_objective_grad(args[0], ct, *args[1:], **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gdA, wdA, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["slo_pidx", "rel_gather"])
def test_rask_objective_index_outside_its_table_gives_nan(cuda_device,
                                                          table):
    """An index outside its table reads NaN, and the NaN reaches exactly the
    outputs that index feeds. The plain version, which cannot read past a
    table, gets the same inputs with a NaN column appended to A and the
    index pointed at it. A parameter SLO whose index is out of range makes
    its service's fulfilment NaN; its cotangent is 0 (the subgradient of
    min at a NaN ratio, as repro's jnp.where gives), so the backward stays
    finite. A relation feature out of range makes NaN in the gradient of
    every index its relation's other features gather."""
    args, kw = _objective_case(1, 6, 41, cuda_device)
    A = args[0]
    D = A.shape[1]
    bad = [t.clone() for t in args]
    pos = {"slo_pidx": 10, "rel_gather": 1}[table]
    if table == "slo_pidx":
        q = int(torch.nonzero(args[6] == 0)[0])   # a parameter SLO
        bad[pos][q] = D
    else:
        bad[pos][1, 0] = D                        # relation 1, feature 0
    ct = torch.randn((A.shape[0], kw["n_services"]), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(2))
    got = rask_objective_forward_cuda(*bad, n_services=kw["n_services"])
    gdA = rask_objective_backward_cuda(A, ct, *bad[1:],
                                       n_services=kw["n_services"])
    A_nan = torch.cat([A, torch.full_like(A[:, :1], float("nan"))], dim=1)
    want = ref.rask_objective_reference(A_nan, *bad[1:], **kw)
    wdA = ref.rask_objective_grad(A_nan, ct, *bad[1:], **kw)[:, :D]
    torch.cuda.synchronize()
    if table == "slo_pidx":
        svc = int(args[7][q])
        assert torch.isnan(want[:, svc]).all()
        assert not torch.isnan(want[:, [s for s in range(want.shape[1])
                                        if s != svc]]).any()
        assert torch.isfinite(wdA).all()
    else:
        assert torch.isnan(wdA).any() and not torch.isnan(wdA).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isnan(gdA), torch.isnan(wdA))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5,
                               equal_nan=True)
    torch.testing.assert_close(gdA, wdA, atol=1e-5, rtol=1e-5,
                               equal_nan=True)


@pytest.mark.cuda
def test_rask_objective_kernel_refuses_bad_input(cuda_device):
    args, kw = _objective_case(1, 6, 6, cuda_device)
    with pytest.raises(ValueError, match="int32"):
        rask_objective_forward_cuda(args[0], args[1].long(), *args[2:],
                                    n_services=kw["n_services"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        rask_objective_forward_cuda(args[0].cpu(), *args[1:],
                                    n_services=kw["n_services"])


def _ssd_inputs(dev, dtype, b, l, h, p, n, with_state, seed):
    """test_ssd_sweep's distributions: x, B, C ~ N(0, 0.25), dt =
    softplus(N(0, 1)), A = -exp(0.3 N(0, 1))."""
    g = torch.Generator(dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    x = randn(b, l, h, p) * 0.5
    dt = torch.nn.functional.softplus(randn(b, l, h))
    A = -torch.exp(randn(h) * 0.3)
    B, C = randn(b, l, n) * 0.5, randn(b, l, n) * 0.5
    init = randn(b, h, p, n) * 0.5 if with_state else None
    out = [t.to(dtype) for t in (x, dt, A, B, C)]
    return out, None if init is None else init.to(dtype)


def _ssd_tol(dtype):
    return dict(atol=1e-1, rtol=1e-1) if dtype == torch.bfloat16 \
        else dict(atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,p,n,chunk,with_state", [
    (1, 64, 2, 16, 8, 16, False),
    (2, 128, 4, 32, 16, 32, True),
    (1, 256, 8, 64, 128, 128, False),     # production-like head
    (1, 384, 32, 64, 128, 128, False),    # mamba2-370m: three chunks
    (2, 256, 32, 64, 128, 128, True),
    (1, 20, 2, 24, 16, 128, True),        # ck = l = 20: ragged chunk and P
    (1, 1024, 32, 64, 128, 128, False),   # mamba2-370m: the longest prompt
    (2, 768, 32, 64, 128, 128, True),     # six chunks, two rows, a state
])
def test_ssd_kernel_matches_plain(cuda_device, dtype, b, l, h, p, n, chunk,
                                  with_state):
    args, init = _ssd_inputs(cuda_device, dtype, b, l, h, p, n, with_state,
                             seed=l + n)
    launches = ssd_cuda.launches
    y, fin = ssd_cuda(*args, chunk=chunk, initial_state=init)
    ck = min(chunk, l)
    want_y, want_fin = ref.ssd_reference(*args, chunk=ck,
                                         initial_state=init)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == launches + 1
    assert y.dtype == fin.dtype == dtype
    torch.testing.assert_close(y.float(), want_y.float(), **_ssd_tol(dtype))
    torch.testing.assert_close(fin.float(), want_fin.float(),
                               **_ssd_tol(dtype))


@pytest.mark.cuda
def test_ssd_kernel_refuses_bad_input(cuda_device):
    (x, dt, A, B, C), _ = _ssd_inputs(cuda_device, torch.float32, 1, 64, 2,
                                      16, 8, False, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C,
                 chunk=16)
    with pytest.raises(ValueError, match="dtype"):
        ssd_cuda(x, dt.bfloat16(), A, B, C, chunk=16)
    with pytest.raises(ValueError, match="shape"):
        ssd_cuda(x, dt, A, B[:, :32], C, chunk=16)
    with pytest.raises(ValueError, match="divisible"):
        ssd_cuda(x, dt, A, B, C, chunk=48)
    with pytest.raises(ValueError, match="at most"):      # state of 256
        ssd_cuda(x, dt, A, B.repeat(1, 1, 32), C.repeat(1, 1, 32), chunk=16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_cuda(x.cpu(), dt, A, B, C, chunk=16)


@pytest.mark.cuda
def test_smoke_mamba2_engine_goes_through_the_kernel(cuda_device):
    """A smoke-size mamba2 behind the engine on the card: one kernel launch
    per layer per admitted prompt, every request served in full."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.models import build
    from repro_torch.serve.engine import EngineConfig, Request, ServingEngine
    cfg = dataclasses.replace(get("mamba2-370m").smoke(), dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(cuda_device).manual_seed(0))
    engine = ServingEngine(model, params, EngineConfig(
        slots=3, max_seq=64, context=48, chips=4.0), device=cuda_device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=4) for i, n in enumerate([5, 17, 40, 33])]
    for r in reqs:
        engine.submit(r)
    launches = ssd_cuda.launches
    for _ in range(50):
        engine.step()
        if len(engine.completed) == len(reqs):
            break
    torch.cuda.synchronize()
    assert len(engine.completed) == len(reqs)
    assert all(len(r.generated) == 4 for r in engine.completed)
    assert ssd_cuda.launches - launches == cfg.n_layers * len(reqs)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [512, 0])
@pytest.mark.parametrize("S", [1, 5, 13, 17, 63])
def test_flash_bf16_at_exact_prompt_lengths(cuda_device, S, window):
    """The dict engine prefills gemma3-1b's prompts at their own length, not
    at a bucket: one prompt, 4 query heads on 1 kv head, d_head 256, S
    rows in a partial tile (TMA boxes past the rows are zero-filled)."""
    g = torch.Generator(cuda_device).manual_seed(S + window)
    q, k, v = (torch.randn((1, h, S, 256), generator=g, device=cuda_device)
               .to(torch.bfloat16) for h in (4, 1, 1))
    before = flash_attention_cuda.variant_launches["wgmma"]
    got = flash_attention_cuda(q, k, v, causal=True, window=window)
    want = ref.flash_attention_reference(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.variant_launches["wgmma"] == before + 1
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", [1, 7, 33, 64])
def test_decode_kernel_one_row(cuda_device, dtype, length):
    """The dict engine decodes one row: gemma3-1b's heads on a 64-slot
    cache, the cluster sized from a grid of one (row, kv head)."""
    from repro_torch.kernels.decode_attention import cluster_size
    assert cluster_size(1, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count) == 16
    g = torch.Generator(cuda_device).manual_seed(length)
    q = torch.randn((1, 4, 256), generator=g, device=cuda_device).to(dtype)
    kc = torch.randn((1, 64, 1, 256), generator=g,
                     device=cuda_device).to(dtype)
    vc = torch.randn((1, 64, 1, 256), generator=g,
                     device=cuda_device).to(dtype)
    length_t = torch.tensor([length], dtype=torch.int32, device=cuda_device)
    start = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = decode_attention_cuda(q, kc, vc, length_t, start)
    want = ref.decode_attention_reference(q, kc, vc, length_t, start)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.cuda
def test_served_loop_launches_follow_steps_and_admissions(cuda_device):
    """A 12 s fixed-allocation serving loop of one ``ServedLMService`` on
    gemma3-1b at full width cut to 2 layers (one local, one global), bf16:
    one decode launch a layer an engine step, one wgmma flash launch a
    layer an admitted prompt, every token in the vocab."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.core.platform import MUDAP
    from repro_torch.kernels.flash_attention import reset_launches
    from repro_torch.models import build
    from repro_torch.serve import (ServedLMService, run_serving_loop,
                                   served_lm_profile)
    base = dataclasses.replace(get("gemma3-1b"), n_layers=2,
                               local_global_period=2)
    prof = served_lm_profile()
    svc = ServedLMService(build, base, profile=prof, slots=4, max_seq=64,
                          seed=0, steps_per_chip_s=5.0, device=cuda_device)
    plat = MUDAP({"chips": 6.0})
    plat.register(svc.sid, prof.api, svc, list(prof.slos),
                  dict(prof.defaults))
    svc._engine()                          # weights drawn before the count
    decode_attention_cuda.launches = 0
    reset_launches()
    hist = run_serving_loop(plat, {str(svc.sid): lambda t: 3.0},
                            duration_s=12.0, cycle_s=10.0)
    torch.cuda.synchronize()
    eng = svc._engine()
    admitted = len(svc.ledger) + len(eng.active)
    assert hist and svc.ledger and eng.admissions == admitted
    assert decode_attention_cuda.launches == base.n_layers * eng.steps
    assert flash_attention_cuda.variant_launches == {
        "wgmma": base.n_layers * admitted, "tf32x3": 0}
    for r in svc.ledger + list(eng.active.values()):
        assert all(0 <= t < base.vocab for t in r.generated)
