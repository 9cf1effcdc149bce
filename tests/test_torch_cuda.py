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
    # qwen2-moe-a2.7b's prefill: 16 heads on 16 kv heads (G = 1), d_head
    # 128, its 128/512/1024 buckets
    (1, 16, 16, 128, 128, 128, True, 0),
    (1, 16, 16, 512, 512, 128, True, 0),
    (1, 16, 16, 1024, 1024, 128, True, 0),
    # whisper-large-v3: 20 heads on 20 kv heads, d_head 64: the encoder
    # (1,500 frames, not causal), the prompt's cross-attention (4 queries
    # over 1,500 frames) and its causal self-attention
    (1, 20, 20, 1500, 1500, 64, False, 0),
    (4, 20, 20, 4, 1500, 64, False, 0),
    (4, 20, 20, 4, 4, 64, True, 0),
    # jamba: 64 heads on 8 kv heads (G = 8), d_head 128, exact lengths
    (1, 64, 8, 300, 300, 128, True, 0),
    (1, 64, 8, 1000, 1000, 128, True, 0),
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
    (1, 16, 16, 512, 512, 128, 0, True, False),   # qwen2-moe: G = 1
    (1, 20, 20, 1500, 1500, 64, 0, False, False),  # whisper's encoder
    (1, 20, 20, 4, 1500, 64, 0, False, False),    # its cross-attention
    (1, 64, 8, 300, 300, 128, 0, True, False),    # jamba: G = 8
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
                                      (4, 1, 300, 40), (12, 2, 130, 37),
                                      # qwen2-moe-a2.7b: G = 1, D = 128
                                      (16, 16, 2048, 128),
                                      # whisper: self (448) and cross
                                      # (1,500 frames), G = 1, D = 64
                                      (20, 20, 448, 64), (20, 20, 1500, 64),
                                      # jamba: G = 8, D = 128
                                      (64, 8, 2048, 128)])
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
    # qwen2-moe-a2.7b's decode: 16 heads on 16 kv heads, the serving
    # phase's 4 rows of a 2048-slot cache
    (torch.bfloat16, 4, 16, 16, 2048, 128, [108, 308, 708, 1008],
     [0, 0, 0, 0]),
    (torch.float32, 4, 16, 16, 2048, 128, [108, 308, 708, 1008],
     [0, 0, 0, 0]),
    # whisper's cross-attention: every row over all 1,500 frames
    (torch.bfloat16, 4, 20, 20, 1500, 64, [1500] * 4, [0] * 4),
    # gemma3-1b's mixed cache: a full 512-slot ring, start 0
    (torch.bfloat16, 2, 4, 1, 512, 256, [512, 512], [0, 0]),
    # jamba's attention layer: the serving rows, G = 8
    (torch.bfloat16, 4, 64, 8, 2048, 128, [108, 308, 708, 1008],
     [0, 0, 0, 0]),
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


def _objective_setup(replicas, K, seed, dev, degree_of=None):
    """``_objective_case``, with the problem and the stacked models;
    ``degree_of(i)`` sets service i's degree (default 1 + i % 3)."""
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
            rels.append(dict(n_features=len(feat),
                             degree=(degree_of or (lambda j: 1 + j % 3))(i),
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


def _batched_case(dev, B, K, seed, D=12, R=5, T=10, F=3, Q=9, S=4):
    """B problem rows padded as a fleet's layout bucket pads its hosts
    (``core/solver.py::FleetBucket``): each row has its own real sizes;
    padded parameters are 0 (boxed to [0, 0]), padded relations keep a
    real relation's weights with term_mask 0 and gather slot 0, padded SLOs
    are kind 0 with weight 0, target 1 and every index 0. Returns the
    objective's arguments, its sizes, and each row's real (D, S)."""
    rng = np.random.default_rng(seed)
    A = np.zeros((B, K, D), np.float32)
    rel = np.zeros((B, R, F), np.int32)
    E = rng.integers(0, 3, (B, R, T, F)).astype(np.int32)
    tm = np.zeros((B, R, T), np.float32)
    w = rng.standard_normal((B, R, T)).astype(np.float32)
    xs = rng.uniform(0.5, 2.0, (B, R, F)).astype(np.float32)
    kind = np.zeros((B, Q), np.int32)
    svc = np.zeros((B, Q), np.int32)
    pidx = np.zeros((B, Q), np.int32)
    ridx = np.zeros((B, Q), np.int32)
    weight = np.zeros((B, Q), np.float32)
    target = np.ones((B, Q), np.float32)
    rps = rng.uniform(0.5, 2.0, (B, S)).astype(np.float32)
    real = []
    for b in range(B):
        d, r, q, s = (int(rng.integers(1, n + 1)) for n in (D, R, Q, S))
        A[b, :, :d] = rng.uniform(0.5, 1.5, (K, d))
        rel[b, :r] = rng.integers(0, d, (r, F))
        tm[b, :r] = rng.random((r, T)) < 0.8
        tm[b, :r, 0] = 1.0
        kind[b, :q] = rng.integers(0, 3, q)
        svc[b, :q] = rng.integers(0, s, q)
        pidx[b, :q] = rng.integers(0, d, q)
        ridx[b, :q] = rng.integers(0, r, q)
        weight[b, :q] = rng.uniform(0.2, 1.0, q)
        target[b, :q] = rng.uniform(0.5, 3.0, q)
        real.append((d, s))
    args = tuple(torch.from_numpy(x).to(dev) for x in (
        A, rel, w, E, tm, xs, kind, svc, weight, target, pidx, ridx, rps))
    return args, dict(n_services=S, max_degree=2), real


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 17])
@pytest.mark.parametrize("K", [1, 4, 6])
def test_batched_rask_kernels_match_plain_and_the_per_row_kernel(
        cuda_device, B, K):
    """Over B padded rows, each kernel is one launch and agrees with the
    batched plain version at 1e-5 (float32, sums in another order), with
    each row's un-batched launch bit for bit, and gives exactly 0 on the
    padded services and parameters."""
    args, kw, real = _batched_case(cuda_device, B, K, seed=100 * B + K)
    A, S = args[0], kw["n_services"]
    ct = torch.randn((B, K, S), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(K))
    n_fwd = rask_objective_forward_cuda.launches
    n_bwd = rask_objective_backward_cuda.launches
    got = rask_objective_forward_cuda(*args, n_services=S)
    gdA = rask_objective_backward_cuda(A, ct, *args[1:], n_services=S)
    assert rask_objective_forward_cuda.launches == n_fwd + 1
    assert rask_objective_backward_cuda.launches == n_bwd + 1
    want = ref.rask_objective_reference(*args, **kw)
    wdA = ref.rask_objective_grad(A, ct, *args[1:], **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gdA, wdA, atol=1e-5, rtol=1e-5)
    for b, (d, s) in enumerate(real):
        row = [t[b] for t in args]
        assert torch.equal(got[b], rask_objective_forward_cuda(
            *row, n_services=S))
        assert torch.equal(gdA[b], rask_objective_backward_cuda(
            row[0], ct[b], *row[1:], n_services=S))
        assert not got[b, :, s:].any() and not gdA[b, :, d:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [65535, 65536])
def test_batched_rask_kernels_pass_the_grid_y_limit(cuda_device, B):
    """Rows sit on gridDim.x, so a batch past 65,535 rows (gridDim.y's
    limit) launches once like any other."""
    args, kw, _ = _batched_case(cuda_device, B, 2, seed=B, D=4, R=2, T=3,
                                Q=3, S=2)
    ct = torch.randn((B, 2, 2), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(0))
    got = rask_objective_forward_cuda(*args, n_services=2)
    gdA = rask_objective_backward_cuda(args[0], ct, *args[1:], n_services=2)
    want = ref.rask_objective_reference(*args, **kw)
    wdA = ref.rask_objective_grad(args[0], ct, *args[1:], **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gdA, wdA, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_batched_rask_kernels_refuse_tables_past_shared_memory(cuda_device):
    """A row's padded tables that need more shared memory than the card
    gives a CTA are refused before any launch, whatever B is."""
    args, kw, _ = _batched_case(cuda_device, 2, 2, seed=5, R=2000, T=10,
                                Q=8)
    n = rask_objective_forward_cuda.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        rask_objective_forward_cuda(*args, n_services=kw["n_services"])
    assert rask_objective_forward_cuda.launches == n


def _fleet_setup(dev, counts=(1, 1, 1, 8, 8), seed=0):
    """A fleet of the paper's services (``counts[h]`` on host h, 2.5 cores
    a service) with fitted models on ``dev``, and the same problem with the
    models' copies on the CPU: two layout buckets under ``auto``."""
    from repro_torch.core.solver import FleetSolverProblem
    rng = np.random.default_rng(seed)
    profs = list(paper_profiles().values())
    specs, host_of, caps = [], {}, {}
    for h, c in enumerate(counts):
        caps[f"h{h}"] = 2.5 * c
        for j in range(c):
            p = profs[(h + j) % 3]
            names = tuple(p.api.names)
            specs.append(ServiceSpec(
                name=f"h{h}/s{j}", param_names=names,
                lower=tuple(x.min_value for x in p.api.parameters),
                upper=tuple(x.max_value for x in p.api.parameters),
                resource_mask=tuple(x.name == "cores"
                                    for x in p.api.parameters),
                slos=tuple(p.slos),
                relation_features=tuple(
                    (t, tuple(names.index(f) for f in fs))
                    for t, fs in p.knowledge.items())))
            host_of[specs[-1].name] = f"h{h}"
    rels, data = [], []
    for s in specs:
        for _, feat in s.relation_features:
            hi = np.asarray([s.upper[j] for j in feat], np.float32)
            X = rng.uniform(0.1, 1.0, (40, len(feat))).astype(np.float32) * hi
            Y = (X @ rng.uniform(1, 20, len(feat))).astype(np.float32)
            rels.append(dict(n_features=len(feat), degree=2, x_scale=hi))
            data.append((X, Y))
    sm = BatchedFitPlan(rels, row_capacity=64, device=dev).fit(data)
    sm_cpu = type(sm)(sm.w.cpu(), sm.exponents.cpu(), sm.term_mask.cpu(),
                      sm.x_scale.cpu(), sm.max_degree)
    problem = SolverProblem(specs, device=dev)
    cpu = SolverProblem(specs, device=torch.device("cpu"))
    fleets = (FleetSolverProblem(problem, host_of, caps),
              FleetSolverProblem(cpu, host_of, caps))
    rps = rng.uniform(5, 60, len(specs)).astype(np.float32)
    return problem, fleets, (sm, sm_cpu), rps, host_of, caps


@pytest.mark.cuda
def test_fleet_solve_is_one_launch_a_bucket_a_step_and_matches_the_cpu(
        cuda_device):
    """The bucketed fleet solve on the card: one backward launch a layout
    bucket an ascent step and one forward a bucket; each host's score
    within 1e-3 relative of the CPU's from the same uniforms, and within
    1e-4 of the card's own per-row loop; every host inside its budget."""
    problem, (fp, fp_cpu), (sm, sm_cpu), rps, host_of, caps = \
        _fleet_setup(cuda_device)
    nb = len(fp.buckets)
    assert nb == 2
    x0 = fp_cpu.random_assignment(np.random.default_rng(1))
    u = fp.uniforms(torch.Generator(cuda_device).manual_seed(3), 6)
    n_fwd = rask_objective_forward_cuda.launches
    n_bwd = rask_objective_backward_cuda.launches
    a, sc = fp.solve_many(sm, rps, x0, u=u)
    assert rask_objective_forward_cuda.launches == n_fwd + nb
    assert rask_objective_backward_cuda.launches == n_bwd + 32 * nb
    a_cpu, sc_cpu = fp_cpu.solve_many(sm_cpu, rps, x0,
                                      u=[x.cpu() for x in u])
    _, sc_seq = fp.solve_sequential(sm, rps, x0, u=u)
    np.testing.assert_array_less(np.abs(sc - sc_cpu),
                                 1e-3 * np.abs(sc_cpu) + 1e-6)
    np.testing.assert_allclose(sc_seq, sc, rtol=1e-4, atol=1e-5)
    for h, cap in caps.items():
        used = sum(float(a[problem.offsets[i]])
                   for i, s in enumerate(problem.specs) if host_of[s.name] == h)
        assert used <= cap


@pytest.mark.cuda
def test_placement_scores_are_one_launch_a_bucket_and_match_the_cpu(
        cuda_device):
    """Overlapping candidate rows (and an empty one) scored on the card:
    one forward and ``iters`` backward launches a bucket, each score
    within 1e-3 relative of the CPU's from the same uniforms."""
    from repro_torch.core.solver import PlacementProblem
    problem, (fp, fp_cpu), (sm, sm_cpu), rps, host_of, caps = \
        _fleet_setup(cuda_device)
    n = len(problem.specs)
    subsets = [()] + [tuple(sorted({i, (i + 3) % n, (i + 7) % n}))
                      for i in range(n)] + [tuple(range(0, n, 2))]
    capacities = [4.0] * len(subsets)
    pp = PlacementProblem(problem, subsets, capacities)
    pp_cpu = PlacementProblem(fp_cpu.problem, subsets, capacities)
    x0 = (0.5 * (problem.lower + problem.upper)).astype(np.float32)
    u = pp.uniforms(torch.Generator(cuda_device).manual_seed(4), 4)
    n_fwd = rask_objective_forward_cuda.launches
    n_bwd = rask_objective_backward_cuda.launches
    got = pp.scores(sm, rps, x0, n_starts=4, iters=16, u=u)
    nb = len(pp.buckets)
    assert rask_objective_forward_cuda.launches == n_fwd + nb
    assert rask_objective_backward_cuda.launches == n_bwd + 16 * nb
    want = pp_cpu.scores(sm_cpu, rps, x0, n_starts=4, iters=16,
                         u=[x.cpu() for x in u])
    assert got[0] == want[0] == 0.0
    np.testing.assert_array_less(np.abs(got - want),
                                 1e-3 * np.abs(want) + 1e-6)


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
    (1, 384, 256, 64, 128, 128, False),   # jamba: 256 heads of 64
    (1, 1024, 256, 64, 128, 128, False),
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


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 3])
def test_rask_kernels_at_the_shrunk_budget(cuda_device, K):
    """The adaptive budget's shapes: K = 2 and 3 candidates (one problem,
    and a fleet bucket of padded rows) against the plain versions at 1e-5,
    and a solve at K starts and 8 iterations — one forward and 8 backward
    launches — within 1e-3 relative of the CPU's from the same uniforms."""
    from repro_torch.core.solver import pgd_solve
    args, kw = _objective_case(1, K, 7 + K, cuda_device)
    S = kw["n_services"]
    ct = torch.randn((K, S), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(K))
    torch.testing.assert_close(
        rask_objective_forward_cuda(*args, n_services=S),
        ref.rask_objective_reference(*args, **kw), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(
        rask_objective_backward_cuda(args[0], ct, *args[1:], n_services=S),
        ref.rask_objective_grad(args[0], ct, *args[1:], **kw), atol=1e-5,
        rtol=1e-5)
    bargs, bkw, _ = _batched_case(cuda_device, 5, K, seed=K)
    bct = torch.randn((5, K, bkw["n_services"]), device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(9))
    torch.testing.assert_close(
        rask_objective_forward_cuda(*bargs, n_services=bkw["n_services"]),
        ref.rask_objective_reference(*bargs, **bkw), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(
        rask_objective_backward_cuda(bargs[0], bct, *bargs[1:],
                                     n_services=bkw["n_services"]),
        ref.rask_objective_grad(bargs[0], bct, *bargs[1:], **bkw),
        atol=1e-5, rtol=1e-5)
    problem, sm = _objective_setup(1, K, 7 + K, cuda_device)[2:4]
    rps = args[-1]
    x0 = args[0][0]
    u = torch.rand((max(K - 3, 0), problem.dim), device=cuda_device,
                   generator=torch.Generator(cuda_device).manual_seed(5))
    n_fwd = rask_objective_forward_cuda.launches
    n_bwd = rask_objective_backward_cuda.launches
    a, score = pgd_solve(x0, u, problem.tables, sm, rps, 8.0, n_starts=K,
                         iters=8, lr=0.18, n_services=S)
    torch.cuda.synchronize()
    assert rask_objective_forward_cuda.launches == n_fwd + 1
    assert rask_objective_backward_cuda.launches == n_bwd + 8
    cpu = torch.device("cpu")
    t_cpu = type(problem.tables)(*(t.to(cpu) for t in problem.tables))
    sm_cpu = type(sm)(sm.w.cpu(), sm.exponents.cpu(), sm.term_mask.cpu(),
                      sm.x_scale.cpu(), sm.max_degree, sm.labels)
    _, want = pgd_solve(x0.cpu(), u.cpu(), t_cpu, sm_cpu, rps.cpu(), 8.0,
                        n_starts=K, iters=8, lr=0.18, n_services=S)
    assert abs(float(score) - float(want)) <= 1e-3 * abs(float(want)) + 1e-6
    assert float(a[problem.resource_mask].sum()) <= 8.0


def _pipelined_agent(dev, seconds=100.0, **cfg):
    from repro_torch.core import RASKAgent, RaskConfig
    from repro_torch.env import EdgeEnvironment, paper_knowledge
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                          seed=0)
    agent = RASKAgent(env.platform, paper_knowledge(),
                      RaskConfig(xi=6, eta=0.05, pipeline=True, **cfg),
                      seed=0, device=dev)
    return env, agent


@pytest.mark.cuda
def test_pipelined_agent_lags_one_cycle_on_its_stream(cuda_device):
    """On the card the pipelined decide queues its dispatch on the agent's
    own stream; the plan emitted at round n + 1 is the noised plan that
    the dispatch at round n computed, the first solved round is a fill
    round, and ``refresh_topology`` drops the pending result (the next
    round is a fill round again)."""
    env, agent = _pipelined_agent(cuda_device)
    assert agent._cuda_stream is not None
    outs, plans, streams = [], [], []
    queue, plan, dispatch = agent._queue_copy, agent._plan, \
        agent._dispatch_fused

    def on_dispatch(*args):
        streams.append(torch.cuda.current_stream(cuda_device))
        return dispatch(*args)

    def on_queue(out):
        outs.append(out.clone())
        return queue(out)
    agent._dispatch_fused, agent._queue_copy = on_dispatch, on_queue
    agent._plan = lambda a: (plans.append(np.array(a, np.float32)),
                             plan(a))[1]
    hist = env.run(agent, duration_s=160.0)
    torch.cuda.synchronize()
    assert all(s == agent._cuda_stream for s in streams)
    assert hist[6].explored and hist[6].pipelined      # the fill round
    d = agent.problem.dim
    for out, emitted in zip(outs[:-1], plans[7:], strict=True):
        np.testing.assert_array_equal(emitted, out.cpu().numpy()[d:2 * d])
    assert agent.collects == len(hist) - 7
    agent.refresh_topology()
    assert agent._pending is None
    more = env.run(agent, duration_s=20.0)
    assert more[0].runtime_s == 0.0 and not more[0].explored
    assert more[1].runtime_s > 0.0


@pytest.mark.cuda
def test_collect_reads_the_pinned_copy_only_after_its_event(cuda_device,
                                                            monkeypatch):
    """Each dispatch ends in a spin of ~0.1 s on the agent's stream ahead
    of the copy, so the collect finds its event still pending: it waits on
    that event, and only then reads the pinned buffer, whose values are
    the device output's bit for bit."""
    from repro_torch.core import rask
    env, agent = _pipelined_agent(cuda_device)
    log, outs = [], []

    class LoggedEvent(torch.cuda.Event):
        def synchronize(self):
            log.append(("wait", self.query()))
            super().synchronize()
            log.append(("done", self.query()))

    monkeypatch.setattr(torch.cuda, "Event", LoggedEvent)
    split = rask.RASKAgent._split_out
    monkeypatch.setattr(rask.RASKAgent, "_split_out", staticmethod(
        lambda out, d, n: (log.append(("read", out.copy())),
                           split(out, d, n))[1]))
    queue = agent._queue_copy

    def on_queue(out):
        torch.cuda._sleep(200_000_000)
        outs.append(out)
        return queue(out)
    agent._queue_copy = on_queue
    env.run(agent, duration_s=120.0)
    reads = [i for i, e in enumerate(log) if e[0] == "read"]
    assert len(reads) == len(outs) - 1 >= 4
    for k, i in enumerate(reads):
        assert log[i - 2] == ("wait", False) and log[i - 1] == ("done", True)
        np.testing.assert_array_equal(log[i][1], outs[k].cpu().numpy())
    assert agent.collects == len(reads) and agent.collects_ready == 0


@pytest.mark.cuda
def test_forecaster_on_the_card_matches_the_cpu(cuda_device):
    """The forecaster's streaming fit and prediction on the card against
    the same on the CPU: predictions and the blended load within 1e-3 of
    their span. The Gram systems agree to float32 rounding; the 9-term AR
    normal equations over correlated lags are ill-conditioned, and the
    card's and the CPU's LU solves of them differ by up to ~2e-4 of the
    prediction (one run: 1.7e-4)."""
    from repro_torch.core.forecast import LoadForecaster
    from repro_torch.core.telemetry import TrainingTable
    rng = np.random.default_rng(0)
    table = TrainingTable()
    sids = [f"edge-0/s/c{i}" for i in range(6)]
    for i, sid in enumerate(sids):
        base = 10.0 * (i + 1)
        for t in range(70):
            table.append(sid, {"rps": float(base * (1.3 + np.sin(t / 4.0))
                                             + rng.normal(0, 0.5))})
    got = []
    for dev in (cuda_device, torch.device("cpu")):
        fc = LoadForecaster(sids, ["s"] * 6, [40.0] * 6, lags=8, horizon=1,
                            row_capacity=64, device=dev)
        kind, pairs = fc.prep(table)
        fc.state = fc.plan.stream_rebuild(pairs)
        wp, pl = fc.prior_arrays()
        w = fc.plan.stream_fit_arrays(fc.state, torch.from_numpy(wp).to(dev),
                                      torch.from_numpy(pl).to(dev))
        lagm = torch.from_numpy(fc.lag_matrix(table)).to(dev)
        use = torch.ones(6, device=dev)
        rps = torch.full((6,), 20.0, device=dev)
        pred, eff = fc.predict_tracer(w, lagm, use, rps)
        got.append((pred.cpu().numpy(), eff.cpu().numpy()))
    (pc, ec), (pp, ep) = got
    span = float(np.abs(pp).max())
    np.testing.assert_allclose(pc, pp, rtol=0, atol=1e-3 * span)
    np.testing.assert_allclose(ec, ep, rtol=0, atol=1e-3 * span)


# -- the paper's comparison: SLSQP, auto_degree, the baselines ---------------


def _auto_degree_tables(dev):
    """The |S| = 9 layout with the degrees ``auto_degree`` may pick, 1 to 6
    mixed over the relations (cv-analyzer's three features at degree 6:
    T = C(9, 3) = 84 terms, the rest padded by ``term_mask``)."""
    degrees = (1, 6, 2, 3, 6, 4, 5, 6, 6)      # QR, CV, PC a replica
    return _objective_setup(3, 1, 83, dev, degree_of=degrees.__getitem__)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["S3", "S9", "T84"])
def test_rask_kernels_at_one_candidate_and_the_auto_degree_tables(
        cuda_device, case):
    """Both kernels at K = 1 (an SLSQP evaluation) on the |S| = 3 and 9
    layouts and on mixed degrees 1-6 (T = 84), against their plain
    versions at 1e-5 of scale; K = 1 is one launch each, as K = 6."""
    if case == "T84":
        args, kw, _, sm = _auto_degree_tables(cuda_device)
        assert sm.w.shape[1] == 84 and sm.max_degree == 6
        assert sorted({int(m.sum()) for m in sm.term_mask.cpu()}) != [84]
    else:
        args, kw = _objective_case(1 if case == "S3" else 3, 1, 7,
                                   cuda_device)
    A = args[0]
    assert A.shape[0] == 1
    ct = -torch.ones((1, kw["n_services"]), device=cuda_device)
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
    for g, w in ((got, want), (gdA, wdA)):
        assert torch.isfinite(g).all()
        bar = 1e-5 * (1.0 + float(w.abs().max()))
        assert float((g - w).abs().max()) <= bar


def _slsqp_case(dev, fused, seed=5):
    """The |S| = 9 problem on ``dev`` and its CPU twin, the same fitted
    models on each, a load and a feasible warm start."""
    args, kw, problem, sm = _objective_setup(3, 1, seed, dev)
    cpu = SolverProblem(problem.specs, fused=fused, device="cpu")
    card = SolverProblem(problem.specs, fused=fused, device=dev)
    from repro_torch.core.regression import StackedModels
    sm_cpu = StackedModels(sm.w.cpu(), sm.exponents.cpu(),
                           sm.term_mask.cpu(), sm.x_scale.cpu(),
                           sm.max_degree, sm.labels)
    rng = np.random.default_rng(seed)
    x0 = cpu.random_assignment(rng, 24.0)
    return card, cpu, sm, sm_cpu, args[-1].cpu().numpy(), x0


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_solve_slsqp_on_the_card_matches_the_cpu(cuda_device, fused):
    """SLSQP on the card from the CPU's models and x0. At every point the
    card's scipy run evaluated, the card's value and gradient equal the
    CPU's within 1e-5 of (1 + the largest); fused, each evaluation
    launches the forward and the backward kernel once. SLSQP is one local
    search: values a float32 rounding apart can send the two runs to
    different local optima (this case: 12.80 on the card, 12.65 on the
    CPU, ROADMAP Queue 3), so the two ends are held to feasibility and to
    5% of each other (``repro``'s PGD/SLSQP parity bar), not to 1e-4."""
    card, cpu, sm, sm_cpu, rps, x0 = _slsqp_case(cuda_device, fused)
    models = sm if fused else card.models_dict(sm)
    cpu_models = sm_cpu if fused else cpu.models_dict(sm_cpu)
    points = []
    name = "_vg_cat" if fused else "_neg_objective"
    inner = getattr(card, name)

    def noted(a, *args):
        points.append(a.detach().cpu().numpy().copy())
        return inner(a, *args)
    setattr(card, name, noted)
    n_fwd = rask_objective_forward_cuda.launches
    n_bwd = rask_objective_backward_cuda.launches
    a, s = card.solve_slsqp(models, rps, x0, 24.0)
    evals = card.last_nfev
    assert len(points) == evals > 1
    if fused:
        assert rask_objective_forward_cuda.launches - n_fwd == evals
        assert rask_objective_backward_cuda.launches - n_bwd == evals
    else:
        assert rask_objective_forward_cuda.launches == n_fwd
    setattr(card, name, inner)
    rps_c, rps_d = torch.from_numpy(rps), torch.from_numpy(rps).to(
        cuda_device)
    for x in points:
        if fused:
            got = card._vg_cat(torch.from_numpy(x).to(cuda_device), sm,
                               rps_d, 24.0).cpu().numpy()
            want = cpu._vg_cat(torch.from_numpy(x), sm_cpu, rps_c,
                               24.0).numpy()
        else:
            vg = []
            for p, m, r, dev in ((card, models, rps_d, cuda_device),
                                 (cpu, cpu_models, rps_c, "cpu")):
                t = torch.tensor(x, device=dev, requires_grad=True)
                v = p._neg_objective(t, m, r, 24.0)
                v.backward()
                vg.append(np.concatenate([[v.item()],
                                          t.grad.cpu().numpy()]))
            got, want = vg
        assert np.abs(got - want).max() <= 1e-5 * (1 + np.abs(want).max())
    a_cpu, s_cpu = cpu.solve_slsqp(cpu_models, rps, x0, 24.0)
    assert abs(s - s_cpu) <= 0.05 * abs(s_cpu)
    for p, x in ((card, a), (cpu, a_cpu)):
        assert x[p.resource_mask].sum() <= 24.0 + 1e-4
        assert np.all(x >= p.lower - 1e-5) and np.all(x <= p.upper + 1e-5)


@pytest.mark.cuda
def test_dqn_td_step_on_the_card_matches_the_cpu(cuda_device):
    """The same DQN (the same seeded initial weights on both devices) takes
    two TD steps on the same batch: losses and weights within 1e-5."""
    from repro_torch.core.agents.dqn import DQNConfig, ServiceDQN
    prof = paper_profiles()["cv-analyzer"]
    nets = [ServiceDQN(prof.api, prof.slos, DQNConfig(), 3, dev)
            for dev in (cuda_device, torch.device("cpu"))]
    rng = np.random.default_rng(0)
    n = nets[1].state_dim
    batch = (rng.random((64, n), np.float32),
             rng.integers(nets[1].n_actions, size=64),
             rng.random(64, np.float32), rng.random((64, n), np.float32),
             np.zeros(64, np.float32))
    out = []
    for net in nets:
        b = [torch.from_numpy(np.asarray(x)).to(net.device) for x in batch]
        losses = [float(net.td_step(*b, 3e-4)) for _ in range(2)]
        out.append((losses, [p.detach().cpu() for p in
                             net.net.parameters()]))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5, atol=1e-6)
    for p, q in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-5)
    s = batch[0][0]
    np.testing.assert_allclose(nets[0].q_values(s), nets[1].q_values(s),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_select_degree_on_the_card_matches_the_cpu(cuda_device):
    """The float64 fits of ``select_degree`` on the card and on the CPU:
    the same pick, errors within 1e-6 relative."""
    from repro_torch.core.regression import select_degree
    rng = np.random.default_rng(4)
    prof = paper_profiles()["cv-analyzer"]
    names = list(prof.api.names)
    hi = np.asarray([prof.api.parameter(x).max_value for x in names],
                    np.float32)
    X = (rng.uniform(0.1, 1.0, (41, 3)) * hi).astype(np.float32)
    Y = np.asarray([prof.tp_max(dict(zip(names, x))) for x in X],
                   np.float32)
    best, errs = select_degree(X, Y, x_scale=hi, device=cuda_device)
    best_c, errs_c = select_degree(X, Y, x_scale=hi)
    assert best == best_c
    for d in errs:
        assert errs[d] == pytest.approx(errs_c[d], rel=1e-6)


@pytest.mark.cuda
def test_new_entry_points_raise_without_cuda(monkeypatch):
    """``DQNAgent``, ``RASKAgent(backend="slsqp")`` and ``compare_solvers``
    default to the card and raise without it (no fall back to the CPU)."""
    from repro_torch.core import RASKAgent, RaskConfig
    from repro_torch.core.agents import DQNAgent
    from repro_torch.env import EdgeEnvironment, paper_knowledge
    from repro_torch.launch import compare_solvers
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DQNAgent(env.platform)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RASKAgent(env.platform, paper_knowledge(),
                  RaskConfig(backend="slsqp"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compare_solvers.main(["--seconds", "10"])


@pytest.mark.cuda
def test_moe_decoder_on_the_card_matches_the_cpu(cuda_device):
    """qwen2-moe-a2.7b's smoke cut in float32, one set of weights: a
    right-padded prefill (64 tokens, one group, routes dropped at cap 40)
    and 4 decode steps, logits within 1e-4 (the bar of
    ``tests/test_torch_model.py``) and the same kept routes, bit for bit."""
    from repro_torch.configs import get
    from repro_torch.models import build
    from repro_torch.models.moe import recording_routes
    cfg = get("qwen2-moe-a2.7b").smoke()
    model = build(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(3))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 64)))
    toks[:, 45:] = 0
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        p = to(params, dev)
        with recording_routes() as routes:
            logits, cache = model.prefill(p, {"tokens": toks.to(dev)},
                                          max_seq=96, length=45)
            steps = [logits]
            for _ in range(4):
                nxt = torch.argmax(steps[-1], -1)[:, None]
                logits, cache = model.decode(p, nxt, cache)
                steps.append(logits)
        out.append(([s.cpu() for s in steps],
                    [(i.cpu(), k.cpu()) for i, k in routes]))
    (card, card_routes), (cpu, cpu_routes) = out
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert len(card_routes) == len(cpu_routes) == 5 * cfg.n_layers
    for (i, k), (ci, ck) in zip(card_routes, cpu_routes):
        assert torch.equal(i, ci) and torch.equal(k, ck)
    assert sum(int((~k).sum()) for _, k in cpu_routes) > 0


@pytest.mark.cuda
def test_autoscale_cli_on_the_card_explores_as_the_cpu(cuda_device):
    """The control plane's CLI deciding on the card: its exploration plans
    (numpy draws) are the CPU run's, and every fulfilment lies in [0, 1]."""
    from repro_torch.launch import autoscale
    runs = [autoscale.main(["--minutes", "4", "--device", dev])
            for dev in ("cuda", "cpu")]
    for h, c in zip(*runs):
        assert h.explored == c.explored
        if h.explored:
            assert sorted((o.sid, o.param, o.requested)
                          for o in h.receipt.outcomes) == \
                sorted((o.sid, o.param, o.requested)
                       for o in c.receipt.outcomes)
        assert 0.0 <= h.fulfillment <= 1.0


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "jamba-1.5-large-398b"])
def test_new_families_on_the_card_match_the_cpu(cuda_device, arch):
    """whisper's and jamba's smoke cuts in float32, one set of weights: a
    prefill (whisper: 2 clips of 40 frames and 5 tokens; jamba: 37
    tokens) and 4 decode steps, logits within 1e-4 (the bar of
    ``tests/test_torch_model.py``), and each attention and SSD call on
    the kernels."""
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import reset_launches
    from repro_torch.models import build
    cfg = get(arch).smoke()
    model = build(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(4))
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 37)))}
    if cfg.family == "encdec":
        batch = {"tokens": batch["tokens"][:, :5], "frames": torch.from_numpy(
            rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32))}
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        reset_launches()
        decode_attention_cuda.launches = ssd_cuda.launches = 0
        logits, cache = model.prefill(_to(params, dev), _to(batch, dev),
                                      max_seq=64)
        steps = [logits]
        for _ in range(4):
            nxt = torch.argmax(steps[-1], -1)[:, None]
            logits, cache = model.decode(_to(params, dev), nxt, cache)
            steps.append(logits)
        out.append([s.cpu() for s in steps])
        if dev.type == "cuda":
            launches = (flash_attention_cuda.launches,
                        decode_attention_cuda.launches, ssd_cuda.launches)
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    if cfg.family == "encdec":       # encoder, prompt and cross; self + cross
        assert launches == (cfg.encoder_layers + 2 * cfg.n_layers,
                            4 * 2 * cfg.n_layers, 0)
    else:                            # one period: attention, 7 Mamba-2
        assert launches == (1, 4, 7)


@pytest.mark.cuda
def test_mixed_cache_on_the_card_matches_the_full_cache(cuda_device):
    """gemma3-1b's smoke cut (window 16) in float32 with the mixed cache:
    40 steps from token 0 (the ring wraps twice) give the full-cache
    decode's logits within 1e-4, one decode launch a layer a step."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.models import build
    cfg = dataclasses.replace(get("gemma3-1b").smoke(), mixed_cache=True)
    mixed = build(cfg)
    full = build(dataclasses.replace(cfg, mixed_cache=False))
    params = _to(mixed.init(torch.Generator("cpu").manual_seed(5)),
                 cuda_device)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (40, 2, 1))).to(cuda_device)
    mc = mixed.init_cache(2, 64, cuda_device)
    fc = full.init_cache(2, 64, cuda_device)
    decode_attention_cuda.launches = 0
    for t in range(40):
        lm, mc = mixed.decode(params, toks[t], mc)
        lf, fc = full.decode(params, toks[t], fc)
        torch.testing.assert_close(lm, lf, rtol=1e-4, atol=1e-4)
    assert decode_attention_cuda.launches == 2 * 40 * cfg.n_layers


# -- training: attention's backward kernel, the forward's lse -----------------

def _grad_err(got, want):
    """Largest gap over the gradient's largest entry."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


# 1e-4 of each gradient's largest entry in float32 (the same sums in
# another order), 5e-2 in bf16 (inputs, P and dS rounded to bf16)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# lse: float32 scores on both sides (bf16 inputs, float32 products)
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}

BWD_CASES = [
    (4, 4, 1, 1024, 1024, 256, True, 512),   # gemma3-1b training: local
    (4, 4, 1, 1024, 1024, 256, True, 0),     # and global layers
    (1, 20, 20, 187, 1500, 64, False, 0),    # whisper: decoder over frames
    (1, 4, 1, 600, 600, 256, True, 512),     # the ragged row of a cross-check
    (2, 4, 2, 37, 53, 40, True, 9),          # ragged, right-aligned, GQA
    (1, 8, 1, 200, 200, 64, True, 0),        # G = 8
    (1, 2, 1, 129, 129, 200, False, 33),     # D not a power of two
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,S,T,D,causal,window", BWD_CASES)
def test_flash_backward_kernel_matches_plain(cuda_device, dtype, B, H, KH,
                                             S, T, D, causal, window):
    from repro_torch.kernels.flash_attention import \
        flash_attention_backward_cuda
    g = torch.Generator(cuda_device).manual_seed(S + T + D)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    q, k, v = randn(B, H, S, D), randn(B, KH, T, D), randn(B, KH, T, D)
    do = randn(B, H, S, D)
    o = ref.flash_attention_reference(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse_reference(q, k, causal=causal,
                                            window=window)
    n = flash_attention_backward_cuda.launches
    got = flash_attention_backward_cuda(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    want = ref.flash_attention_backward_reference(
        q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_backward_cuda.launches == n + 1
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _grad_err(a, b) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,S,T,D,causal,window", [
    (4, 4, 1, 1024, 1024, 256, True, 512),   # chains split: the reduce
    (1, 4, 1, 600, 600, 256, True, 512),
    (1, 20, 20, 187, 1500, 64, False, 0),
])
def test_flash_backward_kernel_is_deterministic(cuda_device, dtype, B, H, KH,
                                                S, T, D, causal, window):
    """Two calls on the same inputs give bitwise-equal gradients: split
    chains are summed by the reduce kernel in a fixed order, no atomics."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, plan_of)
    g = torch.Generator(cuda_device).manual_seed(S + T)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    q, k, v, do = (randn(B, H, S, D), randn(B, KH, T, D), randn(B, KH, T, D),
                   randn(B, H, S, D))
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    a = flash_attention_backward_cuda(q, k, v, o, lse, do, causal=causal,
                                      window=window)
    b = flash_attention_backward_cuda(q, k, v, o, lse, do, causal=causal,
                                      window=window)
    torch.cuda.synchronize()
    if (S, window) != (187, 0):
        assert len(plan_of(q, k, causal=causal, window=window).reduce) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,S,T,D,causal,window", [
    BWD_CASES[0], BWD_CASES[2], BWD_CASES[4], BWD_CASES[6]])
def test_flash_backward_recomputing_dq_matches_plain(cuda_device, dtype, B,
                                                     H, KH, S, T, D, causal,
                                                     window, monkeypatch):
    """Where the dS tiles would not fit under ``BWD_DS_CAP`` (0 here), the
    dQ pass computes S and dP again in blocks of 32 keys: the same
    gradient."""
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(fa, "BWD_DS_CAP", 0)
    g = torch.Generator(cuda_device).manual_seed(S + T + D)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    q, k, v = randn(B, H, S, D), randn(B, KH, T, D), randn(B, KH, T, D)
    do = randn(B, H, S, D)
    o = ref.flash_attention_reference(q, k, v, causal=causal, window=window)
    lse = ref.flash_attention_lse_reference(q, k, causal=causal,
                                            window=window)
    assert fa.plan_of(q, k, causal=causal, window=window).dq_block == 32
    got = fa.flash_attention_backward_cuda(q, k, v, o, lse, do,
                                           causal=causal, window=window)
    want = ref.flash_attention_backward_reference(
        q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _grad_err(a, b) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,S,T,D,causal,window", [
    (4, 4, 1, 1024, 1024, 256, True, 512),
    (1, 4, 1, 1024, 1024, 256, True, 0),     # the kv range splits: merged
    (1, 20, 20, 187, 1500, 64, False, 0),
    (1, 2, 1, 700, 900, 64, False, 0),
])
def test_flash_forward_lse_matches_plain(cuda_device, dtype, B, H, KH, S, T,
                                         D, causal, window):
    g = torch.Generator(cuda_device).manual_seed(7)
    q = torch.randn((B, H, S, D), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((B, KH, T, D), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((B, KH, T, D), generator=g, device=cuda_device).to(dtype)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    plain = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_lse_reference(q, k, causal=causal,
                                             window=window)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    assert float((lse - want).abs().max()) <= LSE_TOL[dtype]
    assert torch.equal(out, plain)           # lse changes nothing else


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_goes_through_the_kernels(cuda_device,
                                                           dtype):
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, reset_launches)
    g = torch.Generator(cuda_device).manual_seed(3)
    q = torch.randn((2, 4, 300, 64), generator=g, device=cuda_device)
    k = torch.randn((2, 1, 300, 64), generator=g, device=cuda_device)
    v = torch.randn((2, 1, 300, 64), generator=g, device=cuda_device)
    do = torch.randn((2, 4, 300, 64), generator=g, device=cuda_device)
    leaves = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
    reset_launches()
    out = ops.flash_attention(*leaves, causal=True, window=128)
    got = torch.autograd.grad(out, leaves, do.to(dtype))
    assert flash_attention_cuda.launches == 1
    assert flash_attention_backward_cuda.launches == 1
    plain = [t.detach().float().requires_grad_(True) for t in leaves]
    want = torch.autograd.grad(ref.flash_attention_reference(
        *plain, causal=True, window=128), plain, do.to(dtype).float())
    for a, b in zip(got, want):
        assert _grad_err(a, b) <= BWD_TOL[dtype]
    with torch.no_grad():                    # no graph: the forward alone
        ops.flash_attention(*leaves, causal=True, window=128)
    assert flash_attention_cuda.launches == 2
    assert flash_attention_backward_cuda.launches == 1


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_autograd(cuda_device):
    g = torch.Generator(cuda_device).manual_seed(0)
    q = torch.randn((2, 4, 64), generator=g, device=cuda_device,
                    requires_grad=True)
    cache = torch.randn((2, 16, 1, 64), generator=g, device=cuda_device)
    length = torch.full((2,), 16, dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention_cuda(q, cache, cache, length, torch.zeros_like(
            length))
    with torch.no_grad():
        decode_attention_cuda(q, cache, cache, length,
                              torch.zeros_like(length))
    b, l, h, p, n = 1, 64, 4, 16, 16
    x = torch.randn((b, l, h, p), generator=g, device=cuda_device,
                    requires_grad=True)
    dt = torch.rand((b, l, h), generator=g, device=cuda_device)
    A = -torch.rand((h,), generator=g, device=cuda_device)
    Bm = torch.randn((b, l, n), generator=g, device=cuda_device)
    with pytest.raises(RuntimeError, match="ops.py::ssd"):
        ssd_cuda(x, dt, A, Bm, Bm, chunk=32)


@pytest.mark.cuda
def test_smoke_loss_on_the_card_matches_the_cpu(cuda_device):
    """gemma3-1b's smoke cut (7 layers, window 16) in float32: the loss and
    every gradient leaf on the card (flash forward and backward kernels,
    once a layer each) against the CPU's plain autograd, within 1e-4 of
    each leaf's largest entry or 1e-7; then mamba2's and jamba's smoke cuts
    (the SSD forward and backward kernels once a Mamba-2 layer) the same
    way."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, reset_launches)
    from repro_torch.models import build
    from repro_torch.train.tree import leaves, map_tree
    cfg = dataclasses.replace(get("gemma3-1b").smoke(), dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 48)))
             for k in ("tokens", "labels")}
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        p = map_tree(lambda t: t.to(dev).requires_grad_(True), params)
        reset_launches()
        loss, _ = model.loss(p, {k: v.to(dev) for k, v in batch.items()})
        grads.append((float(loss), torch.autograd.grad(loss, leaves(p))))
        if dev.type == "cuda":
            assert flash_attention_cuda.launches == cfg.n_layers
            assert flash_attention_backward_cuda.launches == cfg.n_layers
    (lc, gc), (lp, gp) = grads
    assert abs(lc - lp) <= 1e-4
    for a, b in zip(gc, gp):
        bar = max(1e-4 * float(b.abs().max()), 1e-7)
        assert float((a.cpu() - b).abs().max()) <= bar
    from repro_torch.kernels.ssd_scan import ssd_backward_cuda
    from repro_torch.models.transformer import _hybrid_layout
    for arch in ("mamba2-370m", "jamba-1.5-large-398b"):
        scfg = dataclasses.replace(get(arch).smoke(), dtype="float32")
        smodel = build(scfg)
        sparams = smodel.init(torch.Generator().manual_seed(1))
        n_mamba = scfg.n_layers
        if scfg.family == "hybrid":
            n_periods, P, _, _ = _hybrid_layout(scfg)
            n_mamba = n_periods * (P - 1)
        grads = []
        for dev in (cuda_device, torch.device("cpu")):
            p = map_tree(lambda t: t.to(dev).requires_grad_(True), sparams)
            ssd_cuda.launches = ssd_backward_cuda.launches = 0
            loss, _ = smodel.loss(p, {k: v.to(dev) for k, v in batch.items()})
            grads.append((float(loss), torch.autograd.grad(loss, leaves(p))))
            if dev.type == "cuda":
                assert ssd_cuda.launches == n_mamba
                assert ssd_backward_cuda.launches == n_mamba
        (lc, gc), (lp, gp) = grads
        assert abs(lc - lp) <= 1e-4, arch
        for a, b in zip(gc, gp):
            bar = max(1e-4 * float(b.abs().max()), 1e-7)
            assert float((a.cpu() - b).abs().max()) <= bar, arch


# -- the SSD scan's backward ----------------------------------------------------

def _bwd_rel_errors(got, want):
    return [float((a.float() - b.float()).abs().max())
            / max(float(b.float().abs().max()), 1e-30)
            for a, b in zip(got, want)]


def _ssd_bwd_inputs(dev, dtype, b, l, h, p, n, with_state, seed):
    """``_ssd_inputs`` and cotangents dy ~ N(0, 1) and, with a state,
    dfinal ~ N(0, 1)."""
    args, init = _ssd_inputs(dev, dtype, b, l, h, p, n, with_state, seed)
    g = torch.Generator(dev).manual_seed(seed + 1)
    dy = torch.randn((b, l, h, p), generator=g, device=dev).to(dtype)
    dfin = torch.randn((b, h, p, n), generator=g, device=dev).to(dtype) \
        if with_state else None
    return args, init, dy, dfin


SSD_BWD_CASES = [
    (1, 64, 2, 16, 8, 16, False),
    (2, 128, 4, 32, 16, 32, True),
    (1, 20, 2, 24, 16, 128, True),        # ck = l = 20: ragged chunk and P
    (1, 64, 32, 64, 128, 128, False),     # one chunk
    (2, 256, 32, 64, 128, 128, False),    # mamba2-370m's heads, two chunks
    (2, 384, 32, 64, 128, 128, True),     # a state and a final cotangent
    (1, 256, 256, 64, 128, 128, False),   # jamba: 256 heads of 64
    (1, 128, 64, 32, 64, 128, True),      # 64 groups: cluster partials
    (4, 1024, 36, 64, 128, 128, False),   # 36 heads: not a multiple of g
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,p,n,chunk,with_state", SSD_BWD_CASES)
def test_ssd_backward_kernel_matches_plain(cuda_device, dtype, b, l, h, p, n,
                                           chunk, with_state):
    """The backward kernel against ``ref.ssd_backward_reference``: 1e-4 of
    each gradient's largest entry in float32 (the same sums in another
    order), 5e-2 in bf16 (bf16 inputs and forward states, float32 sums);
    one count a call."""
    from repro_torch.kernels.ssd_scan import ssd_backward_cuda
    args, init, dy, dfin = _ssd_bwd_inputs(cuda_device, dtype, b, l, h, p,
                                           n, with_state, seed=l + h)
    _, _, cs, prev = ssd_cuda(*args, chunk=chunk, initial_state=init,
                              return_states=True)
    launches = ssd_backward_cuda.launches
    got = ssd_backward_cuda(*args, dy, cs, prev, dfin, chunk=chunk)
    want = ref.ssd_backward_reference(*args, dy, dfin, chunk=min(chunk, l),
                                      initial_state=init)
    torch.cuda.synchronize()
    assert ssd_backward_cuda.launches == launches + 1
    assert all(a.dtype == dtype and a.shape == w.shape
               for a, w in zip(got, want))
    assert all(bool(torch.isfinite(a).all()) for a in got)
    bar = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert max(_bwd_rel_errors(got, want)) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,cluster", [(1, 1), (5, 2), (3, 4), (8, 1),
                                           (2, 8)])
def test_ssd_backward_kernel_takes_any_partition(cuda_device, dtype, group,
                                                 cluster):
    """Every head group and cluster size (``BackwardPlan.of``; 12 heads:
    groups that do not divide them, CTAs without a head, one cluster or
    several) gives the plain backward's gradients within the bars."""
    from repro_torch.kernels.ssd_scan import BackwardPlan, backward_with_plan
    b, l, h, p, n, chunk = 2, 256, 12, 32, 64, 64
    args, init, dy, dfin = _ssd_bwd_inputs(cuda_device, dtype, b, l, h, p, n,
                                           True, seed=group + 10 * cluster)
    _, _, cs, prev = ssd_cuda(*args, chunk=chunk, initial_state=init,
                              return_states=True)
    plan = BackwardPlan.of(b * (l // chunk), h, group, cluster)
    got = backward_with_plan(*args, dy, cs, prev, dfin, chunk=chunk,
                             plan=plan)
    want = ref.ssd_backward_reference(*args, dy, dfin, chunk=chunk,
                                      initial_state=init)
    torch.cuda.synchronize()
    bar = 5e-2 if dtype == torch.bfloat16 else 1e-4
    assert max(_bwd_rel_errors(got, want)) <= bar


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_is_bitwise_repeatable(cuda_device, dtype):
    from repro_torch.kernels.ssd_scan import ssd_backward_cuda
    args, init, dy, dfin = _ssd_bwd_inputs(cuda_device, dtype, 2, 384, 32,
                                           64, 128, True, seed=7)
    _, _, cs, prev = ssd_cuda(*args, chunk=128, initial_state=init,
                              return_states=True)
    one = ssd_backward_cuda(*args, dy, cs, prev, dfin, chunk=128)
    two = ssd_backward_cuda(*args, dy, cs, prev, dfin, chunk=128)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.cuda
def test_ssd_backward_kernel_refuses_bad_input(cuda_device):
    from repro_torch.kernels.ssd_scan import ssd_backward_cuda
    args, _, dy, _ = _ssd_bwd_inputs(cuda_device, torch.float32, 1, 64, 2,
                                     16, 8, False, seed=3)
    x, dt, A, B, C = args
    _, _, cs, prev = ssd_cuda(*args, chunk=16, return_states=True)
    launches = ssd_backward_cuda.launches
    with pytest.raises(ValueError, match="contiguous"):
        ssd_backward_cuda(x, dt, A, B, C, dy.transpose(2, 3).contiguous()
                          .transpose(2, 3), cs, prev, chunk=16)
    with pytest.raises(ValueError, match="dtype"):
        ssd_backward_cuda(x, dt, A, B, C, dy.bfloat16(), cs, prev, chunk=16)
    with pytest.raises(ValueError, match="shape"):
        ssd_backward_cuda(x, dt, A, B, C, dy[:, :32], cs, prev, chunk=16)
    with pytest.raises(ValueError, match="cs"):
        ssd_backward_cuda(x, dt, A, B, C, dy, cs.double(), prev, chunk=16)
    with pytest.raises(ValueError, match="prev"):
        ssd_backward_cuda(x, dt, A, B, C, dy, cs, prev[:, :1], chunk=32)
    with pytest.raises(ValueError, match="divisible"):
        ssd_backward_cuda(x, dt, A, B, C, dy, cs, prev, chunk=48)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_backward_cuda(x.cpu(), dt, A, B, C, dy, cs, prev, chunk=16)
    assert ssd_backward_cuda.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_autograd_goes_through_the_kernels(cuda_device, dtype,
                                                    with_state):
    """``ops.ssd`` under autograd: ``SSDScan`` (the forward kernel once, the
    backward kernel once) gives the plain backward's gradients of x, dt, A,
    B, C and the initial state; y alone (the final state unused, dfinal
    None) and both outputs; without a graph the forward kernel alone."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_backward_cuda
    args, init, dy, dfin = _ssd_bwd_inputs(cuda_device, dtype, 2, 256, 32,
                                           64, 128, with_state, seed=11)
    bar = 5e-2 if dtype == torch.bfloat16 else 1e-4
    leaves = [t.clone().requires_grad_(True)
              for t in args + ([init] if with_state else [])]
    for cot in ((dy, None), (dy, dfin if with_state else None)):
        ssd_cuda.launches = ssd_backward_cuda.launches = 0
        y, fin = ops.ssd(*leaves[:5], chunk=128,
                         initial_state=leaves[5] if with_state else None)
        outs, cts = zip(*[(o, c) for o, c in zip((y, fin), cot)
                          if c is not None])
        got = torch.autograd.grad(outs, leaves, cts)
        assert ssd_cuda.launches == 1 and ssd_backward_cuda.launches == 1
        want = ref.ssd_backward_reference(*args, cot[0], cot[1], chunk=128,
                                          initial_state=init)
        assert max(_bwd_rel_errors(got, want[:len(got)])) <= bar
    with torch.no_grad():
        ops.ssd(*leaves[:5], chunk=128)
    assert ssd_cuda.launches == 2 and ssd_backward_cuda.launches == 1


# -- the mesh, the step bundles and the checkpoint's shardings -----------------

@pytest.mark.cuda
def test_debug_mesh_is_over_the_first_card(cuda_device):
    from repro_torch.launch import make_debug_mesh
    mesh = make_debug_mesh()
    assert mesh.devices.shape == (1, 1)
    assert mesh.device == torch.device("cuda", 0)


@pytest.mark.cuda
def test_bundle_step_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """gemma3-1b's smoke cut in float32: one train step of the bundle on
    the card's 1 x 1 mesh against the CPU mesh's, from one set of weights.
    The loss and grad norm agree within 1e-4 relative; the gradients, in
    Adam's first moment (1 - b1) g, within 1e-4 of each leaf's largest
    entry, its second moment within 2e-4; and the card's update is AdamW's
    on the card's own moments: each parameter within 1e-2 lr plus 4 ulp of
    p0 - lr ((m / b1c) / (sqrt(v / b2c) + eps) + wd p0) (a missing or
    flipped update is off by lr or more). Then the card's state
    checkpointed and restored through ``restore(..., shardings=)`` of the
    bundle's ``in_shardings``: on the card, bitwise equal."""
    import dataclasses

    from repro_torch.configs import get
    from repro_torch.launch import make_debug_mesh, make_train_step
    from repro_torch.models import build
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWConfig, adamw
    from repro_torch.train.tree import leaves, map_tree
    cfg = dataclasses.replace(get("gemma3-1b").smoke(), dtype="float32")
    ocfg = AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=4)
    params = build(cfg).init(torch.Generator().manual_seed(0))
    p0 = [t.clone() for t in leaves(params)]     # the steps update in place
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32)
             for k in ("tokens", "labels")}
    out = {}
    for mesh in (make_debug_mesh(), make_debug_mesh(device="cpu")):
        bundle = make_train_step(cfg, mesh, 2, 48, opt_cfg=ocfg)
        p = map_tree(lambda t: t.to(mesh.device), params)
        state = bundle.fn(p, adamw(ocfg)[0](p), batch)
        out[mesh.device.type] = (bundle, state)
    (bundle, (pc, oc, mc)), (_, (_, op, mp)) = out["cuda"], out["cpu"]
    for key in ("loss", "grad_norm"):
        assert abs(float(mc[key]) - float(mp[key])) \
            <= 1e-4 * abs(float(mp[key]))
    lr = float(mc["lr"])
    assert lr == float(mp["lr"]) and abs(lr - ocfg.lr) <= 1e-6 * ocfg.lr
    b1c, b2c = 1 - ocfg.b1, 1 - ocfg.b2                  # step 1
    moved = 0.0
    for a, m, v, mq, vq, x in zip(leaves(pc), leaves(oc.mu), leaves(oc.nu),
                                  leaves(op.mu), leaves(op.nu), p0):
        assert a.device == torch.device("cuda", 0)
        m, v, a = m.cpu(), v.cpu(), a.cpu()
        assert float((m - mq).abs().max()) <= 1e-4 * float(mq.abs().max())
        assert float((v - vq).abs().max()) <= 2e-4 * float(vq.abs().max())
        want = x - lr * ((m / b1c) / ((v / b2c).sqrt() + ocfg.eps)
                         + ocfg.weight_decay * x)
        bar = 1e-2 * lr + 4 * torch.finfo(torch.float32).eps * x.abs()
        assert bool(((a - want).abs() <= bar).all())
        moved = max(moved, float((a - x).abs().max()))
    assert moved >= 0.5 * lr

    ckpt = CheckpointManager(tmp_path)
    ckpt.save(1, (pc, oc), blocking=True)
    like = map_tree(torch.zeros_like, (pc, oc))
    restored = ckpt.restore(like, shardings=bundle.in_shardings[:2])
    for a, b in zip(leaves(restored), leaves((pc, oc))):
        assert a.device == torch.device("cuda", 0) and torch.equal(a, b)
    # onto the CPU's like leaves, the shardings still put them on the card
    cpu_like = map_tree(lambda t: t.cpu(), (pc, oc))
    again = ckpt.restore(cpu_like, shardings=bundle.in_shardings[:2])
    assert all(t.device.type == "cuda" for t in leaves(again))


@pytest.mark.cuda
def test_shard_4_runs_on_the_one_card(cuda_device, capsys):
    """``--shard 4`` resolves to the one card (``repro`` caps the count at
    the devices present) and prints what ``--shard 1`` prints."""
    from repro_torch.launch import autoscale
    if torch.cuda.device_count() != 1:
        pytest.skip("the one-card semantics need exactly one card")
    assert autoscale.one_card("4", cuda_device) == 1
    outs = []
    for shard in ("1", "4"):
        autoscale.main(["--minutes", "2", "--shard", shard])
        outs.append(capsys.readouterr().out)
    assert "cycles=" in outs[0] and outs[1] == outs[0]
