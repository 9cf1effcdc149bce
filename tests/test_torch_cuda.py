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
from repro_torch.kernels.flash_attention import flash_attention_cuda
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "tensor_core"),
                                           (torch.float32, "cuda_core")])
def test_flash_dtype_picks_the_kernel(cuda_device, dtype, variant):
    """bf16 runs the wgmma kernel, float32 the CUDA-core kernel; each call
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
                                      (8, 8, 64, 16)])
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


def _objective_case(replicas, K, seed, dev):
    """The paper's QR/CV/PC layout with ``replicas`` containers of each,
    ridge fits of degrees 1-3 on random data, K projected random candidates
    and random loads; exactly one candidate row sits on ratio == 1 of a
    parameter SLO (the half-subgradient)."""
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
    return args, dict(n_services=len(specs), max_degree=sm.max_degree)


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
