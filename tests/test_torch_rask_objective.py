"""The port's RASK objective (src/repro_torch/kernels) against the JAX
package's.

On the CPU ``repro_torch.kernels.ops.rask_objective`` runs the plain
versions (``ref.rask_objective_reference`` forward, the analytic
``ref.rask_objective_grad`` backward). They are held here against
``repro.kernels.ops.rask_objective`` (its jnp reference and the Pallas
kernel in interpret mode), ``repro``'s ``rask_objective_grad`` and
``jax.grad`` of the reference, on random stacked models and SLO tables laid
out by the solver's own table builder (the cases of
``tests/test_kernels.py``), at 1e-5: the same float32 arithmetic, summed in
another order. The CUDA kernels are held against these plain versions on
the card (``test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.regression import fit_polynomial
from repro.core.slo import SLO
from repro.core.solver import ServiceSpec, SolverProblem
from repro.kernels import ops as jops
from repro.kernels.rask_objective import rask_objective_grad
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
jgrad = jax.jit(rask_objective_grad, static_argnames=("n_services",
                                                     "max_degree"))


def _case(seed):
    """Random stacked models + SLO tables + K candidates (kinds 0, 1 and 2,
    degrees 1-3, K not a multiple of the Pallas block); returns the JAX
    arguments as numpy arrays and the static sizes."""
    rng = np.random.default_rng(seed * 2003)
    n_services = int(rng.integers(1, 6))
    specs = []
    for i in range(n_services):
        slos = [SLO("completion", 1.0, 1.0)]
        if rng.random() < 0.7:
            slos.append(SLO("quality", float(rng.uniform(400, 900)), 0.5))
        if rng.random() < 0.4:
            slos.append(SLO("tp_max", float(rng.uniform(50, 150)), 0.3))
        specs.append(ServiceSpec(
            name=f"s{i}", param_names=("cores", "quality"),
            lower=(0.1, 100.0), upper=(8.0, 1000.0),
            resource_mask=(True, False), slos=tuple(slos),
            relation_features=(("tp_max", (0, 1)),)))
    problem = SolverProblem(specs)
    models = {}
    for s in specs:
        X = np.c_[rng.uniform(0.1, 8, 60), rng.uniform(100, 1000, 60)]
        Y = rng.uniform(10, 30) * X[:, 0] - X[:, 1] / rng.uniform(50, 200)
        models[s.name] = {"tp_max": fit_polynomial(
            X.astype(np.float32), Y.astype(np.float32),
            int(rng.integers(1, 4)), x_scale=[8.0, 1000.0])}
    sm = problem.stack(models)
    K = int(rng.integers(1, 20))
    A = np.stack([problem.random_assignment(rng, float(rng.uniform(2, 20)))
                  for _ in range(K)])
    rps = rng.uniform(1, 100, n_services).astype(np.float32)
    t = problem.tables
    args = [np.array(x) for x in (
        A, t.rel_gather, sm.w, sm.exponents, sm.term_mask, sm.x_scale,
        t.slo_kind, t.slo_service, t.slo_weight, t.slo_target, t.slo_pidx,
        t.slo_ridx, rps)]
    return args, dict(n_services=n_services, max_degree=sm.max_degree)


def _torch(args):
    return [torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("seed", range(6))
def test_forward_matches_jax_reference_and_pallas(seed):
    args, kw = _case(seed)
    got = ops.rask_objective(*_torch(args), **kw).numpy()
    want = np.asarray(jops.rask_objective(*args, impl="reference", **kw))
    assert got.shape == (args[0].shape[0], kw["n_services"])
    np.testing.assert_allclose(got, want, **TOL)
    if seed < 3:
        pallas = np.asarray(jops.rask_objective(
            *args, impl="pallas_interpret", **kw))
        np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("seed", range(4))
def test_backward_matches_jax_vjp_and_autodiff(seed):
    args, kw = _case(seed)
    ct = np.random.default_rng(seed).standard_normal(
        (args[0].shape[0], kw["n_services"])).astype(np.float32)
    A = torch.from_numpy(args[0]).requires_grad_(True)
    seg = ops.rask_objective(A, *_torch(args[1:]), **kw)
    got, = torch.autograd.grad(seg, A, grad_outputs=torch.from_numpy(ct))
    want = np.asarray(jgrad(args[0], ct, *args[1:], **kw))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    autodiff = np.asarray(jax.grad(lambda a: jnp.sum(
        jops.rask_objective(a, *args[1:], impl="reference", **kw)
        * ct))(jnp.asarray(args[0])))
    np.testing.assert_allclose(got.numpy(), autodiff, **TOL)


def test_backward_takes_the_half_subgradient_at_the_clip():
    """ratio == 1 on a parameter SLO: half the cotangent, as jax.grad of
    jnp.minimum gives; either side of it, all or nothing."""
    args, kw = _case(1)
    q = int(np.flatnonzero(args[6] == 0)[0])          # a parameter SLO
    p, target = int(args[10][q]), float(args[9][q])
    A = np.repeat(args[0][:1], 3, axis=0)
    A[:, p] = [target, np.nextafter(target, 0.0, dtype=np.float32),
               np.nextafter(target, np.inf, dtype=np.float32)]
    ct = np.ones((3, kw["n_services"]), np.float32)
    got = ref.rask_objective_grad(torch.from_numpy(A), torch.from_numpy(ct),
                                  *_torch(args[1:]), **kw).numpy()
    want = np.asarray(jgrad(A, ct, *args[1:], **kw))
    np.testing.assert_allclose(got, want, **TOL)
    share = float(args[8][q]) / target
    np.testing.assert_allclose(got[:, p] - got[0, p] + 0.5 * share,
                               [0.5 * share, share, 0.0], atol=1e-6)


def test_padded_features_and_terms_contribute_nothing():
    """A padded feature (exponent 0) re-reads A[0] and must give a factor
    of exactly 1; a padded term (mask 0) nothing: changing A[0] through a
    padded slot alone leaves every prediction as it was."""
    args, kw = _case(2)
    A, rel, w, E, tm, xs = (a.copy() for a in args[:6])
    # widen every relation by one padded feature that re-reads index 0
    rel = np.concatenate([rel, np.zeros_like(rel[:, :1])], axis=1)
    E = np.concatenate([E, np.zeros_like(E[..., :1])], axis=2)
    xs = np.concatenate([xs, np.ones_like(xs[:, :1])], axis=1)
    wide = [A, rel, w, E, tm, xs] + args[6:]
    got = ops.rask_objective(*_torch(wide), **kw).numpy()
    want = ops.rask_objective(*_torch(args), **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_cuda_wrapper_checks_each_shape_against_the_card_once(monkeypatch):
    """The CUDA wrappers' size-only checks (features a relation, empty
    tables, shared memory against the card's opt-in limit) ask the kernel
    library once per (name, device, sizes, direction), so a steady decide's
    call makes no ctypes call besides its launch; a refused shape raises on
    every call."""
    from repro_torch.kernels import rask_objective as ro
    calls = []

    class Lib:
        def rask_objective_max_features(self):
            calls.append("max_features")
            return 8

        def rask_objective_smem_bytes(self, D, R, F, T, Q, S, backward):
            calls.append("smem_bytes")
            return 1000 * D + backward

        def rask_objective_smem_limit(self, device):
            calls.append("smem_limit")
            return 50_000

    monkeypatch.setattr(ro, "_lib", Lib)
    ro._shape_checks.cache_clear()
    try:
        dims = (21, 9, 3, 10, 21, 9)
        for _ in range(3):
            ro._shape_checks("rask_objective_grad", 0, *dims, True)
        assert calls == ["max_features", "smem_bytes", "smem_limit"]
        ro._shape_checks("rask_objective", 0, *dims, False)
        assert len(calls) == 6
        for _ in range(2):
            with pytest.raises(ValueError, match="51001 bytes of shared "
                                                 "memory.*allows 50000"):
                ro._shape_checks("rask_objective_grad", 0, 51, 9, 3, 10, 21,
                                 9, True)
        with pytest.raises(ValueError, match="9 features per relation; the "
                                             "kernel takes at most 8"):
            ro._shape_checks("rask_objective", 0, 21, 9, 9, 10, 21, 9, False)
        with pytest.raises(ValueError, match="empty table"):
            ro._shape_checks("rask_objective", 0, 21, 9, 3, 10, 0, 9, False)
    finally:
        ro._shape_checks.cache_clear()
