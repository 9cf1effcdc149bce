"""The port's PGD solver (src/repro_torch/core/solver.py) against the JAX
package's.

* ``project_capacity`` on random boxes, masks and capacities, at the
  solver's two depths (6 and 40 bisection steps): within 1e-5 of the box
  width (float32, the same bisection).
* ``pgd_solve`` on the paper's QR/CV/PC triple with models fitted to the
  profiles' throughput surfaces: the port is fed the uniforms ``repro``
  draws inside its fused decide (``jax.random.split(PRNGKey(seed))``), and
  the two scores agree within 1e-3 relative; both assignments are feasible.
* The phi tables and the exploration draw (``random_assignment``) are
  ``repro``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver as jsolver
from repro.core.regression import BatchedFitPlan as JPlan
from repro.env import paper_knowledge, paper_profiles
from repro_torch.core import solver as tsolver
from repro_torch.core.regression import StackedModels
from repro_torch.core.slo import SLO

torch.set_num_threads(1)


@pytest.mark.parametrize("iters", [6, 40])
@pytest.mark.parametrize("seed", range(3))
def test_project_capacity_matches_jax(seed, iters):
    rng = np.random.default_rng(seed)
    n, d = 64, int(rng.integers(2, 12))
    lower = rng.uniform(0.0, 2.0, d).astype(np.float32)
    upper = (lower + rng.uniform(0.5, 10.0, d)).astype(np.float32)
    mask = rng.random(d) < 0.6
    mask[0] = True
    a = rng.uniform(-3.0, 14.0, (n, d)).astype(np.float32)
    cap = rng.uniform(0.5, 1.2, n).astype(np.float32) * \
        upper[mask].sum().astype(np.float32)
    want = np.asarray(jax.vmap(lambda x, c: jsolver.project_capacity(
        x, lower, upper, mask, c, iters=iters))(a, cap))
    got = tsolver.project_capacity(
        torch.from_numpy(a), torch.from_numpy(lower), torch.from_numpy(upper),
        torch.from_numpy(mask), torch.from_numpy(cap), iters=iters).numpy()
    width = upper - lower
    assert np.all(np.abs(got - want) <= 1e-5 * width + 1e-6)
    assert np.all(got >= lower - 1e-6) and np.all(got <= upper + 1e-6)


def _specs(module, slo_cls):
    specs = []
    for p in paper_profiles().values():
        names = tuple(p.api.names)
        specs.append(module.ServiceSpec(
            name=p.type, param_names=names,
            lower=tuple(x.min_value for x in p.api.parameters),
            upper=tuple(x.max_value for x in p.api.parameters),
            resource_mask=tuple(x.is_resource for x in p.api.parameters),
            slos=tuple(slo_cls(q.metric, q.target, q.weight)
                       for q in p.slos),
            relation_features=tuple(
                (t, tuple(names.index(f) for f in fs))
                for t, fs in paper_knowledge()[p.type].items())))
    return specs


@pytest.fixture(scope="module")
def paper_problem():
    """Both packages' problems for the triple, and ``repro`` models fitted
    (degree 2, RASK's default) to 40 random assignments of each service
    against its hidden throughput surface."""
    from repro.core.slo import SLO as JSLO
    jp = jsolver.SolverProblem(_specs(jsolver, JSLO))
    tp = tsolver.SolverProblem(_specs(tsolver, SLO))
    rng = np.random.default_rng(0)
    rels, data = [], []
    for spec, prof in zip(jp.specs, paper_profiles().values()):
        for target, feat in spec.relation_features:
            X = rng.uniform(spec.lower, spec.upper,
                            (40, len(spec.lower))).astype(np.float32)
            Y = np.asarray([prof.tp_max(dict(zip(spec.param_names, x)))
                            for x in X], np.float32)
            rels.append(dict(n_features=len(feat), degree=2,
                             x_scale=[spec.upper[j] for j in feat]))
            data.append((X[:, list(feat)], Y))
    sm = JPlan(rels, row_capacity=64).fit(data)
    tsm = StackedModels(*(torch.from_numpy(np.array(x)) for x in (
        sm.w, sm.exponents, sm.term_mask, sm.x_scale)), sm.max_degree)
    return jp, tp, sm, tsm


def test_tables_are_repros(paper_problem):
    jp, tp, _, _ = paper_problem
    for name in jsolver.ProblemTables._fields:
        np.testing.assert_array_equal(getattr(tp.tables, name).numpy(),
                                      np.asarray(getattr(jp.tables, name)))
    assert tp.relations == jp.relations and tp.offsets == jp.offsets


@pytest.mark.parametrize("seed", range(4))
def test_pgd_solve_matches_jax_on_the_paper_triple(paper_problem, seed):
    jp, tp, sm, tsm = paper_problem
    rng = np.random.default_rng(seed)
    rps = np.asarray([rng.uniform(10, 100), rng.uniform(1, 10), 50.0],
                     np.float32)
    cap = 8.0
    x0 = jp.random_assignment(rng, cap)
    k_solve, _ = jax.random.split(jax.random.PRNGKey(seed))
    a_j, s_j = jax.jit(lambda x, k: jsolver.pgd_solve(
        x, k, jp.tables, sm, jnp.asarray(rps), jnp.float32(cap), n_starts=6,
        iters=32, lr=0.18, n_services=3))(jnp.asarray(x0), k_solve)
    u = np.array(jax.random.uniform(k_solve, (3, jp.dim)))
    a_t, s_t = tsolver.pgd_solve(
        torch.from_numpy(x0), torch.from_numpy(u), tp.tables, tsm,
        torch.from_numpy(rps), cap, n_starts=6, iters=32, lr=0.18,
        n_services=3)
    s_j, s_t, a_t = float(s_j), float(s_t), a_t.numpy()
    assert abs(s_t - s_j) <= 1e-3 * abs(s_j), (s_t, s_j)
    for a in (np.asarray(a_j), a_t):
        assert np.all(a >= jp.lower - 1e-5) and np.all(a <= jp.upper + 1e-5)
        assert a[jp.resource_mask].sum() <= cap
    # the port's score is the objective of its own assignment
    obj = float(tp.objective(torch.from_numpy(a_t), tsm,
                             torch.from_numpy(rps)))
    assert abs(obj - s_t) <= 1e-5 * abs(s_t)


@pytest.mark.parametrize("seed", range(4))
def test_pgd_solve_takes_each_step_from_the_vjp_alone(paper_problem, seed,
                                                      monkeypatch):
    """Each ascent step's gradient comes from ``ops.rask_objective_vjp``
    with no forward: the objective's forward runs once a solve (the
    finals' scores), and the assignment and score are bit for bit those of
    the gradient taken through the forward and autograd."""
    from repro_torch.kernels import ops
    jp, tp, _, tsm = paper_problem
    rng = np.random.default_rng(seed)
    rps = torch.tensor([rng.uniform(10, 100), rng.uniform(1, 10), 50.0],
                       dtype=torch.float32)
    x0 = torch.from_numpy(jp.random_assignment(rng, 8.0))
    u = torch.from_numpy(rng.random((3, jp.dim)).astype(np.float32))

    def solve():
        return tsolver.pgd_solve(x0, u, tp.tables, tsm, rps, 8.0,
                                 n_starts=6, iters=32, lr=0.18,
                                 n_services=3)

    forward = ops.rask_objective
    calls = {"forward": 0, "vjp": 0}

    def counted_forward(*a, **kw):
        calls["forward"] += 1
        return forward(*a, **kw)

    def counted_vjp(*a, **kw):
        calls["vjp"] += 1
        return vjp(*a, **kw)

    vjp = ops.rask_objective_vjp
    monkeypatch.setattr(ops, "rask_objective", counted_forward)
    monkeypatch.setattr(ops, "rask_objective_vjp", counted_vjp)
    a_vjp, s_vjp = solve()
    assert calls == {"forward": 1, "vjp": 32}

    def through_autograd(A, ct, *tables, **kw):    # the gradient as before
        a = A.detach().requires_grad_(True)
        seg = forward(a, *tables, **kw)
        g, = torch.autograd.grad(seg, a, grad_outputs=ct)
        return g

    monkeypatch.setattr(ops, "rask_objective_vjp", through_autograd)
    a_old, s_old = solve()
    assert torch.equal(a_vjp, a_old) and torch.equal(s_vjp, s_old)


def test_solve_pgd_host_entry_and_all_nan_fallback(paper_problem):
    """``SolverProblem.solve_pgd`` returns host values; with NaN models
    every start scores NaN and the solve falls back to the projected warm
    start with score -inf, as ``repro``'s does."""
    jp, tp, sm, tsm = paper_problem
    rps = np.asarray([60.0, 5.0, 50.0], np.float32)
    x0 = jp.random_assignment(np.random.default_rng(1), 8.0)
    a, s = tp.solve_pgd(tsm, rps, x0, 8.0, seed=3)
    assert isinstance(s, float) and np.isfinite(s) and a.shape == (jp.dim,)
    bad = StackedModels(torch.full_like(tsm.w, float("nan")), tsm.exponents,
                        tsm.term_mask, tsm.x_scale, tsm.max_degree)
    a, s = tp.solve_pgd(bad, rps, x0, 8.0, seed=3)
    assert s == float("-inf")
    want = np.asarray(jsolver.project_capacity(
        jnp.asarray(x0), jp.lower, jp.upper, jp.resource_mask,
        jnp.float32(8.0) * (1.0 - jsolver._CAP_MARGIN)))
    np.testing.assert_allclose(a, want, atol=1e-5)


def test_random_assignment_is_repros(paper_problem):
    jp, tp, _, _ = paper_problem
    for seed in range(3):
        want = jp.random_assignment(np.random.default_rng(seed), 8.0)
        got = tp.random_assignment(np.random.default_rng(seed), 8.0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
