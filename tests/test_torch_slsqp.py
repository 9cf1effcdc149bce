"""The port's SLSQP reference and the seed's loop objective
(src/repro_torch/core/solver.py: ``objective_loop``, ``_neg_objective``,
``_vg_cat``, ``solve_slsqp``, ``solve_many``) and RASK's reference paths
(``RaskConfig(backend="slsqp")``, ``fused=False``) against ``repro``'s,
on the CPU, on the paper triple with ``repro``'s fitted models carried
across.

* ``objective_loop`` equals ``repro``'s and the fused objective within
  1e-5 relative; its autograd gradient equals ``jax.grad`` of ``repro``'s
  loop within 1e-5 (both take the half-subgradient at min(x, 1)'s tie).
* ``_vg_cat`` (the forward at K = 1, the backward from the cotangent -1,
  the soft penalty) equals ``jax.value_and_grad`` of ``repro``'s
  ``_neg_objective`` within 1e-5 of (1 + the largest entry), inside and
  outside the capacity.
* ``solve_slsqp``, fused and loop, from the same models and x0: scores
  within 1e-4 relative, assignments feasible.
* ``solve_many`` (B problems, shared and batched models), both sides fed
  the same uniforms (``repro``'s per-row ``jax.random`` draws): scores
  within 1e-3 relative (``test_torch_solver.py``'s PGD bar).
* RASK with ``backend="slsqp"``, with ``fused=False`` (SLSQP over the
  loop) and with ``fused=False`` and PGD, each in lockstep with ``repro``
  (e3's bursty trace, xi 10, 250 s; the environment applies ``repro``'s
  plans, the warm starts are ``repro``'s): the same explored and solved
  cycles, exploration plans within 1e-5, solver scores within 1e-4
  relative at the median and within 1e-3 in all cycles but one in ten
  (the models are fitted apart: float32 sums in another order, and the
  loop's ``fit_polynomial`` in float64; from the same warm start SLSQP
  may then end in another local optimum, at most 5% apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RaskConfig as JConfig
from repro.core import solver as jsolver
from repro.core.regression import BatchedFitPlan as JPlan
from repro.core.slo import SLO as JSLO
from repro.env import EdgeEnvironment as JEnv
from repro.env import paper_knowledge as j_knowledge
from repro.env import paper_profiles as j_profiles
from repro_torch.core import RaskConfig
from repro_torch.core import solver as tsolver
from repro_torch.core.regression import StackedModels
from repro_torch.core.slo import SLO
from repro_torch.env import EdgeEnvironment, paper_knowledge, paper_profiles
from test_torch_pipeline import JaxRecorder, LockstepAgent, e3_patterns
from test_torch_solver import _specs

torch.set_num_threads(1)
CAP = 8.0


@pytest.fixture(scope="module")
def problems():
    """Both packages' fused and loop problems for the triple, and
    ``repro`` models (degree 2) fitted to 40 random assignments of each
    service against its hidden surface, carried to the port."""
    jp = {f: jsolver.SolverProblem(_specs(jsolver, JSLO), fused=f)
          for f in (True, False)}
    tp = {f: tsolver.SolverProblem(_specs(tsolver, SLO), fused=f)
          for f in (True, False)}
    rng = np.random.default_rng(0)
    rels, data = [], []
    for spec, prof in zip(jp[True].specs, j_profiles().values()):
        for target, feat in spec.relation_features:
            X = rng.uniform(spec.lower, spec.upper,
                            (40, len(spec.lower))).astype(np.float32)
            Y = np.asarray([prof.tp_max(dict(zip(spec.param_names, x)))
                            for x in X], np.float32)
            rels.append(dict(n_features=len(feat), degree=2,
                             x_scale=[spec.upper[j] for j in feat],
                             service=spec.name, target=target))
            data.append((X[:, list(feat)], Y))
    sm = JPlan(rels, row_capacity=64).fit(data)
    tsm = StackedModels(*(torch.from_numpy(np.array(x)) for x in (
        sm.w, sm.exponents, sm.term_mask, sm.x_scale)), sm.max_degree,
        tuple(sm.labels))
    return jp, tp, sm, tsm


def _inputs(jp, seed):
    rng = np.random.default_rng(seed)
    rps = np.asarray([rng.uniform(10, 100), rng.uniform(1, 10), 50.0],
                     np.float32)
    return rps, np.array(jp.random_assignment(rng, CAP), np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_objective_loop_is_repros_and_the_fused_ones(problems, seed):
    jp, tp, sm, tsm = problems
    rps, x0 = _inputs(jp[True], seed)
    spec = tp[True].specs[0]       # a parameter SLO at its target: a tie
    q = next(q for q in spec.slos if q.metric in spec.param_names)
    x0[spec.param_names.index(q.metric)] = q.target
    jmodels = jp[False].models_dict(sm)
    want = float(jp[False].objective_loop(jnp.asarray(x0), jmodels,
                                          jnp.asarray(rps)))
    jgrad = np.asarray(jax.grad(lambda a: jp[False].objective_loop(
        a, jmodels, jnp.asarray(rps)))(jnp.asarray(x0)))
    a = torch.tensor(x0, requires_grad=True)
    got = tp[False].objective_loop(a, tp[False].models_dict(tsm),
                                   torch.from_numpy(rps))
    got.backward()
    fused = float(tp[True].objective(torch.from_numpy(x0), tsm,
                                     torch.from_numpy(rps)))
    assert float(got.detach()) == pytest.approx(want, rel=1e-5)
    assert fused == pytest.approx(want, rel=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), jgrad, rtol=1e-5, atol=1e-5)
    # the loop objective also takes the stacked models directly
    assert float(tp[False].objective(torch.from_numpy(x0), tsm,
                                     torch.from_numpy(rps))) == \
        pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("seed,over", [(0, 1.0), (1, 1.0), (2, 1.6),
                                       (3, 2.5)])
def test_vg_cat_is_value_and_grad(problems, seed, over):
    """``over`` scales the resources past the capacity: the penalty."""
    jp, tp, sm, tsm = problems
    rps, x0 = _inputs(jp[True], seed)
    mask = jp[True].resource_mask
    x0[mask] *= over
    v, g = jax.value_and_grad(jp[True]._neg_objective)(
        jnp.asarray(x0), sm, jnp.asarray(rps), jnp.float32(CAP))
    want = np.concatenate([[float(v)], np.asarray(g)])
    got = tp[True]._vg_cat(torch.from_numpy(x0), tsm, torch.from_numpy(rps),
                           CAP).numpy()
    assert (float(x0[mask].sum()) > CAP) == (over > 1.0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * (1.0 + np.abs(want).max()))


def _feasible(p, a):
    return bool(np.all(a >= p.lower - 1e-5) and np.all(a <= p.upper + 1e-5)
                and a[p.resource_mask].astype(np.float64).sum()
                <= CAP + 1e-4)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_solve_slsqp_scores_repros(problems, fused, seed):
    jp, tp, sm, tsm = problems
    rps, x0 = _inputs(jp[True], seed)
    jm = sm if fused else jp[False].models_dict(sm)
    tm = tsm if fused else tp[False].models_dict(tsm)
    a_j, s_j = jp[fused].solve_slsqp(jm, rps, x0, CAP)
    a_t, s_t = tp[fused].solve_slsqp(tm, rps, x0, CAP)
    assert abs(s_t - s_j) <= 1e-4 * abs(s_j), (s_t, s_j)
    assert _feasible(tp[fused], a_t) and tp[fused].last_nfev > 1


@pytest.mark.parametrize("batched_models", [False, True])
def test_solve_many_matches_repro_from_the_same_uniforms(problems,
                                                         batched_models):
    jp, tp, sm, tsm = problems
    B, seed = 5, 3
    rng = np.random.default_rng(seed)
    rps = np.stack([_inputs(jp[True], s)[0] for s in range(B)])
    x0 = np.stack([jp[True].random_assignment(rng, CAP) for _ in range(B)])
    caps = rng.uniform(4.0, 8.0, B).astype(np.float32)
    jmodels, tmodels = sm, tsm
    if batched_models:              # per-row weights, one layout
        from repro.core.regression import StackedModels as JStacked
        scale = rng.uniform(0.8, 1.2, (B, 1)).astype(np.float32)
        leaves = [np.array(sm.w)[None] * scale[..., None]] + [
            np.broadcast_to(np.array(x), (B,) + x.shape).copy()
            for x in (sm.exponents, sm.term_mask, sm.x_scale)]
        jmodels = JStacked(*(jnp.asarray(x) for x in leaves),
                           sm.max_degree)
        tmodels = StackedModels(*(torch.from_numpy(x) for x in leaves),
                                sm.max_degree)
    a_j, s_j = jp[True].solve_many(jmodels, rps, x0, caps, seed=seed)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    u = np.stack([np.array(jax.random.uniform(k, (3, tp[True].dim)))
                  for k in keys])
    a_t, s_t = tp[True].solve_many(tmodels, rps, x0, caps,
                                   u=torch.from_numpy(u))
    assert a_t.shape == (B, tp[True].dim) and s_t.shape == (B,)
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=1e-3)
    for b in range(B):
        assert a_t[b][tp[True].resource_mask].sum() <= caps[b] * (1 + 1e-5)


class PgdUniforms(LockstepAgent):
    """Lockstep twin of ``repro``'s classic PGD solve, which draws its
    starts from ``PRNGKey(seed)`` itself (not from a split of it)."""

    def _start_uniforms(self, seed):
        self._gen.manual_seed(seed)
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.PRNGKey(seed),
            (max(self._budget_starts - 3, 0), self.problem.dim))))


@pytest.mark.parametrize("cfg", [dict(backend="slsqp"),
                                 dict(backend="slsqp", fused=False),
                                 dict(fused=False)],
                         ids=["slsqp", "slsqp_loop", "pgd_loop"])
def test_reference_paths_lockstep_with_repro(cfg):
    cfg = dict(xi=10, eta=0.0, **cfg)
    seconds = 250.0
    jenv = JEnv(list(j_profiles().values()), {"cores": CAP},
                patterns=e3_patterns("bursty", seconds, False), seed=0)
    jagent = JaxRecorder(jenv.platform, j_knowledge(), JConfig(**cfg),
                         seed=0)
    jhist = jenv.run(jagent, duration_s=seconds)
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": CAP},
                          patterns=e3_patterns("bursty", seconds, True),
                          seed=0)
    agent = PgdUniforms(env.platform, paper_knowledge(), RaskConfig(**cfg),
                        seed=0, device="cpu", ref=jagent)
    hist = env.run(agent, duration_s=seconds)
    assert [h.explored for h in hist] == [h.explored for h in jhist]
    assert sum(not h.explored for h in hist) == len(hist) - cfg["xi"]
    for got, want in zip(agent.plans[:cfg["xi"]], jagent.plans[:cfg["xi"]],
                         strict=True):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    scores = np.array([(i.score, j.score) for i, j in
                       zip(agent.infos, jagent.infos) if not j.explored])
    gaps = np.abs(scores[:, 0] - scores[:, 1]) / np.abs(scores[:, 1])
    # SLSQP is a local method: where the two fits of a relation with few
    # rows differ in rounding, it may end in another local optimum from
    # the same warm start (ROADMAP Queue 3): one cycle in ten at most
    assert np.median(gaps) <= 1e-4 and (gaps > 1e-3).sum() <= \
        max(1, len(gaps) // 10) and gaps.max() <= 0.05, gaps
    assert not agent._pipelined() and agent._stream is None
    if not cfg.get("fused", True):
        assert agent.stacked is None and set(agent.models) == \
            set(env.platform.services())


def test_compare_solvers_runs_on_cpu(capsys):
    """``launch/compare_solvers.py`` at |S| = 3, 6, 9 (two solved cycles a
    backend): each backend's decide ms and fulfilment, one line a size."""
    from repro_torch.launch import compare_solvers
    res = compare_solvers.main(["--device", "cpu", "--seconds", "170"])
    assert sorted(res) == [3, 6, 9]
    for row in res.values():
        for ms, f in row.values():
            assert ms > 0 and 0.0 <= f <= 1.0
    assert capsys.readouterr().out.count("speedup") == 3
