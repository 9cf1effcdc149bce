"""The port's single-relation fit and degree selection
(src/repro_torch/core/regression.py: ``fit_polynomial``, ``mse``,
``train_test_split``, ``select_degree``) and ``RaskConfig(auto_degree=
True)`` against ``repro``'s, on the CPU.

``repro`` solves each relation's ridge system in float32. From degree 3
up the Gram matrices of these surfaces are so ill-conditioned that float32
rounding moves the predictions by up to ~0.8% of their span and the test
errors of ``select_degree`` by tens of percent: no other float32 sum order
reproduces them. The port solves these systems in float64 (``_fit64``), so
the tests hold it to an independent float64 solve (numpy) and to ``repro``
as far as ``repro``'s own rounding allows:

* ``fit_polynomial`` at degrees 1-6 on the paper services' throughput
  surfaces: predictions within 2e-5 of the span of the float64 solve's;
  within 1e-4 of ``repro``'s at degrees 1-2; from degree 3 no further from
  the float64 solve than ``repro``'s. ``mse`` within 1e-4 relative of
  ``repro``'s at degrees 1-2.
* ``train_test_split``: the same indices.
* ``select_degree``: test errors within 1e-6 relative of the float64
  solve's, the float64 pick, and ``repro``'s pick wherever ``repro``'s
  float32 errors cannot reorder the degrees (``_decided``).
* An ``auto_degree`` RASK run in lockstep with ``repro`` (e3's bursty
  trace, xi 12, 320 s; the environment applies ``repro``'s plans): the
  selections happen at the same rounds on the same design rows, each one
  checked as above, and the degrees the agents fit with are ``repro``'s
  at every round where each service's last selection was decided.
"""
import numpy as np
import pytest
import torch

from repro.core import regression as jr
from repro.core import rask as jrask
from repro.core import RaskConfig as JConfig
from repro.env import EdgeEnvironment as JEnv
from repro.env import paper_knowledge as j_knowledge
from repro.env import paper_profiles as j_profiles
from repro_torch.core import RaskConfig
from repro_torch.core import rask as trask
from repro_torch.core import regression as tr
from repro_torch.env import EdgeEnvironment, paper_knowledge, paper_profiles
from test_torch_pipeline import JaxRecorder, LockstepAgent, e3_patterns

torch.set_num_threads(1)


def _surfaces(seed, n=60):
    """Per paper service: tp_max features (n rows, uniform in the box), the
    hidden surface with 3% noise, and the features' upper bounds."""
    rng = np.random.default_rng(seed)
    out = []
    for p in j_profiles().values():
        names = list(p.api.names)
        lo = np.asarray([p.api.parameter(x).min_value for x in names])
        hi = np.asarray([p.api.parameter(x).max_value for x in names])
        cols = [names.index(f) for f in p.knowledge["tp_max"]]
        X = rng.uniform(lo, hi, (n, len(names))).astype(np.float32)
        Y = (np.asarray([p.tp_max(dict(zip(names, x))) for x in X])
             * rng.normal(1.0, 0.03, n)).astype(np.float32)
        out.append((p.type, X[:, cols], Y, hi[cols].astype(np.float32)))
    return out


def _phi64(X, scale, degree):
    xs = (np.asarray(X, np.float32) / np.asarray(scale, np.float32)
          ).astype(np.float64)
    exps = jr.polynomial_exponents(xs.shape[1], degree)
    return np.stack([np.prod(xs ** e, axis=1) for e in exps], axis=1)


def _fit64(X, Y, scale, degree, ridge=1e-6):
    """The ridge system of ``repro``'s ``_fit``, solved by numpy in
    float64."""
    P = _phi64(X, scale, degree)
    A = P.T @ P
    lam = np.float64(np.float32(ridge)) * (1.0 + np.trace(A) / A.shape[0])
    return np.linalg.solve(A + lam * np.eye(A.shape[0]),
                           P.T @ np.asarray(Y, np.float64))


def _select64(X, Y, scale, seed=0):
    Xtr, Ytr, Xte, Yte = jr.train_test_split(X, Y, seed=seed)
    errs = {}
    for d in range(1, 7):
        w = _fit64(Xtr, Ytr, scale, d)
        errs[d] = float(np.mean((_phi64(Xte, scale, d) @ w - Yte) ** 2))
    return min(errs, key=errs.get), errs


def _decided(errs64, jerrs):
    """Whether ``repro``'s float32 errors cannot reorder the float64 best
    degree below another: every other degree's float64 error, less its
    float32 deviation, stays above the best's plus its own."""
    best = min(errs64, key=errs64.get)
    dev = {d: abs(jerrs[d] - errs64[d]) for d in errs64}
    return all(errs64[d] - dev[d] > errs64[best] + dev[best]
               for d in errs64 if d != best)


@pytest.mark.parametrize("degree", range(1, 7))
def test_fit_polynomial_degrees(degree):
    for name, X, Y, scale in _surfaces(seed=degree):
        want = _phi64(X, scale, degree) @ _fit64(X, Y, scale, degree)
        span = float(np.abs(want).max())
        tm = tr.fit_polynomial(X, Y, degree, x_scale=scale,
                               features=("a",), target="tp_max")
        jm = jr.fit_polynomial(X, Y, degree, x_scale=scale)
        got = tm.predict(X).numpy()
        jgot = np.asarray(jm.predict(X))
        assert tm.w.dtype == torch.float32 and tm.degree == degree
        np.testing.assert_array_equal(tm.exponents, jm.exponents)
        assert np.abs(got - want).max() <= 2e-5 * span, name
        if degree <= 2:
            assert np.abs(got - jgot).max() <= 1e-4 * span, name
            assert tr.mse(tm, X, Y) == pytest.approx(jr.mse(jm, X, Y),
                                                     rel=1e-4)
        else:
            assert np.abs(got - want).max() <= \
                np.abs(jgot - want).max() + 2e-5 * span, name


@pytest.mark.parametrize("n,frac,seed", [(10, 0.2, 0), (13, 0.2, 3),
                                         (51, 0.3, 7), (300, 0.2, 1)])
def test_train_test_split_is_repros(n, frac, seed):
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    Y = rng.normal(size=n).astype(np.float32)
    for got, want in zip(tr.train_test_split(X, Y, frac, seed),
                         jr.train_test_split(X, Y, frac, seed)):
        np.testing.assert_array_equal(got, want)


def _check_selection(X, Y, scale, got, jgot):
    """One selection: the port's errors and pick against the float64
    solve's, and against ``repro``'s where decided. Returns whether it
    was."""
    (best, errs), (jbest, jerrs) = got, jgot
    best64, errs64 = _select64(X, Y, scale)
    for d in errs64:
        assert errs[d] == pytest.approx(errs64[d], rel=1e-6, abs=1e-12)
    assert best == best64
    decided = _decided(errs64, jerrs)
    if decided:
        assert best == jbest
    return decided


def test_select_degree_matches_float64_and_repro():
    cases = [(X, Y, s) for _, X, Y, s in _surfaces(seed=11)]
    rng = np.random.default_rng(0)         # tests/test_regression.py's case
    X = rng.uniform(0, 8, (300, 1)).astype(np.float32)
    cases.append((X, ((X[:, 0] - 4.0) ** 4 + rng.normal(0, 0.5, 300)
                      ).astype(np.float32), np.float32([8.0])))
    decided = [_check_selection(X, Y, s, tr.select_degree(X, Y, x_scale=s),
                                jr.select_degree(X, Y, x_scale=s))
               for X, Y, s in cases]
    assert sum(decided) >= 3


class _Selections:
    """Records each selection of an agent: (round, service) -> the design
    rows, the scale, the pick and the errors (a re-run of ``repro``'s cold
    cycle overwrites its own identical entry)."""

    def __init__(self, module, monkeypatch):
        self.calls, self.agent = {}, None
        inner = module.select_degree

        def select(X, Y, *args, **kwargs):
            best, errs = inner(X, Y, *args, **kwargs)
            self.calls[self.key] = (np.array(X), np.array(Y),
                                    np.array(kwargs["x_scale"]), best,
                                    dict(errs))
            return best, errs
        monkeypatch.setattr(module, "select_degree", select)


def _recording(cls, sel):
    """``cls`` keying each selection by round and service, and noting the
    fit plan's degrees (one a relation: here one a service) after every
    decide."""
    class Agent(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.plan_degrees = []

        def _degree(self, sid, X, Y, scale):
            sel.key = (self.rounds, sid)
            return super()._degree(sid, X, Y, scale)

        def decide(self, obs):
            plan = super().decide(obs)
            key = self._fit_plan_key
            self.plan_degrees.append(None if key is None else key[1])
            return plan
    return Agent


def test_auto_degree_lockstep_chooses_repros_degrees(monkeypatch):
    cfg, seconds = dict(xi=12, eta=0.0, auto_degree=True), 320.0
    jsel = _Selections(jrask, monkeypatch)
    tsel = _Selections(trask, monkeypatch)
    jenv = JEnv(list(j_profiles().values()), {"cores": 8.0},
                patterns=e3_patterns("bursty", seconds, False), seed=0)
    jagent = _recording(JaxRecorder, jsel)(
        jenv.platform, j_knowledge(), JConfig(**cfg), seed=0)
    jenv.run(jagent, duration_s=seconds)
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                          patterns=e3_patterns("bursty", seconds, True),
                          seed=0)
    agent = _recording(LockstepAgent, tsel)(
        env.platform, paper_knowledge(), RaskConfig(**cfg), seed=0,
        device="cpu", ref=jagent)
    env.run(agent, duration_s=seconds)

    assert sorted(tsel.calls) == sorted(jsel.calls)
    rounds = sorted({r for r, _ in jsel.calls})
    assert rounds[0] == cfg["xi"] and \
        {r for r in rounds if r % 10 == 0} >= {20, 30}
    decided = {}
    for key, (X, Y, scale, *got) in tsel.calls.items():
        jX, jY, jscale, *jgot = jsel.calls[key]
        np.testing.assert_array_equal(X, jX)
        np.testing.assert_array_equal(Y, jY)
        np.testing.assert_array_equal(scale, jscale)
        decided[key] = _check_selection(X, Y, scale, got, jgot)
    assert sum(decided.values()) >= len(decided) / 2, decided
    # the degrees fitted with, every round, wherever each service's last
    # selection was decided (an undecided pick carries until the next one)
    sids = agent.services
    last, compared = {}, 0
    for r, (got, want) in enumerate(zip(agent.plan_degrees,
                                        jagent.plan_degrees, strict=True)):
        for i, sid in enumerate(sids):
            if (r, sid) in decided:
                last[sid] = decided[(r, sid)]
            if last.get(sid):
                assert got[i] == want[i], (r, sid)
                compared += 1
    assert compared >= len(sids) * 10
