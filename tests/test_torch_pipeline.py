"""The port's pipelined decide and its forecaster in the decide
(src/repro_torch/core/rask.py: ``RaskConfig(pipeline=True, forecast=True)``)
against ``repro``'s, on the paper triple under e3's seeded bursty trace
(QR 100 RPS, CV 10 RPS bursty, PC constant; xi = 12, eta = 0, 400 s), on
the CPU.

A closed loop amplifies float32 differences: two runs that part by one
ULP in a fit solve a flat objective to different argmaxes, apply
different plans and from there see different telemetry. So most checks
run the port in LOCKSTEP with a recorded ``repro`` run (``LockstepAgent``):
the port decides for itself — its own fit, forecaster, gate, pipeline,
budget and placement — but the environment applies ``repro``'s plan of
that cycle, and the warm start is ``repro``'s (``_x0`` and the cached
optimum after each decide), as are the random starts (``jax.random``
draws at the current budget). Each decide then sees ``repro``'s inputs,
and cycle by cycle:

* the explored, pipelined and ``forecast_used`` flags and the PGD budget
  levels are equal to ``repro``'s;
* exploration plans equal ``repro``'s within 1e-5 (the bar of
  ``tests/test_torch_rask.py``), solver scores within 1e-3 relative (the
  solved plans themselves wander a flat basin, so they are compared
  through their score), and the gate's rolling forecast errors at the
  end within 1e-3 relative;
* a pipelined plan is the one dispatched a cycle earlier, and the first
  solved cycle is a pipeline-fill round.

A free-running pair (no lockstep) holds the mean post-exploration
fulfillment within 0.03 of ``repro``'s (``test_torch_rask.py``'s bar), and
e10's quiet tail uploads no design window.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import RASKAgent as JAgent
from repro.core import RaskConfig as JConfig
from repro.env import EdgeEnvironment as JEnv
from repro.env import paper_knowledge as j_knowledge
from repro.env import paper_profiles as j_profiles
from repro.env.workloads import bursty as j_bursty
from repro.env.workloads import constant as j_constant
from repro.env.workloads import diurnal as j_diurnal
from repro_torch.core import RASKAgent, RaskConfig
from repro_torch.core.regression import TRACE_COUNTS
from repro_torch.env import EdgeEnvironment, bursty, constant, diurnal, \
    paper_knowledge, paper_profiles

torch.set_num_threads(1)
XI, SECONDS = 12, 400.0
PIPE = dict(xi=XI, eta=0.0, forecast=True, pipeline=True)


class JaxRecorder(JAgent):
    """``repro``'s agent, recording what a lockstep twin replays: every
    emitted plan, every warm start, the cached optimum and the decision
    after every decide, the prior-ridge inputs by round, and the warm
    start right after each ``refresh_topology``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.plans, self.x0s, self.cached, self.infos = [], [], [], []
        self.priors, self.refreshed = {}, []

    def _plan(self, a):
        self.plans.append(np.array(a, np.float32))
        return super()._plan(a)

    def _x0(self):
        x = super()._x0()
        self.x0s.append(np.array(x, np.float32))
        return x

    def decide(self, obs):
        plan = super().decide(obs)
        self.cached.append(None if self._cached_x is None
                           else np.array(self._cached_x))
        self.infos.append(self.last_decision)
        return plan

    def _prior_args(self):
        wp, pl = super()._prior_args()
        self.priors[self.rounds] = (np.array(wp), np.array(pl))
        return wp, pl

    def refresh_topology(self):
        super().refresh_topology()
        self.refreshed.append(None if self._cached_x is None
                              else np.array(self._cached_x))


class LockstepAgent(RASKAgent):
    """The port's agent replaying a ``JaxRecorder`` run: it decides for
    itself, but the plan applied is ``repro``'s of the same cycle and the
    warm start is ``repro``'s; it solves from ``repro``'s uniforms at the
    current budget. Records its own plans, decisions, prior-ridge inputs
    by round and post-refresh warm starts."""

    ref: JaxRecorder

    def __init__(self, *args, ref=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.ref = ref
        self.plans, self.infos, self.priors, self.refreshed = [], [], {}, []
        self._n_x0 = 0

    def _start_uniforms(self, seed):
        self._gen.manual_seed(seed)
        k_solve, _ = jax.random.split(jax.random.PRNGKey(seed))
        return torch.from_numpy(np.array(jax.random.uniform(
            k_solve, (max(self._budget_starts - 3, 0), self.problem.dim))))

    def _plan(self, a):
        self.plans.append(np.array(a, np.float32))
        return super()._plan(self.ref.plans[len(self.plans) - 1])

    def _x0(self):
        super()._x0()                 # the same rng draws as repro's
        self._n_x0 += 1
        return self.ref.x0s[self._n_x0 - 1]

    def decide(self, obs):
        plan = super().decide(obs)
        self.infos.append(self.last_decision)
        cached = self.ref.cached[len(self.plans) - 1]
        if cached is not None:
            self._cached_x = cached
        return plan

    def _prior_args(self):
        wp, pl = super()._prior_args()
        self.priors[self.rounds] = (wp.numpy().copy(), pl.numpy().copy())
        return wp, pl

    def refresh_topology(self):
        super().refresh_topology()
        self.refreshed.append(None if self._cached_x is None
                              else np.array(self._cached_x))


def e3_patterns(kind, seconds, port: bool):
    """e3's seeded traces (``benchmarks/common.py::e3_patterns``)."""
    b, d, c = (bursty, diurnal, constant) if port else \
        (j_bursty, j_diurnal, j_constant)
    fn = b if kind == "bursty" else d
    return {"qr-detector": fn(100.0, duration_s=seconds, seed=0),
            "cv-analyzer": fn(10.0, duration_s=seconds, seed=100),
            "pc-visualizer": c(50.0)}


def paper_pair(cfg, kind="bursty", seconds=SECONDS, events=(), lock=True):
    """``repro``'s run on the paper triple, then the port's twin (in
    lockstep, or free-running with ``repro``'s uniforms): returns
    (repro history, repro agent, port history, port agent)."""
    jenv = JEnv(list(j_profiles().values()), {"cores": 8.0},
                patterns=e3_patterns(kind, seconds, False), seed=0)
    jagent = JaxRecorder(jenv.platform, j_knowledge(), JConfig(**cfg),
                         seed=0)
    jhist = jenv.run(jagent, duration_s=seconds,
                     events=[e(False) for e in events])
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                          patterns=e3_patterns(kind, seconds, True), seed=0)
    cls = LockstepAgent if lock else FreeAgent
    agent = cls(env.platform, paper_knowledge(), RaskConfig(**cfg), seed=0,
                device="cpu", ref=jagent)
    hist = env.run(agent, duration_s=seconds,
                   events=[e(True) for e in events])
    return jhist, jagent, hist, agent


class FreeAgent(LockstepAgent):
    """The port's agent running free: its own plans and warm starts,
    ``repro``'s uniforms."""

    def _plan(self, a):
        self.plans.append(np.array(a, np.float32))
        return RASKAgent._plan(self, a)

    def _x0(self):
        return RASKAgent._x0(self)

    def decide(self, obs):
        plan = RASKAgent.decide(self, obs)
        self.infos.append(self.last_decision)
        return plan


def flags(hist, infos):
    return [(h.explored, h.pipelined, h.forecast_used, i.pgd_starts,
             i.pgd_iters, i.score_starts, i.score_iters, i.moves)
            for h, i in zip(hist, infos, strict=True)]


def assert_lockstep(jhist, jagent, hist, agent, xi, rtol=1e-3):
    """The checks every lockstep pair shares (see the module docstring);
    ``rtol`` bounds the solver scores."""
    assert flags(hist, agent.infos) == flags(jhist, jagent.infos)
    for got, want in zip(agent.plans[:xi], jagent.plans[:xi], strict=True):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    scores = [(i.score, j.score) for i, j in zip(agent.infos, jagent.infos)
              if not j.explored]
    assert scores
    got, want = np.array(scores, np.float64).T
    np.testing.assert_allclose(got, want, rtol=rtol)


class _Copies:
    """Wraps the agent's ``_queue_copy`` to keep every dispatched output."""

    def __init__(self, agent):
        self.outs = []
        inner = agent._queue_copy

        def queue(out):
            host, event = inner(out)
            self.outs.append((agent.rounds, host.clone()))
            return host, event
        agent._queue_copy = queue


@pytest.fixture(scope="module")
def piped():
    jhist, jagent, hist, agent = paper_pair(PIPE)
    return dict(jhist=jhist, jagent=jagent, hist=hist, agent=agent)


def test_pipelined_forecast_flags_and_scores_match_repro(piped):
    jhist, hist = piped["jhist"], piped["hist"]
    assert_lockstep(jhist, piped["jagent"], hist, piped["agent"], XI)
    assert [h.pipelined for h in hist] == [False] * XI + [True] * (
        len(hist) - XI)
    assert sum(h.forecast_used > 0 for h in hist) >= 20
    # the worst rolling error rides the CycleRecord as in repro; the first
    # fits have fewer lag pairs than AR terms, and two ridge solves of such
    # a system agree on the data but not away from it (ROADMAP Queue 3),
    # so the first predictions' errors differ until they leave the window
    assert [h.forecast_err for h in hist] == pytest.approx(
        [h.forecast_err for h in jhist], rel=1e-2, abs=0.015)


def test_gate_errors_match_repro(piped):
    jfc, fc = piped["jagent"]._forecast, piped["agent"]._forecast
    assert sorted(fc._errs) == sorted(jfc._errs)
    for sid, errs in jfc._errs.items():
        np.testing.assert_allclose(list(fc._errs[sid]), list(errs),
                                   rtol=1e-3, atol=1e-6)
    assert fc._evals == jfc._evals and fc.horizon == jfc.horizon == 1


def test_fill_round_then_one_cycle_plan_lag():
    """The first solved round is a fill round (exploring: no cached
    optimum yet); from then on the plan emitted at round n + 1 is the
    noised plan dispatched at round n, and the dispatch at n warm-starts
    from the optimum collected at n."""
    cfg = dict(PIPE, eta=0.05)
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                          patterns=e3_patterns("bursty", 220.0, True), seed=0)
    agent = RASKAgent(env.platform, paper_knowledge(), RaskConfig(**cfg),
                      seed=0, device="cpu")
    copies = _Copies(agent)
    plans = []
    real_plan = agent._plan
    agent._plan = lambda a: (plans.append(np.array(a, np.float32)),
                             real_plan(a))[1]
    hist = env.run(agent, duration_s=220.0)
    assert hist[XI].explored and hist[XI].pipelined     # fill round
    assert not any(h.explored for h in hist[XI + 1:])
    d = agent.problem.dim
    for (r, out), plan in zip(copies.outs[:-1], plans[XI + 1:], strict=True):
        np.testing.assert_array_equal(plan, out.numpy()[d:2 * d])
        assert r >= XI
    # eta > 0: the emitted (noised) plan is not the cached optimum
    assert not np.array_equal(plans[-1], agent._cached_x)
    assert len(copies.outs) == len(hist) - XI


def test_free_running_fulfillment_tracks_repro():
    jhist, _, hist, agent = paper_pair(PIPE, kind="diurnal", seconds=300.0,
                                       lock=False)
    post = [h.fulfillment for h in hist if not h.explored]
    want = [h.fulfillment for h in jhist if not h.explored]
    assert len(post) == len(want) >= 15
    assert abs(np.mean(post) - np.mean(want)) <= 0.03, (np.mean(post),
                                                         np.mean(want))
    assert [h.forecast_used for h in hist] == \
        [h.forecast_used for h in jhist]


def test_quiet_tail_uploads_no_design_window():
    """e10's zero-overhead guard: over the last 8 cycles of a forecast run
    neither the structural nor the forecaster window is uploaded again."""
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                          patterns=e3_patterns("bursty", 300.0, True), seed=0)
    agent = RASKAgent(env.platform, paper_knowledge(),
                      RaskConfig(xi=XI, eta=0.0, forecast=True), seed=0,
                      device="cpu")
    trail = []
    hist = env.run(agent, duration_s=300.0, on_cycle=lambda rec: trail
                   .append(TRACE_COUNTS["h2d_design_upload"]))
    assert trail[-1] == trail[-8] and trail[XI] >= trail[XI - 1] + 2
    assert max(h.forecast_used for h in hist) == 3


@pytest.mark.parametrize("change", ["refresh", "move", "arrival"])
def test_topology_change_drops_the_pending_result(change):
    """A pending pipelined solve built for the old layout is dropped: the
    next cycle is a fill round (it holds the cached optimum)."""
    from repro_torch.env import ChurnEvent
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                          replicas=2, hosts=2, seed=1)
    agent = RASKAgent(env.platform, paper_knowledge(),
                      RaskConfig(xi=6, eta=0.0, pipeline=True), seed=1,
                      device="cpu")
    env.run(agent, duration_s=100.0)
    assert agent._pending is not None and agent.last_decision.pipelined
    gen = agent._topo_gen
    if change == "refresh":
        agent.refresh_topology()
    elif change == "move":
        sid = env.platform.services()[0]
        src = env.platform.host_of(sid).host
        dst = next(h.host for h in env.platform.hosts() if h.host != src)
        env.platform.rebalance({sid: {src: 0.0, dst: 1e3}}, limit=1)
        agent._build_fleet_problem()
    else:
        env.apply_event(ChurnEvent(t=env.t, kind="arrive",
                                   profile=paper_profiles()["qr-detector"]),
                        agent)
    assert agent._pending is None and agent._topo_gen == gen + 1
    cached = agent._cached_x.copy()
    hist = env.run(agent, duration_s=20.0)
    info = hist[0]
    assert info.pipelined and not info.explored and info.runtime_s == 0.0
    assert hist[0].receipt is not None and np.isfinite(cached).all()
    assert not hist[1].explored and agent.last_decision.score > 0
