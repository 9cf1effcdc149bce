"""The port's failover world (src/repro_torch: ``core/fleet.py``, the
fleet branch of ``core/rask.py``, ``env/simulator.py`` churn events,
``env/scenarios.py::failover_scenario``) against ``repro``'s, on the CPU.

The seeded setting of ``tests/test_e2e.py``'s failover test: the tiered
camera/hub/gateway fleet (9 services), 400 simulated seconds, the hub
drained at 260 s, ``RaskConfig(xi=8, eta=0.0, pgd_starts=4, pgd_iters=12,
rebalance_every=2)``. The port's agent is fed the uniforms ``repro`` draws
(the decide's per-host starts from ``jax.random.split`` of the solve key;
a placement snapshot's per-candidate starts from ``PRNGKey(0)``), so:

* exploration plans equal ``repro``'s within 1e-5 (the same numpy rng
  stream, the same float32 projection per host);
* both runs end on the same two hosts and nine services, every plan
  inside each host's budget (no capacity clip in any receipt), and every
  service answers windowed telemetry after the drain;
* at the first placement snapshot (round xi), given ``repro``'s fitted
  models, the port's placement scores equal ``repro``'s within 1e-5;
* the mean fulfillment after the drain is no worse than ``repro``'s by
  more than 0.03 (the bar of ``tests/test_torch_rask.py``), and above 0.6.
  The bar is one-sided because the two runs' placements part at the first
  snapshot: its fits have 8 rows for 10-term relations, and the two
  packages' ridge solves of such ill-conditioned systems agree on the data
  but not away from it (ROADMAP Queue 3), which turns one marginal gain
  around; from there the runs move different services;
* ``rebalance`` reaches a fixed point, and a second call moves nothing;
* a topology change repacks the streaming fit's device window once.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import RASKAgent as JAgent
from repro.core import RaskConfig as JConfig
from repro.env import failover_scenario as j_failover
from repro_torch.core import RASKAgent, RaskConfig
from repro_torch.core.api import REASON_CAPACITY
from repro_torch.core.regression import TRACE_COUNTS, StackedModels
from repro_torch.env import failover_scenario
from repro_torch.launch import failover as launcher

torch.set_num_threads(1)
SECONDS, FAIL_AT = 400.0, 260.0
CFG = dict(xi=8, eta=0.0, pgd_starts=4, pgd_iters=12, rebalance_every=2)


class _Recorder:
    """Keeps every plan vector the agent emits."""

    def _plan(self, a):
        self.plans.append(np.array(a, np.float32))
        return super()._plan(a)


class JaxAgent(_Recorder, JAgent):
    plans: list


def repro_uniforms(buckets, key, n_rows, n_starts):
    """``repro``'s per-row draws: row k of a batch (fleet host or placement
    candidate index) takes ``uniform(split(key, n_rows)[k], (n_starts - 3,
    D_max))`` for its bucket's D_max."""
    keys = jax.random.split(key, max(n_rows, 1))
    return [torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
        keys[int(k)], (max(n_starts - 3, 0), bk.arrays["lower"].shape[1])))
        for k in bk.host_idx])) for bk in buckets]


class PortAgent(_Recorder, RASKAgent):
    """The port's agent, solving and scoring from ``repro``'s uniforms."""

    plans: list

    def _start_uniforms(self, seed):
        self._gen.manual_seed(seed)
        k_solve, _ = jax.random.split(jax.random.PRNGKey(seed))
        fp = self.fleet_problem
        return repro_uniforms(fp.buckets, k_solve, len(fp.hosts),
                              self._budget_starts)

    def _score_uniforms(self, pp):
        return repro_uniforms(pp.buckets, jax.random.PRNGKey(0),
                              pp.n_candidates, self._score_starts)


def port_models(sm):
    """``repro``'s stacked models as the port's (numpy copies)."""
    return StackedModels(*(torch.from_numpy(np.array(x)) for x in (
        sm.w, sm.exponents, sm.term_mask, sm.x_scale)), sm.max_degree)


def _run(env_fn, agent_cls, cfg_cls, seconds=SECONDS, **agent_kw):
    env, knowledge, events = env_fn(duration_s=SECONDS, seed=0,
                                    fail_at=FAIL_AT)
    agent = agent_cls(env.platform, knowledge, cfg_cls(**CFG), seed=0,
                      **agent_kw)
    agent.plans = []
    hist = env.run(agent, duration_s=seconds, events=events)
    return env, agent, hist


@pytest.fixture(scope="module")
def runs():
    jenv, jagent, jhist = _run(j_failover, JaxAgent, JConfig)
    env, agent, hist = _run(failover_scenario, PortAgent, RaskConfig,
                            device="cpu")
    return dict(jenv=jenv, jagent=jagent, jhist=jhist, env=env, agent=agent,
                hist=hist)


def _post(hist):
    return float(np.mean([h.fulfillment for h in hist
                          if h.t > FAIL_AT + 50.0]))


def test_exploration_plans_are_repros(runs):
    xi = CFG["xi"]
    got, want = runs["agent"].plans[:xi], runs["jagent"].plans[:xi]
    assert len(got) == len(want) == xi
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_two_hosts_nine_services_and_no_clip_after_the_drain(runs):
    env, jenv = runs["env"], runs["jenv"]
    hosts = sorted(h.host for h in env.platform.hosts())
    assert hosts == sorted(h.host for h in jenv.platform.hosts())
    assert len(hosts) == 2 and "hub-0" not in hosts
    assert sorted(env.platform.services()) == \
        sorted(jenv.platform.services())
    assert len(env.platform.services()) == 9
    assert not runs["hist"][-1].explored
    for rec in runs["hist"]:
        assert not [o for o in rec.receipt.clipped()
                    if o.reason == REASON_CAPACITY], rec.t
    for host in env.platform.hosts():
        used = sum(host.assignment(s)["cores"] for s in host.services())
        assert used <= host.capacity["cores"] + 1e-6


def test_telemetry_answers_for_every_service_after_the_move(runs):
    env = runs["env"]
    states = env.platform.window_states(since=env.t - 50.0, until=env.t)
    assert all(states.get(s) for s in env.platform.services())


def test_post_event_fulfillment_tracks_repro(runs):
    post, jpost = _post(runs["hist"]), _post(runs["jhist"])
    assert post >= jpost - 0.03, (post, jpost)
    assert post > 0.6


def test_first_snapshot_scores_are_repros_given_repros_models():
    """The placement path alone: both agents explore the same xi cycles,
    then score the first snapshot, the port from ``repro``'s fitted
    models (converted), with ``repro``'s uniforms."""
    jenv, jagent, _ = _run(j_failover, JaxAgent, JConfig,
                           seconds=10.0 * CFG["xi"])
    env, agent, _ = _run(failover_scenario, PortAgent, RaskConfig,
                         seconds=10.0 * CFG["xi"], device="cpu")
    want = jagent.placement_scores(jagent.observe(jenv.t))
    agent.stacked = port_models(jagent.stacked)
    got = agent.placement_scores(agent.observe(env.t))
    assert sorted(got) == sorted(want)
    for sid in want:
        assert sorted(got[sid]) == sorted(want[sid])
        for host in want[sid]:
            assert abs(got[sid][host] - want[sid][host]) <= 1e-5


def test_rebalance_reaches_a_fixed_point(runs):
    agent = runs["agent"]
    agent.rebalance()
    assert agent.rebalance() == []
    for host in runs["env"].platform.hosts():
        assert host.services()


def test_topology_change_repacks_the_device_window_once():
    """A rebuilt fleet solve (a migration, churn) bumps the topology
    generation: the next decide repacks the streaming fit's device window
    once, the ones after push deltas only."""
    env, knowledge, _ = failover_scenario(duration_s=200.0, seed=0)
    agent = RASKAgent(env.platform, knowledge, RaskConfig(xi=8),
                      device="cpu")
    env.run(agent, duration_s=200.0)
    uploads = [TRACE_COUNTS["h2d_design_upload"]]
    agent._build_fleet_problem()
    for _ in range(3):
        agent.decide(agent.observe(env.t))
        uploads.append(TRACE_COUNTS["h2d_design_upload"])
    assert np.diff(uploads).tolist() == [1, 0, 0]


def test_failover_launcher_runs_on_cpu(capsys):
    assert launcher.main(["--device", "cpu", "--seconds", "300"]) == 0
    out = capsys.readouterr().out
    for text in ("fleet before the outage", "pre-outage mean",
                 "post-outage dip", "recovered mean", "fleet after the outage",
                 "windowed telemetry answers for 9/9 services"):
        assert text in out, out


def test_failover_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--seconds", "10"])
