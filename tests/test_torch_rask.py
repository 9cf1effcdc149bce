"""The port's RASK agent (src/repro_torch/core/rask.py) against ``repro``'s,
end to end on the quickstart triple (QR/CV/PC on one 8-core device, seed 0,
xi = 15), both deciding on the CPU.

The port's random starts come from a ``torch.Generator``; here a subclass
feeds it the uniforms ``repro`` draws inside its fused decide
(``jax.random.split(PRNGKey(seed))``), so both agents solve from the same
starts and the trajectories can be compared cycle by cycle:

* exploration-phase plans equal ``repro``'s within 1e-5 (same numpy rng
  stream, same float32 projection);
* the mean fulfillment of the last 10 cycles is within 0.03 of
  ``repro``'s, and above 0.9. The run is 500 s long: at 300 s neither
  package has converged above 0.9 on this seed (``repro``: 0.81), which is
  why ``tests/test_rask.py`` also runs 500 s for its 0.9 bar;
* steady cycles upload no design window (``h2d_design_upload`` flat);
* no plan or applied assignment exceeds the capacity.
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
from repro_torch.core import RASKAgent, RaskConfig
from repro_torch.core.regression import TRACE_COUNTS
from repro_torch.env import EdgeEnvironment, paper_knowledge, paper_profiles
from repro_torch.launch import quickstart

torch.set_num_threads(1)
XI, SECONDS, CAP = 15, 500.0, 8.0


class _Recorder:
    """Keeps every plan vector the agent emits."""

    def _plan(self, a):
        self.plans.append(np.array(a, np.float32))
        return super()._plan(a)


class JaxAgent(_Recorder, JAgent):
    plans: list


class PortAgent(_Recorder, RASKAgent):
    """The port's agent, solving from ``repro``'s uniforms."""

    plans: list

    def _start_uniforms(self, seed):
        k_solve, _ = jax.random.split(jax.random.PRNGKey(seed))
        u = jax.random.uniform(k_solve, (max(self._budget_starts - 3, 0),
                                         self.problem.dim))
        return torch.from_numpy(np.array(u))


@pytest.fixture(scope="module")
def runs():
    jenv = JEnv(list(j_profiles().values()), {"cores": CAP}, seed=0)
    jagent = JaxAgent(jenv.platform, j_knowledge(), JConfig(xi=XI), seed=0)
    jagent.plans = []
    jhist = jenv.run(jagent, duration_s=SECONDS)

    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": CAP},
                          seed=0)
    agent = PortAgent(env.platform, paper_knowledge(), RaskConfig(xi=XI),
                      seed=0, device="cpu")
    agent.plans = []
    uploads = []
    hist = env.run(agent, duration_s=SECONDS, on_cycle=lambda rec: uploads
                   .append(TRACE_COUNTS["h2d_design_upload"]))
    return dict(jagent=jagent, jhist=jhist, env=env, agent=agent, hist=hist,
                uploads=uploads)


def test_exploration_plans_are_repros(runs):
    got, want = runs["agent"].plans, runs["jagent"].plans
    assert len(got) == len(want) == int(SECONDS // 10)
    for a, b in zip(got[:XI], want[:XI]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert [h.explored for h in runs["hist"]] == \
        [True] * XI + [False] * (len(got) - XI)


def test_post_exploration_fulfillment_tracks_repro(runs):
    port = np.mean([h.fulfillment for h in runs["hist"][-10:]])
    ref = np.mean([h.fulfillment for h in runs["jhist"][-10:]])
    assert abs(port - ref) <= 0.03, (port, ref)
    assert port > 0.9, port


def test_steady_cycles_upload_no_design_window(runs):
    up = runs["uploads"]
    first = XI                       # the first solved cycle builds the ring
    assert up[first] == up[first - 1] + 1
    assert up[-1] == up[first], up


def test_capacity_never_exceeded(runs):
    agent, env = runs["agent"], runs["env"]
    mask = agent.problem.resource_mask
    for i, a in enumerate(agent.plans):
        total = a[mask].astype(np.float64).sum()
        # exploration draws are projected onto C itself (their float32 sum
        # may read 8.000001); solves onto (1 - 1e-6) C
        assert total <= (CAP if i >= XI else CAP * (1 + 1e-6)), (i, total)
    for h in runs["hist"]:
        applied = h.receipt.applied()
        assert sum(v.get("cores", 0.0) for v in applied.values()) \
            <= CAP + 1e-6
    # the streaming fit is the batch refit of the same window
    data = agent._collect_fit_data()
    batch = agent._fit_plan.fit(data)
    for i, (X, _) in enumerate(data):
        want = batch.model(i).predict(X).numpy()
        got = agent.stacked.model(i).predict(X).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max())
    solved = [h for h in runs["hist"] if not h.explored]
    assert all(h.runtime_s > 0.0 and h.compile_s == 0.0 for h in solved)


def test_batch_fit_mode_solves_with_the_streaming_fit():
    """``streaming_fit=False`` refits the full padded window every cycle
    (``fit_batched_arrays``): it solves, and its models are the streaming
    engine's fit of the same table."""
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": CAP},
                          seed=1)
    agent = RASKAgent(env.platform, paper_knowledge(),
                      RaskConfig(xi=6, streaming_fit=False), seed=1,
                      device="cpu")
    before = TRACE_COUNTS["h2d_design_upload"]
    hist = env.run(agent, duration_s=100.0)
    solved = [h for h in hist if not h.explored]
    assert len(solved) == 4 and all(np.isfinite(h.receipt.applied()[
        "edge-0/qr-detector/c0"]["cores"]) for h in solved)
    assert np.isfinite(agent.last_decision.score)
    assert TRACE_COUNTS["h2d_design_upload"] == before + 4   # every cycle
    data = agent._collect_fit_data()
    plan = agent._fit_plan
    stream = plan.stream_fit(plan.stream_rebuild(data))
    for i, (X, _) in enumerate(data):
        want = stream.model(i).predict(X).numpy()
        got = agent.stacked.model(i).predict(X).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("option", [dict(rebalance_every=2),
                                    dict(rebalance_every=2,
                                         burn_weight_cap=2.0)])
def test_fleet_options_run_and_match_repro(option):
    """``rebalance_every`` and ``burn_weight_cap`` on the failover world's
    fleet with the SLO accountant attached: after the same exploration
    (plans within 1e-5), the first placement stage — a snapshot, its rows
    scaled by the burn weights at the cap under a firing alert, one move —
    makes ``repro``'s move, the port scoring from ``repro``'s fitted
    models and uniforms (its own first fits differ from ``repro``'s: 8 rows
    for 10-term relations, see ``tests/test_torch_failover.py``)."""
    from test_torch_failover import PortAgent, port_models
    from repro.env import failover_scenario as j_failover
    from repro.env import sim_slo_budget as j_budget
    from repro.obs import SLOAccountant as JAccountant
    from repro_torch.env import failover_scenario, sim_slo_budget
    from repro_torch.obs import SLOAccountant

    cfg = dict(xi=8, eta=0.0, pgd_starts=4, pgd_iters=12, **option)
    agents = []
    for scen, cls, conf, acct, budget, kw in (
            (j_failover, JaxAgent, JConfig, JAccountant, j_budget, {}),
            (failover_scenario, PortAgent, RaskConfig, SLOAccountant,
             sim_slo_budget, dict(device="cpu"))):
        env, knowledge, _ = scen(duration_s=400.0, seed=0)
        agent = cls(env.platform, knowledge, conf(**cfg), seed=0, **kw)
        agent.plans = []
        agent.attach_accountant(acct(env.platform, budget()))
        env.run(agent, duration_s=10.0 * cfg["xi"])
        agent.rounds += 1                         # the next decide's round
        agents.append((env, agent, agent.observe(env.t)))
    (jenv, jagent, jobs), (env, agent, obs) = agents
    for got, want in zip(agent.plans, jagent.plans, strict=True):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    alerts = sorted(env.platform.services())[:2]  # a firing alert, forced
    jagent._fit_models()
    agent.stacked = port_models(jagent.stacked)
    want = jagent._maybe_rebalance(jobs, alerts)
    got = agent._maybe_rebalance(obs, alerts)
    assert got == want and want[1] and len(want[0]) == 1
    assert {h.host: sorted(h.services()) for h in env.platform.hosts()} == \
        {h.host: sorted(h.services()) for h in jenv.platform.hosts()}


def test_agent_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": CAP})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RASKAgent(env.platform, paper_knowledge())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main(["--seconds", "10"])


def test_quickstart_runs_on_cpu(capsys):
    env, agent, hist = quickstart.main(["--device", "cpu", "--seconds", "220",
                                        "--replicas", "2"])
    assert len(env.platform.services()) == 6 and len(hist) == 22
    assert not hist[-1].explored
    out = capsys.readouterr().out
    assert "post-exploration mean fulfillment" in out
