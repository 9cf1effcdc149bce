"""The port's adaptive solver budget (src/repro_torch/core/rask.py:
``RaskConfig(adapt_budget=True)``, ``_adapt_budget``) against ``repro``'s,
on the CPU.

* Over a scripted score sequence — calm runs that halve the budget to its
  floors, the hysteresis band that only resets the calm count, a load
  shift that restores the full budget, NaN scores, and the grace cycle
  after every change — the budget trajectory (solver and scorer levels,
  calm count, grace) equals ``repro``'s exactly.
* A firing fast-burn alert restores the full budget inside ``decide`` and
  holds off shrinking, as in ``repro``.
* In lockstep runs (``test_torch_pipeline.LockstepAgent``): the paper
  triple under e3's bursty trace, which shrinks to the floors (K = 2
  starts, 8 iterations); and e9's burn-aware failover world, cut short
  (``RaskConfig(xi=20, eta=0, rebalance_every=3, adapt_budget=True)``
  with the simulated SLO accountant, the hub drained at 260 s, 400 s):
  flags, solver and scorer budget levels, moves and alerts equal
  ``repro``'s cycle by cycle, scores within 1e-3 relative.
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
from repro_torch.env import EdgeEnvironment, paper_knowledge, paper_profiles

from test_torch_failover import repro_uniforms
from test_torch_pipeline import JaxRecorder, LockstepAgent, assert_lockstep, \
    flags, paper_pair

torch.set_num_threads(1)


def _pair(**cfg):
    """(env, agent) of each package on the paper triple."""
    jenv = JEnv(list(j_profiles().values()), {"cores": 8.0}, seed=0)
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                          seed=0)
    return ((jenv, JAgent(jenv.platform, j_knowledge(), JConfig(**cfg),
                          seed=0)),
            (env, RASKAgent(env.platform, paper_knowledge(),
                            RaskConfig(**cfg), seed=0, device="cpu")))


def _level(agent):
    return (agent._budget_iters, agent._budget_starts, agent._score_iters,
            agent._score_starts, agent._calm_cycles, agent._last_score)


# calm (< 1%), band (1-5%), shift (>= 5%), NaN and recoveries
SCORES = ([4.0, 4.01, 4.02, 4.015, 4.0, 4.01, 4.005, 4.01, 4.0, 4.012,
           4.008, 4.01, 4.0, 3.99, 4.0]
          + [4.1, 4.05, 4.06, 4.06, 4.07]        # band: calm count resets
          + [4.6, 4.6, 4.61, 4.6, 4.6]           # shift: full budget
          + [float("nan"), 4.6, 4.59, 4.6, 4.6, 4.61, 4.6, 4.6, 4.6, 4.6,
             4.6, 4.61, 4.6, 3.0, 3.0, 3.0, 3.01, 3.0, 3.0, 3.0])


@pytest.mark.parametrize("cfg", [
    dict(adapt_budget=True),
    dict(adapt_budget=True, adapt_patience=2, adapt_restore_tol=0.02,
         adapt_iters_floor=4, adapt_starts_floor=3, score_starts=6,
         adapt_score_iters_floor=2, adapt_score_starts_floor=1),
    dict(adapt_budget=False)])
def test_budget_trajectory_equals_repros(cfg):
    """``decide``'s bookkeeping around ``_adapt_budget`` (the previous
    score, then the adaptation) over the scripted scores."""
    trails = []
    for _, agent in _pair(**cfg):
        trail = []
        for s in SCORES:
            prev, agent._last_score = agent._last_score, float(s)
            agent._adapt_budget(prev, float(s))
            trail.append(_level(agent))
        trails.append(trail)
    want, got = trails
    assert got == want
    levels = {t[:4] for t in got}
    if cfg["adapt_budget"]:
        floors = (cfg.get("adapt_iters_floor", 8),
                  cfg.get("adapt_starts_floor", 2))
        assert any(t[:2] == floors for t in got)        # reached the floors
        assert got[-1][:2] != got[0][:2]                # shrunk at the end
        assert len(levels) >= 3
    else:
        assert levels == {(32, 6, 16, 4)}


class _Firing:
    """A stand-in accountant whose fast-burn alert is firing."""

    def update(self, t):
        return {}

    def fast_alerts(self):
        return ["edge-0/qr-detector/c0"]

    def global_state(self):
        return None


def test_burn_alert_restores_the_full_budget_like_repro():
    xi = 6
    infos = []
    for env, agent in _pair(xi=xi, eta=0.0, adapt_budget=True):
        env.run(agent, duration_s=10.0 * (xi + 3))   # explore, then solve
        agent._budget_iters, agent._budget_starts = 8, 2
        agent._score_iters, agent._score_starts = 8, 2
        agent._calm_cycles, agent._last_score = 2, 4.0
        agent.attach_accountant(_Firing())
        hist = env.run(agent, duration_s=10.0)
        info = agent.last_decision
        infos.append((info.pgd_starts, info.pgd_iters, info.burn_alerts,
                      hist[-1].alerts, _level(agent)[:5]))
    assert infos[1] == infos[0] == (6, 32, 1, 1, (32, 6, 16, 4, 0))


def test_adapt_budget_run_matches_repro_in_lockstep():
    cfg = dict(xi=12, eta=0.0, adapt_budget=True)
    jhist, jagent, hist, agent = paper_pair(cfg)
    assert_lockstep(jhist, jagent, hist, agent, 12)
    levels = [(i.pgd_starts, i.pgd_iters) for i in agent.infos[12:]]
    assert {(6, 32), (3, 16), (2, 8)} <= set(levels)


class FleetLockstep(LockstepAgent):
    """``LockstepAgent`` on a fleet: per-host and per-candidate uniforms as
    ``repro`` draws them, at the current budgets."""

    def _start_uniforms(self, seed):
        self._gen.manual_seed(seed)
        k_solve, _ = jax.random.split(jax.random.PRNGKey(seed))
        fp = self.fleet_problem
        return repro_uniforms(fp.buckets, k_solve, len(fp.hosts),
                              self._budget_starts)

    def _score_uniforms(self, pp):
        return repro_uniforms(pp.buckets, jax.random.PRNGKey(0),
                              pp.n_candidates, self._score_starts)


def test_short_burn_failover_matches_repro_in_lockstep():
    from repro.env import failover_scenario as j_failover
    from repro.env import sim_slo_budget as j_budget
    from repro.obs import SLOAccountant as JAccountant
    from repro_torch.env import failover_scenario, sim_slo_budget
    from repro_torch.obs import SLOAccountant

    cfg = dict(xi=20, eta=0.0, rebalance_every=3, adapt_budget=True)
    runs, ref = [], None
    for scen, cls, conf, acct, budget, kw in (
            (j_failover, JaxRecorder, JConfig, JAccountant, j_budget, {}),
            (failover_scenario, FleetLockstep, RaskConfig, SLOAccountant,
             sim_slo_budget, dict(device="cpu"))):
        env, knowledge, events = scen(duration_s=400.0, seed=0,
                                      fail_at=260.0)
        if ref is not None:
            kw["ref"] = ref
        agent = cls(env.platform, knowledge, conf(**cfg), seed=0, **kw)
        accountant = acct(env.platform, budget())
        agent.attach_accountant(accountant)
        hist = env.run(agent, duration_s=400.0, events=events)
        runs.append((hist, agent, accountant, env))
        ref = agent
    (jhist, jagent, jacct, jenv), (hist, agent, acct, env) = runs
    assert_lockstep(jhist, jagent, hist, agent, 20)
    assert [h.alerts for h in hist] == [h.alerts for h in jhist]
    assert acct.alert_log == jacct.alert_log
    assert any(h.alerts for h in hist)                # a fast alert fired
    assert sum(i.moves for i in agent.infos) >= 3
    assert {h.host: sorted(h.services()) for h in env.platform.hosts()} == \
        {h.host: sorted(h.services()) for h in jenv.platform.hosts()}
    assert flags(hist, agent.infos)[-1][3:5] == (6, 32)
