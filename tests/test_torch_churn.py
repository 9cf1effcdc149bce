"""The port's service-set churn (src/repro_torch: ``env/simulator.py``
``add_service``/``remove_service`` and the ``arrive``/``depart`` events,
``env/scenarios.py::churn_scenario``, and ``core/rask.py``'s transfer
priors and ``refresh_topology``) against ``repro``'s, on the CPU.

* ``churn_scenario`` gives ``repro``'s events and fleet.
* e10's transfer setting, cut short (the paper triple under e3's diurnal
  trace, ``RaskConfig(xi=12, eta=0, forecast=True)``, a QR arrival at
  200 s of 300), in lockstep (``test_torch_pipeline.LockstepAgent``), with
  and without ``transfer_priors``: the post-arrival exploration count
  equals ``repro``'s (0 with priors, more than 0 without — ``repro``'s own
  acceptance fact), every cycle's flags equal ``repro``'s, the solver
  scores within 1e-2 relative (after an arrival the newcomer's relations
  are fitted from fewer rows than terms, a system whose ridge solutions
  in the two packages agree on the data but not away from it — ROADMAP
  Queue 3 — where the runs without churn hold 1e-3), the prior-mean
  ridge inputs (``_prior_args``: the strengths exactly, the captured
  weights within 1e-3 of their largest magnitude) decay round by round as
  ``repro``'s do, and the warm start after the arrival carries every
  surviving service's slice over by name, as ``repro``'s does.
* the whole ``churn_scenario`` — throttling, an arrival and a departure —
  in lockstep on the tiered fleet: flags equal cycle by cycle, scores
  within 1e-2 relative, and the same service set at the end.
"""
import numpy as np
import pytest
import torch

from repro.env import paper_profiles as j_profiles
from repro.env.simulator import ChurnEvent as JEvent
from repro_torch.env import ChurnEvent, churn_scenario, paper_profiles

from test_torch_budget import FleetLockstep
from test_torch_pipeline import JaxRecorder, assert_lockstep, flags, \
    paper_pair

torch.set_num_threads(1)
ARRIVE, SECONDS = 200.0, 300.0


def _arrival(port: bool):
    ev, prof = (ChurnEvent, paper_profiles) if port else \
        (JEvent, j_profiles)
    return ev(t=ARRIVE, kind="arrive", profile=prof()["qr-detector"])


@pytest.fixture(scope="module", params=[True, False],
                ids=["with_priors", "without_priors"])
def arrival(request):
    cfg = dict(xi=12, eta=0.0, forecast=True, transfer_priors=request.param)
    jhist, jagent, hist, agent = paper_pair(cfg, kind="diurnal",
                                            seconds=SECONDS,
                                            events=(_arrival,))
    return request.param, jhist, jagent, hist, agent


def _post_explored(hist):
    return sum(h.explored for h in hist if h.t > ARRIVE)


def test_post_arrival_exploration_matches_repro(arrival):
    priors, jhist, jagent, hist, agent = arrival
    assert_lockstep(jhist, jagent, hist, agent, 12, rtol=1e-2)
    assert _post_explored(hist) == _post_explored(jhist)
    assert (_post_explored(hist) == 0) == priors
    assert len(agent.services) == len(jagent.services) == 4
    assert agent.services == jagent.services


def test_prior_decay_matches_repro(arrival):
    priors, _, jagent, _, agent = arrival
    assert sorted(agent.priors) == sorted(jagent.priors)
    live = 0
    for r in sorted(jagent.priors):
        (jw, jp), (tw, tp) = jagent.priors[r], agent.priors[r]
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_allclose(tw, jw, rtol=0,
                                   atol=1e-3 * max(np.abs(jw).max(), 1.0))
        live += bool(jp.any())
    # with priors: the newcomer's relations lean on the fleet means until
    # they hold transfer_min_rows rows; its first row lands in the arrival
    # cycle, so the pull decays 2/3, 1/3 of the strength, then drops
    assert live == (2 if priors else 0)
    if priors:
        strengths = sorted({float(p.max()) for _, p in agent.priors.values()
                            if p.any()}, reverse=True)
        np.testing.assert_allclose(strengths, [2 / 3, 1 / 3], rtol=1e-6)
        assert agent._transfer_priors == {}       # fully decayed, dropped
        assert agent._fc_priors.keys() == jagent._fc_priors.keys()


def test_warm_start_carried_by_name_like_repro(arrival):
    _, _, jagent, _, agent = arrival
    (want,), (got,) = jagent.refreshed, agent.refreshed
    np.testing.assert_array_equal(got, want)
    problem = agent.problem
    new = problem.specs[-1]
    assert new.name.endswith("qr-detector/c1")
    off = problem.offsets[-1]
    mid = 0.5 * (problem.lower + problem.upper)
    np.testing.assert_allclose(got[off:off + new.n_params],
                               mid[off:off + new.n_params], rtol=1e-6)


def test_churn_scenario_matches_repros_events():
    from repro.env import churn_scenario as j_churn
    jenv, jknow, jevents = j_churn(duration_s=600.0, seed=0)
    env, know, events = churn_scenario(duration_s=600.0, seed=0)
    assert know == jknow
    assert sorted(env.platform.services()) == \
        sorted(jenv.platform.services())
    assert [(e.t, e.kind, e.host, e.service, e.factor,
             e.profile.type if e.profile else None) for e in events] == \
        [(e.t, e.kind, e.host, e.service, e.factor,
          e.profile.type if e.profile else None) for e in jevents]


def test_churn_scenario_runs_in_lockstep_with_repro():
    from repro.core import RaskConfig as JConfig
    from repro.env import churn_scenario as j_churn
    from repro_torch.core import RaskConfig

    cfg = dict(xi=13, eta=0.0)
    runs, ref = [], None
    for scen, cls, conf, kw in ((j_churn, JaxRecorder, JConfig, {}),
                                (churn_scenario, FleetLockstep, RaskConfig,
                                 dict(device="cpu"))):
        env, knowledge, events = scen(duration_s=400.0, seed=0)
        if ref is not None:
            kw["ref"] = ref
        agent = cls(env.platform, knowledge, conf(**cfg), seed=0, **kw)
        hist = env.run(agent, duration_s=400.0, events=events)
        runs.append((hist, agent, env))
        ref = agent
    (jhist, jagent, jenv), (hist, agent, env) = runs
    assert_lockstep(jhist, jagent, hist, agent, 13, rtol=1e-2)
    assert sorted(env.platform.services()) == \
        sorted(jenv.platform.services())
    assert agent.services == jagent.services and len(agent.services) == 9
    assert [e.kind for e in events] == ["degrade", "arrive", "depart"]
    assert not flags(hist, agent.infos)[-1][0]        # solving at the end
