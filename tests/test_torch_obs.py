"""The port's SLO accounting plane (src/repro_torch/obs, ``core/slo.py::
windowed_violation_rate``, ``env/scenarios.py::sim_slo_budget``) and the
RASK agent's accountant hooks, against ``repro``'s.

Two accountants, one per package, each over its own ``MUDAP`` whose stub
backends report the same seeded scrapes (healthy stretches, an outage, a
backlog, gaps). After every update the per-service burn states, the
alerts, the burn weights, the fleet state, the alert log and the alert
seconds agree with ``repro``'s to 1e-12, with and without an override map
(a latency-SLI budget on one service), and after ``prune``. The rolling
rate primitives agree on random sorted series to 1e-12.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import MUDAP as JMUDAP
from repro.core import SLO as JSLO
from repro.core import windowed_violation_rate as j_wvr
from repro.core.elasticity import ApiDescription as JApi
from repro.core.elasticity import ElasticityParameter as JParam
from repro.core.elasticity import ServiceId as JSid
from repro.env import sim_slo_budget as j_sim_slo_budget
from repro_torch import obs
from repro_torch.core import MUDAP, SLO, RASKAgent, RaskConfig, \
    windowed_violation_rate
from repro_torch.core.elasticity import (ApiDescription, ElasticityParameter,
                                         ServiceId)
from repro_torch.env import (EdgeEnvironment, paper_knowledge,
                             paper_profiles, sim_slo_budget)

torch.set_num_threads(1)
N_SERVICES, SECONDS = 3, 400


class _Stub:
    """A backend whose metrics the test sets before each scrape."""

    def __init__(self):
        self.values = {}

    def apply(self, param, value):
        pass

    def metrics(self):
        return dict(self.values)


def _platform(pkg):
    """``N_SERVICES`` stub services with a context and a completion SLO
    (the served LM's shape) on one 8-core device."""
    if pkg == "repro":
        plat_cls, api_cls, par_cls, sid_cls, slo = (JMUDAP, JApi, JParam,
                                                    JSid, JSLO)
    else:
        plat_cls, api_cls, par_cls, sid_cls, slo = (MUDAP, ApiDescription,
                                                    ElasticityParameter,
                                                    ServiceId, SLO)
    api = api_cls("svc", [par_cls("cores", "resources", "/resources", 0.1,
                                  8.0, None, True)])
    platform = plat_cls({"cores": 8.0})
    stubs = {}
    for i in range(N_SERVICES):
        sid = sid_cls("edge-0", "svc", f"c{i}")
        stub = _Stub()
        platform.register(sid, api, stub, [slo("context", 32.0, 0.5),
                                           slo("completion", 1.0, 1.0)])
        stubs[str(sid)] = stub
    return platform, stubs


def _scrapes(seed):
    """(t, {sid: metrics}) for every second: a noisy healthy service, one
    with an outage from 120 s to 220 s, one with a queue backlog from 60 s
    to 260 s; 2% of the scrapes miss their completion metric."""
    rng = np.random.default_rng(seed)
    sids = [f"edge-0/svc/c{i}" for i in range(N_SERVICES)]
    for t in range(1, SECONDS + 1):
        out = {}
        for i, sid in enumerate(sids):
            comp = float(np.clip(rng.normal(0.97, 0.05), 0.0, 1.0))
            if i == 1 and 120 <= t < 220:
                comp = float(rng.uniform(0.1, 0.5))
            queue = float(rng.poisson(2.0))
            if i == 2 and 60 <= t < 260:
                queue += 20.0
            m = {"context": float(rng.choice([16.0, 32.0, 48.0])),
                 "completion": comp, "queue": queue, "rps": 10.0}
            if rng.random() < 0.02:
                del m["completion"]
            out[sid] = m
        yield float(t), out


def _budgets(pkg, override):
    m = jobs if pkg == "repro" else obs
    default = m.SLOBudget(objective=0.95, good_threshold=0.9,
                          budget_window_s=3600.0).scaled(1.0 / 30.0)
    overrides = None
    if override:
        overrides = {"edge-0/svc/c2": m.SLOBudget(
            sli="latency", latency_metric="queue", latency_target=12.0,
            budget_window_s=3600.0).scaled(1.0 / 30.0)}
    return default, overrides


def _state(st):
    return (st.service, st.t, st.sli, st.budget_consumed, st.bad_total,
            st.sample_total, dict(st.burn), st.firing, st.alerting)


def _close(a, b):
    """Nested equality, floats within 1e-12."""
    if isinstance(a, float) or isinstance(b, float):
        return abs(a - b) <= 1e-12 * max(1.0, abs(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


def _views(acct):
    g = acct.global_state()
    return {"states": {s: _state(st) for s, st in acct.states.items()},
            "fast": acct.fast_alerts(), "fast_slow": acct.fast_alerts("slow"),
            "weights": acct.burn_weights(4.0),
            "global": None if g is None else _state(g),
            "log": list(acct.alert_log),
            "seconds": dict(acct.alert_seconds),
            "snapshot": {s: _state(st) for s, st in acct.snapshot().items()}}


@pytest.mark.parametrize("override", [False, True])
def test_accountant_is_repros(override):
    sides = {}
    for pkg in ("repro", "port"):
        platform, stubs = _platform(pkg)
        m = jobs if pkg == "repro" else obs
        default, overrides = _budgets(pkg, override)
        sides[pkg] = (platform, stubs,
                      m.SLOAccountant(platform, default, overrides=overrides))
    fired = set()
    for t, metrics in _scrapes(seed=3 + override):
        views = {}
        for pkg, (platform, stubs, acct) in sides.items():
            for sid, m in metrics.items():
                stubs[sid].values = m
            platform.scrape(t)
            if int(t) % 10 == 0:
                acct.update(t)
                views[pkg] = _views(acct)
        if views:
            assert _close(views["port"], views["repro"]), t
            fired.update(views["port"]["fast"])
        if t == 300:                # a service departs
            for platform, _, acct in sides.values():
                platform.deregister("edge-0/svc/c2")
                acct.prune(platform.services())
            assert _close(_views(sides["port"][2]), _views(sides["repro"][2]))
    acct = sides["port"][2]
    assert fired                    # the outage (and backlog) fired alerts
    assert "edge-0/svc/c2" not in acct.states
    assert [e for e in acct.alert_log if e[3] == "clear"]
    if override:
        assert acct.budget_for("edge-0/svc/c2").sli == "latency"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rolling_rates_are_repros(seed):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0.0, 500.0, 300))
    bad = rng.random(300) < 0.3
    f = np.where(bad, rng.uniform(0.0, 0.99, 300), 1.0)
    windows = [1.0, 7.5, 60.0, 250.0, 1000.0]
    for until in (None, 250.0, 499.0, 600.0):
        for w in windows:
            assert obs.error_rate(ts, bad, w, until) == pytest.approx(
                jobs.error_rate(ts, bad, w, until), abs=1e-12)
            assert windowed_violation_rate(ts, f, w, until) == \
                pytest.approx(j_wvr(ts, f, w, until), abs=1e-12)
        np.testing.assert_allclose(obs.error_rates(ts, bad, windows, until),
                                   jobs.error_rates(ts, bad, windows, until),
                                   rtol=0, atol=1e-12)
    assert obs.error_rate([], [], 10.0) == 0.0
    assert obs.error_rates([], [], [1.0, 2.0]).tolist() == [0.0, 0.0]


def test_sim_slo_budget_is_repros():
    for kw in ({}, dict(objective=0.99, good_threshold=0.8, scale=1 / 60)):
        assert dataclasses.asdict(sim_slo_budget(**kw)) == \
            dataclasses.asdict(j_sim_slo_budget(**kw))
    assert (obs.FAST_BURN.name, obs.FAST_BURN.long_s, obs.FAST_BURN.short_s,
            obs.FAST_BURN.threshold) == dataclasses.astuple(jobs.FAST_BURN)
    assert dataclasses.astuple(obs.SLOW_BURN) == \
        dataclasses.astuple(jobs.SLOW_BURN)


class _StubAccountant:
    def __init__(self, firing=()):
        self.firing, self.updates = list(firing), []

    def fast_alerts(self):
        return list(self.firing)

    def update(self, t):
        self.updates.append(t)
        return {}


def _agent(**cfg):
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0})
    return env, RASKAgent(env.platform, paper_knowledge(),
                          RaskConfig(xi=2, **cfg), device="cpu")


def test_agent_reads_alerts_only_with_burn_control():
    _, agent = _agent()
    assert agent._fast_alerts() == [] and agent._max_burn() == 0.0
    agent.attach_accountant(_StubAccountant(firing=["svc"]))
    assert agent._fast_alerts() == ["svc"]
    _, off = _agent(burn_control=False)
    off.attach_accountant(_StubAccountant(firing=["svc"]))
    assert off._fast_alerts() == []


def test_observe_advances_the_accountant_and_decide_reports_it():
    """Every observe updates the attached accountant; solved and explored
    decides carry its alert count and worst burn rate."""
    env, agent = _agent()
    acct = obs.SLOAccountant(env.platform, sim_slo_budget(good_threshold=1.0))
    agent.attach_accountant(acct)
    hist = env.run(agent, duration_s=80.0)
    assert acct._last_t == 80.0 and agent.burn_states is acct.states
    assert not hist[-1].explored
    info = agent.last_decision
    assert info.burn_alerts == len(acct.fast_alerts())
    assert info.max_burn == max(st.burn_rate() for st in acct.states.values())
    assert info.max_burn > 0.0
