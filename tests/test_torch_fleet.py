"""The port's multi-host control plane against ``repro``'s, on the CPU:
``core/fleet.py::Fleet`` (a copy), the telemetry migration of
``core/telemetry.py``, ``EdgeEnvironment`` over several hosts with its
placement policies and churn events, and ``env/scenarios.py``'s fleet
scenarios and churn grammar. Both packages get identical calls; the
results are compared exactly (the same numpy arithmetic, no device).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.api import ScalingPlan as JPlan
from repro.core.telemetry import TimeSeriesDB as JDB
from repro.env import ChurnEvent as JEvent
from repro.env import EdgeEnvironment as JEnv
from repro.env import HostSpec as JHostSpec
from repro.env import failover_scenario as j_failover
from repro.env import hetero_environment as j_hetero
from repro.env import paper_profiles as j_profiles
from repro.env import parse_churn as j_parse
from repro.env import two_tier_environment as j_two_tier
from repro.env.simulator import SimulatedService as JService
from repro_torch.core.api import ScalingPlan
from repro_torch.core.telemetry import TimeSeriesDB
from repro_torch.env import (ChurnEvent, EdgeEnvironment, HostSpec,
                             failover_scenario, hetero_environment,
                             paper_profiles, parse_churn,
                             two_tier_environment)
from repro_torch.env.simulator import SimulatedService

torch.set_num_threads(1)


class Hold:
    """A legacy agent that changes nothing: the environment only ticks and
    scrapes."""

    def cycle(self, t):
        return None


def _state(env):
    """Everything the two packages' environments are compared on."""
    plat = env.platform
    hosts = plat.hosts() if hasattr(plat, "hosts") else [plat]
    return dict(
        hosts=[(h.host, dict(h.capacity), sorted(h.services()))
               for h in hosts],
        assign={s: plat.assignment(s) for s in sorted(plat.services())},
        windows=plat.window_states(since=env.t - 20.0, until=env.t),
        host_capacity=env.host_capacity)


def _pair(j_fn, t_fn, seconds=30.0, **kw):
    jenv, tenv = j_fn(**kw), t_fn(**kw)
    jenv.run(Hold(), duration_s=seconds)
    tenv.run(Hold(), duration_s=seconds)
    return jenv, tenv


def _profiles(pkg):
    return list((j_profiles() if pkg == "repro" else paper_profiles())
                .values())


@pytest.mark.parametrize("kw", [
    dict(hosts=3, capacity={"cores": 8.0}),
    dict(hosts=2, capacity={"cores": 8.0}, replicas=3),
    dict(hosts="specs", placement="capacity", replicas=3),
    dict(hosts="specs", placement="round_robin", replicas=2),
    dict(hosts="pairs", replicas=2,
         placement=["a", "b", "b", "a", "b", "b"])],
    ids=["hosts3", "hosts2_replicas3", "capacity", "specs_round_robin",
         "explicit"])
def test_environments_are_repros(kw):
    """Containers, placement, defaults and telemetry of ``EdgeEnvironment``
    over several hosts equal ``repro``'s."""
    def make(pkg):
        args = dict(kw)
        if args["hosts"] == "specs":
            spec = JHostSpec if pkg == "repro" else HostSpec
            args["hosts"] = [spec("small", {"cores": 4.0}),
                             spec("big", {"cores": 12.0})]
        elif args["hosts"] == "pairs":
            args["hosts"] = [("a", {"cores": 6.0}), ("b", {"cores": 10.0})]
        cls = JEnv if pkg == "repro" else EdgeEnvironment
        return lambda: cls(_profiles(pkg), seed=3, **args)
    jenv, tenv = _pair(make("repro"), make("port"))
    assert _state(tenv) == _state(jenv)


@pytest.mark.parametrize("name", ["hetero", "two_tier", "failover"])
def test_fleet_scenarios_are_repros(name):
    j_fn, t_fn = {"hetero": (j_hetero, hetero_environment),
                  "two_tier": (j_two_tier, two_tier_environment),
                  "failover": (j_failover, failover_scenario)}[name]
    jout, tout = j_fn(duration_s=60.0, seed=1), t_fn(duration_s=60.0, seed=1)
    assert tout[1] == jout[1]                     # the knowledge
    if name == "failover":
        assert [dataclasses.astuple(e) for e in tout[2]] == \
            [dataclasses.astuple(e) for e in jout[2]]
    jout[0].run(Hold(), duration_s=60.0)
    tout[0].run(Hold(), duration_s=60.0)
    assert _state(tout[0]) == _state(jout[0])


def _apply(env, pkg, events):
    cls = JEvent if pkg == "repro" else ChurnEvent
    for kw in events:
        env.apply_event(cls(t=env.t, **kw))
    env.run(Hold(), duration_s=20.0)


@pytest.mark.parametrize("events", [
    [dict(kind="fail_host", host="hub-0")],
    [dict(kind="drain_host", host="hub-0")],
    [dict(kind="degrade", host="gateway-0", factor=0.6)],
    [dict(kind="degrade", host="camera-0", factor=1.5),
     dict(kind="drain_host", host="gateway-0")]],
    ids=["fail", "drain", "degrade", "recover_then_drain"])
def test_churn_events_are_repros(events):
    """Host failure (telemetry lost with the host), drain (telemetry
    carried), degradation and recovery, without an agent (least-loaded
    destinations): the same hosts, capacities, placement and windows."""
    jenv, tenv = _pair(lambda: j_hetero(duration_s=200.0)[0],
                       lambda: hetero_environment(duration_s=200.0)[0])
    _apply(jenv, "repro", events)
    _apply(tenv, "port", events)
    assert _state(tenv) == _state(jenv)


def _fleet_ops(env, pkg):
    """One script of Fleet calls; returns what each call gave."""
    fleet = env.platform
    out = []
    hosts = sorted(h.host for h in fleet.hosts())
    sids = sorted(fleet.services())
    svc_cls = JService if pkg == "repro" else SimulatedService
    prof = _profiles(pkg)[0]
    for k, host in enumerate([None, hosts[1]]):     # least loaded, explicit
        backend = svc_cls(prof, np.random.default_rng(k))
        out.append(fleet.place(f"{hosts[0]}/extra/c{k}", prof.api, backend,
                               list(prof.slos), dict(prof.defaults),
                               host=host))
    backend = svc_cls(prof, np.random.default_rng(9))
    out.append(fleet.place("x/scored/c0", prof.api, backend, list(prof.slos),
                           dict(prof.defaults),
                           scores={hosts[0]: 0.2, hosts[2]: 0.7}))
    out.append(fleet.migrate(sids[0], hosts[2]))
    out.append(fleet.migrate(sids[0], hosts[0]))            # and back
    out.append(fleet.window_state(sids[0], env.t - 20.0, env.t))
    scores = {s: {h: 0.1 * ((i + j) % 4) for j, h in enumerate(hosts)}
              for i, s in enumerate(sids)}
    out.append(fleet.rebalance(scores, hysteresis=0.25))    # gated: no move
    out.append(fleet.rebalance(scores, hysteresis=0.05, limit=3))
    out.append(fleet.capacity)
    plan_cls = JPlan if pkg == "repro" else ScalingPlan
    plan = plan_cls(agent="test", cycle=1)
    for i, s in enumerate(sorted(fleet.services())):
        plan.set(s, "cores", 1.0 + 3.0 * (i % 3))
        plan.set(s, "data_quality", 500.0 + 7.0 * i)
    plan.set("nowhere/x/c0", "cores", 1.0)
    out.append([dataclasses.astuple(o)
                for o in fleet.apply_plan(plan).outcomes])
    out.append(fleet.set_capacity(hosts[1], "cores", 5.5))
    out.append(fleet.evacuate(hosts[1], scores={
        s: {hosts[0]: 0.3, hosts[2]: 0.4} for s in sids[:2]}))
    removed = fleet.remove_host(hosts[1])
    out.append((removed.host, removed.services()))
    for bad in (lambda: fleet.remove_host("nope"),
                lambda: fleet.set_capacity(hosts[0], "chips", 1.0),
                lambda: fleet.migrate(sids[1], "nope")):
        with pytest.raises(KeyError):
            bad()
    out.append({s: fleet.host_of(s).host for s in sorted(fleet.services())})
    out.append({s: fleet.assignment(s) for s in sorted(fleet.services())})
    out.append(fleet.window_states(env.t - 20.0, env.t))
    return out


def test_fleet_calls_are_repros():
    """place (least loaded, explicit, scored), migrate and migrate back,
    rebalance under and over its hysteresis gate, apply_plan's receipts
    (an unplaced service rejected), set_capacity, evacuate with scored and
    unscored residents, remove_host, and the registry and telemetry views
    after: ``repro``'s results, call by call."""
    jenv, tenv = _pair(lambda: j_hetero(duration_s=100.0)[0],
                       lambda: hetero_environment(duration_s=100.0)[0])
    got, want = _fleet_ops(tenv, "port"), _fleet_ops(jenv, "repro")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


def test_telemetry_migration_is_repros():
    """export_window / import_window (a merge into an interleaved history)
    / transfer, with scrapes that miss columns."""
    rng = np.random.default_rng(0)
    dbs = {pkg: (cls(retention=64), cls(retention=64))
           for pkg, cls in (("repro", JDB), ("port", TimeSeriesDB))}
    for t in range(100):
        row = {"rps": float(rng.uniform(0, 50)), "lat": float(rng.random())}
        if t % 7 == 0:
            row.pop("lat")
        for src, dst in dbs.values():
            src.scrape("a", float(t), row)
            if t % 3 == 0:
                dst.scrape("a", float(t) + 0.5, {"rps": float(t)})
    got, want = [], []
    for out, (src, dst) in ((got, dbs["port"]), (want, dbs["repro"])):
        out.append(src.export_window("a", since=40.0, until=80.0))
        out.append(src.export_window("missing"))
        out.append(dst.import_window("a", *src.export_window("a", 10.0,
                                                              30.0)))
        out.append(src.transfer("a", dst, since=50.0))
        out.append(src.transfer("a", dst))           # nothing left
        out.append(dst.export_window("a"))
        out.append(dst.window_mean("a", 0.0, 200.0))
    for g, w in zip(got, want, strict=True):
        if isinstance(w, tuple):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1] == w[1]
            np.testing.assert_array_equal(g[2], w[2])
        else:
            assert g == w


def test_parse_churn_is_repros():
    spec = ("fail:hub-0@300,drain_host:gateway-0@120,degrade:camera-0@50,"
            "degrade:gateway-0@60:0.25,arrive:qr-detector@90,"
            "depart:gateway-0/pc-visualizer/c2@200")
    got = parse_churn(spec, paper_profiles().values())
    want = j_parse(spec, j_profiles().values())
    assert [(e.t, e.kind, e.host, e.service, e.factor,
             e.profile.type if e.profile else None) for e in got] == \
        [(e.t, e.kind, e.host, e.service, e.factor,
          e.profile.type if e.profile else None) for e in want]
    for bad in ("fail:hub-0", "explode:x@3", "arrive:nope@1"):
        with pytest.raises((ValueError, KeyError)):
            parse_churn(bad, paper_profiles().values())
