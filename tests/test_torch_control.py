"""The port's copies of the host-side modules (src/repro_torch/core/api.py,
platform.py, telemetry.py, slo.py, elasticity.py and env/*) against the
originals in ``repro``: the same inputs give identical outputs — water
filling, ``apply_plan`` receipts, ``TrainingTable.delta_matrix`` exports,
workload curves, and the simulator's telemetry under identical plans.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.api import water_fill as j_water_fill
from repro.core.api import ScalingPlan as JPlan
from repro.core.telemetry import TrainingTable as JTable
from repro.env import EdgeEnvironment as JEnv
from repro.env import paper_profiles as j_profiles
from repro.env import workloads as jw
from repro_torch.core.api import ScalingPlan, water_fill
from repro_torch.core.telemetry import TrainingTable
from repro_torch.env import EdgeEnvironment, paper_profiles, workloads

torch.set_num_threads(1)


def test_water_fill_is_repros():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        floors = rng.uniform(0, 1, n)
        demands = floors + rng.uniform(-0.5, 5, n)
        avail = float(rng.uniform(0, 20))
        np.testing.assert_array_equal(water_fill(demands, floors, avail),
                                      j_water_fill(demands, floors, avail))


def test_profiles_and_workloads_are_repros():
    for (k, p), (jk, jp) in zip(paper_profiles().items(),
                                j_profiles().items()):
        assert k == jk and p.api.names == jp.api.names
        assert [dataclasses.astuple(q) for q in p.slos] == \
            [dataclasses.astuple(q) for q in jp.slos]
        assert p.defaults == jp.defaults and p.knowledge == jp.knowledge
        rng = np.random.default_rng(1)
        for _ in range(20):
            a = {x.name: float(rng.uniform(x.min_value, x.max_value))
                 for x in p.api.parameters}
            assert p.tp_max(a) == jp.tp_max(a)
    for make, jmake in ((workloads.diurnal, jw.diurnal),
                        (workloads.bursty, jw.bursty),
                        (workloads.constant, jw.constant)):
        f, g = make(100.0), jmake(100.0)
        assert [f(t) for t in range(0, 7300, 7)] == \
            [g(t) for t in range(0, 7300, 7)]


def _random_plan(rng, env, plan_cls):
    plan = plan_cls(agent="test")
    for sid in env.platform.services():
        for p in env.platform.service(sid).api.parameters:
            v = rng.uniform(p.min_value - 1.0, p.max_value * 1.5)
            if rng.random() < 0.05:
                v = float("nan")
            plan.set(sid, p.name, v)
    if rng.random() < 0.2:
        plan.set("edge-0/nope/c0", "cores", 1.0)
    return plan


def _receipt(r):
    # repr: a rejected NaN request must compare equal to itself
    return [repr(dataclasses.astuple(o)) for o in r.outcomes]


@pytest.mark.parametrize("replicas", [1, 3])
def test_apply_plan_and_telemetry_are_repros_under_identical_plans(replicas):
    """Both simulators step under the same random plans (some out of
    bounds, over capacity, NaN or for unknown services); receipts, scraped
    windows, measured fulfillment and the per-cycle records agree exactly."""
    profs, jprofs = list(paper_profiles().values()), list(
        j_profiles().values())
    env = EdgeEnvironment(profs, {"cores": 8.0 * replicas},
                          replicas=replicas, seed=4)
    jenv = JEnv(jprofs, {"cores": 8.0 * replicas}, replicas=replicas,
                seed=4)
    rng, jrng = np.random.default_rng(9), np.random.default_rng(9)

    class Planner:
        def __init__(self, env, rng, plan_cls):
            self.env, self.rng, self.plan_cls = env, rng, plan_cls
            self.receipts, self.states = [], []

        def cycle(self, t):
            self.states.append(self.env.platform.window_states(t - 5, t))
            plan = _random_plan(self.rng, self.env, self.plan_cls)
            receipt = self.env.platform.apply_plan(plan)
            self.receipts.append(_receipt(receipt))
            return None

    a, b = Planner(env, rng, ScalingPlan), Planner(jenv, jrng, JPlan)
    hist = env.run(a, duration_s=120)
    jhist = jenv.run(b, duration_s=120)
    assert a.receipts == b.receipts
    assert a.states == b.states
    assert [(h.t, h.fulfillment, h.per_service, h.rps) for h in hist] == \
        [(h.t, h.fulfillment, h.per_service, h.rps) for h in jhist]
    for sid in env.platform.services():
        assert env.platform.assignment(sid) == jenv.platform.assignment(sid)


def test_training_table_delta_matrix_is_repros():
    """Appends with gaps (rows missing a column), through retention
    compaction; every cursor export and the visible window agree."""
    rng = np.random.default_rng(2)
    t, jt = TrainingTable(retention=8), JTable(retention=8)
    cursors, jcursors = {}, {}
    for step in range(60):
        for svc in ("a", "b"):
            row = {"x": float(rng.uniform()), "y": float(rng.uniform())}
            if rng.random() < 0.2:
                row.pop("y")
            t.append(svc, row)
            jt.append(svc, row)
            if rng.random() < 0.5:
                got = t.delta_matrix(svc, ["x"], "y", cursors.get(svc, 0))
                want = jt.delta_matrix(svc, ["x"], "y", jcursors.get(svc, 0))
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
                assert got[2] == want[2]
                cursors[svc], jcursors[svc] = got[2], want[2]
            assert (t.appended(svc), t.evicted(svc), t.count(svc)) == \
                (jt.appended(svc), jt.evicted(svc), jt.count(svc))
            for g, w in zip(t.design_matrix(svc, ["x"], "y"),
                            jt.design_matrix(svc, ["x"], "y")):
                np.testing.assert_array_equal(g, w)


def test_unported_topologies_raise():
    profs = list(paper_profiles().values())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EdgeEnvironment(profs, {"cores": 8.0}, hosts=3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EdgeEnvironment(profs, {"cores": 8.0}, placement="capacity")
    env = EdgeEnvironment(profs, {"cores": 8.0})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        env.run(None, 10, events=[object()])
