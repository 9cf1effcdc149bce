"""The closed loop over *real* serving backends (the port's copy of
``repro/serve/loop.py``).

``run_serving_loop`` is ``EdgeEnvironment.run`` without the simulator: time
advances second by second, each tick pushes the workload pattern into the
backends, ``platform.pump`` runs their real decode work, and the scrape lands
measured rows in the ``TimeSeriesDB``. Every ``cycle_s`` the (optional) agent
observes, decides and applies a plan, and the loop records measured Eq. (8)
fulfillment — dropping the agent gives the fixed-allocation baseline with
the identical workload and clock.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional

from ..core.platform import MUDAP
from ..core.slo import service_fulfillment


@dataclasses.dataclass
class ServeCycleRecord:
    t: float
    fulfillment: float
    per_service: Dict[str, float]
    rps: Dict[str, float]
    explored: bool = False
    runtime_s: float = 0.0
    alerts: int = 0


def run_serving_loop(platform: MUDAP,
                     patterns: Mapping[str, Callable[[float], float]],
                     agent=None, *, duration_s: float = 120.0,
                     cycle_s: float = 10.0, t0: float = 0.0,
                     on_cycle: Optional[Callable] = None,
                     accountant=None) -> List[ServeCycleRecord]:
    """Drive registered backends for ``duration_s`` seconds.

    patterns: {sid: rps(t)} — each backend's ``rps`` attribute is set every
    tick before ``pump`` runs the tick's real work. With ``agent=None`` the
    allocation stays fixed (baseline); pass ``accountant`` to keep the SLO
    ledger advancing in that case (an attached agent updates it itself).
    """
    history: List[ServeCycleRecord] = []
    t = t0
    for step in range(1, int(duration_s) + 1):
        t += 1.0
        for sid, pat in patterns.items():
            platform.service(sid).backend.rps = float(pat(t))
        platform.pump(t, 1.0)
        platform.scrape(t)
        if step % int(cycle_s) != 0:
            continue
        explored, runtime_s, alerts = False, 0.0, 0
        if agent is not None:
            obs = agent.observe(t)
            plan = agent.decide(obs)
            platform.apply_plan(plan)
            info = getattr(agent, "last_decision", None)
            if info is not None:
                explored = info.explored
                runtime_s = info.runtime_s
                alerts = info.burn_alerts
        elif accountant is not None:
            accountant.update(t)
        states = platform.window_states(since=t - 5.0, until=t)
        per = {}
        for key in platform.services():
            state = states.get(key)
            if not state:
                continue
            svc = platform.service(key)
            per[key] = float(service_fulfillment(svc.slos, state))
        fulfillment = sum(per.values()) / max(len(per), 1) if per else 1.0
        rec = ServeCycleRecord(
            t, fulfillment, per,
            {sid: float(pat(t)) for sid, pat in patterns.items()},
            explored=explored, runtime_s=runtime_s, alerts=alerts)
        history.append(rec)
        if on_cycle:
            on_cycle(rec)
    return history
