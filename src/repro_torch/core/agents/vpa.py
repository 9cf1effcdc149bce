"""VPA baseline — replicates the Kubernetes Vertical Pod Autoscaler (paper §V-C3);
the port's copy of ``repro/core/agents/vpa.py``, host-only as there.

Per service container it maintains a resource *slack* of 5–15 % [34]: target
utilization of the scheduled CPU quota between 85 % and 95 %. Outside the
band it adjusts ``cores`` by ±0.25. It is resource-only (one elasticity
dimension) and — as in the paper — can only claim cores that other services
have released ("if all available resources are allocated, they can only be
reassigned once released"); the capacity arbitration of ``MUDAP.apply_plan``
enforces that, since services absent from the plan keep their holdings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

from ..api import DecisionInfo, PlanningAgent, ScalingPlan
from ..platform import MUDAP


@dataclasses.dataclass
class VPAConfig:
    resource: str = "cores"
    step: float = 0.25
    low: float = 0.85    # below -> over-provisioned, scale down
    high: float = 0.95   # above -> under-provisioned, scale up


class VPAAgent(PlanningAgent):
    name = "vpa"

    def __init__(self, platform: MUDAP, config: Optional[VPAConfig] = None):
        super().__init__()
        self.platform = platform
        self.cfg = config if config is not None else VPAConfig()
        self.rounds = -1

    def observe(self, t: float, window: float = 5.0
                ) -> Dict[str, Dict[str, float]]:
        return self.platform.window_states(since=t - window, until=t)

    def decide(self, obs: Mapping[str, Mapping[str, float]]) -> ScalingPlan:
        self.rounds += 1
        self.last_decision = DecisionInfo()
        plan = ScalingPlan(agent=self.name, cycle=self.rounds)
        for sid in self.platform.services():
            state = obs.get(sid) or {}
            if not state:
                continue
            alloc = self.platform.assignment(sid).get(self.cfg.resource)
            if alloc is None:
                continue
            util = state.get("cpu_utilization")
            if util is None:
                used = state.get("cores_used", 0.0)
                util = used / max(alloc, 1e-9)
            if util > self.cfg.high:
                plan.set(sid, self.cfg.resource, alloc + self.cfg.step)
            elif util < self.cfg.low:
                plan.set(sid, self.cfg.resource, alloc - self.cfg.step)
        return plan
