"""Declarative control-plane API (the port's copy of ``repro/core/api.py``):
transactional ScalingPlans and the Agent protocol every autoscaler
implements.

The seed modeled the paper's ScalingAPI (§III, Fig. 2 step 4) as imperative
per-parameter ``MUDAP.scale(sid, param, value)`` calls. That shape is
order-dependent — whichever service is scaled first grabs the shared
headroom — and non-atomic: a multi-service assignment is a sequence of
independent mutations. This module replaces it with a *declarative* plane:

* ``ScalingPlan`` — the full per-service assignment an agent proposes for
  one cycle (what the solver's decision vector *means*);
* ``PlanReceipt`` / ``ParameterOutcome`` — the platform's per-parameter
  verdict: applied as requested, clipped (with a machine-readable reason),
  or rejected;
* ``water_fill`` — order-independent max-min fair arbitration used by
  ``MUDAP.apply_plan`` when the plan's resource demands exceed the global
  capacity C (replacing first-come-first-served clipping);
* ``Agent`` — the single protocol (``observe(t) -> obs``,
  ``decide(obs) -> ScalingPlan``) RASK, DQN and VPA all implement, so one
  environment loop can drive any of them;
* ``PlanningAgent`` — a small base class providing the legacy
  ``cycle(t) -> CycleResult`` loop on top of observe/decide.

``MUDAP.scale`` survives as a thin shim over a one-entry plan for one
release; new code should build plans.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Mapping, Optional, Protocol, \
    Tuple, runtime_checkable

import numpy as np

# ParameterOutcome.status values
APPLIED = "applied"     # applied exactly as requested
CLIPPED = "clipped"     # applied, but adjusted (bounds / step / capacity)
REJECTED = "rejected"   # not applied at all (unknown service/param, NaN, ...)

# machine-readable clip/reject reasons
REASON_BOUNDS = "bounds"            # outside [min, max] or snapped to step
REASON_CAPACITY = "capacity"        # scaled back by global-capacity arbitration
REASON_UNKNOWN_SERVICE = "unknown-service"
REASON_UNKNOWN_PARAM = "unknown-parameter"
REASON_NON_FINITE = "non-finite"


@dataclasses.dataclass
class ScalingPlan:
    """The full assignment one agent proposes for one autoscaling cycle.

    A plan is a *declaration* of desired state, not a sequence of commands:
    the platform arbitrates all of it at once, so the outcome does not
    depend on the order services appear in ``assignments``.
    """

    assignments: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    agent: str = ""          # who proposed it (for receipts / logging)
    cycle: int = -1          # the proposing agent's round counter

    def set(self, sid: str, param: str, value: float) -> "ScalingPlan":
        """Add/overwrite one target value; returns self for chaining."""
        self.assignments.setdefault(str(sid), {})[param] = float(value)
        return self

    def get(self, sid: str, param: str) -> Optional[float]:
        return self.assignments.get(str(sid), {}).get(param)

    @property
    def services(self) -> List[str]:
        return list(self.assignments)

    def entries(self) -> Iterator[Tuple[str, str, float]]:
        for sid, params in self.assignments.items():
            for param, value in params.items():
                yield sid, param, value

    def __len__(self) -> int:
        return sum(len(p) for p in self.assignments.values())

    def merge(self, other: "ScalingPlan") -> "ScalingPlan":
        """Later plan wins on conflicts; returns a new plan."""
        merged = ScalingPlan({k: dict(v) for k, v in self.assignments.items()},
                             agent=other.agent or self.agent,
                             cycle=max(self.cycle, other.cycle))
        for sid, param, value in other.entries():
            merged.set(sid, param, value)
        return merged

    def restrict(self, sids) -> "ScalingPlan":
        """Sub-plan containing only the given services."""
        keep = {str(s) for s in sids}
        return ScalingPlan(
            {k: dict(v) for k, v in self.assignments.items() if k in keep},
            agent=self.agent, cycle=self.cycle)


@dataclasses.dataclass(frozen=True)
class ParameterOutcome:
    """One (service, parameter) verdict of an applied plan."""

    sid: str
    param: str
    requested: float
    applied: Optional[float]          # None iff status == REJECTED
    status: str                       # APPLIED | CLIPPED | REJECTED
    reason: str = ""                  # REASON_* when not APPLIED

    @property
    def ok(self) -> bool:
        return self.status != REJECTED


@dataclasses.dataclass
class PlanReceipt:
    """Per-parameter outcomes of one ``apply_plan`` transaction."""

    outcomes: List[ParameterOutcome] = dataclasses.field(default_factory=list)
    host: str = ""                    # applying host ("" for fleet-merged)

    def outcome(self, sid: str, param: str) -> Optional[ParameterOutcome]:
        for o in self.outcomes:
            if o.sid == str(sid) and o.param == param:
                return o
        return None

    def applied(self) -> Dict[str, Dict[str, float]]:
        """sid -> param -> actually-applied value (rejected entries omitted)."""
        out: Dict[str, Dict[str, float]] = {}
        for o in self.outcomes:
            if o.ok:
                out.setdefault(o.sid, {})[o.param] = float(o.applied)
        return out

    def clipped(self) -> List[ParameterOutcome]:
        return [o for o in self.outcomes if o.status == CLIPPED]

    def rejected(self) -> List[ParameterOutcome]:
        return [o for o in self.outcomes if o.status == REJECTED]

    @property
    def ok(self) -> bool:
        """True iff nothing was rejected (clips are normal operation)."""
        return not self.rejected()

    def merge(self, other: "PlanReceipt") -> "PlanReceipt":
        return PlanReceipt(self.outcomes + other.outcomes)


def water_fill(demands: np.ndarray, floors: np.ndarray,
               available: float) -> np.ndarray:
    """Order-independent max-min fair allocation with per-item floors.

    Grants every item at least its floor, then raises a common water level
    theta, granting ``floor_i + min(extra_i, theta)`` where
    ``extra_i = demand_i - floor_i``, until the available budget is spent.
    Small demands are fully satisfied; large ones are capped at the level.
    The result is a pure function of the (demand, floor) multiset and the
    budget — registration or plan order cannot change it.
    """
    demands = np.asarray(demands, np.float64)
    floors = np.asarray(floors, np.float64)
    demands = np.maximum(demands, floors)
    extra = demands - floors
    remaining = float(available) - float(floors.sum())
    if remaining <= 0.0:
        return floors.copy()              # over-subscribed even at the floors
    if float(extra.sum()) <= remaining:
        return demands.copy()             # everything fits — grant in full
    order = np.sort(extra)
    granted_below = 0.0                   # total extra of fully-granted items
    n = len(order)
    theta = 0.0
    for i, e in enumerate(order):
        theta = (remaining - granted_below) / (n - i)
        if theta <= e:
            break
        granted_below += e
    return floors + np.minimum(extra, theta)


@dataclasses.dataclass
class DecisionInfo:
    """Side-channel metadata of one ``decide()`` call (for CycleRecords)."""

    explored: bool = False
    runtime_s: float = 0.0                # steady-state fit + solve duration
    score: float = float("nan")           # solver objective, if any
    # one-off kernel build time, nonzero only on the first solved decide of
    # an agent on the card — kept out of runtime_s
    compile_s: float = 0.0
    # PGD solver budget of this decide (0: not a PGD solve cycle)
    pgd_starts: int = 0
    pgd_iters: int = 0
    # placement migrations applied by the per-cycle rebalance stage
    moves: int = 0
    # placement-scorer budget (0: no scoring ran this cycle)
    score_starts: int = 0
    score_iters: int = 0
    # SLO error-budget control plane (obs): services with a firing
    # fast-burn alert, and the worst long-window burn rate seen this cycle
    burn_alerts: int = 0
    max_burn: float = 0.0
    # pipelined decide (RaskConfig(pipeline=True)): per-phase blocked times.
    # ``dispatch_s`` is the host time to queue this cycle's solve on the
    # agent's stream (the device runs it while the environment applies the
    # plan), ``collect_s`` the wait for the PREVIOUS cycle's solve and its
    # copy; ``runtime_s`` is their sum — the decide latency the control
    # loop actually blocks on
    pipelined: bool = False
    dispatch_s: float = 0.0
    collect_s: float = 0.0
    # proactive scaling (RaskConfig(forecast=True)): services whose hybrid
    # gate solved against predicted-horizon load this cycle, and the worst
    # rolling relative forecast error across gate-evaluated services —
    # forecast_used == 0 with forecast on means every service fell back to
    # reactive rps (gate closed: cold forecaster or error spike)
    forecast_used: int = 0
    forecast_err: float = 0.0


@dataclasses.dataclass
class CycleResult:
    """Legacy per-cycle summary returned by ``Agent.cycle`` (kept so seed
    callers and benchmarks keep working; new code reads ``PlanReceipt``)."""

    rounds: int
    explored: bool
    assignments: Dict[str, Dict[str, float]]
    runtime_s: float                      # steady-state fit + solve (E4/E5/E6)
    solver_score: float = float("nan")
    receipt: Optional[PlanReceipt] = None
    compile_s: float = 0.0                # first-solve kernel build time


@runtime_checkable
class Agent(Protocol):
    """The one protocol every autoscaling agent speaks.

    The environment loop is then agent-agnostic:
    ``obs = agent.observe(t); plan = agent.decide(obs);
    receipt = platform.apply_plan(plan)``.
    """

    def observe(self, t: float) -> Any:
        """Read stabilized state from the platform's telemetry at time t."""
        ...

    def decide(self, obs: Any) -> ScalingPlan:
        """Turn an observation into a declarative plan (no side effects on
        the platform — the caller applies the plan)."""
        ...


class PlanningAgent:
    """Base class: observe/decide implementations get ``cycle`` for free.

    Subclasses must set ``self.platform`` (anything with ``apply_plan``),
    maintain ``self.rounds``, and populate ``self.last_decision`` inside
    ``decide()``.
    """

    name = "agent"
    platform: Any
    rounds: int = -1

    def __init__(self) -> None:
        self.last_decision = DecisionInfo()

    def observe(self, t: float) -> Any:                 # pragma: no cover
        raise NotImplementedError

    def decide(self, obs: Any) -> ScalingPlan:          # pragma: no cover
        raise NotImplementedError

    def cycle(self, t: float) -> CycleResult:
        """Legacy imperative loop: observe, decide, apply, summarize."""
        obs = self.observe(t)
        plan = self.decide(obs)
        receipt = self.platform.apply_plan(plan)
        info = self.last_decision
        return CycleResult(self.rounds, info.explored, receipt.applied(),
                           info.runtime_s, info.score, receipt=receipt,
                           compile_s=info.compile_s)
