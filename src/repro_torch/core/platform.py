"""MUDAP — the Multi-dimensional Autoscaling Platform (paper §III); the
port's copy of ``repro/core/platform.py``.

The platform is *service-agnostic*: it knows nothing about what a parameter
does. Each managed service hands MUDAP (1) an ``ApiDescription`` (Table I) and
(2) a ``ServiceBackend`` handle — the moral equivalent of the in-container
HTTP server + Docker API of the prototype.

Scaling goes through the declarative control plane (``core/api.py``): an
agent proposes a ``ScalingPlan`` and ``apply_plan`` applies it as one
transaction — every value is validated, clipped to the advertised
bounds/steps, and resource-class parameters are arbitrated against the
*global* capacity C with order-independent water-filling (max-min fair with
per-parameter floors), so no service can starve the rest and the outcome
never depends on registration or plan order. The caller gets a
``PlanReceipt`` recording, per parameter, whether the request was applied,
clipped (and why: bounds vs capacity), or rejected.

The imperative ``scale(sid, param, value)`` of the seed survives as a thin
shim over a one-entry plan for one release.

Metrics are scraped every second into the ``TimeSeriesDB`` (§III-A), from
which agents read windowed aggregates (§IV-A) — per service or in bulk via
``window_states`` (one DB query for all services).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Protocol, Tuple

from .api import APPLIED, CLIPPED, REASON_BOUNDS, REASON_CAPACITY, \
    REASON_NON_FINITE, REASON_UNKNOWN_PARAM, REASON_UNKNOWN_SERVICE, \
    REJECTED, ParameterOutcome, PlanReceipt, ScalingPlan, water_fill
from .elasticity import ApiDescription, ElasticityParameter, ServiceId
from .slo import SLO
from .telemetry import TimeSeriesDB


class ServiceBackend(Protocol):
    """What a container must expose to the platform (REST/Docker API stand-in)."""

    def apply(self, param: str, value: float) -> None:
        """Handle e.g. /quality?resolution=1080 — adjust live, no restart."""
        ...

    def metrics(self) -> Dict[str, float]:
        """Current service+container metrics (scraped every 1 s)."""
        ...


@dataclasses.dataclass
class ManagedService:
    sid: ServiceId
    api: ApiDescription
    backend: ServiceBackend
    slos: List[SLO]
    assignment: Dict[str, float]  # last applied values


@dataclasses.dataclass
class _Entry:
    """One validated plan entry during arbitration."""

    sid: str
    param: ElasticityParameter
    requested: float
    value: float                  # current working value (clipped so far)
    reason: str = ""              # decisive clip reason so far


class MUDAP:
    """Registry + transactional ScalingPlan API + metric scraping for one
    device (host)."""

    def __init__(self, capacity: Mapping[str, float], host: str = "edge-0"):
        """capacity: global resource constraints C, e.g. {"cores": 8.0}."""
        self.capacity = dict(capacity)
        self.host = host
        self.db = TimeSeriesDB()
        self._services: Dict[str, ManagedService] = {}

    # -- registry -----------------------------------------------------------
    def register(self, sid: ServiceId, api: ApiDescription,
                 backend: ServiceBackend, slos: List[SLO],
                 assignment: Optional[Dict[str, float]] = None) -> PlanReceipt:
        key = str(sid)
        if key in self._services:
            raise ValueError(f"service {key} already registered")
        a = dict(assignment) if assignment else api.defaults()
        self._services[key] = ManagedService(sid, api, backend, list(slos), {})
        try:
            return self.apply_plan(ScalingPlan({key: a}, agent="register"))
        except Exception:
            # a failed initial apply must not leave a half-configured service
            # in the registry (its backend state would be invisible to the
            # capacity arbitration)
            self._services.pop(key, None)
            raise

    def deregister(self, sid: str) -> None:
        """Remove a service; its resource holdings are released immediately
        (the next plan arbitrates against the freed headroom)."""
        self._services.pop(str(sid), None)

    def services(self) -> List[str]:
        return list(self._services)

    def service(self, sid: str) -> ManagedService:
        return self._services[str(sid)]

    # -- transactional ScalingPlan API (Fig. 2 step 4, redesigned) -----------
    def apply_plan(self, plan: ScalingPlan) -> PlanReceipt:
        """Apply a full plan atomically with order-independent arbitration.

        Three phases: (1) validate and clip every entry to its parameter's
        bounds/step; (2) for each globally-constrained resource, water-fill
        the plan's demands into the headroom left by services *not* in the
        plan (their holdings are kept untouched); (3) apply all final values
        to the backends — nothing touches a backend before the whole plan is
        arbitrated, and a backend failure rolls back the values already
        pushed, so a plan is all-or-nothing. (Rollback restores previously
        applied values; a parameter that had never been applied has no prior
        value to restore, so it is only dropped from the accounting —
        ``register`` additionally evicts the service on a failed first
        apply.)
        """
        rejected: List[ParameterOutcome] = []
        entries: List[_Entry] = []

        # phase 1 — validation + bounds/step clipping
        for sid, params in plan.assignments.items():
            svc = self._services.get(sid)
            for param, value in params.items():
                if svc is None:
                    rejected.append(ParameterOutcome(
                        sid, param, float(value), None, REJECTED,
                        REASON_UNKNOWN_SERVICE))
                    continue
                try:
                    p = svc.api.parameter(param)
                except KeyError:
                    rejected.append(ParameterOutcome(
                        sid, param, float(value), None, REJECTED,
                        REASON_UNKNOWN_PARAM))
                    continue
                if not math.isfinite(float(value)):
                    rejected.append(ParameterOutcome(
                        sid, param, float(value), None, REJECTED,
                        REASON_NON_FINITE))
                    continue
                v = p.clip(float(value))
                entries.append(_Entry(
                    sid, p, float(value), v,
                    REASON_BOUNDS if abs(v - float(value)) > 1e-12 else ""))

        # phase 2 — global capacity arbitration, one resource at a time
        for resource, cap in self.capacity.items():
            group = [e for e in entries
                     if e.param.is_resource and e.param.name == resource]
            if not group:
                continue
            in_plan = {e.sid for e in group}
            held = sum(svc.assignment.get(resource, 0.0)
                       for key, svc in self._services.items()
                       if key not in in_plan)
            grants = water_fill([e.value for e in group],
                                [e.param.min_value for e in group],
                                cap - held)
            for e, g in zip(group, grants):
                g = float(g)
                if g < e.value - 1e-9:
                    e.value = self._snap_down(e.param, g)
                    e.reason = REASON_CAPACITY

        # phase 3 — apply everything (compute-then-commit, with rollback)
        pushed: List[Tuple[ManagedService, str, Optional[float]]] = []
        try:
            for e in entries:
                svc = self._services[e.sid]
                prev = svc.assignment.get(e.param.name)
                svc.backend.apply(e.param.name, e.value)
                svc.assignment[e.param.name] = e.value
                pushed.append((svc, e.param.name, prev))
        except Exception:
            for svc, name, prev in reversed(pushed):
                if prev is None:
                    svc.assignment.pop(name, None)
                else:
                    svc.backend.apply(name, prev)
                    svc.assignment[name] = prev
            raise

        outcomes = [ParameterOutcome(
            e.sid, e.param.name, e.requested, e.value,
            CLIPPED if e.reason else APPLIED, e.reason) for e in entries]
        return PlanReceipt(outcomes + rejected, host=self.host)

    @staticmethod
    def _snap_down(p: ElasticityParameter, grant: float) -> float:
        """Clip a capacity grant without letting step-snapping round it back
        *up* over the arbitrated budget."""
        v = p.clip(grant)
        if p.step and v > grant + 1e-9:
            v = max(v - p.step, p.min_value)
        return v

    # -- legacy imperative shims (kept for one release) ----------------------
    def scale(self, sid: str, param: str, value: float) -> float:
        """One-entry-plan shim; returns the actually-applied value."""
        key = str(sid)
        if key not in self._services:
            raise KeyError(key)
        receipt = self.apply_plan(
            ScalingPlan({key: {param: float(value)}}, agent="scale-shim"))
        out = receipt.outcomes[0]
        if out.status == REJECTED:
            raise KeyError(f"{key}: {param} ({out.reason})")
        return out.applied

    def scale_all(self, assignments: Mapping[str, Mapping[str, float]]
                  ) -> Dict[str, Dict[str, float]]:
        """Shim over ``apply_plan`` — now order-independent by construction."""
        plan = ScalingPlan({sid: dict(a) for sid, a in assignments.items()},
                           agent="scale-all-shim")
        return self.apply_plan(plan).applied()

    def assignment(self, sid: str) -> Dict[str, float]:
        return dict(self._services[str(sid)].assignment)

    # -- time advancement ----------------------------------------------------
    def pump(self, t: float, dt: float = 1.0) -> None:
        """Advance every backend that owns real work by ``dt`` seconds.

        Backends are polled for an optional ``advance(t, dt)`` hook: simulated
        services integrate their queue model, served services (serve/) run
        their engine's decode steps for the tick's wall-clock budget. Backends
        without the hook are skipped — scrape-only backends stay valid.
        """
        for svc in self._services.values():
            advance = getattr(svc.backend, "advance", None)
            if advance is not None:
                advance(t, dt)

    # -- metric scraping (Fig. 2 step 3) --------------------------------------
    def scrape(self, t: float) -> None:
        # one bulk DB write (single lock acquisition) for all containers
        self.db.scrape_many(
            t, {key: svc.backend.metrics()
                for key, svc in self._services.items()})

    def window_state(self, sid: str, since: float,
                     until: Optional[float] = None) -> Dict[str, float]:
        """Stabilized state: windowed mean per §IV-A (last 5 s of the cycle)."""
        return self.db.window_mean(str(sid), since, until)

    def window_states(self, since: float, until: Optional[float] = None
                      ) -> Dict[str, Dict[str, float]]:
        """Stabilized states of *all* services in one bulk DB query."""
        return self.db.window_means(list(self._services), since, until)

    def window_columns(self, since: float, until: Optional[float] = None
                       ) -> Dict[str, Tuple]:
        """Raw columnar windows of all services in one bulk DB query:
        {sid: (timestamps, column names, values)}."""
        return self.db.export_windows(list(self._services), since, until)

    def latest_metrics(self, sid: str) -> Dict[str, float]:
        """Most recent scrape of one service ({} before the first scrape)."""
        s = self.db.latest(str(sid))
        return dict(s.metrics) if s else {}

    def api_descriptions(self) -> Dict[str, ApiDescription]:
        return {k: s.api for k, s in self._services.items()}

    def reset_defaults(self) -> None:
        """Paper §V-B(c): reset elasticity parameters between experimental runs
        (resource params get an equal share C/|S|; others their half-range).
        One transactional plan — no release-then-grant dance needed."""
        n = max(len(self._services), 1)
        plan = ScalingPlan(agent="reset")
        for key, svc in self._services.items():
            for p in svc.api.parameters:
                if p.is_resource and p.name in self.capacity:
                    plan.set(key, p.name, self.capacity[p.name] / n)
                else:
                    plan.set(key, p.name, p.default)
        self.apply_plan(plan)
