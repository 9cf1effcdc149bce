"""Fleet — several MUDAP hosts behind one control plane (the port's copy of
``repro/core/fleet.py``; no JAX there, plain Python here too).

The paper's platform manages one edge device; the ROADMAP north star is many
services spread over many devices. ``Fleet`` keeps the per-host MUDAPs (each
with its *own* capacity C and water-filling arbitration) and adds:

* **placement** — ``place()`` registers a service on an explicit host, on
  the host with the best predicted *marginal SLO fulfillment* (when the
  caller supplies per-host scores, e.g. ``RASKAgent.placement_scores``), or
  on the least-loaded one (largest fractional resource headroom);
  ``rebalance()`` migrates services toward higher-scoring hosts, guarded by
  a hysteresis threshold so only decisively better moves happen;
* **plan routing** — ``apply_plan`` splits a fleet-wide ``ScalingPlan`` by
  placement, applies each host's sub-plan transactionally, and merges the
  per-host ``PlanReceipt``s, so an agent proposes one plan for 9+ services
  across 3 devices exactly like it does for 3 services on one;
* **aggregate views** — ``capacity`` (summed budgets), bulk
  ``window_states``, and the same registry/telemetry surface as a single
  MUDAP, so every agent runs unmodified on a fleet.

RASK does not optimize against the summed-capacity relaxation: on a Fleet
it builds a ``FleetSolverProblem`` (core/solver.py) from the
``hosts()``/``host_of`` topology and solves every host's services against
that host's OWN budget, one batched kernel launch per layout bucket and
ascent step, so its plans are per-host feasible by construction.
Apply-time water-filling stays as the safety net for everything that does
not solve per host — action noise and hand-built plans — with clips
reported in the receipt.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .api import ParameterOutcome, PlanReceipt, REASON_UNKNOWN_SERVICE, \
    REJECTED, ScalingPlan
from .elasticity import ApiDescription, ServiceId
from .platform import MUDAP, ManagedService, ServiceBackend
from .slo import SLO


class Fleet:
    """Multi-host control plane with the single-host MUDAP surface."""

    def __init__(self, hosts: Sequence[MUDAP], hysteresis: float = 0.05):
        """``hysteresis``: minimum predicted marginal-fulfillment gain over
        the current host before ``rebalance`` migrates a service (migrations
        cost settling time and discard telemetry locality, so only
        decisively better placements move)."""
        self._hosts: Dict[str, MUDAP] = {}
        self.hysteresis = float(hysteresis)
        for h in hosts:
            if h.host in self._hosts:
                raise ValueError(f"duplicate host {h.host!r}")
            self._hosts[h.host] = h
        self._placement: Dict[str, str] = {}  # sid -> host name
        for name, h in self._hosts.items():   # adopt pre-registered services
            for sid in h.services():
                self._placement[sid] = name

    # -- topology -------------------------------------------------------------
    def hosts(self) -> List[MUDAP]:
        return list(self._hosts.values())

    def host_of(self, sid: str) -> MUDAP:
        return self._hosts[self._placement[str(sid)]]

    @property
    def capacity(self) -> Dict[str, float]:
        """Fleet-aggregate resource budget (reporting/placement view; the
        RASK solver uses the per-host budgets via ``FleetSolverProblem``)."""
        total: Dict[str, float] = {}
        for h in self._hosts.values():
            for r, c in h.capacity.items():
                total[r] = total.get(r, 0.0) + c
        return total

    # -- placement ------------------------------------------------------------
    def place(self, sid: ServiceId, api: ApiDescription,
              backend: ServiceBackend, slos: List[SLO],
              assignment: Optional[Dict[str, float]] = None,
              host: Optional[str] = None,
              scores: Optional[Mapping[str, float]] = None) -> str:
        """Register a service and record the placement; returns the chosen
        host name.  Host choice, in priority order: an explicit ``host``;
        the best of ``scores`` (host name -> predicted marginal SLO
        fulfillment of hosting this service there, e.g. from
        ``RASKAgent.placement_scores``); the least-loaded host."""
        if host is None:
            host = self._best_host(scores) if scores else self._least_loaded()
        if host not in self._hosts:
            raise KeyError(f"unknown host {host!r}")
        self._hosts[host].register(sid, api, backend, slos, assignment)
        self._placement[str(sid)] = host
        return host

    def _best_host(self, scores: Mapping[str, float]) -> str:
        """Highest marginal-fulfillment host (ties broken by host id)."""
        known = {h: float(s) for h, s in scores.items() if h in self._hosts}
        if not known:
            raise KeyError(f"no known host in scores {sorted(scores)}")
        return min(known, key=lambda h: (-known[h], h))

    def _least_loaded(self, exclude: Sequence[str] = ()) -> str:
        """Host with the largest worst-case fractional headroom.  All ties
        — equal headroom, then equal service count — resolve on the host id
        (NOT registration/dict order), so placement is reproducible across
        runs regardless of the order hosts were constructed in."""
        def score(h: MUDAP):
            fracs = []
            for r, cap in h.capacity.items():
                used = sum(h.assignment(s).get(r, 0.0) for s in h.services())
                fracs.append((cap - used) / cap if cap > 0 else 0.0)
            headroom = min(fracs) if fracs else 1.0
            return (-headroom, len(h.services()), h.host)

        pool = [h for n, h in self._hosts.items() if n not in set(exclude)]
        if not pool:
            raise ValueError("no eligible host")
        return min(pool, key=score).host

    def migrate(self, sid: str, host: str,
                carry_telemetry: bool = True) -> str:
        """Move a placed service to ``host``: deregister from the source
        (its holdings are released), re-register on the destination with the
        same API/SLOs/backend and its last-applied assignment (arbitrated
        against the destination's own capacity), and carry its telemetry
        ring-buffer window into the destination host's DB — windowed
        queries (``window_state``/``window_means``) are identical across
        the move, so the agent's stabilized-state observations and training
        feed survive rebalancing.  ``carry_telemetry=False`` models an
        abrupt host *failure*, where the source DB is lost with the host.
        A failed destination register restores the source placement (and
        touches no telemetry), so a migration is all-or-nothing."""
        key = str(sid)
        src = self._placement[key]
        if host not in self._hosts:
            raise KeyError(f"unknown host {host!r}")
        if src == host:
            return host
        svc = self._hosts[src].service(key)
        assignment = dict(svc.assignment)
        self._hosts[src].deregister(key)
        try:
            self._hosts[host].register(svc.sid, svc.api, svc.backend,
                                       list(svc.slos), assignment)
        except Exception:
            self._hosts[src].register(svc.sid, svc.api, svc.backend,
                                      list(svc.slos), assignment)
            raise
        if carry_telemetry:
            self._hosts[src].db.transfer(key, self._hosts[host].db)
        self._placement[key] = host
        return host

    def rebalance(self, scores: Mapping[str, Mapping[str, float]],
                  hysteresis: Optional[float] = None,
                  limit: Optional[int] = None) -> List[Tuple[str, str, str]]:
        """Migrate services toward their highest-scoring hosts.

        ``scores``: sid -> {host -> predicted marginal SLO fulfillment of
        that service on that host} (see ``RASKAgent.placement_scores``).  A
        service moves only when its best host (ties: host id) beats its
        CURRENT host's score by more than the hysteresis threshold — below
        it ``rebalance`` is a no-op.  Candidate moves are applied in
        descending-gain order (ties: sid), at most ``limit`` of them.

        ``scores`` is a *snapshot*: marginal fulfillment is
        contention-coupled (a move changes every other score on the two
        hosts it touches), so callers applying more than one move should
        re-score between moves — ``RASKAgent.rebalance`` passes
        ``limit=1`` per fresh snapshot, which makes each applied move a
        strict fleet-fulfillment improvement and the loop idempotent once
        no gain clears the gate.  Returns the applied moves as
        (sid, from_host, to_host).
        """
        gate = self.hysteresis if hysteresis is None else float(hysteresis)
        candidates: List[Tuple[float, str, str, str]] = []
        for sid in sorted(scores):
            src = self._placement.get(sid)
            if src is None:
                continue
            known = {h: float(s) for h, s in scores[sid].items()
                     if h in self._hosts}
            # the CURRENT host must be scored: defaulting a missing source
            # score would turn an incomplete candidate map into a migration
            # away from a possibly-better host
            if src not in known:
                continue
            best = self._best_host(known)
            gain = known[best] - known[src]
            if best != src and gain > gate:
                candidates.append((-gain, sid, src, best))
        moves: List[Tuple[str, str, str]] = []
        for _, sid, src, best in sorted(candidates)[:limit]:
            self.migrate(sid, best)
            moves.append((sid, src, best))
        return moves

    def deregister(self, sid: str) -> None:
        key = str(sid)
        host = self._placement.pop(key, None)
        if host is not None:
            self._hosts[host].deregister(key)

    # -- churn: hosts leaving / losing capacity mid-run ------------------------
    def evacuate(self, name: str,
                 scores: Optional[Mapping[str, Mapping[str, float]]] = None,
                 carry_telemetry: bool = True) -> List[Tuple[str, str, str]]:
        """Migrate every resident off host ``name`` (failure or drain).

        Destinations come from each service's ``scores`` row (sid -> {host
        -> predicted marginal fulfillment}, e.g. the batched
        ``RASKAgent.placement_scores``) restricted to OTHER hosts; services
        without a scored row fall back to the least-loaded other host.
        ``carry_telemetry`` as in ``migrate`` (False = the failed host's DB
        is lost).  Returns the applied moves (sid, from, to); the emptied
        host stays in the fleet until ``remove_host``."""
        if name not in self._hosts:
            raise KeyError(f"unknown host {name!r}")
        if len(self._hosts) < 2:
            raise ValueError(f"no other host to evacuate {name!r} onto")
        moves: List[Tuple[str, str, str]] = []
        for sid in sorted(self._hosts[name].services()):
            row = {h: float(s) for h, s in (scores or {}).get(sid, {}).items()
                   if h in self._hosts and h != name}
            dst = self._best_host(row) if row \
                else self._least_loaded(exclude=(name,))
            self.migrate(sid, dst, carry_telemetry=carry_telemetry)
            moves.append((sid, name, dst))
        return moves

    def remove_host(self, name: str) -> MUDAP:
        """Drop an (evacuated) host from the fleet.  The host must hold no
        services — evacuate first (``env.simulator`` fail/drain events
        migrate residents via the placement scorer before removing the
        device).  Returns the detached MUDAP."""
        if name not in self._hosts:
            raise KeyError(f"unknown host {name!r}")
        residents = self._hosts[name].services()
        if residents:
            raise ValueError(
                f"host {name!r} still holds {sorted(residents)}; "
                f"evacuate before removing it")
        return self._hosts.pop(name)

    def set_capacity(self, name: str, resource: str, value: float) -> float:
        """Change one host's resource budget in place (capacity
        degradation/recovery).  Existing holdings are NOT clawed back — the
        next applied plan arbitrates against the new budget (and per-host
        solvers rebuilt after this see it immediately).  Returns the new
        value."""
        host = self._hosts.get(name)
        if host is None:
            raise KeyError(f"unknown host {name!r}")
        if resource not in host.capacity:
            raise KeyError(f"host {name!r} has no resource {resource!r}")
        host.capacity[resource] = float(value)
        return float(value)

    # -- registry views --------------------------------------------------------
    def services(self) -> List[str]:
        return [s for h in self._hosts.values() for s in h.services()]

    def service(self, sid: str) -> ManagedService:
        return self.host_of(sid).service(sid)

    def assignment(self, sid: str) -> Dict[str, float]:
        return self.host_of(sid).assignment(sid)

    def api_descriptions(self) -> Dict[str, ApiDescription]:
        out: Dict[str, ApiDescription] = {}
        for h in self._hosts.values():
            out.update(h.api_descriptions())
        return out

    # -- transactional plan routing -------------------------------------------
    def apply_plan(self, plan: ScalingPlan) -> PlanReceipt:
        """Split by placement, apply each host's sub-plan atomically, merge
        the receipts. Entries for unplaced services are rejected."""
        by_host: Dict[str, ScalingPlan] = {}
        receipt = PlanReceipt()
        for sid, params in plan.assignments.items():
            host = self._placement.get(sid)
            if host is None:
                receipt.outcomes.extend(
                    ParameterOutcome(sid, p, float(v), None, REJECTED,
                                     REASON_UNKNOWN_SERVICE)
                    for p, v in params.items())
                continue
            sub = by_host.setdefault(
                host, ScalingPlan(agent=plan.agent, cycle=plan.cycle))
            for p, v in params.items():
                sub.set(sid, p, v)
        for host, sub in by_host.items():
            receipt = receipt.merge(self._hosts[host].apply_plan(sub))
        return receipt

    def scale(self, sid: str, param: str, value: float) -> float:
        """Legacy one-entry shim, routed to the owning host."""
        return self.host_of(sid).scale(sid, param, value)

    def reset_defaults(self) -> None:
        for h in self._hosts.values():
            h.reset_defaults()

    # -- telemetry -------------------------------------------------------------
    def pump(self, t: float, dt: float = 1.0) -> None:
        """Advance real-work backends (``advance`` hook) on every host."""
        for h in self._hosts.values():
            h.pump(t, dt)

    def scrape(self, t: float) -> None:
        for h in self._hosts.values():
            h.scrape(t)

    def window_state(self, sid: str, since: float,
                     until: Optional[float] = None) -> Dict[str, float]:
        return self.host_of(sid).window_state(sid, since, until)

    def window_states(self, since: float, until: Optional[float] = None
                      ) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for h in self._hosts.values():
            out.update(h.window_states(since, until))
        return out

    def window_columns(self, since: float, until: Optional[float] = None
                       ) -> Dict[str, Tuple]:
        """Raw columnar windows of all services, merged across hosts (each
        service lives on exactly one host, so the union is disjoint) — the
        fleet leg of the SLO accountant's bulk SLI feed."""
        out: Dict[str, Tuple] = {}
        for h in self._hosts.values():
            out.update(h.window_columns(since, until))
        return out

    def latest_metrics(self, sid: str) -> Dict[str, float]:
        return self.host_of(sid).latest_metrics(sid)
