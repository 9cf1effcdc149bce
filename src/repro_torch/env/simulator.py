"""Discrete-time processing-environment simulator (1 s ticks).

Replicates the paper's runtime at the fidelity the autoscaler observes:
services pull items from a buffer every second and process as many as the
current configuration allows (§V-B); scaling actions need a settling time of
up to ~5 s (§IV); metrics are scraped every second (§III-A).

The *hidden* capacity comes from the profile's ``tp_max`` surface plus
multiplicative measurement noise. Backpressure is modeled with a bounded
buffer: unprocessed items queue up (and are drained later), items beyond the
buffer are dropped — throughput/completion therefore reflect both load and
capacity history, like the real prototype.

Vectorized container pool
-------------------------
All containers of one environment live in a ``ContainerPool`` — a
structure-of-arrays store (targets/currents padded to the widest parameter
set, rps/queue/metric vectors) whose ``tick`` steps *every* container's
settle, queue, throughput and utilization update as batch numpy ops; only
the per-profile hidden ``tp_max`` surface (an opaque Python callable) and
the per-container RNG draws (kept per-container so seeded trajectories are
reproducible regardless of pool size) remain scalar.  ``SimulatedService``
is a per-container *view* into a pool (standalone instances own a pool of
one), so the single-service API is unchanged while ``EdgeEnvironment.run``
advances the whole fleet with one ``pool.tick`` per simulated second.
Padding invariant: parameter slots beyond a container's API are masked out
of settling and never surface in ``metrics()``.

``EdgeEnvironment`` wires profiles + workloads + one MUDAP host and drives
any ``Agent`` (``observe``/``decide``) through the standard experiment loop:
observe, decide a ``ScalingPlan``, apply it transactionally, record
per-cycle Eq. (8) fulfillment — the measurement every figure of the paper's
evaluation is built from. Legacy agents exposing only ``cycle(t)`` still
work.

This is the port's copy of ``repro/env/simulator.py`` for one device.
Several hosts, placement policies and churn events need the multi-host
``Fleet`` (``core/fleet.py``), which is not ported yet: they raise
``NotImplementedError`` naming ROADMAP Queue 1 item 1 (``fleet.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.api import Agent, CycleResult, DecisionInfo, PlanReceipt
from ..core.elasticity import ServiceId
from ..core.platform import MUDAP
from ..core.slo import global_fulfillment, service_fulfillment
from .profiles import ServiceProfile
from .workloads import Pattern, constant


class ContainerPool:
    """Structure-of-arrays state for N simulated containers.

    ``tick`` updates settle/queue/throughput/utilization for an index subset
    (default: all) with vectorized numpy ops.  Containers keep their own
    ``np.random.Generator`` and draw in a fixed order (capacity noise, then
    utilization noise) so per-container random streams match the seed-era
    scalar simulator exactly.
    """

    def __init__(self):
        self.profiles: List[ServiceProfile] = []
        self.rngs: List[np.random.Generator] = []
        self.param_names: List[Tuple[str, ...]] = []
        self.n = 0
        self.p_max = 0
        # SoA state — (N,) unless noted
        self.settle_tau = np.zeros(0)
        self.buffer_s = np.zeros(0)
        self.noise = np.zeros(0)
        self.parallel_eff = np.zeros(0)
        self.rps = np.zeros(0)
        self.queue = np.zeros(0)
        self.target = np.zeros((0, 0))       # (N, P_max)
        self.current = np.zeros((0, 0))      # (N, P_max)
        self.res_mask = np.zeros((0, 0), bool)
        self.present = np.zeros((0, 0), bool)
        self.throughput = np.zeros(0)
        self.tp_cap = np.zeros(0)
        self.completion = np.zeros(0)
        self.utilization = np.zeros(0)

    # -- registration --------------------------------------------------------
    def add(self, profile: ServiceProfile, rng: np.random.Generator,
            settle_tau: float = 1.5, buffer_s: float = 3.0,
            noise: float = 0.02) -> int:
        i = self.n
        names = tuple(profile.api.names)
        self.profiles.append(profile)
        self.rngs.append(rng)
        self.param_names.append(names)
        self.n += 1
        p = max(self.p_max, len(names))
        if self.n > self.settle_tau.shape[0] or p > self.p_max:
            self._grow(p)   # amortized: row capacity doubles
        self.settle_tau[i] = settle_tau
        self.buffer_s[i] = buffer_s
        self.noise[i] = noise
        self.parallel_eff[i] = profile.parallel_eff
        self.rps[i] = profile.default_rps
        for j, name in enumerate(names):
            self.res_mask[i, j] = profile.api.parameter(name).is_resource
            d = profile.defaults.get(name)
            if d is not None:
                self.target[i, j] = self.current[i, j] = float(d)
                self.present[i, j] = True
        return i

    def _grow(self, p_max: int) -> None:
        # amortized doubling: rows grow geometrically, columns to the widest
        # API seen, so N registrations cost O(N) copies, not O(N^2)
        rows = max(2 * self.settle_tau.shape[0], self.n, 4)

        def vec(a):
            out = np.zeros(rows)
            out[:a.shape[0]] = a
            return out

        def mat(a, fill=0.0, dtype=float):
            out = np.full((rows, p_max), fill, dtype)
            out[:a.shape[0], :a.shape[1]] = a
            return out

        self.settle_tau = vec(self.settle_tau)
        self.buffer_s = vec(self.buffer_s)
        self.noise = vec(self.noise)
        self.parallel_eff = vec(self.parallel_eff)
        self.rps = vec(self.rps)
        self.queue = vec(self.queue)
        self.throughput = vec(self.throughput)
        self.tp_cap = vec(self.tp_cap)
        self.completion = vec(self.completion)
        self.utilization = vec(self.utilization)
        self.target = mat(self.target)
        self.current = mat(self.current)
        self.res_mask = mat(self.res_mask, False, bool)
        self.present = mat(self.present, False, bool)
        self.p_max = p_max

    def _col(self, i: int, param: str) -> int:
        try:
            return self.param_names[i].index(param)
        except ValueError:
            raise KeyError(param) from None

    # -- per-container surface ----------------------------------------------
    def apply(self, i: int, param: str, value: float) -> None:
        j = self._col(i, param)
        self.target[i, j] = float(value)
        self.present[i, j] = True
        if not self.res_mask[i, j]:
            self.current[i, j] = float(value)  # config switches are immediate

    def param_dict(self, i: int) -> Dict[str, float]:
        return {name: float(self.current[i, j])
                for j, name in enumerate(self.param_names[i])
                if self.present[i, j]}

    def metrics(self, i: int) -> Dict[str, float]:
        return {
            "rps": float(self.rps[i]),
            "throughput": float(self.throughput[i]),
            "tp_max": float(self.tp_cap[i]),     # from per-item latency, §V-B(a)
            "completion": float(self.completion[i]),
            "queue": float(self.queue[i]),
            "cpu_utilization": float(self.utilization[i]),
            **self.param_dict(i),
        }

    # -- simulation ----------------------------------------------------------
    def tick(self, t: float, dt: float = 1.0,
             idx: Optional[Sequence[int]] = None) -> None:
        """Advance the selected containers (default: all) by one step —
        settle, hidden capacity, queue/throughput, utilization — with batch
        numpy ops; only ``tp_max`` surfaces and RNG draws stay per-container."""
        del t  # dynamics are time-invariant; t kept for API symmetry
        ids = np.arange(self.n) if idx is None else np.asarray(idx, int)
        if ids.size == 0:
            return
        # settle resource params toward their targets (tau~1.5 s -> ~5 s to
        # converge, §IV: "processing services stabilized in less than 5s")
        alpha = 1.0 - np.exp(-dt / self.settle_tau[ids])
        cur = self.current[ids]
        step = (self.target[ids] - cur) * alpha[:, None]
        self.current[ids] = np.where(self.res_mask[ids] & self.present[ids],
                                     cur + step, cur)

        # hidden capacity: opaque per-profile surface + multiplicative noise
        caps = np.empty(ids.size)
        for k, i in enumerate(ids):
            caps[k] = self.profiles[i].tp_max(self.param_dict(int(i)))
        draws = np.array([self.rngs[int(i)].normal(1.0, self.noise[int(i)])
                          for i in ids])
        caps *= np.maximum(draws, 0.0)

        rps = self.rps[ids]
        arrivals = rps * dt
        work = self.queue[ids] + arrivals
        processed = np.minimum(work, caps * dt)
        self.queue[ids] = np.minimum(work - processed,
                                     rps * self.buffer_s[ids])  # bounded buffer
        throughput = processed / dt
        live = rps > 0
        completion = np.ones(ids.size)
        np.divide(throughput, rps, out=completion, where=live)
        completion = np.minimum(completion, 1.0)
        saturation = np.minimum(rps / np.maximum(caps, 1e-9), 1.0)
        # when saturated the container burns parallel_eff of its allocation;
        # when idle, usage tracks offered load
        udraws = np.array([self.rngs[int(i)].normal(1.0, 1.0) for i in ids])
        utilization = np.clip(
            self.parallel_eff[ids] * saturation + 0.02 * udraws, 0.0, 1.0)

        self.throughput[ids] = throughput
        self.tp_cap[ids] = caps
        self.completion[ids] = completion
        self.utilization[ids] = utilization


class SimulatedService:
    """ServiceBackend implementation: one containerized stream processor.

    A thin per-container view into a ``ContainerPool`` — standalone
    construction owns a private pool of one, ``EdgeEnvironment`` shares one
    pool across all containers and ticks it in bulk.
    """

    def __init__(self, profile: ServiceProfile, rng: np.random.Generator,
                 settle_tau: float = 1.5, buffer_s: float = 3.0,
                 noise: float = 0.02, pool: Optional[ContainerPool] = None):
        self.profile = profile
        self.pool = pool if pool is not None else ContainerPool()
        self.i = self.pool.add(profile, rng, settle_tau, buffer_s, noise)
        self.tick(0.0)

    # -- ServiceBackend ------------------------------------------------------
    def apply(self, param: str, value: float) -> None:
        self.pool.apply(self.i, param, value)

    def metrics(self) -> Dict[str, float]:
        return self.pool.metrics(self.i)

    # -- pool-backed state views ---------------------------------------------
    @property
    def rps(self) -> float:
        return float(self.pool.rps[self.i])

    @rps.setter
    def rps(self, value: float) -> None:
        self.pool.rps[self.i] = float(value)

    @property
    def queue(self) -> float:
        return float(self.pool.queue[self.i])

    @queue.setter
    def queue(self, value: float) -> None:
        self.pool.queue[self.i] = float(value)

    @property
    def current(self) -> Dict[str, float]:
        return self.pool.param_dict(self.i)

    @property
    def target(self) -> Dict[str, float]:
        p = self.pool
        return {name: float(p.target[self.i, j])
                for j, name in enumerate(p.param_names[self.i])
                if p.present[self.i, j]}

    # -- simulation ----------------------------------------------------------
    def tick(self, t: float, dt: float = 1.0) -> None:
        self.pool.tick(t, dt, idx=[self.i])

    def advance(self, t: float, dt: float = 1.0) -> None:
        """``MUDAP.pump`` hook — simulated services advance by ticking their
        pool row (``EdgeEnvironment.run`` ticks the whole pool itself and
        never pumps, so there is no double-advance)."""
        self.tick(t, dt)


_FLEET_TODO = ("needs the multi-host Fleet (core/fleet.py), not ported yet: "
               "ROADMAP Queue 1, slice B deferral 1 (fleet.py + "
               "FleetSolverProblem)")


@dataclasses.dataclass
class CycleRecord:
    t: float
    fulfillment: float
    per_service: Dict[str, float]
    runtime_s: float                      # steady-state fit + solve
    explored: bool
    rps: Dict[str, float]
    receipt: Optional[PlanReceipt] = None
    compile_s: float = 0.0                # first-solve kernel build time


class EdgeEnvironment:
    """One Edge device: control plane + simulated services + request
    workloads (``repro``'s ``EdgeEnvironment`` with ``hosts == 1``)."""

    def __init__(self, profiles: Sequence[ServiceProfile],
                 capacity: Mapping[str, float],
                 patterns: Optional[Mapping[str, Pattern]] = None,
                 replicas: int = 1, host: str = "edge-0", seed: int = 0,
                 hosts: int = 1, placement: str = "round_robin"):
        """``replicas`` spawns N independent containers per profile (E6)."""
        if not isinstance(hosts, int) or hosts > 1:
            raise NotImplementedError(f"hosts={hosts!r} {_FLEET_TODO}")
        if placement != "round_robin":
            raise NotImplementedError(
                f"placement={placement!r} {_FLEET_TODO}")
        self.host_capacity: Dict[str, Dict[str, float]] = {
            host: dict(capacity)}
        self.platform = MUDAP(dict(capacity), host=host)
        self.pool = ContainerPool()
        self.services: Dict[str, SimulatedService] = {}
        self.patterns: Dict[str, Pattern] = {}
        rng = np.random.default_rng(seed)
        self._routes: Optional[List[tuple]] = None
        # each container starts with an equal share of the device's
        # resources (§V-B(c))
        n_total = len(profiles) * replicas
        instance_of: Dict[str, int] = {}   # per-type container numbering
        for profile in profiles:
            for _r in range(replicas):
                c = instance_of.get(profile.type, 0)
                instance_of[profile.type] = c + 1
                sid = ServiceId(host, profile.type, f"c{c}")
                key = str(sid)
                backend = SimulatedService(
                    profile, np.random.default_rng(rng.integers(2 ** 31)),
                    pool=self.pool)
                defaults = dict(profile.defaults)
                for res, cap in capacity.items():
                    if res in profile.api.names:
                        defaults[res] = cap / n_total
                self.platform.register(sid, profile.api, backend,
                                       list(profile.slos), defaults)
                self.services[key] = backend
                pat = (patterns or {}).get(profile.type)
                self.patterns[key] = pat if pat else constant(profile.default_rps)
        self.t = 0.0

    # -- measured Eq. (8) ------------------------------------------------------
    def measured_fulfillment(self, window: float = 5.0
                             ) -> Tuple[float, Dict[str, float]]:
        per_service = {}
        metrics_list, slo_list = [], []
        states = self.platform.window_states(since=self.t - window,
                                             until=self.t)
        for key in self.platform.services():
            svc = self.platform.service(key)
            state = states.get(key)
            if not state:
                continue
            metrics_list.append(state)
            slo_list.append(svc.slos)
            per_service[key] = float(service_fulfillment(svc.slos, state))
        if not metrics_list:
            return 1.0, per_service
        return float(global_fulfillment(metrics_list, slo_list)), per_service

    # -- one agent cycle through the unified protocol ---------------------------
    def _drive(self, agent) -> CycleResult:
        """observe -> decide -> apply_plan for ``Agent``s; legacy agents
        exposing only ``cycle(t)`` are still driven through it."""
        if isinstance(agent, Agent):
            obs = agent.observe(self.t)
            plan = agent.decide(obs)
            receipt = self.platform.apply_plan(plan)
            info = getattr(agent, "last_decision", None) or DecisionInfo()
            return CycleResult(getattr(agent, "rounds", -1), info.explored,
                               receipt.applied(), info.runtime_s, info.score,
                               receipt=receipt, compile_s=info.compile_s)
        return agent.cycle(self.t)

    # -- main loop ----------------------------------------------------------------
    def run(self, agent, duration_s: float, cycle_s: float = 10.0,
            on_cycle: Optional[Callable] = None,
            events: Optional[Sequence] = None) -> List[CycleRecord]:
        """Tick the pool every simulated second, scrape, and drive the agent
        every ``cycle_s`` seconds. Scripted churn ``events`` raise."""
        if events:
            raise NotImplementedError(f"churn events {_FLEET_TODO}")
        history: List[CycleRecord] = []
        steps = int(duration_s)
        # (pool index, pattern) per container — indexing by the backend's own
        # pool slot, not dict position, so extra pool tenants cannot skew it
        self._routes = [(b.i, self.patterns[k])
                        for k, b in self.services.items()]
        for step in range(1, steps + 1):
            self.t += 1.0
            for j, pat in self._routes:          # workloads are opaque callables
                self.pool.rps[j] = pat(self.t)
            self.pool.tick(self.t)               # whole pool, one batched step
            self.platform.scrape(self.t)
            if step % int(cycle_s) == 0:
                result = self._drive(agent)
                fulfillment, per_service = self.measured_fulfillment()
                rec = CycleRecord(
                    self.t, fulfillment, per_service,
                    result.runtime_s if result else 0.0,
                    result.explored if result else False,
                    {k: self.services[k].rps for k in self.services},
                    receipt=result.receipt if result else None,
                    compile_s=result.compile_s if result else 0.0)
                history.append(rec)
                if on_cycle:
                    on_cycle(rec)
        return history
