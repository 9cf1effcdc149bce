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

``EdgeEnvironment`` wires profiles + workloads + a control plane — one MUDAP
host, or a multi-host ``Fleet`` when ``hosts > 1`` — and drives any ``Agent``
(``observe``/``decide``) through the standard experiment loop: observe,
decide a ``ScalingPlan``, apply it transactionally, record per-cycle Eq. (8)
fulfillment — the measurement every figure of the paper's evaluation is
built from. Legacy agents exposing only ``cycle(t)`` still work.

This is the port's copy of ``repro/env/simulator.py`` (numpy; the agent it
drives decides on its own device), churn events of all five kinds included.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, \
    Union

import numpy as np

from ..core.api import Agent, CycleResult, DecisionInfo, PlanReceipt
from ..core.elasticity import ServiceId
from ..core.fleet import Fleet
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
    # SLO error-budget control plane (obs), populated when the agent
    # carries an attached SLOAccountant: services with a firing fast-burn
    # alert, worst long-window burn rate, and the fleet-level rolling error
    # budget consumed (1.0 = the whole budget)
    alerts: int = 0
    max_burn: float = 0.0
    budget_consumed: float = 0.0
    # pipelined decide (RaskConfig(pipeline=True)): the blocked time splits
    # into the dispatch of THIS cycle's solve and the collect of the
    # previous one — runtime_s is their sum, the solve itself overlaps the
    # apply + scrape window
    pipelined: bool = False
    dispatch_s: float = 0.0
    collect_s: float = 0.0
    # proactive scaling (RaskConfig(forecast=True)): services solved against
    # predicted-horizon load this cycle, and the worst rolling relative
    # forecast error (DecisionInfo passthrough)
    forecast_used: int = 0
    forecast_err: float = 0.0


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One scripted mid-run fleet change, applied by ``EdgeEnvironment.run``
    when the simulation clock reaches ``t`` (absolute seconds).

    Kinds:
      * ``"fail_host"``  — abrupt host loss: residents evacuated to the best
        other hosts via the agent's batched placement scores (least-loaded
        fallback), the host's telemetry DB lost with it, host removed;
      * ``"drain_host"`` — graceful decommission: same evacuation, but each
        service's telemetry window migrates with it;
      * ``"degrade"``    — host capacity multiplied by ``factor`` (use > 1 to
        model recovery);
      * ``"arrive"``     — a new service container from ``profile`` placed on
        ``host`` (or the least-loaded device), fed by ``pattern``;
      * ``"depart"``     — service ``service`` leaves the fleet.

    After every event the driving agent is re-bound to the new topology
    (``refresh_topology``) before its next cycle.
    """

    t: float
    kind: str
    host: str = ""
    service: str = ""
    factor: float = 1.0
    profile: Optional[ServiceProfile] = None
    pattern: Optional[Pattern] = None


class EdgeEnvironment:
    """One or more Edge devices: control plane + simulated services +
    request workloads.

    With ``hosts == 1`` the platform is a single ``MUDAP``; with
    ``hosts > 1`` it is a ``Fleet`` of per-device MUDAPs (each with its own
    ``capacity``) — the E6-style 9-services-on-3-devices scenario is
    ``EdgeEnvironment(profiles, {"cores": 8.0}, replicas=3, hosts=3)``.

    ``hosts`` may instead be a sequence of host specs — anything with
    ``.name`` and ``.capacity`` (see ``env.scenarios.HostSpec``) or plain
    ``(name, capacity)`` pairs — giving every device its OWN budget: the
    heterogeneous fleets the bucketed per-host solver exists for.
    ``placement`` then chooses how containers spread over the devices:
    ``"round_robin"`` (the homogeneous default), ``"capacity"``
    (proportional to each device's resource budget, largest-remainder
    apportionment — a 16-core gateway takes 8x the services of a 2-core
    camera node), or an explicit per-container host-name list.
    """

    def __init__(self, profiles: Sequence[ServiceProfile],
                 capacity: Optional[Mapping[str, float]] = None,
                 patterns: Optional[Mapping[str, Pattern]] = None,
                 replicas: int = 1, host: str = "edge-0", seed: int = 0,
                 hosts: Union[int, Sequence] = 1,
                 placement: Union[str, Sequence[str]] = "round_robin"):
        """``replicas`` spawns N independent containers per profile (E6)."""
        self.platform: Union[MUDAP, Fleet]
        if isinstance(hosts, int):
            if capacity is None:
                raise ValueError("an integer `hosts` needs `capacity` "
                                 "(the per-device budget)")
            if hosts <= 1:
                specs = [(host, dict(capacity))]
            else:
                if host != "edge-0":
                    raise ValueError(
                        "hosts > 1 generates edge-0..edge-N-1 device names; "
                        "a custom `host` name cannot be honored")
                specs = [(f"edge-{i}", dict(capacity)) for i in range(hosts)]
        else:
            if capacity is not None:
                raise ValueError(
                    "per-host budgets come from the host specs; `capacity` "
                    "must be omitted when `hosts` is a sequence")
            if host != "edge-0":
                raise ValueError(
                    "host specs carry their own names; a custom `host` "
                    "cannot be honored when `hosts` is a sequence")
            specs = [(str(h.name), dict(h.capacity))
                     if hasattr(h, "capacity") else (str(h[0]), dict(h[1]))
                     for h in hosts]
            if not specs:
                raise ValueError("`hosts` sequence is empty")
        hostnames = [n for n, _ in specs]
        self.host_capacity: Dict[str, Dict[str, float]] = dict(specs)
        if len(specs) == 1:
            self.platform = MUDAP(specs[0][1], host=specs[0][0])
        else:
            self.platform = Fleet([MUDAP(c, host=n) for n, c in specs])
        self.pool = ContainerPool()
        self.services: Dict[str, SimulatedService] = {}
        self.patterns: Dict[str, Pattern] = {}
        rng = np.random.default_rng(seed)
        self._rng = rng                     # churn arrivals draw from it too
        self._routes: Optional[List[tuple]] = None   # rebuilt after churn
        n_total = len(profiles) * replicas
        assign = self._placements(placement, hostnames, n_total)
        # each container starts with an equal share of its *device's*
        # resources (§V-B(c))
        per_host = {h: 0 for h in hostnames}
        for h in assign:
            per_host[h] += 1
        i = 0
        instance_of: Dict[str, int] = {}   # per-type container numbering
        for profile in profiles:
            for _r in range(replicas):
                hostname = assign[i]
                i += 1
                c = instance_of.get(profile.type, 0)
                instance_of[profile.type] = c + 1
                sid = ServiceId(hostname, profile.type, f"c{c}")
                key = str(sid)
                backend = SimulatedService(
                    profile, np.random.default_rng(rng.integers(2 ** 31)),
                    pool=self.pool)
                defaults = dict(profile.defaults)
                for res, cap in self.host_capacity[hostname].items():
                    if res in profile.api.names:
                        defaults[res] = cap / per_host[hostname]
                if isinstance(self.platform, Fleet):
                    self.platform.place(sid, profile.api, backend,
                                        list(profile.slos), defaults,
                                        host=hostname)
                else:
                    self.platform.register(sid, profile.api, backend,
                                           list(profile.slos), defaults)
                self.services[key] = backend
                pat = (patterns or {}).get(profile.type)
                self.patterns[key] = pat if pat else constant(profile.default_rps)
        self._instance_of = instance_of     # per-type numbering continues
        self.t = 0.0

    def _placements(self, placement, hostnames: List[str],
                    n_total: int) -> List[str]:
        """Per-container host assignment under the chosen policy."""
        if not isinstance(placement, str):
            assign = [str(h) for h in placement]
            if len(assign) != n_total:
                raise ValueError(f"explicit placement names {len(assign)} "
                                 f"hosts for {n_total} containers")
            unknown = set(assign) - set(hostnames)
            if unknown:
                raise KeyError(f"unknown hosts in placement: {sorted(unknown)}")
            return assign
        if placement == "round_robin":
            return [hostnames[i % len(hostnames)] for i in range(n_total)]
        if placement == "capacity":
            # largest-remainder apportionment on total budget, then hand
            # containers out by largest remaining quota (ties: host order)
            w = np.asarray([max(sum(self.host_capacity[h].values()), 0.0)
                            for h in hostnames], float)
            w = w / max(w.sum(), 1e-9)
            quota = w * n_total
            counts = np.floor(quota).astype(int)
            frac_order = np.argsort(-(quota - counts), kind="stable")
            for j in frac_order[:n_total - int(counts.sum())]:
                counts[j] += 1
            remaining = counts.astype(float)
            assign = []
            for _ in range(n_total):
                j = int(np.argmax(remaining))   # ties: first host wins
                assign.append(hostnames[j])
                remaining[j] -= 1.0
            return assign
        raise ValueError(f"unknown placement policy {placement!r}")

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

    # -- churn: the fleet changing underneath the agent --------------------------
    def evacuate_host(self, name: str, agent=None,
                      carry_telemetry: bool = True
                      ) -> List[Tuple[str, str, str]]:
        """Move every resident off device ``name`` and drop it from the
        fleet.  Destinations come from the agent's candidate-batched
        ``placement_scores`` when it exposes them (one dispatch scores all
        (service, host) pairs; the failed host's column is ignored), with a
        least-loaded fallback per unscored service.  Returns the moves."""
        if not isinstance(self.platform, Fleet):
            raise ValueError("host churn needs a multi-host Fleet")
        scores = {}
        if agent is not None and hasattr(agent, "placement_scores"):
            scores = agent.placement_scores()
        moves = self.platform.evacuate(name, scores,
                                       carry_telemetry=carry_telemetry)
        self.platform.remove_host(name)
        self.host_capacity.pop(name, None)
        return moves

    def degrade_host(self, name: str, factor: float) -> Dict[str, float]:
        """Scale every resource budget of device ``name`` by ``factor``
        (< 1: thermal throttling / co-tenant pressure; > 1: recovery).
        Existing holdings shrink on the next applied plan's arbitration."""
        caps = self.host_capacity[name]
        for res in list(caps):
            caps[res] = caps[res] * float(factor)
            if isinstance(self.platform, Fleet):
                self.platform.set_capacity(name, res, caps[res])
            else:
                self.platform.capacity[res] = caps[res]
        return dict(caps)

    def add_service(self, profile: ServiceProfile,
                    pattern: Optional[Pattern] = None,
                    host: Optional[str] = None) -> str:
        """A new service container arrives mid-run: registered on ``host``
        (default: least-loaded), simulated in the shared pool, fed by
        ``pattern`` (default: the profile's constant rate).  Returns the
        sid.  The agent refits once the newcomer has >= 3 observed cycles
        (until then it re-enters exploration, like the initial xi phase)."""
        c = self._instance_of.get(profile.type, 0)
        self._instance_of[profile.type] = c + 1
        backend = SimulatedService(
            profile, np.random.default_rng(self._rng.integers(2 ** 31)),
            pool=self.pool)
        defaults = dict(profile.defaults)
        if isinstance(self.platform, Fleet):
            # pick the device first so the sid carries its real host name
            host = host or self.platform._least_loaded()
            sid = ServiceId(host, profile.type, f"c{c}")
            self.platform.place(sid, profile.api, backend,
                                list(profile.slos), defaults, host=host)
        else:
            sid = ServiceId(self.platform.host, profile.type, f"c{c}")
            self.platform.register(sid, profile.api, backend,
                                   list(profile.slos), defaults)
        key = str(sid)
        self.services[key] = backend
        self.patterns[key] = pattern if pattern \
            else constant(profile.default_rps)
        self._routes = None
        return key

    def remove_service(self, sid: str) -> None:
        """A service departs mid-run: deregistered (holdings released), its
        workload stops; the pooled container idles at zero load (pool slots
        are append-only)."""
        key = str(sid)
        backend = self.services.pop(key)
        self.platform.deregister(key)
        self.patterns.pop(key, None)
        self.pool.rps[backend.i] = 0.0
        self.pool.queue[backend.i] = 0.0
        self._routes = None

    def apply_event(self, ev: ChurnEvent, agent=None) -> None:
        """Apply one scripted churn event, then re-bind the agent
        (``refresh_topology``) so its next cycle decides against the new
        topology."""
        if ev.kind in ("fail_host", "drain_host"):
            self.evacuate_host(ev.host, agent,
                               carry_telemetry=(ev.kind == "drain_host"))
        elif ev.kind == "degrade":
            self.degrade_host(ev.host, ev.factor)
        elif ev.kind == "arrive":
            if ev.profile is None:
                raise ValueError("arrive event needs a profile")
            self.add_service(ev.profile, pattern=ev.pattern,
                             host=ev.host or None)
        elif ev.kind == "depart":
            self.remove_service(ev.service)
        else:
            raise ValueError(f"unknown churn event kind {ev.kind!r}")
        if agent is not None and hasattr(agent, "refresh_topology"):
            agent.refresh_topology()

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
            events: Optional[Sequence[ChurnEvent]] = None
            ) -> List[CycleRecord]:
        """``events``: scripted churn (absolute ``t`` on the environment
        clock), applied just before the tick that reaches their time;
        events already in the past fire on the first step."""
        history: List[CycleRecord] = []
        steps = int(duration_s)
        pending = sorted(events or [], key=lambda e: e.t)
        # (pool index, pattern) per container — indexing by the backend's own
        # pool slot, not dict position, so extra pool tenants cannot skew it;
        # rebuilt whenever churn changes the service set
        self._routes = None
        for step in range(1, steps + 1):
            self.t += 1.0
            while pending and pending[0].t <= self.t:
                self.apply_event(pending.pop(0), agent)
            if self._routes is None:
                self._routes = [(b.i, self.patterns[k])
                                for k, b in self.services.items()]
            for j, pat in self._routes:          # workloads are opaque callables
                self.pool.rps[j] = pat(self.t)
            self.pool.tick(self.t)               # whole fleet, one batched step
            self.platform.scrape(self.t)
            if step % int(cycle_s) == 0:
                result = self._drive(agent)
                fulfillment, per_service = self.measured_fulfillment()
                info = getattr(agent, "last_decision", None)
                accountant = getattr(agent, "accountant", None)
                fleet_burn = accountant.global_state() \
                    if accountant is not None else None
                rec = CycleRecord(
                    self.t, fulfillment, per_service,
                    result.runtime_s if result else 0.0,
                    result.explored if result else False,
                    {k: self.services[k].rps for k in self.services},
                    receipt=result.receipt if result else None,
                    compile_s=result.compile_s if result else 0.0,
                    alerts=info.burn_alerts if info else 0,
                    max_burn=info.max_burn if info else 0.0,
                    budget_consumed=fleet_burn.budget_consumed
                    if fleet_burn else 0.0,
                    pipelined=info.pipelined if info else False,
                    dispatch_s=info.dispatch_s if info else 0.0,
                    collect_s=info.collect_s if info else 0.0,
                    forecast_used=info.forecast_used if info else 0,
                    forecast_err=info.forecast_err if info else 0.0)
                history.append(rec)
                if on_cycle:
                    on_cycle(rec)
        return history
