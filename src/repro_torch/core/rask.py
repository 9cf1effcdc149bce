"""RASK — Regression Analysis of Structural Knowledge (paper §IV, Algorithm 1),
with its decide on the card (the port of ``repro/core/rask.py``'s default
path).

Per 10 s cycle the agent:
  1. observes stabilized service states (windowed mean of the last 5 s, §IV-A)
     and appends them to its training table D;
  2. while rounds < xi: returns RAND_PARAM (Eq. 3) — uniform exploration
     within bounds subject to the resource constraint;
  3. otherwise fits one polynomial regression per structural relation k in K
     (Eq. 2, degree delta) and hands the models, SLOs, bounds and capacity to
     the numerical solver (Eq. 4), warm-starting from the cached previous
     assignment (§IV-B3), and
  4. perturbs the solution with Gaussian action noise NOISE(a, eta) (Eq. 5)
     and emits the result as a declarative ``ScalingPlan``.

The decide on the device
------------------------
``repro`` composes fit, solve, projection and noise into one compiled
program. The port runs the same steps eagerly on the agent's device
(``cuda`` unless the caller asks for the CPU): the streaming fit pushes
only the telemetry rows appended since the last cycle into the
device-resident Gram accumulators (``regression.BatchedFitPlan``) and
solves the ridge systems there, the multi-start PGD solve
(``solver.pgd_solve``) takes every gradient through the objective's
backward kernel and scores the finals with its forward kernel, and the
noise is drawn on the device. The host uploads the delta rows, the load
vector and the warm start without waiting, and the decide ends in ONE
device-to-host copy of [optimum | noised plan | score]: no ``.item()`` and
no Python branch on a device value in between. ``streaming_fit=False``
refits over the full padded window each cycle (``fit_batched_arrays``).

Randomness: per decide the agent draws a seed and the warm start from its
numpy rng exactly as ``repro`` does, then seeds one ``torch.Generator`` on
its device, which draws the random starts' uniforms and then the noise.
So exploration plans match ``repro`` draw for draw; solved plans differ
by the generator (``jax.random`` and ``torch`` give different numbers).

On a multi-host ``Fleet`` the agent solves every host's services against
that host's OWN capacity (``solver.FleetSolverProblem``): one batched solve
per layout bucket, each ascent step one backward launch a bucket, still
ONE device-to-host copy a decide. The fleet's random starts are one draw
of (B, n_starts - 3, D_max) a bucket, in bucket order, from the same
generator, before the noise. Exploration projects each host's draw onto
its budget (``FleetSolverProblem.random_assignment``), draw for draw as
``repro``.

Placement: ``placement_scores`` scores every (service, host) what-if
subset with one batched solve per layout bucket
(``solver.PlacementProblem``, ``score_starts`` x ``score_iters``, starts
from a generator seeded 0: a snapshot is deterministic) and ONE
device-to-host copy; ``rebalance`` applies the best move per fresh
snapshot until no gain clears the hysteresis gate, and
``RaskConfig(rebalance_every=N)`` takes one snapshot every N solved
cycles and applies at most one move. ``refresh_topology`` re-binds the
agent after churn: after a host failure, drain or capacity change the
fitted models, the training table and the warm start stay, the fleet solve
is rebuilt and the streaming fit's device window is repacked once
(``_topo_gen``); after an arrival or departure the problem is rebuilt too,
carrying the warm start over by name (see ``transfer_priors`` below).

SLO error budgets: ``attach_accountant`` binds an ``obs.SLOAccountant``;
every ``observe`` advances it and every ``DecisionInfo`` carries its
``burn_alerts`` and ``max_burn``. A firing fast-burn alert takes a
placement snapshot every cycle, scales its rows by the accountant's burn
weights (capped at ``burn_weight_cap``) and restores a shrunk solver
budget.

Beyond-paper options, as in ``repro``:
  * ``pipeline`` — dispatch this cycle's fit+solve and emit the plan
    collected from the PREVIOUS cycle's dispatch (``_decide_pipelined``).
    On the card the dispatch is queued on a CUDA stream the agent owns,
    ending in a non-blocking copy of ``out`` into pinned memory and an
    event; the collect waits on that event and nothing else;
  * ``forecast`` — per-service AR load forecasters (``core/forecast.py``)
    fitted and evaluated in the same decide ahead of the solve; the hybrid
    gate picks forecast or reactive load per service, and the predictions
    ride in ``out``, so a decide still makes ONE device-to-host copy;
  * ``adapt_budget`` — halve the PGD and placement-scorer budgets while the
    solver score is calm, restore them on a load shift, a burn alert or
    churn (``_adapt_budget``);
  * ``transfer_priors`` — at a change of the service set,
    ``refresh_topology`` captures fleet-mean regression weights per service
    type (and the forecasters' AR weights) and warm-starts every arriving
    service's relations from them through the prior-mean ridge
    (``_prior_args``), so an arrival does not send the fleet back into
    exploration.

The reference paths (``_classic_cycle``), as in ``repro``: fit, then solve,
each on its own. ``backend="slsqp"`` is the paper-faithful scipy SLSQP
(``SolverProblem.solve_slsqp``: on the fused objective one device-to-host
copy a scipy evaluation), ``fused=False`` the seed's per-relation
``fit_polynomial`` loop and per-service loop objective (e7's pre-PR
baseline). Both solve the aggregate capacity, draw their noise from the
numpy rng and leave the pipeline, the forecaster and the streaming fit
out, as ``repro`` does; ``backend="pgd"`` with ``fused=False`` solves
through ``SolverProblem.solve_pgd`` from the agent's ``_start_uniforms``.

``auto_degree`` (beyond-paper): every ``auto_degree_every`` rounds each
service's degree is chosen by ``select_degree``'s test-split MSE (six fits
a relation on the agent's device); a pass that changes no degree keeps the
streaming fit's device window.

``shard`` is ``repro``'s: the fleet and placement solves spread each
layout bucket's rows over the devices it resolves to
(``solver.shard_rows``), byte for byte the one-device results. ``repro``'s
``aot`` and ``objective_impl`` fields are left out: they choose how JAX
compiles and which implementation scores; here nothing compiles and the
tensors' device picks the implementation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from ..device import resolve_device, upload
from .api import DecisionInfo, PlanningAgent, ScalingPlan
from .forecast import LoadForecaster
from .platform import MUDAP
from .regression import BatchedFitPlan, PolynomialModel, StackedModels, \
    fit_polynomial, pad_capacity, select_degree
from .solver import FleetSolverProblem, PlacementProblem, ServiceSpec, \
    SolverProblem, cached_fn, pgd_solve
from .telemetry import TrainingTable

# Structural knowledge K: per service, target -> feature parameter names.
# E.g. {"tp_max": ("cores", "data_quality")} — Eq. (7).
Knowledge = Mapping[str, Mapping[str, Sequence[str]]]

@dataclasses.dataclass
class RaskConfig:
    """``repro``'s ``RaskConfig`` fields that the port implements, with the
    same defaults (see the module docstring for the rest)."""

    xi: int = 20                # initial exploration rounds
    eta: float = 0.0            # Gaussian action-noise ratio
    delta: int = 2              # default polynomial degree
    delta_per_service: Optional[Dict[str, int]] = None
    backend: str = "pgd"        # "pgd" (default) | "slsqp" (paper reference)
    cache: bool = True          # §IV-B3 warm-start from last assignment
    ridge: float = 1e-6
    eta_decay: float = 1.0      # beyond-paper: <1.0 decays noise after xi
    auto_degree: bool = False   # beyond-paper: per-service degree by CV
    auto_degree_every: int = 10
    pgd_starts: int = 6
    pgd_iters: int = 32
    pgd_lr: float = 0.18
    resource: str = "cores"     # the shared-capacity resource name
    fused: bool = True          # batched fit + fused objective (False: seed loop)
    # streaming device-resident fit: the padded design window lives on the
    # device as per-relation rings + Gram accumulators, and each cycle
    # uploads only the rows appended since the last cycle's cursor; the
    # full window is uploaded again only when the plan changes (row bucket
    # or degrees) or table compaction outran a cursor
    streaming_fit: bool = True
    # exact Gram recompute from the device ring every N delta pushes,
    # bounding float32 accumulate/evict drift; 0 disables
    stream_resync_every: int = 64
    # per-service TrainingTable retention (rows), rounded up to a power of
    # two so the host window and the device ring evict in lockstep; None
    # keeps an unbounded table
    table_retention: Optional[int] = 1024
    # the fleet/placement solves' rows over devices (solver.shard_rows,
    # device.shard_devices): "auto" every card (1 on the CPU), False/None
    # one device, an int N the first N cards (at most the cards present;
    # N entries of the CPU on the CPU); results are byte-identical
    shard: Union[bool, int, str, None] = "auto"
    # pipelined decide (dispatch-then-collect): each decide queues this
    # cycle's fit+solve and returns the plan collected from the PREVIOUS
    # cycle's dispatch, so the device runs the solve while the environment
    # applies the plan and scrapes telemetry. Plans lag observations by
    # one cycle; the first post-exploration cycle is a pipeline-fill round
    # (no solved plan yet). Per-phase timings land in DecisionInfo.
    pipeline: bool = False
    # per-cycle placement stage: every N post-exploration cycles take one
    # batched placement-score snapshot and apply at most one migration
    # (0 = off; rebalancing then only happens via explicit ``rebalance()``)
    rebalance_every: int = 0
    # placement scoring budget: candidate subsets are warm-started from the
    # cached optimum's slices and only their marginal ORDERING matters (the
    # hysteresis gate absorbs score polish), so the scorer runs a lighter
    # deterministic budget than the decide solve
    score_starts: int = 4
    score_iters: int = 16
    # online solver budget adaptation (beyond-paper, opt-in): shrink
    # pgd_iters/pgd_starts toward the floors while the warm-started optimum
    # value stays within adapt_tol for adapt_patience consecutive solve
    # cycles; restore the full budget on any larger move (a load shift)
    adapt_budget: bool = False
    adapt_tol: float = 0.01         # relative solver-score movement = calm
    # restore threshold (None -> 5 * adapt_tol): the band between "not
    # calm" and "load shift" is hysteresis, so the floor budget's own
    # solution noise cannot flap the budget back up
    adapt_restore_tol: Optional[float] = None
    adapt_patience: int = 3         # calm cycles before each halving
    adapt_iters_floor: int = 8
    adapt_starts_floor: int = 2
    # the placement scorer follows the same shrink/restore hysteresis
    adapt_score_iters_floor: int = 8
    adapt_score_starts_floor: int = 2
    # SLO error-budget control (obs, active once an accountant is
    # attached): a firing fast-burn alert overrides the rebalance cadence
    # (a snapshot every cycle until it clears) and the budget adaptation
    # (full solver budget restored, no shrinking while burning), and the
    # burn weights (capped at burn_weight_cap) scale placement-score rows,
    # so the one move a snapshot goes to the service burning fastest
    burn_control: bool = True
    burn_weight_cap: float = 4.0    # max extra weight (see burn_weights)
    # proactive scaling (core/forecast.py): per-service AR(forecast_lags)
    # load forecasters fitted and evaluated inside the decide, and the
    # solve sees predicted-horizon load wherever the hybrid gate trusts
    # the forecaster: a service goes proactive only after forecast_min_evals
    # scored predictions with rolling relative error <= forecast_gate_tol,
    # and falls back to reactive rps the moment its error spikes
    forecast: bool = False
    horizon_s: float = 10.0         # how far ahead the solve looks
    forecast_cycle_s: float = 10.0  # control interval (horizon_s -> steps)
    forecast_lags: int = 8          # AR window length (rps history rows)
    forecast_gate_tol: float = 0.35     # rolling rel. error gate threshold
    forecast_min_evals: int = 3     # scored predictions before going proactive
    forecast_err_window: int = 8    # rolling-error window (predictions)
    # transfer learning across churn: at a service-set change the agent
    # captures fleet-mean regression weights per service TYPE (and the
    # forecasters' AR weights) and warm-starts every newly arrived
    # service's relations from them through the prior-mean ridge; the
    # prior decays linearly to zero as transfer_min_rows real rows arrive
    transfer_priors: bool = True
    transfer_strength: float = 1.0
    transfer_min_rows: int = 3


# host-side stand-in for "no new rows this cycle" (rebuild cycles push the
# window via ``stream_rebuild`` and then run the delta push empty)
_EMPTY_X = np.zeros((0, 1), np.float32)
_EMPTY_Y = np.zeros((0,), np.float32)


def _on_agent_stream(fn):
    """Run a method's device work on the agent's own CUDA stream when it
    has one (a pipelined agent on the card, see ``_decide_pipelined``)."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        with self._stream_ctx():
            return fn(self, *args, **kwargs)
    return wrapped


class RASKAgent(PlanningAgent):
    """The action-perception loop of Fig. 3 bound to one MUDAP platform or a
    multi-host ``Fleet``, deciding on ``device`` (``cuda`` unless the
    caller asks for the CPU)."""

    name = "rask"

    def __init__(self, platform: MUDAP, knowledge: Knowledge,
                 config: Optional[RaskConfig] = None, seed: int = 0,
                 device=None):
        super().__init__()
        self.cfg = config if config is not None else RaskConfig()
        self.device = resolve_device(device)
        self.platform = platform
        self.knowledge = knowledge
        self.rng = np.random.default_rng(seed)
        # bounded training table: retention is rounded to a power of two so
        # the host window and the streaming device ring evict in lockstep
        ret = self.cfg.table_retention
        self.table = TrainingTable(
            retention=None if ret is None else pad_capacity(int(ret),
                                                            minimum=1))
        self.rounds = -1            # Algo 1 line 2: first cycle -> 0
        self.services = platform.services()
        self.capacity = platform.capacity[self.cfg.resource]
        self._degrees: Dict[str, int] = {}      # auto_degree's picks
        self._cached_x: Optional[np.ndarray] = None
        # a pipelined agent on the card queues ALL of its device work on
        # one stream of its own: the tensors that outlive a dispatch (the
        # stacked weights, the streaming fit's and the forecasters' device
        # state, the problem tables) are made, read, written and freed on
        # that one stream, so they need no wait_stream/record_stream, and
        # the host only ever waits on the dispatch's event
        self._cuda_stream = torch.cuda.Stream(self.device) \
            if self._pipelined() and self.device.type == "cuda" else None
        # pipelined decide state: the in-flight dispatched solve (collected
        # by the NEXT decide) and a topology generation counter — bumped by
        # every fleet rebuild (migration, churn), it drops a pending result
        # built for the old layout and invalidates the streaming fit's
        # device window once
        self._pending: Optional[dict] = None
        self._topo_gen = 0
        self.collects = 0           # pipelined collects, and those whose
        self.collects_ready = 0     # event had completed before the wait
        with self._stream_ctx():
            self.problem = self._build_problem()
            # on a Fleet, decide against each host's OWN capacity (one
            # batched solve per layout bucket), not the aggregate relaxation
            self.fleet_problem: Optional[FleetSolverProblem] = None
            self._build_fleet_problem()
        # candidate-batched placement scorers, keyed on residency topology
        self._placement_cache: Dict[tuple, PlacementProblem] = {}
        self._score_gen = torch.Generator(self.device)
        self.moves_total = 0
        self._models_loop: Dict[str, Dict[str, PolynomialModel]] = {}
        self._models_view: Optional[Dict[str, Dict[str, PolynomialModel]]] = None
        self.stacked: Optional[StackedModels] = None
        self._row_capacity = 0      # padded-fit bucket (power-of-two growth)
        self._fit_plan: Optional[BatchedFitPlan] = None
        self._fit_plan_key = None
        # streaming-fit state: the device-resident StreamState, per-relation
        # total-index cursors into the training table, the plan key it was
        # built against, per-relation window row counts, and the push
        # counter driving the periodic exact resync
        self._stream: Optional[dict] = None
        # online budget adaptation state (active PGD and scorer budgets;
        # the configured ones unless adapt_budget has shrunk them)
        self._budget_iters = self.cfg.pgd_iters
        self._budget_starts = self.cfg.pgd_starts
        self._score_iters = self.cfg.score_iters
        self._score_starts = self.cfg.score_starts
        self._calm_cycles = 0
        self._last_score: Optional[float] = None
        # last-known per-service rps: the fallback when a cycle's observe
        # window is empty (a paused scrape must not be solved as zero load)
        self._last_rps: Dict[str, float] = {}
        self._rps_scale: Dict[str, float] = {}   # running max (fc x_scale)
        # proactive scaling state (RaskConfig(forecast=True)): the
        # LoadForecaster bound to the current plan/topology and the fit
        # input it prepared for this cycle's dispatch
        self._forecast: Optional[LoadForecaster] = None
        self._fc_prep = None
        # transfer-learning priors captured at churn: fleet-mean regression
        # weights keyed (service type, target, degree, n_features), the
        # forecasters' per-type AR means, and the cached zero-prior tensors
        # dispatched while no prior is live
        self._transfer_priors: Dict[tuple, np.ndarray] = {}
        self._fc_priors: Dict[str, np.ndarray] = {}
        self._prior_zero: Optional[tuple] = None
        self._gen = torch.Generator(self.device)
        self.compile_s_total = 0.0
        # SLO error-budget control plane (attach_accountant): burn states
        # from the last observe
        self.accountant = None
        self.burn_states: Dict[str, object] = {}
        self._build_s = self._build_kernels()
        self._build_rel_static()

    def _build_kernels(self) -> float:
        """Build (or load) the objective kernels now, on the card, so the
        first solved cycle's ``runtime_s`` holds no compilation; the time
        is reported as that cycle's ``compile_s``. Nothing to build on the
        CPU."""
        if self.device.type != "cuda":
            return 0.0
        from ..kernels import rask_objective
        t0 = time.perf_counter()
        rask_objective._lib()
        return time.perf_counter() - t0

    def _stream_ctx(self):
        """The agent's CUDA stream as the current stream (pipelined agents
        on the card), else nothing."""
        s = self._cuda_stream
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def _build_fleet_problem(self) -> None:
        """(Re)bind the per-host fleet solve to the platform's CURRENT
        placement — at construction and again after a migration or churn
        (the bucket layouts follow the topology). Any in-flight pipelined
        solve targets the OLD topology and is dropped."""
        self._topo_gen += 1
        self._pending = None
        platform = self.platform
        if hasattr(platform, "hosts") and hasattr(platform, "host_of"):
            self.fleet_problem = FleetSolverProblem(
                self.problem,
                {sid: platform.host_of(sid).host for sid in self.services},
                {h.host: h.capacity[self.cfg.resource]
                 for h in platform.hosts()}, shard=self.cfg.shard)

    def _build_rel_static(self) -> None:
        """Static per-relation fit metadata (feature names + scales), in the
        problem's global relation order."""
        self._rel_static: List[Tuple[str, str, Tuple[str, ...], np.ndarray]] = []
        self._sid_types: Dict[str, str] = {}
        for _, sid, target, _ in self.problem.relations:
            svc = self.platform.service(sid)
            self._sid_types[sid] = svc.sid.type
            feats = tuple(self.knowledge[svc.sid.type][target])
            scale = np.asarray(
                [svc.api.parameter(f).max_value for f in feats], np.float32)
            self._rel_static.append((sid, target, feats, scale))

    @property
    def models(self) -> Dict[str, Dict[str, PolynomialModel]]:
        """Seed-style {service: {target: PolynomialModel}} view: in fused
        mode sliced lazily out of the stacked tensors, in loop mode the
        dict the fit writes into."""
        if not self.cfg.fused:
            return self._models_loop
        if self._models_view is None and self.stacked is not None:
            self._models_view = self.problem.models_dict(self.stacked)
        return self._models_view if self._models_view is not None else {}

    # -- problem construction -------------------------------------------------
    def _build_problem(self) -> SolverProblem:
        specs = []
        for sid in self.services:
            svc = self.platform.service(sid)
            api = svc.api
            names = tuple(api.names)
            rels = []
            for target, feats in self.knowledge[svc.sid.type].items():
                rels.append((target, tuple(names.index(f) for f in feats)))
            specs.append(ServiceSpec(
                name=sid,
                param_names=names,
                lower=tuple(p.min_value for p in api.parameters),
                upper=tuple(p.max_value for p in api.parameters),
                resource_mask=tuple(p.is_resource and p.name == self.cfg.resource
                                    for p in api.parameters),
                slos=tuple(svc.slos),
                relation_features=tuple(rels)))
        return SolverProblem(specs, fused=self.cfg.fused, device=self.device)

    # -- SLO error-budget control plane (obs) -----------------------------------
    def attach_accountant(self, accountant) -> None:
        """Bind an ``obs.SLOAccountant``: every ``observe`` refreshes its
        rolling SLI rings (one bulk columnar pass, plain numpy, nothing on
        the card), and ``decide`` reads its fast-burn alerts."""
        self.accountant = accountant

    def _fast_alerts(self) -> List[str]:
        """Services whose fastest burn policy is firing (empty without an
        attached accountant or with ``burn_control`` off)."""
        if self.accountant is None or not self.cfg.burn_control:
            return []
        return self.accountant.fast_alerts()

    def _max_burn(self) -> float:
        """Worst long-window burn rate across services (0.0 when idle)."""
        return max((st.burn_rate() for st in self.burn_states.values()),
                   default=0.0)

    # -- observation (§IV-A) ---------------------------------------------------
    def observe(self, t: float, window: float = 5.0
                ) -> Dict[str, Dict[str, float]]:
        """Append the stabilized state of each service to D; returns the
        states (one bulk telemetry query for all services)."""
        states = {}
        windowed = self.platform.window_states(since=t - window, until=t)
        for sid in self.services:
            state = windowed.get(sid)
            if not state:
                continue
            row = dict(state)
            row.update(self.platform.assignment(sid))  # features = applied params
            self.table.append(sid, row)
            states[sid] = row
            rps = row.get("rps")
            if rps is not None and np.isfinite(rps):
                self._last_rps[sid] = float(rps)
                self._rps_scale[sid] = max(self._rps_scale.get(sid, 0.0),
                                           float(rps))
        if self.accountant is not None:
            self.burn_states = self.accountant.update(t)
        return states

    # -- Algorithm 1 ------------------------------------------------------------
    @_on_agent_stream
    def decide(self, obs: Mapping[str, Mapping[str, float]]) -> ScalingPlan:
        """One RASK round: explore or fit+solve; returns the proposed plan
        (the caller — environment or ``cycle`` — applies it)."""
        self.rounds += 1
        if self.rounds < self.cfg.xi:                       # lines 3-5
            self.last_decision = DecisionInfo(explored=True)
            return self._plan(self._explore())

        alerts = self._fast_alerts()
        if alerts:
            # a firing fast-burn alert is a regime change by definition:
            # restore the full solver budget at once (the shrunk steady-
            # state budget solves noisier exactly when precision matters
            # most) and hold off further shrinking until the alert clears
            self._restore_budget()
        moves, scored = self._maybe_rebalance(obs, alerts)
        if self._pipelined():
            return self._decide_pipelined(obs, moves, scored, alerts)
        t0 = time.perf_counter()
        out = self._solve_cycle(obs)                        # lines 6-11
        if out is None:
            self.last_decision = DecisionInfo(
                explored=True, moves=len(moves),
                score_starts=self._score_starts if scored else 0,
                score_iters=self._score_iters if scored else 0,
                burn_alerts=len(alerts), max_burn=self._max_burn())
            return self._plan(self._explore())
        runtime = time.perf_counter() - t0
        compile_s, self._build_s = self._build_s, 0.0
        a, noised, score = out
        used_starts, used_iters = self._budget_starts, self._budget_iters
        self._cached_x = np.asarray(a, np.float32)          # §IV-B3 cache
        prev_score, self._last_score = self._last_score, float(score)
        if not alerts:      # no shrinking while the error budget is burning
            self._adapt_budget(prev_score, float(score))
        self.moves_total += len(moves)
        self.compile_s_total += compile_s
        self.last_decision = DecisionInfo(
            explored=False, runtime_s=runtime, compile_s=compile_s,
            score=score, pgd_starts=used_starts, pgd_iters=used_iters,
            moves=len(moves),
            score_starts=self._score_starts if scored else 0,
            score_iters=self._score_iters if scored else 0,
            burn_alerts=len(alerts), max_burn=self._max_burn(),
            **self._fc_stats())
        return self._plan(noised)

    def _decide_pipelined(self, obs, moves, scored: bool,
                          alerts: Sequence[str]) -> ScalingPlan:
        """Dispatch-then-collect decide (``RaskConfig(pipeline=True)``).

        Phase 1 COLLECTS the solve dispatched by the *previous* decide: on
        the card a wait on the event recorded after that dispatch's
        non-blocking copy of ``out`` into pinned memory (having had the
        whole control interval to run, the solve is normally done and the
        wait is near-free), then a read of the pinned buffer. Phase 2 fits
        this cycle's data and queues the next solve on the agent's stream
        without waiting; the device runs it while the environment applies
        the plan and scrapes. The emitted plan is the collected (previous)
        cycle's — a one-cycle plan lag. Warm starts stay as fresh as the
        synchronous path: the collect happens before the dispatch, so the
        new solve warm-starts from the optimum just collected. A pending
        result whose topology generation is stale (rebalance move, churn)
        is dropped, and the cycle degrades to a pipeline-fill round. On the
        CPU the dispatch computes at once and the collect only reads."""
        # -- phase 1: collect the in-flight solve -----------------------------
        t0 = time.perf_counter()
        pend, self._pending = self._pending, None
        collected = None
        if pend is not None and pend["gen"] == self._topo_gen:
            ev = pend["event"]
            if ev is not None:
                self.collects += 1
                self.collects_ready += int(ev.query())
                ev.synchronize()
            out = pend["out"].numpy()   # read only after the event
            self.stacked = pend["plan"].stacked(pend["w"])
            self._models_view = None
            a, noised, score, pred = self._split_out(
                out, pend["dim"], pend["n_fc"])
            collected = (a, noised, score)
            if pred is not None and self._forecast is not None:
                # the prediction dispatched last cycle targets fc_target;
                # settle() in this cycle's dispatch scores it when due
                self._forecast.note(pend["fc_target"], pred)
        collect_s = time.perf_counter() - t0
        if collected is not None:
            a, noised, score = collected
            self._cached_x = np.asarray(a, np.float32)      # §IV-B3 cache
            prev_score, self._last_score = self._last_score, float(score)
            if not alerts:  # no shrinking while the error budget is burning
                self._adapt_budget(prev_score, float(score))

        # -- phase 2: fit + queue the next solve ------------------------------
        dispatch_s = compile_s = 0.0
        used_starts = used_iters = 0
        prep = self._prepare_fit()
        if prep is None:
            if collected is None:
                self.stacked = None       # models incomplete: keep exploring
        else:
            seed = int(self.rng.integers(2 ** 31))
            x0 = self._x0()
            plan = self._fit_plan
            td = time.perf_counter()
            out_dev, w_dev, n_fc = self._dispatch_fused(prep, obs, seed, x0)
            host, event = self._queue_copy(out_dev)
            dispatch_s = time.perf_counter() - td
            fc = self._forecast
            self._pending = dict(out=host, event=event, w=w_dev, plan=plan,
                                 dim=self.problem.dim, gen=self._topo_gen,
                                 n_fc=n_fc,
                                 fc_target=self.rounds +
                                 (fc.horizon if fc is not None else 0))
            used_starts, used_iters = self._budget_starts, self._budget_iters
            compile_s, self._build_s = self._build_s, 0.0

        # -- emit: the collected (previous) cycle's plan ----------------------
        self.moves_total += len(moves)
        self.compile_s_total += compile_s
        common = dict(moves=len(moves), compile_s=compile_s,
                      score_starts=self._score_starts if scored else 0,
                      score_iters=self._score_iters if scored else 0,
                      burn_alerts=len(alerts), max_burn=self._max_burn(),
                      pipelined=True, dispatch_s=dispatch_s,
                      collect_s=collect_s, **self._fc_stats())
        if collected is None:
            # pipeline fill: no solved plan to emit yet — hold the cached
            # operating point if one exists, otherwise explore one round
            hold = self._cached_x
            self.last_decision = DecisionInfo(explored=hold is None, **common)
            return self._plan(hold if hold is not None else self._explore())
        self.last_decision = DecisionInfo(
            explored=False, runtime_s=dispatch_s + collect_s, score=score,
            pgd_starts=used_starts, pgd_iters=used_iters, **common)
        return self._plan(noised)

    @staticmethod
    def _queue_copy(out: torch.Tensor):
        """Queue the decide's ONE device-to-host copy of ``out``: on the
        card a non-blocking copy into pinned memory on the current (the
        agent's) stream and an event recorded after it; returns (host
        tensor, event). A CPU ``out`` is already the host copy (event
        None)."""
        if out.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _maybe_rebalance(self, obs, alerts: Sequence[str] = ()
                         ) -> Tuple[List[Tuple[str, str, str]], bool]:
        """The optional per-cycle placement stage (``rebalance_every=N``):
        every N post-exploration cycles take ONE fresh batched score
        snapshot and apply at most one migration — the monotone one-move-
        per-snapshot ascent of ``rebalance``, amortized over cycles. A
        topology change rebuilds the fleet solve.

        A firing fast-burn alert (``alerts``) overrides the cadence — a
        snapshot is taken EVERY cycle until the alert clears — and the
        snapshot's rows are scaled by the accountant's burn weights, so the
        one-move budget is spent on the service burning error budget
        fastest first. Returns (applied moves, whether a snapshot ran)."""
        n = self.cfg.rebalance_every
        if (n <= 0 or self.fleet_problem is None
                or self.rounds < self.cfg.xi
                or ((self.rounds - self.cfg.xi) % n != 0 and not alerts)):
            return [], False
        scores = self.placement_scores(obs)
        if not scores:
            return [], False
        if alerts and self.accountant is not None:
            # scale whole rows: within-row argmax (the best host) is
            # unchanged, but a burning service's gain grows relative to
            # calm services', so it wins the descending-gain ordering and
            # clears the hysteresis gate sooner
            weights = self.accountant.burn_weights(self.cfg.burn_weight_cap)
            scores = {sid: {h: s * weights.get(sid, 1.0)
                            for h, s in row.items()}
                      for sid, row in scores.items()}
        moves = self.platform.rebalance(scores, limit=1)
        if moves:
            self._build_fleet_problem()
            # the migration changes the solve's score baseline by design
            # (that is why the move was chosen): grace the budget
            # adaptation so the jump is not misread as a load shift
            self._last_score = None
        return moves, True

    def _restore_budget(self) -> None:
        """The configured solver and scorer budgets, at once (a burn alert,
        churn); the calm count starts over."""
        cfg = self.cfg
        self._budget_iters = cfg.pgd_iters
        self._budget_starts = cfg.pgd_starts
        self._score_iters = cfg.score_iters
        self._score_starts = cfg.score_starts
        self._calm_cycles = 0

    def _adapt_budget(self, prev_score: Optional[float],
                      score: float) -> None:
        """Online solver budget adaptation (opt-in ``adapt_budget``): at
        steady state the warm-started optimum barely moves in VALUE (the
        argmax itself wanders the flat basin with the per-cycle multi-start
        draws), so convergence is measured on the solver score. A relative
        score move below ``adapt_tol`` for ``adapt_patience`` consecutive
        solve cycles halves the PGD budget toward the floors; a move past
        ``adapt_restore_tol`` (a load shift — well above the noise floor
        of a shrunk budget's own solves) restores the configured budget at
        once, and the band between the two thresholds just resets the calm
        counter (hysteresis, so the floor budget's solution noise cannot
        flap the budget back up). The cycle right after a budget change is
        a grace cycle (its score jump is the budget's doing, not the
        load's)."""
        cfg = self.cfg
        if not cfg.adapt_budget or prev_score is None \
                or not np.isfinite(prev_score) or not np.isfinite(score):
            return
        restore_tol = cfg.adapt_restore_tol \
            if cfg.adapt_restore_tol is not None else 5.0 * cfg.adapt_tol
        move = abs(score - prev_score) / max(abs(prev_score), 1.0)
        if move >= cfg.adapt_tol:
            self._calm_cycles = 0
            if move >= restore_tol and \
                    (self._budget_iters, self._budget_starts,
                     self._score_iters, self._score_starts) != \
                    (cfg.pgd_iters, cfg.pgd_starts,
                     cfg.score_iters, cfg.score_starts):
                self._restore_budget()
                self._last_score = None     # grace cycle after the change
            return
        self._calm_cycles += 1
        if self._calm_cycles >= cfg.adapt_patience:
            iters = max(self._budget_iters // 2, cfg.adapt_iters_floor)
            starts = max(self._budget_starts // 2, cfg.adapt_starts_floor)
            # the scorer shrinks in lockstep (its own floors): at steady
            # state the candidate ordering is as stationary as the optimum
            s_iters = max(self._score_iters // 2, cfg.adapt_score_iters_floor)
            s_starts = max(self._score_starts // 2,
                           cfg.adapt_score_starts_floor)
            if (iters, starts, s_iters, s_starts) != \
                    (self._budget_iters, self._budget_starts,
                     self._score_iters, self._score_starts):
                self._budget_iters, self._budget_starts = iters, starts
                self._score_iters, self._score_starts = s_iters, s_starts
                self._last_score = None     # grace cycle after the change
            self._calm_cycles = 0

    def _solve_cycle(self, obs):
        """One full fit+solve+NOISE pass; returns (optimum, noised plan
        vector, score), or None while models are incomplete."""
        if not self._fused_pgd():
            return self._classic_cycle(obs)
        prep = self._prepare_fit()                          # lines 6-9
        if prep is None:
            self.stacked = None
            return None
        # per-decide randomness, drawn from the numpy rng as repro draws it
        seed = int(self.rng.integers(2 ** 31))
        return self._decide_fused(prep, obs, seed, self._x0())

    # -- which decide runs --------------------------------------------------------
    def _fused_pgd(self) -> bool:
        """The default decide: the fused fit + PGD solve on the device (the
        pipeline, the forecaster and the streaming fit ride only on it)."""
        return self.cfg.fused and self.cfg.backend == "pgd"

    def _pipelined(self) -> bool:
        return self.cfg.pipeline and self._fused_pgd()

    def _streaming(self) -> bool:
        return self.cfg.streaming_fit and self._fused_pgd()

    def _forecast_on(self) -> bool:
        return self.cfg.forecast and self._fused_pgd()

    # -- the two-stage (reference / baseline) cycle ---------------------------
    def _classic_cycle(self, obs):
        """Fit then solve as separate steps — the SLSQP reference or the
        seed's loop path (``fused=False``); None while models are
        incomplete. The noise comes from the numpy rng, drawn before the
        warm start, as ``repro`` draws it."""
        self._fit_models()
        if not self._models_complete():
            # not enough samples to fit every relation (e.g. xi=0 at cycle
            # 1): keep exploring — there is no model to solve against yet
            return None
        rps = self._rps_vector(obs)
        models = self.stacked if (self.cfg.fused and self.stacked is not None) \
            else self.models
        seed = int(self.rng.integers(2 ** 31)) \
            if self.cfg.backend == "pgd" else 0
        eps = self.rng.normal(0.0, 1.0, self.problem.dim).astype(np.float32) \
            if self._eta_t() > 0 else None
        x0 = self._x0()
        if self.cfg.backend == "pgd":
            # the aggregate problem's starts (a fleet's own draws are per
            # layout bucket: the solve then seeds its generator itself)
            u = self._start_uniforms(seed) if self.fleet_problem is None \
                else None
            a, score = self.problem.solve_pgd(
                models, rps, x0, self.capacity, u=u, seed=seed,
                n_starts=self._budget_starts, iters=self._budget_iters,
                lr=self.cfg.pgd_lr)
        else:                                                # line 10
            a, score = self.problem.solve_slsqp(models, rps, x0,
                                                self.capacity)
        return a, (a if eps is None else self._noise(a, eps)), score

    def _models_complete(self) -> bool:
        if self.cfg.fused:
            return self.stacked is not None
        for sid in self.services:
            svc = self.platform.service(sid)
            for target in self.knowledge[svc.sid.type]:
                if target not in self.models.get(sid, {}):
                    return False
        return True

    def _fit_models(self) -> None:
        """The reference paths' fit (lines 6-9): one batched fit over the
        design window (fused), or the seed's ``fit_polynomial`` a relation
        with >= 3 rows, on the agent's device."""
        if self.cfg.fused:
            data = self._collect_fit_data()
            if data is None:
                self.stacked = None
                return
            self.stacked = self._fit_plan.fit(data)
            self._models_view = None      # seed-style view rebuilt lazily
            return
        for sid in self.services:
            svc = self.platform.service(sid)
            k = self.knowledge[svc.sid.type]
            self._models_loop.setdefault(sid, {})
            for target, feats in k.items():
                X, Y = self.table.design_matrix(sid, feats, target)
                if len(Y) < 3:
                    continue
                scale = np.asarray(
                    [svc.api.parameter(f).max_value for f in feats],
                    np.float32)
                degree = self._degree(sid, X, Y, scale)
                self._models_loop[sid][target] = fit_polynomial(
                    X, Y, degree, x_scale=scale, ridge=self.cfg.ridge,
                    features=feats, target=target, device=self.device)

    # -- Eq. (3) --------------------------------------------------------------
    def _explore(self) -> np.ndarray:
        if self.fleet_problem is not None:
            return self.fleet_problem.random_assignment(self.rng)
        return self.problem.random_assignment(self.rng, self.capacity)

    def _rps_vector(self, obs) -> np.ndarray:
        # rps from the observe() states in hand; a service with no sample in
        # the window OR in the metrics store falls back to its LAST-KNOWN
        # rps, not 0.0 (solving against zero load mid-traffic scales it to
        # the floor)
        obs = obs or {}
        out = np.zeros(len(self.services), np.float32)
        for i, sid in enumerate(self.services):
            v = obs.get(sid, {}).get("rps")
            if v is None or not np.isfinite(v):
                v = self.platform.latest_metrics(sid).get("rps")
            if v is None or not np.isfinite(v):
                v = self._last_rps.get(sid, 0.0)
            else:
                self._last_rps[sid] = float(v)
            out[i] = v
        return out

    def _x0(self) -> np.ndarray:
        if self.cfg.cache and self._cached_x is not None:
            return self._cached_x
        return self._explore()

    # -- the fit inputs ----------------------------------------------------------
    def _prepare_fit(self):
        """Fit inputs for the decide, structural AND (with
        ``forecast=True``) forecaster: the structural prep is returned, the
        forecaster's lands in ``self._fc_prep`` for ``_dispatch_fused`` —
        both advance their cursors here, exactly once per decide."""
        prep = self._prepare_fit_structural()
        if prep is not None and self._forecast_on():
            fc = self._ensure_forecaster()
            self._fc_prep = fc.prep(self.table, self._streaming())
        else:
            self._fc_prep = None
        return prep

    def _prepare_fit_structural(self):
        """Structural fit inputs: ``("delta", deltas)`` with only the rows
        appended since each relation's cursor (the streaming steady state),
        or ``("batch", data)`` with the full design window
        (``streaming_fit=False``, or a streaming rebuild). None while some
        relation still lacks >= 3 usable rows AND has no transfer prior
        (the agent keeps exploring). An ``auto_degree`` round goes through
        ``_collect_fit_data``, which selects the degrees."""
        streaming = self._streaming()
        auto_due = self.cfg.auto_degree and \
            self.rounds % self.cfg.auto_degree_every == 0
        if streaming and not auto_due:
            deltas = self._stream_deltas()
            if deltas is not None:
                return ("delta", deltas)
        data = self._collect_fit_data()   # (re)builds plan, checks degrees
        if data is None:
            self._stream = None
            return None
        if streaming:
            # an auto-degree pass that did NOT change the plan key leaves
            # the stream state valid: keep pushing deltas
            deltas = self._stream_deltas()
            if deltas is not None:
                return ("delta", deltas)
        return ("batch", data)

    def _stream_deltas(self):
        """The unseen training rows of every relation (cursor-driven delta
        export), or None when the stream state is missing or invalid — built
        against another topology generation or fit plan, a cursor lost rows
        to table compaction, or
        the window outgrew the device ring's row bucket — in which case the
        caller rebuilds through ``_collect_fit_data`` (ONE counted design
        upload)."""
        st = self._stream
        if (st is None or st["gen"] != self._topo_gen
                or st["plan_key"] != self._fit_plan_key
                or self._fit_plan is None):
            return None
        ret = self.table.retention
        deltas = []
        max_rows = 0
        for i, (sid, target, feats, scale) in enumerate(self._rel_static):
            if st["cursors"][i] < self.table.evicted(sid):
                return None               # compaction outran the cursor
            Xd, Yd, cur = self.table.delta_matrix(sid, feats, target,
                                                  st["cursors"][i])
            st["cursors"][i] = cur
            # window row estimate: usable rows only ever grow by the delta
            # and never exceed the visible window
            n = st["rows"][i] + len(Yd)
            n = min(n, self.table.count(sid) if ret is not None else n)
            st["rows"][i] = n
            max_rows = max(max_rows, n)
            deltas.append((Xd, Yd))
        if pad_capacity(max_rows) > self._row_capacity:
            return None                   # window outgrew the device ring
        return deltas

    def _stream_rebuild(self, data) -> dict:
        """Fresh device-resident stream state holding the current design
        window (counts as ONE ``h2d_design_upload``), with cursors at each
        relation's current append total."""
        plan = self._fit_plan
        return dict(
            state=plan.stream_rebuild(data),
            cursors=[self.table.appended(sid)
                     for sid, *_ in self._rel_static],
            rows=[len(Y) for _, Y in data],
            gen=self._topo_gen, plan_key=self._fit_plan_key, pushes=0)

    def _collect_fit_data(self):
        """Design matrices for all |S|x|K| relations, plus plan upkeep.

        Matrices are padded to a shared power-of-two row capacity (monotone
        per agent); the padding tables live in a ``BatchedFitPlan``, rebuilt
        only when the capacity bucket or a per-relation degree changes.
        Returns None until every relation has >= 3 usable rows OR a
        transfer prior (the agent keeps exploring until then)."""
        data = []
        degrees = []
        max_rows = 0
        for sid, target, feats, scale in self._rel_static:
            X, Y = self.table.design_matrix(sid, feats, target)
            if len(Y) < 3 and not self._has_prior(sid, target, feats):
                # a relation with a captured transfer prior fits anyway:
                # the prior-mean ridge supplies what the missing rows would
                # have, so one arrival does not re-enter fleet-wide
                # exploration (the prior decays as real rows land)
                return None
            max_rows = max(max_rows, len(Y))
            degrees.append(self._degree(sid, X, Y, scale))
            data.append((X, Y))
        self._row_capacity = max(self._row_capacity, pad_capacity(max_rows))
        key = (self._row_capacity, tuple(degrees))
        if self._fit_plan_key != key:
            self._fit_plan = self._make_plan(self._row_capacity, degrees)
            self._fit_plan_key = key
        return data

    def _make_plan(self, cap: int, degrees: Sequence[int]) -> BatchedFitPlan:
        return BatchedFitPlan(
            [dict(n_features=len(feats), degree=d, x_scale=scale,
                  service=sid, target=target, features=feats)
             for (sid, target, feats, scale), d
             in zip(self._rel_static, degrees)],
            row_capacity=cap, ridge=self.cfg.ridge, device=self.device)

    def _degree(self, sid: str, X, Y, scale) -> int:
        """A relation's degree for this fit: the per-service setting, else
        with ``auto_degree`` (and >= 10 rows) ``select_degree``'s pick on
        the agent's device, refreshed every ``auto_degree_every`` rounds
        and kept per service, else ``delta``."""
        if self.cfg.delta_per_service and sid in self.cfg.delta_per_service:
            return self.cfg.delta_per_service[sid]
        if self.cfg.auto_degree and len(Y) >= 10:
            if (sid not in self._degrees
                    or self.rounds % self.cfg.auto_degree_every == 0):
                best, _ = select_degree(X, Y, x_scale=scale,
                                        device=self.device)
                self._degrees[sid] = best
            return self._degrees[sid]
        return self.cfg.delta

    def _default_degree(self, sid: str) -> int:
        """The degree relation ``sid`` will fit with absent new data (the
        configured/per-service default or the last auto-selected value) —
        what the prior key must match."""
        if self.cfg.delta_per_service and sid in self.cfg.delta_per_service:
            return self.cfg.delta_per_service[sid]
        return self._degrees.get(sid, self.cfg.delta)

    # -- proactive scaling (core/forecast.py) ---------------------------------
    def _ensure_forecaster(self) -> LoadForecaster:
        """The LoadForecaster bound to the CURRENT topology and fit plan —
        rebuilt (carrying the hybrid gate's error history over when the
        service set is unchanged) whenever either moves, so its row ring
        grows in lockstep with the structural plan's bucket."""
        cfg = self.cfg
        key = (self._topo_gen, self._fit_plan_key, cfg.forecast_lags)
        fc = self._forecast
        if fc is not None and fc.bind_key == key:
            return fc
        horizon = max(1, int(round(cfg.horizon_s /
                                   max(cfg.forecast_cycle_s, 1e-9))))
        new = LoadForecaster(
            self.services,
            [self._sid_types.get(s, "") for s in self.services],
            [max(self._rps_scale.get(s, 0.0), 1.0) for s in self.services],
            cfg.forecast_lags, horizon,
            row_capacity=self._fit_plan.row_capacity, ridge=cfg.ridge,
            err_window=cfg.forecast_err_window,
            gate_tol=cfg.forecast_gate_tol, min_evals=cfg.forecast_min_evals,
            priors=self._fc_priors if cfg.transfer_priors else None,
            prior_strength=cfg.transfer_strength,
            min_prior_rows=cfg.transfer_min_rows, device=self.device)
        if fc is not None and fc.services == new.services:
            new.inherit_gate(fc)
        new.bind_key = key
        self._forecast = new
        return new

    def _fc_stats(self) -> dict:
        """DecisionInfo's forecast fields (empty off the forecast path, so
        the dataclass defaults apply)."""
        fc = self._forecast
        if not self._forecast_on() or fc is None:
            return {}
        return dict(forecast_used=fc.last_used, forecast_err=fc.last_err)

    @staticmethod
    def _split_out(out: np.ndarray, d: int, n_fc: int):
        """Slice one decide's output vector — layout
        [optimum (d) | noised plan (d) | predictions (n_fc) | scores] —
        into (a, noised, score, pred-or-None)."""
        a, noised = out[:d], out[d:2 * d]
        pred = np.asarray(out[2 * d:2 * d + n_fc]) if n_fc else None
        return a, noised, float(out[2 * d + n_fc:].sum()), pred

    # -- transfer-learning priors (churn warm start) --------------------------
    def _has_prior(self, sid: str, target: str,
                   feats: Tuple[str, ...]) -> bool:
        if not (self.cfg.transfer_priors and self._transfer_priors):
            return False
        return (self._sid_types.get(sid), target, self._default_degree(sid),
                len(feats)) in self._transfer_priors

    def _prior_args(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_prior (R, T_max), prior_lam (R,)) on the device for this
        cycle's fit — the prior-mean ridge inputs. A relation whose service
        is still short of ``transfer_min_rows`` table rows is pulled toward
        its captured fleet-mean weights with linearly decaying strength;
        everything else gets prior_lam = 0, which solves the EXACT
        unprior'd system. Once every prior has fully decayed the capture
        dict is dropped and cached zeros, made once per plan shape on the
        device, are used (no per-cycle upload on the steady path)."""
        plan = self._fit_plan
        R, T = plan.n_relations, plan.t_max
        if self.cfg.transfer_priors and self._transfer_priors:
            wp = np.zeros((R, T), np.float32)
            pl = np.zeros((R,), np.float32)
            minr = max(self.cfg.transfer_min_rows, 1)
            live = False
            for i, (sid, target, feats, _) in enumerate(self._rel_static):
                w = self._transfer_priors.get(
                    (self._sid_types.get(sid), target,
                     self._default_degree(sid), len(feats)))
                if w is None or w.shape[0] > T:
                    continue
                need = minr - min(self.table.count(sid), minr)
                if need <= 0:
                    continue
                wp[i, :w.shape[0]] = w
                pl[i] = self.cfg.transfer_strength * need / minr
                live = True
            if live:
                return upload(wp, self.device), upload(pl, self.device)
            self._transfer_priors = {}    # fully decayed: back to zeros
        z = self._prior_zero
        if z is None or z[0] != (R, T):
            f32 = dict(dtype=torch.float32, device=self.device)
            z = self._prior_zero = ((R, T), torch.zeros((R, T), **f32),
                                    torch.zeros((R,), **f32))
        return z[1], z[2]

    def _fleet_priors(self) -> Dict[tuple, np.ndarray]:
        """Fleet-mean regression weights grouped by (service type, target,
        degree, n_features) from the current stacked models — captured at
        churn time (the one device-to-host copy is on the cold path) so
        arriving services of a known type warm-start instead of
        re-triggering fleet-wide exploration. Falls back to the previously
        captured priors when no fit has happened yet."""
        if self.stacked is None or not self.stacked.labels:
            return dict(self._transfer_priors)
        W = self.stacked.w.cpu().numpy()
        groups: Dict[tuple, list] = {}
        for i, (sid, target, _, degree, t, f) in enumerate(
                self.stacked.labels):
            key = (self._sid_types.get(sid), target, degree, f)
            groups.setdefault(key, []).append(W[i, :t])
        out = dict(self._transfer_priors)
        for key, rows in groups.items():
            out[key] = np.mean(np.stack(rows), axis=0)
        return out

    # -- the decide on the device ------------------------------------------------
    def _dispatch_fused(self, prep, obs, seed: int, x0: np.ndarray
                        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Fit (+ forecast) + solve + NOISE on the device, queued without
        waiting; returns (out = [a | noised | predictions | score] on the
        device, w, n_fc), n_fc being the number of per-service predictions
        in ``out`` (0 without the forecaster). Streaming preps rebuild or
        rank-k push the device-resident accumulators — structural AND
        forecaster — as a side effect."""
        plan = self._fit_plan
        dev = self.device
        kind, payload = prep
        rps_np = self._rps_vector(obs)
        fc = self._forecast \
            if (self._forecast_on() and self._fc_prep is not None) else None
        if fc is not None:
            # score the prediction that targeted THIS round, then build the
            # cycle's gate inputs: lag windows, AR priors, use mask
            fc.settle(self.rounds, rps_np)
            lagm = upload(fc.lag_matrix(self.table), dev)
            fwp, fpl = (upload(x, dev) for x in fc.prior_arrays())
            use = upload(fc.use_mask(), dev)
        wp, pl = self._prior_args()
        rps = upload(rps_np, dev)
        x0_t = upload(np.asarray(x0, np.float32), dev)
        streaming = self._streaming()
        if streaming:
            if kind == "batch":
                # invalidated (first fit, churn, plan change): rebuild the
                # device window, then run the steady-state push empty
                self._stream = self._stream_rebuild(payload)
                payload = [(_EMPTY_X, _EMPTY_Y)] * plan.n_relations
            st = self._stream
            k_cap = plan.delta_capacity(max((len(Y) for _, Y in payload),
                                            default=1))
            dbuf = upload(plan.fill_delta(payload, k_cap), dev)
            state = plan.stream_update_arrays(
                st["state"], *plan.unpack_delta(dbuf, k_cap))
            w = plan.stream_fit_arrays(state, wp, pl)     # solve from Gram
            st["state"] = state
        else:
            buf = upload(plan.fill_packed(payload), dev)
            w = plan.fit_arrays(*plan.unpack(buf), wp, pl)
        extra: Tuple[torch.Tensor, ...] = ()
        n_fc = 0
        if fc is not None:
            fplan = fc.plan
            fkind, fpairs = self._fc_prep
            if streaming:
                fk_cap = fc.delta_capacity(self._fc_prep)
                if fkind == "batch" or fc.state is None:
                    # forecaster ring invalidated too: rebuild it on the
                    # device, then run the same steady-state push empty
                    fc.state = fplan.stream_rebuild(fpairs)
                    fpairs = [(_EMPTY_X, _EMPTY_Y)] * fplan.n_relations
                fdbuf = upload(fplan.fill_delta(fpairs, fk_cap), dev)
                fc.state = fplan.stream_update_arrays(
                    fc.state, *fplan.unpack_delta(fdbuf, fk_cap))
                fw = fplan.stream_fit_arrays(fc.state, fwp, fpl)
            else:
                fbuf = upload(fplan.fill_packed(fpairs), dev)
                fw = fplan.fit_arrays(*fplan.unpack(fbuf), fwp, fpl)
            fc.last_w = fw
            pred, rps = fc.predict_tracer(fw, lagm, use, rps)
            extra, n_fc = (pred,), len(fc.services)
        if streaming:
            st["pushes"] += 1
            every = self.cfg.stream_resync_every
            if every and st["pushes"] % every == 0:
                # exact Gram recompute from the device ring (no upload):
                # bounds incremental float32 drift on arbitrarily long runs
                st["state"] = plan.stream_resync_arrays(st["state"])
                if fc is not None and fc.state is not None:
                    fc.state = fc.plan.stream_resync_arrays(fc.state)
        return self._tail(plan.stacked(w), x0_t, seed, rps, extra), w, n_fc

    def _tail(self, sm: StackedModels, x0: torch.Tensor, seed: int,
              rps: torch.Tensor, extra: Tuple[torch.Tensor, ...] = ()
              ) -> torch.Tensor:
        """Solve + NOISE from the fitted models at the current budget; the
        generator seeded with ``seed`` draws the random starts' uniforms,
        then the noise. Returns [a | noised | *extra | scores] (one score,
        or one a host of a fleet)."""
        problem, fp = self.problem, self.fleet_problem
        starts, iters, lr = (self._budget_starts, self._budget_iters,
                             self.cfg.pgd_lr)
        u = self._start_uniforms(seed)
        if fp is None:
            a, score = pgd_solve(x0, u, problem.tables, sm, rps,
                                 float(self.capacity), n_starts=starts,
                                 iters=iters, lr=lr,
                                 n_services=len(problem.specs))
            score = score.reshape(1)
        else:
            # one batched solve per layout bucket, packed scatter back
            a, score = fp.solve_rows(x0, u, sm, rps, n_starts=starts,
                                     iters=iters, lr=lr)
        eta = self._eta_t()
        if eta > 0:
            eps = torch.randn(a.shape, generator=self._gen,
                              device=self.device)
            noised = self._noise(a, eps)
        else:
            noised = a
        return torch.cat([a, noised, *extra, score])

    def _start_uniforms(self, seed: int):
        """Seed the agent's generator with this decide's seed and draw the
        random starts' uniforms from it at the CURRENT budget:
        (budget_starts - 3, D) on one host (no rows below 4 starts), one
        (B, budget_starts - 3, D_max) a layout bucket of a fleet. The noise
        comes next from the same generator."""
        self._gen.manual_seed(seed)
        if self.fleet_problem is not None:
            return self.fleet_problem.uniforms(self._gen, self._budget_starts)
        return torch.rand((max(self._budget_starts - 3, 0),
                           self.problem.dim),
                          generator=self._gen, device=self.device)

    def _decide_fused(self, prep, obs, seed: int, x0: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Fit (+ forecast) + solve + project + NOISE; returns (optimum for
        the warm-start cache, noised plan vector, score)."""
        out, w, n_fc = self._dispatch_fused(prep, obs, seed, x0)
        out = out.cpu().numpy()   # the cycle's ONE device->host transfer
        self.stacked = self._fit_plan.stacked(w)   # weights stay on device
        self._models_view = None
        a, noised, score, pred = self._split_out(out, self.problem.dim, n_fc)
        if pred is not None:
            self._forecast.note(self.rounds + self._forecast.horizon, pred)
        return a, noised, score

    # -- marginal-fulfillment placement (candidate-batched scorer) --------------
    def _placement_problem(self, residents: Dict[str, Tuple[int, ...]],
                           caps: Dict[str, float]
                           ) -> Tuple[PlacementProblem,
                                      Dict[Tuple[str, str], Tuple[int, int]]]:
        """The candidate batch for the CURRENT residency: per host its
        resident subset, plus per (service, host) the with/without what-if
        variant — deduplicated (all of a host's 'without' variants share its
        base subset) and built once per topology (bounded cache of 4).
        Returns the (cached) ``PlacementProblem`` and the candidate-index
        plan {(sid, host): (with_id, without_id)}."""
        hosts = sorted(residents)
        sidx = {s.name: i for i, s in enumerate(self.problem.specs)}
        cand: Dict[Tuple[str, Tuple[int, ...]], int] = {}
        subsets: List[Tuple[int, ...]] = []
        capacities: List[float] = []

        def cid(host: str, subset: Tuple[int, ...]) -> int:
            k = cand.get((host, subset))
            if k is None:
                k = cand[(host, subset)] = len(subsets)
                subsets.append(subset)
                capacities.append(float(caps[host]))
            return k

        plan: Dict[Tuple[str, str], Tuple[int, int]] = {}
        base = {h: cid(h, residents[h]) for h in hosts}
        for sid in self.services:
            i = sidx[sid]
            cur = self.platform.host_of(sid).host
            for h in hosts:
                if h == cur:
                    plan[(sid, h)] = (
                        base[h],
                        cid(h, tuple(j for j in residents[h] if j != i)))
                else:
                    plan[(sid, h)] = (
                        cid(h, tuple(sorted(residents[h] + (i,)))), base[h])
        key = tuple((h, residents[h], float(caps[h])) for h in hosts)
        pp = cached_fn(self._placement_cache, key,
                       lambda: PlacementProblem(self.problem, subsets,
                                                capacities,
                                                shard=self.cfg.shard), size=4)
        return pp, plan

    def _score_uniforms(self, pp: PlacementProblem):
        """The placement snapshot's random starts at the current scorer
        budget: a generator seeded 0 (the snapshot is deterministic), one
        draw a layout bucket."""
        self._score_gen.manual_seed(0)
        return pp.uniforms(self._score_gen, self._score_starts)

    @_on_agent_stream
    def placement_scores(self, obs: Optional[Mapping] = None
                         ) -> Dict[str, Dict[str, float]]:
        """Predicted marginal SLO fulfillment of every (service, host) pair.

        For service s and host h: solve h's residents WITH s under h's own
        budget, minus the solve WITHOUT s — the fulfillment the fleet gains
        (or loses, when s squeezes the residents' shares) by hosting s on h.
        All O(|S| x |H|) candidate subsets are scored by one batched solve
        per layout bucket (``PlacementProblem``) and ONE device-to-host
        copy. Deterministic, so ``Fleet.rebalance`` fed these scores is
        idempotent. Returns {} off a Fleet or until every relation has a
        fitted model (exploration phase)."""
        if self.fleet_problem is None:
            return {}
        if not self._models_complete():
            self._fit_models()
        if not self._models_complete():
            return {}
        problem = self.problem
        rps = self._rps_vector(obs)
        x0 = self._cached_x if self._cached_x is not None else \
            (0.5 * (problem.lower + problem.upper)).astype(np.float32)
        sidx = {s.name: i for i, s in enumerate(problem.specs)}
        hosts = {h.host: h for h in self.platform.hosts()}
        caps = {name: h.capacity[self.cfg.resource]
                for name, h in hosts.items()}
        residents = {name: tuple(sorted(sidx[s] for s in h.services()
                                        if s in sidx))
                     for name, h in hosts.items()}
        pp, plan = self._placement_problem(residents, caps)
        # the ADAPTIVE scoring budget (the seed stays fixed): per budget
        # level the scores are deterministic, and the hysteresis gate plus
        # the restore-on-shift adaptation absorb the level changes
        models = self.stacked \
            if (self.cfg.fused and self.stacked is not None) else self.models
        vec = pp.scores(models, rps, x0, n_starts=self._score_starts,
                        iters=self._score_iters, lr=self.cfg.pgd_lr,
                        u=self._score_uniforms(pp))
        out: Dict[str, Dict[str, float]] = {}
        for sid in self.services:
            row = {}
            for name in hosts:
                w, wo = plan[(sid, name)]
                row[name] = float(vec[w] - vec[wo])
            out[sid] = row
        return out

    @_on_agent_stream
    def rebalance(self, obs: Optional[Mapping] = None,
                  hysteresis: Optional[float] = None
                  ) -> List[Tuple[str, str, str]]:
        """Migrate services toward higher predicted marginal fulfillment,
        one move per fresh score snapshot.

        A move's gain (best host's score minus the current host's) is
        exactly the predicted fleet-fulfillment delta of applying it, so
        applying the single best move and re-scoring walks total
        fulfillment strictly upward by more than the hysteresis gate per
        move — the loop terminates, never ping-pongs a service, and a
        second ``rebalance`` right after convergence is a no-op. Rebinds
        the bucketed fleet solve to the final topology. Returns the
        applied moves as (sid, from, to)."""
        all_moves: List[Tuple[str, str, str]] = []
        for _ in range(2 * max(len(self.services), 1)):   # safety cap
            scores = self.placement_scores(obs)
            if not scores:
                break
            moves = self.platform.rebalance(scores, hysteresis, limit=1)
            if not moves:
                break
            all_moves.extend(moves)
        if all_moves:
            self._build_fleet_problem()   # bucket layouts follow placement
        return all_moves

    @_on_agent_stream
    def refresh_topology(self) -> None:
        """Re-bind the agent to the platform's CURRENT topology after churn
        (host failure or drain, capacity degradation, service arrival or
        departure — ``env.simulator`` churn events call this).

        Placement-only changes (same service set) keep the fitted models,
        the training table and the warm start — only the per-host fleet
        solve and the aggregate capacity rebuild, and the streaming fit
        repacks its device window once. Service-set changes rebuild the
        optimization problem, carrying each surviving service's warm-start
        slice over by name; models refit from the (persistent) training
        table on the next cycle. With ``transfer_priors`` the fleet-mean
        weights per service type (regression AND forecaster) are captured
        here and warm-start every NEW relation through the prior-mean
        ridge, so an arrival keeps the fleet solving instead of re-entering
        exploration; without priors (first ever fit, transfer disabled)
        the agent explores until every new relation has >= 3 observed
        rows, like the initial xi phase. Any pending pipelined solve is
        dropped."""
        current = self.platform.services()
        cur_set = set(current)
        kept = [s for s in self.services if s in cur_set]
        new = [s for s in current if s not in set(self.services)]
        self.capacity = self.platform.capacity[self.cfg.resource]
        # prune departed services from the control-plane state FIRST — on
        # every refresh, including placement-only ones: stale burn states
        # and accountant rings would keep a departed service's last SLI
        # firing fast-burn alerts
        self.burn_states = {s: st for s, st in self.burn_states.items()
                            if s in cur_set}
        if self.accountant is not None:
            self.accountant.prune(current)
        for sid in [s for s in self._last_rps if s not in cur_set]:
            self._last_rps.pop(sid, None)
        for sid in [s for s in self._rps_scale if s not in cur_set]:
            self._rps_scale.pop(sid, None)
        # churn is a regime change: restore the full solver AND scorer
        # budgets and let the score baseline re-establish before adapting
        self._restore_budget()
        self._last_score = None
        if kept == self.services and not new:
            self._build_fleet_problem()   # placement/capacity change only
            return
        # the service set changed: capture transfer priors from the OLD
        # fitted models/forecaster BEFORE the rebuild discards them —
        # ``_sid_types`` still describes the old topology here, which is
        # exactly what the stacked labels refer to
        if self.cfg.transfer_priors:
            self._transfer_priors = self._fleet_priors()
        if self._forecast is not None:
            self._fc_priors.update(self._forecast.type_means())
        self._forecast = None             # rebuilt against the new set
        self._fc_prep = None
        old_slice = {s.name: (self.problem.offsets[i], s.n_params)
                     for i, s in enumerate(self.problem.specs)}
        prev_x = self._cached_x
        self.services = kept + new
        self.problem = self._build_problem()
        self._build_fleet_problem()
        self._build_rel_static()
        self._placement_cache.clear()
        # warm start: surviving services keep their cached slices, new ones
        # start at the box midpoint (projected feasible at first use)
        if prev_x is not None:
            x = (0.5 * (self.problem.lower + self.problem.upper)
                 ).astype(np.float32)
            for i, s in enumerate(self.problem.specs):
                if s.name in old_slice:
                    off, n = old_slice[s.name]
                    o = self.problem.offsets[i]
                    x[o:o + n] = prev_x[off:off + n]
            self._cached_x = x
        self.stacked = None               # refit against the new relation set
        self._models_view = None
        self._fit_plan = None
        self._fit_plan_key = None
        self._stream = None               # device window follows the plan
        for sid in list(self._models_loop):
            if sid not in set(self.services):
                self._models_loop.pop(sid)

    # -- NOISE (Eq. 5) ------------------------------------------------------------
    def _eta_t(self) -> float:
        """Current noise ratio: eta decayed past the exploration phase."""
        return self.cfg.eta * (
            self.cfg.eta_decay ** max(self.rounds - self.cfg.xi, 0))

    def _noise(self, a, eps):
        """a + eps * |a| * eta_t for standard-normal ``eps`` (tensors or
        arrays). Eq. (5) prints sigma=(a*eta)^2, but the paper's own worked
        example (a=4, eta=0.1 -> sigma=0.4) and the "relative noise" wording
        imply sigma = a*eta; we follow the example."""
        return a + eps * abs(a) * self._eta_t()

    # -- decision vector -> declarative plan (§IV-C) ------------------------------
    def _plan(self, a: np.ndarray) -> ScalingPlan:
        plan = ScalingPlan(agent=self.name, cycle=self.rounds)
        for i, spec in enumerate(self.problem.specs):
            off = self.problem.offsets[i]
            for j, name in enumerate(spec.param_names):
                plan.set(spec.name, name, float(a[off + j]))
        return plan
