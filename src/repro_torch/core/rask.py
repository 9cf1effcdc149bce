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
agent after a host failure, drain or capacity change: the fitted models,
the training table and the warm start stay; the fleet solve is rebuilt and
the streaming fit's device window is repacked once (``_topo_gen``).

SLO error budgets: ``attach_accountant`` binds an ``obs.SLOAccountant``;
every ``observe`` advances it and every ``DecisionInfo`` carries its
``burn_alerts`` and ``max_burn``. A firing fast-burn alert takes a
placement snapshot every cycle and scales its rows by the accountant's
burn weights (capped at ``burn_weight_cap``). In ``repro`` it also
restores a shrunk solver budget; the port never shrinks the budget.

Options not ported yet raise ``NotImplementedError`` naming their ROADMAP
item when set to a non-default value: ``backend="slsqp"``,
``fused=False``, ``pipeline``, ``forecast``, ``adapt_budget`` and
``auto_degree``; so does ``refresh_topology`` after a change of the
service set (arrival or departure, item 7). Transfer priors are captured
only at such a change, so ``_prior_args`` always gives zeros.
``repro``'s ``aot``, ``shard`` and ``objective_impl`` fields are left out:
they choose how JAX compiles, shards and which implementation scores;
here nothing compiles, one card takes the whole solve, and the tensors'
device picks the implementation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, upload
from .api import DecisionInfo, PlanningAgent, ScalingPlan
from .platform import MUDAP
from .regression import BatchedFitPlan, PolynomialModel, StackedModels, \
    fit_batched_arrays, pad_capacity
from .solver import FleetSolverProblem, PlacementProblem, ServiceSpec, \
    SolverProblem, cached_fn, pgd_solve
from .telemetry import TrainingTable

# Structural knowledge K: per service, target -> feature parameter names.
# E.g. {"tp_max": ("cores", "data_quality")} — Eq. (7).
Knowledge = Mapping[str, Mapping[str, Sequence[str]]]

# the ROADMAP items (Queue 1, slice B deferrals) of the options that are not
# ported yet, with the default that stays allowed
_UNPORTED = {
    "backend": ("pgd", "9 (SLSQP and fused=False)"),
    "fused": (True, "9 (SLSQP and fused=False)"),
    "pipeline": (False, "3 (pipeline)"),
    "forecast": (False, "4 (forecast.py)"),
    "adapt_budget": (False, "5 (adapt_budget)"),
    "auto_degree": (False, "8 (auto_degree)"),
}


def _todo(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP Queue 1, slice B "
        f"deferral {item}")


@dataclasses.dataclass
class RaskConfig:
    """``repro``'s ``RaskConfig`` fields that the port implements, with the
    same defaults (see the module docstring for the rest)."""

    xi: int = 20                # initial exploration rounds
    eta: float = 0.0            # Gaussian action-noise ratio
    delta: int = 2              # default polynomial degree
    delta_per_service: Optional[Dict[str, int]] = None
    backend: str = "pgd"        # only "pgd"; "slsqp" is not ported yet
    cache: bool = True          # §IV-B3 warm-start from last assignment
    ridge: float = 1e-6
    eta_decay: float = 1.0      # beyond-paper: <1.0 decays noise after xi
    auto_degree: bool = False   # not ported yet
    pgd_starts: int = 6
    pgd_iters: int = 32
    pgd_lr: float = 0.18
    resource: str = "cores"     # the shared-capacity resource name
    fused: bool = True          # only True; the seed loop is not ported yet
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
    pipeline: bool = False      # not ported yet
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
    adapt_budget: bool = False  # not ported yet
    forecast: bool = False      # not ported yet
    # SLO error-budget control (obs, active once an accountant is
    # attached): a firing fast-burn alert overrides the rebalance cadence
    # (a snapshot every cycle until it clears), and the burn weights
    # (capped at burn_weight_cap) scale placement-score rows, so the one
    # move a snapshot goes to the service burning fastest; ``repro``'s
    # alert also restores a shrunk solver budget (adapt_budget, not ported)
    burn_control: bool = True
    burn_weight_cap: float = 4.0    # max extra weight (see burn_weights)

    def check_ported(self) -> None:
        for name, (default, item) in _UNPORTED.items():
            value = getattr(self, name)
            if value != default:
                raise _todo(f"RaskConfig({name}={value!r})", item)


# host-side stand-in for "no new rows this cycle" (rebuild cycles push the
# window via ``stream_rebuild`` and then run the delta push empty)
_EMPTY_X = np.zeros((0, 1), np.float32)
_EMPTY_Y = np.zeros((0,), np.float32)


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
        self.cfg.check_ported()
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
        self._cached_x: Optional[np.ndarray] = None
        self.problem = self._build_problem()
        # topology generation: bumped by every fleet rebuild (migration,
        # churn), it invalidates the streaming fit's device window once
        self._topo_gen = 0
        # on a Fleet, decide against each host's OWN capacity (one batched
        # solve per layout bucket) instead of the aggregate relaxation
        self.fleet_problem: Optional[FleetSolverProblem] = None
        self._build_fleet_problem()
        # candidate-batched placement scorers, keyed on residency topology
        self._placement_cache: Dict[tuple, PlacementProblem] = {}
        self._score_gen = torch.Generator(self.device)
        self.moves_total = 0
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
        self._prior_zero: Optional[tuple] = None
        # last-known per-service rps: the fallback when a cycle's observe
        # window is empty (a paused scrape must not be solved as zero load)
        self._last_rps: Dict[str, float] = {}
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

    def _build_fleet_problem(self) -> None:
        """(Re)bind the per-host fleet solve to the platform's CURRENT
        placement — at construction and again after a migration or churn
        (the bucket layouts follow the topology)."""
        self._topo_gen += 1
        platform = self.platform
        if hasattr(platform, "hosts") and hasattr(platform, "host_of"):
            self.fleet_problem = FleetSolverProblem(
                self.problem,
                {sid: platform.host_of(sid).host for sid in self.services},
                {h.host: h.capacity[self.cfg.resource]
                 for h in platform.hosts()})

    def _build_rel_static(self) -> None:
        """Static per-relation fit metadata (feature names + scales), in the
        problem's global relation order."""
        self._rel_static: List[Tuple[str, str, Tuple[str, ...], np.ndarray]] = []
        for _, sid, target, _ in self.problem.relations:
            svc = self.platform.service(sid)
            feats = tuple(self.knowledge[svc.sid.type][target])
            scale = np.asarray(
                [svc.api.parameter(f).max_value for f in feats], np.float32)
            self._rel_static.append((sid, target, feats, scale))

    @property
    def models(self) -> Dict[str, Dict[str, PolynomialModel]]:
        """Seed-style {service: {target: PolynomialModel}} view, sliced
        lazily out of the stacked tensors."""
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
        return SolverProblem(specs, device=self.device)

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
        if self.accountant is not None:
            self.burn_states = self.accountant.update(t)
        return states

    # -- Algorithm 1 ------------------------------------------------------------
    def decide(self, obs: Mapping[str, Mapping[str, float]]) -> ScalingPlan:
        """One RASK round: explore or fit+solve; returns the proposed plan
        (the caller — environment or ``cycle`` — applies it)."""
        self.rounds += 1
        if self.rounds < self.cfg.xi:                       # lines 3-5
            self.last_decision = DecisionInfo(explored=True)
            return self._plan(self._explore())
        # a firing fast-burn alert: ``repro`` also restores its full solver
        # budget here, which the port always runs (adapt_budget is not
        # ported); the alerts drive the placement stage
        alerts = self._fast_alerts()
        moves, scored = self._maybe_rebalance(obs, alerts)
        self.moves_total += len(moves)
        placement = dict(
            moves=len(moves),
            score_starts=self.cfg.score_starts if scored else 0,
            score_iters=self.cfg.score_iters if scored else 0,
            burn_alerts=len(alerts), max_burn=self._max_burn())
        t0 = time.perf_counter()
        out = self._solve_cycle(obs)                        # lines 6-11
        if out is None:
            self.last_decision = DecisionInfo(explored=True, **placement)
            return self._plan(self._explore())
        runtime = time.perf_counter() - t0
        compile_s, self._build_s = self._build_s, 0.0
        a, noised, score = out
        self._cached_x = np.asarray(a, np.float32)          # §IV-B3 cache
        self.compile_s_total += compile_s
        self.last_decision = DecisionInfo(
            explored=False, runtime_s=runtime, compile_s=compile_s,
            score=score, pgd_starts=self.cfg.pgd_starts,
            pgd_iters=self.cfg.pgd_iters, **placement)
        return self._plan(noised)

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
        return moves, True

    def _solve_cycle(self, obs):
        """One full fit+solve+NOISE pass; returns (optimum, noised plan
        vector, score), or None while models are incomplete."""
        prep = self._prepare_fit_structural()               # lines 6-9
        if prep is None:
            self.stacked = None
            return None
        # per-decide randomness, drawn from the numpy rng as repro draws it
        seed = int(self.rng.integers(2 ** 31))
        return self._decide_fused(prep, obs, seed, self._x0())

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
    def _prepare_fit_structural(self):
        """Fit inputs for this decide: ``("delta", deltas)`` with only the
        rows appended since each relation's cursor (the streaming steady
        state), or ``("batch", data)`` with the full design window
        (``streaming_fit=False``, or a streaming rebuild). None while some
        relation still lacks >= 3 usable rows (the agent keeps exploring)."""
        streaming = self.cfg.streaming_fit
        if streaming:
            deltas = self._stream_deltas()
            if deltas is not None:
                return ("delta", deltas)
        data = self._collect_fit_data()   # (re)builds the plan
        if data is None:
            self._stream = None
            return None
        if streaming:
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
        Returns None until every relation has >= 3 usable rows."""
        data = []
        degrees = []
        max_rows = 0
        for sid, target, feats, scale in self._rel_static:
            X, Y = self.table.design_matrix(sid, feats, target)
            if len(Y) < 3:
                return None
            max_rows = max(max_rows, len(Y))
            degrees.append(self._degree(sid))
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

    def _degree(self, sid: str) -> int:
        if self.cfg.delta_per_service and sid in self.cfg.delta_per_service:
            return self.cfg.delta_per_service[sid]
        return self.cfg.delta

    def _prior_args(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_prior (R, T_max), prior_lam (R,)) for this cycle's fit. Priors
        are captured only at churn, which the port does not have yet, so
        these are zeros (prior_lam == 0 solves the exact unprior'd system),
        made once per plan shape on the device."""
        plan = self._fit_plan
        R, T = plan.n_relations, plan.t_max
        z = self._prior_zero
        if z is None or z[0] != (R, T):
            f32 = dict(dtype=torch.float32, device=self.device)
            z = self._prior_zero = ((R, T), torch.zeros((R, T), **f32),
                                    torch.zeros((R,), **f32))
        return z[1], z[2]

    # -- the decide on the device ------------------------------------------------
    def _dispatch_fused(self, prep, obs, seed: int, x0: np.ndarray
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fit + solve + NOISE on the device, queued without waiting;
        returns (out = [a | noised | score] on the device, w). Streaming
        preps rebuild or rank-k push the device-resident accumulators as a
        side effect."""
        plan = self._fit_plan
        dev = self.device
        kind, payload = prep
        wp, pl = self._prior_args()
        rps = upload(self._rps_vector(obs), dev)
        x0_t = upload(np.asarray(x0, np.float32), dev)
        if self.cfg.streaming_fit:
            if kind == "batch":
                # invalidated (first fit, plan change): rebuild the device
                # window, then run the steady-state push empty
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
            st["pushes"] += 1
            every = self.cfg.stream_resync_every
            if every and st["pushes"] % every == 0:
                # exact Gram recompute from the device ring (no upload):
                # bounds incremental float32 drift on arbitrarily long runs
                st["state"] = plan.stream_resync_arrays(st["state"])
        else:
            buf = upload(plan.fill_packed(payload), dev)
            w = fit_batched_arrays(*plan.unpack(buf), plan._E, plan._tmask,
                                   plan._nterms, plan._scale, plan.ridge,
                                   plan.max_degree, wp, pl)
        return self._tail(plan.stacked(w), x0_t, seed, rps), w

    def _tail(self, sm: StackedModels, x0: torch.Tensor, seed: int,
              rps: torch.Tensor) -> torch.Tensor:
        """Solve + NOISE from the fitted models; the generator seeded with
        ``seed`` draws the random starts' uniforms, then the noise. Returns
        [a | noised | scores] (one score, or one a host of a fleet)."""
        cfg = self.cfg
        problem, fp = self.problem, self.fleet_problem
        u = self._start_uniforms(seed)
        if fp is None:
            a, score = pgd_solve(x0, u, problem.tables, sm, rps,
                                 float(self.capacity),
                                 n_starts=cfg.pgd_starts,
                                 iters=cfg.pgd_iters, lr=cfg.pgd_lr,
                                 n_services=len(problem.specs))
            score = score.reshape(1)
        else:
            # one batched solve per layout bucket, packed scatter back
            a, score = fp.solve_rows(x0, u, sm, rps, n_starts=cfg.pgd_starts,
                                     iters=cfg.pgd_iters, lr=cfg.pgd_lr)
        eta = self._eta_t()
        if eta > 0:
            eps = torch.randn(a.shape, generator=self._gen,
                              device=self.device)
            noised = self._noise(a, eps)
        else:
            noised = a
        return torch.cat([a, noised, score])

    def _start_uniforms(self, seed: int):
        """Seed the agent's generator with this decide's seed and draw the
        random starts' uniforms from it: (n_starts - 3, D) on one host, one
        (B, n_starts - 3, D_max) a layout bucket of a fleet. The noise
        comes next from the same generator."""
        self._gen.manual_seed(seed)
        if self.fleet_problem is not None:
            return self.fleet_problem.uniforms(self._gen, self.cfg.pgd_starts)
        return torch.rand((max(self.cfg.pgd_starts - 3, 0), self.problem.dim),
                          generator=self._gen, device=self.device)

    def _decide_fused(self, prep, obs, seed: int, x0: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Fit + solve + project + NOISE; returns (optimum for the
        warm-start cache, noised plan vector, score)."""
        out, w = self._dispatch_fused(prep, obs, seed, x0)
        out = out.cpu().numpy()   # the cycle's ONE device->host transfer
        self.stacked = self._fit_plan.stacked(w)   # weights stay on device
        self._models_view = None
        d = self.problem.dim
        return out[:d], out[d:2 * d], float(out[2 * d:].sum())

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
                                                capacities), size=4)
        return pp, plan

    def _score_uniforms(self, pp: PlacementProblem):
        """The placement snapshot's random starts: a generator seeded 0
        (the snapshot is deterministic), one draw a layout bucket."""
        self._score_gen.manual_seed(0)
        return pp.uniforms(self._score_gen, self.cfg.score_starts)

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
        if self.stacked is None:
            data = self._collect_fit_data()
            if data is None:
                return {}
            self.stacked = self._fit_plan.fit(data)
            self._models_view = None
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
        vec = pp.scores(self.stacked, rps, x0, n_starts=self.cfg.score_starts,
                        iters=self.cfg.score_iters, lr=self.cfg.pgd_lr,
                        u=self._score_uniforms(pp))
        out: Dict[str, Dict[str, float]] = {}
        for sid in self.services:
            row = {}
            for name in hosts:
                w, wo = plan[(sid, name)]
                row[name] = float(vec[w] - vec[wo])
            out[sid] = row
        return out

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

    def refresh_topology(self) -> None:
        """Re-bind the agent to the platform's CURRENT topology after churn
        that keeps the service set (host failure or drain, capacity
        degradation — ``env.simulator`` churn events call this): the fitted
        models, the training table and the warm start stay; the aggregate
        capacity and the per-host fleet solve rebuild, and the streaming
        fit repacks its device window once. A change of the service set
        (arrival or departure) raises ``NotImplementedError``: it needs the
        transfer priors (ROADMAP Queue 1, item 7)."""
        current = self.platform.services()
        cur_set = set(current)
        kept = [s for s in self.services if s in cur_set]
        new = [s for s in current if s not in set(self.services)]
        if kept != self.services or new:
            raise _todo("refresh_topology after a change of the service set",
                        "7 (transfer priors and refresh_topology)")
        self.capacity = self.platform.capacity[self.cfg.resource]
        # prune departed services from the control-plane state — on every
        # refresh, as repro does: stale burn states and accountant rings
        # would keep a departed service's last SLI firing alerts
        self.burn_states = {s: st for s, st in self.burn_states.items()
                            if s in cur_set}
        if self.accountant is not None:
            self.accountant.prune(current)
        for sid in [s for s in self._last_rps if s not in cur_set]:
            self._last_rps.pop(sid, None)
        self._build_fleet_problem()   # placement/capacity change only

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
