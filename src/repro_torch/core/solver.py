"""Numerical solver for RASK's SOLVE step — paper Eq. (4), on the card (the
port of ``repro/core/solver.py``'s PGD path).

    SOLVE := max_A  sum_i sum_j  phi(q_j, p_i ^ w_i(p_i))
             s.t.   sum_i p_i <= C_p          (global resource constraint)
                    p_min <= p <= p_max       (per-parameter bounds)

Multi-start projected-gradient ascent: the K starts are one (K, D) batch,
every ascent step takes its gradient from the objective's vector-Jacobian
product alone (``kernels/ops.py::rask_objective_vjp``: on a CUDA tensor
the hand-written backward kernel, with no forward and no autograd graph),
and the finals are scored through its forward
(``kernels/ops.py::rask_objective``, the forward kernel). Projection onto
the box/halfspace intersection is exact
(bisection on the KKT multiplier, i.e. water-filling), with ``repro``'s
bisection counts; in eager PyTorch a shallow bisection and a deep one are
both plain Python loops, so ``repro``'s static unroll for ``iters <= 8``
has nothing to choose between here.

The uniform draws of the random starts are an argument ``u``
((n_starts - 3, D)), drawn by the caller from an explicit
``torch.Generator``, so a test can feed the port the numbers ``repro`` drew.

Not ported yet (ROADMAP Queue 1, slice B deferrals): the SLSQP reference
and the seed's loop objective (``fused=False``), ``solve_many``,
``FleetSolverProblem`` and ``PlacementProblem``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, \
    Tuple, Union

import numpy as np
import torch

from ..kernels import ops as kernel_ops
from .regression import PolynomialModel, StackedModels, stack_models
from .slo import SLO

COMPLETION = "completion"
THROUGHPUT_MAX = "tp_max"

# SLO kinds in the fused phi table
_KIND_PARAM = 0        # metric is a decision parameter: phi = min(a/target, 1)
_KIND_COMPLETION = 1   # §V-B(a): phi = min(tp_max / (rps * target), 1)
_KIND_RELATION = 2     # metric is a regression target: phi = min(pred/target, 1)

# bisection depth for the exact water-filling projection: the KKT multiplier
# lives in [0, max masked headroom] (resource bounds, single digits), so 40
# halvings put it far below float32 resolution
_PROJECT_ITERS = 40

# relative capacity slack on emitted assignments: float32 projection can
# overshoot the budget by ~1e-6 C, which apply-time water-filling would
# (correctly but noisily) report as a capacity clip; solving against
# (1 - margin) C keeps every emitted plan strictly feasible in float64
_CAP_MARGIN = 1e-6

Models = Union[Mapping[str, Mapping[str, PolynomialModel]], StackedModels]


class ProblemTables(NamedTuple):
    """Everything the objective/projection needs, as tensors on one device."""

    lower: torch.Tensor          # (D,)
    upper: torch.Tensor          # (D,)
    resource_mask: torch.Tensor  # (D,) bool — counted against the capacity
    rel_gather: torch.Tensor     # (R, F) int32 — feature indices in a
    slo_kind: torch.Tensor       # (Q,) int32  _KIND_*
    slo_service: torch.Tensor    # (Q,) int32
    slo_weight: torch.Tensor     # (Q,)
    slo_target: torch.Tensor     # (Q,)
    slo_pidx: torch.Tensor       # (Q,) int32 — decision index (kind 0)
    slo_ridx: torch.Tensor       # (Q,) int32 — relation index (kinds 1, 2)


def project_capacity(a, lower, upper, mask, capacity,
                     iters: int = _PROJECT_ITERS):
    """Exact projection of each row of ``a`` (..., D) onto {box} ∩ {sum of
    masked entries <= capacity} (bisection on the KKT multiplier —
    water-filling). ``capacity`` is a float or a tensor of one value per
    row, shaped ``a.shape[:-1]``."""
    a = torch.clamp(a, lower, upper)
    if torch.is_tensor(capacity):
        capacity = capacity[..., None]
    maskf = mask.to(a.dtype)
    lam_lo = torch.zeros_like(a[..., :1])
    lam_hi = torch.amax((a - lower) * maskf, dim=-1, keepdim=True) + 1.0
    for _ in range(iters):
        lam = 0.5 * (lam_lo + lam_hi)
        tot = (torch.clamp(a - lam, lower, upper) * maskf).sum(-1,
                                                               keepdim=True)
        over = tot > capacity
        lam_lo = torch.where(over, lam, lam_lo)
        lam_hi = torch.where(over, lam_hi, lam)
    need = (a * maskf).sum(-1, keepdim=True) > capacity
    lam = torch.where(need, 0.5 * (lam_lo + lam_hi), 0.0)
    return torch.where(mask, torch.clamp(a - lam, lower, upper), a)


def segments_from_tables(a, tables: ProblemTables, sm: StackedModels, rps,
                         n_services: int):
    """Per-service weighted phi totals (n_services,) of one decision vector
    — one gather, one batched polynomial evaluation, branch-free phi, one
    segment sum (the objective's forward on a batch of one)."""
    return candidate_segments(a[None], tables, sm, rps, n_services)[0]


def candidate_segments(A, tables: ProblemTables, sm: StackedModels, rps,
                       n_services: int):
    """(K, D) candidates -> (K, n_services) through the objective entry
    point (kernel on the card, plain version on the CPU)."""
    return kernel_ops.rask_objective(
        A, tables.rel_gather, sm.w, sm.exponents, sm.term_mask, sm.x_scale,
        tables.slo_kind, tables.slo_service, tables.slo_weight,
        tables.slo_target, tables.slo_pidx, tables.slo_ridx, rps,
        n_services=n_services, max_degree=sm.max_degree)


def score_candidates(A, tables: ProblemTables, sm: StackedModels, rps,
                     n_services: int):
    """Objective for a batch of candidates (K, D) -> (K,)."""
    return candidate_segments(A, tables, sm, rps, n_services).sum(-1)


def pgd_solve(x0, u, tables: ProblemTables, sm: StackedModels, rps,
              capacity: float, *, n_starts: int, iters: int, lr: float,
              n_services: int):
    """Multi-start projected-gradient ascent for one problem instance;
    returns (assignment (D,), score ()) as tensors on x0's device.

    The start set is structured — the warm start, the water-filled upper
    bounds, the box midpoint, then ``lower + u * (upper - lower)`` for the
    uniform draws ``u`` (n_starts - 3, D) — and all starts ascend together
    as one (K, D) batch. Interior steps project with a shallow 6-step
    bisection, the step size follows a cosine decay from ``lr``, Adam
    moments scale the step per coordinate, and the finals are re-projected
    exactly against (1 - _CAP_MARGIN) C. Nothing here waits on the card.
    """
    lo, hi, mask = tables.lower, tables.upper, tables.resource_mask
    span = hi - lo
    dim = x0.shape[0]
    lr_t = (np.float32(lr) * np.float32(0.5) * (np.float32(1.0) + np.cos(
        np.float32(np.pi) * np.arange(iters, dtype=np.float32)
        / np.float32(iters))) + np.float32(1e-3)).astype(np.float32)

    def objective_grad(a):       # the VJP alone: no forward, no graph
        return kernel_ops.rask_objective_vjp(
            a, ones, tables.rel_gather, sm.w, sm.exponents, sm.term_mask,
            sm.x_scale, tables.slo_kind, tables.slo_service,
            tables.slo_weight, tables.slo_target, tables.slo_pidx,
            tables.slo_ridx, rps, n_services=n_services,
            max_degree=sm.max_degree)

    top_mid = project_capacity(torch.stack([hi, lo + 0.5 * span]), lo, hi,
                               mask, capacity)
    structured = torch.cat([x0[None], top_mid])[:n_starts]   # x0 first
    u = u.reshape(max(n_starts - 3, 0), dim)
    starts = torch.cat([structured, lo + u * span], dim=0)   # (K, D)
    ones = torch.ones((starts.shape[0], n_services), dtype=starts.dtype,
                      device=starts.device)

    a = project_capacity(starts, lo, hi, mask, capacity, iters=6)
    m = torch.zeros_like(a)
    v = torch.zeros_like(a)
    for i in range(iters):
        t = float(i + 1)
        g = objective_grad(a)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / float(np.float32(1.0) - np.float32(0.9) ** np.float32(t))
        vh = v / float(np.float32(1.0) - np.float32(0.999) ** np.float32(t))
        a = project_capacity(
            a + float(lr_t[i]) * span * mh / (torch.sqrt(vh) + 1e-8),
            lo, hi, mask, capacity, iters=6)
    # the finals and the x0 fallback, projected exactly in one batch
    last = project_capacity(torch.cat([a, x0[None]]), lo, hi, mask,
                            capacity * (1.0 - _CAP_MARGIN))
    finals, x0_proj = last[:-1], last[-1]
    scores = score_candidates(finals, tables, sm, rps, n_services)
    # tie-break toward the warm start: the regression is only trustworthy
    # near sampled configurations, so among (near-)equal model optima prefer
    # the one closest to the validated operating point
    dist = torch.linalg.vector_norm(
        (finals - x0[None]) / torch.clamp_min(span, 1e-6), dim=-1)
    finite = torch.isfinite(scores)
    adj = torch.where(finite, scores - 5e-3 * dist, -math.inf)
    best = torch.argmax(adj).reshape(1)
    a_best = finals.index_select(0, best)[0]
    s_best = scores.index_select(0, best)[0]
    # degenerate models can NaN every start: fall back to x0
    ok = torch.isfinite(s_best) & torch.isfinite(a_best).all()
    return (torch.where(ok, a_best, x0_proj),
            torch.where(ok, s_best, -math.inf))


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """Static optimization view of one service (bounds, SLOs, relation shapes)."""

    name: str
    param_names: Tuple[str, ...]
    lower: Tuple[float, ...]
    upper: Tuple[float, ...]
    resource_mask: Tuple[bool, ...]          # True -> counted against C
    slos: Tuple[SLO, ...]
    # target -> indices (into param_names) of the regression features
    relation_features: Tuple[Tuple[str, Tuple[int, ...]], ...]

    @property
    def n_params(self) -> int:
        return len(self.param_names)


class SolverProblem:
    """Flattens |S| services into one decision vector and builds Eq. (4).

    The phi table is laid out once at construction: ``relations`` fixes a
    global relation order r = 0..R-1 (service-major), ``_rel_gather``
    (R, F_max) indexes each relation's features in the decision vector
    (padded features re-read index 0 — harmless, their exponent is 0), and
    the per-SLO arrays (kind, service, weight, target, parameter index,
    relation index) drive a branch-free phi computation. ``tables`` holds
    them on ``device``.
    """

    def __init__(self, specs: Sequence[ServiceSpec],
                 device: Optional[torch.device] = None):
        self.specs = list(specs)
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.offsets: List[int] = []
        off = 0
        for s in self.specs:
            self.offsets.append(off)
            off += s.n_params
        self.dim = off
        self.lower = np.concatenate([np.asarray(s.lower, np.float32)
                                     for s in self.specs])
        self.upper = np.concatenate([np.asarray(s.upper, np.float32)
                                     for s in self.specs])
        self.resource_mask = np.concatenate(
            [np.asarray(s.resource_mask, bool) for s in self.specs])
        self._build_tables()
        # host copies of the bounds: exploration draws are projected on the
        # CPU (the plan goes straight back to the host)
        self._host_bounds = (torch.from_numpy(self.lower),
                             torch.from_numpy(self.upper),
                             torch.from_numpy(self.resource_mask))

    # -- static phi/gather tables for the objective ---------------------------
    def _build_tables(self) -> None:
        # global relation order: service-major, then spec order
        self.relations: List[Tuple[int, str, str, Tuple[int, ...]]] = []
        self._rel_index: Dict[Tuple[str, str], int] = {}
        for i, s in enumerate(self.specs):
            for target, feat_idx in s.relation_features:
                self._rel_index[(s.name, target)] = len(self.relations)
                self.relations.append((i, s.name, target, feat_idx))
        r_count = max(len(self.relations), 1)
        f_max = max([len(f) for *_, f in self.relations] or [1])
        self._rel_gather = np.zeros((r_count, f_max), np.int32)
        for r, (i, _, _, feat_idx) in enumerate(self.relations):
            for j, p in enumerate(feat_idx):
                self._rel_gather[r, j] = self.offsets[i] + p

        kinds, svc, weight, target, pidx, ridx = [], [], [], [], [], []
        for i, s in enumerate(self.specs):
            rel_targets = {t for t, _ in s.relation_features}
            for q in s.slos:
                if q.metric in s.param_names:
                    kinds.append(_KIND_PARAM)
                    pidx.append(self.offsets[i] + s.param_names.index(q.metric))
                    ridx.append(0)
                elif q.metric == COMPLETION:
                    kinds.append(_KIND_COMPLETION)
                    pidx.append(0)
                    ridx.append(self._rel_index[(s.name, THROUGHPUT_MAX)])
                elif q.metric in rel_targets:
                    kinds.append(_KIND_RELATION)
                    pidx.append(0)
                    ridx.append(self._rel_index[(s.name, q.metric)])
                else:
                    raise KeyError(
                        f"SLO metric {q.metric!r} of service {s.name} is "
                        f"neither a parameter nor a regression target")
                svc.append(i)
                weight.append(q.weight)
                target.append(q.target)
        self._slo_kind = np.asarray(kinds, np.int32)
        self._slo_service = np.asarray(svc, np.int32)
        self._slo_weight = np.asarray(weight, np.float32)
        self._slo_target = np.asarray(target, np.float32)
        self._slo_pidx = np.asarray(pidx, np.int32)
        self._slo_ridx = np.asarray(ridx, np.int32)
        dev = self.device

        def t(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        self.tables = ProblemTables(
            lower=t(self.lower), upper=t(self.upper),
            resource_mask=t(self.resource_mask),
            rel_gather=t(self._rel_gather), slo_kind=t(self._slo_kind),
            slo_service=t(self._slo_service),
            slo_weight=t(self._slo_weight), slo_target=t(self._slo_target),
            slo_pidx=t(self._slo_pidx), slo_ridx=t(self._slo_ridx))

    # -- model representation -------------------------------------------------
    def stack(self, models: Models) -> StackedModels:
        """Pad a seed-style ``{service: {target: model}}`` mapping into the
        stacked tensors, in this problem's global relation order."""
        if isinstance(models, StackedModels):
            return models
        return stack_models(
            [models[name][tgt] for _, name, tgt, _ in self.relations],
            [name for _, name, _, _ in self.relations])

    def models_dict(self, sm: StackedModels
                    ) -> Dict[str, Dict[str, PolynomialModel]]:
        """Unstack per-relation ``PolynomialModel`` views keyed like the seed."""
        out: Dict[str, Dict[str, PolynomialModel]] = {}
        for r, (_, name, target, _) in enumerate(self.relations):
            out.setdefault(name, {})[target] = sm.model(r)
        return out

    # -- objective ------------------------------------------------------------
    def objective(self, a, models: Models, rps):
        """Weighted total SLO fulfillment (higher is better) of decision
        vector a (D,) under the models and the per-service load rps (|S|,)."""
        return self.per_service_fulfillment(a, models, rps).sum()

    def per_service_fulfillment(self, a, models: Models, rps):
        """Per-service weighted phi totals (|S|,)."""
        return segments_from_tables(a, self.tables, self.stack(models), rps,
                                    len(self.specs))

    # -- projection onto {box} ∩ {sum of resources <= C} --------------------
    def project(self, a, capacity):
        """Exact projection (50 bisection steps) on ``a``'s device."""
        if a.device == self.device:
            lo, hi, mask = (self.tables.lower, self.tables.upper,
                            self.tables.resource_mask)
        else:
            lo, hi, mask = (b.to(a.device) for b in self._host_bounds)
        return project_capacity(a, lo, hi, mask, capacity, iters=50)

    # -- the solve ------------------------------------------------------------
    def solve_pgd(self, models: Models, rps, x0, capacity: float, *,
                  u: Optional[torch.Tensor] = None, n_starts: int = 6,
                  iters: int = 32, lr: float = 0.18, seed: int = 0
                  ) -> Tuple[np.ndarray, float]:
        """One PGD solve; ``u`` (n_starts - 3, D) defaults to uniform draws
        of a ``torch.Generator`` seeded with ``seed`` on the problem's
        device. Returns (assignment, score) on the host."""
        dev = self.device
        if u is None:
            gen = torch.Generator(dev).manual_seed(int(seed))
            u = torch.rand((max(n_starts - 3, 0), self.dim), generator=gen,
                           device=dev)
        a, score = pgd_solve(
            torch.as_tensor(np.asarray(x0, np.float32), device=dev),
            torch.as_tensor(u, dtype=torch.float32, device=dev),
            self.tables, self.stack(models),
            torch.as_tensor(np.asarray(rps, np.float32), device=dev),
            float(capacity), n_starts=n_starts, iters=iters, lr=lr,
            n_services=len(self.specs))
        out = torch.cat([a, score.reshape(1)]).cpu().numpy()
        return out[:-1], float(out[-1])

    # -- Eq. (3): RAND_PARAM — uniform draw within bounds + constraint -------
    def random_assignment(self, rng: np.random.Generator,
                          capacity: float) -> np.ndarray:
        """A uniform draw within the bounds (numpy ``rng``), projected onto
        the capacity on the CPU."""
        a = rng.uniform(self.lower, self.upper).astype(np.float32)
        return self.project(torch.from_numpy(a), float(capacity)).numpy()
