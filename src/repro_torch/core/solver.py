"""Numerical solver for RASK's SOLVE step — paper Eq. (4), on the card (the
port of ``repro/core/solver.py``).

    SOLVE := max_A  sum_i sum_j  phi(q_j, p_i ^ w_i(p_i))
             s.t.   sum_i p_i <= C_p          (global resource constraint)
                    p_min <= p <= p_max       (per-parameter bounds)

Two interchangeable backends, as in ``repro``: ``solve_pgd`` (the default,
below) and ``solve_slsqp``, the paper-faithful reference (scipy SLSQP [39],
§V-A) with exact gradients. On the fused objective one SLSQP evaluation is
one upload of the iterate, the forward kernel on it as one candidate
(K = 1), the backward kernel, the soft capacity penalty and ONE
device-to-host copy of [value | gradient] (``_vg_cat``). The seed's
per-service loop objective survives as ``objective_loop`` (plain PyTorch
over ``PolynomialModel.predict``, autograd for the gradient, two transfers
an evaluation): the parity reference and e7's pre-PR baseline, selected by
``SolverProblem(specs, fused=False)``.

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

``pgd_solve`` runs B independent problems at once over a leading row axis
(``repro`` vmaps it): x0 (B, D), u (B, n_starts - 3, D), every table with a
leading B, capacity (B,). Each ascent step is one launch of the backward
kernel for all B rows, and the finals' scores one launch of the forward.
One problem is the case B = 1 (unbatched arguments are accepted as such).
Four callers batch rows:

* ``SolverProblem.solve_many`` — B independent instances of one layout
  (one shared model set or a batch of them), each with its own load,
  warm start and capacity;
* ``FleetSolverProblem`` — a multi-host Fleet's per-host subproblems,
  grouped into power-of-two layout buckets (``bucket_key``), each bucket
  padded to its member maxima (``FleetBucket``) and solved with its
  per-host capacities as one batch, the solved vectors scattered back into
  the global plan;
* ``PlacementProblem`` — candidate (service subset, capacity) rows, which
  may OVERLAP in services, bucketed by the same machinery and scored as
  one batch per bucket (``RASKAgent.placement_scores``);
* their ``solve_sequential``/``scores_sequential`` oracles, which run each
  row alone (B = 1) on the same padded tables and uniforms.

``bucketed="auto"`` merges single-member buckets into a neighbouring
layout and, for fleets, collapses tiny mixed fleets to one shared layout;
the thresholds (``_AUTO_BUCKET_MIN_HOSTS``, ``_AUTO_PAD_FACTOR``) are
``repro``'s, tuned there for XLA-CPU's dispatch floor and kept so that the
port's layouts equal ``repro``'s. ``shard`` is ``repro``'s option too:
``shard_rows`` cuts a bucket's rows into contiguous chunks, one a device
(``device.shard_devices``: every card for ``"auto"``, N entries of the CPU
on the CPU), and each chunk's batched ``pgd_solve`` runs on its device,
that device current (``device.device_guard``), queued without waiting;
the results come back in row order on the problem's device, byte for byte
those of the unsharded solve (every row's arithmetic is its own).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, \
    Tuple, Union

import numpy as np
import scipy.optimize
import torch

from ..device import device_guard, shard_devices, upload
from ..kernels import ops as kernel_ops
from .regression import PolynomialModel, StackedModels, pad_capacity, \
    stack_models
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


def cached_fn(cache: Dict[tuple, object], key: tuple, build,
              size: int = 8):
    """Bounded keyed cache: get-or-build, evicting the oldest entry past
    ``size`` (``repro``'s one cache policy for built solver variants)."""
    fn = cache.get(key)
    if fn is None:
        fn = build()
        if len(cache) >= size:
            cache.pop(next(iter(cache)))
        cache[key] = fn
    return fn


def shard_rows(n_rows: int, devices: Sequence[torch.device]
               ) -> List[Tuple[torch.device, slice]]:
    """``repro``'s ``shard_rows`` as row chunks: B rows over n devices in
    contiguous chunks of ceil(B / n), the rows each device runs under
    ``repro``'s padded ``shard_map`` (whose padding re-runs real rows).
    Chunks left empty (B < n, or a short tail) are dropped: they launch
    nothing."""
    per = -(-n_rows // max(len(devices), 1))
    return [(dev, slice(i * per, min((i + 1) * per, n_rows)))
            for i, dev in enumerate(devices) if i * per < n_rows]


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


def _rows(tables: ProblemTables, sm: StackedModels):
    """One problem's tables and models as a batch of one row."""
    return (ProblemTables(*(t[None] for t in tables)),
            StackedModels(sm.w[None], sm.exponents[None], sm.term_mask[None],
                          sm.x_scale[None], sm.max_degree, sm.labels))


def pgd_solve(x0, u, tables: ProblemTables, sm: StackedModels, rps,
              capacity, *, n_starts: int, iters: int, lr: float,
              n_services: int):
    """Multi-start projected-gradient ascent for B problem rows at once;
    returns (assignments (B, D), scores (B,)) as tensors on x0's device.

    x0 (B, D), u (B, n_starts - 3, D), tables and models with a leading B,
    rps (B, S), capacity a float or a tensor (B,) of per-row budgets. With
    x0 (D,), u (n_starts - 3, D) and one problem's tables, it solves that
    problem as the case B = 1 and returns (D,) and ().

    The start set is structured — the warm start, the water-filled upper
    bounds, the box midpoint, then ``lower + u * (upper - lower)`` for the
    uniform draws ``u`` — and all starts of all rows ascend together as one
    (B, K, D) batch: each step one backward launch. Interior steps project
    with a shallow 6-step bisection, the step size follows a cosine decay
    from ``lr``, Adam moments scale the step per coordinate, and the finals
    are re-projected exactly against (1 - _CAP_MARGIN) C. Nothing here
    waits on the card.
    """
    if x0.dim() == 1:           # one problem: the row axis' case B = 1
        tables, sm = _rows(tables, sm)
        a, score = pgd_solve(
            x0[None], u[None], tables, sm, rps[None],
            capacity[None] if torch.is_tensor(capacity) else capacity,
            n_starts=n_starts, iters=iters, lr=lr, n_services=n_services)
        return a[0], score[0]
    B, dim = x0.shape
    lo, hi, mask = (tables.lower[:, None], tables.upper[:, None],
                    tables.resource_mask[:, None])          # (B, 1, D)
    span = hi - lo
    # one budget a row, broadcast over its starts
    cap = capacity[:, None] if torch.is_tensor(capacity) else capacity
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

    top_mid = project_capacity(torch.cat([hi, lo + 0.5 * span], dim=1), lo,
                               hi, mask, cap)
    structured = torch.cat([x0[:, None], top_mid], dim=1)[:, :n_starts]
    u = u.reshape(B, max(n_starts - 3, 0), dim)
    starts = torch.cat([structured, lo + u * span], dim=1)  # (B, K, D)
    ones = torch.ones((B, starts.shape[1], n_services), dtype=starts.dtype,
                      device=starts.device)

    a = project_capacity(starts, lo, hi, mask, cap, iters=6)
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
            lo, hi, mask, cap, iters=6)
    # the finals and the x0 fallback, projected exactly in one batch
    last = project_capacity(torch.cat([a, x0[:, None]], dim=1), lo, hi, mask,
                            cap * (1.0 - _CAP_MARGIN))
    finals, x0_proj = last[:, :-1].contiguous(), last[:, -1]
    scores = score_candidates(finals, tables, sm, rps, n_services)  # (B, K)
    # tie-break toward the warm start: the regression is only trustworthy
    # near sampled configurations, so among (near-)equal model optima prefer
    # the one closest to the validated operating point
    dist = torch.linalg.vector_norm(
        (finals - x0[:, None]) / torch.clamp_min(span, 1e-6), dim=-1)
    finite = torch.isfinite(scores)
    adj = torch.where(finite, scores - 5e-3 * dist, -math.inf)
    best = torch.argmax(adj, dim=-1, keepdim=True)              # (B, 1)
    a_best = torch.gather(finals, 1, best[..., None].expand(B, 1, dim))[:, 0]
    s_best = torch.gather(scores, 1, best)[:, 0]
    # degenerate models can NaN every start: fall back to x0
    ok = torch.isfinite(s_best) & torch.isfinite(a_best).all(-1)
    return (torch.where(ok[:, None], a_best, x0_proj),
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
    them on ``device``. ``fused=False`` makes ``objective`` (and with it
    ``solve_slsqp``) the seed's per-service loop.
    """

    def __init__(self, specs: Sequence[ServiceSpec], fused: bool = True,
                 device: Optional[torch.device] = None):
        self.specs = list(specs)
        self.fused = fused
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
        self._bounds = list(zip(self.lower.tolist(), self.upper.tolist()))
        # the cotangent of -objective for one candidate: the fused SLSQP
        # gradient is the backward kernel's VJP of it
        self._neg_ct = torch.full((1, len(self.specs)), -1.0,
                                  device=self.device)
        self.last_nfev = 0          # objective evaluations of the last SLSQP

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
        vector a (D,) under the models and the per-service load rps (|S|,);
        differentiable in ``a`` (the kernels' autograd function on the
        fused path, autograd through the loop otherwise)."""
        if not self.fused:
            return self.objective_loop(a, models, rps)
        return self.per_service_fulfillment(a, models, rps).sum()

    def per_service_fulfillment(self, a, models: Models, rps):
        """Per-service weighted phi totals (|S|,)."""
        return segments_from_tables(a, self.tables, self.stack(models), rps,
                                    len(self.specs))

    def objective_loop(self, a, models, rps):
        """The seed's per-service Python-loop objective (graph grows with
        |S|), plain PyTorch over ``PolynomialModel.predict`` on ``a``'s
        device — kept as the parity reference and e7's pre-PR baseline.
        ``torch.minimum`` takes the half-subgradient at a tie, as
        ``jnp.minimum`` does."""
        if isinstance(models, StackedModels):
            models = self.models_dict(models)
        one = torch.ones((), dtype=a.dtype, device=a.device)
        total = 0.0
        for i, s in enumerate(self.specs):
            p = a[self.offsets[i]:self.offsets[i] + s.n_params]
            preds = {}
            for target, feat_idx in s.relation_features:
                x = torch.stack([p[j] for j in feat_idx])
                preds[target] = models[s.name][target].predict(x)
            for q in s.slos:
                if q.metric in s.param_names:
                    value = p[s.param_names.index(q.metric)]
                    phi = torch.minimum(value / q.target, one)
                elif q.metric == COMPLETION:
                    # §V-B(a): solver uses tp_max for the completion SLO —
                    # completion_est = tp_max / RPS, phi capped at 1.
                    tp = preds[THROUGHPUT_MAX]
                    phi = torch.minimum(
                        tp / torch.clamp_min(rps[i] * q.target, 1e-9), one)
                elif q.metric in preds:
                    phi = torch.minimum(preds[q.metric] / q.target, one)
                else:
                    raise KeyError(
                        f"SLO metric {q.metric!r} of service {s.name} is "
                        f"neither a parameter nor a regression target")
                total = total + q.weight * phi
        return total

    def _neg_objective(self, a, models, rps, capacity):
        # soft-penalized constraint keeps SLSQP's line search informative even
        # when the iterate is pushed outside the feasible region by noise.
        mask = self.tables.resource_mask.to(a.device)
        res = torch.where(mask, a, 0.0).sum()
        penalty = 1e3 * torch.clamp_min(res - capacity, 0.0) ** 2
        return -self.objective(a, models, rps) + penalty

    def _vg_cat(self, a, models: Models, rps, capacity):
        """[value | gradient] of ``_neg_objective`` at a (D,) as ONE tensor
        on the problem's device (the fused path): the forward kernel scores
        ``a`` as one candidate (K = 1), the backward kernel gives the
        gradient of -objective from the cotangent -1 (no autograd graph),
        and the penalty 1e3 * max(res - C, 0)^2 and its gradient are added
        in tensor ops. Nothing here waits on the card."""
        sm, t = self.stack(models), self.tables
        A = a[None]
        args = (t.rel_gather, sm.w, sm.exponents, sm.term_mask, sm.x_scale,
                t.slo_kind, t.slo_service, t.slo_weight, t.slo_target,
                t.slo_pidx, t.slo_ridx, rps)
        kw = dict(n_services=len(self.specs), max_degree=sm.max_degree)
        seg = kernel_ops.rask_objective(A, *args, **kw)              # (1, S)
        grad = kernel_ops.rask_objective_vjp(A, self._neg_ct, *args,
                                             **kw)[0]                # (D,)
        maskf = t.resource_mask.to(a.dtype)
        excess = torch.clamp_min(torch.where(t.resource_mask, a, 0.0).sum()
                                 - capacity, 0.0)
        value = -seg.sum() + 1e3 * excess ** 2
        return torch.cat([value.reshape(1), grad + 2e3 * excess * maskf])

    # -- projection onto {box} ∩ {sum of resources <= C} --------------------
    def project(self, a, capacity):
        """Exact projection (50 bisection steps) on ``a``'s device."""
        if a.device == self.device:
            lo, hi, mask = (self.tables.lower, self.tables.upper,
                            self.tables.resource_mask)
        else:
            lo, hi, mask = (b.to(a.device) for b in self._host_bounds)
        return project_capacity(a, lo, hi, mask, capacity, iters=50)

    # -- backend 1: paper-faithful SLSQP reference ----------------------------
    def solve_slsqp(self, models: Models, rps, x0, capacity: float,
                    maxiter: int = 100) -> Tuple[np.ndarray, float]:
        """scipy SLSQP (ftol 1e-6) from ``x0`` within the bounds and the
        capacity constraint, on the soft-penalized objective; returns
        (assignment, score) on the host. Fused: each evaluation is one
        ``_vg_cat`` and ONE device-to-host copy, and the solution is
        projected on the host, where it already is. Loop
        (``fused=False``): the seed's evaluation (autograd through
        ``objective_loop``, value and gradient fetched apart: two
        transfers) and its eager 50-step projection epilogue on the
        problem's device. ``last_nfev`` keeps the evaluation count."""
        dev = self.device
        if self.fused:
            models = self.stack(models)   # one conversion, outside the loop
        rps_t = upload(np.asarray(rps, np.float32), dev)
        cap = float(np.float32(capacity))
        mask = self.resource_mask

        if self.fused:
            def f(a):
                out = self._vg_cat(upload(np.asarray(a, np.float32), dev),
                                   models, rps_t, cap)
                out = out.cpu().numpy().astype(np.float64)
                return out[0], out[1:]
        else:
            def f(a):   # seed path: two transfers per iteration
                x = torch.tensor(np.asarray(a, np.float32), device=dev,
                                 requires_grad=True)
                v = self._neg_objective(x, models, rps_t, cap)
                v.backward()
                return (v.detach().item(),
                        x.grad.cpu().numpy().astype(np.float64))

        res_jac = -mask.astype(np.float64)
        cons = [{"type": "ineq",
                 "fun": lambda a: capacity - float(np.sum(a[mask])),
                 "jac": lambda a: res_jac}]
        res = scipy.optimize.minimize(
            f, np.asarray(x0, np.float64), jac=True, method="SLSQP",
            bounds=self._bounds, constraints=cons,
            options={"maxiter": maxiter, "ftol": 1e-6})
        self.last_nfev = int(res.nfev)
        x = torch.from_numpy(np.asarray(res.x, np.float32))
        if self.fused:
            a = self.project(x, cap)
        else:
            a = self.project(x.to(dev), cap).cpu()
        return a.numpy(), -float(res.fun)

    # -- backend 2 (default): multi-start PGD ---------------------------------
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

    def solve_many(self, models: Models, rps, x0, capacities, *,
                   n_starts: int = 6, iters: int = 32, lr: float = 0.18,
                   seed: int = 0, u: Optional[torch.Tensor] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Solve B independent instances of this problem layout as ONE
        batched ``pgd_solve`` (B rows a launch) instead of a Python loop.

        rps (B, |S|), x0 (B, dim), capacities (B,) are per-problem;
        ``models`` is either one ``StackedModels`` shared by every instance
        or a stacked batch of them (leaves with a leading B). ``u`` (B,
        n_starts - 3, dim) defaults to draws of a generator seeded with
        ``seed``. Returns (assignments (B, dim), scores (B,)) on the
        host."""
        dev = self.device
        sm = self.stack(models)
        x0 = torch.as_tensor(np.asarray(x0, np.float32), device=dev)
        B = x0.shape[0]

        def rows(t):            # one contiguous copy a row
            return t[None].expand(B, *t.shape).contiguous()

        if sm.w.dim() == 2:
            sm = StackedModels(rows(sm.w), rows(sm.exponents),
                               rows(sm.term_mask), rows(sm.x_scale),
                               sm.max_degree, sm.labels)
        if u is None:
            gen = torch.Generator(dev).manual_seed(int(seed))
            u = torch.rand((B, max(n_starts - 3, 0), self.dim),
                           generator=gen, device=dev)
        a, scores = pgd_solve(
            x0, torch.as_tensor(u, dtype=torch.float32, device=dev),
            ProblemTables(*(rows(t) for t in self.tables)), sm,
            torch.as_tensor(np.asarray(rps, np.float32), device=dev),
            torch.as_tensor(np.asarray(capacities, np.float32), device=dev),
            n_starts=n_starts, iters=iters, lr=lr,
            n_services=len(self.specs))
        out = torch.cat([a.reshape(-1), scores]).cpu().numpy()
        return out[:B * self.dim].reshape(B, self.dim), out[B * self.dim:]

    # -- Eq. (3): RAND_PARAM — uniform draw within bounds + constraint -------
    def random_assignment(self, rng: np.random.Generator,
                          capacity: float) -> np.ndarray:
        """A uniform draw within the bounds (numpy ``rng``), projected onto
        the capacity on the CPU."""
        a = rng.uniform(self.lower, self.upper).astype(np.float32)
        return self.project(torch.from_numpy(a), float(capacity)).numpy()


# -- multi-host fleets: per-host solves bucketed by layout ---------------------

def layout_bucket(n: int, minimum: int = 1) -> int:
    """Power-of-two layout bucketing (``pad_capacity`` applied to host
    layouts): the bucket a host falls into is a pure function of its OWN
    service/relation counts — total (every count maps to a bucket) and
    stable (independent of what else is in the fleet)."""
    return pad_capacity(n, minimum=max(minimum, 1))


def bucket_key(n_services: int, n_relations: int) -> Tuple[int, int]:
    """Bucket identity of a host layout: power-of-two service and relation
    ceilings.  Hosts sharing a key share one padded layout (padded to the
    member maximum), so a fleet mixing 2-service cameras with 8-service
    gateways solves two small batches instead of padding every host to
    the fleet-wide maximum."""
    return layout_bucket(n_services), layout_bucket(n_relations)


# auto bucketing, with ``repro``'s thresholds (tuned there for XLA-CPU's
# dispatch floor; kept so that the port's layouts equal ``repro``'s): below
# about a dozen hosts a bucket, an extra bucket costs more than the padding
# it saves, unless the layouts are so unequal that the padding dominates
_AUTO_BUCKET_MIN_HOSTS = 12
_AUTO_PAD_FACTOR = 2.0


def _merge_singleton_groups(keys: List[tuple], groups: Dict[tuple, list]
                            ) -> Tuple[List[tuple], Dict[tuple, list]]:
    """Fold 1-member layout groups into the neighboring group with the next
    key up (or down, for the largest): ``FleetBucket`` pads to its member
    maxima anyway, and a lone host is cheaper padded into a neighbor's
    layout than solved as a batch of its own."""
    keys = list(keys)
    while len(keys) > 1:
        lone = next((key for key in keys if len(groups[key]) == 1), None)
        if lone is None:
            break
        i = keys.index(lone)
        into = keys[i + 1] if i + 1 < len(keys) else keys[i - 1]
        groups[into] = sorted(groups[into] + groups.pop(lone))
        keys.remove(lone)
    return keys, groups


def _layout_work(problem: "SolverProblem", rows: Sequence[Sequence[int]]
                 ) -> int:
    """Padded-solve work proxy for one shared layout: rows x (power-of-two
    service ceiling x relation ceiling)."""
    s = max(len(svcs) for svcs in rows)
    r = max(sum(len(problem.specs[i].relation_features) for i in svcs)
            for svcs in rows)
    return len(rows) * layout_bucket(s) * layout_bucket(r)


def _auto_single_layout(problem: "SolverProblem",
                        groups_rows: Sequence[Sequence[Sequence[int]]]
                        ) -> bool:
    """Static tiny-fleet threshold: collapse to the single shared layout
    when every bucket is small (< ``_AUTO_BUCKET_MIN_HOSTS`` rows) and the
    padding a shared layout wastes stays within ``_AUTO_PAD_FACTOR`` of the
    bucketed work.  Pure function of the layout counts — no timing."""
    if len(groups_rows) <= 1:
        return False
    if max(len(rows) for rows in groups_rows) >= _AUTO_BUCKET_MIN_HOSTS:
        return False
    all_rows = [svcs for rows in groups_rows for svcs in rows]
    single = _layout_work(problem, all_rows)
    split = sum(_layout_work(problem, rows) for rows in groups_rows)
    return single <= _AUTO_PAD_FACTOR * split


class FleetBucket:
    """One padded per-row layout shared by a group of like-sized subproblems.

    Holds the batched ``ProblemTables`` (leading axis = rows in the bucket,
    padded to the bucket's member maxima), the gather tables mapping the
    global problem into row-local slots, and the inverse maps used to
    scatter solved per-row vectors back into the global decision vector.
    The tables are built with numpy, as in ``repro``, and uploaded once to
    the problem's device; a second copy stays on the CPU for the
    exploration draw's projection.

    A row is *any* service subset with its own capacity: a host's residents
    (``FleetSolverProblem`` — rows partition the services) or a placement
    what-if candidate (``PlacementProblem`` — rows OVERLAP, the same service
    appears in several candidate subsets).  All local index maps are built
    per row, so overlap is safe; the scatter-back maps (``g_idx``/``loc_*``)
    are only meaningful for partitioned rows.

    Padding: parameters boxed to [0, 0] and out of the resource mask,
    relations with term_mask 0 (``rel_valid``), SLOs of weight 0 and target
    1, gathers of local slot 0 — each contributes exactly 0.
    """

    def __init__(self, problem: "SolverProblem", hosts: Sequence[str],
                 host_idx: Sequence[int], svc_of_host: Sequence[Sequence[int]],
                 capacities: Sequence[float],
                 devices: Optional[Sequence[torch.device]] = None):
        self.hosts: Tuple[str, ...] = tuple(hosts)
        self.host_idx = np.asarray(host_idx, np.int64)  # rows in fleet order
        B = len(self.hosts)
        self.capacities = np.asarray(capacities, np.float32)
        self.n_services_max = max(len(v) for v in svc_of_host)
        self.key = bucket_key(
            self.n_services_max,
            max(sum(len(problem.specs[i].relation_features) for i in svcs)
                for svcs in svc_of_host))

        # decision-vector layout: row-local slots <-> global indices
        dims = [sum(problem.specs[i].n_params for i in svcs)
                for svcs in svc_of_host]
        d_max = max(dims)
        self.dim = int(sum(dims))          # real (unpadded) params covered
        svc_sets = [set(svcs) for svcs in svc_of_host]
        # relation/SLO membership per row, in global order
        rel_rows = [[r for r, (i, *_rest) in enumerate(problem.relations)
                     if i in ss] for ss in svc_sets]
        slo_rows = [[q for q, i in enumerate(problem._slo_service)
                     if int(i) in ss] for ss in svc_sets]
        r_max = max(max((len(v) for v in rel_rows), default=1), 1)
        q_max = max(max((len(v) for v in slo_rows), default=1), 1)
        f_max = problem._rel_gather.shape[1]

        param_take = np.zeros((B, d_max), np.int64)
        lower = np.zeros((B, d_max), np.float32)
        upper = np.zeros((B, d_max), np.float32)   # padded slots pin to 0
        mask = np.zeros((B, d_max), bool)
        g_idx = np.zeros(self.dim, np.int64)       # global param indices
        loc_b = np.zeros(self.dim, np.int64)       # -> bucket row
        loc_d = np.zeros(self.dim, np.int64)       # -> local slot
        rel_take = np.zeros((B, r_max), np.int64)
        rel_valid = np.zeros((B, r_max), np.float32)
        rel_gather = np.zeros((B, r_max, f_max), np.int32)
        kind = np.zeros((B, q_max), np.int32)
        svc = np.zeros((B, q_max), np.int32)
        weight = np.zeros((B, q_max), np.float32)
        target = np.ones((B, q_max), np.float32)   # pad 1.0: no divide-by-0
        pidx = np.zeros((B, q_max), np.int32)
        ridx = np.zeros((B, q_max), np.int32)
        svc_take = np.zeros((B, self.n_services_max), np.int64)

        k = 0
        for b, svcs in enumerate(svc_of_host):
            svc_local: Dict[int, int] = {}    # per-row: rows may overlap
            g2slot: Dict[int, int] = {}
            d = 0
            for si, i in enumerate(svcs):
                svc_local[i] = si
                svc_take[b, si] = i
                for j in range(problem.specs[i].n_params):
                    g = problem.offsets[i] + j
                    param_take[b, d] = g
                    lower[b, d] = problem.lower[g]
                    upper[b, d] = problem.upper[g]
                    mask[b, d] = problem.resource_mask[g]
                    g_idx[k], loc_b[k], loc_d[k] = g, b, d
                    g2slot[g] = d
                    k += 1
                    d += 1
            rel_local: Dict[int, int] = {}
            for rl, r in enumerate(rel_rows[b]):
                rel_take[b, rl] = r
                rel_valid[b, rl] = 1.0
                rel_local[r] = rl
                # padded feature slots in the global gather re-read global
                # index 0 (their exponent is 0 -> factor 1), which may not
                # belong to this row: local slot 0 is equally harmless
                rel_gather[b, rl] = [g2slot.get(int(g), 0)
                                     for g in problem._rel_gather[r]]
            for ql, q in enumerate(slo_rows[b]):
                kind[b, ql] = problem._slo_kind[q]
                svc[b, ql] = svc_local[int(problem._slo_service[q])]
                weight[b, ql] = problem._slo_weight[q]
                target[b, ql] = problem._slo_target[q]
                # pidx/ridx are only read for their kind; foreign indices
                # (kind-0 slots of kind-1/2 SLOs and vice versa) pin to 0
                pidx[b, ql] = g2slot.get(int(problem._slo_pidx[q]), 0)
                ridx[b, ql] = rel_local.get(int(problem._slo_ridx[q]), 0)

        self.arrays = dict(
            lower=lower, upper=upper, resource_mask=mask,
            rel_gather=rel_gather, slo_kind=kind, slo_service=svc,
            slo_weight=weight, slo_target=target, slo_pidx=pidx,
            slo_ridx=ridx, param_take=param_take, rel_take=rel_take,
            rel_valid=rel_valid, svc_take=svc_take, loc_b=loc_b,
            loc_d=loc_d)
        self.g_idx = g_idx
        dev = problem.device

        def on(x, where):
            return torch.from_numpy(np.ascontiguousarray(x)).to(where)

        self.tables = ProblemTables(*(on(self.arrays[name], dev)
                                      for name in ProblemTables._fields))
        self.param_take = on(param_take, dev)
        self.rel_take = on(rel_take, dev)
        self.rel_valid = on(rel_valid, dev)
        self.svc_take = on(svc_take, dev)
        self.loc_b = on(loc_b, dev)
        self.loc_d = on(loc_d, dev)
        self.caps = on(self.capacities, dev)
        # the row chunks (``shard_rows``): each chunk's tables and budgets
        # on its device, once for the layout
        self.shards = [
            (where, rows, ProblemTables(*(
                t[rows].to(where) for t in self.tables)),
             self.caps[rows].to(where))
            for where, rows in shard_rows(B, devices or [dev])]
        # the exploration draw is projected on the CPU (the plan goes
        # straight back to the host): what that needs, on the CPU
        cpu = torch.device("cpu")
        self._host = tuple(on(x, cpu) for x in (
            param_take, lower, upper, mask, self.capacities, loc_b, loc_d))

    # -- device-side building blocks ------------------------------------------
    def gather_models(self, sm: StackedModels) -> StackedModels:
        """Per-row batched view (leaves (B, R_max, ...)) of the global
        stacked models — device gathers, no host sync; padded relation rows
        are masked out entirely."""
        take = self.rel_take
        return StackedModels(
            sm.w[take], sm.exponents[take],
            sm.term_mask[take] * self.rel_valid[:, :, None],
            sm.x_scale[take], sm.max_degree, ())

    def split(self, a):
        """Global decision vector (dim,) -> this bucket's padded (B, D_max)."""
        return torch.clamp(a[self.param_take], self.tables.lower,
                           self.tables.upper)

    def gather_back(self, A):
        """Padded per-row solutions (B, D_max) -> the bucket's real params
        (dim_bucket,), ordered by ascending global index ``g_idx``."""
        return A[self.loc_b, self.loc_d]

    def project_host(self, a):
        """Exact projection of a global decision vector (dim,) on the CPU
        onto each row's budget (less ``_CAP_MARGIN``); the bucket's real
        params come back as ``gather_back`` orders them."""
        take, lo, hi, mask, caps, loc_b, loc_d = self._host
        proj = project_capacity(torch.clamp(a[take], lo, hi), lo, hi, mask,
                                caps * (1.0 - _CAP_MARGIN))
        return proj[loc_b, loc_d]

    def uniforms(self, gen: torch.Generator, n_starts: int) -> torch.Tensor:
        """The random starts' draws of every row, (B, n_starts - 3, D_max),
        from ``gen`` on its device."""
        return torch.rand((len(self.hosts), max(n_starts - 3, 0),
                           self.arrays["lower"].shape[1]), generator=gen,
                          device=gen.device)

    def solve(self, x0g, u, sm: StackedModels, rps, *, n_starts: int,
              iters: int, lr: float):
        """Every row of the bucket from the global warm start ``x0g``, the
        global models and load: one batch a row chunk, each on its device
        (its warm starts, models, load and uniforms sent there once a
        call, without waiting), gathered back in row order on ``x0g``'s
        device: (A (B, D_max), scores (B,))."""
        x0, smb, load = self.split(x0g), self.gather_models(sm), \
            rps[self.svc_take]
        parts = []
        for where, rows, tables, caps in self.shards:
            def on(t):
                return t[rows].to(where, non_blocking=True)
            with device_guard(where):   # kernels launch on the current card
                parts.append(pgd_solve(
                    on(x0), on(u), tables,
                    StackedModels(on(smb.w), on(smb.exponents),
                                  on(smb.term_mask), on(smb.x_scale),
                                  smb.max_degree, ()),
                    on(load), caps, n_starts=n_starts, iters=iters, lr=lr,
                    n_services=self.n_services_max))
        home = x0g.device
        if len(parts) == 1 and parts[0][0].device == home:
            return parts[0]
        # a copy to the host is read at once, so only a card's is queued
        wait = home.type != "cuda"
        return tuple(torch.cat([p[i].to(home, non_blocking=not wait)
                                for p in parts]) for i in range(2))

    def solve_row(self, j: int, x0g, u, sm: StackedModels, rps, *,
                  n_starts: int, iters: int, lr: float):
        """Row ``j`` alone (B = 1) on the same padded tables: the per-row
        parity oracle and baseline of ``solve``."""
        row = ProblemTables(*(t[j] for t in self.tables))
        smb = self.gather_models(sm)
        smj = StackedModels(smb.w[j], smb.exponents[j], smb.term_mask[j],
                            smb.x_scale[j], smb.max_degree, ())
        return pgd_solve(self.split(x0g)[j], u[j], row, smj,
                         rps[self.svc_take[j]], self.caps[j],
                         n_starts=n_starts, iters=iters, lr=lr,
                         n_services=self.n_services_max)


class _BucketedRows:
    """What fleet solves and placement batches share: their layout
    buckets' random-start draws and the host entry points' inputs."""

    problem: "SolverProblem"
    buckets: List[FleetBucket]

    def uniforms(self, gen: torch.Generator, n_starts: int):
        """The random starts' draws of every bucket, in bucket order: one
        draw of (B, n_starts - 3, D_max) a bucket, rows in bucket order."""
        return [bk.uniforms(gen, n_starts) for bk in self.buckets]

    def _inputs(self, models, rps, x0, u, seed, n_starts):
        """(models, rps, x0, uniforms) on the problem's device; ``u``
        defaults to a generator seeded with ``seed`` there."""
        dev = self.problem.device
        if u is None:
            u = self.uniforms(torch.Generator(dev).manual_seed(int(seed)),
                              n_starts)
        return (self.problem.stack(models),
                torch.tensor(np.asarray(rps, np.float32), device=dev),
                torch.tensor(np.asarray(x0, np.float32), device=dev),
                [torch.as_tensor(x, dtype=torch.float32, device=dev)
                 for x in u])


class FleetSolverProblem(_BucketedRows):
    """Per-host capacity solve for a multi-device Fleet, bucketed by layout.

    The fleet objective is separable per service and the constraints are
    per host, so the problem decomposes exactly into independent per-host
    subproblems. Hosts are grouped into **layout buckets** (power-of-two
    service/relation ceilings, ``bucket_key``), each padded only to its
    member maxima; a solve runs one batched ``pgd_solve`` per bucket (per
    row chunk of a bucket with ``shard``) with that bucket's **per-host
    capacity vector** — one backward launch per chunk and ascent step, one
    forward launch per chunk — and scatters
    the solved vectors back into the global plan (a precomputed
    permutation, ``join``). ``bucketed=False`` pads every host to one
    shared layout (``repro``'s e6 baseline). Plans are per-host feasible by
    construction (no capacity clips in the receipt).
    """

    def __init__(self, problem: "SolverProblem", host_of: Mapping[str, str],
                 capacities: Mapping[str, float],
                 bucketed: Union[bool, str] = "auto",
                 shard: Union[bool, int, str, None] = "auto",
                 devices: Optional[Sequence[torch.device]] = None):
        """``host_of``: service name (spec.name) -> host name;
        ``capacities``: host name -> resource budget C_h;
        ``bucketed=True`` keeps one bucket per power-of-two layout key;
        ``bucketed=False`` forces the single-shared-layout path (every host
        padded to the fleet maximum); ``"auto"`` (default) buckets but
        merges single-member buckets into a neighboring layout and
        collapses tiny fleets (every bucket below
        ``_AUTO_BUCKET_MIN_HOSTS`` hosts, little padding to save) to the
        single shared layout.

        ``shard`` spreads each bucket's rows over devices (``shard_rows``;
        ``device.shard_devices`` resolves it on the problem's device):
        ``"auto"`` (default) every card, 1 on the CPU; results are
        byte-identical whatever the count. ``devices`` names them instead
        (several shards may sit on one device)."""
        self.problem = problem
        self.devices = list(devices or shard_devices(shard, problem.device))
        self.n_shards = len(self.devices)
        self.hosts: Tuple[str, ...] = tuple(sorted(
            {host_of[s.name] for s in problem.specs}))
        hidx = {h: b for b, h in enumerate(self.hosts)}
        self.capacities = np.asarray([capacities[h] for h in self.hosts],
                                     np.float32)

        svc_of_host: List[List[int]] = [[] for _ in self.hosts]
        for i, s in enumerate(problem.specs):
            svc_of_host[hidx[host_of[s.name]]].append(i)

        # bucket assignment: a pure function of each host's own layout
        # (auto merging regroups *buckets*, never this per-host key)
        self.bucket_of: Dict[str, Tuple[int, int]] = {
            h: bucket_key(len(svcs),
                          sum(len(problem.specs[i].relation_features)
                              for i in svcs))
            for h, svcs in zip(self.hosts, svc_of_host)}
        if bucketed is False:
            groups: Dict[Tuple[int, int], List[int]] = \
                {(0, 0): list(range(len(self.hosts)))}
            keys = [(0, 0)]
        else:
            groups = {}
            for b, h in enumerate(self.hosts):
                groups.setdefault(self.bucket_of[h], []).append(b)
            keys = sorted(groups)          # deterministic bucket order
            if bucketed == "auto":
                keys, groups = _merge_singleton_groups(keys, groups)
                if _auto_single_layout(problem, [
                        [svc_of_host[b] for b in groups[k]] for k in keys]):
                    groups = {(0, 0): list(range(len(self.hosts)))}
                    keys = [(0, 0)]
        self.buckets: List[FleetBucket] = [
            FleetBucket(problem, [self.hosts[b] for b in groups[k]],
                        groups[k], [svc_of_host[b] for b in groups[k]],
                        self.capacities[groups[k]], self.devices)
            for k in keys]

        # topology fingerprint: the shard count, the resolved bucket
        # structure and the per-host residents and capacities
        self.layout_key: tuple = (
            ("shards", self.n_shards),
            tuple(tuple(bk.hosts) for bk in self.buckets),
            tuple((h, tuple(svc_of_host[b]), float(self.capacities[b]))
                  for b, h in enumerate(self.hosts)))

        # scatter permutations: concat of per-bucket outputs -> global order
        join = np.argsort(np.concatenate([bk.g_idx for bk in self.buckets]),
                          kind="stable")
        self._join_perm = torch.from_numpy(join).to(problem.device)
        self._join_perm_host = torch.from_numpy(join)
        self._score_perm = torch.from_numpy(np.argsort(np.concatenate(
            [bk.host_idx for bk in self.buckets]), kind="stable")).to(
                problem.device)

    def join(self, parts):
        """Per-bucket real-param vectors (in ``buckets`` order) -> global
        decision vector (dim,) via the precomputed permutation."""
        return torch.cat(parts)[self._join_perm]

    # -- the fleet solve -------------------------------------------------------
    def solve_rows(self, x0g, u, sm: StackedModels, rps, *, n_starts: int,
                   iters: int, lr: float):
        """The fleet solve on the device, queued without waiting: one
        batched ``pgd_solve`` per bucket (``u``: the buckets' uniforms),
        packed scatter back. Returns the global assignment (dim,) and the
        per-host scores (B,) in fleet host order."""
        parts, scores = [], []
        for bk, ub in zip(self.buckets, u):
            A, sc = bk.solve(x0g, ub, sm, rps, n_starts=n_starts,
                             iters=iters, lr=lr)
            parts.append(bk.gather_back(A))
            scores.append(sc)
        return self.join(parts), torch.cat(scores)[self._score_perm]

    def solve_many(self, models: Models, rps, x0, *, n_starts: int = 6,
                   iters: int = 32, lr: float = 0.18, seed: int = 0,
                   u: Optional[Sequence] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Every host's services against its OWN capacity, one batched
        solve per layout bucket. ``rps`` (|S|,) and ``x0`` (dim,) are in
        the global problem's order; ``u`` the buckets' uniforms (default:
        drawn from a generator seeded with ``seed``). Returns (global
        assignment (dim,), per-host scores (B,) in ``hosts`` order) on the
        host."""
        sm, rps, x0, u = self._inputs(models, rps, x0, u, seed, n_starts)
        a, scores = self.solve_rows(x0, u, sm, rps, n_starts=n_starts,
                                    iters=iters, lr=lr)
        out = torch.cat([a, scores]).cpu().numpy()
        return out[:a.shape[0]], out[a.shape[0]:]

    def solve_sequential(self, models: Models, rps, x0, *,
                         n_starts: int = 6, iters: int = 32,
                         lr: float = 0.18, seed: int = 0,
                         u: Optional[Sequence] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """The per-host loop: each host's padded subproblem solved alone
        (B = 1) on the same tables and uniforms as ``solve_many`` — the
        parity oracle the batched path must match, and its baseline."""
        sm, rps, x0, u = self._inputs(models, rps, x0, u, seed, n_starts)
        parts, scores = [], []
        for bk, ub in zip(self.buckets, u):
            rows = [bk.solve_row(j, x0, ub, sm, rps, n_starts=n_starts,
                                 iters=iters, lr=lr)
                    for j in range(len(bk.hosts))]
            parts.append(bk.gather_back(torch.stack([a for a, _ in rows])))
            scores.append(torch.stack([s for _, s in rows]))
        a = self.join(parts)
        out = torch.cat([a, torch.cat(scores)[self._score_perm]])
        out = out.cpu().numpy()
        return out[:a.shape[0]], out[a.shape[0]:]

    # -- Eq. (3) under per-host constraints -----------------------------------
    def random_assignment(self, rng: np.random.Generator) -> np.ndarray:
        """Uniform draw within bounds (numpy ``rng``), projected onto each
        host's budget on the CPU."""
        a = torch.from_numpy(rng.uniform(self.problem.lower,
                                         self.problem.upper
                                         ).astype(np.float32))
        parts = [bk.project_host(a) for bk in self.buckets]
        return torch.cat(parts)[self._join_perm_host].numpy()


class PlacementProblem(_BucketedRows):
    """Candidate-batched placement scoring — every (service, host) what-if
    subset scored as one batch per layout bucket.

    ``RASKAgent.placement_scores`` needs, per host h, the best predicted
    fulfillment of h's residents with and without each candidate service
    under h's own budget — O(|S| x |H|) subset solves per snapshot. Every
    candidate (a subset of global spec indices plus a capacity) becomes one
    row of a ``FleetBucket``-padded batch (rows OVERLAP: the same service is
    scored on several hosts), and one batched ``pgd_solve`` per bucket
    scores them: per ascent step one backward launch a bucket, whatever the
    number of candidates. ``scores_sequential`` is the brute-force parity
    oracle: the same padded tables and uniforms, one solve per candidate.
    Empty subsets score 0.0 without a solve.
    """

    def __init__(self, problem: "SolverProblem",
                 subsets: Sequence[Sequence[int]],
                 capacities: Sequence[float],
                 bucketed: Union[bool, str] = "auto",
                 shard: Union[bool, int, str, None] = "auto",
                 devices: Optional[Sequence[torch.device]] = None):
        """``shard`` and ``devices`` as ``FleetSolverProblem``'s."""
        self.problem = problem
        self.devices = list(devices or shard_devices(shard, problem.device))
        self.n_shards = len(self.devices)
        self.subsets: List[Tuple[int, ...]] = [
            tuple(int(i) for i in s) for s in subsets]
        self.capacities = np.asarray(capacities, np.float32)
        self.n_candidates = len(self.subsets)
        rows = [k for k, s in enumerate(self.subsets) if s]
        if bucketed is False:
            groups: Dict[Tuple[int, int], List[int]] = \
                {(0, 0): rows} if rows else {}
            keys = list(groups)
        else:
            groups = {}
            for k in rows:
                s = self.subsets[k]
                key = bucket_key(len(s), sum(
                    len(problem.specs[i].relation_features) for i in s))
                groups.setdefault(key, []).append(k)
            keys = sorted(groups)
            if bucketed == "auto":
                keys, groups = _merge_singleton_groups(keys, groups)
        self.buckets: List[FleetBucket] = [
            FleetBucket(problem, [f"cand{k}" for k in groups[key]],
                        groups[key],
                        [list(self.subsets[k]) for k in groups[key]],
                        self.capacities[groups[key]], self.devices)
            for key in keys]
        self._order = np.concatenate(
            [bk.host_idx for bk in self.buckets]) if self.buckets \
            else np.zeros(0, np.int64)

    def score_rows(self, x0g, u, sm: StackedModels, rps, *, n_starts: int,
                   iters: int, lr: float):
        """Every candidate's best score on the device, queued without
        waiting: one batched solve per bucket, concatenated in bucket
        order (candidate order is ``_order``)."""
        parts = [bk.solve(x0g, ub, sm, rps, n_starts=n_starts, iters=iters,
                          lr=lr)[1] for bk, ub in zip(self.buckets, u)]
        return torch.cat(parts) if parts else \
            torch.zeros((0,), device=self.problem.device)

    def scores(self, models: Models, rps, x0, *, n_starts: int = 6,
               iters: int = 32, lr: float = 0.18, seed: int = 0,
               u: Optional[Sequence] = None) -> np.ndarray:
        """Best predicted weighted fulfillment of every candidate subset
        under its own capacity, in candidate order — one batched solve per
        bucket and ONE device-to-host copy."""
        out = np.zeros(self.n_candidates, np.float64)
        if not self.buckets:
            return out
        sm, rps, x0, u = self._inputs(models, rps, x0, u, seed, n_starts)
        sc = self.score_rows(x0, u, sm, rps, n_starts=n_starts, iters=iters,
                             lr=lr)
        out[self._order] = sc.cpu().numpy()
        return out

    def scores_sequential(self, models: Models, rps, x0, *,
                          n_starts: int = 6, iters: int = 32,
                          lr: float = 0.18, seed: int = 0,
                          u: Optional[Sequence] = None) -> np.ndarray:
        """The brute-force oracle: one solve per candidate (B = 1) on the
        same padded tables and uniforms as ``scores``."""
        out = np.zeros(self.n_candidates, np.float64)
        if not self.buckets:
            return out
        sm, rps, x0, u = self._inputs(models, rps, x0, u, seed, n_starts)
        sc = torch.cat([torch.stack([
            bk.solve_row(j, x0, ub, sm, rps, n_starts=n_starts, iters=iters,
                         lr=lr)[1] for j in range(len(bk.hosts))])
            for bk, ub in zip(self.buckets, u)])
        out[self._order] = sc.cpu().numpy()
        return out
