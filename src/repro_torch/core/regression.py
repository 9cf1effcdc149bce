"""Polynomial regression of structural knowledge — paper Eq. (2), on the
card (the port of ``repro/core/regression.py``).

``w* (X, Y, delta) = argmin_w sum_i (y_i - w^T delta(x_i))^2``

Terms are all exponent tuples with total degree <= delta (bias first), the
powers are repeated products selected per (term, feature) by the exponent
tables (no ``pow``, no 0**0), and the ridge system is solved with
``torch.linalg.solve_ex(..., check_errors=False)``, an LU solve like
``jnp.linalg.solve`` that does not make the host wait on the card.

Stacked representation: ``StackedModels`` holds all |S|x|K| relations as
padded tensors — ``w`` (R, T_max) zero on padded terms, ``exponents``
(R, T_max, F_max) int32 zero on padding, ``term_mask`` (R, T_max), and
``x_scale`` (R, F_max) one on padded features. A padded feature has
exponent 0, so its value contributes a factor of exactly 1; a padded term
has ``term_mask`` 0, so the ridge pins its weight to 0.

Three fits, as in ``repro``: ``fit_polynomial`` for one relation (the
seed's loop, ``RaskConfig(fused=False)``, and ``select_degree``'s test-split
MSE, ``RaskConfig(auto_degree=True)``; these two solve in float64, see
``_fit64``), ``fit_batched_arrays`` over the full
padded design window, and the streaming engine of ``BatchedFitPlan``, which
keeps the window on the device as per-relation rings plus Gram accumulators
(``StreamState``) and per cycle uploads only the rows appended since the
last cycle. Every product here is an elementwise multiply and sum, so the
fit never runs on TF32, whatever ``torch.backends.cuda.matmul.allow_tf32``
says; the LU solve runs with TF32 switched off around it (an
ill-conditioned degree-6 system solved on TF32 would pick another degree).

``TRACE_COUNTS`` keeps ``repro``'s two runtime transfer counters:
``h2d_design_upload`` (every upload of a full padded design window) and
``h2d_delta_rows`` (telemetry rows pushed by the streaming path). The JAX
package's trace-time counters count compilations, which eager PyTorch does
not have, so they are left out.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import upload

TRACE_COUNTS: collections.Counter = collections.Counter()


def polynomial_exponents(n_features: int, degree: int) -> np.ndarray:
    """All exponent tuples with 0 <= sum(e) <= degree, bias term first.

    Shape (T, n_features); T = C(n_features + degree, degree).
    """
    terms = [e for e in itertools.product(range(degree + 1), repeat=n_features)
             if sum(e) <= degree]
    terms.sort(key=lambda e: (sum(e), tuple(-x for x in e)))
    return np.asarray(terms, np.int32)


def _expand_gather(x, exponents, max_degree: int):
    """delta(x) for an exponent table, batched over leading dims:
    x (..., N, F), exponents (..., T, F) -> (..., N, T).

    Powers x^0..x^max_degree are repeated products (the order of
    ``repro``'s cumulative product), gathered per (term, feature) and
    multiplied out over the features."""
    p = torch.ones_like(x)
    pows = [p]
    for _ in range(max_degree):
        p = p * x
        pows.append(p)
    pows = torch.stack(pows, dim=-2)                     # (..., N, d+1, F)
    *lead, n, d1, f = pows.shape
    t = exponents.shape[-2]
    idx = exponents.long()[..., None, :, None, :].expand(*lead, n, t, 1, f)
    vals = torch.gather(pows[..., None, :, :].expand(*lead, n, t, d1, f),
                        -2, idx)[..., 0, :]              # (..., N, T, F)
    return torch.prod(vals, dim=-1)


def _gram(phi):
    """phi (..., N, T) -> phi^T phi (..., T, T) as a multiply-and-sum (no
    TF32-capable matmul)."""
    return (phi[..., :, :, None] * phi[..., :, None, :]).sum(dim=-3)


def _xty(phi, y):
    """phi (..., N, T), y (..., N) -> phi^T y (..., T)."""
    return (phi * y[..., None]).sum(dim=-2)


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _ridge_solve(G, b, n_terms, ridge: float, w_prior, prior_lam,
                 term_mask):
    """Batched scale-aware ridge solve (``repro``'s ``_fit`` lambda:
    ridge * (1 + trace / active terms)) with the optional prior-mean term
    ``(G + (lam + pl) I) w = b + pl * w_prior``."""
    trace = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    lam = ridge * (1.0 + trace / n_terms)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    A = G + (lam + prior_lam)[:, None, None] * eye
    rhs = b + prior_lam[:, None] * (w_prior * term_mask)
    with _no_tf32():
        w = torch.linalg.solve_ex(A, rhs[..., None], check_errors=False)[0]
    return w[..., 0].contiguous()


@dataclasses.dataclass
class PolynomialModel:
    """A fitted w*(X, Y, delta) — one structural relation k in K."""

    w: torch.Tensor           # (T,)
    exponents: np.ndarray     # (T, F)
    x_scale: np.ndarray       # (F,) feature scaling for conditioning
    degree: int
    features: Tuple[str, ...] = ()
    target: str = ""

    def predict(self, x):
        """Estimate the target for raw (unscaled) feature vector(s) x (..., F);
        differentiable in a tensor ``x`` (the seed's loop objective takes
        its gradient through here)."""
        dev = self.w.device
        if torch.is_tensor(x):
            x = x.to(device=dev, dtype=torch.float32)
        else:
            x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        xs = x / torch.as_tensor(self.x_scale, device=dev)
        lead = xs.shape[:-1]
        phi = _expand_gather(xs.reshape(-1, xs.shape[-1]),
                             torch.as_tensor(self.exponents, device=dev),
                             self.degree)
        return (phi * self.w).sum(-1).reshape(lead)


def _fit64(Xs, Y, degree: int, ridge: float):
    """One relation's ridge system on ``Xs``'s device (``repro``'s ``_fit``,
    with its scale-aware lambda ridge * (1 + tr(A) / T)) in float64:
    Xs (N, F) float32 scaled features, Y (N,) -> w (T,) float64.

    ``repro`` solves this system in float32. From degree 3 up its Gram
    matrices are so ill-conditioned that float32 rounding sets the weights
    (and ``select_degree``'s test errors) to a few percent, so no other
    float32 sum order can reproduce them, and the card's would not match
    the CPU's. In float64 the card and the CPU agree, and the fit is at
    least as close to ``repro``'s as another float32 one."""
    exps = torch.from_numpy(polynomial_exponents(Xs.shape[1], degree)).to(
        Xs.device)
    phi = _expand_gather(Xs.double(), exps, degree)          # (N, T)
    A = _gram(phi)
    lam = ridge * (1.0 + torch.diagonal(A).sum() / A.shape[0])
    A = A + lam * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    with _no_tf32():
        w = torch.linalg.solve_ex(A, _xty(phi, Y.double())[:, None],
                                  check_errors=False)[0]
    return w[:, 0]


def _fit_scaled(X, Y, degree: int, x_scale, ridge: float, device):
    """(float64 weights, scale) of one relation on ``device`` (the CPU by
    default); ``x_scale`` defaults to the column max."""
    X = np.atleast_2d(np.asarray(X, np.float32))
    Y = np.asarray(Y, np.float32).reshape(-1)
    if x_scale is None:
        x_scale = np.maximum(np.abs(X).max(axis=0), 1e-9)
    x_scale = np.asarray(x_scale, np.float32)
    dev = torch.device("cpu") if device is None else torch.device(device)
    return _fit64(upload(X / x_scale, dev), upload(Y, dev), degree,
                  float(np.float32(ridge))), x_scale


def fit_polynomial(X, Y, degree: int, x_scale: Optional[Sequence[float]] = None,
                   ridge: float = 1e-6, features: Sequence[str] = (),
                   target: str = "", device=None) -> PolynomialModel:
    """Fit Eq. (2) for one relation on ``device`` (the CPU by default; the
    system is solved in float64, the weights kept in float32). ``x_scale``
    (default: column max) conditions the expansion — raw features like
    data_quality in [100, 1000] raised to delta=6 would otherwise overflow
    float32."""
    w, x_scale = _fit_scaled(X, Y, degree, x_scale, ridge, device)
    n = x_scale.shape[0]
    return PolynomialModel(w.float(), polynomial_exponents(n, degree),
                           x_scale, degree, tuple(features), target)


def mse(model: PolynomialModel, X, Y) -> float:
    pred = model.predict(X)
    y = torch.as_tensor(np.asarray(Y, np.float32), device=pred.device)
    return float(torch.mean((pred - y) ** 2))


def train_test_split(X, Y, test_frac: float = 0.2, seed: int = 0):
    """Deterministic 80/20 split used by E2 (Table IV)."""
    n = len(Y)
    idx = np.random.default_rng(seed).permutation(n)
    cut = max(1, int(round(n * test_frac)))
    te, tr = idx[:cut], idx[cut:]
    X = np.asarray(X)
    Y = np.asarray(Y)
    return X[tr], Y[tr], X[te], Y[te]


def select_degree(X, Y, degrees: Sequence[int] = (1, 2, 3, 4, 5, 6),
                  x_scale=None, seed: int = 0, device=None
                  ) -> Tuple[int, dict]:
    """E2 / §VI-C2: pick the service-specific degree by test-split MSE.
    The fits and their test errors run in float64 on ``device`` (the CPU
    by default; see ``_fit64``), and the errors come back to the host in
    one copy."""
    Xtr, Ytr, Xte, Yte = train_test_split(X, Y, seed=seed)
    dev = torch.device("cpu") if device is None else torch.device(device)
    errs_t = []
    for d in degrees:
        w, scale = _fit_scaled(Xtr, Ytr, d, x_scale, 1e-6, dev)
        xs = upload(np.atleast_2d(np.asarray(Xte, np.float32)) / scale, dev)
        exps = torch.from_numpy(polynomial_exponents(xs.shape[1], d)).to(dev)
        pred = (_expand_gather(xs.double(), exps, d) * w).sum(-1)
        y = upload(np.asarray(Yte, np.float32), dev).double()
        errs_t.append(torch.mean((pred - y) ** 2))
    errs = dict(zip(degrees, torch.stack(errs_t).cpu().tolist()))
    best = min(errs, key=errs.get)
    return best, errs


@dataclasses.dataclass
class StackedModels:
    """All R = |S|x|K| structural relations as padded tensors (see the
    module docstring for the padding invariants). ``labels`` keeps
    (service, target, features, degree, n_terms, n_features) per
    relation."""

    w: torch.Tensor            # (R, T_max)   zero on padded terms
    exponents: torch.Tensor    # (R, T_max, F_max) int32, zero on padding
    term_mask: torch.Tensor    # (R, T_max)   1.0 real / 0.0 padded
    x_scale: torch.Tensor      # (R, F_max)   1.0 on padded features
    max_degree: int
    labels: Tuple[Tuple[str, str, Tuple[str, ...], int, int, int], ...] = ()

    @property
    def n_relations(self) -> int:
        return self.w.shape[0]

    def predict_all(self, x):
        """One prediction per relation: x (R, F_max) raw features -> (R,)."""
        xs = x.float() / self.x_scale
        phi = _expand_gather(xs[:, None, :], self.exponents,
                             self.max_degree)[:, 0] * self.term_mask
        return torch.sum(phi * self.w, dim=-1)

    def model(self, r: int) -> PolynomialModel:
        """Per-relation ``PolynomialModel`` view (unpadded)."""
        _, target, features, degree, n_terms, n_feat = self.labels[r]
        return PolynomialModel(
            self.w[r, :n_terms],
            self.exponents[r, :n_terms, :n_feat].cpu().numpy(),
            self.x_scale[r, :n_feat].cpu().numpy(),
            degree, tuple(features), target)


def fit_batched_arrays(Xp, Yp, row_mask, exponents, term_mask, n_terms,
                       x_scale, ridge: float, max_degree: int,
                       w_prior=None, prior_lam=None):
    """Every relation's ridge system over its padded design window, batched:
    Xp (R, C, F_max), Yp and row_mask (R, C) -> w (R, T_max).

    ``w_prior`` (R, T_max) / ``prior_lam`` (R,) add the optional prior-mean
    ridge; ``prior_lam == 0`` solves the exact unprior'd system."""
    r_count, t_max = term_mask.shape
    if w_prior is None:
        w_prior = torch.zeros_like(term_mask)
    if prior_lam is None:
        prior_lam = torch.zeros((r_count,), dtype=term_mask.dtype,
                                device=term_mask.device)
    phi = _expand_gather(Xp / x_scale[:, None, :], exponents, max_degree)
    phi = phi * term_mask[:, None, :] * row_mask[..., None]    # (R, C, T)
    return _ridge_solve(_gram(phi), _xty(phi, Yp * row_mask),
                        n_terms.float(), ridge, w_prior, prior_lam,
                        term_mask)


class StreamState(NamedTuple):
    """Device-resident streaming-fit accumulators for one ``BatchedFitPlan``.

    The expanded design rows live in a per-relation ring of the newest
    ``row_capacity`` rows (the window of ``BatchedFitPlan.fill``), and the
    Gram system is kept up to date by rank-k pushes of only the new rows.
    The rings carry one scratch row past ``row_capacity``: masked delta rows
    are written there (``repro`` drops them as out-of-bounds scatters) and
    it is never read."""

    phi: torch.Tensor    # (R, C + 1, T_max) expanded rows (term-masked)
    y: torch.Tensor      # (R, C + 1)        targets, same ring order
    gram: torch.Tensor   # (R, T_max, T_max) running Phi^T Phi
    xty: torch.Tensor    # (R, T_max)        running Phi^T y
    count: torch.Tensor  # (R,) int32        rows ever pushed per relation


def pad_capacity(n: int, minimum: int = 64) -> int:
    """Fixed-capacity bucketing for padded design matrices: the next power of
    two >= n (>= ``minimum``)."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def stack_models(models: Sequence[PolynomialModel],
                 services: Sequence[str] = ()) -> StackedModels:
    """Pad already-fitted per-relation models into one ``StackedModels``."""
    if not models:
        raise ValueError("stack_models needs at least one model")
    r_count = len(models)
    t_max = max(m.w.shape[0] for m in models)
    f_max = max(m.exponents.shape[1] for m in models)
    dev = models[0].w.device
    w = torch.zeros((r_count, t_max), dtype=torch.float32, device=dev)
    E = np.zeros((r_count, t_max, f_max), np.int32)
    tmask = np.zeros((r_count, t_max), np.float32)
    scale = np.ones((r_count, f_max), np.float32)
    labels = []
    svc = list(services) if services else [""] * r_count
    for i, m in enumerate(models):
        t, f = m.exponents.shape
        w[i, :t] = m.w
        E[i, :t, :f] = m.exponents
        tmask[i, :t] = 1.0
        scale[i, :f] = m.x_scale
        labels.append((svc[i], m.target, tuple(m.features), m.degree, t, f))
    return StackedModels(w, torch.from_numpy(E).to(dev),
                         torch.from_numpy(tmask).to(dev),
                         torch.from_numpy(scale).to(dev),
                         max(m.degree for m in models), tuple(labels))


class BatchedFitPlan:
    """Precomputed padding tables for *repeated* batched fits, on one device.

    Everything but the data — exponent tables, term masks, feature scales,
    labels — is fixed given (degrees, features, row capacity): the plan
    builds those once on the device and reuses host buffers for the padded
    design matrices. ``relations``: one dict per relation with
    ``n_features``, ``degree``, ``x_scale`` and optional ``service`` /
    ``target`` / ``features`` labels.
    """

    def __init__(self, relations: Sequence[dict], row_capacity: int,
                 ridge: float = 1e-6, device: Optional[torch.device] = None):
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.row_capacity = row_capacity
        self.ridge = float(np.float32(ridge))
        r_count = len(relations)
        exps = [polynomial_exponents(int(r["n_features"]), int(r["degree"]))
                for r in relations]
        self.f_max = max(max(int(r["n_features"]), 1) for r in relations)
        self.t_max = max(e.shape[0] for e in exps)
        self.max_degree = max(int(r["degree"]) for r in relations)
        E = np.zeros((r_count, self.t_max, self.f_max), np.int32)
        tmask = np.zeros((r_count, self.t_max), np.float32)
        nterms = np.zeros((r_count,), np.float32)
        scale = np.ones((r_count, self.f_max), np.float32)
        labels = []
        for i, (rel, e) in enumerate(zip(relations, exps)):
            t, f = e.shape
            E[i, :t, :f] = e
            tmask[i, :t] = 1.0
            nterms[i] = t
            scale[i, :f] = np.asarray(rel["x_scale"], np.float32)
            labels.append((rel.get("service", ""), rel.get("target", ""),
                           tuple(rel.get("features", ())),
                           int(rel["degree"]), t, f))
        self.labels = tuple(labels)
        dev = self.device
        self._E = torch.from_numpy(E).to(dev)
        self._tmask = torch.from_numpy(tmask).to(dev)
        self._nterms = torch.from_numpy(nterms).to(dev)
        self._scale = torch.from_numpy(scale).to(dev)
        # reusable host-side padded buffers: views into ONE contiguous f32
        # block, so a batch fit uploads a single array
        self.n_relations = r_count
        self._buf = np.zeros(r_count * row_capacity * (self.f_max + 2),
                             np.float32)
        nx = r_count * row_capacity * self.f_max
        ny = r_count * row_capacity
        self._Xp = self._buf[:nx].reshape(r_count, row_capacity, self.f_max)
        self._Yp = self._buf[nx:nx + ny].reshape(r_count, row_capacity)
        self._rmask = self._buf[nx + ny:].reshape(r_count, row_capacity)

    def fill(self, data: Sequence[Tuple[np.ndarray, np.ndarray]]
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Overwrite the reusable padded host buffers with ``data`` (one
        (X (N_r, F_r), Y (N_r,)) pair per relation, in plan order; the
        newest ``row_capacity`` rows win) and return (Xp, Yp, row_mask)."""
        TRACE_COUNTS["h2d_design_upload"] += 1    # runtime transfer counter
        self._Xp[:] = 0.0
        self._Yp[:] = 0.0
        self._rmask[:] = 0.0
        for i, (X, Y) in enumerate(data):
            X = np.atleast_2d(np.asarray(X, np.float32))
            Y = np.asarray(Y, np.float32).reshape(-1)
            n = min(len(Y), self.row_capacity)
            self._Xp[i, :n, :X.shape[1]] = X[-n:]
            self._Yp[i, :n] = Y[-n:]
            self._rmask[i, :n] = 1.0
        return self._Xp, self._Yp, self._rmask

    def fill_packed(self, data: Sequence[Tuple[np.ndarray, np.ndarray]]
                    ) -> np.ndarray:
        """``fill`` returning the single flat backing buffer (upload once,
        ``unpack`` on the device)."""
        self.fill(data)
        return self._buf

    def unpack(self, buf):
        """Flat buffer -> (Xp, Yp, row_mask) views with this plan's shapes."""
        r, c, f = self.n_relations, self.row_capacity, self.f_max
        nx, ny = r * c * f, r * c
        return (buf[:nx].reshape(r, c, f), buf[nx:nx + ny].reshape(r, c),
                buf[nx + ny:].reshape(r, c))

    def fit_arrays(self, Xp, Yp, row_mask, w_prior=None, prior_lam=None):
        """``fit_batched_arrays`` with this plan's tables."""
        return fit_batched_arrays(Xp, Yp, row_mask, self._E, self._tmask,
                                  self._nterms, self._scale, self.ridge,
                                  self.max_degree, w_prior, prior_lam)

    def fit(self, data: Sequence[Tuple[np.ndarray, np.ndarray]]
            ) -> StackedModels:
        """One standalone batched fit over ``data`` (see ``fill``)."""
        buf = upload(self.fill_packed(data), self.device)
        return self.stacked(self.fit_arrays(*self.unpack(buf)))

    def stacked(self, w: torch.Tensor) -> StackedModels:
        """Wrap computed weights in this plan's tables."""
        return StackedModels(w, self._E, self._tmask, self._scale,
                             self.max_degree, self.labels)

    # -- streaming fit engine (device-resident Gram accumulators) -------------

    def stream_init(self) -> StreamState:
        """Fresh all-zero accumulators, made on the device (no upload)."""
        r, c, t = self.n_relations, self.row_capacity, self.t_max
        f32 = dict(dtype=torch.float32, device=self.device)
        return StreamState(
            phi=torch.zeros((r, c + 1, t), **f32),
            y=torch.zeros((r, c + 1), **f32),
            gram=torch.zeros((r, t, t), **f32),
            xty=torch.zeros((r, t), **f32),
            count=torch.zeros((r,), dtype=torch.int32, device=self.device))

    def delta_capacity(self, k: int) -> int:
        """Power-of-two bucket for a delta push of up to ``k`` rows (>= 1,
        <= row_capacity)."""
        return min(pad_capacity(max(int(k), 1), minimum=1), self.row_capacity)

    def fill_delta(self, deltas: Sequence[Tuple[np.ndarray, np.ndarray]],
                   k_cap: int) -> np.ndarray:
        """Pack only the NEW rows (one (X (k_r, F_r), Y (k_r,)) pair per
        relation, in plan order; newest ``k_cap`` win) into a fresh flat
        delta buffer — O(new rows) instead of O(window)."""
        r, f = self.n_relations, self.f_max
        nx, ny = r * k_cap * f, r * k_cap
        buf = np.zeros(nx + 2 * ny, np.float32)
        Xd = buf[:nx].reshape(r, k_cap, f)
        Yd = buf[nx:nx + ny].reshape(r, k_cap)
        dmask = buf[nx + ny:].reshape(r, k_cap)
        total = 0
        for i, (X, Y) in enumerate(deltas):
            X = np.atleast_2d(np.asarray(X, np.float32))
            Y = np.asarray(Y, np.float32).reshape(-1)
            n = min(len(Y), k_cap)
            if n:
                Xd[i, :n, :X.shape[1]] = X[-n:]
                Yd[i, :n] = Y[-n:]
                dmask[i, :n] = 1.0
            total += n
        TRACE_COUNTS["h2d_delta_rows"] += total   # runtime transfer counter
        return buf

    def unpack_delta(self, dbuf, k_cap: int):
        """Flat delta buffer -> (Xd, Yd, dmask) views."""
        r, f = self.n_relations, self.f_max
        nx, ny = r * k_cap * f, r * k_cap
        return (dbuf[:nx].reshape(r, k_cap, f),
                dbuf[nx:nx + ny].reshape(r, k_cap),
                dbuf[nx + ny:].reshape(r, k_cap))

    def stream_update_arrays(self, state: StreamState, Xd, Yd, dmask
                             ) -> StreamState:
        """Rank-k accumulator push, all relations at once.

        Per relation: expand the (masked) new rows, subtract the ring rows
        they overwrite from the Gram system (eviction: the window is the
        newest ``row_capacity`` rows, exactly ``fill``'s), add the new
        contributions, and write the rows into the ring — in place, where
        ``repro`` returns a new (donated) ring. Requires
        k_cap <= row_capacity (``delta_capacity`` ensures it)."""
        cap = self.row_capacity
        r, k = Yd.shape
        t = self.t_max
        phi_new = _expand_gather(Xd / self._scale[:, None, :], self._E,
                                 self.max_degree) * self._tmask[:, None, :]
        phi_new = phi_new * dmask[..., None]                 # (R, k, T)
        y_new = Yd * dmask
        pos = state.count[:, None] + torch.arange(
            k, dtype=torch.int32, device=Yd.device)          # (R, k)
        valid = dmask > 0
        slot = torch.where(valid, pos % cap, cap).long()     # cap: scratch row
        evict = (valid & (pos >= cap)).to(phi_new.dtype)
        take = slot.clamp(max=cap - 1)
        phi_old = torch.gather(state.phi, 1, take[..., None].expand(r, k, t)) \
            * evict[..., None]
        y_old = torch.gather(state.y, 1, take) * evict
        gram = state.gram + _gram(phi_new) - _gram(phi_old)
        xty = state.xty + _xty(phi_new, y_new) - _xty(phi_old, y_old)
        state.phi.scatter_(1, slot[..., None].expand(r, k, t), phi_new)
        state.y.scatter_(1, slot, y_new)
        count = state.count + dmask.sum(-1).to(torch.int32)
        return StreamState(state.phi, state.y, gram, xty, count)

    def stream_resync_arrays(self, state: StreamState) -> StreamState:
        """Recompute the Gram system exactly from the device ring (no
        upload): bounds the float32 drift of the incremental add/subtract."""
        cap = self.row_capacity
        valid = (torch.arange(cap, device=state.count.device)[None, :]
                 < state.count.clamp(max=cap)[:, None]).to(state.phi.dtype)
        pm = state.phi[:, :cap] * valid[..., None]
        return StreamState(state.phi, state.y, _gram(pm),
                           _xty(pm, state.y[:, :cap] * valid), state.count)

    def stream_fit_arrays(self, state: StreamState, w_prior=None,
                          prior_lam=None) -> torch.Tensor:
        """Ridge solve straight from the accumulators — the same scale-aware
        lambda as ``fit_batched_arrays`` (trace(G) IS trace(A))."""
        if w_prior is None:
            w_prior = torch.zeros_like(self._tmask)
        if prior_lam is None:
            prior_lam = torch.zeros_like(self._nterms)
        return _ridge_solve(state.gram, state.xty, self._nterms, self.ridge,
                            w_prior, prior_lam, self._tmask)

    def stream_push(self, state: StreamState,
                    deltas: Sequence[Tuple[np.ndarray, np.ndarray]]
                    ) -> StreamState:
        """Standalone rank-k push: pack ``deltas`` and update on the device."""
        k_cap = self.delta_capacity(max((len(np.atleast_1d(Y)) for _, Y
                                         in deltas), default=1))
        dbuf = upload(self.fill_delta(deltas, k_cap), self.device)
        return self.stream_update_arrays(state,
                                         *self.unpack_delta(dbuf, k_cap))

    def stream_rebuild(self, data: Sequence[Tuple[np.ndarray, np.ndarray]]
                       ) -> StreamState:
        """Fresh state holding the newest ``row_capacity`` rows of ``data``.
        This IS a full design-window upload and counts as one."""
        TRACE_COUNTS["h2d_design_upload"] += 1    # runtime transfer counter
        return self.stream_push(self.stream_init(), data)

    def stream_fit(self, state: StreamState) -> StackedModels:
        """Solve the accumulators into ``StackedModels`` (on the device)."""
        return self.stacked(self.stream_fit_arrays(state))
