"""Load forecasting for proactive autoscaling (beyond-paper), on the
agent's device — the port of ``repro/core/forecast.py``.

RASK as published is purely reactive: each cycle solves against the rps it
just observed, so every burst in the paper's bursty trace (Fig. 7a — steep
<=30 s ramps) is paid for one full control interval late. This module adds
prediction, mapped onto the batched fit machinery of ``core/regression.py``:

* ``LoadForecaster`` — one ridge-over-lagged-windows AR(L) model per service,
  held as ONE degree-1 ``BatchedFitPlan`` relation per service so every
  service fits in one batched ridge solve. The agent queues the fit in the
  same decide as the structural fit and the solve (``rask._dispatch_fused``:
  ``stream_update_arrays``/``stream_fit_arrays``, or the batch
  ``fit_batched_arrays`` path), and ``predict_tracer`` blends its
  predictions into the load vector the solve sees, so the forecast adds no
  device-to-host copy: training pairs stream in through the same rank-k
  delta pushes as the structural relations (``TrainingTable.lagged_windows``
  cursors), and the gate inputs (lag windows, use mask, transfer priors)
  are uploaded without waiting.
* hybrid reactive/proactive gate — predictions are scored against the rps
  that actually arrived ``horizon`` cycles later; a service is solved
  against forecast load only while its rolling relative error stays under
  ``gate_tol`` (and after ``min_evals`` scored predictions). Everything
  else falls back to reactive rps, so a mis-trained forecaster can never
  do worse than the paper's behavior.
* transfer learning — fleet-mean AR weights per service TYPE (captured at
  churn time from the fitted stack) warm-start a newly arrived service's
  forecaster through the prior-mean ridge (``w_prior``/``prior_lam``),
  decaying as real pairs accumulate.
* ``gru_predict``/``fit_gru`` — a tiny GRU forecaster in plain PyTorch, the
  nonlinear upgrade path. Tested and available, but not wired into the
  decide (as in ``repro``). ``gru_params_from_numpy`` carries a parameter
  dict across from ``repro`` (or any numpy source).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .regression import BatchedFitPlan, StackedModels

__all__ = ["LoadForecaster", "gru_init", "gru_predict", "fit_gru",
           "gru_params_from_numpy"]


class LoadForecaster:
    """Per-service AR(``lags``) load forecaster riding the agent's decide.

    One degree-1 relation per service in its own ``BatchedFitPlan`` on
    ``device`` (the lag window is the feature vector, oldest value first);
    the agent queues ``plan.stream_update_arrays`` + ``plan.stream_fit_arrays``
    (or the batch fill path) in its decide and hands the fitted weights to
    ``predict_tracer``. The forecaster itself owns the HOST side:
    training-pair cursors into the ``TrainingTable``, the streaming device
    state, the hybrid gate's rolling-error bookkeeping, and the transfer
    priors.
    """

    def __init__(self, services: Sequence[str], types: Sequence[str],
                 scales: Sequence[float], lags: int, horizon: int,
                 row_capacity: int, ridge: float = 1e-6,
                 err_window: int = 8, gate_tol: float = 0.35,
                 min_evals: int = 3, column: str = "rps",
                 priors: Optional[Mapping[str, np.ndarray]] = None,
                 prior_strength: float = 1.0, min_prior_rows: int = 3,
                 device: Optional[torch.device] = None):
        self.services = list(services)
        self.types = list(types)
        self.lags = int(lags)
        self.horizon = max(int(horizon), 1)
        self.column = column
        self.err_window = int(err_window)
        self.gate_tol = float(gate_tol)
        self.min_evals = int(min_evals)
        self.priors = dict(priors) if priors else {}
        self.prior_strength = float(prior_strength)
        self.min_prior_rows = max(int(min_prior_rows), 1)
        self.plan = BatchedFitPlan(
            [dict(n_features=self.lags, degree=1,
                  x_scale=np.full(self.lags, max(float(s), 1.0), np.float32),
                  service=sid, target=column)
             for sid, s in zip(self.services, scales)],
            row_capacity=row_capacity, ridge=ridge, device=device)
        self.state = None                  # StreamState (streaming mode)
        self.last_w = None                 # device weights of the last fit
        self.cursors: List[int] = [0] * len(self.services)
        self.rows: List[int] = [0] * len(self.services)
        self.bind_key = None               # set by the agent (cache identity)
        # hybrid-gate state, keyed by service NAME so it survives plan
        # rebuilds (bucket growth) via ``inherit_gate``
        self._pending: Dict[int, Tuple[np.ndarray, Tuple[str, ...]]] = {}
        self._errs: Dict[str, collections.deque] = {}
        self._evals: Dict[str, int] = {}
        self._tail_ok = np.zeros(len(self.services), bool)
        self.last_used = 0                 # services gated proactive last mask
        self.last_err = 0.0                # worst rolling relative error

    def inherit_gate(self, other: "LoadForecaster") -> None:
        """Carry the gate's error history across a plan rebuild (row-bucket
        growth keeps the same services — their track record still stands)."""
        mine = set(self.services)
        self._errs = {s: d for s, d in other._errs.items() if s in mine}
        self._evals = {s: n for s, n in other._evals.items() if s in mine}
        self._pending = dict(other._pending)

    # -- training-pair export (host side) ----------------------------------
    def prep(self, table, streaming: bool = True):
        """This cycle's fit input: ``("delta", pairs)`` with only the pairs
        whose target row appeared since each cursor (streaming steady
        state), or ``("batch", pairs)`` with the full lagged windows (non-
        streaming mode, first fit, or a cursor invalidated by table
        compaction)."""
        if not streaming or self.state is None or self._lost_rows(table):
            return ("batch", self._full_pairs(table))
        deltas = []
        for i, sid in enumerate(self.services):
            X, Y, cur = table.lagged_windows(sid, self.column, self.lags,
                                             self.horizon,
                                             since=self.cursors[i])
            self.cursors[i] = cur
            self.rows[i] = min(self.rows[i] + len(Y),
                               self.plan.row_capacity)
            deltas.append((X, Y))
        return ("delta", deltas)

    def _lost_rows(self, table) -> bool:
        """True when compaction evicted rows a pending pair still needs."""
        need = self.horizon + self.lags - 1
        return any(self.cursors[i] - need < table.evicted(sid)
                   for i, sid in enumerate(self.services))

    def _full_pairs(self, table):
        pairs = []
        for i, sid in enumerate(self.services):
            X, Y, cur = table.lagged_windows(sid, self.column, self.lags,
                                             self.horizon)
            self.cursors[i] = cur
            self.rows[i] = min(len(Y), self.plan.row_capacity)
            pairs.append((X, Y))
        return pairs

    def delta_capacity(self, prep) -> int:
        """The delta-row bucket ``prep`` dispatches with (the forecast
        analogue of the agent's delta bucket; rebuild cycles run the
        steady-state push empty)."""
        kind, pairs = prep
        if kind == "batch":
            return self.plan.delta_capacity(0)
        return self.plan.delta_capacity(
            max((len(Y) for _, Y in pairs), default=1))

    # -- prediction inputs (host side) --------------------------------------
    def lag_matrix(self, table) -> np.ndarray:
        """Current lag window per service, (S, lags) float32 — the
        prediction input. Services without a full finite window are noted
        and masked off by ``use_mask``."""
        M = np.zeros((len(self.services), self.lags), np.float32)
        ok = np.zeros(len(self.services), bool)
        for i, sid in enumerate(self.services):
            M[i], ok[i] = table.lag_tail(sid, self.column, self.lags)
        self._tail_ok = ok
        return M

    def use_mask(self) -> np.ndarray:
        """The hybrid gate, (S,) float32: 1.0 where this service is solved
        against forecast load, 0.0 where it stays reactive. Proactive
        requires a full lag window, enough training pairs, ``min_evals``
        scored predictions, and a rolling relative error within
        ``gate_tol`` — one error spike and the service falls back until its
        rolling window recovers. Also refreshes ``last_used``/``last_err``
        (the ``DecisionInfo.forecast_used``/``forecast_err`` feed)."""
        m = np.zeros(len(self.services), np.float32)
        errs = []
        for i, sid in enumerate(self.services):
            dq = self._errs.get(sid)
            roll = float(np.mean(dq)) if dq else None
            if roll is not None:
                errs.append(roll)
            if (self._tail_ok[i] and self.rows[i] >= self.lags
                    and self._evals.get(sid, 0) >= self.min_evals
                    and roll is not None and roll <= self.gate_tol):
                m[i] = 1.0
        self.last_used = int(m.sum())
        self.last_err = max(errs, default=0.0)
        return m

    # -- gate bookkeeping ----------------------------------------------------
    def note(self, target_round: int, preds: np.ndarray) -> None:
        """Record a dispatched prediction for scoring when ``target_round``
        arrives. Keyed by round, so noting the same round twice overwrites
        rather than double-counts."""
        self._pending[int(target_round)] = (
            np.asarray(preds, np.float32), tuple(self.services))

    def settle(self, rounds: int, rps: np.ndarray) -> None:
        """Score the prediction that targeted THIS round against the rps
        actually observed (relative error, floor 1 rps); overdue targets
        (exploration gaps) are dropped — their observation is gone."""
        for r in [k for k in self._pending if k < rounds]:
            self._pending.pop(r)
        pend = self._pending.pop(int(rounds), None)
        if pend is None:
            return
        preds, sids = pend
        index = {s: i for i, s in enumerate(self.services)}
        for p, sid in zip(preds, sids):
            i = index.get(sid)
            if i is None:
                continue
            obs = float(rps[i])
            err = abs(float(p) - obs) / max(obs, 1.0)
            dq = self._errs.get(sid)
            if dq is None:
                dq = self._errs[sid] = collections.deque(
                    maxlen=self.err_window)
            dq.append(err)
            self._evals[sid] = self._evals.get(sid, 0) + 1

    def inject_error(self, err: float) -> None:
        """Push one synthetic error sample per service — test/chaos hook to
        force the gate closed (or open) without waiting ``err_window``
        real cycles."""
        for sid in self.services:
            dq = self._errs.get(sid)
            if dq is None:
                dq = self._errs[sid] = collections.deque(
                    maxlen=self.err_window)
            dq.extend([float(err)] * self.err_window)

    # -- transfer learning ---------------------------------------------------
    def prior_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(w_prior (S, T), prior_lam (S,)) for the prior-mean ridge: a
        service still short of ``min_prior_rows`` training pairs leans on
        its type's fleet-mean weights (fallback: the global mean under
        ``"*"``), with the pull decaying linearly as pairs accumulate —
        at ``min_prior_rows`` the solve is exactly the unprior'd system."""
        S, T = len(self.services), self.plan.t_max
        wp = np.zeros((S, T), np.float32)
        pl = np.zeros((S,), np.float32)
        if self.priors:
            for i, (sid, typ) in enumerate(zip(self.services, self.types)):
                w = self.priors.get(typ)
                if w is None:
                    w = self.priors.get("*")
                if w is None or w.shape[0] > T:
                    continue
                need = self.min_prior_rows - min(self.rows[i],
                                                 self.min_prior_rows)
                if need <= 0:
                    continue
                wp[i, :w.shape[0]] = w
                pl[i] = self.prior_strength * need / self.min_prior_rows
        return wp, pl

    def type_means(self) -> Dict[str, np.ndarray]:
        """Fleet-mean AR weights per service type (plus the global ``"*"``)
        from the last fitted stack — captured by the agent at churn time
        (ONE device-to-host copy, cold path only) to warm-start arriving
        services."""
        if self.last_w is None:
            return {}
        W = self.last_w.float().cpu().numpy()
        out: Dict[str, np.ndarray] = {}
        for typ in set(self.types):
            rows = [W[i] for i, t in enumerate(self.types) if t == typ]
            out[typ] = np.mean(np.stack(rows), axis=0)
        out["*"] = W.mean(axis=0)
        return out

    # -- prediction on the device --------------------------------------------
    def predict_tracer(self, fw: torch.Tensor, lagm: torch.Tensor,
                       use: torch.Tensor, rps: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """AR predictions from fitted weights ``fw`` (S, T) and lag windows
        ``lagm`` (S, L), then the hybrid blend, as tensor operations queued
        on the device (``repro``'s traced function of the same name). Where
        the gate trusts the forecaster (``use`` = 1) the solve sees
        max(pred, rps) — proactive never under-provisions against load
        already in hand; everywhere else the reactive rps passes through
        untouched. Returns (pred (S,), rps_eff (S,))."""
        plan = self.plan
        sm = StackedModels(fw, plan._E, plan._tmask, plan._scale,
                           plan.max_degree, ())
        pred = torch.clamp(sm.predict_all(lagm), min=0.0)
        rps_eff = use * torch.maximum(pred, rps) + (1.0 - use) * rps
        return pred, rps_eff


# --------------------------------------------------------------------------
# Tiny GRU forecaster (plain PyTorch) — the nonlinear upgrade path
# --------------------------------------------------------------------------

_GRU_KEYS = ("Wz", "Wr", "Wh", "bz", "br", "bh", "Wo", "bo")


def gru_init(generator: torch.Generator, n_hidden: int = 8,
             n_in: int = 1) -> dict:
    """GRU-cell + linear-head parameters (a plain dict of tensors on the
    generator's device), drawn from ``generator``."""
    dev = generator.device
    s = 1.0 / np.sqrt(n_hidden)
    shape = (n_in + n_hidden, n_hidden)

    def normal(*size):
        return torch.randn(size, generator=generator, device=dev) * s

    zeros = dict(dtype=torch.float32, device=dev)
    return dict(
        Wz=normal(*shape), Wr=normal(*shape), Wh=normal(*shape),
        bz=torch.zeros(n_hidden, **zeros), br=torch.zeros(n_hidden, **zeros),
        bh=torch.zeros(n_hidden, **zeros),
        Wo=normal(n_hidden), bo=torch.zeros((), **zeros))


def gru_params_from_numpy(params: Mapping[str, object],
                          device=None) -> dict:
    """A GRU parameter dict of arrays (``repro``'s ``gru_init``/``fit_gru``
    output, or numpy) as float32 tensors on ``device``."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=dev)
            for k in _GRU_KEYS}


def gru_predict(params: dict, window) -> torch.Tensor:
    """Run the GRU over lag window(s) ``window`` (..., L), oldest first, and
    read the head: the next-value prediction (...). A loop over the window
    (``repro`` scans); batched over any leading dims, differentiable."""
    p = params
    x_all = torch.as_tensor(window, dtype=torch.float32,
                            device=p["bz"].device)
    h = torch.zeros((*x_all.shape[:-1], p["bz"].shape[0]),
                    dtype=torch.float32, device=x_all.device)
    for t in range(x_all.shape[-1]):
        x = x_all[..., t:t + 1]
        xh = torch.cat([x, h], dim=-1)
        z = torch.sigmoid(xh @ p["Wz"] + p["bz"])
        r = torch.sigmoid(xh @ p["Wr"] + p["br"])
        hh = torch.tanh(torch.cat([x, r * h], dim=-1) @ p["Wh"] + p["bh"])
        h = (1.0 - z) * h + z * hh
    return h @ p["Wo"] + p["bo"]


def fit_gru(X, Y, n_hidden: int = 8, steps: int = 120, lr: float = 0.1,
            seed: int = 0, device=None) -> Tuple[dict, List[float]]:
    """Full-batch gradient fit of the GRU on (windows (N, L), targets (N,)).

    Plain SGD on the autograd gradient of the mean squared error, from
    ``gru_init`` with a generator seeded ``seed``. Returns (params,
    per-step losses)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    params = gru_init(torch.Generator(dev).manual_seed(int(seed)), n_hidden)
    X = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    Y = torch.as_tensor(np.asarray(Y, np.float32), device=dev)
    losses = []
    for _ in range(int(steps)):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = torch.mean((gru_predict(leaves, X) - Y) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            params = {k: v - lr * g
                      for (k, v), g in zip(leaves.items(), grads)}
        losses.append(float(loss))
    return params, losses
