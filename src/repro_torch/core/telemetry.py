"""In-process time-series DB — the Prometheus stand-in of paper §III-A/§IV-A
(the port's copy of ``repro/core/telemetry.py``, plain numpy).

Containers are scraped every second; the agent queries a *window* of the most
recent samples and aggregates (the paper averages the last 5 s of each 10 s
cycle, because scaling actions take up to ~5 s to settle). The DB also serves
as the regression training-data store D: ``TrainingTable`` flattens the
windowed aggregates of each past cycle into the tabular structure RASK fits
its polynomials on (Fig. 3 step 1).

Columnar layout (the telemetry leg of the fused cycle engine)
-------------------------------------------------------------
Both stores are *columnar*: one preallocated float64 array per metric with a
shared, monotonically increasing timestamp vector — no per-sample dicts.

* ``TimeSeriesDB`` keeps one ring buffer per service.  ``scrape`` writes one
  row at the tail (amortized O(1): capacity doubles up to 2x retention, then
  the newest ``retention`` rows are compacted to the front — timestamps stay
  contiguous and sorted).  Window queries binary-search the timestamp vector
  (``np.searchsorted``) and reduce a contiguous column slice with one
  vectorized ``nanmean`` — no Python-level row scans.
* Schema is fixed at first scrape per service; a metric appearing later adds
  a NaN-backfilled column, a metric missing from one scrape stores NaN
  (``nanmean`` ignores both).
* ``TrainingTable`` is append-only column arrays (capacity-doubling), so
  ``design_matrix`` — the feed of the batched regression's padded buffers
  (``core/regression.py::BatchedFitPlan``) — is a vectorized column
  gather + finite-row mask, not a per-row dict scan.

The window migration (``export_window``/``import_window``/``transfer``)
carries a service's telemetry with it when the fleet moves it. The
lagged-window export (``lagged_windows``/``lag_tail``) feeds the load
forecaster (``core/forecast.py``).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Sample:
    t: float
    metrics: Dict[str, float]


class _Ring:
    """Columnar ring buffer for one service: sorted timestamps + one column
    per metric, amortized O(1) append, O(log n) window lookup."""

    __slots__ = ("retention", "t", "vals", "cols", "colidx", "n")

    def __init__(self, retention: int, initial: int = 256):
        self.retention = retention
        cap = min(initial, 2 * retention)
        self.t = np.empty(cap, np.float64)
        self.vals = np.empty((cap, 0), np.float64)
        self.cols: List[str] = []
        self.colidx: Dict[str, int] = {}
        self.n = 0                       # next write position

    @property
    def count(self) -> int:
        return min(self.n, self.retention)

    @property
    def start(self) -> int:
        return self.n - self.count

    def _ensure_capacity(self) -> None:
        cap = self.t.shape[0]
        if self.n < cap:
            return
        if cap < 2 * self.retention:     # grow geometrically up to 2x retention
            new_cap = min(2 * cap, 2 * self.retention)
            self.t = np.concatenate([self.t, np.empty(new_cap - cap)])
            self.vals = np.concatenate(
                [self.vals, np.empty((new_cap - cap, self.vals.shape[1]))])
        else:                            # wrap: compact newest rows to front
            keep = self.retention
            self.t[:keep] = self.t[self.n - keep:self.n]
            self.vals[:keep] = self.vals[self.n - keep:self.n]
            self.n = keep

    def _ensure_column(self, key: str) -> int:
        idx = self.colidx.get(key)
        if idx is None:
            idx = len(self.cols)
            self.cols.append(key)
            self.colidx[key] = idx
            col = np.full((self.t.shape[0], 1), np.nan)
            self.vals = np.concatenate([self.vals, col], axis=1)
        return idx

    def append(self, t: float, metrics: Mapping[str, float]) -> None:
        self._ensure_capacity()
        row = np.full(len(self.cols), np.nan)
        extra = None
        for k, v in metrics.items():
            idx = self.colidx.get(k)
            if idx is None:              # schema grows: NaN-backfilled column
                idx = self._ensure_column(k)
                if extra is None:
                    extra = {}
                extra[idx] = float(v)
            elif idx < row.shape[0]:
                row[idx] = float(v)
        self.t[self.n] = t
        self.vals[self.n, :row.shape[0]] = row
        if extra:
            for idx, v in extra.items():
                self.vals[self.n, idx] = v
        self.n += 1

    def window_slice(self, since: float, until: Optional[float]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        lo = self.start + np.searchsorted(self.t[self.start:self.n], since,
                                          side="left")
        hi = self.n if until is None else self.start + np.searchsorted(
            self.t[self.start:self.n], until, side="right")
        return self.t[lo:hi], self.vals[lo:hi]

    def latest(self) -> Optional[Sample]:
        if self.count == 0:
            return None
        i = self.n - 1
        row = self.vals[i]
        return Sample(float(self.t[i]),
                      {k: float(row[j]) for j, k in enumerate(self.cols)
                       if np.isfinite(row[j])})


class TimeSeriesDB:
    """Append-only per-service metric store with windowed aggregation.

    Thread-safe: the scrape loop and the agent may run concurrently
    (MUDAP scrapes each container every 1 s; the agent reads every 10 s).
    """

    def __init__(self, retention: int = 100_000):
        self._series: Dict[str, _Ring] = {}
        self._retention = retention
        self._lock = threading.Lock()

    def scrape(self, service: str, t: float, metrics: Mapping[str, float]) -> None:
        self.scrape_many(t, {service: metrics})

    def scrape_many(self, t: float,
                    per_service: Mapping[str, Mapping[str, float]]) -> None:
        """Bulk scrape: one lock acquisition for all services (the platform
        scrapes every container each second — one call instead of |S|)."""
        with self._lock:
            for service, metrics in per_service.items():
                ring = self._series.get(service)
                if ring is None:
                    ring = self._series[service] = _Ring(self._retention)
                ring.append(float(t), metrics)

    def services(self) -> List[str]:
        with self._lock:
            return list(self._series)

    def latest(self, service: str) -> Optional[Sample]:
        with self._lock:
            ring = self._series.get(service)
            return ring.latest() if ring else None

    def window(self, service: str, since: float, until: Optional[float] = None
               ) -> List[Sample]:
        with self._lock:
            ring = self._series.get(service)
            if ring is None:
                return []
            ts, vals = ring.window_slice(since, until)
            cols = list(ring.cols)
            ts, vals = ts.copy(), vals.copy()
        return [Sample(float(t),
                       {k: float(v[j]) for j, k in enumerate(cols)
                        if np.isfinite(v[j])})
                for t, v in zip(ts, vals)]

    def window_mean(self, service: str, since: float,
                    until: Optional[float] = None) -> Dict[str, float]:
        """Average each metric over [since, until] — paper §IV-A: 'query a time
        series of the remaining 5s and consider the average'."""
        return self.window_means([service], since, until)[service]

    # -- migration support: move a service's window between DBs ----------------
    def export_window(self, service: str, since: float = 0.0,
                      until: Optional[float] = None
                      ) -> Tuple[np.ndarray, List[str], np.ndarray]:
        """Columnar copy of one service's samples in [since, until]:
        (timestamps (n,), column names, values (n, len(cols)) with NaN for
        metrics missing from a scrape).  The raw feed of ``transfer``."""
        with self._lock:
            ring = self._series.get(service)
            if ring is None:
                return np.zeros(0), [], np.zeros((0, 0))
            ts, vals = ring.window_slice(since, until)
            return ts.copy(), list(ring.cols), vals.copy()

    def import_window(self, service: str, ts: np.ndarray,
                      cols: Sequence[str], vals: np.ndarray) -> int:
        """Bulk-append exported rows for ``service`` (see ``export_window``).

        Rows merge with any samples already present, keeping the ring's
        timestamps sorted (a service migrating BACK to a host it once lived
        on appends after its old history).  Returns the rows imported."""
        ts = np.asarray(ts, np.float64)
        if ts.size == 0:
            return 0
        with self._lock:
            ring = self._series.get(service)
            if ring is None:
                ring = self._series[service] = _Ring(self._retention)
            rows = [(float(t), {k: float(v[j])
                                for j, k in enumerate(cols)
                                if np.isfinite(v[j])})
                    for t, v in zip(ts, vals)]
            if ring.count and ts[0] < ring.t[ring.n - 1]:
                # interleaved history: merge-sort the union and rebuild
                old_ts, old_vals = ring.window_slice(-np.inf, None)
                old_cols = list(ring.cols)
                rows += [(float(t), {k: float(v[j])
                                     for j, k in enumerate(old_cols)
                                     if np.isfinite(v[j])})
                         for t, v in zip(old_ts, old_vals)]
                rows.sort(key=lambda r: r[0])
                ring = self._series[service] = _Ring(self._retention)
            for t, metrics in rows:
                ring.append(t, metrics)
        return int(ts.size)

    def transfer(self, service: str, dst: "TimeSeriesDB",
                 since: float = 0.0, until: Optional[float] = None,
                 drop: bool = True) -> int:
        """Carry one service's telemetry window into another DB — the
        migration path: ``Fleet.migrate`` moves the ring-buffer history with
        the service so windowed queries (and the agent's stabilized-state
        observations) survive the move.  ``drop`` removes the source series
        in the SAME locked section as the export, so a concurrent scrape
        either lands before the export (and is carried) or after the drop
        (opening a fresh source series) — never silently between.  Locks
        are taken one DB at a time (source, then destination), so two
        concurrent opposite-direction transfers cannot deadlock.  Returns
        the rows moved."""
        with self._lock:
            ring = self._series.get(service)
            if ring is None:
                return 0
            ts, vals = ring.window_slice(since, until)
            ts, cols, vals = ts.copy(), list(ring.cols), vals.copy()
            if drop:
                self._series.pop(service, None)
        return dst.import_window(service, ts, cols, vals)

    def export_windows(self, services: Optional[Sequence[str]] = None,
                       since: float = 0.0, until: Optional[float] = None
                       ) -> Dict[str, Tuple[np.ndarray, List[str], np.ndarray]]:
        """Bulk ``export_window``: one lock acquisition for ALL services.

        Returns {service: (timestamps, column names, values)}: every
        service's new scrapes come out in one locked section instead of |S|
        round-trips.  Services with no samples in the window are
        omitted."""
        with self._lock:
            if services is None:
                services = list(self._series)
            out: Dict[str, Tuple[np.ndarray, List[str], np.ndarray]] = {}
            for s in services:
                ring = self._series.get(s)
                if ring is None:
                    continue
                ts, vals = ring.window_slice(since, until)
                if ts.shape[0] == 0:
                    continue
                out[s] = (ts.copy(), list(ring.cols), vals.copy())
            return out

    def window_means(self, services: Optional[Sequence[str]] = None,
                     since: float = 0.0, until: Optional[float] = None
                     ) -> Dict[str, Dict[str, float]]:
        """Bulk windowed aggregation: one lock acquisition, then one
        binary-searched column-slice ``nanmean`` per service.

        Services with no samples in the window map to ``{}``.
        """
        with self._lock:
            if services is None:
                services = list(self._series)
            slices = []
            for s in services:
                ring = self._series.get(s)
                if ring is None:
                    slices.append((s, None, ()))
                    continue
                ts, vals = ring.window_slice(since, until)
                slices.append((s, vals.copy(), list(ring.cols)))
        out: Dict[str, Dict[str, float]] = {}
        for s, vals, cols in slices:
            if vals is None or vals.shape[0] == 0:
                out[s] = {}
                continue
            present = np.isfinite(vals)
            counts = present.sum(axis=0)
            with np.errstate(invalid="ignore"):
                sums = np.where(present, vals, 0.0).sum(axis=0)
            means = sums / np.maximum(counts, 1)
            out[s] = {k: float(means[j]) for j, k in enumerate(cols)
                      if counts[j] > 0}
        return out


class TrainingTable:
    """The tabular structure D of Fig. 3 — one row per (cycle, service).

    Each row holds the *stabilized* metric aggregate of one autoscaling cycle
    so the regression sees (features X, target Y) pairs at cycle granularity.
    Storage is append-only column arrays (capacity-doubling, missing fields
    are NaN), so extracting a design matrix is a vectorized column gather.

    ``retention`` bounds per-service host memory, mirroring ``_Ring``:
    capacity grows geometrically up to 2x retention, then the newest
    ``retention`` rows are compacted to the front — a thousand-service
    week-long run holds |S| x retention rows, not |S| x cycles.  Row
    identity survives compaction through *total* indices: ``appended``
    counts every row ever written, ``evicted`` how many compaction has
    dropped, and ``delta_matrix`` exports rows since a total-index cursor —
    the feed of the streaming fit engine's rank-k pushes.
    """

    def __init__(self, initial: int = 64, retention: Optional[int] = None):
        self._initial = initial
        self._retention = retention

        self._cols: Dict[str, Dict[str, np.ndarray]] = {}
        self._n: Dict[str, int] = {}
        self._base: Dict[str, int] = {}   # rows evicted by compaction

    @property
    def retention(self) -> Optional[int]:
        return self._retention

    def append(self, service: str, row: Mapping[str, float]) -> None:
        cols = self._cols.setdefault(service, {})
        n = self._n.get(service, 0)
        ret = self._retention
        cap = next(iter(cols.values())).shape[0] if cols else 0
        if n >= cap:                      # all columns share one capacity
            if ret is not None and cap >= 2 * ret:
                # wrap: compact the newest ``retention`` rows to the front,
                # re-NaN the tail (positions >= n must read as missing, or
                # a later row lacking a key would leak the stale value)
                for k in cols:
                    cols[k][:ret] = cols[k][n - ret:n]
                    cols[k][ret:] = np.nan
                self._base[service] = self._base.get(service, 0) + (n - ret)
                n = ret
            else:
                new_cap = max(2 * cap, self._initial)
                if ret is not None:
                    new_cap = min(new_cap, 2 * ret)
                for k in cols:
                    cols[k] = np.concatenate(
                        [cols[k], np.full(new_cap - cap, np.nan, np.float32)])
                cap = new_cap
        for k, v in row.items():
            if k not in cols:
                cols[k] = np.full(cap, np.nan, np.float32)
            cols[k][n] = float(v)
        self._n[service] = n + 1

    def _start(self, service: str) -> int:
        """Physical index of the first VISIBLE row: like ``_Ring``, the
        visible window is the newest ``retention`` rows even while the
        backing arrays still hold up to 2x that between compactions."""
        if self._retention is None:
            return 0
        return max(self._n.get(service, 0) - self._retention, 0)

    def rows(self, service: str) -> List[Dict[str, float]]:
        """Row-dict view (reconstructed; kept for seed-era consumers)."""
        cols = self._cols.get(service, {})
        n = self._n.get(service, 0)
        return [{k: float(arr[i]) for k, arr in cols.items()
                 if np.isfinite(arr[i])}
                for i in range(self._start(service), n)]

    def __len__(self) -> int:
        return sum(self.count(s) for s in self._n)

    def count(self, service: str) -> int:
        return self._n.get(service, 0) - self._start(service)

    # -- total-index cursor surface (streaming-fit delta export) -------------
    def appended(self, service: str) -> int:
        """Rows ever written for ``service`` (compaction-independent)."""
        return self._base.get(service, 0) + self._n.get(service, 0)

    def evicted(self, service: str) -> int:
        """Rows no longer visible (dropped by compaction or outside the
        retention window) — cursors below this point have lost rows, so
        delta consumers must rebuild instead of pushing."""
        return self._base.get(service, 0) + self._start(service)

    def columns(self, service: str, names: Sequence[str]) -> np.ndarray:
        """Stacked (count, len(names)) view of the named columns over the
        visible window (NaN where a row never recorded the field)."""
        n = self._n.get(service, 0)
        lo = self._start(service)
        cols = self._cols.get(service, {})
        out = np.full((n - lo, len(names)), np.nan, np.float32)
        for j, name in enumerate(names):
            arr = cols.get(name)
            if arr is not None:
                out[:, j] = arr[lo:n]
        return out

    def design_matrix(self, service: str, features: Sequence[str], target: str):
        """Extract (X, Y) for one structural relation k — Algo 1 line 7.

        Rows missing any feature or the target are dropped (vectorized
        finite-mask, no per-row dict scans)."""
        mat = self.columns(service, list(features) + [target])
        keep = np.isfinite(mat).all(axis=1)
        X = mat[keep, :-1]
        Y = mat[keep, -1]
        return np.ascontiguousarray(X), np.ascontiguousarray(Y)

    # -- lagged-window export (load forecasting, core/forecast.py) -------------
    def lagged_windows(self, service: str, column: str, lags: int,
                       horizon: int = 1, since: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Autoregressive training pairs over the visible window: X[i] holds
        ``lags`` consecutive values of ``column`` (oldest first) ending
        ``horizon`` rows before the target Y[i] — the feed of the per-service
        load forecaster's ridge fit.  With ``since`` (a TOTAL row index, see
        ``appended``) only pairs whose target row is at total index >= since
        come back — the cursor-driven delta export (one new pair per cycle
        at steady state).  Pairs touching a non-finite value are dropped.
        Returns (X (k, lags), Y (k,), new_cursor); pass new_cursor back as
        the next call's ``since``.  A cursor whose next pair would need lag
        rows older than ``evicted`` has lost history to compaction — the
        consumer must rebuild with since=None instead (mirror of
        ``delta_matrix``'s contract)."""
        base = self._base.get(service, 0)
        n = self._n.get(service, 0)
        lo = self._start(service)
        cursor = base + n
        L, h = int(lags), max(int(horizon), 1)
        col = self.columns(service, [column])[:, 0]      # visible rows (m,)
        m = col.shape[0]
        j0 = L + h - 1                     # first formable target (window-rel.)
        if since is not None:
            j0 = max(j0, int(since) - (base + lo))
        if L <= 0 or m - j0 <= 0:
            return (np.zeros((0, max(L, 0)), np.float32),
                    np.zeros(0, np.float32), cursor)
        sw = np.lib.stride_tricks.sliding_window_view(col, L)  # (m-L+1, L)
        X = sw[j0 - h - L + 1: m - h - L + 1]
        Y = col[j0:]
        keep = np.isfinite(X).all(axis=1) & np.isfinite(Y)
        return (np.ascontiguousarray(X[keep], dtype=np.float32),
                np.ascontiguousarray(Y[keep], dtype=np.float32), cursor)

    def lag_tail(self, service: str, column: str, lags: int
                 ) -> Tuple[np.ndarray, bool]:
        """The newest ``lags`` values of ``column`` (oldest first) — the
        forecaster's prediction input.  Left-padded with zeros while fewer
        rows exist; the returned flag is True only when the window is full
        and every value finite (a partial window must not be trusted)."""
        col = self.columns(service, [column])[:, 0]
        L = int(lags)
        out = np.zeros(L, np.float32)
        tail = col[-L:] if col.shape[0] else col
        k = tail.shape[0]
        if k:
            out[L - k:] = np.where(np.isfinite(tail), tail, 0.0)
        return out, bool(k == L and np.isfinite(tail).all())

    def delta_matrix(self, service: str, features: Sequence[str], target: str,
                     since: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """Columnar delta export: the (X, Y) rows appended at total indices
        [since, appended), finite-filtered like ``design_matrix``.  Returns
        (X, Y, new_cursor) with new_cursor = ``appended(service)``; pass it
        back as the next call's ``since``.  A cursor below ``evicted`` has
        lost rows to compaction — check before calling and rebuild instead.
        """
        base = self._base.get(service, 0)
        n = self._n.get(service, 0)
        names = list(features) + [target]
        lo = min(max(since - base, 0), n)
        cols = self._cols.get(service, {})
        if n - lo <= 2:
            # scalar fast path: steady-state deltas are 0-1 rows, and the
            # column path below pays ~10us of array overhead per call —
            # material when the agent exports |S| deltas every cycle
            arrs = [cols.get(name) for name in names]
            rows, ys = [], []
            for r in range(lo, n):
                vals = [float(a[r]) if a is not None else math.nan
                        for a in arrs]
                if all(map(math.isfinite, vals)):
                    rows.append(vals[:-1])
                    ys.append(vals[-1])
            X = np.asarray(rows, np.float32).reshape(len(rows), len(names) - 1)
            return X, np.asarray(ys, np.float32), base + n
        mat = np.full((n - lo, len(names)), np.nan, np.float32)
        for j, name in enumerate(names):
            arr = cols.get(name)
            if arr is not None:
                mat[:, j] = arr[lo:n]
        keep = np.isfinite(mat).all(axis=1)
        return (np.ascontiguousarray(mat[keep, :-1]),
                np.ascontiguousarray(mat[keep, -1]), base + n)
