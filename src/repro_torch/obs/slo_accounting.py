"""Rolling SLI accounting and multiwindow multiburn error-budget alerts.

The repo's benchmarks reduce SLO health to the instantaneous Eq. (8)
fulfillment scalar; production SLO practice (Google SRE Workbook ch. 5)
instead tracks a *service level indicator* per scrape, an *error budget*
(the tolerated fraction of bad scrapes under an objective like 99.9%
availability), and alerts on the *burn rate* — how many times faster than
the sustainable rate the budget is being consumed — over TWO windows at
once: a long window so one bad scrape cannot page, a short window so a
recovered incident clears the page quickly.

This module implements that accounting over the repo's own telemetry:

* SLI extraction — per service, per scrape, a boolean "good" flag computed
  columnar-style from the ``TimeSeriesDB`` ring windows (one vectorized
  pass over the new rows of ALL services per update, no per-sample Python
  loops).  Two SLI kinds:
    - ``availability`` (default): the scrape's weighted SLO fulfillment
      (Eq. 1/Eq. 8 per-service term) >= ``good_threshold``;
    - ``latency``: a named metric <= a target (classic latency-SLI shape;
      the simulator's ``queue`` backlog is the natural column).
* Rolling windows — per service a compacted (t, bad) ring with a prefix
  sum of bad counts, so every window query is two ``searchsorted`` calls
  and two subtractions; all of a policy's windows are answered from ONE
  cumulative pass (``error_rates``).
* Multiwindow multiburn alerts — ``BurnPolicy(name, long_s, short_s,
  threshold)``: the alert for a policy fires iff BOTH its long- and
  short-window burn rates exceed the threshold (the SRE Workbook's
  "multiwindow, multi-burn-rate" recipe; defaults 1h/5m at 14.4x and
  6h/30m at 6x, scalable to the simulated clock via ``SLOBudget.scaled``).

Everything here is plain numpy on the host: the accounting launches
nothing on the card and adds no work to the decide.

``core.slo.windowed_violation_rate`` delegates to ``error_rate`` below, so
benchmarks and the control plane report rolling violation numbers from one
code path.

The port's copy of ``repro/obs/slo_accounting.py``, line for line.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.slo import SLO


def error_rate(ts, bad, window: float, until: Optional[float] = None) -> float:
    """Fraction of samples flagged bad in the half-open window
    ``(until - window, until]`` (0.0 when the window holds no samples).

    ``ts`` must be sorted ascending.  This is THE rolling-rate primitive:
    burn rates, rolling SLIs and ``core.slo.windowed_violation_rate`` are
    all thin wrappers over it, so every consumer reports the same number.
    """
    ts = np.asarray(ts, np.float64)
    bad = np.asarray(bad)
    if ts.size == 0:
        return 0.0
    t1 = float(ts[-1]) if until is None else float(until)
    lo = int(np.searchsorted(ts, t1 - float(window), side="right"))
    hi = int(np.searchsorted(ts, t1, side="right"))
    n = hi - lo
    if n <= 0:
        return 0.0
    return float(np.count_nonzero(bad[lo:hi])) / n


def error_rates(ts, bad, windows: Sequence[float],
                until: Optional[float] = None) -> np.ndarray:
    """``error_rate`` for many windows in one vectorized pass: one prefix
    sum over the bad flags, one batched ``searchsorted`` for all edges."""
    ts = np.asarray(ts, np.float64)
    bad = np.asarray(bad, np.float64)
    w = np.asarray(list(windows), np.float64)
    if ts.size == 0 or w.size == 0:
        return np.zeros(w.size)
    t1 = float(ts[-1]) if until is None else float(until)
    cum = np.concatenate([[0.0], np.cumsum(bad != 0)])
    hi = int(np.searchsorted(ts, t1, side="right"))
    lo = np.searchsorted(ts, t1 - w, side="right")
    n = np.maximum(hi - lo, 0)
    counts = cum[hi] - cum[np.minimum(lo, hi)]
    with np.errstate(invalid="ignore"):
        out = np.where(n > 0, counts / np.maximum(n, 1), 0.0)
    return out


@dataclasses.dataclass(frozen=True)
class BurnPolicy:
    """One multiwindow burn-rate alert: fires iff the error budget burns
    faster than ``threshold``x sustainable over BOTH windows at once."""

    name: str
    long_s: float
    short_s: float
    threshold: float

    def scaled(self, factor: float) -> "BurnPolicy":
        """Windows scaled by ``factor`` (thresholds are dimensionless)."""
        return BurnPolicy(self.name, self.long_s * factor,
                          self.short_s * factor, self.threshold)


# the SRE Workbook's recommended pairs (for a 30d budget at 2%/5%/10%
# spend): page on 14.4x over 1h/5m, ticket-or-page on 6x over 6h/30m
FAST_BURN = BurnPolicy("fast", 3600.0, 300.0, 14.4)
SLOW_BURN = BurnPolicy("slow", 21600.0, 1800.0, 6.0)


@dataclasses.dataclass(frozen=True)
class SLOBudget:
    """An SLO objective, its error budget window, and the alert policies.

    ``objective`` is the availability target (0.99 tolerates 1% bad
    scrapes); the error budget over any window is ``(1 - objective) *
    samples``.  ``sli`` picks the goodness predicate: ``"availability"``
    flags a scrape good iff its weighted SLO fulfillment >=
    ``good_threshold``; ``"latency"`` iff ``latency_metric`` <=
    ``latency_target``.
    """

    objective: float = 0.99
    budget_window_s: float = 86400.0
    policies: Tuple[BurnPolicy, ...] = (FAST_BURN, SLOW_BURN)
    sli: str = "availability"
    good_threshold: float = 1.0          # availability: fulfillment >= this
    latency_metric: str = "queue"        # latency: metric <= target is good
    latency_target: float = 1.0

    @property
    def allowed(self) -> float:
        """Sustainable error rate: the budget per sample."""
        return max(1.0 - self.objective, 1e-9)

    def scaled(self, factor: float) -> "SLOBudget":
        """All windows scaled by ``factor`` — maps the production-sized
        1h/6h policies onto a short simulated clock (e.g. 1/60)."""
        return dataclasses.replace(
            self, budget_window_s=self.budget_window_s * factor,
            policies=tuple(p.scaled(factor) for p in self.policies))

    def burn_rates(self, ts, bad, until: Optional[float] = None
                   ) -> Dict[str, Tuple[float, float]]:
        """(long, short) burn rate per policy — one vectorized pass."""
        windows: List[float] = []
        for p in self.policies:
            windows.extend((p.long_s, p.short_s))
        rates = error_rates(ts, bad, windows, until) / self.allowed
        return {p.name: (float(rates[2 * i]), float(rates[2 * i + 1]))
                for i, p in enumerate(self.policies)}


@dataclasses.dataclass(frozen=True)
class BurnState:
    """One service's error-budget health at a snapshot instant."""

    service: str
    t: float
    sli: float                    # 1 - rolling error rate (budget window)
    budget_consumed: float        # rolling budget fraction spent (can be >1)
    bad_total: int                # cumulative bad scrapes (monotone)
    sample_total: int             # cumulative scrapes (monotone)
    burn: Mapping[str, Tuple[float, float]]   # policy -> (long, short)
    firing: Tuple[str, ...] = ()  # policies whose alert is firing

    @property
    def alerting(self) -> bool:
        return bool(self.firing)

    def fired(self, policy: str) -> bool:
        return policy in self.firing

    def burn_rate(self, policy: str = "fast") -> float:
        """The policy's long-window burn rate (0.0 for unknown policies)."""
        return float(self.burn.get(policy, (0.0, 0.0))[0])


class _SliRing:
    """Per-service (t, bad) ring: sorted timestamps, bad flags and their
    prefix sum; appends are amortized O(1), window queries O(log n).
    Samples older than the retention horizon are compacted away, but the
    cumulative totals survive compaction (they are monotone by
    construction — the error budget only ever gets spent)."""

    __slots__ = ("t", "bad", "n", "bad_total", "total")

    def __init__(self, initial: int = 256):
        self.t = np.empty(initial, np.float64)
        self.bad = np.empty(initial, bool)
        self.n = 0
        self.bad_total = 0
        self.total = 0

    def append(self, ts: np.ndarray, bad: np.ndarray,
               horizon: float) -> None:
        k = ts.shape[0]
        if k == 0:
            return
        if self.n + k > self.t.shape[0]:
            keep = int(np.searchsorted(self.t[:self.n], horizon, side="left"))
            if keep > 0:                    # compact: drop pre-horizon rows
                self.t[:self.n - keep] = self.t[keep:self.n]
                self.bad[:self.n - keep] = self.bad[keep:self.n]
                self.n -= keep
            while self.n + k > self.t.shape[0]:
                cap = 2 * self.t.shape[0]
                self.t = np.concatenate([self.t, np.empty(cap - self.t.shape[0])])
                self.bad = np.concatenate(
                    [self.bad, np.empty(cap - self.bad.shape[0], bool)])
        self.t[self.n:self.n + k] = ts
        self.bad[self.n:self.n + k] = bad
        self.n += k
        self.total += int(k)
        self.bad_total += int(np.count_nonzero(bad))

    def view(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.t[:self.n], self.bad[:self.n]


def sli_flags(budget: SLOBudget, slos: Sequence[SLO], ts: np.ndarray,
              cols: Sequence[str], vals: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized goodness flags for one service's columnar sample block.

    Returns (timestamps, bad) with rows missing a needed metric dropped
    (a scrape gap neither spends nor refunds budget).  ``availability``
    reduces the per-SLO Eq. (1) terms exactly like
    ``core.slo.service_fulfillment``, just over whole columns at once.
    """
    ts = np.asarray(ts, np.float64)
    if ts.size == 0:
        return ts, np.zeros(0, bool)
    colidx = {c: j for j, c in enumerate(cols)}
    if budget.sli == "latency":
        j = colidx.get(budget.latency_metric)
        if j is None:
            return np.zeros(0), np.zeros(0, bool)
        col = np.asarray(vals[:, j], np.float64)
        valid = np.isfinite(col)
        return ts[valid], col[valid] > budget.latency_target
    num = np.zeros(ts.shape[0])
    den = 0.0
    valid = np.ones(ts.shape[0], bool)
    for q in slos:
        j = colidx.get(q.metric)
        if j is None:
            return np.zeros(0), np.zeros(0, bool)
        col = np.asarray(vals[:, j], np.float64)
        ok = np.isfinite(col)
        valid &= ok
        num += np.where(ok, np.minimum(col / q.target, 1.0), 0.0) * q.weight
        den += q.weight
    f = num / max(den, 1e-12)
    bad = f < budget.good_threshold - 1e-9
    return ts[valid], bad[valid]


class SLOAccountant:
    """Rolling per-service error-budget accounting over a live platform.

    Bind it to anything with the MUDAP/Fleet surface (``services()``,
    ``service(sid).slos``, ``window_columns``); call ``update(t)`` once per
    agent cycle.  Each update ingests every service's NEW scrapes since the
    last one in a single bulk columnar query, flags them good/bad
    (``sli_flags``), advances the alert clocks, and returns the fresh
    per-service ``BurnState`` map.  ``snapshot`` is the read-only variant.

    The accountant owns its rings: a service's budget history survives
    host failure (the failed host's ``TimeSeriesDB`` is lost, the budget
    ledger is not) and migration (sids are stable across moves).
    """

    def __init__(self, platform, budget: Optional[SLOBudget] = None,
                 retention_margin: float = 1.5,
                 overrides: Optional[Mapping[str, SLOBudget]] = None):
        """``budget`` is the fleet default; ``overrides`` maps service ids to
        their own ``SLOBudget`` (e.g. a latency-SLI budget for a really-served
        LM while the simulated services keep the availability default).

        Merge rule for the cross-service views: every *per-service* quantity
        (goodness flags, burn rates, firing alerts, burn weights) uses the
        service's own budget; the *fleet-level* ``global_state`` pools the
        per-service goodness flags as ingested (so each sample was judged by
        its owner's SLI) but evaluates burn rates, the budget window, and the
        allowed error rate with the fleet DEFAULT budget — the platform-wide
        ledger needs one common yardstick.  ``fast_alerts``'s default policy
        name also comes from the default budget; a policy name that exists
        only in an override is still tracked in ``alert_seconds``.
        """
        self.platform = platform
        self.budget = budget if budget is not None else SLOBudget()
        self.overrides: Dict[str, SLOBudget] = dict(overrides or {})
        budgets = [self.budget] + list(self.overrides.values())
        horizon = max(max([b.budget_window_s] + [p.long_s for p in b.policies])
                      for b in budgets)
        self._retention_s = retention_margin * horizon
        self._rings: Dict[str, _SliRing] = {}
        self._cursor: Dict[str, float] = {}
        self._firing: Dict[Tuple[str, str], float] = {}  # (sid, policy) -> t0
        self._last_t: Optional[float] = None
        self.alert_seconds: Dict[str, float] = {
            p.name: 0.0 for b in budgets for p in b.policies}
        self.alert_log: List[Tuple[float, str, str, str]] = []
        self.states: Dict[str, BurnState] = {}
        self._lock = threading.Lock()

    def budget_for(self, sid: str) -> SLOBudget:
        """The budget governing one service (override, else fleet default)."""
        return self.overrides.get(str(sid), self.budget)

    # -- ingestion -------------------------------------------------------------
    def update(self, t: float) -> Dict[str, BurnState]:
        """Ingest all new scrapes up to ``t``, advance alert clocks, and
        return the per-service burn states (also kept on ``self.states``)."""
        with self._lock:
            services = list(self.platform.services())
            since = {s: self._cursor.get(s, -np.inf) for s in services}
            lo = min(since.values()) if since else -np.inf
            blocks = self.platform.window_columns(
                since=(lo if np.isfinite(lo) else 0.0) + 1e-9, until=t)
            for sid in services:
                ts, cols, vals = blocks.get(sid, (np.zeros(0), [],
                                                  np.zeros((0, 0))))
                keep = ts > since[sid]      # per-service cursor (bulk query
                ts, vals = ts[keep], vals[keep]   # used the oldest cursor)
                if ts.size == 0:
                    continue
                self._cursor[sid] = float(ts[-1])
                slos = self.platform.service(sid).slos
                sts, bad = sli_flags(self.budget_for(sid), slos, ts, cols,
                                     vals)
                if sts.size:
                    ring = self._rings.get(sid)
                    if ring is None:
                        ring = self._rings[sid] = _SliRing()
                    ring.append(sts, bad, float(t) - self._retention_s)
            states = self._states(t)
            self._advance_alerts(t, states)
            self.states = states
            return states

    def snapshot(self, t: Optional[float] = None) -> Dict[str, BurnState]:
        """Read-only burn states at ``t`` (default: the last update's clock)
        — no ingestion, no alert-clock side effects."""
        with self._lock:
            tt = self._last_t if t is None else float(t)
            if tt is None:
                return {}
            return self._states(tt)

    # -- burn math ------------------------------------------------------------
    def _states(self, t: float) -> Dict[str, BurnState]:
        out: Dict[str, BurnState] = {}
        for sid, ring in self._rings.items():
            b = self.budget_for(sid)
            ts, bad = ring.view()
            burn = b.burn_rates(ts, bad, until=t)
            rolling = error_rate(ts, bad, b.budget_window_s, until=t)
            firing = tuple(p.name for p in b.policies
                           if burn[p.name][0] > p.threshold
                           and burn[p.name][1] > p.threshold)
            out[sid] = BurnState(
                service=sid, t=float(t), sli=1.0 - rolling,
                budget_consumed=rolling / b.allowed,
                bad_total=ring.bad_total, sample_total=ring.total,
                burn=burn, firing=firing)
        return out

    def _advance_alerts(self, t: float,
                        states: Mapping[str, BurnState]) -> None:
        dt = 0.0 if self._last_t is None else max(float(t) - self._last_t, 0.0)
        self._last_t = float(t)
        for sid, st in states.items():
            for p in self.budget_for(sid).policies:
                key = (sid, p.name)
                was = key in self._firing
                now = st.fired(p.name)
                if now:
                    self.alert_seconds[p.name] = \
                        self.alert_seconds.get(p.name, 0.0) + (dt if was
                                                               else 0.0)
                if now and not was:
                    self._firing[key] = float(t)
                    self.alert_log.append((float(t), sid, p.name, "fire"))
                elif was and not now:
                    self._firing.pop(key, None)
                    self.alert_log.append((float(t), sid, p.name, "clear"))

    def prune(self, keep) -> None:
        """Drop the rings, cursors and firing alerts of services NOT in
        ``keep`` — the churn hook: ``RASKAgent.refresh_topology`` passes the
        platform's current service set, so a DEPARTED service stops feeding
        ``fast_alerts``/``burn_weights``/``max_burn`` (its alert would
        otherwise fire forever: no new scrapes ever clear it).  Evacuated
        and migrated services are still registered and stay untouched, so
        the survives-failover contract holds; the cumulative
        ``alert_seconds`` ledger and past ``alert_log`` entries are kept —
        a "clear" transition is logged for any alert firing at prune time
        so fire/clear events stay balanced."""
        with self._lock:
            keep_set = set(keep)
            t = self._last_t if self._last_t is not None else 0.0
            for sid in [s for s in self._rings if s not in keep_set]:
                self._rings.pop(sid, None)
                self.states.pop(sid, None)
                for key in [k for k in self._firing if k[0] == sid]:
                    self._firing.pop(key, None)
                    self.alert_log.append((float(t), sid, key[1], "clear"))
            for sid in [s for s in self._cursor if s not in keep_set]:
                self._cursor.pop(sid, None)

    # -- control-plane views ---------------------------------------------------
    def fast_alerts(self, policy: Optional[str] = None) -> List[str]:
        """Services whose ``policy`` alert is firing (default: the first —
        fastest — policy of the fleet DEFAULT budget; override budgets that
        share the name fire under it too), from the last ``update``."""
        if not self.budget.policies:
            return []
        name = policy if policy is not None else self.budget.policies[0].name
        return sorted(s for s, st in self.states.items() if st.fired(name))

    def burn_weights(self, cap: float = 4.0) -> Dict[str, float]:
        """Per-service rebalance priority weight in [1, 1 + cap]: 1 when no
        budget is burning, growing with the worst long-window burn relative
        to its policy's threshold — each service judged against its OWN
        budget's policies.  ``RASKAgent`` multiplies placement score rows by
        these, so the per-snapshot migration budget is spent on the services
        burning error budget fastest."""
        out: Dict[str, float] = {}
        for sid, st in self.states.items():
            rel = max((st.burn[p.name][0] / p.threshold
                       for p in self.budget_for(sid).policies
                       if p.name in st.burn), default=0.0)
            out[sid] = 1.0 + float(np.clip(rel, 0.0, cap))
        return out

    def global_state(self, t: Optional[float] = None) -> Optional[BurnState]:
        """Fleet-level burn state: all services' samples pooled into one
        stream (the "is the PLATFORM inside its budget" view).  Each pooled
        flag was judged by its service's own budget at ingestion; the pooled
        burn/allowed math uses the fleet DEFAULT budget (see ``__init__``'s
        merge rule)."""
        with self._lock:
            tt = self._last_t if t is None else float(t)
            if tt is None or not self._rings:
                return None
            parts = [ring.view() for ring in self._rings.values()]
            ts = np.concatenate([p[0] for p in parts])
            bad = np.concatenate([p[1] for p in parts])
            order = np.argsort(ts, kind="stable")
            ts, bad = ts[order], bad[order]
            b = self.budget
            burn = b.burn_rates(ts, bad, until=tt)
            rolling = error_rate(ts, bad, b.budget_window_s, until=tt)
            firing = tuple(p.name for p in b.policies
                           if burn[p.name][0] > p.threshold
                           and burn[p.name][1] > p.threshold)
            return BurnState(
                service="_fleet", t=float(tt), sli=1.0 - rolling,
                budget_consumed=rolling / b.allowed,
                bad_total=sum(r.bad_total for r in self._rings.values()),
                sample_total=sum(r.total for r in self._rings.values()),
                burn=burn, firing=firing)
