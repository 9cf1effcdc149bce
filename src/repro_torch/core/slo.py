"""Service Level Objectives — paper §II-C1 (the port's copy of
``repro/core/slo.py``, with numpy in place of ``jnp``).

Implements Eq. (1) fulfillment, Eq. (6) completion rate, and Eq. (8)
globally-weighted fulfillment. The solver's differentiable fulfillment is
the RASK objective kernel (``kernels/ops.py::rask_objective``); these are
the host-side measurements. ``windowed_violation_rate`` delegates to the
SLO accounting plane (``obs.slo_accounting``), as in ``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLO:
    """One SLO ``q``: keep ``metric`` >= ``target`` with importance ``weight``.

    Matches paper Table II rows, e.g. SLO("data_quality", 800, 0.5) for QR, or
    SLO("completion", 1.0, 1.0).
    """

    metric: str
    target: float
    weight: float = 1.0

    def fulfillment(self, m):
        """phi(q, m) — Eq. (1). Continuous in m, capped at 1 (no overfulfillment)."""
        return np.minimum(np.asarray(m, np.float32) / np.float32(self.target),
                          np.float32(1.0))


def fulfillment(metric_value, target):
    """Functional form of Eq. (1) for ad-hoc use."""
    return np.minimum(np.asarray(metric_value, np.float32) / np.float32(target),
                      np.float32(1.0))


def completion(throughput, rps):
    """Eq. (6): completion = throughput / RPS, the share of arriving work
    finished, capped at 1 (transient queue drains can push raw tp above the
    arrival rate). Guarded for rps == 0 (idle stream counts as complete).
    """
    rps = np.asarray(rps, np.float32)
    tp = np.asarray(throughput, np.float32)
    return np.where(rps > 0,
                    np.minimum(tp / np.maximum(rps, np.float32(1e-9)),
                               np.float32(1.0)), np.float32(1.0))


def service_fulfillment(slos: Sequence[SLO], metrics: Mapping[str, float]):
    """Weighted mean fulfillment of one service: sum(phi_j * w_j) / sum(w_j)."""
    num = 0.0
    den = 0.0
    for q in slos:
        num = num + q.fulfillment(metrics[q.metric]) * q.weight
        den = den + q.weight
    return num / den


def global_fulfillment(per_service: Sequence[Mapping[str, float]],
                       slo_sets: Sequence[Sequence[SLO]]):
    """Eq. (8): mean over services of their weighted SLO fulfillment."""
    assert len(per_service) == len(slo_sets)
    total = 0.0
    for metrics, slos in zip(per_service, slo_sets):
        total = total + service_fulfillment(slos, metrics)
    return total / max(len(per_service), 1)


def violation_rate(history: Sequence[float], threshold: float = 1.0) -> float:
    """Share of cycles whose global fulfillment fell below ``threshold``.

    The paper reports "28% less SLO violations"; a violation is any cycle with
    fulfillment < 1.0 (any SLO unmet at all).
    """
    if not history:
        return 0.0
    return float(sum(1 for f in history if float(f) < threshold)) / len(history)


def windowed_violation_rate(ts: Sequence[float], history: Sequence[float],
                            window: float, until=None,
                            threshold: float = 1.0) -> float:
    """Rolling variant of ``violation_rate``: the share of samples below
    ``threshold`` among those in the half-open window ``(until - window,
    until]`` (default ``until``: the last timestamp).

    Delegates to the SLO accounting plane's ``error_rate``
    (``obs.slo_accounting``) so benchmarks and the error-budget control
    plane report the same rolling number from ONE code path — a violation
    here IS a bad SLI sample there. ``ts`` must be sorted ascending and
    aligned with ``history``.
    """
    # deferred import: obs imports SLO from this module
    from ..obs.slo_accounting import error_rate
    f = np.asarray(list(history), np.float64)
    return error_rate(ts, f < threshold, window, until)
