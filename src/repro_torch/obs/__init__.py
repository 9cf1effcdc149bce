"""Observability: SLO error-budget accounting, burn-rate alerts, and a
golden-signals metric registry with Prometheus text-format exposition (the
port's copy of ``repro/obs``).

``SLOAccountant`` turns raw ``TimeSeriesDB`` scrapes into rolling SLIs,
error budgets, and Google-SRE multiwindow multiburn alerts that
``RASKAgent`` consumes as a scaling signal; ``MetricRegistry`` +
``golden_signals`` + ``render`` expose the same state (plus solver
internals from ``DecisionInfo``) to scrapes, and ``MetricsServer`` serves
them on ``/metrics``.
"""
from .slo_accounting import (
    FAST_BURN,
    SLOW_BURN,
    BurnPolicy,
    BurnState,
    SLOAccountant,
    SLOBudget,
    error_rate,
    error_rates,
    sli_flags,
)
from .registry import Metric, MetricRegistry, golden_signals
from .prometheus import MetricsServer, render, snapshot

__all__ = [
    "BurnPolicy",
    "BurnState",
    "FAST_BURN",
    "SLOW_BURN",
    "SLOAccountant",
    "SLOBudget",
    "error_rate",
    "error_rates",
    "sli_flags",
    "Metric",
    "MetricRegistry",
    "golden_signals",
    "MetricsServer",
    "render",
    "snapshot",
]
