"""Observability: SLO error-budget accounting and burn-rate alerts (the
port's copy of ``repro/obs``'s accounting plane).

``SLOAccountant`` turns raw ``TimeSeriesDB`` scrapes into rolling SLIs,
error budgets, and Google-SRE multiwindow multiburn alerts that
``RASKAgent`` consumes as a scaling signal. ``repro``'s golden-signals
registry and Prometheus exposition (``registry.py``, ``prometheus.py``)
are not ported yet (ROADMAP Queue 1, item 22).
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
]
