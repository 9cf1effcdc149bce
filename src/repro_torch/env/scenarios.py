"""Scenarios: the SLO error budget on the simulated clock and the REAL
serving scenario (the port's part of ``repro/env/scenarios.py``).

``repro``'s fleet scenarios (``HostSpec``, tiered and two-tier hosts,
``hetero_environment``, ``failover_scenario``, ``churn_scenario``,
``parse_churn``, ``backlog_scenario``) need the multi-host Fleet and come
with it (ROADMAP Queue 1, item 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from .workloads import Pattern, bursty


def sim_slo_budget(objective: float = 0.95, good_threshold: float = 0.6,
                   scale: float = 1.0 / 20.0):
    """The production SRE alert policies mapped onto the simulated clock.

    ``SLOBudget``'s defaults are production-sized (1h/5m fast burn at
    14.4x, 6h/30m slow burn at 6x over a 24h budget); a simulated run is
    ~20 minutes.  ``scale=1/20`` compresses every window by the same
    factor (fast 180s/15s, slow 1080s/90s, budget 72min) while the
    dimensionless burn thresholds stay untouched — one 10s agent cycle
    plays ~3.3 production minutes, so the fast long window spans 18
    cycles.

    A scrape is *good* when the service's weighted SLO fulfillment is at
    least ``good_threshold``; with ``objective=0.95`` the fast policy
    fires once >72% of a window's scrapes go bad (14.4 x 5%).  The
    defaults were tuned in ``repro`` against its seeded failover world:
    the per-scrape fulfillment of a healthy-but-noisy service dips below
    0.6 in bursts too short to sustain a 72% bad rate over 3 simulated
    minutes, while a post-outage capacity squeeze does it within one
    agent cycle.
    """
    from ..obs import SLOBudget
    return SLOBudget(objective=objective,
                     good_threshold=good_threshold).scaled(scale)


def real_serving_scenario(arch: str = "gemma3-1b", n_services: int = 2,
                          duration_s: float = 600.0,
                          capacity_chips: float = 6.0,
                          max_rps: Sequence[float] = (4.0, 14.0),
                          steps_per_chip_s: float = 5.0, max_seq: int = 64,
                          slots: int = 4, latency_target: float = 12.0,
                          budget_scale: float = 1.0 / 60.0, base=None,
                          device=None):
    """REAL serving under MUDAP: no simulator, no analytic surfaces.

    Builds ``n_services`` ``ServedLMService``s (``arch`` models behind
    stacked-cache continuous-batching engines) on one device with a shared
    chip budget, bursty per-service load with asymmetric peaks
    (``max_rps`` cycles per service — the heavy tail is what makes a fixed
    equal split lose), and an ``SLOAccountant`` whose first service
    carries a latency-SLI budget override over its real queue while the
    rest keep the fleet availability default.

    ``base`` is the model config the rung ladder scales; ``None`` keeps
    ``repro``'s choice, ``arch``'s ``.smoke()`` cut in float32. Pass the
    registered config (e.g. ``configs.get("gemma3-1b")``, bf16) to serve
    at full width. ``device`` defaults to ``cuda`` and raises without a
    card.

    Returns ``(platform, patterns, sids, knowledge, accountant)`` — drive
    with ``serve.run_serving_loop`` (agent or fixed baseline). Everything
    scraped is measured: per-step wall-clock latency, real queue depths,
    completed requests per second.
    """
    from ..configs import get
    from ..core.platform import MUDAP
    from ..device import resolve_device
    from ..models import build
    from ..obs import SLOAccountant, SLOBudget
    from ..serve import ServedLMService, served_lm_profile

    device = resolve_device(device)
    if base is None:
        base = dataclasses.replace(get(arch).smoke(), dtype="float32")
    platform = MUDAP({"chips": capacity_chips}, host="edge-0")
    patterns: Dict[str, Pattern] = {}
    sids: List[str] = []
    knowledge: Dict[str, Dict] = {}
    for i in range(n_services):
        prof = served_lm_profile(f"lm-real-{i}")
        svc = ServedLMService(build, base, profile=prof, slots=slots,
                              max_seq=max_seq, seed=i, rps=1.0,
                              prompt_len=14.0 + 4.0 * i,
                              steps_per_chip_s=steps_per_chip_s,
                              device=device)
        assignment = dict(prof.defaults)
        assignment["chips"] = capacity_chips / n_services
        platform.register(svc.sid, prof.api, svc, list(prof.slos),
                          assignment)
        sid = str(svc.sid)
        sids.append(sid)
        knowledge[prof.type] = dict(prof.knowledge)
        patterns[sid] = bursty(max_rps[i % len(max_rps)], duration_s,
                               seed=10 + i)
    accountant = SLOAccountant(
        platform, SLOBudget(budget_window_s=3600.0).scaled(budget_scale),
        overrides={sids[0]: SLOBudget(
            sli="latency", latency_metric="queue",
            latency_target=latency_target,
            budget_window_s=3600.0).scaled(budget_scale)})
    return platform, patterns, sids, knowledge, accountant
