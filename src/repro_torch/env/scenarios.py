"""Scenarios (the port's copy of ``repro/env/scenarios.py``): heterogeneous
fleets — unequal devices under one control plane — the failover world and
the churn grammar, the SLO error budget on the simulated clock, and the
REAL serving scenario.

The paper's E6 replicates the QR/CV/PC triple on ONE device with
proportionally grown capacity; real edge fleets are not like that.  A
camera node has 2 vCPUs, an aggregation hub a handful, a gateway a big
multiple (DYVERSE's heterogeneous-edge setting, arXiv:1810.04608) — and the
services they run see different load shapes at the same time:

* ``HostSpec`` — a named device with its OWN resource budget;
* ``tiered_hosts`` — the camera / hub / gateway preset (2 / 6 / 16 cores);
* ``two_tier_hosts`` — one small + one large device, sized so
  capacity-weighted placement yields hosts of 2 and 8 services — the
  minimal fleet that exercises TWO solver layout buckets;
* ``mixed_patterns`` — per-service-type diurnal / bursty / constant load;
* ``hetero_environment`` / ``two_tier_environment`` — wired scenarios;
* ``failover_scenario`` — the tiered fleet plus one scripted host outage;
* ``churn_scenario`` — the tiered fleet under throttling, an arrival and a
  departure;
* ``parse_churn`` — the CLI churn grammar (all five kinds).

``repro``'s ``backlog_scenario`` waits for the latency-SLI work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

from .profiles import CV_PROFILE, PC_PROFILE, QR_PROFILE, ServiceProfile, \
    paper_profiles
from .simulator import ChurnEvent, EdgeEnvironment
from .workloads import Pattern, bursty, constant, diurnal


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """One edge device: a name and its own resource budget."""

    name: str
    capacity: Mapping[str, float]


def tiered_hosts(resource: str = "cores", small: float = 2.0,
                 mid: float = 6.0, large: float = 16.0) -> List[HostSpec]:
    """Camera / hub / gateway — three capacity tiers on one resource."""
    return [HostSpec("camera-0", {resource: small}),
            HostSpec("hub-0", {resource: mid}),
            HostSpec("gateway-0", {resource: large})]


def two_tier_hosts(resource: str = "cores", small: float = 4.0,
                   large: float = 16.0) -> List[HostSpec]:
    """One small + one large device (1:4 budget ratio): with 10 services
    under capacity placement the small host takes 2 and the large 8 —
    two solver layout buckets, the e6 ``--hetero`` acceptance fleet."""
    return [HostSpec("edge-small", {resource: small}),
            HostSpec("edge-big", {resource: large})]


def mixed_patterns(duration_s: float = 1800.0, seed: int = 0
                   ) -> Dict[str, Pattern]:
    """Mixed load shapes hitting the fleet at once: QR rides the diurnal
    curve, CV gets the bursts, PC streams at a constant rate (Fig. 7
    levels: QR to 100 RPS, CV to 10, PC at 50)."""
    return {"qr-detector": diurnal(100.0, duration_s=duration_s, seed=seed),
            "cv-analyzer": bursty(10.0, duration_s=duration_s,
                                  seed=seed + 100),
            "pc-visualizer": constant(50.0)}


def hetero_knowledge(profiles: Sequence[ServiceProfile]
                     ) -> Dict[str, Dict[str, Tuple[str, ...]]]:
    """Structural knowledge K for any profile mix (deduped by type)."""
    return {p.type: {t: tuple(f) for t, f in p.knowledge.items()}
            for p in profiles}


def hetero_environment(replicas: int = 3, duration_s: float = 1800.0,
                       seed: int = 0,
                       hosts: Sequence[HostSpec] = None
                       ) -> Tuple[EdgeEnvironment, Dict]:
    """The 9-services / 3-unequal-devices scenario: ``replicas`` copies of
    the paper triple spread over camera/hub/gateway proportionally to each
    device's budget, under mixed diurnal/bursty/constant load.  Returns
    (environment, knowledge-for-RASK)."""
    profiles = list(paper_profiles().values())
    hosts = list(hosts) if hosts is not None else tiered_hosts()
    env = EdgeEnvironment(profiles,
                          patterns=mixed_patterns(duration_s, seed=seed),
                          replicas=replicas, seed=seed, hosts=hosts,
                          placement="capacity")
    return env, hetero_knowledge(profiles)


def two_tier_environment(duration_s: float = 1800.0, seed: int = 0
                         ) -> Tuple[EdgeEnvironment, Dict]:
    """10 services on a 2-bucket fleet (2 on the small host, 8 on the big
    one): five profile slots (QR, CV, PC plus a second QR and CV) times two
    replicas, capacity-placed over ``two_tier_hosts``.  Returns
    (environment, knowledge-for-RASK)."""
    profiles = [QR_PROFILE, CV_PROFILE, PC_PROFILE, QR_PROFILE, CV_PROFILE]
    env = EdgeEnvironment(profiles,
                          patterns=mixed_patterns(duration_s, seed=seed),
                          replicas=2, seed=seed, hosts=two_tier_hosts(),
                          placement="capacity")
    return env, hetero_knowledge(profiles)




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


# -- churn scenarios: the fleet changing mid-run ------------------------------

def failover_scenario(duration_s: float = 1200.0, seed: int = 0,
                      fail_at: float = None, kind: str = "drain_host",
                      host: str = "hub-0"
                      ) -> Tuple[EdgeEnvironment, Dict, List[ChurnEvent]]:
    """The seeded failover world of e8 and the e2e tests: the 9-service
    camera/hub/gateway fleet of ``hetero_environment`` plus one scripted
    outage of ``host`` at ``fail_at`` (default: 60% through the run).  On
    the event the hub's residents are evacuated via the agent's batched
    placement scores onto the surviving devices — with their telemetry
    windows when ``kind="drain_host"``, without when ``"fail_host"`` — and
    the agent re-binds to the 2-device topology.  Returns (environment,
    knowledge-for-RASK, events)."""
    env, knowledge = hetero_environment(duration_s=duration_s, seed=seed)
    t = float(fail_at) if fail_at is not None else round(0.6 * duration_s)
    return env, knowledge, [ChurnEvent(t=t, kind=kind, host=host)]


def churn_scenario(duration_s: float = 1800.0, seed: int = 0
                   ) -> Tuple[EdgeEnvironment, Dict, List[ChurnEvent]]:
    """Mixed mid-run churn on the tiered fleet: the gateway loses 40% of
    its capacity (thermal throttling), a new QR container arrives, and one
    original service departs — arrival/departure re-enter a short
    exploration phase while the new relations gather >= 3 rows, exactly
    like the initial xi phase."""
    env, knowledge = hetero_environment(duration_s=duration_s, seed=seed)
    victim = sorted(env.platform.services())[0]
    events = [
        ChurnEvent(t=round(0.35 * duration_s), kind="degrade",
                   host="gateway-0", factor=0.6),
        ChurnEvent(t=round(0.55 * duration_s), kind="arrive",
                   profile=QR_PROFILE),
        ChurnEvent(t=round(0.75 * duration_s), kind="depart",
                   service=victim),
    ]
    return env, knowledge, events


def parse_churn(spec: str, profiles: Sequence[ServiceProfile] = ()
                ) -> List[ChurnEvent]:
    """CLI churn grammar (``launch/autoscale --churn``): a comma-separated
    list of ``kind:arg@t[:extra]`` items —

      * ``fail:HOST@T`` / ``drain:HOST@T`` — abrupt / graceful host outage;
      * ``degrade:HOST@T:FACTOR``          — capacity x FACTOR (default 0.5);
      * ``arrive:TYPE@T``                  — a new container of profile TYPE;
      * ``depart:SID@T``                   — service SID leaves.

    ``T`` is absolute simulation seconds.  Events come back time-sorted.
    """
    by_type = {p.type: p for p in profiles}
    out: List[ChurnEvent] = []
    for item in filter(None, (s.strip() for s in spec.split(","))):
        head, sep, tail = item.partition("@")
        kind, _, arg = head.partition(":")
        if not sep or not arg:
            raise ValueError(f"churn item {item!r} is not kind:arg@t[:extra]")
        t_str, _, extra = tail.partition(":")
        t = float(t_str)
        if kind in ("fail", "fail_host"):
            out.append(ChurnEvent(t=t, kind="fail_host", host=arg))
        elif kind in ("drain", "drain_host"):
            out.append(ChurnEvent(t=t, kind="drain_host", host=arg))
        elif kind == "degrade":
            out.append(ChurnEvent(t=t, kind="degrade", host=arg,
                                  factor=float(extra) if extra else 0.5))
        elif kind == "arrive":
            if arg not in by_type:
                raise KeyError(f"arrive: unknown profile type {arg!r} "
                               f"(have {sorted(by_type)})")
            out.append(ChurnEvent(t=t, kind="arrive", profile=by_type[arg]))
        elif kind == "depart":
            out.append(ChurnEvent(t=t, kind="depart", service=arg))
        else:
            raise ValueError(f"unknown churn kind {kind!r} in {item!r}")
    return sorted(out, key=lambda e: e.t)
