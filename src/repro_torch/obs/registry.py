"""Golden-signals metric registry (the port's copy of
``repro/obs/registry.py``: the same families, names and help texts, so
scrapes and dashboards read the port as they read ``repro``).

A tiny Prometheus-shaped metric model: named families (gauge or counter)
holding labeled samples, plus ``golden_signals`` — the one collector that
maps the platform's state onto the four golden signals per service

* traffic     — ``repro_service_rps`` (request rate from the last scrape)
* latency     — ``repro_service_queue`` (queue backlog: the sim's latency
                proxy — completion < 1 means work is queueing)
* errors      — ``repro_service_error_ratio`` (1 - completion)
* saturation  — ``repro_service_cpu_utilization``

plus the SLO budget plane (``repro_slo_*`` from ``SLOAccountant``) and the
solver internals carried by ``DecisionInfo`` (``repro_decide_*``).  The
registry is collect-on-demand: ``collect()`` re-reads the live objects, so
a scrape (or one-shot snapshot) always reflects the current cycle without
any per-cycle bookkeeping on the hot path. Nothing here touches the card:
``DecisionInfo`` and the accountant hold host floats. The help text of
``repro_decide_compile_seconds_total`` keeps ``repro``'s words; in the
port it counts the one-off kernel build of an agent's first solve.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Mapping, Optional, Tuple

LabelSet = Tuple[Tuple[str, str], ...]


@dataclasses.dataclass
class Metric:
    """One metric family: name, type ('gauge'|'counter'), help text, and
    labeled samples."""

    name: str
    kind: str
    help: str
    samples: Dict[LabelSet, float] = dataclasses.field(default_factory=dict)

    def set(self, value: float, **labels: str) -> None:
        self.samples[tuple(sorted(labels.items()))] = float(value)

    def inc(self, value: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        self.samples[key] = self.samples.get(key, 0.0) + float(value)


class MetricRegistry:
    """Thread-safe registry of metric families with pluggable collectors.

    ``register_collector`` adds a zero-arg callable run at every
    ``collect()``; collectors write into families via ``gauge``/``counter``.
    """

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._collectors: List[Callable[["MetricRegistry"], None]] = []
        self._lock = threading.RLock()

    def gauge(self, name: str, help: str = "") -> Metric:
        return self._family(name, "gauge", help)

    def counter(self, name: str, help: str = "") -> Metric:
        return self._family(name, "counter", help)

    def _family(self, name: str, kind: str, help: str) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Metric(name, kind, help)
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def register_collector(
            self, fn: Callable[["MetricRegistry"], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> List[Metric]:
        """Run all collectors, then return the families sorted by name."""
        with self._lock:
            for fn in self._collectors:
                fn(self)
            return [self._metrics[k] for k in sorted(self._metrics)]


def golden_signals(registry: MetricRegistry, platform,
                   accountant=None, agent=None) -> None:
    """Register the standard collector set on ``registry``.

    ``platform`` is a MUDAP or Fleet; ``accountant`` an optional
    ``SLOAccountant``; ``agent`` an optional ``RASKAgent`` (for the
    ``DecisionInfo`` solver internals of the last cycle).
    """

    def collect_services(reg: MetricRegistry) -> None:
        rps = reg.gauge("repro_service_rps",
                        "traffic: request rate at the last scrape")
        queue = reg.gauge("repro_service_queue",
                          "latency proxy: queued work in request-seconds")
        errs = reg.gauge("repro_service_error_ratio",
                         "errors: 1 - completion at the last scrape")
        sat = reg.gauge("repro_service_cpu_utilization",
                        "saturation: fraction of allocated resource in use")
        fulf = reg.gauge("repro_service_fulfillment",
                         "weighted SLO fulfillment (Eq. 8 per-service term)")
        for sid in platform.services():
            m = platform.latest_metrics(sid)
            if not m:
                continue
            labels = {"service": str(sid)}
            if "rps" in m:
                rps.set(m["rps"], **labels)
            if "queue" in m:
                queue.set(m["queue"], **labels)
            if "completion" in m:
                errs.set(max(1.0 - m["completion"], 0.0), **labels)
            if "cpu_utilization" in m:
                sat.set(m["cpu_utilization"], **labels)
            svc = platform.service(sid)
            if svc.slos:
                from ..core.slo import service_fulfillment
                fulf.set(service_fulfillment(svc.slos, m), **labels)

    registry.register_collector(collect_services)

    if accountant is not None:
        def collect_slo(reg: MetricRegistry) -> None:
            sli = reg.gauge("repro_slo_sli",
                            "rolling SLI over the error-budget window")
            consumed = reg.gauge("repro_slo_budget_consumed",
                                 "rolling error budget consumed (1.0 = all)")
            burn = reg.gauge("repro_slo_burn_rate",
                             "error-budget burn rate (long window)")
            firing = reg.gauge("repro_slo_alert_firing",
                               "1 if the multiwindow burn alert is firing")
            bad = reg.counter("repro_slo_bad_samples_total",
                              "cumulative bad scrapes (budget ever spent)")
            total = reg.counter("repro_slo_samples_total",
                                "cumulative scrapes accounted")
            alert_s = reg.counter("repro_slo_alert_seconds_total",
                                  "cumulative seconds spent with the alert "
                                  "firing")
            for sid, st in accountant.states.items():
                labels = {"service": sid}
                sli.set(st.sli, **labels)
                consumed.set(st.budget_consumed, **labels)
                bad.samples[(("service", sid),)] = float(st.bad_total)
                total.samples[(("service", sid),)] = float(st.sample_total)
                for p in accountant.budget.policies:
                    burn.set(st.burn[p.name][0], service=sid, policy=p.name)
                    firing.set(1.0 if st.fired(p.name) else 0.0,
                               service=sid, policy=p.name)
            for name, secs in accountant.alert_seconds.items():
                alert_s.samples[(("policy", name),)] = float(secs)

        registry.register_collector(collect_slo)

    if agent is not None:
        def collect_agent(reg: MetricRegistry) -> None:
            info = getattr(agent, "last_decision", None)
            if info is None:
                return
            reg.gauge("repro_decide_us",
                      "agent decide latency, microseconds").set(
                          info.runtime_s * 1e6)
            reg.gauge("repro_decide_score",
                      "solver objective at the accepted plan").set(info.score)
            reg.gauge("repro_decide_pgd_starts",
                      "PGD restarts in the last solve").set(info.pgd_starts)
            reg.gauge("repro_decide_pgd_iters",
                      "PGD iterations in the last solve").set(info.pgd_iters)
            reg.gauge("repro_decide_score_starts",
                      "placement-scorer restarts (adaptive budget)").set(
                          info.score_starts)
            reg.gauge("repro_decide_score_iters",
                      "placement-scorer iterations (adaptive budget)").set(
                          info.score_iters)
            reg.gauge("repro_decide_burn_alerts",
                      "services with a firing fast-burn alert").set(
                          info.burn_alerts)
            reg.gauge("repro_decide_max_burn",
                      "worst long-window burn rate across services").set(
                          info.max_burn)
            moves = reg.counter("repro_decide_moves_total",
                                "cumulative applied migrations")
            moves.samples[()] = float(getattr(agent, "moves_total", 0))
            comp = reg.counter("repro_decide_compile_seconds_total",
                               "cumulative jit compile time in decide")
            comp.samples[()] = float(getattr(agent, "compile_s_total", 0.0))

        registry.register_collector(collect_agent)
