"""Multi-dimensional autoscaling of co-located LM services: the control
plane's CLI, the counterpart of ``repro/launch/autoscale.py`` (the paper's
technique applied to LM serving, experiment X1).

Three LM services (gemma3-1b, qwen2-moe-a2.7b, mamba2-370m) share one
pod's chip budget. MUDAP exposes each engine's {chips, context, rung};
RASK learns {chips, context, rung} -> tp_max per service from scraped
metrics, proposes one transactional ``ScalingPlan`` per cycle, and the
platform arbitrates it against the shared chip constraint, exactly as it
does for the paper's QR/CV/PC triple. The agent decides on ``--device``:
the card unless the caller asks for ``cpu``; a missing card is an error.

With ``--hosts N`` the pod budget is split over N devices behind a
``Fleet`` (``--replicas`` multiplies the service count), so e.g.
``--hosts 3 --replicas 3`` runs 9 services across 3 devices under one
agent. ``--host-caps 4,8,20`` instead gives every device its OWN chip
budget — a heterogeneous fleet: services are placed proportionally to
each device's budget and the solver groups the unequal hosts into layout
buckets.

``--rebalance-every N`` turns on the per-cycle placement stage (one
candidate-batched score snapshot + at most one migration every N cycles)
and ``--churn`` scripts mid-run fleet changes (host failure/drain with
scorer-driven evacuation, capacity degradation, service arrival/departure
— see ``env.scenarios.parse_churn`` for the grammar).

``--shard`` is ``repro``'s: ``auto``, ``off`` or a count. Each layout
bucket's rows are spread over the devices it names
(``device.shard_devices``: every card for ``auto``, the first N cards for
N, at most the cards present; N entries of the CPU on the CPU;
``core.solver.shard_rows``), and the plans are the same whatever the
count.

Each LM's throughput surface is analytic (``env/profiles.py::lm_profile``,
rated by the H100 data sheet) unless ``benchmarks/artifacts/
lm_calibration.json`` exists, which then gives {rung: tokens/s/chip}.

    PYTHONPATH=src python -m repro_torch.launch.autoscale --minutes 10
    PYTHONPATH=src python -m repro_torch.launch.autoscale --hosts 3 --replicas 3
    PYTHONPATH=src python -m repro_torch.launch.autoscale --host-caps 4,8,20 \
        --replicas 3 --rebalance-every 3 --churn "fail:edge-1@420"
    PYTHONPATH=src python -m repro_torch.launch.autoscale --device cpu
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..configs import ARCHS
from ..core import RASKAgent, RaskConfig, violation_rate
from ..device import resolve_device
from ..env import EdgeEnvironment, bursty, diurnal, lm_profile


def lm_services(max_chips: float = 16.0):
    cal_path = Path(__file__).resolve().parents[3] / "benchmarks" / \
        "artifacts" / "lm_calibration.json"
    cal = json.loads(cal_path.read_text()) if cal_path.exists() else {}
    profiles = []
    for name, rps in [("gemma3-1b", 12.0), ("qwen2-moe-a2.7b", 6.0),
                      ("mamba2-370m", 20.0)]:
        n = ARCHS[name].n_params_active()
        profiles.append(lm_profile(
            name, n, default_rps=rps, max_chips=max_chips,
            calibration={int(k): v for k, v in cal.get(name, {}).items()}
            or None))
    return profiles


def shard_spec(shard: str):
    """``--shard`` as ``repro``'s CLI parses it: ``"auto"``, False for
    ``off``/``false``/``0``, else the count."""
    if shard == "auto":
        return "auto"
    return False if shard.lower() in ("off", "false", "0") else int(shard)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--chips", type=float, default=16.0)
    ap.add_argument("--pattern", default="diurnal",
                    choices=["diurnal", "bursty"])
    ap.add_argument("--backend", default="pgd", choices=["pgd", "slsqp"])
    ap.add_argument("--hosts", type=int, default=1,
                    help="edge devices behind one Fleet (chips split evenly)")
    ap.add_argument("--host-caps", default=None,
                    help="comma-separated per-device chip budgets (e.g. "
                         "'4,8,20'): a HETEROGENEOUS fleet, services placed "
                         "proportionally to each device's budget; overrides "
                         "--hosts/--chips splitting")
    ap.add_argument("--replicas", type=int, default=1,
                    help="containers per LM service type")
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="per-cycle placement stage: every N post-"
                         "exploration cycles one batched placement-score "
                         "snapshot and at most one migration (0 = off)")
    ap.add_argument("--churn", default=None,
                    help="scripted mid-run fleet changes, e.g. "
                         "'fail:edge-1@420,degrade:edge-0@300:0.5,"
                         "arrive:gemma3-1b@500,depart:SID@700' "
                         "(env.scenarios.parse_churn grammar)")
    ap.add_argument("--forecast", action="store_true",
                    help="proactive scaling: per-service AR load "
                         "forecasters ride inside the fused decide and the "
                         "solve targets predicted-horizon load wherever "
                         "the hybrid gate's rolling forecast error allows "
                         "(falls back to reactive rps on error spikes)")
    ap.add_argument("--horizon", type=float, default=10.0,
                    help="forecast horizon in seconds (--forecast); "
                         "rounded to whole control cycles")
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined decide (dispatch-then-collect): each "
                         "cycle's solve runs on the card while the plan is "
                         "applied and telemetry scraped, hiding the solve "
                         "latency behind the control interval (plans lag "
                         "observations by one cycle)")
    ap.add_argument("--shard", default="auto",
                    help="'auto' (default: every card), 'off' or a count "
                         "N (the first N cards, at most the cards present; "
                         "N entries of the CPU on the CPU): each layout "
                         "bucket's rows are spread over those devices")
    ap.add_argument("--adapt-budget", action="store_true",
                    help="online solver budget adaptation (shrink PGD "
                         "iters/starts at steady state, restore on load "
                         "shifts)")
    ap.add_argument("--slo-burn", action="store_true",
                    help="SLO error-budget control plane: rolling SLI "
                         "accounting with multiwindow burn-rate alerts "
                         "(sim-scaled SRE policies), wired into the agent "
                         "as a first-class scaling signal")
    ap.add_argument("--slo-objective", type=float, default=0.95,
                    help="availability objective for --slo-burn (a scrape "
                         "is good when weighted fulfillment >= the "
                         "threshold; the budget tolerates 1-objective bad)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics (golden signals + SLO "
                         "budgets + solver internals) on this port for the "
                         "duration of the run (0 picks a free port)")
    ap.add_argument("--dump-metrics", default=None, metavar="PATH",
                    help="write one Prometheus text-format snapshot to "
                         "PATH after the run ('-' for stdout)")
    ap.add_argument("--device", default="cuda",
                    help="where the agent decides: 'cuda' (default) or "
                         "'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.host_caps:
        caps = [float(c) for c in args.host_caps.split(",")]
        total_chips = sum(caps)
    else:
        total_chips = args.chips
    profiles = lm_services(total_chips)
    duration = args.minutes * 60.0
    pat = diurnal if args.pattern == "diurnal" else bursty
    patterns = {p.type: pat(p.default_rps * 2.5, duration_s=duration,
                            seed=args.seed + i)
                for i, p in enumerate(profiles)}
    if args.host_caps:
        # heterogeneous fleet: every device its own budget, services placed
        # proportionally to it (the bucketed per-host solver's home turf)
        hosts = [(f"edge-{i}", {"chips": c}) for i, c in enumerate(caps)]
        env = EdgeEnvironment(profiles, patterns=patterns, seed=args.seed,
                              replicas=args.replicas, hosts=hosts,
                              placement="capacity")
    else:
        per_host_chips = args.chips / max(args.hosts, 1)
        env = EdgeEnvironment(profiles, {"chips": per_host_chips},
                              patterns=patterns, seed=args.seed,
                              replicas=args.replicas, hosts=args.hosts)
    knowledge = {p.type: dict(p.knowledge) for p in profiles}
    agent = RASKAgent(env.platform, knowledge,
                      RaskConfig(xi=20, eta=0.0, backend=args.backend,
                                 resource="chips",
                                 rebalance_every=args.rebalance_every,
                                 adapt_budget=args.adapt_budget,
                                 pipeline=args.pipeline,
                                 shard=shard_spec(args.shard),
                                 forecast=args.forecast,
                                 horizon_s=args.horizon),
                      seed=args.seed, device=device)
    accountant = None
    registry = None
    server = None
    if args.slo_burn or args.metrics_port is not None or args.dump_metrics:
        from ..env import sim_slo_budget
        from ..obs import MetricRegistry, MetricsServer, SLOAccountant, \
            golden_signals
        registry = MetricRegistry()
        if args.slo_burn:
            accountant = SLOAccountant(
                env.platform, sim_slo_budget(objective=args.slo_objective))
            agent.attach_accountant(accountant)
        golden_signals(registry, env.platform, accountant, agent)
        if args.metrics_port is not None:
            server = MetricsServer(registry, port=args.metrics_port)
            port = server.start()
            print(f"serving /metrics on http://127.0.0.1:{port}/metrics")
    events = None
    if args.churn:
        from ..env import parse_churn
        events = parse_churn(args.churn, profiles)
    hist = env.run(agent, duration_s=duration, events=events)
    f = [h.fulfillment for h in hist]
    post = f[agent.cfg.xi:]
    capacity_clips = sum(
        1 for h in hist if h.receipt
        for o in h.receipt.clipped() if o.reason == "capacity")
    n_hosts = len(env.platform.hosts()) \
        if hasattr(env.platform, "hosts") else 1
    print(f"services={len(env.platform.services())} hosts={n_hosts} "
          f"cycles={len(hist)} mean fulfillment (post-explore)="
          f"{np.mean(post):.3f} violations={violation_rate(post):.2%} "
          f"capacity clips={capacity_clips} mean agent runtime="
          f"{np.mean([h.runtime_s for h in hist if not h.explored]) * 1e3:.0f}ms")
    if args.forecast:
        used = [h.forecast_used for h in hist]
        errs = [h.forecast_err for h in hist if h.forecast_used]
        print(f"forecast: proactive cycles={sum(1 for u in used if u)}"
              f"/{len(hist)} max services gated in={max(used, default=0)} "
              f"worst rolling err="
              f"{max(errs, default=0.0):.2f}")
    if accountant is not None:
        fleet = accountant.global_state()
        alert_cycles = sum(1 for h in hist if h.alerts)
        print(f"slo: budget consumed={fleet.budget_consumed:.2f} "
              f"sli={fleet.sli:.4f} alert cycles={alert_cycles} "
              f"fast-alert seconds={accountant.alert_seconds.get('fast', 0.0):.0f}")
    if args.dump_metrics and registry is not None:
        from ..obs import snapshot
        text = snapshot(registry)
        if args.dump_metrics == "-":
            print(text, end="")
        else:
            Path(args.dump_metrics).write_text(text)
    if server is not None:
        server.stop()
    return hist


if __name__ == "__main__":
    main()
