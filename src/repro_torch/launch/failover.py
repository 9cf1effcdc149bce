"""Failover walkthrough: a device dies mid-run and the fleet absorbs it (the
counterpart of ``examples/failover.py``).

The tiered camera/hub/gateway fleet (9 services under mixed diurnal /
bursty / constant load) runs with the per-cycle placement stage on
(``RaskConfig(rebalance_every=3)``): every third cycle the agent scores
all (service, host) what-if placements with one batched solve per layout
bucket (``PlacementProblem``) and applies at most one decisively-better
migration.

At 60% of the run the hub drains: its residents are evacuated onto the
camera and gateway — destinations chosen by the same batched scores, each
service's telemetry window carried to its new host's DB
(``Fleet.migrate``) — and the agent, deciding on ``--device`` (``cuda``
unless asked for ``cpu``), re-binds to the 2-device topology.

    PYTHONPATH=src python -m repro_torch.launch.failover              # card
    PYTHONPATH=src python -m repro_torch.launch.failover --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import RASKAgent, RaskConfig, violation_rate
from ..device import resolve_device
from ..env import failover_scenario


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=900.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    env, knowledge, events = failover_scenario(duration_s=args.seconds,
                                               seed=args.seed)
    fail_t = events[0].t
    agent = RASKAgent(env.platform, knowledge,
                      RaskConfig(xi=20, eta=0.0, rebalance_every=3),
                      seed=args.seed, device=device)

    print("fleet before the outage:")
    for host in env.platform.hosts():
        print(f"  {host.host}: {host.capacity['cores']:>4.1f} cores, "
              f"{len(host.services())} services")
    print(f"scripted event: {events[0].kind} of {events[0].host} "
          f"at t={fail_t:.0f}s\n")

    history = env.run(agent, duration_s=args.seconds, events=events)

    pre = [h.fulfillment for h in history
           if not h.explored and h.t <= fail_t]
    post = [h.fulfillment for h in history if h.t > fail_t]
    settled = [h.fulfillment for h in history if h.t > fail_t + 100.0]
    print(f"fulfillment  pre-outage mean: {np.mean(pre):.3f}   "
          f"post-outage dip: {np.min(post):.3f}   "
          f"recovered mean: {np.mean(settled):.3f} "
          f"(violations {violation_rate(settled):.1%})")

    print("fleet after the outage:")
    for host in env.platform.hosts():
        used = sum(host.assignment(s).get("cores", 0.0)
                   for s in host.services())
        print(f"  {host.host}: {used:.2f}/{host.capacity['cores']:.2f} cores "
              f"across {len(host.services())} services")

    # the survivors kept their telemetry history across the evacuation
    horizon = env.t - 50.0
    states = env.platform.window_states(since=horizon, until=env.t)
    print(f"windowed telemetry answers for "
          f"{sum(bool(v) for v in states.values())}"
          f"/{len(env.platform.services())} services after the move")
    return 0


if __name__ == "__main__":
    main()
