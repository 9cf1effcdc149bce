"""Heterogeneous fleet walkthrough: unequal edge devices, one RASK agent
(the counterpart of ``examples/hetero_fleet.py``).

Three devices with very different budgets — a 2-core camera node, a 6-core
hub, a 16-core gateway — run 9 services (3 replicas of the paper's QR/CV/PC
triple) placed proportionally to each device's capacity, under mixed
diurnal / bursty / constant load. The agent, deciding on ``--device``
(``cuda`` unless asked for ``cpu``), solves every device's services
against that device's OWN budget: hosts are grouped into power-of-two
layout buckets (the camera is not padded to the gateway's layout), one
batched solve per bucket, and the emitted plans are per-host feasible by
construction.

After the run, the solver's per-host marginal-fulfillment scores drive a
placement pass: ``agent.rebalance()`` migrates a service only when another
device is decisively better (hysteresis), then rebinds the bucketed solve
to the new topology.

    PYTHONPATH=src python -m repro_torch.launch.hetero_fleet              # card
    PYTHONPATH=src python -m repro_torch.launch.hetero_fleet --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import RASKAgent, RaskConfig, violation_rate
from ..device import resolve_device
from ..env import hetero_environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=900.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    env, knowledge = hetero_environment(replicas=3, duration_s=args.seconds,
                                        seed=args.seed)
    agent = RASKAgent(env.platform, knowledge, RaskConfig(xi=20, eta=0.0),
                      seed=args.seed, device=device)

    print("fleet topology and solver layout buckets:")
    for host in env.platform.hosts():
        key = agent.fleet_problem.bucket_of[host.host]
        print(f"  {host.host}: {host.capacity['cores']:>4.1f} cores, "
              f"{len(host.services())} services -> bucket {key}")

    history = env.run(agent, duration_s=args.seconds)
    post = [h.fulfillment for h in history[20:]]
    clips = sum(1 for h in history if h.receipt
                for o in h.receipt.clipped() if o.reason == "capacity")
    print(f"post-exploration mean fulfillment: {np.mean(post):.3f} "
          f"(violations {violation_rate(post):.1%}, capacity clips {clips})")
    for host in env.platform.hosts():
        used = sum(host.assignment(s).get("cores", 0.0)
                   for s in host.services())
        print(f"  {host.host}: {used:.2f}/{host.capacity['cores']:.2f} cores "
              f"across {len(host.services())} services")

    moves = agent.rebalance()
    print(f"rebalance: {len(moves)} migration(s)"
          + "".join(f"\n  {sid}: {src} -> {dst}" for sid, src, dst in moves))
    if moves:
        tail = env.run(agent, duration_s=200.0)
        print(f"post-rebalance fulfillment: "
              f"{np.mean([h.fulfillment for h in tail]):.3f}")
    return 0


if __name__ == "__main__":
    main()
