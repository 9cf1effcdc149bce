"""Fleet quickstart: one RASK agent scaling 9 services across 3 edge
devices (the counterpart of ``examples/fleet_autoscale.py``).

Each device runs one QR + one CV + one PC container and has its own 8-core
budget; the agent optimizes against the fleet-aggregate constraint,
deciding on ``--device`` (``cuda`` unless asked for ``cpu``), and every
cycle's ``ScalingPlan`` is split by placement and arbitrated per device
(water-filling), with the merged ``PlanReceipt`` reporting any clips.

    PYTHONPATH=src python -m repro_torch.launch.fleet_autoscale              # card
    PYTHONPATH=src python -m repro_torch.launch.fleet_autoscale --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import RASKAgent, RaskConfig, violation_rate
from ..device import resolve_device
from ..env import EdgeEnvironment, paper_knowledge, paper_profiles


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 3 replicas of the paper triple, placed round-robin over 3 devices
    env = EdgeEnvironment(list(paper_profiles().values()), {"cores": 8.0},
                          replicas=3, hosts=3, seed=args.seed)
    print(f"{len(env.platform.services())} services on "
          f"{len(env.platform.hosts())} hosts, "
          f"aggregate capacity {env.platform.capacity}")

    agent = RASKAgent(env.platform, paper_knowledge(),
                      RaskConfig(xi=20, eta=0.0), seed=args.seed,
                      device=device)
    history = env.run(agent, duration_s=args.seconds)

    post = [h.fulfillment for h in history[20:]]
    clips = sum(1 for h in history if h.receipt
                for o in h.receipt.clipped() if o.reason == "capacity")
    print(f"post-exploration mean fulfillment: {np.mean(post):.3f} "
          f"(violations {violation_rate(post):.1%}, capacity clips {clips})")
    for host in env.platform.hosts():
        used = sum(host.assignment(s).get("cores", 0.0)
                   for s in host.services())
        print(f"  {host.host}: {used:.2f}/8.00 cores across "
              f"{len(host.services())} services")
    return 0


if __name__ == "__main__":
    main()
