"""Quickstart: the paper's full loop on the port (the counterpart of
``examples/quickstart.py``).

Builds the simulated Edge device with the paper's three services (QR / CV /
PC, Tables II-III), ``--replicas`` containers of each on 8 cores per
replica (3 replicas: E6's 9 services on one 24-core device), attaches the
RASK agent deciding on ``--device`` (``cuda`` unless asked for ``cpu``),
runs ``--seconds`` of simulated time, and prints the SLO-fulfillment
trajectory.

    PYTHONPATH=src python -m repro_torch.launch.quickstart              # card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import RASKAgent, RaskConfig, violation_rate
from ..device import resolve_device
from ..env import EdgeEnvironment, paper_knowledge, paper_profiles


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. one Edge device with 8 cores per replica of the three services
    env = EdgeEnvironment(list(paper_profiles().values()),
                          {"cores": 8.0 * args.replicas},
                          replicas=args.replicas, seed=args.seed)

    # 2. the RASK agent: 20 exploration cycles, no action noise (paper E1)
    agent = RASKAgent(env.platform, paper_knowledge(),
                      RaskConfig(xi=20, eta=0.0), seed=args.seed,
                      device=device)

    # 3. 1 s ticks; each cycle the environment calls
    #    agent.observe -> agent.decide -> platform.apply_plan
    history = env.run(agent, duration_s=args.seconds)

    fulfillment = [h.fulfillment for h in history]
    print("cycle | fulfillment | explored")
    for h in history[::6]:
        print(f"{int(h.t):5d} | {h.fulfillment:11.3f} | {h.explored}")
    post = fulfillment[agent.cfg.xi:]
    print(f"\npost-exploration mean fulfillment: {np.mean(post):.3f}")
    print(f"violation rate: {violation_rate(post):.1%}")
    clips = sum(len(h.receipt.clipped()) for h in history if h.receipt)
    print(f"plan entries clipped by bounds/capacity arbitration: {clips}")
    solved = [h.runtime_s for h in history if not h.explored]
    if solved:
        print(f"decide on {device}: median {1e3 * np.median(solved):.2f} ms "
              f"over {len(solved)} solved cycles")
    print("final assignments:")
    for sid in env.platform.services():
        print(f"  {sid}: "
              f"{ {k: round(v, 2) for k, v in env.platform.assignment(sid).items()} }")
    return env, agent, history


if __name__ == "__main__":
    main()
