"""SLSQP (paper-faithful) against the multi-start PGD solver on the same
learned models, at growing service counts: the port's counterpart of
``examples/compare_solvers.py`` (the experiment the paper's Discussion asks
for, "accelerating the solver").

For 1, 2 and 3 replicas of the paper's QR/CV/PC triple (|S| = 3, 6, 9 on 8
cores a replica) it runs the RASK agent (xi = 15) with each backend for
``--seconds`` of simulated time, deciding on ``--device`` (``cuda`` unless
asked for ``cpu``), and prints each backend's median decide ms (the solved
cycles after the first) and mean fulfillment over the last 10 cycles.

    PYTHONPATH=src python -m repro_torch.launch.compare_solvers              # card
    PYTHONPATH=src python -m repro_torch.launch.compare_solvers --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import RASKAgent, RaskConfig
from ..device import resolve_device
from ..env import EdgeEnvironment, paper_knowledge, paper_profiles


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=500.0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    results = {}
    for replicas in (1, 2, 3):
        row = {}
        for backend in ("slsqp", "pgd"):
            env = EdgeEnvironment(list(paper_profiles().values()),
                                  {"cores": 8.0 * replicas},
                                  replicas=replicas, seed=0)
            agent = RASKAgent(env.platform, paper_knowledge(),
                              RaskConfig(xi=15, backend=backend), seed=0,
                              device=device)
            hist = env.run(agent, duration_s=args.seconds)
            rts = [h.runtime_s for h in hist if not h.explored][1:]
            row[backend] = (float(np.median(rts) * 1e3) if rts
                            else float("nan"),
                            float(np.mean([h.fulfillment
                                           for h in hist[-10:]])))
        s, p = row["slsqp"], row["pgd"]
        print(f"|S|={replicas * 3}: slsqp {s[0]:7.1f} ms (f={s[1]:.3f})   "
              f"pgd {p[0]:7.1f} ms (f={p[1]:.3f})   speedup "
              f"x{s[0] / p[0]:.1f}   on {device}")
        results[3 * replicas] = row
    return results


if __name__ == "__main__":
    main()
