"""Request-load patterns — paper §V-C3, Fig. 7.

Two one-hour patterns extracted from Google Cluster production traces
[45], [46]: *Bursty* (sharp spikes over a low baseline) and *Diurnal*
(smooth daily rise/fall). We regenerate them procedurally with a fixed seed
so experiments are deterministic; both emit a *relative* load in [0, 1] which
callers scale to a service's maximum RPS (100 for QR, 10 for CV in E3; the
PC service sees a constant load).

Past ``duration_s`` the curve repeats periodically (period ``duration_s + 1``
seconds — the sampled curve length).  The seed behavior held the FINAL sample
forever, so multi-hour runs silently lost their diurnal/bursty shape (and
starved any load forecaster of signal); queries inside [0, duration_s] are
byte-identical to the seed's.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Pattern = Callable[[float], float]   # t (seconds) -> rps


def constant(rps: float) -> Pattern:
    return lambda t: float(rps)


def _smooth(x: np.ndarray, k: int) -> np.ndarray:
    kern = np.ones(k) / k
    return np.convolve(x, kern, mode="same")


def diurnal(max_rps: float, duration_s: float = 3600.0, seed: int = 7,
            floor: float = 0.12) -> Pattern:
    """Smooth single-peak daily curve with small measurement jitter (Fig. 7b)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s) + 1
    t = np.linspace(0.0, 1.0, n)
    base = floor + (1.0 - floor) * np.sin(np.pi * t) ** 2
    jitter = _smooth(rng.normal(0.0, 0.05, n), 31)
    curve = np.clip(base + jitter, 0.0, 1.0)

    def pattern(tt: float) -> float:
        i = max(int(tt), 0) % n
        return float(curve[i] * max_rps)

    return pattern


def bursty(max_rps: float, duration_s: float = 3600.0, seed: int = 11,
           floor: float = 0.15, n_bursts: int = 6) -> Pattern:
    """Low baseline with recurring steep bursts to full load (Fig. 7a)."""
    rng = np.random.default_rng(seed)
    n = int(duration_s) + 1
    curve = np.full(n, floor)
    starts = np.sort(rng.uniform(0.03, 0.85, n_bursts)) * duration_s
    for s in starts:
        width = rng.uniform(90.0, 260.0)          # 1.5–4.5 min bursts
        height = rng.uniform(0.7, 1.0)
        i0, i1 = int(s), min(int(s + width), n - 1)
        ramp = int(min(30, (i1 - i0) / 3))        # steep edges
        for i in range(i0, i1):
            edge = min((i - i0) / max(ramp, 1), (i1 - i) / max(ramp, 1), 1.0)
            curve[i] = max(curve[i], floor + (height - floor) * edge)
    jitter = _smooth(rng.normal(0.0, 0.03, n), 11)
    curve = np.clip(curve + jitter, 0.0, 1.0)

    def pattern(tt: float) -> float:
        i = max(int(tt), 0) % n
        return float(curve[i] * max_rps)

    return pattern


PATTERNS = {"bursty": bursty, "diurnal": diurnal}
