"""Service profiles: the paper's QR / CV / PC services (Tables II & III)
plus LM-serving profiles — the port's copy of ``repro/env/profiles.py``.

A profile bundles what MUDAP needs to register a service (ApiDescription,
SLOs, Table-III defaults, default RPS) with the simulator-only *hidden ground
truth*: a ``tp_max`` response surface mapping the current elasticity
parameters to the maximum sustainable throughput (items/s). Agents never see
the surface — they observe only scraped metrics, exactly as in the paper.

Paper surfaces are chosen to reproduce the qualitative structure of Fig. 6:
 * QR — strong parallel scaling; throughput falls super-linearly with frame
   size (quality SLO >= 800 px conflicts with completion at peak load);
 * CV — near-linear in all three dims (its best regression in Table IV is
   delta=1); at SLO-level quality/model-size the device cannot reach peak
   RPS, so quality *must* be traded (the E3 narrative);
 * PC — poor parallelization ("throughput is always highly impacted by data
   quality and cores, except for the PC service, which indicates poor
   parallelization") — nearly flat in cores.

LM surfaces are roofline-derived: tokens/s/chip from the bf16 compute bound
vs the HBM weight-streaming bound of the (possibly down-rung'd) model, with
an optional calibration dict of measured rates overriding the analytic
ones. The port rates a "chip" as one NVIDIA H100 (``repro`` rates a TPU).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Sequence

from ..core.elasticity import ApiDescription, ElasticityParameter
from ..core.slo import SLO

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate and HBM3 bandwidth
PEAK_FLOPS = 989e12          # bf16 / chip
HBM_BW = 3.35e12             # bytes/s / chip


@dataclasses.dataclass(frozen=True)
class ServiceProfile:
    type: str
    api: ApiDescription
    slos: Sequence[SLO]
    defaults: Mapping[str, float]        # Table III
    default_rps: float
    tp_max: Callable[[Mapping[str, float]], float]   # hidden ground truth
    knowledge: Mapping[str, Sequence[str]]           # Eq. (7) relation(s)
    parallel_eff: float = 0.9            # cores actually used when saturated


def _api(service_type: str, params) -> ApiDescription:
    return ApiDescription(service_type, [ElasticityParameter(*p) for p in params])


# --------------------------------------------------------------------------
# Paper services — Table II (ranges, SLOs, weights, steps), Table III (defaults)
# --------------------------------------------------------------------------

QR_PROFILE = ServiceProfile(
    type="qr-detector",
    api=_api("qr-detector", [
        # name, strategy, endpoint, min, max, step, is_resource
        ("cores", "resources", "/resources", 0.1, 8.0, None, True),
        ("data_quality", "quality", "/quality", 100.0, 1000.0, 1.0, False),
    ]),
    slos=(SLO("data_quality", 800.0, 0.5), SLO("completion", 1.0, 1.0)),
    defaults={"cores": 2.6, "data_quality": 550.0},
    default_rps=80.0,
    tp_max=lambda p: 40.0 * p["cores"] ** 0.85
    * (550.0 / max(p["data_quality"], 1.0)) ** 1.6,
    knowledge={"tp_max": ("cores", "data_quality")},
    parallel_eff=0.95,
)

_YOLO_RUNGS = {1: 1.0, 2: 2.6, 3: 6.7, 4: 14.3}   # n/s/m/l relative cost


def _cv_tp(p: Mapping[str, float]) -> float:
    rung = min(max(p["model_size"], 1.0), 4.0)
    lo = int(math.floor(rung))
    hi = int(math.ceil(rung))
    cost = _YOLO_RUNGS[lo] + (rung - lo) * (_YOLO_RUNGS[hi] - _YOLO_RUNGS[lo])
    return 2.2 * p["cores"] * (224.0 / max(p["data_quality"], 1.0)) ** 2 \
        * (_YOLO_RUNGS[3] / cost)


CV_PROFILE = ServiceProfile(
    type="cv-analyzer",
    api=_api("cv-analyzer", [
        ("cores", "resources", "/resources", 0.1, 8.0, None, True),
        ("data_quality", "quality", "/quality", 128.0, 320.0, 32.0, False),
        ("model_size", "quality", "/model", 1.0, 4.0, 1.0, False),
    ]),
    slos=(SLO("data_quality", 288.0, 0.2), SLO("model_size", 3.0, 0.2),
          SLO("completion", 1.0, 1.0)),
    defaults={"cores": 2.6, "data_quality": 224.0, "model_size": 3.0},
    default_rps=5.0,
    tp_max=_cv_tp,
    knowledge={"tp_max": ("cores", "data_quality", "model_size")},
    parallel_eff=0.9,
)

PC_PROFILE = ServiceProfile(
    type="pc-visualizer",
    api=_api("pc-visualizer", [
        ("cores", "resources", "/resources", 0.1, 8.0, None, True),
        ("data_quality", "quality", "/quality", 6.0, 60.0, 1.0, False),
    ]),
    slos=(SLO("data_quality", 40.0, 0.5), SLO("completion", 1.0, 1.0)),
    defaults={"cores": 2.6, "data_quality": 30.0},
    default_rps=50.0,
    tp_max=lambda p: 85.0 * p["cores"] ** 0.12
    * (30.0 / max(p["data_quality"], 1.0)) ** 1.1,
    knowledge={"tp_max": ("cores", "data_quality")},
    parallel_eff=0.35,      # "indicates poor parallelization"
)


def paper_profiles() -> Dict[str, ServiceProfile]:
    return {"qr-detector": QR_PROFILE, "cv-analyzer": CV_PROFILE,
            "pc-visualizer": PC_PROFILE}


def paper_knowledge() -> Dict[str, Dict[str, Sequence[str]]]:
    """Structural knowledge K (Eq. 7) for the paper's three service types."""
    return {p.type: dict(p.knowledge) for p in paper_profiles().values()}


# --------------------------------------------------------------------------
# LM-serving profiles
# --------------------------------------------------------------------------

_RUNG_FRACTION = {1: 0.25, 2: 0.5, 3: 0.75, 4: 1.0}   # depth/quant rung -> N_eff/N


def _lm_rate_tokens_per_chip(n_params: float, rung: float,
                             batch_eff: float = 32.0,
                             mfu: float = 0.5, mbu: float = 0.7) -> float:
    """Roofline decode rate per chip: min(compute bound, weight-streaming bound)."""
    lo = int(math.floor(min(max(rung, 1.0), 4.0)))
    hi = int(math.ceil(min(max(rung, 1.0), 4.0)))
    fr = _RUNG_FRACTION[lo] + (rung - lo) * (_RUNG_FRACTION[hi] - _RUNG_FRACTION[lo])
    n_eff = n_params * fr
    compute = PEAK_FLOPS * mfu / (2.0 * n_eff)
    memory = HBM_BW * mbu * batch_eff / (2.0 * n_eff)      # bf16 weights
    return min(compute, memory)


def lm_profile(name: str, n_params: float, *, default_rps: float = 4.0,
               max_chips: float = 16.0, out_tokens: float = 256.0,
               context_slo: float = 8192.0, rung_slo: float = 3.0,
               calibration: Optional[Mapping[int, float]] = None
               ) -> ServiceProfile:
    """Profile for one LM service (arch ``name`` with ``n_params`` weights).

    calibration: optional {rung: tokens/s/chip} measured rates; overrides
    the analytic rate.
    """

    def tp(p: Mapping[str, float]) -> float:
        rung = min(max(p["rung"], 1.0), 4.0)
        if calibration:
            lo, hi = int(math.floor(rung)), int(math.ceil(rung))
            rate = calibration[lo] + (rung - lo) * (calibration[hi] -
                                                    calibration[lo])
        else:
            rate = _lm_rate_tokens_per_chip(n_params, rung)
        # request cost in decode-token equivalents: generated tokens plus the
        # prefill of `context` tokens (compute-bound, ~20x cheaper per token)
        req_cost = out_tokens + 0.05 * p["context"]
        chips = max(p["chips"], 1e-3)
        return chips * rate / req_cost

    return ServiceProfile(
        type=name,
        api=_api(name, [
            ("chips", "resources", "/resources", 0.25, max_chips, None, True),
            ("context", "quality", "/quality", 2048.0, 32768.0, 128.0, False),
            ("rung", "quality", "/model", 1.0, 4.0, 1.0, False),
        ]),
        slos=(SLO("context", context_slo, 0.5), SLO("rung", rung_slo, 0.2),
              SLO("completion", 1.0, 1.0)),
        defaults={"chips": max_chips / 3.0, "context": 16384.0, "rung": 3.0},
        default_rps=default_rps,
        tp_max=tp,
        knowledge={"tp_max": ("chips", "context", "rung")},
        parallel_eff=0.85,
    )
