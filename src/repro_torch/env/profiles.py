"""Service profiles: the paper's QR / CV / PC services (Tables II & III) —
the port's copy of ``repro/env/profiles.py``. ``lm_profile`` and its rate
model wait for the LM-serving loop (ROADMAP slice D).

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Sequence

from ..core.elasticity import ApiDescription, ElasticityParameter
from ..core.slo import SLO


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
