"""Elasticity parameters and the Table-I API description syntax — paper §III-B.

Every managed service exposes *elasticity parameters* in two classes:
resource constraints (e.g. ``cores`` / ``chips``) and service configurations
(e.g. ``data_quality``, ``model_size``). A parameter has bounds, an optional
quantization step (YOLOv8 input must be a multiple of 32; our LM context a
multiple of 128), and the URL endpoint it is exposed under.

``ApiDescription`` is the machine-readable catalogue the scaling agent reads
(paper Table I) — it is deliberately dumb data, so the platform stays
service-agnostic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ElasticityParameter:
    """One scalar knob of one service, with bounds and optional step."""

    name: str                      # query parameter, e.g. "cores"
    strategy: str                  # elasticity strategy, e.g. "resources" | "quality"
    endpoint: str                  # URL endpoint, e.g. "/resources"
    min_value: float
    max_value: float
    step: Optional[float] = None   # quantization (None = continuous float)
    is_resource: bool = False      # participates in the global constraint sum <= C

    def clip(self, value: float) -> float:
        """Clip to bounds and snap to the nearest valid step (paper §III-B:
        'if the assignment exceeds the valid bounds, the value is clipped')."""
        v = min(max(float(value), self.min_value), self.max_value)
        if self.step:
            v = self.min_value + round((v - self.min_value) / self.step) * self.step
            v = min(max(v, self.min_value), self.max_value)
        return v

    @property
    def default(self) -> float:
        """Paper §V-B(c): default assignment is the half range of the bounds."""
        return (self.max_value + self.min_value) / 2.0


@dataclasses.dataclass(frozen=True)
class ServiceId:
    """s = <host, type, c_name> — paper §III-A."""

    host: str
    type: str
    c_name: str

    def __str__(self) -> str:
        return f"{self.host}/{self.type}/{self.c_name}"


@dataclasses.dataclass
class ApiDescription:
    """Table I: per service type, the list of elasticity strategies/parameters."""

    service_type: str
    parameters: List[ElasticityParameter]

    def parameter(self, name: str) -> ElasticityParameter:
        for p in self.parameters:
            if p.name == name:
                return p
        raise KeyError(f"{self.service_type} has no elasticity parameter {name!r}")

    @property
    def names(self) -> List[str]:
        return [p.name for p in self.parameters]

    @property
    def resource_names(self) -> List[str]:
        return [p.name for p in self.parameters if p.is_resource]

    def bounds(self) -> Dict[str, tuple]:
        return {p.name: (p.min_value, p.max_value) for p in self.parameters}

    def defaults(self) -> Dict[str, float]:
        return {p.name: p.default for p in self.parameters}

    def clip_assignment(self, assignment: Dict[str, float]) -> Dict[str, float]:
        return {k: self.parameter(k).clip(v) for k, v in assignment.items()}


def total_resource(assignments: Sequence[Dict[str, float]],
                   apis: Sequence[ApiDescription], resource: str) -> float:
    """sum_i p_i for the shared resource (the constraint of Eq. 3/4)."""
    tot = 0.0
    for a, api in zip(assignments, apis):
        if resource in api.names and api.parameter(resource).is_resource:
            tot += float(a.get(resource, 0.0))
    return tot
