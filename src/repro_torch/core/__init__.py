"""The paper's contribution in the port: the MUDAP platform, the
declarative control plane, and the RASK agent whose decide runs on the
card (``regression.py`` fit, ``solver.py`` PGD solve over the hand-written
objective kernel)."""
from .api import (Agent, APPLIED, CLIPPED, CycleResult, DecisionInfo,
                  ParameterOutcome, PlanningAgent, PlanReceipt, REJECTED,
                  ScalingPlan, water_fill)
from .elasticity import ApiDescription, ElasticityParameter, ServiceId
from .platform import MUDAP, ServiceBackend
from .rask import RaskConfig, RASKAgent
from .regression import (BatchedFitPlan, PolynomialModel, StackedModels,
                         polynomial_exponents)
from .slo import SLO, completion, fulfillment, global_fulfillment, \
    service_fulfillment, violation_rate, windowed_violation_rate
from .solver import ServiceSpec, SolverProblem

__all__ = [
    "Agent", "APPLIED", "CLIPPED", "REJECTED", "CycleResult", "DecisionInfo",
    "ParameterOutcome", "PlanningAgent", "PlanReceipt", "ScalingPlan",
    "water_fill", "ApiDescription", "ElasticityParameter", "ServiceId",
    "MUDAP", "ServiceBackend", "RaskConfig", "RASKAgent", "BatchedFitPlan",
    "PolynomialModel", "StackedModels", "polynomial_exponents", "SLO",
    "completion", "fulfillment", "global_fulfillment", "service_fulfillment",
    "violation_rate", "windowed_violation_rate", "ServiceSpec",
    "SolverProblem",
]
