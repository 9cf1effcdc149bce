"""The paper's contribution in the port: the MUDAP platform and the
multi-host ``Fleet``, the declarative control plane, and the RASK agent
whose decide runs on the card (``regression.py`` fit, ``solver.py`` PGD
solve over the hand-written objective kernel, batched over a fleet's hosts
and placement candidates; the SLSQP reference and the seed's loop
objective beside it). The e3 baselines, VPA and DQN, are in ``agents``."""
from .api import (Agent, APPLIED, CLIPPED, CycleResult, DecisionInfo,
                  ParameterOutcome, PlanningAgent, PlanReceipt, REJECTED,
                  ScalingPlan, water_fill)
from .elasticity import ApiDescription, ElasticityParameter, ServiceId
from .fleet import Fleet
from .platform import MUDAP, ServiceBackend
from .rask import RaskConfig, RASKAgent
from .agents import DQNAgent, DQNConfig, VPAAgent, VPAConfig, \
    dqn_params_from_numpy
from .regression import (BatchedFitPlan, PolynomialModel, StackedModels,
                         fit_polynomial, mse, polynomial_exponents,
                         select_degree, stack_models, train_test_split)
from .slo import SLO, completion, fulfillment, global_fulfillment, \
    service_fulfillment, violation_rate, windowed_violation_rate
from .solver import FleetSolverProblem, PlacementProblem, ServiceSpec, \
    SolverProblem

__all__ = [
    "Agent", "APPLIED", "CLIPPED", "REJECTED", "CycleResult", "DecisionInfo",
    "ParameterOutcome", "PlanningAgent", "PlanReceipt", "ScalingPlan",
    "water_fill", "ApiDescription", "ElasticityParameter", "ServiceId",
    "Fleet", "MUDAP", "ServiceBackend", "RaskConfig", "RASKAgent",
    "DQNAgent", "DQNConfig", "VPAAgent", "VPAConfig", "dqn_params_from_numpy",
    "BatchedFitPlan", "PolynomialModel", "StackedModels", "fit_polynomial",
    "mse", "polynomial_exponents", "select_degree", "stack_models",
    "train_test_split", "SLO",
    "completion", "fulfillment", "global_fulfillment", "service_fulfillment",
    "violation_rate", "windowed_violation_rate", "FleetSolverProblem",
    "PlacementProblem", "ServiceSpec", "SolverProblem",
]
