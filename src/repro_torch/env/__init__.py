"""The simulated Edge devices (the port's copies of ``repro/env``): the
paper's and the LM services' profiles, request-load patterns, the
simulator over one host or a multi-host fleet with churn events, and the
scenarios (``scenarios.py``: heterogeneous fleets, failover, the churn
grammar, the real-serving scenario)."""
from .profiles import (CV_PROFILE, PC_PROFILE, QR_PROFILE, ServiceProfile,
                       lm_profile, paper_knowledge, paper_profiles)
from .scenarios import (HostSpec, churn_scenario, failover_scenario,
                        hetero_environment,
                        hetero_knowledge, mixed_patterns, parse_churn,
                        real_serving_scenario, sim_slo_budget, tiered_hosts,
                        two_tier_environment, two_tier_hosts)
from .simulator import ChurnEvent, ContainerPool, CycleRecord, \
    EdgeEnvironment, SimulatedService
from .workloads import bursty, constant, diurnal

__all__ = ["ServiceProfile", "QR_PROFILE", "CV_PROFILE", "PC_PROFILE",
           "lm_profile", "paper_profiles", "paper_knowledge", "ChurnEvent",
           "ContainerPool", "CycleRecord", "EdgeEnvironment",
           "SimulatedService", "bursty", "constant", "diurnal", "HostSpec",
           "churn_scenario", "failover_scenario", "hetero_environment", "hetero_knowledge",
           "mixed_patterns", "parse_churn", "real_serving_scenario",
           "sim_slo_budget", "tiered_hosts", "two_tier_environment",
           "two_tier_hosts"]
