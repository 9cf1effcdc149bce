"""The simulated Edge device (the port's copies of ``repro/env``): the
paper's and the LM services' profiles, request-load patterns, the one-host
simulator, and the real-serving scenario (``scenarios.py``)."""
from .profiles import (CV_PROFILE, PC_PROFILE, QR_PROFILE, ServiceProfile,
                       lm_profile, paper_knowledge, paper_profiles)
from .scenarios import real_serving_scenario, sim_slo_budget
from .simulator import ContainerPool, CycleRecord, EdgeEnvironment, \
    SimulatedService
from .workloads import bursty, constant, diurnal

__all__ = ["ServiceProfile", "QR_PROFILE", "CV_PROFILE", "PC_PROFILE",
           "lm_profile", "paper_profiles", "paper_knowledge", "ContainerPool",
           "CycleRecord", "EdgeEnvironment", "SimulatedService", "bursty",
           "constant", "diurnal", "real_serving_scenario",
           "sim_slo_budget"]
