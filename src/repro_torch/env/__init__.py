"""The simulated Edge device (the port's copies of ``repro/env``): the
paper's service profiles, request-load patterns and the one-host
simulator."""
from .profiles import (CV_PROFILE, PC_PROFILE, QR_PROFILE, ServiceProfile,
                       paper_knowledge, paper_profiles)
from .simulator import ContainerPool, CycleRecord, EdgeEnvironment, \
    SimulatedService
from .workloads import bursty, constant, diurnal

__all__ = ["ServiceProfile", "QR_PROFILE", "CV_PROFILE", "PC_PROFILE",
           "paper_profiles", "paper_knowledge", "ContainerPool",
           "CycleRecord", "EdgeEnvironment", "SimulatedService", "bursty",
           "constant", "diurnal"]
