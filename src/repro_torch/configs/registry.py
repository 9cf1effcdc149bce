"""Architecture registry of the port: only the configs whose family it runs.

The port runs the dense decoder program and the ssm program, so the
registry holds gemma3-1b and mamba2-370m. Other families join as their
slices are ported (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig
from . import gemma3_1b, mamba2_370m

ARCHS: Dict[str, ModelConfig] = {c.CONFIG.name: c.CONFIG
                                 for c in (gemma3_1b, mamba2_370m)}


def get(arch_id: str) -> ModelConfig:
    key = arch_id.replace("_", "-")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; the port runs: "
                       f"{sorted(ARCHS)}")
    return ARCHS[key]
