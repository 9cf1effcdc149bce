"""Architecture and input-shape registry of the port: a copy of
``repro/configs/registry.py``, the assigned 10 x 4 evaluation grid.

``get(arch_id)`` resolves ``--arch`` flags; ``SHAPES`` are the assigned
input shapes; ``cells()`` enumerates the 40 (arch x shape) cells with the
documented skips (DESIGN.md §4):

  * ``long_500k`` requires sub-quadratic attention — runs only for
    mamba2 (SSM), jamba (hybrid; its sparse attention layers get a 4096
    sliding window at this shape), gemma3 (5:1 local:global).
  * decode shapes lower ``serve_step`` (one token against a seq-long KV
    cache); whisper's decode cross-attends a seq-long encoder cache.

All ten configs are registered, and the port builds every one of their
families: dense, MoE, ssm, hybrid (jamba) and encoder-decoder (whisper).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..models.config import ModelConfig
from . import (chameleon_34b, dbrx_132b, gemma3_1b, internlm2_20b,
               jamba_1_5_large_398b, mamba2_370m, mistral_large_123b,
               qwen2_moe_a2_7b, qwen3_32b, whisper_large_v3)

ARCHS: Dict[str, ModelConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (chameleon_34b, mamba2_370m, jamba_1_5_large_398b, dbrx_132b,
              qwen2_moe_a2_7b, internlm2_20b, gemma3_1b, qwen3_32b,
              mistral_large_123b, whisper_large_v3)
}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    sub_quadratic_only: bool = False


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1,
                       sub_quadratic_only=True),
}


def get(arch_id: str) -> ModelConfig:
    key = arch_id.replace("_", "-")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[key]


def sub_quadratic(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid") or cfg.local_global_period > 0


def config_for_shape(cfg: ModelConfig, shape: Shape) -> ModelConfig:
    """Shape-specific config adjustments (documented in DESIGN.md §4)."""
    if shape.name == "long_500k" and cfg.family == "hybrid" and not cfg.window:
        # jamba's rare attention layers use a bounded sliding window at 500k
        cfg = dataclasses.replace(cfg, window=4_096)
    return cfg


def cells(include_skips: bool = False
          ) -> List[Tuple[ModelConfig, Shape, Optional[str]]]:
    """All 40 (arch, shape) cells; skip reason (or None) as third element."""
    out = []
    for cfg in ARCHS.values():
        for shape in SHAPES.values():
            skip = None
            if shape.sub_quadratic_only and not sub_quadratic(cfg):
                skip = "long_500k skipped: pure full-attention arch (DESIGN.md §4)"
            if skip is None or include_skips:
                out.append((config_for_shape(cfg, shape), shape, skip))
    return out
