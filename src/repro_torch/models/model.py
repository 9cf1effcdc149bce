"""Model facade: the counterpart of ``repro/models/model.py::Model``.

``build(cfg)`` returns a ``Model`` with:
  init(gen) -> params                     # on gen.device
  prefill(params, batch, max_seq, length=None) -> (logits, cache)
  decode(params, tokens, cache) -> (logits, cache)
  init_cache(batch, max_seq, device) -> zeroed cache

The port runs the decoder program (dense and MoE) and the ssm program
(Mamba-2). The hybrid and encoder-decoder families raise
``NotImplementedError`` naming the ROADMAP item that ports each.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from . import transformer as T
from .config import ModelConfig

Params = Dict[str, Any]

_NOT_PORTED = {
    "hybrid": "ROADMAP Queue 1, item 13b (hybrid: jamba, Mamba-2 and "
              "attention with the MoE FFN)",
    "encdec": "ROADMAP Queue 1, item 13a (encoder-decoder: whisper, "
              "cross-attention and mixed_cache)",
}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family in _NOT_PORTED:
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet: "
                f"{_NOT_PORTED[self.cfg.family]}")
        if self.cfg.family not in ("dense", "moe", "ssm"):
            raise ValueError(self.cfg.family)
        if self.cfg.mixed_cache or self.cfg.logit_cap:
            raise NotImplementedError(
                "mixed_cache and logit_cap are not ported (no config the "
                "port runs sets them)")

    def init(self, gen: torch.Generator) -> Params:
        if self.cfg.family == "ssm":
            return T.init_ssm(gen, self.cfg)
        return T.init_decoder(gen, self.cfg)

    def prefill(self, params: Params, batch, max_seq: int, length=None):
        """``batch = {"tokens": (B,S)}``; ``length`` supports right-padded
        prompts on the decoder (attention is causal; an MoE FFN routes the
        pads with the real tokens, as ``repro``'s does). The ssm program is
        recurrent and would fold pad tokens into its state, so it rejects
        ``length``."""
        cfg = self.cfg
        if length is not None and not self.supports_padded_prefill:
            raise ValueError(
                f"family {cfg.family!r} runs a recurrent prefill; padded "
                "prompts would corrupt its state (no `length` support)")
        if cfg.family == "ssm":
            return T.ssm_prefill(params, cfg, batch["tokens"], max_seq)
        return T.decoder_prefill(params, cfg, batch["tokens"], max_seq,
                                 length=length)

    @property
    def supports_padded_prefill(self) -> bool:
        return self.cfg.family in ("dense", "moe")

    def decode(self, params: Params, tokens, cache):
        if self.cfg.family == "ssm":
            return T.ssm_decode(params, self.cfg, tokens, cache)
        return T.decoder_decode(params, self.cfg, tokens, cache)

    def init_cache(self, batch: int, max_seq: int, device):
        if self.cfg.family == "ssm":
            return T.ssm_init_cache(self.cfg, batch, max_seq, device)
        return T.decoder_init_cache(self.cfg, batch, max_seq, device)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
