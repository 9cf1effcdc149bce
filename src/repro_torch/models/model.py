"""Model facade: the counterpart of ``repro/models/model.py::Model``.

``build(cfg)`` returns a ``Model`` with:
  init(gen) -> params                     # on gen.device
  loss(params, batch) -> (loss, {"ce", "aux"})   # teacher-forced CE
  prefill(params, batch, max_seq, length=None) -> (logits, cache)
  decode(params, tokens, cache) -> (logits, cache)
  init_cache(batch, max_seq, device) -> zeroed cache

The port runs every family of ``repro``: the decoder (dense and MoE, with
gemma3's mixed ring cache under ``mixed_cache``), the ssm program
(Mamba-2), the hybrid (jamba) and the encoder-decoder (whisper, whose
``prefill`` takes ``{"frames", "tokens"}``). ``logit_cap`` is not ported
(no config sets it).

``loss`` is differentiable with ordinary autograd: on the CPU through the
plain kernels, on the card through the backward kernels of attention
(``kernels/flash_attention.py::FlashAttention``) and of the SSD scan
(``kernels/ssd_scan.py::SSDScan``), so an ssm or hybrid loss
differentiates on the card as a decoder's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from . import transformer as T
from .config import ModelConfig

Params = Dict[str, Any]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
ENCDEC_DEC_FRac = 8      # train: decoder tokens = frames // 8, as in repro


def _xent(logits, labels):
    """Mean CE in float32; logits (B,S,V), labels (B,S) integer."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -ll.mean()


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise ValueError(self.cfg.family)
        if self.cfg.logit_cap:
            raise NotImplementedError(
                "logit_cap is not ported (no config the port runs sets it)")

    @property
    def _mixed(self) -> bool:
        return bool(self.cfg.mixed_cache and self.cfg.local_global_period)

    def init(self, gen: torch.Generator) -> Params:
        f = self.cfg.family
        if f == "ssm":
            return T.init_ssm(gen, self.cfg)
        if f == "hybrid":
            return T.init_hybrid(gen, self.cfg)
        if f == "encdec":
            return T.init_encdec(gen, self.cfg)
        return T.init_decoder(gen, self.cfg)

    def loss(self, params: Params, batch) -> Tuple[torch.Tensor, Dict]:
        """Teacher-forced loss: mean CE of ``batch["tokens"]``'s logits
        against ``batch["labels"]`` (the encoder-decoder also takes
        ``"frames"``), plus 0.01 x the MoE load-balancing loss, as in
        ``repro``. Returns (loss, {"ce", "aux"}), float32 scalars."""
        cfg = self.cfg
        if cfg.family == "encdec":
            logits, aux, _ = T.encdec_forward(params, cfg, batch["frames"],
                                              batch["tokens"])
        elif cfg.family == "ssm":
            logits, _ = T.ssm_forward(params, cfg, batch["tokens"])
            aux = 0.0
        elif cfg.family == "hybrid":
            logits, aux, _ = T.hybrid_forward(params, cfg, batch["tokens"])
        else:
            logits, aux, _ = T.decoder_forward(params, cfg, batch["tokens"])
        ce = _xent(logits, batch["labels"])
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def prefill(self, params: Params, batch, max_seq: int, length=None):
        """``batch = {"tokens": (B,S)}`` (and ``"frames": (B,T,d_model)``
        for the encoder-decoder, whose self cache holds 448 positions and
        whose cross cache the T frames, whatever ``max_seq``). ``length``
        supports right-padded prompts on the decoder (attention is causal;
        an MoE FFN routes the pads with the real tokens, as ``repro``'s
        does); the recurrent families would fold pad tokens into their
        state, so they reject it. A mixed cache has no prefill, as in
        ``repro``: it starts from ``init_cache``."""
        cfg = self.cfg
        if length is not None and not self.supports_padded_prefill:
            raise ValueError(
                f"family {cfg.family!r} runs a recurrent prefill; padded "
                "prompts would corrupt its state (no `length` support)")
        if self._mixed:
            raise ValueError(
                "mixed_cache has no prefill (nor has repro's): start from "
                "init_cache and decode from token 0")
        if cfg.family == "encdec":
            return T.encdec_prefill(params, cfg, batch["frames"],
                                    batch["tokens"])
        if cfg.family == "ssm":
            return T.ssm_prefill(params, cfg, batch["tokens"], max_seq)
        if cfg.family == "hybrid":
            return T.hybrid_prefill(params, cfg, batch["tokens"], max_seq)
        return T.decoder_prefill(params, cfg, batch["tokens"], max_seq,
                                 length=length)

    @property
    def supports_padded_prefill(self) -> bool:
        return self.cfg.family in ("dense", "moe")

    def decode(self, params: Params, tokens, cache):
        f = self.cfg.family
        if f == "encdec":
            return T.encdec_decode(params, self.cfg, tokens, cache)
        if f == "ssm":
            return T.ssm_decode(params, self.cfg, tokens, cache)
        if f == "hybrid":
            return T.hybrid_decode(params, self.cfg, tokens, cache)
        if self._mixed:
            return T.decoder_decode_mixed(params, self.cfg, tokens, cache)
        return T.decoder_decode(params, self.cfg, tokens, cache)

    def init_cache(self, batch: int, max_seq: int, device):
        """A zeroed cache; for the encoder-decoder ``max_seq`` is the
        encoder's frame count (its cross cache), as in ``repro``."""
        f = self.cfg.family
        if f == "encdec":
            return T.encdec_init_cache(self.cfg, batch, max_seq, device)
        if f == "ssm":
            return T.ssm_init_cache(self.cfg, batch, max_seq, device)
        if f == "hybrid":
            return T.hybrid_init_cache(self.cfg, batch, max_seq, device)
        if self._mixed:
            return T.decoder_init_cache_mixed(self.cfg, batch, max_seq,
                                              device)
        return T.decoder_init_cache(self.cfg, batch, max_seq, device)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
