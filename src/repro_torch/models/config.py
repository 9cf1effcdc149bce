"""Model configuration — one dataclass covers all 10 assigned families.

A copy of ``repro/models/config.py``: the port imports nothing of the JAX
package, so it keeps its own. The JAX-only execution fields (``remat``,
``attn_impl``, ``ssm_impl``) are kept so configs compare equal field by
field; the port reads none of them (a tensor's device picks the attention
implementation, see ``kernels/ops.py``).

``family`` selects the block program:
  dense   — pre-norm decoder transformer (GQA, optional qk_norm / sliding
            window / local:global interleave)
  moe     — dense skeleton with a routed MoE FFN (optional shared experts)
  ssm     — Mamba2 (SSD) stack, attention-free
  hybrid  — Jamba: periods of [attention, mamba x (attn_period-1)], MoE FFN
            every ``moe_every`` sublayers
  encdec  — Whisper: bidirectional encoder + causal decoder w/ cross-attn
            (conv/mel frontend stubbed — inputs are frame embeddings)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: int = 0               # sliding-window size for local layers (0=full)
    local_global_period: int = 0  # gemma3: every Nth layer is global, rest local

    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1            # MoE FFN every Nth sublayer (jamba: 2)

    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    attn_period: int = 0          # hybrid: one attention layer per period

    # encdec
    encoder_layers: int = 0

    # execution
    dtype: str = "bfloat16"
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "silu"             # silu | gelu
    gated_mlp: bool = True
    tie_embeddings: bool = False
    remat: str = "dots"           # none | dots | full
    attn_impl: str = "reference"  # reference | pallas | pallas_interpret
    ssm_impl: str = "reference"   # reference | pallas | pallas_interpret
    mixed_cache: bool = False     # local:global ring caches (§Perf P3)
    logit_cap: float = 0.0

    # ---- derived ----------------------------------------------------------
    @property
    def d_inner(self) -> int:     # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def kv_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    def n_params(self) -> int:
        """Parameter count (exact for our parameterization; used for 6ND)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.n_heads * self.d_head * 2 \
            + d * self.n_kv_heads * self.d_head * 2
        if self.qk_norm:
            attn += 2 * self.d_head
        dense_ffn = d * f * (3 if self.gated_mlp else 2)
        moe_ffn = self.n_experts * dense_ffn + d * self.n_experts \
            + self.n_shared_experts * dense_ffn
        mamba = (2 * self.d_inner + 2 * self.ssm_state + self.ssm_heads) * d \
            + self.ssm_conv * (self.d_inner + 2 * self.ssm_state) \
            + self.d_inner * d + 2 * self.ssm_heads + self.d_inner
        emb = v * d * (1 if self.tie_embeddings else 2)
        norms = 2 * d * self.n_layers + d

        if self.family == "dense":
            total = self.n_layers * (attn + dense_ffn)
        elif self.family == "moe":
            total = self.n_layers * (attn + moe_ffn)
        elif self.family == "ssm":
            total = self.n_layers * mamba
        elif self.family == "hybrid":
            n_attn = self.n_layers // self.attn_period
            n_mamba = self.n_layers - n_attn
            n_moe = self.n_layers // self.moe_every
            n_dense = self.n_layers - n_moe
            total = n_attn * attn + n_mamba * mamba \
                + n_moe * moe_ffn + n_dense * dense_ffn
        elif self.family == "encdec":
            # encoder self-attn+ffn, decoder self+cross-attn+ffn
            total = self.encoder_layers * (attn + dense_ffn) \
                + self.n_layers * (2 * attn + dense_ffn)
        else:
            raise ValueError(self.family)
        return int(total + emb + norms)

    def n_params_active(self) -> int:
        """Active parameters per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_ffn = d * f * (3 if self.gated_mlp else 2)
        inactive = (self.n_experts - self.top_k) * dense_ffn
        if self.family == "moe":
            n_moe_layers = self.n_layers
        else:
            n_moe_layers = self.n_layers // self.moe_every
        return self.n_params() - n_moe_layers * inactive

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, self.attn_period or 2) if self.family == "hybrid"
            else (self.local_global_period + 1 if self.local_global_period
                  else 2),
            d_model=64,
            n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)), d_head=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16,
            ssm_chunk=16,
            window=min(self.window, 16) if self.window else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            dtype="float32",
            remat="none",
        )
