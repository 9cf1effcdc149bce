"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7, MoE [arXiv:2403.19887].

Periods of 8 sublayers: [attention, mamba x7]; MoE FFN (16e top-2) on every
other sublayer. 72 layers = 9 periods.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab=65536,
    n_experts=16, top_k=2, moe_every=2,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    attn_period=8,
)
