"""whisper-large-v3 [audio] — enc-dec [arXiv:2212.04356].

Backbone only: the mel/conv frontend is a stub; inputs are precomputed frame
embeddings (B, frames, d_model). 32 encoder + 32 decoder layers, MHA,
LayerNorm + GELU (non-gated), tied decoder embeddings.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_head=64,
    d_ff=5120, vocab=51866,
    encoder_layers=32,
    norm="layernorm", act="gelu", gated_mlp=False, tie_embeddings=True,
    rope_theta=0.0,
)
