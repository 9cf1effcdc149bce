"""gemma3-1b [dense] — 5:1 local:global attention, 128k [hf:google/gemma-3-1b-pt].

Every 6th layer is global; local layers use a 512-token sliding window.
d_head=256 with 4 query heads (projection 1152 -> 1024, decoupled from
d_model as in the released checkpoint).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_head=256,
    d_ff=6912, vocab=262144,
    qk_norm=True, window=512, local_global_period=6,
    rope_theta=1_000_000.0, tie_embeddings=True,
)
