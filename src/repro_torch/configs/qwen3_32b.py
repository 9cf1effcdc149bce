"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B scaled per assignment]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=25600, vocab=151936,
    qk_norm=True, rope_theta=1_000_000.0,
)
