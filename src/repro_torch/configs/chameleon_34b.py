"""chameleon-34b [vlm] — early-fusion VQ image tokens [arXiv:2405.09818].

Backbone only: text+image VQ tokens share one 65536 vocab; the VQ-VAE image
tokenizer frontend is a stub (input_specs feeds token ids directly).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab=65536,
    qk_norm=True,            # chameleon stabilizes early fusion with qk-norm
)
