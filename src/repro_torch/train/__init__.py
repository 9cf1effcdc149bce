from .checkpoint import CheckpointManager
from .optimizer import AdamWConfig, adamw, compressed_adamw

__all__ = ["AdamWConfig", "adamw", "compressed_adamw", "CheckpointManager"]
