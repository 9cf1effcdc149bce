from .config import ModelConfig
from .model import Model, build

__all__ = ["ModelConfig", "Model", "build"]
