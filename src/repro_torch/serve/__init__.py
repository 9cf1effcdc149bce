"""Real serving: the continuous-batching engine of the port."""
from .engine import EngineConfig, Request, ServingEngine, bucket_length

__all__ = ["EngineConfig", "Request", "ServingEngine", "bucket_length"]
