"""Real serving: continuous-batching engines + the MUDAP-managed LM service
(the port's ``repro/serve``)."""
from .engine import (DictCacheEngine, EngineConfig, Request, ServingEngine,
                     bucket_length)
from .loop import ServeCycleRecord, run_serving_loop
from .service import ServedLMService, rung_config, served_lm_profile

__all__ = ["DictCacheEngine", "EngineConfig", "Request", "ServingEngine",
           "bucket_length", "ServeCycleRecord", "run_serving_loop",
           "ServedLMService", "rung_config", "served_lm_profile"]
