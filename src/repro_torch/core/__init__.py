"""MELINOE core for the port: the host-side expert cache (and its trace
replay, ``simulate_trace``) and the slab offload engine."""
from .expert_cache import (CacheStats, LayerExpertCache, ModelExpertCache,
                           simulate_trace)
from .offload_engine import (EngineMetrics, ExpertSlab, HardwareProfile,
                             OffloadedMoEEngine)

__all__ = ["CacheStats", "LayerExpertCache", "ModelExpertCache", "simulate_trace",
           "EngineMetrics", "ExpertSlab", "HardwareProfile",
           "OffloadedMoEEngine"]
