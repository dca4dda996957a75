"""MELINOE core for the port: the host-side expert cache and the slab
offload engine."""
from .expert_cache import CacheStats, LayerExpertCache, ModelExpertCache
from .offload_engine import (EngineMetrics, ExpertSlab, HardwareProfile,
                             OffloadedMoEEngine)

__all__ = ["CacheStats", "LayerExpertCache", "ModelExpertCache",
           "EngineMetrics", "ExpertSlab", "HardwareProfile",
           "OffloadedMoEEngine"]
