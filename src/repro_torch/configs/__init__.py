from .base import (
    SHAPES,
    AttnSpec,
    BlockSpec,
    LayoutGroup,
    MelinoeSpec,
    ModelConfig,
    MoESpec,
    ShapeSpec,
    SSMSpec,
    make_smoke,
)
from .registry import ASSIGNED, PAPER, get_config, list_archs

__all__ = [
    "SHAPES",
    "AttnSpec",
    "BlockSpec",
    "LayoutGroup",
    "MelinoeSpec",
    "ModelConfig",
    "MoESpec",
    "ShapeSpec",
    "SSMSpec",
    "make_smoke",
    "ASSIGNED",
    "PAPER",
    "get_config",
    "list_archs",
]
