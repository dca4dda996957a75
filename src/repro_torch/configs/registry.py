"""Architecture registry: ``--arch <id>`` resolves through here. An id
``<arch>-<N>l`` names ``<arch>`` cut to its first N layers (``cut_layers``),
so that a process handed the name (a fleet worker, a spawned child)
resolves the same cut."""
from __future__ import annotations

import dataclasses
import importlib
import re
from typing import Callable, Dict

from .base import ModelConfig, make_smoke

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}

# module name per arch id (one file per assigned architecture + paper's own)
_MODULES = {
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    # paper's own backbones (reproduction targets)
    "olmoe": "repro_torch.configs.olmoe",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "phi35-moe": "repro_torch.configs.phi35_moe",
    # reduced reproduction workhorse
    "olmoe-mini": "repro_torch.configs.olmoe_mini",
}

ASSIGNED = tuple(list(_MODULES)[:10])
PAPER = ("olmoe", "mixtral-8x7b", "phi35-moe")


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


_CUT = re.compile(r"(?P<base>.+)-(?P<layers>[0-9]+)l")


def cut_layers(cfg: ModelConfig, layers: int) -> ModelConfig:
    """``cfg`` (one layout group) cut to its first ``layers`` layers, a
    whole number of its pattern's repeats, named ``<name>-<layers>l``."""
    (g,) = cfg.layout
    if not 0 < layers <= cfg.n_layers or layers % len(g.pattern):
        raise ValueError(f"{cfg.name}: {layers} layers is not a whole number of "
                         f"{g.pattern} repeats up to {cfg.n_layers}")
    return dataclasses.replace(cfg, name=f"{cfg.name}-{layers}l", layout=(
        dataclasses.replace(g, repeats=layers // len(g.pattern)),))


def get_config(name: str) -> ModelConfig:
    smoke = name.endswith("-smoke")
    base = name[: -len("-smoke")] if smoke else name
    cut = _CUT.fullmatch(name)
    if base not in _REGISTRY and base not in _MODULES and cut:
        return cut_layers(get_config(cut["base"]), int(cut["layers"]))
    if base not in _REGISTRY:
        if base not in _MODULES:
            raise KeyError(f"unknown arch {base!r}; known: {sorted(_MODULES)}")
        importlib.import_module(_MODULES[base])
    cfg = _REGISTRY[base]()
    cfg.validate()
    if smoke:
        cfg = make_smoke(cfg)
        cfg.validate()
    return cfg


def list_archs():
    return sorted(_MODULES)
