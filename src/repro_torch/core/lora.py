"""LoRA adapters for the expert up/down projections (paper Sec 3.1.1:
rank-32 LoRA on expert up/down), the apply half of
``repro/core/lora.py``.

The tree mirrors ``params["groups"]`` with adapters only at MoE
positions: ``{g: {p: {"wu"|"wd": {"a": (R, E, din, r), "b": (R, E, r,
dout)}}}}``. Each expert's weight acts as ``w + scale * a @ b`` with
``scale = alpha / rank``.

The reference seeds each adapter stream with ``hash((gi, pi, t))``,
which changes with ``PYTHONHASHSEED``; here the streams come one after
another from the caller's generator, so an init is reproducible but is
not the reference's draw (carry a reference tree across with
``bridge.lora_from_jax``). The training half (trainable mask, base
routers) comes with the training slice.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import MelinoeSpec, ModelConfig
from ..models.common import dense_init

LORA_TARGETS = ("wu", "wd")  # expert up / down projections


def lora_scale(spec: MelinoeSpec) -> float:
    return spec.lora_alpha / spec.lora_rank


def init_lora(cfg: ModelConfig, spec: MelinoeSpec, *, generator: torch.Generator,
              dtype=torch.float32, device=None) -> Dict[str, Any]:
    """a ~ truncated N(0, 1/din); b = 0 (the delta starts at zero).
    ``generator`` must live on ``device`` (default: the generator's)."""
    device = torch.device(device or generator.device)
    r = spec.lora_rank
    tree: Dict[str, Any] = {}
    for gi, g in enumerate(cfg.layout):
        gtree: Dict[str, Any] = {}
        for pi, bname in enumerate(g.pattern):
            b = cfg.block_defs[bname]
            if b.moe is None:
                continue
            E, d, f = b.moe.num_experts, cfg.d_model, b.moe.d_ff
            dims = {"wu": (d, f), "wd": (f, d)}
            ptree = {}
            for t in LORA_TARGETS:
                din, dout = dims[t]
                ptree[t] = {
                    "a": dense_init(din, r, dtype, generator=generator, device=device,
                                    lead=(g.repeats, E)),
                    "b": torch.zeros((g.repeats, E, r, dout), dtype=dtype, device=device),
                }
            gtree[f"p{pi}"] = ptree
        tree[f"g{gi}"] = gtree
    return tree
