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
``bridge.lora_from_jax``).

The training half: :func:`melinoe_trainable_mask` (the router and the
expert gate ``wg`` are trained in full, everything else in the base
params is frozen), :func:`apply_mask` and :func:`extract_base_routers`
(detached copies of the frozen base routers, for rank matching).
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


# ---------------------------------------------------------------------------
# Trainable partition for MELINOE fine-tuning
# ---------------------------------------------------------------------------


def _map_with_path(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def melinoe_trainable_mask(params) -> Any:
    """Bool tree: True for router weights and expert gate projections
    (full update); everything else in the base params is frozen. The
    expert ``wg`` is stacked (R, E, d, f); a dense-MLP ``wg`` (fewer than
    4 dims) stays frozen. LoRA params are trained in full (a separate
    tree)."""

    def mark(path: str, leaf) -> bool:
        if "/ffn/router" in "/" + path:
            return True
        return path.endswith("/ffn/wg") and getattr(leaf, "ndim", 0) >= 4

    return _map_with_path(mark, params)


def apply_mask(tree, mask, frozen_value: float = 0.0):
    """Zero (or scale by ``frozen_value``) leaves where ``mask`` is False —
    used to freeze grads."""
    if isinstance(tree, dict):
        return {k: apply_mask(v, mask[k], frozen_value) for k, v in tree.items()}
    if mask:
        return tree
    return torch.zeros_like(tree) if frozen_value == 0.0 else tree * frozen_value


def extract_base_routers(params, cfg: ModelConfig):
    """Detached copies of the router weights per group/position (stacked
    over repeats; a router given as per-repeat slices is stacked), for the
    same_trajectory rank-matching mode."""
    out = {}
    for gi, g in enumerate(cfg.layout):
        gname = f"g{gi}"
        gout = {}
        for pi, bname in enumerate(g.pattern):
            if cfg.block_defs[bname].moe is None:
                continue
            w = params["groups"][gname][f"p{pi}"]["ffn"]["router"]
            gout[f"p{pi}"] = (torch.stack([x.detach() for x in w]) if isinstance(w, list)
                              else w.detach().clone())
        out[gname] = gout
    return out
