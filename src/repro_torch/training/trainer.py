"""The deployment half of ``repro/training/trainer.py``: ``merge_lora``
bakes a fine-tune's LoRA deltas into the expert weights (the checkpoint
``examples/train_melinoe.py`` serves). Pretraining and the MELINOE
fine-tuning loop wait for the training slice."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig


def _copy_dicts(tree):
    return {k: _copy_dicts(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


def merge_lora(cfg: ModelConfig, params, lora, scale: float):
    """A new parameter tree (the input is left as it is; untouched leaves
    are shared) whose expert ``wu``/``wd`` are ``w + scale * a @ b`` cast
    to ``w``'s dtype. The product runs where the adapters live, one
    repeat at a time, and the result goes where ``w`` lives."""
    out = _copy_dicts(params)
    for gi, g in enumerate(cfg.layout):
        gname = f"g{gi}"
        for pi, bname in enumerate(g.pattern):
            if cfg.block_defs[bname].moe is None or f"p{pi}" not in lora.get(gname, {}):
                continue
            ffn = out["groups"][gname][f"p{pi}"]["ffn"]
            lt = lora[gname][f"p{pi}"]
            for t in ("wu", "wd"):
                w = ffn[t]
                merged = torch.empty_like(w)
                for r in range(w.shape[0]):
                    delta = torch.einsum("edk,ekf->edf", lt[t]["a"][r], lt[t]["b"][r])
                    merged[r] = w[r] + (scale * delta).to(w.dtype).to(w.device)
                ffn[t] = merged
    return out
