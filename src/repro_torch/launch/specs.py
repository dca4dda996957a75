"""Shape-and-dtype stand-ins for every step input (counterpart of
``repro/launch/specs.py``): the dry run (``launch/dryrun.py``) runs its
steps on these. A stand-in is an empty tensor on ``device``: on ``meta``
(the default) it carries shape and dtype only, the counterpart of
``jax.ShapeDtypeStruct``; under ``FakeTensorMode`` on ``cuda`` it is a fake
tensor of the card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import SHAPES, ModelConfig, ShapeSpec
from ..models.common import cdtype
from ..models.model import init_cache


def decode_window_override(cfg: ModelConfig, shape: ShapeSpec) -> Optional[int]:
    """long_500k on (semi-)dense archs runs the sliding-window variant
    (DESIGN.md Sec 4 long-context policy)."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return cfg.long_context_window
    return None


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *, dtype=None,
                device="meta") -> Dict:
    """The kwargs tree of the step of ``shape.mode`` as empty tensors on
    ``device``. Tokens and labels are int64, the port's token dtype (the
    reference's are int32); ``prefix_embed`` and the cache take ``dtype``
    (the config's by default)."""
    dtype = cdtype(dtype or cfg.dtype)
    B, S = shape.global_batch, shape.seq_len

    def empty(*dims, dt=torch.long):
        return torch.empty(dims, dtype=dt, device=device)

    if shape.mode in ("train", "prefill"):
        specs = {"tokens": empty(B, S)}
        if shape.mode == "train":
            specs["labels"] = empty(B, S)
        if cfg.prefix_len:
            specs["prefix_embed"] = empty(B, cfg.prefix_len, cfg.d_model, dt=dtype)
        return specs
    if shape.mode == "decode":
        cache = init_cache(cfg, B, S, dtype, window_override=decode_window_override(cfg, shape),
                           device=device)
        return {"tokens": empty(B, 1), "cache": cache}
    raise ValueError(shape.mode)


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]
