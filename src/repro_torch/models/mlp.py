"""Gated (SwiGLU) dense MLP (counterpart of ``repro/models/mlp.py``)."""
from __future__ import annotations

from .common import dense_init, silu


def init_mlp(d_model: int, d_ff: int, dtype, *, generator, device, lead=()):
    kw = dict(generator=generator, device=device, lead=lead)
    return {
        "wg": dense_init(d_model, d_ff, dtype, **kw),
        "wu": dense_init(d_model, d_ff, dtype, **kw),
        "wd": dense_init(d_ff, d_model, dtype, **kw),
    }


def apply_mlp(params, x):
    h = silu(x @ params["wg"]) * (x @ params["wu"])
    return h @ params["wd"]
