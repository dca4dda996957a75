"""Block zoo: init/apply for each block kind, full-sequence and decode
(counterpart of ``repro/models/blocks.py``, single device).

``attn_moe`` blocks are initialized here (the offload engine walks them
itself), but the full-model path does not apply them yet: that needs
``moe.make_dispatch``/``apply_moe``, which wait for their own slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import BlockSpec, ModelConfig
from .attention import (attend_full, cache_from_prefill, decode_attend, init_attn,
                        init_kv_cache)
from .common import rms_norm, rms_norm_init
from .mamba2 import (MambaState, apply_mamba_decode, apply_mamba_full, conv_dim,
                     init_mamba)
from .mlp import apply_mlp, init_mlp
from .moe import init_moe
from .runtime import Runtime


def init_block(cfg: ModelConfig, b: BlockSpec, dtype, *, generator, device,
               lead=(), expert_device=None):
    """One block's weights, stacked over ``lead``. ``shared_attn`` blocks
    are initialized once, by the model, into its ``shared`` subtree.
    ``expert_device``: where an ``attn_moe`` block keeps its experts."""
    kw = dict(generator=generator, device=device, lead=lead)
    p = {"ln1": rms_norm_init(cfg.d_model, dtype, device=device, lead=lead)}
    if b.kind == "mamba":
        p["mixer"] = init_mamba(cfg.d_model, b.ssm, dtype, **kw)
        return p
    p["mixer"] = init_attn(cfg.d_model, b.attn, dtype, **kw)
    p["ln2"] = rms_norm_init(cfg.d_model, dtype, device=device, lead=lead)
    if b.kind == "attn_moe":
        p["ffn"] = init_moe(cfg.d_model, b.moe, dtype, expert_device=expert_device, **kw)
    else:
        p["ffn"] = init_mlp(cfg.d_model, b.d_ff, dtype, **kw)
    return p


def effective_window(b: BlockSpec, window_override: Optional[int]) -> Optional[int]:
    if b.attn is None:
        return None
    w = b.attn.window
    if window_override is not None:
        w = min(w, window_override) if w is not None else window_override
    return w


def _no_moe(b: BlockSpec) -> None:
    if b.kind == "attn_moe":
        raise NotImplementedError(
            "attn_moe blocks in the full-model path need make_dispatch/apply_moe, "
            "not ported yet; MoE models are served by core.offload_engine")


def apply_block_full(params, cfg: ModelConfig, b: BlockSpec, x, positions, rt: Runtime,
                     *, window_override: Optional[int] = None, want_cache: bool = False,
                     cache_slots: int = 0) -> tuple:
    """Full-sequence (prefill) application. x (B, T, d). Returns (x, aux);
    ``aux["kv"]`` is the block's cache when ``want_cache``."""
    _no_moe(b)
    aux = {}
    h = rms_norm(params["ln1"], x, cfg.norm_eps)
    if b.kind == "mamba":
        if want_cache:
            y, aux["kv"] = apply_mamba_full(params["mixer"], h, b.ssm,
                                            return_state=True, rt=rt)
        else:
            y = apply_mamba_full(params["mixer"], h, b.ssm, rt=rt)
        return x + y, aux

    w = effective_window(b, window_override)
    if want_cache:
        y, (k, v) = attend_full(params["mixer"], b.attn, h, positions, w,
                                return_kv=True, rt=rt)
        aux["kv"] = cache_from_prefill(k, v, b.attn, cache_slots or k.shape[1])
    else:
        y = attend_full(params["mixer"], b.attn, h, positions, w, rt=rt)
    x = x + y
    h2 = rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(params["ffn"], h2), aux


def apply_block_decode(params, cfg: ModelConfig, b: BlockSpec, x, cache, pos,
                       rt: Runtime, *, window_override: Optional[int] = None) -> tuple:
    """Single-token step. x (B, 1, d); cache is this block's state.
    Returns (x, new cache, aux); an attention block's KV cache is updated
    in place and returned."""
    _no_moe(b)
    h = rms_norm(params["ln1"], x, cfg.norm_eps)
    if b.kind == "mamba":
        y, new_state = apply_mamba_decode(params["mixer"], h, cache, b.ssm)
        return x + y, new_state, {}

    w = effective_window(b, window_override)
    y, new_cache = decode_attend(params["mixer"], b.attn, h, cache, pos, w)
    x = x + y
    h2 = rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(params["ffn"], h2), new_cache, {}


def init_block_cache(cfg: ModelConfig, b: BlockSpec, batch: int, n_slots: int,
                     window_override: Optional[int], dtype, device):
    if b.kind == "mamba":
        s = b.ssm
        return MambaState(
            conv=torch.zeros((batch, s.d_conv - 1, conv_dim(s, cfg.d_model)),
                             dtype=dtype, device=device),
            ssm=torch.zeros((batch, s.n_heads(cfg.d_model), s.head_dim, s.d_state),
                            dtype=torch.float32, device=device))
    w = effective_window(b, window_override)
    slots = min(n_slots, w) if w is not None else n_slots
    return init_kv_cache(batch, slots, b.attn, dtype, device)
