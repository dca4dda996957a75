"""Block zoo: init/apply for each block kind, full-sequence and decode
(counterpart of ``repro/models/blocks.py``). On a sharded ``Runtime`` the
full-sequence block constrains its residual stream to the batch spec after
the attention and after the FFN, where the reference does.

An ``attn_moe`` block runs its MoE FFN through ``moe.apply_moe`` (the
local path, ``moe_gmm`` for the expert products); with ``want_probs`` its
aux carries the router distribution (B, T, E). Decode forces
``zero_drop``, as the reference does. ``lora`` (one block's adapters,
``{"wu"|"wd": {"a", "b"}}``) is merged into its expert weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..configs.base import BlockSpec, ModelConfig
from .attention import (attend_full, cache_from_prefill, decode_attend, init_attn,
                        init_kv_cache)
from .common import rms_norm, rms_norm_init
from .mamba2 import (MambaState, apply_mamba_decode, apply_mamba_full, conv_dim,
                     init_mamba)
from .mlp import apply_mlp, apply_mlp_sharded, init_mlp
from .moe import apply_moe, init_moe, router_probs
from .runtime import Runtime, is_distributed


def init_block(cfg: ModelConfig, b: BlockSpec, dtype, *, generator, device,
               lead=(), expert_device=None, expert_sink=None):
    """One block's weights, stacked over ``lead``. ``shared_attn`` blocks
    are initialized once, by the model, into its ``shared`` subtree.
    ``expert_device`` / ``expert_sink``: where an ``attn_moe`` block keeps
    its experts, and what takes each drawn matrix (``moe.init_moe``)."""
    kw = dict(generator=generator, device=device, lead=lead)
    p = {"ln1": rms_norm_init(cfg.d_model, dtype, device=device, lead=lead)}
    if b.kind == "mamba":
        p["mixer"] = init_mamba(cfg.d_model, b.ssm, dtype, **kw)
        return p
    p["mixer"] = init_attn(cfg.d_model, b.attn, dtype, **kw)
    p["ln2"] = rms_norm_init(cfg.d_model, dtype, device=device, lead=lead)
    if b.kind == "attn_moe":
        p["ffn"] = init_moe(cfg.d_model, b.moe, dtype, expert_device=expert_device,
                            expert_sink=expert_sink, **kw)
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


def _ffn(params, b: BlockSpec, h2, rt: Runtime, aux: dict, want_probs: bool,
         lora, lora_scale: float):
    """The block's FFN on h2 (B, T, d): the MoE layer for ``attn_moe`` (its
    router distribution into ``aux["probs"]`` and the router's input into
    ``aux["moe_h"]`` when ``want_probs``), else the dense MLP; a
    ``shared_attn`` block's on a mesh with a "model" axis d_ff-parallel
    (``mlp.apply_mlp_sharded``: its weights' placements split ``wg`` and
    ``wu`` along d_model)."""
    if b.kind == "shared_attn" and is_distributed(h2) and rt.model_axis is not None:
        return apply_mlp_sharded(params["ffn"], h2, rt)
    if b.kind != "attn_moe":
        return apply_mlp(params["ffn"], h2)
    B, T, dm = h2.shape
    h2f = h2.reshape(B * T, dm)
    probs = router_probs(params["ffn"], h2f, b.moe)
    y2, _ = apply_moe(params["ffn"], h2f, b.moe, rt, lora=lora, lora_scale=lora_scale,
                      probs=probs)
    if want_probs:
        aux["probs"] = probs.reshape(B, T, -1)
        aux["moe_h"] = h2
    return y2.reshape(B, T, dm)


def apply_block_full(params, cfg: ModelConfig, b: BlockSpec, x, positions, rt: Runtime,
                     *, window_override: Optional[int] = None, want_cache: bool = False,
                     cache_slots: int = 0, want_probs: bool = False, lora=None,
                     lora_scale: float = 1.0) -> tuple:
    """Full-sequence (prefill) application. x (B, T, d). Returns (x, aux);
    ``aux["kv"]`` is the block's cache when ``want_cache``, ``aux["probs"]``
    an ``attn_moe`` block's router distribution and ``aux["moe_h"]`` the
    hidden states fed to its router when ``want_probs``."""
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
    x = rt.constrain(x + y, rt.batch_spec_entry())
    h2 = rms_norm(params["ln2"], x, cfg.norm_eps)
    x = x + _ffn(params, b, h2, rt, aux, want_probs, lora, lora_scale)
    return rt.constrain(x, rt.batch_spec_entry()), aux


def apply_block_decode(params, cfg: ModelConfig, b: BlockSpec, x, cache, pos,
                       rt: Runtime, *, window_override: Optional[int] = None,
                       want_probs: bool = False, lora=None,
                       lora_scale: float = 1.0) -> tuple:
    """Single-token step. x (B, 1, d); cache is this block's state; pos an
    int or a (B,) tensor of per-row positions. Returns (x, new cache,
    aux); an attention block's KV cache is updated in place and returned."""
    aux = {}
    h = rms_norm(params["ln1"], x, cfg.norm_eps)
    if b.kind == "mamba":
        y, new_state = apply_mamba_decode(params["mixer"], h, cache, b.ssm, rt=rt)
        return x + y, new_state, aux

    w = effective_window(b, window_override)
    y, new_cache = decode_attend(params["mixer"], b.attn, h, cache, pos, w)
    x = x + y
    h2 = rms_norm(params["ln2"], x, cfg.norm_eps)
    rt_d = rt if rt.zero_drop else dataclasses.replace(rt, zero_drop=True)
    return (x + _ffn(params, b, h2, rt_d, aux, want_probs, lora, lora_scale),
            new_cache, aux)


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
