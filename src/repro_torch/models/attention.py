"""Grouped-query attention: projections, prefill attention through the
flash kernel, and single-token decode against a ring KV cache
(counterpart of ``repro/models/attention.py``).

Layouts: x (B, T, d); q (B, T, Hq, hd); k/v (B, S, Hkv, hd).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs.base import AttnSpec
from ..kernels.flash_attn import ops as flash_ops
from .common import apply_rope, dense_init, rms_norm, rms_norm_init, softcap
from .runtime import Runtime

NEG = -1e30


def init_attn(d_model: int, spec: AttnSpec, dtype, *, generator, device, lead=()):
    kw = dict(generator=generator, device=device, lead=lead)
    p = {
        "wq": dense_init(d_model, spec.q_dim, dtype, **kw),
        "wk": dense_init(d_model, spec.kv_dim, dtype, **kw),
        "wv": dense_init(d_model, spec.kv_dim, dtype, **kw),
        "wo": dense_init(spec.q_dim, d_model, dtype, **kw),
    }
    if spec.qk_norm:
        p["q_norm"] = rms_norm_init(spec.head_dim, dtype, device=device, lead=lead)
        p["k_norm"] = rms_norm_init(spec.head_dim, dtype, device=device, lead=lead)
    return p


def _project_qkv(params, spec: AttnSpec, x, positions):
    B, T, _ = x.shape
    q = (x @ params["wq"]).reshape(B, T, spec.n_heads, spec.head_dim)
    k = (x @ params["wk"]).reshape(B, T, spec.n_kv_heads, spec.head_dim)
    v = (x @ params["wv"]).reshape(B, T, spec.n_kv_heads, spec.head_dim)
    if spec.qk_norm:
        q = rms_norm(params["q_norm"], q)
        k = rms_norm(params["k_norm"], k)
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Ring KV cache + single-token decode (plain torch: no TPU kernel here)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, W, Hkv, hd)
    v: torch.Tensor  # (B, W, Hkv, hd)
    slot_pos: torch.Tensor  # (B, W) int32 per row; -1 = empty


def init_kv_cache(batch: int, n_slots: int, spec: AttnSpec, dtype, device) -> KVCache:
    shape = (batch, n_slots, spec.n_kv_heads, spec.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        slot_pos=torch.full((batch, n_slots), -1, dtype=torch.int32, device=device),
    )


def cache_from_prefill(k, v, spec: AttnSpec, n_slots: int) -> KVCache:
    """Build a (possibly ring) cache from prefill K/V of length T."""
    B, T, H, hd = k.shape
    cache = init_kv_cache(B, n_slots, spec, k.dtype, k.device)
    if T <= n_slots:
        cache.k[:, :T] = k
        cache.v[:, :T] = v
        cache.slot_pos[:, :T] = torch.arange(T, dtype=torch.int32, device=k.device)
        return cache
    pos = torch.arange(T - n_slots, T, dtype=torch.int32, device=k.device)
    slots = (pos % n_slots).long()
    cache.k[:, slots] = k[:, -n_slots:]
    cache.v[:, slots] = v[:, -n_slots:]
    cache.slot_pos[:, slots] = pos
    return cache


def decode_attend(params, spec: AttnSpec, x, cache: KVCache, pos,
                  window: Optional[int]):
    """x: (B, 1, d); pos: position of the new token — a scalar (whole
    batch in lockstep) or a (B,) vector (every row at its own position).

    Returns (out (B,1,d), updated cache). The cache tensors are updated
    in place (the port owns them; the JAX version returns new arrays)."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    positions = pos[:, None]  # (B, 1)
    q, k_new, v_new = _project_qkv(params, spec, x, positions)
    W = cache.k.shape[1]
    slot = (pos % W).long()  # (B,)
    rows = torch.arange(B, device=x.device)
    cache.k[rows, slot] = k_new[:, 0]
    cache.v[rows, slot] = v_new[:, 0]
    cache.slot_pos[rows, slot] = pos
    slot_pos = cache.slot_pos

    G = spec.n_heads // spec.n_kv_heads
    qg = q.reshape(B, 1, spec.n_kv_heads, G, spec.head_dim)
    scale = spec.head_dim**-0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), cache.k.float()) * scale
    s = softcap(s, spec.attn_softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])  # (B, W)
    if window is not None:
        valid &= slot_pos > (pos[:, None] - window)
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full((), NEG, device=x.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, cache.v.float())
    o = o.reshape(B, 1, spec.q_dim).to(x.dtype)
    return o @ params["wo"], cache


# ---------------------------------------------------------------------------
# Full attention layer (prefill)
# ---------------------------------------------------------------------------


def attend_full(params, spec: AttnSpec, x, positions, window: Optional[int],
                return_kv=False, rt: Optional[Runtime] = None):
    """x (B,T,d) -> (B,T,d). positions (B,T) absolute, starting at 0.

    Causal attention goes through ``kernels.flash_attn``: the Hopper
    kernel for a CUDA tensor, the plain version for a CPU tensor (or
    under the "ref" backend)."""
    q, k, v = _project_qkv(params, spec, x, positions)
    B, T, Hq, hd = q.shape
    G = Hq // spec.n_kv_heads
    backend = rt.kernel_backend if rt is not None else None
    o = flash_ops.flash(q.reshape(B, T, spec.n_kv_heads, G, hd), k, v,
                        softcap=spec.attn_softcap, window=window,
                        backend=backend)
    out = o.reshape(B, T, spec.q_dim) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out
