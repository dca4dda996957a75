"""Grouped-query attention: projections, prefill attention through the
flash kernel, and single-token decode against a ring KV cache
(counterpart of ``repro/models/attention.py``).

Layouts: x (B, T, d); q (B, T, Hq, hd); k/v (B, S, Hkv, hd).

On a sharded mesh the activations and cache leaves are DTensors (batch
over the data axes, heads over "model"). Attention mixes neither batch
rows nor heads, so each rank attends over its own rows and kv heads
(:func:`_on_shards`: the plain computation on the local tensors, the
output placed as the inputs; the local tensors take the kernels as on
one device) rather than through DTensor's strategies for
the einsums, whose reshapes of sharded dims not every torch release
propagates. The ring write is an elementwise select of the new row into
each rank's cache shard instead of the indexed write of one device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs.base import AttnSpec
from ..kernels.flash_attn import ops as flash_ops
from .common import apply_rope, dense_init, rms_norm, rms_norm_init, softcap
from .runtime import Runtime, is_distributed

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
    """Build a (possibly ring) cache from prefill K/V of length T. DTensor
    K/V (a sharded mesh, sequence unsharded) give a DTensor cache built
    shard by shard: each rank's rows and heads, placed as K's."""
    if is_distributed(k):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        if any(p == Shard(1) for p in k.placements):
            raise ValueError("cache_from_prefill: K/V sharded along the sequence")
        local = cache_from_prefill(k.to_local(), v.to_local(), spec, n_slots)
        rows = [p if p == Shard(0) else Replicate() for p in k.placements]
        return KVCache(*(DTensor.from_local(t, k.device_mesh, pl, run_check=False)
                         for t, pl in zip(local, (k.placements, v.placements, rows))))
    B, T, H, hd = k.shape
    cache = KVCache(k=k.new_zeros((B, n_slots, H, hd)), v=k.new_zeros((B, n_slots, H, hd)),
                    slot_pos=torch.full((B, n_slots), -1, dtype=torch.int32, device=k.device))
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


class _DenseGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous: DTensor views a
    gradient as dense, and the gradient of a shard computed locally (an
    einsum's, permuted) need not be."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _on_shards(fn, q, k, *rest):
    """``fn(q, k, *rest)`` of attention inputs that are DTensors, each rank on
    its own batch rows (dim 0) and kv heads (dim 2 of q, k and v): the
    inputs placed as K on those dims and replicated on the rest (a 2-D
    mask keeps only the rows), ``fn`` on the local tensors, its output (B,
    ., Hkv, ...) placed alike."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = k.device_mesh
    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in k.placements)
    rows = tuple(p if p == Shard(0) else Replicate() for p in pl)
    loc = [t.redistribute(mesh, pl if t.dim() > 2 else rows).to_local()
           for t in (q, k, *rest)]
    loc = [_DenseGrad.apply(t) if t.requires_grad else t for t in loc]
    return DTensor.from_local(fn(*loc).contiguous(), mesh, pl, run_check=False)


def _decode_weights(spec: AttnSpec, qg, k, v, valid):
    """Single-query attention of qg (B, 1, Hkv, G, hd) over the cache rows
    k/v (B, W, Hkv, hd) where ``valid`` (B, W): fp32 scores, softcap,
    softmax, the value product. Returns (B, 1, Hkv, G, hd) fp32."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * spec.head_dim**-0.5
    s = softcap(s, spec.attn_softcap)
    s = torch.where(valid[:, None, None, None, :], s, torch.full((), NEG, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())


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
    if is_distributed(cache.k):
        # each rank writes the rows and heads of its own shard: the new
        # row selected into its slot (no indexed write across shards)
        hit = torch.arange(W, device=x.device)[None, :] == slot[:, None]  # (B, W)
        cache.k.copy_(torch.where(hit[:, :, None, None], k_new, cache.k))
        cache.v.copy_(torch.where(hit[:, :, None, None], v_new, cache.v))
        cache.slot_pos.copy_(torch.where(hit, pos[:, None], cache.slot_pos))
    else:
        rows = torch.arange(B, device=x.device)
        cache.k[rows, slot] = k_new[:, 0]
        cache.v[rows, slot] = v_new[:, 0]
        cache.slot_pos[rows, slot] = pos
    slot_pos = cache.slot_pos

    G = spec.n_heads // spec.n_kv_heads
    qg = q.reshape(B, 1, spec.n_kv_heads, G, spec.head_dim)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])  # (B, W)
    if window is not None:
        valid &= slot_pos > (pos[:, None] - window)
    attend = lambda *t: _decode_weights(spec, *t)  # noqa: E731
    o = (_on_shards(attend, qg, cache.k, cache.v, valid) if is_distributed(cache.k)
         else attend(qg, cache.k, cache.v, valid))
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
    under the "ref" backend; on a sharded mesh, shard by shard, each
    rank's local tensors under ``rt.local()``'s backend)."""
    q, k, v = _project_qkv(params, spec, x, positions)
    B, T, Hq, hd = q.shape
    G = Hq // spec.n_kv_heads
    sharded = is_distributed(q)
    backend = None if rt is None else (rt.local() if sharded else rt).backend
    attend = lambda q_, k_, v_: flash_ops.flash(  # noqa: E731
        q_, k_, v_, softcap=spec.attn_softcap, window=window, backend=backend)
    qg = q.reshape(B, T, spec.n_kv_heads, G, hd)
    o = _on_shards(attend, qg, k, v) if sharded else attend(qg, k, v)
    out = o.reshape(B, T, spec.q_dim) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out
