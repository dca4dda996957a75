"""Grouped-query attention: projections, prefill attention through the
flash kernel or the reference's blockwise plain form, and single-token
decode against a ring KV cache (counterpart of
``repro/models/attention.py``).

Layouts: x (B, T, d); q (B, T, Hq, hd); k/v (B, S, Hkv, hd).

Where the ``flash_attn`` kernel does not run (a CPU tensor, the "ref"
backend, every train step: the kernel has no backward), ``attend_full``
takes :func:`flash_attention`, the reference's blockwise form: q chunks of
512 against kv chunks of 1024 with an online softmax, and for a windowed
layer whose keys outrun the window the banded path, each q chunk against
its ``window + bq`` kv slice only. Its memory is linear in T, the
gradient's too: a ``torch.autograd.Function`` keeps q, k, v, the output
and the rows' log-sum-exp, and its backward recomputes each tile
(FlashAttention-2's backward in plain torch). One departure: the
reference ends a q chunk's band at ``(idx + 1) * bq - q_offset``, which
for ``q_offset > 0`` drops keys the chunk sees; here the band ends at the
chunk's last position, ``q_offset + (idx + 1) * bq``.

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

import functools
from typing import NamedTuple, Optional

import torch

from ..configs.base import AttnSpec
from ..kernels import dispatch
from ..kernels.flash_attn import ops as flash_ops
from .common import apply_rope, dense_init, rms_norm, rms_norm_init, softcap
from .runtime import Runtime, is_distributed

NEG = -1e30
PAD_POS = 2 * 10**9  # a padded kv slot's position (the causal test fails) and a padded q row's


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
# Blockwise attention (full sequence: train / prefill; plain torch)
# ---------------------------------------------------------------------------


def _scores(qi, kj, q_pos, k_pos, cap: Optional[float], window: Optional[int],
            keep_tanh: bool = False):
    """One tile's scores: qi (B, bq, Hkv, G, hd) and kj (B, bk, Hkv, hd)
    fp32 -> (s (B, Hkv, G, bq, bk) softcapped, NEG where masked; the mask
    (bq, bk); with ``keep_tanh`` tanh of the capped scores (None without a
    cap)). In place where nothing else reads: a tile is the largest
    tensor here."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj).mul_(qi.shape[-1]**-0.5)
    t = None
    if cap is not None:
        s = s.div_(cap).tanh_()
        t, s = (s, s * cap) if keep_tanh else (None, s.mul_(cap))
    mask = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > (q_pos[:, None] - window)
    return s.masked_fill_(~mask, NEG), mask, t


def _chunk_attend(qi, kj, vj, q_pos, k_pos, cap, window, carry):
    """One (q chunk x kv chunk) online-softmax update of carry = (m, l,
    acc), fp32: m and l (B, Hkv, G, bq), acc (B, Hkv, G, bq, hd)."""
    m, l, acc = carry
    s, _, _ = _scores(qi, kj, q_pos, k_pos, cap, window)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = s.sub_(m_new[..., None]).exp_()
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vj)
    return m_new, l_new, acc_new


class _Tiles(NamedTuple):
    """The reference's tiling of T queries at ``q_offset`` against S keys.
    q is padded to ``nq`` chunks of ``bq`` rows (position PAD_POS). k and v
    lie in one fp32 layout of ``n`` slots (:func:`_kv_layout`, positions
    ``pos``): on the banded path ``front`` = window + bq PAD_POS slots
    before them, and at the end as many as the last kv chunk needs.
    ``spans[i]``: q chunk i's kv [lo, hi) in that layout, read in chunks of
    ``bk`` from lo; a chunk's slots past hi count as padding (PAD_POS), as
    in the reference, which pads each slice. Unlike the reference's, a
    chunk is no longer than the keys it covers (``bk`` at most S, or
    window + bq): the reference pads S = 128 to 1024 slots, whose scores
    are masked and change no row that sees a key, at 8 x the tile's bytes
    and operations."""
    bq: int
    nq: int
    bk: int
    front: int
    n: int
    q_pos: torch.Tensor
    pos: torch.Tensor
    spans: tuple


def _tiles(T: int, S: int, dev, q_offset: int, window: Optional[int], bq: int,
           bk: int) -> _Tiles:
    bq = min(bq, T)
    nq = -(-T // bq)
    q_pos = torch.full((nq * bq,), PAD_POS, dtype=torch.long, device=dev)
    q_pos[:T] = q_offset + torch.arange(T, device=dev)
    if window is not None and S > window + bq:  # banded
        wb = window + bq
        front, bk = wb, min(bk, wb)
        # the band ends just past the chunk's last q position, or at S (the
        # reference subtracts q_offset here: its sign error)
        spans = tuple((e, e + wb) for e in
                      (min(max(q_offset + (i + 1) * bq, 0), S) for i in range(nq)))
        n = S + wb + (-wb) % bk
    else:
        front, spans, bk = 0, ((0, S),) * nq, min(bk, S)
        n = S + (-S) % bk
    pos = torch.full((n,), PAD_POS, dtype=torch.long, device=dev)
    pos[front:front + S] = torch.arange(S, device=dev)
    return _Tiles(bq, nq, bk, front, n, q_pos, pos, spans)


def _kv_layout(t, tl: _Tiles):
    """t (B, S, Hkv, hd) in the tiles' fp32 layout: t itself (cast to
    fp32) where the layout pads nothing, else a padded copy."""
    B, S, Hkv, hd = t.shape
    if tl.front == 0 and tl.n == S:
        return t.float()
    out = t.new_zeros((B, tl.n, Hkv, hd), dtype=torch.float32)
    out[:, tl.front:tl.front + S] = t
    return out


def _kv_chunks(tl: _Tiles, kf, vf, i: int):
    """(start, k, v, positions) of q chunk i's kv chunks in the layout."""
    lo, hi = tl.spans[i]
    for a in range(lo, hi, tl.bk):
        b = a + tl.bk
        pj = tl.pos[a:b]
        if b > hi:
            pj = torch.where(torch.arange(a, b, device=pj.device) < hi, pj, PAD_POS)
        yield a, kf[:, a:b], vf[:, a:b], pj


def _q_rows(t, tl: _Tiles, i: int):
    """Rows [i bq, (i + 1) bq) of t (B, T, ...) in fp32, zeros past T."""
    rows = t[:, i * tl.bq:(i + 1) * tl.bq].float()
    short = tl.bq - rows.shape[1]
    if short:
        rows = torch.cat([rows, rows.new_zeros((rows.shape[0], short, *rows.shape[2:]))], 1)
    return rows


def _flash_q_chunk(qi, tl: _Tiles, kf, vf, i: int, cap, window):
    """Attend q chunk i (qi fp32 (B, bq, Hkv, G, hd)) against its kv chunks.
    Returns (out (B, Hkv, G, bq, hd), log-sum-exp (B, Hkv, G, bq)), fp32."""
    B, bq, Hkv, G, hd = qi.shape
    m = qi.new_full((B, Hkv, G, bq), NEG)
    l = qi.new_zeros((B, Hkv, G, bq))
    acc = qi.new_zeros((B, Hkv, G, bq, hd))
    qp = tl.q_pos[i * bq:(i + 1) * bq]
    for _, kj, vj, pj in _kv_chunks(tl, kf, vf, i):
        m, l, acc = _chunk_attend(qi, kj, vj, qp, pj, cap, window, (m, l, acc))
    return acc / l.clamp_min(1e-30)[..., None], m + torch.log(l)


class _Blockwise(torch.autograd.Function):
    """:func:`blockwise_attention`: the forward keeps q, k, v, the fp32
    output and each row's log-sum-exp (O(T)); the backward recomputes each
    tile's probabilities from them and accumulates dq, dk and dv tile by
    tile, through the softcap's tanh and the mask."""

    @staticmethod
    def forward(ctx, q, k, v, cap, window, q_offset, bq, bk):
        T = q.shape[1]
        tl = _tiles(T, k.shape[1], k.device, q_offset, window, bq, bk)
        kf, vf = _kv_layout(k, tl), _kv_layout(v, tl)
        outs, lses = zip(*(_flash_q_chunk(_q_rows(q, tl, i), tl, kf, vf, i, cap, window)
                           for i in range(tl.nq)))
        o = torch.cat(outs, dim=3)[:, :, :, :T].permute(0, 3, 1, 2, 4).contiguous()
        ctx.save_for_backward(q, k, v, o, torch.cat(lses, dim=3))
        ctx.args = (cap, window, q_offset, bq, bk)
        return o.to(k.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        cap, window, q_offset, bq, bk = ctx.args
        # the positions made again: kept in ctx, every layer's would stay
        # alive until that layer's backward
        tl = _tiles(q.shape[1], k.shape[1], k.device, q_offset, window, bq, bk)
        kf, vf = _kv_layout(k, tl), _kv_layout(v, tl)
        dkf = kf.new_zeros((k.shape[0], tl.n, *k.shape[2:]))
        dvf = torch.zeros_like(dkf)
        dqs = []
        for i in range(tl.nq):
            qi, doi = _q_rows(q, tl, i), _q_rows(do, tl, i)
            rows = slice(i * tl.bq, (i + 1) * tl.bq)
            di = (doi * _q_rows(o, tl, i)).sum(-1).permute(0, 2, 3, 1)  # (B, Hkv, G, bq)
            lse_i = lse[..., rows]
            dqi = torch.zeros_like(qi)
            for a, kj, vj, pj in _kv_chunks(tl, kf, vf, i):
                s, mask, t = _scores(qi, kj, tl.q_pos[rows], pj, cap, window, True)
                p = s.sub_(lse_i[..., None]).exp_()
                dvf[:, a:a + tl.bk] += torch.einsum("bhgqk,bqhgd->bkhd", p, doi)
                ds = torch.einsum("bqhgd,bkhd->bhgqk", doi, vj).sub_(di[..., None]).mul_(p)
                del p, s
                if t is not None:  # d(cap tanh(x / cap)) / dx = 1 - tanh^2
                    ds.mul_(t.square_().neg_().add_(1.0))
                    del t
                ds = ds.masked_fill_(~mask, 0.0).mul_(qi.shape[-1]**-0.5)
                dqi += torch.einsum("bhgqk,bkhd->bqhgd", ds, kj)
                dkf[:, a:a + tl.bk] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qi)
            dqs.append(dqi)
        S, f = k.shape[1], tl.front
        dq = torch.cat(dqs, dim=1)[:, :q.shape[1]]
        return (dq.to(q.dtype), dkf[:, f:f + S].to(k.dtype), dvf[:, f:f + S].to(v.dtype),
                None, None, None, None, None)


def blockwise_attention(q, k, v, *, softcap: Optional[float] = None,
                        window: Optional[int] = None, q_offset: int = 0,
                        bq: int = 512, bk: int = 1024):
    """Causal blockwise GQA attention, the reference's plain form (the
    module's docstring), on the flash kernel's layout: q (B, T, Hkv, G, hd),
    k/v (B, S, Hkv, hd) -> (B, T, Hkv, G, hd) in k's dtype; q row t at
    position ``q_offset + t``, key s at s."""
    return _Blockwise.apply(q, k, v, softcap, window, int(q_offset), bq, bk)


def flash_attention(q, k, v, spec: AttnSpec, *, q_offset: int = 0,
                    window: Optional[int] = None, bq: int = 512, bk: int = 1024):
    """Causal blockwise attention. q (B, T, Hq, hd), k/v (B, S, Hkv, hd) ->
    (B, T, Hq, hd) in k's dtype (:func:`blockwise_attention`).

    ``q_offset``: position of q[0] relative to k[0] (prefix decode).
    Windowed layers take the *banded* path: each q chunk only sees the
    ``window + bq`` KV slice that can pass the mask."""
    B, T, Hq, hd = q.shape
    qg = q.reshape(B, T, spec.n_kv_heads, Hq // spec.n_kv_heads, hd)
    return blockwise_attention(qg, k, v, softcap=spec.attn_softcap, window=window,
                               q_offset=q_offset, bq=bq, bk=bk).reshape(B, T, Hq, hd)


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

    Causal attention goes through the ``flash_attn`` Hopper kernel for a
    CUDA tensor, else (a CPU tensor, the "ref" backend) through
    :func:`blockwise_attention`; on a sharded mesh shard by shard, each
    rank's local tensors under ``rt.local()``'s backend."""
    q, k, v = _project_qkv(params, spec, x, positions)
    B, T, Hq, hd = q.shape
    G = Hq // spec.n_kv_heads
    sharded = is_distributed(q)
    backend = None if rt is None else (rt.local() if sharded else rt).backend
    attend = (flash_ops.flash_hopper if dispatch.use_kernel("flash_attn", backend, q.device)
              else blockwise_attention)
    attend = functools.partial(attend, softcap=spec.attn_softcap, window=window)
    qg = q.reshape(B, T, spec.n_kv_heads, G, hd)
    o = _on_shards(attend, qg, k, v) if sharded else attend(qg, k, v)
    out = o.reshape(B, T, spec.q_dim) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out
