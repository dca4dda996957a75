"""Mamba2 (SSD, state-space duality) mixer — arXiv:2405.21060
(counterpart of ``repro/models/mamba2.py``).

Chunked dual form for prefill, through ``kernels/ssd_scan``'s wrapper:
the Hopper kernel on a CUDA tensor, the plain chunked form otherwise;
O(1)-state recurrent step for decode, plain torch (the reference has no
kernel there). The depthwise causal conv is plain torch too.

Shapes: x_in (B, T, d); inner x (B, T, H, P); B/C (B, T, G, N);
state (B, H, P, N) fp32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs.base import SSMSpec
from ..kernels.ssd_scan import ops as ssd_ops
from ..kernels.ssd_scan import ref as ssd_ref
from .common import dense_init, rms_norm, rms_norm_init, silu
from . import tensor_parallel as tp
from .runtime import is_distributed


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, conv_dim) last inputs to the causal conv
    ssm: torch.Tensor  # (B, H, P, N) fp32


def conv_dim(spec: SSMSpec, d_model: int) -> int:
    return spec.d_inner(d_model) + 2 * spec.n_groups * spec.d_state


def init_mamba(d_model: int, spec: SSMSpec, dtype, *, generator, device, lead=()):
    """Weights in ``dtype``; ``A_log``, ``D`` and ``dt_bias`` stay fp32 at
    any model dtype, as in the JAX init."""
    di = spec.d_inner(d_model)
    nh = spec.n_heads(d_model)
    cd = conv_dim(spec, d_model)
    kw = dict(generator=generator, device=device, lead=lead)
    proj_out = 2 * di + 2 * spec.n_groups * spec.d_state + nh

    def per_head(v):  # (nh,) fp32 -> (*lead, nh)
        return v.to(device).expand(*lead, nh).clone()

    conv_w = torch.randn((*lead, spec.d_conv, cd), generator=generator,
                         device=device) * 0.1
    return {
        "in_proj": dense_init(d_model, proj_out, dtype, **kw),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((*lead, cd), dtype=dtype, device=device),
        "A_log": per_head(torch.log(torch.linspace(1.0, 16.0, nh))),
        "D": per_head(torch.ones(nh)),
        "dt_bias": per_head(torch.log(torch.expm1(torch.full((nh,), 0.01)))),
        "norm_w": rms_norm_init(di, dtype, device=device, lead=lead),
        "out_proj": dense_init(di, d_model, dtype, **kw),
    }


def _split_proj(zxbcdt, spec: SSMSpec, d_model: int):
    di = spec.d_inner(d_model)
    gn = spec.n_groups * spec.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    return z, xbc, dt


def _causal_conv(xbc, w, b, init: Optional[torch.Tensor] = None):
    """Depthwise causal conv. xbc (B, T, cd); w (dc, cd); returns (out, tail).

    ``init``: (B, dc-1, cd) carried context (decode/prefill chaining)."""
    B, T, cd = xbc.shape
    dc = w.shape[0]
    if init is None:
        init = torch.zeros((B, dc - 1, cd), dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([init, xbc], dim=1)  # (B, T+dc-1, cd)
    out = sum(xp[:, i: i + T] * w[i][None, None] for i in range(dc)) + b[None, None]
    tail = xp[:, xp.shape[1] - (dc - 1):].clone()  # a copy: xp is not kept alive
    return silu(out), tail


def ssd_chunked(x, dt, A, Bm, Cm, spec: SSMSpec, init_state=None):
    """Chunked SSD scan (plain torch oracle; ``kernels/ssd_scan/ref.py``
    at ``spec.chunk``). Returns (y (B,T,H,P) fp32, final_state (B,H,P,N))."""
    return ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, spec.chunk, init_state)


def apply_mamba_full(params, x_in, spec: SSMSpec, *,
                     init_state: Optional[MambaState] = None,
                     return_state: bool = False, rt=None):
    """x_in (B, T, d) -> (B, T, d).

    ``rt``: Runtime for kernel dispatch (None: the plain path). The scan
    goes through ``ssd_scan.ops.ssd`` under ``rt.backend``: the
    Hopper kernel for a CUDA tensor, ``ssd_chunked`` otherwise, both with
    the D skip added in fp32 so that y is rounded to the model dtype once.
    On a DTensor head-parallel over the mesh's "model" axis
    (:func:`apply_mamba_sharded`), the scan under ``rt.local()``'s backend."""
    if is_distributed(x_in):
        y, st = apply_mamba_sharded(params, x_in, spec, rt, state=init_state,
                                    want_state=return_state)
        return (y, st) if return_state else y
    B, T, d_model = x_in.shape
    di = spec.d_inner(d_model)
    nh = spec.n_heads(d_model)
    gn = spec.n_groups * spec.d_state
    zxbcdt = x_in @ params["in_proj"]
    z, xbc, dt_raw = _split_proj(zxbcdt, spec, d_model)
    conv_init = init_state.conv if init_state is not None else None
    xbc, conv_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"], conv_init)
    xs = xbc[..., :di].reshape(B, T, nh, spec.head_dim)
    Bm = xbc[..., di: di + gn].reshape(B, T, spec.n_groups, spec.d_state)
    Cm = xbc[..., di + gn:].reshape(B, T, spec.n_groups, spec.d_state)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None])
    A = -torch.exp(params["A_log"])
    ssm_init = init_state.ssm if init_state is not None else None
    y, final = ssd_ops.ssd(
        xs.contiguous(), dt.contiguous(), A.contiguous(), Bm.contiguous(),
        Cm.contiguous(), init=ssm_init.contiguous() if ssm_init is not None else None,
        D=params["D"].contiguous(), chunk=spec.chunk,
        backend=rt.backend if rt is not None else "ref")
    y = y.reshape(B, T, di)
    y = rms_norm(params["norm_w"], y * silu(z))
    out = y @ params["out_proj"]
    if return_state:
        return out, MambaState(conv=conv_tail, ssm=final)
    return out


def apply_mamba_decode(params, x_in, state: MambaState, spec: SSMSpec, rt=None):
    """Single-token step. x_in (B, 1, d) -> (out (B,1,d), new state); on a
    DTensor head-parallel over ``rt``'s "model" axis
    (:func:`apply_mamba_sharded`)."""
    if is_distributed(x_in):
        return apply_mamba_sharded(params, x_in, spec, rt, state=state, decode=True)
    B, _, d_model = x_in.shape
    di = spec.d_inner(d_model)
    nh = spec.n_heads(d_model)
    gn = spec.n_groups * spec.d_state
    hpg = nh // spec.n_groups
    zxbcdt = x_in @ params["in_proj"]
    z, xbc, dt_raw = _split_proj(zxbcdt, spec, d_model)
    # conv step using cached tail
    xp = torch.cat([state.conv, xbc], dim=1)  # (B, dc, cd)
    out = torch.einsum("btc,tc->bc", xp.float(), params["conv_w"].float())
    xbc1 = silu(out + params["conv_b"].float())[:, None].to(x_in.dtype)
    new_conv = xp[:, 1:].clone()
    xs = xbc1[..., :di].reshape(B, nh, spec.head_dim).float()
    Bm = xbc1[..., di: di + gn].reshape(B, spec.n_groups, spec.d_state).float()
    Cm = xbc1[..., di + gn:].reshape(B, spec.n_groups, spec.d_state).float()
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"][None])  # (B,H)
    A = -torch.exp(params["A_log"])
    dec = torch.exp(dt * A[None])  # (B,H)
    Bh = Bm.repeat_interleave(hpg, dim=1)  # (B,H,N)
    s_new = state.ssm * dec[:, :, None, None] + \
        (xs * dt[..., None])[..., :, None] * Bh[..., None, :]
    Ch = Cm.repeat_interleave(hpg, dim=1)
    y = torch.einsum("bhpn,bhn->bhp", s_new, Ch) + params["D"][None, :, None] * xs
    y = y.reshape(B, 1, di).to(x_in.dtype)
    y = rms_norm(params["norm_w"], y * silu(z))
    return y @ params["out_proj"], MambaState(conv=new_conv, ssm=s_new)


# ---------------------------------------------------------------------------
# On a mesh: heads over the "model" axis
# ---------------------------------------------------------------------------
#
# Model rank m of ms owns a contiguous block of heads (the first nh % ms ranks
# one head more) and computes z, x, dt, the conv of its x channels, the scan,
# the D skip, the gate and its rows of out_proj for them; B and C, which every
# head reads, every rank computes whole. The weights and the state stay in
# ``distributed/sharding.py``'s placements: an even column or channel split
# over "model" where the size divides, whole otherwise. Those splits do not
# follow the heads, so the body re-lays what it reads (``tp.relay``, one
# all_to_all over the "model" group where a rank needs another's part). The
# gated norm sums its squares over "model" and the output is a partial sum
# over "model", each one all_reduce. Every collective is a c10d call on local
# tensors inside an autograd Function that carries its transpose
# (``models/tensor_parallel.py``).

MIXER = "the Mamba mixer"  # its name in the errors of tp


def _state_placements(shape, ch: int, sp: tp.Split, given=None) -> tuple:
    """The placements a state tensor takes in the body: its batch rows as
    the input's, and on "model" ``given``'s split along its channel dim
    ``ch`` (where it has one) or, without ``given``, the cache's rule
    (``distributed/sharding.py::cache_pspecs``: split along ``ch`` where
    ``ms`` divides it, else whole)."""
    from torch.distributed.tensor import Replicate, Shard

    pl = list(sp.rows)
    if sp.md is not None:
        if given is not None:
            keep = given[sp.md] == Shard(ch)
        else:
            keep = shape[ch] % sp.ms == 0
        pl[sp.md] = Shard(ch) if keep else Replicate()
    return tuple(pl)


def _state_in(t, ch: int, sp: tp.Split):
    """A state DTensor -> (this rank's local tensor, its ranges along ``ch``
    a model rank)."""
    pl = _state_placements(t.shape, ch, sp, t.placements)
    split = sp.md is not None and pl[sp.md].is_shard()
    return t.redistribute(sp.mesh, pl).to_local(), tp.stored(t.shape[ch], split, sp.ms)


def _state_out(loc, ch: int, n: int, mine: tuple, sp: tp.Split, given=None):
    """This rank's part of a new state (dim ``ch`` holding ranges ``mine``, a
    model rank) -> a DTensor in ``given``'s placements (a state passed in)
    or the cache's rule."""
    from torch.distributed.tensor import DTensor

    shape = (*loc.shape[:ch], n, *loc.shape[ch + 1:])
    pl = _state_placements(shape, ch, sp, None if given is None else given.placements)
    split = sp.md is not None and pl[sp.md].is_shard()
    loc = tp.relay(loc, ch, mine, tp.stored(n, split, sp.ms), sp.me, sp.group)
    out = DTensor.from_local(loc.contiguous(), sp.mesh, pl, run_check=False)
    if given is not None and pl != tuple(given.placements):
        out = out.redistribute(sp.mesh, given.placements)
    return out


def _norm_sharded(w, g, di: int, sp: tp.Split, eps: float = 1e-6):
    """:func:`rms_norm` of g over all ``di`` channels, this rank holding its
    own channels of g and w: the squares summed over "model"."""
    dt = g.dtype
    g = g.float()
    ss = g.square().sum(dim=-1, keepdim=True)
    if sp.group is not None:
        ss = tp.AllReduce.apply(ss, sp.group, True)
    g = g * torch.rsqrt(ss / di + eps)
    return (g * (1.0 + w.float())).to(dt)


def _per_head(t, dim: int, h0: int, h1: int, hpg: int):
    """Groups (dim ``dim`` of ``t``) -> one a head, heads [h0, h1)."""
    g0, g1 = h0 // hpg, (h1 - 1) // hpg + 1
    return t.narrow(dim, g0, g1 - g0).repeat_interleave(hpg, dim).narrow(
        dim, h0 - g0 * hpg, h1 - h0)


def apply_mamba_sharded(params, x_in, spec: SSMSpec, rt, *,
                        state: Optional[MambaState] = None, want_state: bool = False,
                        decode: bool = False):
    """The mixer on a DTensor x_in (B, T, d), head-parallel over ``rt``'s
    "model" axis (the section's comment): prefill (``state`` the carried
    state or None; the new one with ``want_state``) or, with ``decode``, one
    step from ``state``. Returns (y, new state or None), y as x_in's batch
    rows and replicated over "model", the state in ``state``'s placements
    or the cache's. ``in_proj`` split over "model" is re-laid as weights in
    prefill and as the projected activations in decode (T = 1: far fewer
    bytes). A mesh whose "model" axis outnumbers the heads raises."""
    from torch.distributed.tensor import DTensor, Partial

    sp = tp.split_of(x_in, rt, MIXER)
    d_model = x_in.shape[-1]
    di = spec.d_inner(d_model)
    nh = spec.n_heads(d_model)
    P = spec.head_dim
    G, N = spec.n_groups, spec.d_state
    gn = G * N
    if nh < sp.ms:
        raise NotImplementedError(f"the Mamba mixer on a mesh: {nh} heads over {sp.ms} "
                                  "model ranks leaves a rank without a head")
    blocks = [tp.block_of(nh, sp.ms, m) for m in range(sp.ms)]
    h0, h1 = blocks[sp.me]
    Hl, Dl = h1 - h0, (h1 - h0) * P
    want = {  # each model rank's ranges of each channel dim
        "in_proj": tuple(((a * P, b * P), (di + a * P, di + b * P), (2 * di, 2 * di + 2 * gn),
                          (2 * di + 2 * gn + a, 2 * di + 2 * gn + b)) for a, b in blocks),
        "conv": tuple(((a * P, b * P), (di, di + 2 * gn)) for a, b in blocks),
        "inner": tuple(((a * P, b * P),) for a, b in blocks),
        "heads": tuple(((a, b),) for a, b in blocks)}

    def relay(t, dim, have, key):
        return tp.relay(t, dim, have, want[key], sp.me, sp.group)

    x_pl = tuple(Partial() if i == sp.md else p for i, p in enumerate(sp.rows))
    x = x_in.redistribute(sp.mesh, sp.rows).to_local(grad_placements=x_pl)
    w_in, have_in = tp.enter_weight(params["in_proj"], -1, sp, MIXER)
    if decode and have_in[0] != have_in[-1]:  # split: the activations re-laid
        zx = relay(x @ w_in, -1, have_in, "in_proj")
    else:
        zx = x @ relay(w_in, -1, have_in, "in_proj")
    z, xbc, dt_raw = zx[..., :Dl], zx[..., Dl: 2 * Dl + 2 * gn], zx[..., 2 * Dl + 2 * gn:]
    conv_w, have_c = tp.enter_weight(params["conv_w"], -1, sp, MIXER)
    conv_b, _ = tp.enter_weight(params["conv_b"], -1, sp, MIXER)
    conv_w, conv_b = relay(conv_w, -1, have_c, "conv"), relay(conv_b, -1, have_c, "conv")
    heads = {k: tp.enter_weight(params[k], -1, sp, MIXER)[0].narrow(-1, h0, Hl)
             for k in ("A_log", "D", "dt_bias")}
    norm_w, have_n = tp.enter_weight(params["norm_w"], -1, sp, MIXER)
    out_proj, have_o = tp.enter_weight(params["out_proj"], 0, sp, MIXER)
    norm_w, out_proj = relay(norm_w, -1, have_n, "inner"), relay(out_proj, 0, have_o, "inner")
    cd = di + 2 * gn
    conv_st = ssm_st = None
    if state is not None:
        conv_st, have_cs = _state_in(state.conv, 2, sp)
        ssm_st, have_ss = _state_in(state.ssm, 1, sp)
        conv_st = relay(conv_st, 2, have_cs, "conv")
        ssm_st = relay(ssm_st, 1, have_ss, "heads").contiguous()
    A = -torch.exp(heads["A_log"])
    B = x.shape[0]
    if decode:
        xp = torch.cat([conv_st, xbc], dim=1)  # (B, dc, conv channels)
        out = torch.einsum("btc,tc->bc", xp.float(), conv_w.float())
        xbc1 = silu(out + conv_b.float())[:, None].to(x.dtype)
        conv_tail = xp[:, 1:]
        xs = xbc1[..., :Dl].reshape(B, Hl, P).float()
        Bh = _per_head(xbc1[..., Dl: Dl + gn].reshape(B, G, N).float(), 1, h0, h1, nh // G)
        Ch = _per_head(xbc1[..., Dl + gn:].reshape(B, G, N).float(), 1, h0, h1, nh // G)
        dt = F.softplus(dt_raw[:, 0].float() + heads["dt_bias"][None])  # (B, Hl)
        dec = torch.exp(dt * A[None])
        final = ssm_st * dec[:, :, None, None] + \
            (xs * dt[..., None])[..., :, None] * Bh[..., None, :]
        y = torch.einsum("bhpn,bhn->bhp", final, Ch) + heads["D"][None, :, None] * xs
        y = y.reshape(B, 1, Dl).to(x.dtype)
    else:
        T = x.shape[1]
        xbc, conv_tail = _causal_conv(xbc, conv_w, conv_b, conv_st)
        xs = xbc[..., :Dl].reshape(B, T, Hl, P)
        Bm = xbc[..., Dl: Dl + gn].reshape(B, T, G, N)
        Cm = xbc[..., Dl + gn:].reshape(B, T, G, N)
        if G > 1:  # the kernel's heads share groups evenly: one group a head here
            Bm, Cm = (_per_head(t, 2, h0, h1, nh // G) for t in (Bm, Cm))
        dt = F.softplus(dt_raw.float() + heads["dt_bias"][None, None])
        # the head slices are strided views; the kernel takes contiguous ones
        y, final = ssd_ops.ssd(
            xs.contiguous(), dt.contiguous(), A.contiguous(), Bm.contiguous(),
            Cm.contiguous(), init=ssm_st, D=heads["D"].contiguous(), chunk=spec.chunk,
            backend=rt.local().backend)
        y = y.reshape(B, T, Dl)
    y = _norm_sharded(norm_w, y * silu(z), di, sp) @ out_proj
    if sp.group is not None:
        y = tp.AllReduce.apply(y, sp.group, False)
    y = DTensor.from_local(y, sp.mesh, sp.rows, run_check=False)
    if not (decode or want_state):
        return y, None
    return y, MambaState(
        conv=_state_out(conv_tail, 2, cd, want["conv"], sp,
                        None if state is None else state.conv),
        ssm=_state_out(final, 1, nh, want["heads"], sp, None if state is None else state.ssm))
