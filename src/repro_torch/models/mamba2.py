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
    On a DTensor rank by rank (:func:`on_rows`), the scan under
    ``rt.local()``'s backend."""
    if is_distributed(x_in):
        rl = rt.local() if rt is not None else None

        def local(p, x, st):
            out = apply_mamba_full(p, x, spec, init_state=st, return_state=return_state,
                                   rt=rl)
            return out if return_state else (out, None)

        y, st = on_rows(local, params, x_in, init_state)
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


def on_rows(fn, params, x, state: Optional[MambaState] = None):
    """``fn(params, x, state)`` -> (y, new state or None) of a mixer whose
    input ``x`` is a DTensor, rank by rank: each rank takes its own batch
    rows of ``x`` and ``state`` (sharded as ``x``'s dim 0, replicated on
    every other mesh dim) and the mixer's weights whole, and runs ``fn`` on
    local tensors; y and the new state come back as DTensors of those rows
    (the state in ``state``'s own placements where one is given). The
    weights' gradients are partial sums over the mesh dims that split the
    rows. DTensor's strategies for the mixer's slices and reshapes of its
    model-sharded conv dim send torch's redistribution planner into a loop
    without end (torch 2.13), so the mixer does not run on DTensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    rows = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    whole = (Replicate(),) * mesh.ndim
    partial = tuple(Partial() if p == Shard(0) else Replicate() for p in rows)

    def local(t, pl, grad_pl):
        return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    w = {k: local(v, whole, partial) for k, v in params.items()}
    st = None if state is None else MambaState(*(local(t, rows, rows) for t in state))
    y, new = fn(w, local(x, rows, rows), st)
    y = DTensor.from_local(y, mesh, rows, run_check=False)
    if new is not None:
        new = MambaState(*(DTensor.from_local(t, mesh, rows, run_check=False)
                           for t in new))
        if state is not None:
            new = MambaState(*(t.redistribute(mesh, s.placements)
                               for t, s in zip(new, state)))
    return y, new


def apply_mamba_decode(params, x_in, state: MambaState, spec: SSMSpec):
    """Single-token step. x_in (B, 1, d) -> (out (B,1,d), new state); on a
    DTensor rank by rank (:func:`on_rows`)."""
    if is_distributed(x_in):
        return on_rows(lambda p, x, s: apply_mamba_decode(p, x, s, spec), params, x_in, state)
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
