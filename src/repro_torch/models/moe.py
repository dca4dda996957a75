"""MoE routing and slot dispatch (counterpart of ``repro/models/moe.py``:
the pieces the offload engine runs; the sharded path waits)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..configs.base import MoESpec
from .common import dense_init
from .mlp import init_mlp


def init_moe(d_model: int, spec: MoESpec, dtype, *, generator, device, lead=(),
             expert_device=None):
    """Router (fp32) + stacked expert weights ``(*lead, E, ...)``.

    ``expert_device``: where the expert weights are kept (drawn on
    ``device`` one leading index at a time, then moved) — a full-width
    model keeps its experts in host memory."""
    E, f = spec.num_experts, spec.d_ff
    kw = dict(generator=generator, device=device)
    p = {"router": dense_init(d_model, E, torch.float32, lead=lead, **kw)}
    for name, (i, o) in (("wg", (d_model, f)), ("wu", (d_model, f)),
                         ("wd", (f, d_model))):
        if expert_device is None:
            p[name] = dense_init(i, o, dtype, lead=(*lead, E), **kw)
            continue
        w = torch.empty((*lead, E, i, o), dtype=dtype, device=expert_device)
        for idx in np.ndindex(*lead):  # one layer's experts at a time
            w[idx] = dense_init(i, o, dtype, lead=(E,), **kw)
        p[name] = w
    if spec.shared_d_ff:
        p["shared"] = init_mlp(d_model, spec.shared_d_ff, dtype, lead=lead, **kw)
    return p


def router_probs(params, x, spec: MoESpec):
    """x: (..., d) -> softmax router distribution (..., E) in fp32 (Eq. 1)."""
    logits = x.float() @ params["router"].float()
    if spec.router_softcap is not None:
        logits = torch.tanh(logits / spec.router_softcap) * spec.router_softcap
    return torch.softmax(logits, dim=-1)


def top_k_route(probs, k: int):
    """probs (N, E) -> gates (N, K) raw probabilities, eids (N, K) int32."""
    gates, eids = torch.topk(probs, k, dim=-1)
    return gates, eids.to(torch.int32)


class Dispatch(NamedTuple):
    eids: torch.Tensor  # (N, K) int32, == E (or C) where dropped
    pos: torch.Tensor  # (N, K) int32 slot within the expert buffer
    gates: torch.Tensor  # (N, K) f32, zeroed where dropped
    cap: int


def dispatch_tokens(d: Dispatch, x, n_experts: int):
    """x (N, dm) -> expert buffers (E, cap, dm). Assignments whose expert
    index is the sentinel (>= n_experts) are dropped — the JAX version's
    ``mode="drop"`` scatter, masked here explicitly."""
    N, K = d.eids.shape
    flat_e = d.eids.reshape(-1).long()
    flat_p = d.pos.reshape(-1).long()
    keep = flat_e < n_experts
    xr = x.repeat_interleave(K, dim=0)  # row n*K + k is token n
    buf = torch.zeros((n_experts, d.cap, x.shape[-1]), dtype=x.dtype, device=x.device)
    buf[flat_e[keep], flat_p[keep]] = xr[keep]
    return buf


def combine_tokens(d: Dispatch, buf):
    """buf (E, cap, dm) -> (N, dm) gate-weighted combine."""
    N, K = d.eids.shape
    safe_e = torch.clamp(d.eids, max=buf.shape[0] - 1).reshape(-1).long()
    gathered = buf[safe_e, d.pos.reshape(-1).long()].reshape(N, K, -1)
    return torch.einsum("nkd,nk->nd", gathered.float(), d.gates).to(buf.dtype)
