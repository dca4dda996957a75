"""Sparsely-gated MoE layer (Eq. 1-2) with capacity-based dispatch
(counterpart of ``repro/models/moe.py``, local path).

Dispatch is GShard-style: per-expert capacity ``cap``; overflow tokens
are dropped (gate mass zeroed), the later tokens first. ``zero_drop``
(decode) sizes the buffer at N tokens so nothing can drop. The grouped
expert FFN goes through ``kernels.moe_gmm`` with each expert's kept
count as its group size, so the kernel skips empty experts. LoRA
adapters on the expert projections are merged into the weights before
the grouped products, as the reference does. The sharded path (expert
parallelism over a mesh) is not ported: ``apply_moe`` runs the local
path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..configs.base import MoESpec
from ..kernels.moe_gmm import ops as gmm_ops
from .common import dense_init, silu
from .mlp import apply_mlp, init_mlp
from .runtime import Runtime


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


def make_dispatch(gates, eids, spec: MoESpec, cap: int) -> Dispatch:
    """Slot of each (token, k) assignment within its expert's buffer: the
    number of earlier assignments (in token-major order) to the same
    expert. Assignments at or past ``cap`` are dropped: their expert index
    becomes the sentinel ``E``, their slot 0 and their gate 0."""
    N, K = eids.shape
    E = spec.num_experts
    oh = torch.nn.functional.one_hot(eids.reshape(N * K).long(), E).to(torch.int32)
    pos = ((torch.cumsum(oh, dim=0) * oh).sum(-1) - 1).reshape(N, K)
    keep = pos < cap
    return Dispatch(
        eids=torch.where(keep, eids, torch.full_like(eids, E)),
        pos=torch.where(keep, pos, torch.zeros_like(pos)).to(torch.int32),
        gates=torch.where(keep, gates, torch.zeros_like(gates)),
        cap=cap,
    )


def group_sizes(d: Dispatch, n_experts: int):
    """Kept assignments per expert (E,) int32, on the device and without a
    host sync: the rows of each expert buffer that ``dispatch_tokens``
    fills (slots 0 .. count - 1; the rest stay zero)."""
    flat = torch.clamp(d.eids.reshape(-1).long(), max=n_experts)
    counts = torch.zeros(n_experts + 1, dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts[:n_experts]


def dispatch_tokens(d: Dispatch, x, n_experts: int):
    """x (N, dm) -> expert buffers (E, cap, dm). Assignments whose expert
    index is the sentinel (>= n_experts) are dropped — the JAX version's
    ``mode="drop"`` scatter: they land in one extra buffer row that is
    cut off, so no mask needs the host."""
    N, K = d.eids.shape
    flat_e = torch.clamp(d.eids.reshape(-1).long(), max=n_experts)
    flat_p = d.pos.reshape(-1).long()
    xr = x.repeat_interleave(K, dim=0)  # row n*K + k is token n
    buf = torch.zeros((n_experts + 1, d.cap, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    buf[flat_e, flat_p] = xr
    return buf[:n_experts]


def combine_tokens(d: Dispatch, buf):
    """buf (E, cap, dm) -> (N, dm) gate-weighted combine."""
    N, K = d.eids.shape
    safe_e = torch.clamp(d.eids, max=buf.shape[0] - 1).reshape(-1).long()
    gathered = buf[safe_e, d.pos.reshape(-1).long()].reshape(N, K, -1)
    return torch.einsum("nkd,nk->nd", gathered.float(), d.gates).to(buf.dtype)


# ---------------------------------------------------------------------------
# Expert FFN (grouped)
# ---------------------------------------------------------------------------


def _expert_weights(params, lora: Optional[dict], lora_scale: float, name: str):
    """``params[name]`` with the adapter's delta ``scale * a @ b`` (fp32,
    cast once to the weight's dtype) merged in, where ``lora`` has one."""
    w = params[name]
    if lora is not None and name in lora:
        a, b = lora[name]["a"], lora[name]["b"]
        delta = torch.einsum("edr,erf->edf", a.float(), b.float())
        w = w + (lora_scale * delta).to(w.dtype)
    return w


def expert_ffn(params, buf, rt: Runtime, lora: Optional[dict] = None,
               lora_scale: float = 1.0, sizes=None):
    """buf (E, cap, d) -> (E, cap, d) via per-expert gated MLP (Eq. 2),
    three ``moe_gmm`` calls. ``sizes`` (E,): each expert's valid rows
    (``group_sizes``); rows past it must be zero in ``buf`` and come out
    zero, so the kernel may skip them."""
    wg = _expert_weights(params, lora, lora_scale, "wg")
    wu = _expert_weights(params, lora, lora_scale, "wu")
    wd = _expert_weights(params, lora, lora_scale, "wd")

    def gmm(a, b):
        return gmm_ops.gmm(a, b, sizes, backend=rt.kernel_backend)

    h = silu(gmm(buf, wg)) * gmm(buf, wu)
    return gmm(h, wd)


# ---------------------------------------------------------------------------
# Local path
# ---------------------------------------------------------------------------


def _capacity(spec: MoESpec, n_tokens: int, zero_drop: bool) -> int:
    return n_tokens if zero_drop else min(n_tokens, spec.capacity(n_tokens))


def apply_moe_local(params, x2d, spec: MoESpec, rt: Runtime, lora=None,
                    lora_scale: float = 1.0, probs=None):
    """x2d (N, dm) -> (N, dm). Returns (y, probs)."""
    if probs is None:
        probs = router_probs(params, x2d, spec)
    gates, eids = top_k_route(probs, spec.top_k)
    cap = _capacity(spec, x2d.shape[0], rt.zero_drop)
    d = make_dispatch(gates, eids, spec, cap)
    buf = dispatch_tokens(d, x2d, spec.num_experts)
    out_buf = expert_ffn(params, buf, rt, lora, lora_scale,
                         sizes=group_sizes(d, spec.num_experts))
    y = combine_tokens(d, out_buf)
    if spec.shared_d_ff:
        y = y + apply_mlp(params["shared"], x2d)
    return y, probs


def apply_moe(params, x2d, spec: MoESpec, rt: Runtime, lora=None,
              lora_scale: float = 1.0, probs=None):
    """The local path: the port's ``Runtime`` has no mesh, so there is no
    expert-parallel branch yet."""
    return apply_moe_local(params, x2d, spec, rt, lora, lora_scale, probs)
