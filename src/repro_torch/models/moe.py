"""Sparsely-gated MoE layer (Eq. 1-2) with capacity-based dispatch and
expert parallelism (counterpart of ``repro/models/moe.py``).

Dispatch is GShard-style: per-expert capacity ``cap``; overflow tokens
are dropped (gate mass zeroed), the later tokens first. ``zero_drop``
(decode) sizes the buffer at N tokens so nothing can drop. The grouped
expert FFN goes through ``kernels.moe_gmm`` with each expert's kept
count as its group size, so the kernel skips empty experts. LoRA
adapters on the expert projections are merged into the weights before
the grouped products, as the reference does.

Two execution paths share the dispatch logic:
  * local   — one device (the offload engine, the smoke tests);
  * sharded — on a mesh (``apply_moe_sharded``): tokens sharded over the
              data axes, experts over "model"; each rank dispatches its
              own tokens into buffers for all E experts, one
              ``all_to_all`` over the mesh's "model" group sends each
              expert's rows to the rank that holds it, the grouped FFN
              runs over that rank's E/ms experts, and a second
              ``all_to_all`` brings the rows back to combine. The exchange
              carries its gradient (:class:`_AllToAll`), so the train
              step's backward passes through it. The local body runs on
              one rank's plain tensors, so its products go through the
              port's dispatch as on one device (``moe_gmm`` on the card);
              the reference keeps that body on its reference einsum only
              because its Pallas kernels were not validated under
              ``shard_map``.

The reference's ``REPRO_OPT`` switch ``moe_dispatch_shard``
(``common.OPT_FLAGS``): the dispatch
shards the tokens over the model axis as well, so the ms ranks of a data
row no longer dispatch identical buffers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..configs.base import MoESpec
from ..kernels.moe_gmm import ops as gmm_ops
from .common import OPT_FLAGS, dense_init, silu
from .mlp import apply_mlp, init_mlp
from .runtime import Runtime, is_distributed

def init_moe(d_model: int, spec: MoESpec, dtype, *, generator, device, lead=(),
             expert_device=None, expert_sink=None):
    """Router (fp32) + stacked expert weights ``(*lead, E, ...)``.

    The experts are drawn on ``device`` one ``(E, i, o)`` matrix (one
    leading index) at a time, ``wg`` for every leading index, then ``wu``,
    then ``wd``. ``expert_device``: where they are kept (default
    ``device``; "meta" keeps none). ``expert_sink``: called as
    ``expert_sink(name, idx, w)`` with each matrix so drawn (``idx`` its
    index into ``lead``), which it takes instead of the tree: the leaves
    then stay on ``meta`` unless ``expert_device`` says otherwise. The
    draws, and so every weight, are the same with or without either (a
    draw of the whole ``(*lead, E, i, o)`` leaf would not give the same
    matrices: torch's truncated normal may reject and draw again over the
    whole tensor, and a CUDA generator maps elements to its stream by the
    tensor's size)."""
    E, f = spec.num_experts, spec.d_ff
    kw = dict(generator=generator, device=device)
    p = {"router": dense_init(d_model, E, torch.float32, lead=lead, **kw)}
    keep = expert_device or (device if expert_sink is None else "meta")
    for name, (i, o) in (("wg", (d_model, f)), ("wu", (d_model, f)),
                         ("wd", (f, d_model))):
        w = torch.empty((*lead, E, i, o), dtype=dtype, device=keep)
        for idx in np.ndindex(*lead):  # one layer's experts at a time
            m = dense_init(i, o, dtype, lead=(E,), **kw)
            if expert_sink is not None:
                expert_sink(name, idx, m)
            if not w.is_meta:
                w[idx] = m
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
        return gmm_ops.gmm(a, b, sizes, backend=rt.backend)

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


# ---------------------------------------------------------------------------
# Sharded path (expert parallel over "model", tokens over data axes)
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal blocks along dim 0 over ``group``
    (block j to rank j, block i of the output from rank i), with its
    gradient: the same exchange of the output's gradient (equal blocks make
    the exchange its own transpose). Plain c10d collectives, which gloo
    also runs on CUDA tensors."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.contiguous()  # the output takes the input's layout
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient times ``c``."""

    @staticmethod
    def forward(ctx, x, c: float):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.c, None


def _on_mesh(t, rt: Runtime):
    """``t`` as a DTensor on ``rt.mesh`` (a plain tensor counts as
    replicated, as inside ``Runtime.dist``)."""
    if is_distributed(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, rt.mesh, [Replicate()] * rt.mesh.ndim, run_check=False)


def _gathered(tree):
    """Every DTensor leaf of ``tree`` (a dict, or None) whole on each rank."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _gathered(v) for k, v in tree.items()}
    return tree.full_tensor() if is_distributed(tree) else tree


def _local_on_mesh(params, x2d, spec: MoESpec, rt: Runtime, lora, lora_scale, probs):
    """The local path on a mesh without expert parallelism (one model
    shard, E not divisible by it, or ``pure_fsdp``): the whole batch and
    every weight gathered on each rank, the local layer, its output
    replicated — the single-device result, capacity drops included."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * rt.mesh.ndim
    y, probs = apply_moe_local(_gathered(params), _gathered(x2d), spec, rt.local(),
                               _gathered(lora), lora_scale, _gathered(probs))
    return (DTensor.from_local(y, rt.mesh, rep, run_check=False),
            DTensor.from_local(probs, rt.mesh, rep, run_check=False))


def apply_moe_sharded(params, x2d, spec: MoESpec, rt: Runtime, lora=None,
                      lora_scale: float = 1.0, probs=None):
    """x2d (N, dm) DTensor -> (y (N, dm), probs): expert parallelism over
    the mesh's "model" axis (the module's docstring), step by step the
    reference's ``shard_map`` body. The capacity is computed from each
    rank's own token count. LoRA slices ride with their experts; the
    shared expert is added outside."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from ..distributed.sharding import placements

    ms = rt.axis_size("model")
    E = spec.num_experts
    if ms == 1 or E % ms != 0:
        return _local_on_mesh(params, x2d, spec, rt, lora, lora_scale, probs)

    mesh = rt.mesh
    N = x2d.shape[0]
    data_axes = rt.data_axes
    dp = rt.axis_size(data_axes) if data_axes else 1
    # optimized dispatch: tokens sharded over the model axis as well
    if OPT_FLAGS["moe_dispatch_shard"] and N % (dp * ms) == 0:
        tok_axes, n_loc = tuple(data_axes) + ("model",), N // (dp * ms)
    elif data_axes and N % dp == 0:
        tok_axes, n_loc = tuple(data_axes), N // dp
    else:
        tok_axes, n_loc = (), N
    tok_pl = placements((tok_axes or None,), mesh)

    if probs is None:
        probs = router_probs(params, x2d, spec)
    gates, eids = top_k_route(probs, spec.top_k)
    cap = _capacity(spec, n_loc, rt.zero_drop)

    # The body's gradient, as the reference's shard_map transposes it:
    # the ranks a token row is replicated over (the mesh axes not in
    # tok_axes) each send a copy of it to the experts, so each copy's
    # output takes 1/rep of the output's gradient, and every input's
    # gradient is a partial sum over the mesh axes it is replicated over
    # (the experts' over the data axes: each data row's tokens give their
    # own part).
    rep = mesh.size() // rt.axis_size(tok_axes) if tok_axes else mesh.size()

    def local(t, pl):
        grad_pl = [Partial() if p == Replicate() else p for p in pl]
        return _on_mesh(t, rt).redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    ew_pl = placements(("model", None, None), mesh)
    x_loc, g_loc, e_loc = (local(t, tok_pl) for t in (x2d, gates, eids))
    p_loc = {k: local(params[k], ew_pl) for k in ("wg", "wu", "wd")}
    lora_loc = (None if lora is None else
                {k: {f: local(v, ew_pl) for f, v in ab.items()} for k, ab in lora.items()})
    group = mesh.get_group("model")

    def exchange(buf):  # (ms, ...) blocks: block j to model rank j, back in order
        return _AllToAll.apply(buf, group)

    d = make_dispatch(g_loc, e_loc, spec, cap)
    buf = dispatch_tokens(d, x_loc, E)  # (E, cap, dm)
    # (E = ms * E_loc, cap, dm) -> rows of my experts from every peer
    buf = exchange(buf.reshape(ms, E // ms, cap, -1))
    # (ms, E_loc, cap, dm): axis 0 now indexes the source shard; with one
    # row a shard (cap 1) the reshape is a strided view, and the kernel takes
    # contiguous rows
    buf = buf.transpose(0, 1).reshape(E // ms, ms * cap, -1).contiguous()
    out = expert_ffn(p_loc, buf, rt.local(), lora_loc, lora_scale)
    out = out.reshape(E // ms, ms, cap, -1).transpose(0, 1)
    out = exchange(out).reshape(E, cap, -1)
    y = DTensor.from_local(_ScaleGrad.apply(combine_tokens(d, out), 1.0 / rep), mesh, tok_pl,
                           run_check=False)
    if spec.shared_d_ff:
        y = y + apply_mlp(params["shared"], x2d)
    return y, probs


def apply_moe(params, x2d, spec: MoESpec, rt: Runtime, lora=None,
              lora_scale: float = 1.0, probs=None):
    """The sharded path on a mesh with a model axis, the local path on one
    device."""
    if rt.sharded and rt.model_axis is not None:
        return apply_moe_sharded(params, x2d, spec, rt, lora, lora_scale, probs)
    if rt.sharded:
        return _local_on_mesh(params, x2d, spec, rt, lora, lora_scale, probs)
    return apply_moe_local(params, x2d, spec, rt, lora, lora_scale, probs)
