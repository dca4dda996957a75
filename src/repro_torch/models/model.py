"""Model assembly: parameter init, embeddings, logits, and the
full-model (fits-in-memory) path — ``apply_model``, ``prefill``,
``init_cache`` and ``decode_step`` (counterpart of
``repro/models/model.py``). A Python loop over each
group's ``repeats`` takes the place of ``lax.scan``: it indexes the
stacked leaves (views, no copies).

Parameter dict, keyed as the JAX tree:
  params = {
    "embed": (V, d),
    "lm_head": (d, V)           # absent when tie_embeddings
    "final_norm": (d,),
    "shared": {block params}    # zamba2 shared-attention weights, not stacked
    "groups": {"g0": {"p0": block params stacked over repeats (R, ...)}},
  }
A ``shared_attn`` position has no entry under its group: every
occurrence uses ``params["shared"]``.

Cache dict (``init_cache``/``prefill``): ``{"pos": int, "g0": {"p0":
KVCache or MambaState with leaves stacked over repeats}}``; ``pos`` may
also be a (B,) int tensor, every row at its own position (the
continuous-batching server's slot pool). Unlike the JAX version,
``decode_step`` updates the cache in place and returns it.

Router probes (``collect_probs``) come back in the JAX layout: a list of
(R, B, T, E) router distributions, one per (group, MoE position).

Offloaded experts (``experts``): ``apply_model``, ``prefill`` and
``decode_step`` take a callable ``experts(moe_idx) -> {"wg", "wu", "wd"}``
that hands each MoE block its experts (MoE layers numbered in walk
order, ``moe_layers``: the offload engine's and its host store's layer
order) in place of the tree's, e.g. one layer staged from the engine's
host store (``inference.engine.ServingEngine(host_store=)``); the staged
tensors are dropped before the next MoE layer asks for its own. Without
it a MoE block whose experts lie on the ``meta`` device (an offloaded
tree) raises ``ValueError``.

LoRA trees (``lora``, from ``core.lora`` or ``bridge.lora_from_jax``)
mirror ``params["groups"]``; each repeat takes its slice of the stacked
adapters, as the reference's scan does. A stacked leaf may also be given
as a list of its per-repeat slices (the training steps hand in views of
that kind, each its own autograd leaf).

Training (``apply_model(melinoe=MelinoeRun(...))``) adds the per-layer
cache-simulation and rank-matching losses of every MoE block, the JAX
``_melinoe_layer``.

On a sharded ``Runtime`` (a mesh of several devices) the same functions
run on DTensors: parameters from ``distributed.sharding.distribute_params``,
tokens sharded over the data axes (``batch_pspecs``), activations
constrained where the reference constrains them (after the embedding, the
logits), plain tensors made inside the model counted as replicated
(``Runtime.dist``). ``param_shapes`` is the tree of ``init_params`` on the
``meta`` device: shapes and dtypes, no storage.

Under the reference's ``REPRO_OPT`` switch ``loss_token_shard``
(``common.OPT_FLAGS``) the LM head's token dim is sharded over every
mesh axis on a sharded mesh.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import MelinoeSpec, ModelConfig
from ..kernels import dispatch
from .blocks import apply_block_decode, apply_block_full, init_block, init_block_cache
from .common import OPT_FLAGS, cdtype, dense_init, embed_init, rms_norm, rms_norm_init, softcap
from .runtime import Runtime, is_distributed, resolve_device


@dataclass(frozen=True)
class MelinoeRun:
    """MELINOE auxiliary-loss request threaded through the forward pass."""

    spec: MelinoeSpec
    cache_capacity: int
    # stacked base-router weights per group/position (same_trajectory
    # mode); None disables the rank-matching term
    base_routers: Optional[Dict[str, Dict[str, torch.Tensor]]] = None


def init_params(cfg: ModelConfig, *, generator: torch.Generator, dtype=None,
                device=None, expert_device=None, expert_sink=None):
    """Random weights with the JAX tree's key layout (the random bits
    differ from ``jax.random``). ``generator`` must live on ``device``.

    ``expert_device``: keep the MoE expert weights there ("meta": not at
    all); they are drawn on ``device`` one layer at a time and moved.
    ``expert_sink``: called as ``expert_sink(gi, pi, name, idx, w)`` with
    each layer's ``(E, i, o)`` matrix as it is drawn (block ``p{pi}`` of
    group ``g{gi}``, ``idx`` its repeat), e.g.
    ``core.offload_engine.HostExpertStore.sink``, which writes it into
    the offload engine's host store: the tree's expert leaves then stay
    on ``meta`` unless ``expert_device`` says otherwise. The generator's
    stream, and so every weight, is the same with or without either."""
    dtype = cdtype(dtype or cfg.dtype)
    device = torch.device(device or generator.device)
    kw = dict(generator=generator, device=device)
    params: dict = {
        "embed": embed_init(cfg.vocab, cfg.d_model, dtype, **kw),
        "final_norm": rms_norm_init(cfg.d_model, dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(cfg.d_model, cfg.vocab, dtype, **kw)
    shared = [n for n, b in cfg.block_defs.items() if b.kind == "shared_attn"]
    if shared:
        (sname,) = shared
        params["shared"] = init_block(cfg, cfg.block_defs[sname], dtype, **kw)
    groups = {}
    for gi, g in enumerate(cfg.layout):
        groups[f"g{gi}"] = {
            f"p{pi}": init_block(cfg, cfg.block_defs[bname], dtype,
                                 lead=(g.repeats,), expert_device=expert_device,
                                 expert_sink=(None if expert_sink is None else
                                              functools.partial(expert_sink, gi, pi)),
                                 **kw)
            for pi, bname in enumerate(g.pattern)
            if cfg.block_defs[bname].kind != "shared_attn"
        }
    params["groups"] = groups
    return params


def param_shapes(cfg: ModelConfig, dtype=None):
    """The tree of :func:`init_params` on the ``meta`` device: every leaf's
    shape and dtype (the reference's ``jax.eval_shape`` of ``init_params``),
    no storage."""
    return init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=dtype,
                       device="meta")


def embed_tokens(params, cfg: ModelConfig, tokens, prefix_embed=None):
    """Token embeddings (B, T, d), scaled where the config says so;
    ``prefix_embed`` (B, P, d), the frontend's conditioning rows (audio,
    image patches), goes ahead of them, cast to their dtype and not
    scaled: (B, P + T, d). A DTensor table is gathered whole and looked up
    with ``embedding`` (rows of a replicated table: the one lookup, and
    backward, that every torch release's DTensor propagates)."""
    embed = params["embed"]
    if is_distributed(embed):
        from torch.distributed.tensor import Replicate

        whole = embed.redistribute(embed.device_mesh, [Replicate()] * embed.device_mesh.ndim)
        x = torch.nn.functional.embedding(tokens, whole)
    else:
        x = embed[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
    if prefix_embed is not None:
        x = torch.cat([torch.as_tensor(prefix_embed).to(x.device, x.dtype), x], dim=1)
    return x


def compute_logits(params, cfg: ModelConfig, x, rt: Optional[Runtime] = None):
    """Final norm + LM head; logits in fp32 (after the optional softcap).
    On a sharded ``rt`` the logits are constrained to (batch over the data
    axes, vocab over "model"), or, under ``loss_token_shard`` with more
    than one position, computed with the tokens sharded over every axis."""
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if rt is None or not rt.sharded:
        return softcap((x @ head).float(), cfg.logit_softcap)
    if OPT_FLAGS["loss_token_shard"] and x.shape[1] > 1:
        # the token dim over ALL mesh axes (by default tokens go over the
        # data axes only, so every model shard computes the full-vocab
        # logits of its whole local batch)
        axes = tuple(rt.data_axes) + (("model",) if rt.model_axis else ())
        # fold tokens into the batch-of-tokens dim and shard it over all axes
        B, T, d = x.shape
        x2 = rt.constrain(x.reshape(B * T, d), axes)
        logits = softcap((x2 @ head).float(), cfg.logit_softcap)
        return rt.constrain(logits, axes, None).reshape(B, T, -1)
    logits = softcap((x @ head).float(), cfg.logit_softcap)
    return rt.constrain(logits, rt.batch_spec_entry(), None, rt.model_axis)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def _index(tree, r: int):
    """Repeat ``r`` of a stacked subtree (dict / NamedTuple of tensors)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_index(v, r) for v in tree))
    return tree[r]


def _stack(caches: list):
    """Per-repeat caches (NamedTuples) -> one with leaves stacked on dim 0."""
    return type(caches[0])(*(torch.stack(leaves) for leaves in zip(*caches)))


def _block_params(params, gparams, b, pi: int, r: int):
    if b.kind == "shared_attn":
        return params["shared"]
    return _index(gparams[f"p{pi}"], r)


def moe_layers(cfg: ModelConfig) -> Dict[tuple, int]:
    """(group, position, repeat) -> MoE layer index, in the order the model
    walks its blocks (groups, then repeats, then pattern positions)."""
    index: Dict[tuple, int] = {}
    for gi, g in enumerate(cfg.layout):
        for r in range(g.repeats):
            for pi, bname in enumerate(g.pattern):
                if cfg.block_defs[bname].kind == "attn_moe":
                    index[(gi, pi, r)] = len(index)
    return index


def _walk_params(params, gparams, b, gi: int, pi: int, r: int, experts, index):
    """Block ``p{pi}`` of group ``g{gi}``, repeat ``r``: its weights, a MoE
    block's experts from ``experts`` where given (``index``:
    :func:`moe_layers`). A MoE block whose experts are on ``meta`` with no
    ``experts`` raises ``ValueError``."""
    bp = _block_params(params, gparams, b, pi, r)
    if b.kind != "attn_moe":
        return bp
    if experts is not None:
        return dict(bp, ffn=dict(bp["ffn"], **experts(index[gi, pi, r])))
    if bp["ffn"]["wg"].is_meta:
        raise ValueError(
            f"MoE layer {index[gi, pi, r]} (group {gi}, position {pi}, repeat {r}): its "
            f"experts are on the meta device (an offloaded tree); pass experts= to stage "
            f"them")
    return bp


def _block_lora(lora_g, pi: int, r: int):
    """Repeat ``r`` of position ``pi``'s adapters, or None."""
    if lora_g is None or f"p{pi}" not in lora_g:
        return None
    return _index(lora_g[f"p{pi}"], r)


def _melinoe_layer(losses, aux, base_router, mel: "MelinoeRun", top_k: int):
    from ..core.losses import melinoe_layer_losses

    cs, rm = melinoe_layer_losses(probs=aux["probs"], moe_h=aux.get("moe_h"),
                                  base_router=base_router, spec=mel.spec,
                                  cache_capacity=mel.cache_capacity, top_k=top_k)
    return losses[0] + cs, losses[1] + rm


def apply_model(params, cfg: ModelConfig, tokens, rt: Runtime, *, prefix_embed=None,
                melinoe: Optional[MelinoeRun] = None, collect_probs: bool = False,
                want_cache: bool = False, cache_slots: int = 0,
                window_override: Optional[int] = None, lora=None,
                lora_scale: float = 1.0, remat: bool = False, experts=None):
    """tokens (B, T) -> (logits (B, P + T, V) fp32, aux), P the rows of
    ``prefix_embed`` (B, P, d) placed ahead of the tokens (0 without
    one; positions run over both); ``aux["cache"]``
    holds the per-group stacked block caches when ``want_cache``,
    ``aux["probs"]`` the router distributions when ``collect_probs``, and
    ``aux["cs_loss"]``/``aux["rm_loss"]`` the MELINOE losses (summed over
    the MoE layers in order, divided by their number) when ``melinoe``.

    ``remat`` recomputes each repeat's blocks in the backward pass
    (``torch.utils.checkpoint``, non-reentrant): activation memory of one
    repeat instead of all. ``experts``: each MoE block's experts (see the
    module's docstring). On a sharded ``rt`` everything is a DTensor (see
    the module's docstring)."""
    with rt.dist():
        return _apply_model(params, cfg, tokens, rt, prefix_embed=prefix_embed,
                            melinoe=melinoe, collect_probs=collect_probs,
                            want_cache=want_cache, cache_slots=cache_slots,
                            window_override=window_override, lora=lora,
                            lora_scale=lora_scale, remat=remat, experts=experts)


def _apply_model(params, cfg, tokens, rt, *, prefix_embed, melinoe, collect_probs,
                 want_cache, cache_slots, window_override, lora, lora_scale, remat,
                 experts):
    index = moe_layers(cfg)
    x = rt.constrain(embed_tokens(params, cfg, tokens, prefix_embed), rt.batch_spec_entry())
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    want_probs = collect_probs or melinoe is not None
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    losses = (zero, zero)
    cache, probs_out = {}, []
    for gi, g in enumerate(cfg.layout):
        gparams = params["groups"][f"g{gi}"]
        lora_g = lora.get(f"g{gi}") if lora is not None else None
        base_g = None
        if melinoe is not None and melinoe.base_routers is not None:
            base_g = melinoe.base_routers.get(f"g{gi}")

        # the group's values are bound now: remat recomputes the body in the
        # backward pass, after this loop has moved on to later groups
        def body(x, losses, r, g=g, gi=gi, gparams=gparams, lora_g=lora_g, base_g=base_g):
            kv, probs = {}, {}
            for pi, bname in enumerate(g.pattern):
                b = cfg.block_defs[bname]
                x, aux = apply_block_full(
                    _walk_params(params, gparams, b, gi, pi, r, experts, index), cfg, b,
                    x, positions, rt,
                    window_override=window_override, want_cache=want_cache,
                    cache_slots=cache_slots, want_probs=want_probs and b.moe is not None,
                    lora=_block_lora(lora_g, pi, r), lora_scale=lora_scale)
                if b.moe is not None and melinoe is not None:
                    br = _block_lora(base_g, pi, r)  # this repeat's base router
                    losses = _melinoe_layer(losses, aux, br, melinoe, b.moe.top_k)
                if want_cache:
                    kv[pi] = aux["kv"]
                if collect_probs and "probs" in aux:
                    probs[pi] = aux["probs"]
            return x, losses, kv, probs

        kvs = [[] for _ in g.pattern]
        probs = [[] for _ in g.pattern]
        for r in range(g.repeats):
            if remat:
                x, losses, kv, pr = checkpoint(body, x, losses, r, use_reentrant=False)
            else:
                x, losses, kv, pr = body(x, losses, r)
            for pi, v in kv.items():
                kvs[pi].append(v)
            for pi, v in pr.items():
                probs[pi].append(v)
        if want_cache:
            cache[f"g{gi}"] = {f"p{pi}": _stack(c) for pi, c in enumerate(kvs)}
        probs_out += [torch.stack(p) for p in probs if p]
    logits = compute_logits(params, cfg, x, rt)
    aux = {}
    if melinoe is not None:
        n_moe = max(cfg.n_moe_layers, 1)
        aux["cs_loss"], aux["rm_loss"] = losses[0] / n_moe, losses[1] / n_moe
    if collect_probs:
        aux["probs"] = probs_out
    if want_cache:
        cache["pos"] = T
        aux["cache"] = cache
    return logits, aux


def prefill(params, cfg: ModelConfig, tokens, rt: Runtime, *, prefix_embed=None,
            n_slots: Optional[int] = None, window_override: Optional[int] = None,
            lora=None, lora_scale: float = 1.0, experts=None):
    """Process the prompt (``prefix_embed`` rows, then the tokens),
    returning (last-position logits (B,1,V), cache); the cache holds
    ``n_slots`` positions, by default the prefix's and the tokens'.
    ``experts``: as ``apply_model``'s."""
    T = tokens.shape[1] + (prefix_embed.shape[1] if prefix_embed is not None else 0)
    logits, aux = apply_model(params, cfg, tokens, rt, prefix_embed=prefix_embed,
                              want_cache=True, cache_slots=n_slots or T,
                              window_override=window_override, lora=lora,
                              lora_scale=lora_scale, experts=experts)
    return logits[:, -1:], aux["cache"]


# ---------------------------------------------------------------------------
# KV/SSM cache init + single-token decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, n_slots: int, dtype=None,
               window_override: Optional[int] = None, device=None):
    """Empty caches in prefill's layout, on ``device`` (None: cuda)."""
    dtype = cdtype(dtype or cfg.dtype)
    device = resolve_device(device)
    cache: dict = {"pos": 0}
    for gi, g in enumerate(cfg.layout):
        cache[f"g{gi}"] = {
            f"p{pi}": _stack([init_block_cache(cfg, cfg.block_defs[bname], batch,
                                               n_slots, window_override, dtype,
                                               device)] * g.repeats)
            for pi, bname in enumerate(g.pattern)
        }
    return cache


def decode_step(params, cfg: ModelConfig, tokens, cache, rt: Runtime, *,
                window_override: Optional[int] = None, collect_probs: bool = False,
                lora=None, lora_scale: float = 1.0, experts=None):
    """One autoregressive step. tokens (B, 1); ``cache["pos"]`` an int (the
    batch in lockstep) or a (B,) tensor (per-row positions). Returns
    (logits (B,1,V), cache, aux); the cache is updated in place, and
    ``aux["probs"]`` holds the router distributions when ``collect_probs``.
    ``experts``: as ``apply_model``'s."""
    with rt.dist():
        return _decode_step(params, cfg, tokens, cache, rt, window_override=window_override,
                            collect_probs=collect_probs, lora=lora, lora_scale=lora_scale,
                            experts=experts)


def _decode_step(params, cfg, tokens, cache, rt, *, window_override, collect_probs, lora,
                 lora_scale, experts):
    index = moe_layers(cfg)
    pos = cache["pos"]
    x = rt.constrain(embed_tokens(params, cfg, tokens), rt.batch_spec_entry())
    probs_out = []
    for gi, g in enumerate(cfg.layout):
        gparams, gcache = params["groups"][f"g{gi}"], cache[f"g{gi}"]
        lora_g = lora.get(f"g{gi}") if lora is not None else None
        probs = [[] for _ in g.pattern]
        for r in range(g.repeats):
            for pi, bname in enumerate(g.pattern):
                b = cfg.block_defs[bname]
                c = _index(gcache[f"p{pi}"], r)  # views into the stacked cache
                x, new_c, aux = apply_block_decode(
                    _walk_params(params, gparams, b, gi, pi, r, experts, index), cfg, b,
                    x, c, pos, rt,
                    window_override=window_override,
                    want_probs=collect_probs and b.moe is not None,
                    lora=_block_lora(lora_g, pi, r), lora_scale=lora_scale)
                for dst, src in zip(c, new_c):
                    if src is not dst and (is_distributed(src) or dispatch.is_fake(src)
                                           or src.data_ptr() != dst.data_ptr()):
                        dst.copy_(src)
                if "probs" in aux:
                    probs[pi].append(aux["probs"])
        probs_out += [torch.stack(p) for p in probs if p]
    cache["pos"] = pos + 1
    return compute_logits(params, cfg, x, rt), cache, (
        {"probs": probs_out} if collect_probs else {})
