"""Parameter init, embeddings and logits (counterpart of
``repro/models/model.py``, unsharded; the scanned full-model forward
waits — the offload engine walks the layers itself).

Parameter dict, keyed as the JAX tree:
  params = {
    "embed": (V, d),
    "lm_head": (d, V)           # absent when tie_embeddings
    "final_norm": (d,),
    "groups": {"g0": {"p0": block params stacked over repeats (R, ...)}},
  }
"""
from __future__ import annotations

import torch

from ..configs.base import BlockSpec, ModelConfig
from .attention import init_attn
from .common import cdtype, dense_init, embed_init, rms_norm, rms_norm_init, softcap
from .moe import init_moe


def init_block(cfg: ModelConfig, b: BlockSpec, dtype, *, generator, device,
               lead=(), expert_device=None):
    if b.kind != "attn_moe":
        raise NotImplementedError(f"block kind {b.kind!r} is not ported yet")
    kw = dict(generator=generator, device=device, lead=lead)
    p = {"ln1": rms_norm_init(cfg.d_model, dtype, device=device, lead=lead),
         "mixer": init_attn(cfg.d_model, b.attn, dtype, **kw),
         "ln2": rms_norm_init(cfg.d_model, dtype, device=device, lead=lead)}
    p["ffn"] = init_moe(cfg.d_model, b.moe, dtype, expert_device=expert_device, **kw)
    return p


def init_params(cfg: ModelConfig, *, generator: torch.Generator, dtype=None,
                device=None, expert_device=None):
    """Random weights with the JAX tree's key layout (the random bits
    differ from ``jax.random``). ``generator`` must live on ``device``.

    ``expert_device``: keep the MoE expert weights there (e.g. "cpu" for a
    full-width model served from host memory); they are drawn on
    ``device`` one layer at a time and moved."""
    dtype = cdtype(dtype or cfg.dtype)
    device = torch.device(device or generator.device)
    kw = dict(generator=generator, device=device)
    params: dict = {
        "embed": embed_init(cfg.vocab, cfg.d_model, dtype, **kw),
        "final_norm": rms_norm_init(cfg.d_model, dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(cfg.d_model, cfg.vocab, dtype, **kw)
    groups = {}
    for gi, g in enumerate(cfg.layout):
        groups[f"g{gi}"] = {
            f"p{pi}": init_block(cfg, cfg.block_defs[bname], dtype,
                                 lead=(g.repeats,), expert_device=expert_device,
                                 **kw)
            for pi, bname in enumerate(g.pattern)
        }
    params["groups"] = groups
    return params


def embed_tokens(params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
    return x


def compute_logits(params, cfg: ModelConfig, x):
    """Final norm + LM head; logits in fp32 (after the optional softcap)."""
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap((x @ head).float(), cfg.logit_softcap)
