"""Per-request expert-preference scorers for the affinity scheduler
(counterpart of ``repro/serving/scorers.py``), same (L, E) score contract
as ``core.predictor``:

* ``prefill_expert_scores`` — "oracle" profile from the request's own
  prompt: one collect-probs forward pass, mean router distribution per
  layer. No training needed; this is the upper bound the Psi predictor
  approximates (Sec 3.1.2). With ``host_store`` (an offloaded model:
  ``params``' experts on ``meta``, the experts in the engine's store) the
  passes go layer-major: each MoE layer's experts are staged on the
  device once (``core.offload_engine.stage_experts``) and every request's
  hidden state goes through that layer as its own batch-1 forward, so
  the device never holds more than one layer of experts and the scores
  are the whole-tree ones, bit for bit.
* ``predictor_expert_scores`` — the trained Psi_MLP over the frozen
  prompt embedder (Eq. 7).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.predictor import PromptEmbedder, predict_scores
from ..core.offload_engine import stage_experts
from ..models.blocks import apply_block_full
from ..models.model import _block_lora, _walk_params, apply_model, embed_tokens, moe_layers
from ..models.runtime import Runtime
from .request import ServeRequest


@torch.inference_mode()
def prompt_router_profile(cfg: ModelConfig, params, prompt: np.ndarray, *,
                          rt: Optional[Runtime] = None, lora=None,
                          lora_scale: float = 1.0) -> np.ndarray:
    """One forward pass over the prompt -> (L, E) mean router probs."""
    device = params["embed"].device
    rt = rt or Runtime(device=device, zero_drop=True)
    _, aux = apply_model(params, cfg,
                         torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                         device=device)[None],
                         rt, collect_probs=True, lora=lora, lora_scale=lora_scale)
    # aux["probs"]: list of (R, 1, T, E) per (group, position) -> (L, E)
    per_layer = [p[:, 0].mean(dim=1) for p in aux["probs"]]  # [(R, E), ...]
    return torch.cat(per_layer, dim=0).float().cpu().numpy()


@torch.inference_mode()
def streamed_router_profiles(cfg: ModelConfig, params, prompts, host_store, *,
                             rt: Optional[Runtime] = None, lora=None,
                             lora_scale: float = 1.0) -> List[np.ndarray]:
    """:func:`prompt_router_profile` of every prompt, from ``params``
    without their experts and the host store ``host_store`` that holds
    them (per MoE layer, in the engine's layer order): one walk over the
    model's blocks, as ``apply_model`` walks them, each MoE layer's
    experts staged once and each prompt's hidden state run through the
    block alone (batch 1), the ops of the whole-tree pass in its order."""
    device = params["embed"].device
    rt = rt or Runtime(device=device, zero_drop=True)
    index = moe_layers(cfg)
    if len(host_store) != len(index):
        raise ValueError(f"host_store holds {len(host_store)} MoE layers, the config "
                         f"{len(index)}")

    def experts(i):
        return stage_experts(host_store[i], device)

    with rt.dist():
        xs = [embed_tokens(params, cfg, torch.as_tensor(np.asarray(p), dtype=torch.long,
                                                        device=device)[None])
              for p in prompts]
        positions = [torch.arange(x.shape[1], device=device).expand(1, x.shape[1])
                     for x in xs]
        probs: List[list] = [[] for _ in xs]  # per prompt: (R, 1, T, E) per MoE position
        for gi, g in enumerate(cfg.layout):
            gparams = params["groups"][f"g{gi}"]
            lora_g = lora.get(f"g{gi}") if lora is not None else None
            per = [[[] for _ in g.pattern] for _ in xs]
            for r in range(g.repeats):
                for pi, bname in enumerate(g.pattern):
                    b = cfg.block_defs[bname]
                    bp = _walk_params(params, gparams, b, gi, pi, r, experts, index)
                    for j, x in enumerate(xs):
                        xs[j], aux = apply_block_full(
                            bp, cfg, b, x, positions[j], rt,
                            want_probs=b.moe is not None,
                            lora=_block_lora(lora_g, pi, r), lora_scale=lora_scale)
                        if "probs" in aux:
                            per[j][pi].append(aux["probs"])
                    del bp  # the staged experts go before the next layer's
            for j in range(len(xs)):
                probs[j] += [torch.stack(p) for p in per[j] if p]
    return [torch.cat([p[:, 0].mean(dim=1) for p in pr], dim=0).float().cpu().numpy()
            for pr in probs]


def prefill_expert_scores(cfg: ModelConfig, params,
                          requests: Sequence[ServeRequest], *,
                          rt: Optional[Runtime] = None, lora=None,
                          lora_scale: float = 1.0, host_store=None) -> List[np.ndarray]:
    """Annotate ``requests`` in place with oracle prompt profiles. With
    ``host_store`` the experts come from it, one layer at a time
    (:func:`streamed_router_profiles`), and ``params``' own are not read."""
    if host_store is not None:
        scores = streamed_router_profiles(cfg, params, [r.prompt for r in requests],
                                          host_store, rt=rt, lora=lora,
                                          lora_scale=lora_scale)
    else:
        scores = [prompt_router_profile(cfg, params, r.prompt, rt=rt, lora=lora,
                                        lora_scale=lora_scale) for r in requests]
    for r, s in zip(requests, scores):
        r.expert_scores = s
    return scores


def predictor_expert_scores(predictor_params, embedder: PromptEmbedder,
                            requests: Sequence[ServeRequest]) -> List[np.ndarray]:
    """Annotate ``requests`` in place with Psi predictor scores (Eq. 7)."""
    scores = []
    for r in requests:
        s = predict_scores(predictor_params, embedder(r.prompt))
        r.expert_scores = s
        scores.append(s)
    return scores
