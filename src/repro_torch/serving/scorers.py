"""Per-request expert-preference scorers for the affinity scheduler
(counterpart of ``repro/serving/scorers.py``), same (L, E) score contract
as ``core.predictor``:

* ``prefill_expert_scores`` — "oracle" profile from the request's own
  prompt: one collect-probs forward pass, mean router distribution per
  layer. No training needed; this is the upper bound the Psi predictor
  approximates (Sec 3.1.2).
* ``predictor_expert_scores`` — the trained Psi_MLP over the frozen
  prompt embedder (Eq. 7).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.predictor import PromptEmbedder, predict_scores
from ..models.model import apply_model
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


def prefill_expert_scores(cfg: ModelConfig, params,
                          requests: Sequence[ServeRequest], *,
                          rt: Optional[Runtime] = None, lora=None,
                          lora_scale: float = 1.0) -> List[np.ndarray]:
    """Annotate ``requests`` in place with oracle prompt profiles."""
    scores = []
    for r in requests:
        s = prompt_router_profile(cfg, params, r.prompt, rt=rt, lora=lora,
                                  lora_scale=lora_scale)
        r.expert_scores = s
        scores.append(s)
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
