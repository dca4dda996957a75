"""Batched serving engine over the full model (fits-in-memory path),
counterpart of ``repro/inference/engine.py``: static batching, left
padding, one prefill, then decode steps, greedy or sampled per row, with
optional MELINOE router-probe collection (``collect_probs``).

The memory-constrained path is ``core.offload_engine.OffloadedMoEEngine``.
Sampled rows draw from ``sampling.row_generator(seed, row, step)``: the
reference's ``jax.random`` stream cannot be reproduced, so sampled tokens
are the port's own (greedy ones are the reference's).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.model import decode_step, prefill
from ..models.runtime import Runtime
from .sampling import greedy, row_generator, sample_per_row


@dataclass
class Request:
    prompt: np.ndarray  # (T,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    stop_tokens: tuple = ()  # token ids that terminate the completion


@dataclass
class Completion:
    tokens: np.ndarray
    router_probs: Optional[np.ndarray] = None  # (L, T_gen, E)
    finish_reason: str = "length"  # "stop" | "length"


def truncate_at_stop(tokens: np.ndarray, stop_tokens) -> tuple:
    """Cut ``tokens`` at the first stop token (inclusive). Returns
    (tokens, finish_reason)."""
    toks = np.asarray(tokens)
    if stop_tokens:
        hit = np.isin(toks, list(stop_tokens))
        if hit.any():
            return toks[: int(np.argmax(hit)) + 1], "stop"
    return toks, "length"


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, rt: Optional[Runtime] = None,
                 lora=None, lora_scale: float = 1.0, max_batch: int = 8,
                 window_override: Optional[int] = None):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.rt = rt or Runtime(device=self.device, zero_drop=True)
        self.lora = lora
        self.lora_scale = lora_scale
        self.max_batch = max_batch
        self.window_override = window_override

    @torch.inference_mode()
    def generate_batch(self, requests: Sequence[Request], *,
                       collect_probs: bool = False, seed: int = 0) -> List[Completion]:
        """Static batching: left-pad prompts to a common length (with token
        0, unmasked, as the reference does), prefill once, decode to the
        max requested length. The first token is greedy; after it a row
        with ``temperature`` > 0 samples, keyed by (``seed``, row, step).
        ``collect_probs`` gives each completion the router distributions
        of its decode steps, (L, max_new - 1, E)."""
        assert len(requests) <= self.max_batch
        B = len(requests)
        lens = [len(r.prompt) for r in requests]
        T = max(lens)
        toks = np.zeros((B, T), np.int64)
        for i, r in enumerate(requests):
            toks[i, T - lens[i]:] = r.prompt  # left padding
        max_new = max(r.max_new_tokens for r in requests)
        n_slots = T + max_new

        logits, cache = prefill(self.params, self.cfg,
                                torch.as_tensor(toks, device=self.device), self.rt,
                                n_slots=n_slots, window_override=self.window_override,
                                lora=self.lora, lora_scale=self.lora_scale)
        temps = np.asarray([r.temperature for r in requests], np.float32)
        cur = greedy(logits)
        outs = [cur]
        probs_steps = []
        for step in range(1, max_new):
            logits, cache, aux = decode_step(self.params, self.cfg, cur, cache, self.rt,
                                             window_override=self.window_override,
                                             collect_probs=collect_probs, lora=self.lora,
                                             lora_scale=self.lora_scale)
            if collect_probs and aux["probs"]:
                # aux["probs"]: list of (R, B, 1, E) -> (B, L, E)
                p = torch.cat([a[:, :, 0] for a in aux["probs"]], dim=0)
                probs_steps.append(p.transpose(0, 1).float().cpu().numpy())
            if np.any(temps > 0):
                cur = sample_per_row(logits, temps,
                                     [row_generator(seed, i, step) for i in range(B)])
            else:
                cur = greedy(logits)
            outs.append(cur)
        gen = torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)  # (B, max_new)
        completions = []
        for i, r in enumerate(requests):
            rp = None
            if collect_probs and probs_steps:
                rp = np.stack([p[i] for p in probs_steps], axis=1)  # (L, T_gen, E)
            toks_i, reason = truncate_at_stop(gen[i, : r.max_new_tokens], r.stop_tokens)
            completions.append(Completion(tokens=toks_i, router_probs=rp,
                                          finish_reason=reason))
        return completions


def routing_trace(cfg: ModelConfig, params, prompts: np.ndarray, *, max_new: int = 32,
                  rt: Optional[Runtime] = None, lora=None, lora_scale: float = 1.0):
    """Greedy-decode every prompt in one batch, returning (tokens (B,
    max_new), probs (B, L, max_new - 1, E)): the router distributions of
    every decode step, the dataset of the activation predictor (Sec
    3.1.2) and of the transfer-count benchmarks."""
    eng = ServingEngine(cfg, params, rt=rt, lora=lora, lora_scale=lora_scale,
                        max_batch=len(prompts))
    reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    comps = eng.generate_batch(reqs, collect_probs=True)
    toks = np.stack([c.tokens for c in comps])
    probs = np.stack([c.router_probs for c in comps])
    return toks, probs
