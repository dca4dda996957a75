"""Expert activation predictor Psi (paper Sec 3.1.2), counterpart of
``repro/core/predictor.py``.

Psi_EMB: the paper uses BGE-Base-EN-v1.5 (768-dim); offline, a frozen
deterministic *bag-of-embedding* encoder with the same interface stands
in: a fixed random table indexed by token id, mean-pooled over the
prompt. The table is the reference's numpy draw (``default_rng(17)``,
float32 / sqrt(768)), so it is bit-equal to the JAX package's.

Psi_MLP: 2-layer MLP 768 -> 1024 -> L*E trained with row-wise KL against
the per-layer mean router distribution Y(q) (Table 8: SGD, momentum 0.9,
lr 2e-4, batch 16, 10 epochs). Its initial weights come from a
``torch.Generator`` (the bits differ from ``jax.random``; carry a JAX
init across with ``bridge.predictor_from_jax``); the batch order is the
reference's ``np.random.default_rng(seed)`` permutation, so a bridged
init follows the reference's trajectory.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

D_EMB = 768
D_HIDDEN = 1024


class PromptEmbedder:
    def __init__(self, vocab: int, d_emb: int = D_EMB, seed: int = 17, device="cpu"):
        rng = np.random.default_rng(seed)
        table = rng.standard_normal((vocab, d_emb), np.float32) / np.sqrt(d_emb)
        self.table = torch.from_numpy(np.asarray(table, dtype=np.float32)).to(device)

    def __call__(self, tokens) -> torch.Tensor:
        """tokens (T,) or (B, T) -> (d_emb,) or (B, d_emb) mean-pooled."""
        idx = torch.as_tensor(tokens, dtype=torch.long, device=self.table.device)
        return self.table[idx].mean(dim=-2)


def init_predictor(n_layers: int, n_experts: int, *, generator: torch.Generator,
                   d_emb: int = D_EMB, d_hidden: int = D_HIDDEN, device=None) -> dict:
    """Standard-normal fan-in weights, zero biases, fp32; ``generator``
    must live on ``device`` (default: the generator's)."""
    device = torch.device(device or generator.device)
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    return {
        "w1": torch.randn((d_emb, d_hidden), **kw) / np.sqrt(d_emb),
        "b1": torch.zeros((d_hidden,), dtype=torch.float32, device=device),
        "w2": torch.randn((d_hidden, n_layers * n_experts), **kw) / np.sqrt(d_hidden),
        "b2": torch.zeros((n_layers * n_experts,), dtype=torch.float32, device=device),
        "_dims": (n_layers, n_experts),
    }


def predictor_logits(params, emb: torch.Tensor) -> torch.Tensor:
    """emb (..., d_emb) -> (..., L, E) unnormalized preference scores."""
    L, E = params["_dims"]
    h = torch.relu(emb @ params["w1"] + params["b1"])  # gradient 0 at 0, as jax.nn.relu
    out = h @ params["w2"] + params["b2"]
    return out.reshape(*emb.shape[:-1], L, E)


def predictor_kl_loss(params, emb: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Row-wise KL(target || softmax(pred)). target (..., L, E) normalized."""
    logq = torch.log_softmax(predictor_logits(params, emb), dim=-1)
    t = target / torch.clamp(target.sum(-1, keepdim=True), min=1e-9)
    kl = (t * (torch.log(torch.clamp(t, min=1e-9)) - logq)).sum(-1)
    return kl.mean()


def train_predictor(params, embs: torch.Tensor, targets: torch.Tensor, *, lr: float = 2e-4,
                    momentum: float = 0.9, epochs: int = 10, batch_size: int = 16,
                    seed: int = 0) -> Tuple[dict, List[float]]:
    """SGD+momentum per paper Table 8, on the device of ``params``. embs
    (N, d_emb), targets (N, L, E) per-layer mean router probs Y(q).
    Returns (new params, per-epoch mean loss history); ``params`` is left
    as it is."""
    dims = params["_dims"]
    dev = params["w1"].device
    weights = {k: v.detach().clone() for k, v in params.items() if k != "_dims"}
    vel = {k: torch.zeros_like(v) for k, v in weights.items()}
    embs = torch.as_tensor(embs, dtype=torch.float32, device=dev)
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    n = embs.shape[0]
    rng = np.random.default_rng(seed)
    history = []
    for _ in range(epochs):
        order = rng.permutation(n)
        ep_loss, nb = 0.0, 0
        for s in range(0, n, batch_size):
            idx = torch.as_tensor(order[s: s + batch_size], device=dev)
            w = {k: v.requires_grad_() for k, v in weights.items()}
            loss = predictor_kl_loss({**w, "_dims": dims}, embs[idx], targets[idx])
            grads = torch.autograd.grad(loss, list(w.values()))
            with torch.no_grad():
                for (k, v), g in zip(w.items(), grads):
                    vel[k] = momentum * vel[k] + g
                    weights[k] = v.detach() - lr * vel[k]
            ep_loss += float(loss.detach())
            nb += 1
        history.append(ep_loss / max(nb, 1))
    return {**weights, "_dims": dims}, history


@torch.no_grad()
def predict_topc(params, emb: torch.Tensor, capacity: int) -> np.ndarray:
    """emb (d_emb,) -> (L, C) predicted Top-C expert ids per layer (Eq. 7);
    equal scores rank the lower id first (a stable sort, as jnp.argsort)."""
    scores = predictor_logits(params, emb.to(params["w1"].device))
    return torch.argsort(-scores, dim=-1, stable=True)[..., :capacity].cpu().numpy()


@torch.no_grad()
def predict_scores(params, emb: torch.Tensor) -> np.ndarray:
    return predictor_logits(params, emb.to(params["w1"].device)).cpu().numpy()


def build_targets(probs_list: List[torch.Tensor]) -> torch.Tensor:
    """Stacked per-(group, position) router probs [(R, B, T, E), ...] ->
    Y (B, L, E): per-layer mean over tokens (Sec 3.1.2)."""
    return torch.cat([p.mean(dim=2).transpose(0, 1) for p in probs_list], dim=1)
