"""Self-contained AdamW + linear-warmup/linear-decay schedule (paper
Table 7: AdamW, linear schedule, warmup ratio 0.03), counterpart of
``repro/training/optim.py``.

The math is the reference's: fp32 moments, the update computed in fp32
and cast back to the parameter's dtype, clipping on the global norm of
the (masked) gradients, and the learning rate and bias corrections
evaluated in fp32 as the reference's traced step does.

Two differences of bookkeeping, not of result:

* moments are kept only for trainable leaves. The reference keeps a zero
  moment for every frozen leaf and never reads it, so every trainable
  leaf and every moment it keeps come out the same. At OLMoE-1B-7B's
  width fp32 moments for all 6.9 B parameters would take 55 GB alone.
* parameters and moments are updated in place (under ``no_grad``), one
  slice of the leading dimension at a time, so that the fp32 temporaries
  of a stacked leaf (16 x 64 experts at OLMoE's width) stay one repeat
  large.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 1e-5  # paper Table 7
    total_steps: int = 1000
    warmup_ratio: float = 0.03
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    min_lr_frac: float = 0.0


def schedule(step: int, cfg: OptConfig) -> float:
    """The learning rate at ``step`` (fp32 arithmetic, as the reference)."""
    f = np.float32
    warm = max(int(cfg.total_steps * cfg.warmup_ratio), 1)
    s = f(step)
    if s < warm:
        return float(f(f(cfg.peak_lr) * s) / f(warm))
    frac = min(max(f(s - f(warm)) / f(max(cfg.total_steps - warm, 1)), f(0.0)), f(1.0))
    return float(f(cfg.peak_lr) * f(f(1.0) - f(f(1.0 - cfg.min_lr_frac) * f(frac))))


def _leaves(tree, mask=True, path=""):
    """(path, leaf, trainable) over a tree of dicts and tuples, dict keys in
    sorted order (``jax.tree.leaves``' order); ``mask`` a bool or a tree of
    bools of the same shape. A list is a leaf: a stacked leaf's gradient
    given as per-repeat slices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], mask[k] if isinstance(mask, dict) else mask,
                               f"{path}/{k}")
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from _leaves(t, mask[i] if isinstance(mask, tuple) else mask,
                               f"{path}/{i}")
    else:
        yield path, tree, bool(mask)


def init_opt_state(params, mask=True) -> dict:
    """``{"mu", "nu": {path: fp32 zeros}, "step": 0}`` for the leaves that
    ``mask`` (a bool or a bool tree) marks trainable."""
    zeros = {p: torch.zeros_like(t, dtype=torch.float32)  # placed as t on a mesh
             for p, t, m in _leaves(params, mask) if m}
    return {"mu": zeros, "nu": {p: torch.zeros_like(z) for p, z in zeros.items()},
            "step": 0}


def _split(g) -> bool:
    """Whether a gradient leaf is taken slice by slice along its leading
    dimension: a list (one autograd leaf per repeat) or a stacked tensor."""
    return isinstance(g, list) or g.dim() >= 3


def _slices(t, split: bool) -> list:
    return list(t) if split else [t]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (fp32); a leaf may be a
    list of slices; ``None`` leaves are skipped."""
    total = None
    for _, leaf, _ in _leaves(tree):
        if leaf is None:
            continue
        for s in _slices(leaf, _split(leaf)):
            sq = s.float().square().sum()
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptConfig, mask=True):
    """One AdamW step, in place: the trainable leaves of ``params`` (those
    ``mask`` marks; a bool or a bool tree) and the moments of
    ``opt_state``. ``grads`` mirrors ``params``; a frozen leaf's gradient
    is ignored (``None`` will do), a trainable one may be a list of
    per-repeat slices. Clipping uses the norm over the trainable leaves'
    gradients (the reference masks the frozen ones to zero first).
    Returns (params, opt_state, {"lr": lr})."""
    step = opt_state["step"] + 1
    lr = schedule(step, cfg)
    f = np.float32
    bc1 = float(f(1.0) - f(cfg.b1) ** f(step))
    bc2 = float(f(1.0) - f(cfg.b2) ** f(step))
    pairs = [(path, p, g) for (path, p, m), (_, g, _) in
             zip(_leaves(params, mask), _leaves(grads, mask)) if m]
    scale = None
    if cfg.clip_norm is not None:
        gn = global_norm(tuple(g for _, _, g in pairs))
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    for path, p, g in pairs:
        mu, nu = opt_state["mu"][path], opt_state["nu"][path]
        split = _split(g)
        for pi, gi, mi, vi in zip(*(_slices(t, split) for t in (p, g, mu, nu))):
            g32 = gi.float() if scale is None else gi.float() * scale
            mi.mul_(b1).add_(g32, alpha=1 - b1)
            vi.mul_(b2).add_(g32.square(), alpha=1 - b2)
            u = (mi / bc1) / (torch.sqrt(vi / bc2) + cfg.eps)
            p32 = pi.float()
            if cfg.weight_decay:
                u = u + cfg.weight_decay * p32
            pi.copy_((p32 - lr * u).to(pi.dtype))
    opt_state["step"] = step
    return params, opt_state, {"lr": lr}
