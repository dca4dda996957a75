"""Cache-simulation loss L_cs (paper Sec 3.1.1, App C.1), counterpart of
``repro/core/cache_sim.py``.

A differentiable *soft cache state* c^(t) in R^E_{>=0} with ||c||_1 = C is
maintained by the Z-normalized recursion of Prop C.3:

    c^(t+1) = (gamma * Z^(t) * c^(t) + r^(t)) / Z^(t+1)
    Z^(t+1) = gamma * Z^(t) + K / C

and the loss is the cache-miss proxy  mean_t <r^(t), 1 - c^(t)>.

``r`` is the Top-K request vector: ``soft`` (Top-K-masked probabilities
renormalized to L1 mass K), ``hard`` (the binary mask) or ``hard_st``
(straight-through: the mask forward, the masked probabilities' gradient).

Both evaluations of the recursion take a batch: ``r`` may be (T, E) or
(..., T, E), every leading index an independent sequence.

* ``scan`` (:func:`soft_cache_states`, the paper's and the default): a
  Python loop over T, each step vectorized over the batch and experts.
  It is T small ops per MoE layer, forward and backward.
* ``assoc`` (:func:`soft_cache_states_assoc`): the discounted counts
  ``Count_t = gamma Count_{t-1} + r_{t-1}`` by a log-depth doubling scan
  over ``(a, b)`` pairs (PyTorch has no ``associative_scan``), then
  renormalized to mass C. A closed form with ``gamma**-t`` would overflow
  fp32 past T of about 840 and lose precision well before it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def topk_request(probs: torch.Tensor, k: int, mode: str = "soft") -> torch.Tensor:
    """probs (..., E) -> request vector r (..., E) with ||r||_1 = K."""
    _, eids = torch.topk(probs, k, dim=-1)
    mask = torch.zeros_like(probs).scatter(-1, eids, 1.0)  # out of place: DTensors too
    if mode == "hard":
        return mask
    pm = probs * mask
    if mode not in ("soft", "hard_st"):
        raise ValueError(f"unknown request mode {mode!r}")
    scaled = pm * (k / torch.clamp(pm.sum(-1, keepdim=True), min=1e-9))
    if mode == "soft":
        return scaled
    return mask + scaled - scaled.detach()


def _z_steps(T: int, gamma: float, cache_capacity: int, top_k: int):
    """The data-independent normalizers of the recursion, in fp32 as the
    reference's carry holds them: per step (gamma * Z^(t), Z^(t+1))."""
    g, kc = np.float32(gamma), np.float32(top_k / float(cache_capacity))
    z = np.float32(1.0)
    out = []
    for _ in range(T):
        z_new = np.float32(g * z + kc)
        out.append((float(np.float32(g * z)), float(z_new)))
        z = z_new
    return out


def soft_cache_states(r: torch.Tensor, gamma: float, cache_capacity: int, top_k: int,
                      init: Optional[torch.Tensor] = None):
    """r (..., T, E) requests -> (c (..., T, E), final_c (..., E)).

    c[t] is the cache state *seen by* token t (built from requests < t).
    Uniform initialization with ||c^(1)||_1 = C (App C.1 option that
    avoids the cache-fill phase)."""
    T, E = r.shape[-2:]
    C = float(cache_capacity)
    rf = r.float()
    c = (torch.full((E,), C / E, dtype=torch.float32, device=r.device)
         if init is None else init.float()).expand(*r.shape[:-2], E)
    states = []
    for t, (gz, z_new) in enumerate(_z_steps(T, gamma, cache_capacity, top_k)):
        states.append(c)
        c = torch.add(rf[..., t, :], c, alpha=gz) / z_new
    return torch.stack(states, dim=-2), c


def soft_cache_states_assoc(r: torch.Tensor, gamma: float, cache_capacity: int,
                            init: Optional[torch.Tensor] = None):
    """Log-depth equivalent of :func:`soft_cache_states`: by Prop C.3 the
    state is the gamma-discounted count renormalized to L1 mass C,

        Count_1 = init,  Count_t = gamma Count_{t-1} + r_{t-1},
        c_t     = C Count_t / ||Count_t||_1,

    and the Count recursion, pairs ``x -> a x + b`` composed right after
    left, is prefix-scanned by doubling: ceil(log2 T) steps, each
    vectorized over (..., T, E)."""
    T, E = r.shape[-2:]
    C = float(cache_capacity)
    rf = r.float()
    lead = rf.shape[:-2]
    init = (torch.full((E,), C / E, dtype=torch.float32, device=r.device)
            if init is None else init.float())
    # b_t carries r_{t-1}; b_0 the initial state (the pre-state is zero)
    b = torch.cat([init.expand(*lead, 1, E), rf[..., :-1, :]], dim=-2)
    a = torch.full((T,), gamma, dtype=torch.float32, device=r.device)
    d = 1
    while d < T:  # inclusive prefix: element t composes elements t-d..t
        b = torch.cat([b[..., :d, :], a[d:, None] * b[..., :-d, :] + b[..., d:, :]], dim=-2)
        a = torch.cat([a[:d], a[:-d] * a[d:]])
        d *= 2
    counts = b
    c = counts * (C / torch.clamp(counts.sum(-1, keepdim=True), min=1e-30))
    count_fin = gamma * counts[..., -1, :] + rf[..., -1, :]  # after the last request
    c_fin = count_fin * (C / torch.clamp(count_fin.sum(-1, keepdim=True), min=1e-30))
    return c, c_fin


def cache_sim_loss(probs: torch.Tensor, *, top_k: int, gamma: float, cache_capacity: int,
                   request_mode: str = "soft", impl: str = "assoc") -> torch.Tensor:
    """probs (B, T, E) router distributions of ONE layer -> scalar:
    mean over batch of (1/T) sum_t <r_t, 1 - c_t>  (Eq. 4, one-layer slice).

    ``impl``: "scan" (paper-faithful sequential recursion) or "assoc"
    (the same values by a log-depth scan)."""
    r = topk_request(probs.float(), top_k, request_mode)
    if impl == "assoc":
        cs, _ = soft_cache_states_assoc(r, gamma, cache_capacity)
    elif impl == "scan":
        cs, _ = soft_cache_states(r, gamma, cache_capacity, top_k)
    else:
        raise ValueError(f"unknown cache-state impl {impl!r}")
    miss = (r * (1.0 - cs)).sum(-1)  # (B, T)
    return miss.mean(-1).mean()


# ---------------------------------------------------------------------------
# Hard (non-differentiable) counterparts — Def C.1, used by tests to
# cross-check the soft proxy.
# ---------------------------------------------------------------------------


@torch.no_grad()
def hard_cache_misses(r_hard: torch.Tensor, gamma: float, cache_capacity: int,
                      init_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary requests r (T, E) -> total misses under the gamma-discounted
    Top-C cache of Def C.1 (scalar fp32). The cache is the Top-C of the
    discounted counts before each request; equal counts rank the lower
    expert id first, as ``lax.top_k`` does."""
    T, E = r_hard.shape
    C = cache_capacity
    counts = (torch.full((E,), C / E, dtype=torch.float32, device=r_hard.device)
              if init_counts is None else init_counts.float().clone())
    rf = r_hard.float()
    misses = torch.zeros((), dtype=torch.float32, device=r_hard.device)
    for t in range(T):
        top = torch.sort(counts, descending=True, stable=True).indices[:C]
        in_cache = torch.zeros(E, dtype=torch.bool, device=r_hard.device)
        in_cache[top] = True
        misses = misses + (rf[t] * (~in_cache)).sum()
        counts = gamma * counts + rf[t]
    return misses


def replay_trace_misses(routing, cache_capacity: int, policy: str = "gamma",
                        gamma: float = 0.9, num_experts: Optional[int] = None) -> int:
    """Replay an integer Top-K id trace (T, K) through the real
    eviction-based cache (the port's numpy ``LayerExpertCache``) in one
    ``access_batch`` call and return the miss count: the cache the
    offload engine runs, the ground truth the soft proxy must rank
    consistently with."""
    from .expert_cache import LayerExpertCache

    routing = np.asarray(routing)
    E = num_experts or max(int(routing.max()) + 1, cache_capacity)
    cache = LayerExpertCache(E, cache_capacity, policy, gamma)
    cache.access_batch(routing)
    return cache.misses
