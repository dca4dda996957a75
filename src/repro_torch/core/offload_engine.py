"""Offloaded MoE inference engine, slab implementation (paper Sec 3.2,
Eq. 3; counterpart of ``repro/core/offload_engine.py`` with
``impl="slab"``).

  * resident pool — per-MoE-layer *slabs* on the device: stacked
                    ``wg/wu (C, d, f)``, ``wd (C, f, d)`` buffers with a
                    slot free-list, overwritten in place;
  * offload pool  — every expert of every layer in **pinned** host
                    memory (one ``(E, 3, d*f)`` buffer per layer);
  * miss          — a ``non_blocking`` host->device copy of the expert's
                    three matrices into a slab slot (it replaces the JAX
                    engine's donated ``.at[slot].set``), counted and
                    costed by Eq. 3.

Per MoE layer and step: attention + router, then the vectorized host
cache accounting (``LayerExpertCache.access_batch``), then one grouped
``moe_gmm`` per projection over the C slots (tokens sorted into
per-slot buffers, ragged group sizes), plus an overflow group for the
experts this step needs that the slab could not hold. The port runs
eagerly, so the JAX engine's compact variant and fused moe(l)+pre(l+1)
call — XLA launch optimisations with identical results — are not
ported.

Beside the two modeled clocks the engine reports measured wall-clock
prefill seconds and decode tokens/s on its device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.moe_gmm import ops as gmm_ops
from ..models.attention import attend_full, cache_from_prefill, decode_attend
from ..models.common import rms_norm, silu
from ..models.mlp import apply_mlp
from ..models.model import compute_logits, embed_tokens
from ..models.moe import (Dispatch, combine_tokens, dispatch_tokens,
                          router_probs, top_k_route)
from ..models.runtime import Runtime, resolve_device
from .expert_cache import ModelExpertCache

_EXPERT_KEYS = ("wg", "wu", "wd")


# ---------------------------------------------------------------------------
# Hardware profile (H100 datasheet constants; PCIe gen5 host link)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareProfile:
    name: str = "h100-pcie5"
    peak_flops: float = 989e12  # bf16 dense
    hbm_bw: float = 3350e9
    host_link_bw: float = 64e9  # host<->device copies (PCIe gen5 x16)
    transfer_latency: float = 30e-6  # per-transfer fixed cost
    mfu: float = 0.4  # assumed compute efficiency for Eq. 3


# ---------------------------------------------------------------------------
# Metrics: serial Eq. 3 clock + overlapped prefetch clock
# ---------------------------------------------------------------------------


@dataclass
class EngineMetrics:
    decode_tokens: int = 0
    transfers: int = 0
    transfer_bytes: int = 0
    prefetch_transfers: int = 0
    prefetch_bytes: int = 0
    compute_flops: float = 0.0
    wall_time: float = 0.0  # measured seconds of the last generate call
    prefill_wall_time: float = 0.0  # ... of its prefill (device synchronized)
    decode_wall_time: float = 0.0  # ... of its decode steps
    # per engine step (prefill counts as one, then one per decode step):
    # total flops and per-MoE-layer demand-transfer counts/bytes — the
    # event records behind the overlapped clock
    step_flops: List[float] = field(default_factory=list)
    step_tx: List[np.ndarray] = field(default_factory=list)
    step_tx_bytes: List[np.ndarray] = field(default_factory=list)

    def begin_step(self, n_moe_layers: int) -> None:
        self.step_flops.append(0.0)
        self.step_tx.append(np.zeros(n_moe_layers, np.int64))
        self.step_tx_bytes.append(np.zeros(n_moe_layers, np.int64))

    def add_flops(self, flops: float) -> None:
        self.compute_flops += flops
        if self.step_flops:
            self.step_flops[-1] += flops

    def add_demand_transfers(self, moe_idx: int, n: int, nbytes: int) -> None:
        self.transfers += n
        self.transfer_bytes += nbytes
        if self.step_tx:
            self.step_tx[-1][moe_idx] += n
            self.step_tx_bytes[-1][moe_idx] += nbytes

    def add_prefetch_transfers(self, moe_idx: int, n: int, nbytes: int) -> None:
        """Proactive (predictor-driven) transfers: real link traffic, but
        charged outside the demand clocks."""
        self.prefetch_transfers += n
        self.prefetch_bytes += nbytes

    def modeled_time(self, hw: HardwareProfile) -> float:
        """Eq. 3, serial: Time_decode ~ Time_compute + N_miss * Time_transfer."""
        t_compute = self.compute_flops / (hw.peak_flops * hw.mfu)
        t_transfer = (self.transfer_bytes / hw.host_link_bw
                      + self.transfers * hw.transfer_latency)
        return t_compute + t_transfer

    def overlapped_span(self, hw: HardwareProfile) -> float:
        """Eq. 3 with cross-layer prefetch hiding: layer ``l``'s router
        output issues layer ``l+1``'s fetches, so a step costs
        ``t_tx[0] + sum_l max(t_compute_l, t_tx[l+1])`` with the step's
        compute split uniformly over its MoE layers."""
        speed = hw.peak_flops * hw.mfu
        total = 0.0
        for flops, tx, txb in zip(self.step_flops, self.step_tx,
                                  self.step_tx_bytes):
            L = len(tx)
            if L == 0:
                total += flops / speed
                continue
            t_tx = txb / hw.host_link_bw + tx * hw.transfer_latency
            seg = flops / speed / L
            t = float(t_tx[0])  # the first layer's fetches hide nothing
            for l in range(L):
                t += max(seg, float(t_tx[l + 1]) if l + 1 < L else 0.0)
            total += t
        return total

    def modeled_time_overlapped(self, hw: HardwareProfile) -> float:
        """Always <= :meth:`modeled_time` (``max(a, b) <= a + b``)."""
        if not self.step_flops:
            return self.modeled_time(hw)
        return self.overlapped_span(hw)

    def throughput(self, hw: HardwareProfile, batch: int = 1,
                   overlap: bool = False) -> float:
        t = self.modeled_time_overlapped(hw) if overlap else self.modeled_time(hw)
        return (self.decode_tokens * batch) / max(t, 1e-12)


# ---------------------------------------------------------------------------
# Resident slab: stacked per-layer expert buffers with a slot free-list
# ---------------------------------------------------------------------------


class ExpertSlab:
    """Device-resident expert weights for ONE MoE layer: ``buffers`` maps
    wg/wu/wd to tensors with a leading slot axis of size ``C``. Slots are
    recycled through a free-list and overwritten in place."""

    def __init__(self, num_experts: int, capacity: int,
                 buffers: Dict[str, torch.Tensor]):
        self.C = capacity
        self.buffers = buffers
        self.residents: set = set()
        self.free: List[int] = list(range(capacity - 1, -1, -1))
        # expert id -> slot (C == "absent" sentinel; also the dispatch
        # drop index)
        self.slot_of_expert = np.full(num_experts, capacity, np.int64)
        self.last_use: Dict[int, int] = {}  # physical LRU over compute use
        self.tick = 0

    def drop(self, e: int) -> None:
        self.free.append(int(self.slot_of_expert[e]))
        self.slot_of_expert[e] = self.C
        self.residents.discard(e)
        self.last_use.pop(e, None)

    def claim(self, e: int) -> int:
        """Assign a free slot to expert ``e`` (bookkeeping only; the
        caller copies the weights)."""
        slot = self.free.pop()
        self.slot_of_expert[e] = slot
        self.residents.add(e)
        return slot


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


class OffloadedMoEEngine:
    """Greedy decoding with a per-layer offloaded expert cache."""

    def __init__(self, cfg: ModelConfig, params, *, capacity: int,
                 policy: str = "lfu", gamma: float = 0.9,
                 hw: HardwareProfile = HardwareProfile(),
                 kernel_backend: str = "auto", device=None):
        assert cfg.has_router, "offload engine needs an MoE architecture"
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rt = Runtime(kernel_backend=kernel_backend, device=self.device)
        self.hw = hw
        self.capacity = capacity
        self.moe_spec = cfg.moe_spec
        E, d, f = self.moe_spec.num_experts, cfg.d_model, self.moe_spec.d_ff
        dev = self.device
        pin = dev.type == "cuda"

        # ---- unstack the scanned groups into a flat per-layer list; the
        # expert weights go to the pinned host store, the rest to the device
        self.layers: List[dict] = []  # {"spec", "params", "moe_idx"}
        self.moe_layer_ids: List[int] = []
        # per MoE layer: wg/wu/wd (E, ...) views of one pinned (E, 3, d*f) buffer
        self.host_store: List[Dict[str, torch.Tensor]] = []
        for gi, g in enumerate(cfg.layout):
            gparams = params["groups"][f"g{gi}"]
            for r in range(g.repeats):
                for pi, bname in enumerate(g.pattern):
                    b = cfg.block_defs[bname]
                    if b.kind != "attn_moe":
                        raise NotImplementedError(
                            f"block kind {b.kind!r}: only attn_moe is ported")
                    bp = gparams[f"p{pi}"]
                    ffn = bp["ffn"]
                    lp = _tree_map(lambda a: a[r].to(dev),
                                   {k: v for k, v in bp.items() if k != "ffn"})
                    lp["ffn"] = _tree_map(
                        lambda a: a[r].to(dev),
                        {k: v for k, v in ffn.items() if k not in _EXPERT_KEYS})
                    self._add_host_experts({k: ffn[k][r] for k in _EXPERT_KEYS},
                                           pin)
                    self.moe_layer_ids.append(len(self.layers))
                    self.layers.append({"spec": b, "params": lp,
                                        "moe_idx": len(self.moe_layer_ids) - 1})
        self.params_top = {k: v.to(dev) for k, v in params.items()
                           if k in ("embed", "lm_head", "final_norm")}
        wg0 = self.host_store[0]["wg"]
        self.expert_bytes = 3 * d * f * wg0.element_size()

        self.cache = ModelExpertCache(len(self.moe_layer_ids), E, capacity,
                                      policy=policy, gamma=gamma)
        self.metrics = EngineMetrics()
        self._flops_per_token = cfg.param_counts()["active"] * 2  # fwd only
        # zero-filled slabs (never-written slots hold finite values)
        self._slabs = [
            ExpertSlab(E, capacity, {
                k: torch.zeros((capacity,) + tuple(v.shape[1:]), dtype=wg0.dtype,
                               device=dev)
                for k, v in self.host_store[0].items()})
            for _ in self.moe_layer_ids
        ]
        self._overflow: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------------------
    # host store and copies
    # ------------------------------------------------------------------
    def _add_host_experts(self, w: Dict[str, torch.Tensor], pin: bool) -> None:
        """Copy one layer's (E, ...) expert matrices into a pinned host
        buffer in which each expert's three matrices are contiguous."""
        E = w["wg"].shape[0]
        buf = torch.empty((E, 3, w["wg"][0].numel()), dtype=w["wg"].dtype,
                          pin_memory=pin)
        views = {}
        for i, k in enumerate(_EXPERT_KEYS):
            buf[:, i].copy_(w[k].reshape(E, -1))
            views[k] = buf[:, i].unflatten(1, tuple(w[k].shape[1:]))
        self.host_store.append(views)

    def _load(self, moe_idx: int, e: int, dst: Dict[str, torch.Tensor],
              slot: int) -> None:
        """Host -> device copy of expert ``e`` into ``dst[k][slot]`` (async
        from pinned memory, ordered on the current stream)."""
        for k, v in self.host_store[moe_idx].items():
            dst[k][slot].copy_(v[e], non_blocking=True)

    def _overflow_buffers(self, n: int) -> Dict[str, torch.Tensor]:
        """Device buffers for ``n`` transient experts (grown on demand,
        reused by every layer: copies and kernels are stream-ordered)."""
        if self._overflow is None or self._overflow["wg"].shape[0] < n:
            self._overflow = {
                k: torch.empty((n,) + tuple(v.shape[1:]), dtype=v.dtype,
                               device=self.device)
                for k, v in self.host_store[0].items()}
        return {k: v[:n] for k, v in self._overflow.items()}

    # ------------------------------------------------------------------
    # physical residency
    # ------------------------------------------------------------------
    def _sync_slab(self, moe_idx: int) -> int:
        """Mirror the cache manager's resident set into the device slab."""
        slab = self._slabs[moe_idx]
        target = self.cache.layers[moe_idx].resident
        for e in [e for e in slab.residents if e not in target]:
            slab.drop(e)
        new = sorted(target - slab.residents)
        for e in new:
            self._load(moe_idx, e, slab.buffers, slab.claim(e))
        return len(new)

    def _ensure_resident(self, moe_idx: int, needed: List[int]) -> List[int]:
        """Physically load as many of ``needed`` as fit into the slab.

        The modeled residency/transfer accounting is the cache manager's;
        the slab is the physical pool of C device slots behind it and
        retains experts by recency of compute use, which minimizes real
        host->device traffic. Returns the experts that still did not fit
        (served by the overflow group)."""
        slab = self._slabs[moe_idx]
        slab.tick += 1
        if slab.residents.issuperset(needed):  # warm fast path
            for e in needed:
                slab.last_use[e] = slab.tick
            return []
        needed_set = set(needed)
        new = [e for e in needed if e not in slab.residents]
        evictable = sorted((e for e in slab.residents if e not in needed_set),
                           key=lambda e: slab.last_use.get(e, -1))
        load = new[: len(slab.free) + len(evictable)]
        while len(slab.free) < len(load):
            slab.drop(evictable.pop(0))
        for e in load:
            self._load(moe_idx, e, slab.buffers, slab.claim(e))
        for e in needed:
            if e in slab.residents:
                slab.last_use[e] = slab.tick
        return [e for e in needed if e not in slab.residents]

    def prefetch(self, scores: np.ndarray) -> None:
        """Predictor-driven proactive cache load (Sec 3.2). scores (L, E)."""
        self.cache.prefill_from_scores(scores)
        for moe_idx in range(len(self.moe_layer_ids)):
            added = self._sync_slab(moe_idx)
            self.metrics.add_prefetch_transfers(moe_idx, added,
                                                added * self.expert_bytes)

    # ------------------------------------------------------------------
    # grouped expert compute
    # ------------------------------------------------------------------
    def _group_core(self, w: Dict[str, torch.Tensor], slots: np.ndarray,
                    h2f, gates):
        """Sort the (N, K) top-k assignments into per-group buffers
        (``slots`` holds each assignment's group, == G where its expert is
        not in ``w``), run ONE grouped matmul per projection over all G
        groups with ragged sizes, gate-combine. The index arithmetic runs
        on the host, where the routed ids already are."""
        G = w["wg"].shape[0]
        N, K = slots.shape
        flat = slots.reshape(-1)
        oh = flat[:, None] == np.arange(G + 1)[None, :]
        pos = (np.cumsum(oh, axis=0) * oh).sum(-1) - 1  # occurrences before self
        keep = flat < G
        dev = self.device
        to_dev = lambda a: torch.as_tensor(a, dtype=torch.int32).to(dev)
        keep_t = torch.as_tensor(keep.reshape(N, K)).to(dev)
        d = Dispatch(eids=to_dev(slots), pos=to_dev(np.where(keep, pos, 0).reshape(N, K)),
                     gates=torch.where(keep_t, gates, torch.zeros((), device=dev)),
                     cap=N)
        buf = dispatch_tokens(d, h2f, G)  # (G, N, d) slot-sorted
        sizes = to_dev(oh.sum(0)[:G])  # tokens per group (ragged gmm groups)
        mm = lambda a, b: gmm_ops.gmm(a, b, sizes, backend=self.rt.kernel_backend)
        h_act = silu(mm(buf, w["wg"])) * mm(buf, w["wu"])
        return combine_tokens(d, mm(h_act, w["wd"]))  # (N, d)

    def _prep_moe(self, moe_idx: int, eids_np: np.ndarray) -> List[int]:
        """Host half of a MoE layer's step: cache accounting (one
        vectorized call), then physical residency. Returns the experts
        the slab could not hold."""
        missed = self.cache.layers[moe_idx].access_batch(eids_np)
        if missed:
            self.metrics.add_demand_transfers(moe_idx, len(missed),
                                              len(missed) * self.expert_bytes)
        return self._ensure_resident(moe_idx, sorted(set(eids_np.ravel().tolist())))

    def _finish_moe(self, layer: dict, h2f, gates, eids_np, missing):
        """Device half: grouped compute over the slab (+ the shared expert)
        and the overflow group. h2f (N, d) -> (N, d)."""
        slab = self._slabs[layer["moe_idx"]]
        y = self._group_core(slab.buffers, slab.slot_of_expert[eids_np], h2f, gates)
        if self.moe_spec.shared_d_ff:
            y = y + apply_mlp(layer["params"]["ffn"]["shared"], h2f)
        if missing:  # |needed| > C spillover / degenerate C < K
            y = y + self._overflow_group(layer["moe_idx"], h2f, gates, eids_np,
                                         missing)
        return y

    def _overflow_group(self, moe_idx: int, h2f, gates, eids_np, missing):
        """Grouped compute over a transient stack of the experts the slab
        could not hold this step."""
        w = self._overflow_buffers(len(missing))
        soe = np.full(self.moe_spec.num_experts, len(missing), np.int64)
        for i, e in enumerate(missing):
            soe[e] = i
            self._load(moe_idx, e, w, i)
        return self._group_core(w, soe[eids_np], h2f, gates)

    # ------------------------------------------------------------------
    def _forward_layers_slab(self, x, positions, caches, decode_pos=None):
        """One engine step through every layer: attention (prefill through
        the flash kernel, or one decode position), router, MoE."""
        cfg = self.cfg
        for idx, layer in enumerate(self.layers):
            b, p = layer["spec"], layer["params"]
            h = rms_norm(p["ln1"], x, cfg.norm_eps)
            if decode_pos is None:
                y, (k, v) = attend_full(p["mixer"], b.attn, h, positions,
                                        b.attn.window, return_kv=True, rt=self.rt)
                caches[idx] = cache_from_prefill(k, v, b.attn, self._n_slots)
            else:
                y, caches[idx] = decode_attend(p["mixer"], b.attn, h, caches[idx],
                                               decode_pos, b.attn.window)
            xa = x + y
            h2 = rms_norm(p["ln2"], xa, cfg.norm_eps)
            B, T, dm = h2.shape
            h2f = h2.reshape(B * T, dm)
            probs = router_probs(p["ffn"], h2f, b.moe)
            gates, eids = top_k_route(probs, b.moe.top_k)
            eids_np = eids.cpu().numpy()  # the host cache manager needs the ids
            missing = self._prep_moe(layer["moe_idx"], eids_np)
            y = self._finish_moe(layer, h2f, gates, eids_np, missing)
            x = xa + y.reshape(B, T, dm)
        return x

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate(self, prompt_tokens, max_new_tokens: int) -> dict:
        """Greedy decoding. prompt_tokens (B, T) ints. Returns a dict with
        tokens (B, max_new_tokens) int32, the last prompt position's
        logits, metrics, both Eq.-3 clocks and the measured times."""
        cfg = self.cfg
        t0 = time.perf_counter()
        toks = torch.as_tensor(prompt_tokens).to(self.device, torch.long)
        B, T = toks.shape
        L_moe = len(self.moe_layer_ids)
        self._n_slots = T + max_new_tokens

        self.metrics.begin_step(L_moe)
        x = embed_tokens(self.params_top, cfg, toks)
        positions = torch.arange(T, device=self.device).expand(B, T)
        caches: List = [None] * len(self.layers)
        x = self._forward_layers_slab(x, positions, caches)
        self.metrics.add_flops(self._flops_per_token * B * T)
        logits = compute_logits(self.params_top, cfg, x[:, -1:])
        next_tok = torch.argmax(logits, -1).to(torch.int32)
        self._sync()
        t_prefill = time.perf_counter()
        self.metrics.prefill_wall_time = t_prefill - t0

        out_tokens = [next_tok]
        pos = T
        for _ in range(max_new_tokens - 1):
            self.metrics.begin_step(L_moe)
            x = embed_tokens(self.params_top, cfg, next_tok.long())
            x = self._forward_layers_slab(x, positions, caches, decode_pos=pos)
            next_tok = torch.argmax(compute_logits(self.params_top, cfg, x), -1
                                    ).to(torch.int32)
            out_tokens.append(next_tok)
            pos += 1
            self.metrics.decode_tokens += 1
            self.metrics.add_flops(self._flops_per_token * B)
        self.metrics.decode_tokens += 1
        tokens = torch.cat(out_tokens, dim=1)
        self._sync()
        m = self.metrics
        m.wall_time = time.perf_counter() - t0
        m.decode_wall_time = m.wall_time - m.prefill_wall_time
        decode_steps = max_new_tokens - 1
        return {
            "tokens": tokens,
            "prefill_logits": logits[:, 0],
            "metrics": m,
            "cache_stats": self.cache.stats(),
            "transfers_per_layer": self.cache.transfers_per_layer(),
            "throughput_tok_s": m.throughput(self.hw, batch=B),
            "throughput_overlapped_tok_s": m.throughput(self.hw, batch=B, overlap=True),
            "modeled_time_s": m.modeled_time(self.hw),
            "modeled_time_overlapped_s": m.modeled_time_overlapped(self.hw),
            "prefill_s": m.prefill_wall_time,
            "decode_tok_s": (B * decode_steps / m.decode_wall_time
                             if decode_steps and m.decode_wall_time > 0 else 0.0),
        }
