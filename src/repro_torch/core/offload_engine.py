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

With ``quantized=True`` (paper Sec 3.2) every expert is held in HQQ
INT4: ``wg/wu/wd`` quantized with ``quantize_linear(..., iters=4)`` and
stored in the matmul layout (packed ``(K//2, N)`` bytes, fp32 scale and
zero ``(K//group, N)``), one expert's nine leaves contiguous in a pinned
``(E, expert_bytes)`` byte buffer per layer, so a miss is ONE copy of
``expert_bytes_q`` bytes into a byte slab. The slab mirrors the cache
manager's resident set (``_sync_slab``, as the JAX quantized engine);
each step dequantizes the slots it uses into the activation dtype and
runs the same grouped ``moe_gmm``, and the experts the slab cannot hold
run one by one through ``qmatmul`` -> ``int4_matmul`` with fp32
gate-mass accumulation (the JAX ``_per_expert_contrib``).

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
from ..kernels import dispatch
from ..kernels.int4_matmul.ops import MatmulQWeight
from ..kernels.int4_matmul.ref import dequant_ref
from ..kernels.moe_gmm import ops as gmm_ops
from ..models.attention import attend_full, cache_from_prefill, decode_attend
from ..models.common import rms_norm, silu
from ..models.mlp import apply_mlp
from ..models.model import compute_logits, embed_tokens
from ..models.moe import (Dispatch, combine_tokens, dispatch_tokens,
                          router_probs, top_k_route)
from ..models.runtime import Runtime, resolve_device
from .expert_cache import ModelExpertCache
from .quant import matmul_layout, qmatmul, quantize_linear

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


class QuantLayout:
    """Byte layout of one INT4 expert: for each of wg/wu/wd (a (K, N)
    matmul weight) its packed ``(K//2, N)`` uint8, scale and zero
    ``(K//group, N)`` fp32, back to back. ``nbytes`` equals the JAX
    engine's ``expert_bytes_q`` (the sum of ``quant_bytes``)."""

    def __init__(self, shapes: Dict[str, tuple], group: int):
        self.group = group
        self.fields = []  # (key, leaf, offset, nbytes, dtype, shape)
        off = 0
        for k, (K, N) in shapes.items():
            if K % group or group % 2:
                raise ValueError(f"{k}: K={K} is not a multiple of the even "
                                 f"group {group}")
            for leaf, dt, shp in (("packed", torch.uint8, (K // 2, N)),
                                  ("scale", torch.float32, (K // group, N)),
                                  ("zero", torch.float32, (K // group, N))):
                n = shp[0] * shp[1] * dt.itemsize
                if off % 4:  # fp32 views need 4-byte offsets
                    raise ValueError(f"{k}.{leaf}: offset {off} is not 4-aligned")
                self.fields.append((k, leaf, off, n, dt, shp))
                off += n
        self.nbytes = off

    def views(self, buf: torch.Tensor) -> Dict[str, MatmulQWeight]:
        """(n, nbytes) uint8 -> {k: MatmulQWeight of (n, ...) views}."""
        leaves: Dict[str, dict] = {}
        for k, leaf, off, n, dt, shp in self.fields:
            v = buf[:, off:off + n].view(dt).unflatten(1, shp)
            leaves.setdefault(k, {})[leaf] = v
        return {k: MatmulQWeight(v["packed"], v["scale"], v["zero"], self.group)
                for k, v in leaves.items()}


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


class OffloadedMoEEngine:
    """Greedy decoding with a per-layer offloaded expert cache."""

    def __init__(self, cfg: ModelConfig, params, *, capacity: int,
                 policy: str = "lfu", gamma: float = 0.9,
                 quantized: bool = False, quant_group: int = 32,
                 quantized_experts: Optional[List[Dict[str, MatmulQWeight]]] = None,
                 hw: HardwareProfile = HardwareProfile(),
                 kernel_backend: str = "auto", device=None):
        """``quantized_experts`` (with ``quantized``): per MoE layer, the
        INT4 experts already in the matmul layout (``{k: MatmulQWeight}``
        of ``(E, ...)`` leaves, e.g. from :meth:`quantized_experts` or
        ``bridge.quantized_experts_from_jax``), stored as given instead of
        quantizing ``params``' experts."""
        assert cfg.has_router, "offload engine needs an MoE architecture"
        self.cfg = cfg
        self.quantized = quantized
        self.quant_group = quant_group
        self.device = resolve_device(device)
        self.rt = Runtime(kernel_backend=kernel_backend, device=self.device)
        self.hw = hw
        self.capacity = capacity
        self.moe_spec = cfg.moe_spec
        E, d, f = self.moe_spec.num_experts, cfg.d_model, self.moe_spec.d_ff
        dev = self.device
        pin = dev.type == "cuda"
        self._qlayout = (QuantLayout({"wg": (d, f), "wu": (d, f), "wd": (f, d)},
                                     quant_group) if quantized else None)
        self.quantize_s = 0.0  # seconds spent building the INT4 store
        self.host_store_bytes = 0  # pinned host memory of the expert store

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
                    w = {k: ffn[k][r] for k in _EXPERT_KEYS}
                    if quantized:
                        t0 = time.perf_counter()
                        self._add_host_qexperts(
                            w, quantized_experts, len(self.moe_layer_ids), pin)
                        self.quantize_s += time.perf_counter() - t0
                    else:
                        self._add_host_experts(w, pin)
                    self.moe_layer_ids.append(len(self.layers))
                    self.layers.append({"spec": b, "params": lp,
                                        "moe_idx": len(self.moe_layer_ids) - 1})
        self.params_top = {k: v.to(dev) for k, v in params.items()
                           if k in ("embed", "lm_head", "final_norm")}
        leaf0 = next(iter(self.host_store[0].values()))
        self.expert_bytes = (self._qlayout.nbytes if quantized
                             else 3 * d * f * leaf0.element_size())

        self.cache = ModelExpertCache(len(self.moe_layer_ids), E, capacity,
                                      policy=policy, gamma=gamma)
        self.metrics = EngineMetrics()
        self._flops_per_token = cfg.param_counts()["active"] * 2  # fwd only
        # zero-filled slabs (never-written slots hold finite values)
        self._slabs = [
            ExpertSlab(E, capacity, {
                k: torch.zeros((capacity,) + tuple(v.shape[1:]), dtype=v.dtype,
                               device=dev)
                for k, v in self.host_store[0].items()})
            for _ in self.moe_layer_ids
        ]
        self.slab_bytes = sum(b.nbytes for s in self._slabs
                              for b in s.buffers.values())
        # INT4 leaves of each slab, viewed in place
        self._slab_q = ([self._qlayout.views(s.buffers["q"]) for s in self._slabs]
                        if quantized else None)
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
        self.host_store_bytes += buf.nbytes

    def _add_host_qexperts(self, w: Dict[str, torch.Tensor], given, moe_idx: int,
                           pin: bool) -> None:
        """One layer's experts into a pinned ``(E, expert_bytes)`` INT4
        buffer: quantized here on the engine's device (the whole layer at
        once; groups are independent), or taken from ``given``."""
        if given is not None:
            mq = given[moe_idx]
        else:
            mq = {k: matmul_layout(quantize_linear(v.to(self.device), iters=4,
                                                   group=self.quant_group))
                  for k, v in w.items()}
        E = w["wg"].shape[0]
        buf = torch.empty((E, self._qlayout.nbytes), dtype=torch.uint8,
                          pin_memory=pin)
        for k, dst in self._qlayout.views(buf).items():
            for leaf in ("packed", "scale", "zero"):
                getattr(dst, leaf).copy_(getattr(mq[k], leaf))
        self.host_store.append({"q": buf})
        self.host_store_bytes += buf.nbytes

    def quantized_experts(self) -> List[Dict[str, MatmulQWeight]]:
        """The INT4 store as ``{k: MatmulQWeight}`` of ``(E, ...)`` views of
        the pinned host buffers (no copy), one dict per MoE layer — the
        ``quantized_experts`` argument of another engine."""
        return [self._qlayout.views(s["q"]) for s in self.host_store]

    def _load(self, moe_idx: int, e: int, dst: Dict[str, torch.Tensor],
              slot: int) -> None:
        """Host -> device copy of expert ``e`` into ``dst[k][slot]`` (async
        from pinned memory, ordered on the current stream): three copies
        for fp experts, one of ``expert_bytes`` for INT4."""
        for k, v in self.host_store[moe_idx].items():
            dst[k][slot].copy_(v[e], non_blocking=True)

    def _overflow_buffers(self, n: int) -> Dict[str, torch.Tensor]:
        """Device buffers for ``n`` transient experts (grown on demand,
        reused by every layer: copies and kernels are stream-ordered)."""
        have = 0 if self._overflow is None else len(next(iter(self._overflow.values())))
        if have < n:
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
        needed = sorted(set(eids_np.ravel().tolist()))
        if self.quantized:  # the slab mirrors the manager's resident set
            if missed:
                self._sync_slab(moe_idx)
            residents = self._slabs[moe_idx].residents
            return [e for e in needed if e not in residents]
        return self._ensure_resident(moe_idx, needed)

    def _finish_moe(self, layer: dict, h2f, gates, eids, eids_np, missing):
        """Device half: grouped compute over the slab (+ the shared expert)
        and the overflow group. h2f (N, d) -> (N, d)."""
        moe_idx = layer["moe_idx"]
        slab = self._slabs[moe_idx]
        if self.quantized:
            y = self._quant_slab_group(moe_idx, h2f, gates, eids_np)
        else:
            y = self._group_core(slab.buffers, slab.slot_of_expert[eids_np], h2f,
                                 gates)
        if self.moe_spec.shared_d_ff:
            y = y + apply_mlp(layer["params"]["ffn"]["shared"], h2f)
        if missing:  # |needed| > C spillover / degenerate C < K
            if self.quantized:
                extra = self._quant_spillover(moe_idx, h2f, gates, eids, missing)
                y = y + extra.to(y.dtype)
            else:
                y = y + self._overflow_group(moe_idx, h2f, gates, eids_np, missing)
        return y

    def _quant_slab_group(self, moe_idx: int, h2f, gates, eids_np):
        """Grouped compute over the INT4 slab: the slots this step uses are
        dequantized into the activation dtype (``dequant_ref`` batched over
        slots, the JAX ``_dequant_slab_mat``; an unused slot would only
        meet zero rows) and renumbered 0..G-1 for one ``moe_gmm`` per
        projection."""
        slab = self._slabs[moe_idx]
        slots = slab.slot_of_expert[eids_np]
        # never empty: the manager admits every miss, so the step's last
        # routed expert is resident
        used = np.unique(slots[slots < slab.C])
        remap = np.full(slab.C + 1, used.size, np.int64)
        remap[used] = np.arange(used.size)
        w = self._dequant_slots(moe_idx, used, h2f.dtype)
        return self._group_core(w, remap[slots], h2f, gates)

    def _dequant_slots(self, moe_idx: int, used: np.ndarray, dtype):
        """{k: (G, K, N)} weights of the slab slots ``used``, in ``dtype``."""
        idx = torch.as_tensor(used).to(self.device)
        return {k: dequant_ref(mq.packed[idx], mq.scale[idx], mq.zero[idx],
                               mq.group).to(dtype)
                for k, mq in self._slab_q[moe_idx].items()}

    def _quant_spillover(self, moe_idx: int, h2f, gates, eids, missing):
        """The experts the INT4 slab could not hold, one by one (the JAX
        ``_per_expert_contrib``): a copy into a reused INT4 buffer, then
        three ``qmatmul`` calls (the ``int4_matmul`` kernel on the card),
        with gate-massed fp32 accumulation. Returns (N, d) fp32."""
        buf = self._overflow_buffers(len(missing))
        for i, e in enumerate(missing):
            self._load(moe_idx, e, buf, i)
        ws = self._qlayout.views(buf["q"])
        # gate mass per (token, expert): an expert appears at most once in a
        # token's top-k, so this is the where(eids == e, gates, 0).sum(-1)
        # of the reference exactly
        mass = torch.zeros((h2f.shape[0], self.moe_spec.num_experts),
                           dtype=torch.float32, device=self.device)
        mass.scatter_add_(1, eids.long(), gates.float())
        be = self.rt.kernel_backend
        out = torch.zeros(h2f.shape, dtype=torch.float32, device=self.device)
        for i, e in enumerate(missing):
            w = {k: MatmulQWeight(v.packed[i], v.scale[i], v.zero[i], v.group)
                 for k, v in ws.items()}
            h_act = (silu(qmatmul(h2f, w["wg"], backend=be))
                     * qmatmul(h2f, w["wu"], backend=be))
            ye = qmatmul(h_act, w["wd"], backend=be)
            out = out + mass[:, e:e + 1] * ye.float()
        return out

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
            y = self._finish_moe(layer, h2f, gates, eids, eids_np, missing)
            x = xa + y.reshape(B, T, dm)
        return x

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate(self, prompt_tokens, max_new_tokens: int) -> dict:
        """Greedy decoding. prompt_tokens (B, T) ints. Returns a dict with
        tokens (B, max_new_tokens) int32, the last prompt position's
        logits, metrics, both Eq.-3 clocks, the measured times and the
        kernel launches of each phase by op and route."""
        cfg = self.cfg
        routes0 = dispatch.route_snapshot()
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
        routes1 = dispatch.route_snapshot()

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
            "route_launches": {
                "prefill": dispatch.route_delta(routes0, routes1),
                "decode": dispatch.route_delta(routes1, dispatch.route_snapshot())},
        }
