"""Offloaded MoE inference engine, slab implementation (paper Sec 3.2,
Eq. 3; counterpart of ``repro/core/offload_engine.py`` with
``impl="slab"``).

  * resident pool — per-MoE-layer *slabs* on the device: stacked
                    ``wg/wu (C, d, f)``, ``wd (C, f, d)`` buffers with a
                    slot free-list, overwritten in place;
  * offload pool  — every expert of every layer in **pinned** host
                    memory (one ``(E, 3, d*f)`` buffer per layer,
                    page-locked with ``cudaHostRegister`` at its exact
                    size);
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
per-slot buffers, ragged group sizes; a single token is broadcast into
every active slot instead, the reference's ``N == 1`` branch), plus an
overflow group for the experts this step needs that the slab could not
hold. LoRA adapters (``lora``, per MoE layer on the device) ride as a
low-rank term gathered by each group's expert. The blocks without
experts (``attn_dense``, ``mamba``, ``shared_attn``) run whole on the
device between the MoE layers. The port runs eagerly, so the JAX
engine's compact variant and fused moe(l)+pre(l+1) call — XLA launch
optimisations with identical results — are not ported.

The paper's comparison systems (``core/baselines.py``) run on the same
engine: ``stream_all`` keeps nothing on the device and charges every
routed assignment as a transfer; ``cpu_execute`` runs the cache manager
but books its misses as host-executed (Eq. 3's host term) instead of
transfers. In both, every expert a step needs that the slab does not
hold runs through the overflow group (or the INT4 spillover), exactly
as the reference models them: the host-execution baseline is a cost
model, its experts compute on the device.

With ``little_experts`` an always-resident low-rank bank
(``core/little_expert.py``) stands in for the big experts that the
quality dial of ``generate`` (or its deadline pressure) sends to the
little tier: those misses are neither fetched nor charged, and they
leave the modeled resident set and the slab.

Beside the two modeled clocks the engine reports measured wall-clock
prefill seconds and decode tokens/s on its device.

The operations stack is the reference's. Tracing: the span names of
``obs.reconcile`` (``engine.prefill`` / ``engine.decode_step`` /
``engine.prefetch`` / ``engine.revive``; per MoE layer ``moe.pre``,
``moe.account``, ``moe.fetch`` / ``moe.prefetch``, ``moe.compute``,
``moe.spillover``, ``moe.degraded``; ``engine.embed``, ``engine.logits``,
``engine.block``). While a tracer is enabled on a CUDA device every span
ends after ``torch.cuda.synchronize`` (:meth:`_obs_sync`), so a span
around a ``non_blocking`` copy holds the copy; with tracing off nothing
synchronizes that did not before. The port's spans fall finer than the
reference's: the copies of the overflow group and the INT4 spillover are
``moe.fetch`` spans of their own, and no call fuses moe(l) with pre(l+1).
Faults (``faults/``): the fetch trials of ``_guard_fetch`` under
``fetch_policy``, the fault half of ``_degrade_misses``, eviction storms
and crash points in ``generate``, and ``_guard_prefetch``, drawing from
the installed ``FaultPlan`` in the reference's order. Recovery:
``cache_state``, ``revive(warm=)``, ``resync_slabs`` and ``audit``.

``impl="dict"`` is the reference's pre-rewrite engine, the per-expert
baseline the slab engine is measured against: one dict of device weights
per MoE layer (expert id -> its three matrices, or its INT4 codes), the
cache manager called token by token (``ModelExpertCache.access``, each
miss through its fault trial and quality roll in the reference's order,
then one copy of that expert), and an eager loop over the experts a step
needs: three products each (``torch.matmul`` for fp weights, as the
reference's ``x @ w``; ``qmatmul`` -> ``int4_matmul`` for INT4 codes where
the kernel launches, else weights dequantized to fp32 once at the copy),
LoRA as a separate low-rank term, gate-massed fp32 accumulation. Its
attention, norms and router are the slab engine's.
"""
from __future__ import annotations

import mmap
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..faults import FetchPolicy, get_fault_plan
from ..kernels import dispatch
from ..kernels.int4_matmul.ops import MatmulQWeight
from ..kernels.int4_matmul.ref import dequant_ref
from ..kernels.moe_gmm import ops as gmm_ops
from ..models.attention import attend_full, cache_from_prefill, decode_attend
from ..models.blocks import apply_block_full
from ..models.common import rms_norm, silu
from ..models.mamba2 import apply_mamba_decode
from ..models.mlp import apply_mlp
from ..models.model import compute_logits, embed_tokens, moe_layers
from ..models.moe import (Dispatch, combine_tokens, dispatch_tokens,
                          router_probs, top_k_route)
from ..models.runtime import Runtime, resolve_device
from ..obs.trace import get_tracer
from .expert_cache import ModelExpertCache
from .little_expert import LittleExpertBank
from .quant import matmul_layout, qmatmul, quantize_linear

_EXPERT_KEYS = ("wg", "wu", "wd")
# The INT4 slab's slots are dequantized in fp32 (``dequant_ref``) at most
# this many bytes of fp32 weights at a time, each part cast into the
# activation dtype as it is made: Mixtral-8x7B's six quant_cache slots take
# 1.41 GB of fp32 a leaf, and three such temporaries at once set the row's
# peak (34.89 GB against 32.47 GB for its weights and working set on an H100
# 80GB HBM3). OLMoE's 16 slots (128 MiB a leaf) stay one part.
_DEQUANT_PART_BYTES = 256 << 20


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
    host_flops: float = 2e12  # host-side expert execution (cpu_execute; Eq. 3 term)
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
    host_executed: int = 0
    compute_flops: float = 0.0
    wall_time: float = 0.0  # measured seconds of the last generate call
    prefill_wall_time: float = 0.0  # ... of its prefill (device synchronized)
    decode_wall_time: float = 0.0  # ... of its decode steps
    host_time: float = 0.0  # modeled host-side expert execution (set in generate)
    # resilience accounting: modeled seconds lost to injected transfer
    # spikes, failed fetch attempts and retry backoff; retries, failures,
    # and little-expert substitutions
    fault_delay_s: float = 0.0
    fetch_retries: int = 0
    fetch_failures: int = 0
    degraded_uses: int = 0
    # per engine step (prefill counts as one, then one per decode step):
    # total flops and per-MoE-layer demand-transfer counts/bytes — the
    # event records behind the overlapped clock — plus that step's fault
    # delay (charged serially on both clocks)
    step_flops: List[float] = field(default_factory=list)
    step_tx: List[np.ndarray] = field(default_factory=list)
    step_tx_bytes: List[np.ndarray] = field(default_factory=list)
    step_fault_delay: List[float] = field(default_factory=list)
    # overlapped-clock seconds of records dropped via drop_step_records
    # (keeps modeled_time_overlapped cumulative after trimming)
    overlapped_dropped: float = 0.0
    # cumulative per-MoE-layer transfer totals (moe_idx -> count/bytes);
    # unlike the per-step records these survive drop_step_records
    layer_tx: Dict[int, int] = field(default_factory=dict)
    layer_tx_bytes: Dict[int, int] = field(default_factory=dict)
    layer_prefetch_tx: Dict[int, int] = field(default_factory=dict)
    layer_prefetch_bytes: Dict[int, int] = field(default_factory=dict)

    # -- recording ---------------------------------------------------------
    def begin_step(self, n_moe_layers: int) -> None:
        self.step_flops.append(0.0)
        self.step_tx.append(np.zeros(n_moe_layers, np.int64))
        self.step_tx_bytes.append(np.zeros(n_moe_layers, np.int64))
        self.step_fault_delay.append(0.0)

    def add_fault_delay(self, seconds: float) -> None:
        self.fault_delay_s += seconds
        if self.step_fault_delay:
            self.step_fault_delay[-1] += seconds

    def add_flops(self, flops: float) -> None:
        self.compute_flops += flops
        if self.step_flops:
            self.step_flops[-1] += flops

    def add_demand_transfers(self, moe_idx: int, n: int, nbytes: int) -> None:
        self.transfers += n
        self.transfer_bytes += nbytes
        self.layer_tx[moe_idx] = self.layer_tx.get(moe_idx, 0) + n
        self.layer_tx_bytes[moe_idx] = self.layer_tx_bytes.get(moe_idx, 0) + nbytes
        if self.step_tx:
            self.step_tx[-1][moe_idx] += n
            self.step_tx_bytes[-1][moe_idx] += nbytes

    def add_prefetch_transfers(self, moe_idx: int, n: int, nbytes: int) -> None:
        """Proactive (predictor-driven) transfers: real link traffic, but
        charged outside the demand clocks; tracked per layer."""
        self.prefetch_transfers += n
        self.prefetch_bytes += nbytes
        self.layer_prefetch_tx[moe_idx] = self.layer_prefetch_tx.get(moe_idx, 0) + n
        self.layer_prefetch_bytes[moe_idx] = (
            self.layer_prefetch_bytes.get(moe_idx, 0) + nbytes)

    def drop_step_records(self, hw: HardwareProfile) -> None:
        """Discard the per-step event records so a long-lived engine (the
        wave server) keeps no array pair per decode step. Their
        overlapped seconds are folded into ``overlapped_dropped`` first,
        so :meth:`modeled_time_overlapped` stays cumulative (exact as long
        as the same ``hw`` is used throughout)."""
        self.overlapped_dropped += self.overlapped_span(hw)
        self.step_flops.clear()
        self.step_tx.clear()
        self.step_tx_bytes.clear()
        self.step_fault_delay.clear()

    # -- clocks ------------------------------------------------------------
    def modeled_time(self, hw: HardwareProfile) -> float:
        """Eq. 3, serial: Time_decode ~ Time_compute + N_miss * Time_transfer."""
        t_compute = self.compute_flops / (hw.peak_flops * hw.mfu)
        t_transfer = (self.transfer_bytes / hw.host_link_bw
                      + self.transfers * hw.transfer_latency)
        return t_compute + t_transfer + self.host_time + self.fault_delay_s

    def _spans(self, start_step: int, end_step: Optional[int]):
        return zip(self.step_flops[start_step:end_step],
                   self.step_tx[start_step:end_step],
                   self.step_tx_bytes[start_step:end_step],
                   self.step_fault_delay[start_step:end_step])

    def serial_span(self, hw: HardwareProfile, start_step: int = 0,
                    end_step: Optional[int] = None) -> float:
        """Serial Eq.-3 seconds of steps[start_step:end_step] only (no host
        time): per-step flops + every demand transfer + fault delay. A
        request's time to first token is the span of its prefill step."""
        speed = hw.peak_flops * hw.mfu
        total = 0.0
        for flops, tx, txb, fd in self._spans(start_step, end_step):
            total += flops / speed
            total += float(txb.sum()) / hw.host_link_bw
            total += float(tx.sum()) * hw.transfer_latency
            total += fd
        return total

    def overlapped_span(self, hw: HardwareProfile, start_step: int = 0,
                        end_step: Optional[int] = None) -> float:
        """Overlapped-clock seconds of steps[start_step:end_step] only (no
        host time): layer ``l``'s router output issues layer ``l+1``'s
        fetches, so a step costs ``t_tx[0] + sum_l max(t_compute_l,
        t_tx[l+1])`` with the step's compute split uniformly over its MoE
        layers; fault delay serializes."""
        speed = hw.peak_flops * hw.mfu
        total = 0.0
        for flops, tx, txb, fd in self._spans(start_step, end_step):
            total += fd  # retry stalls serialize: nothing hides them
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
        """Eq. 3 with cross-layer prefetch hiding (:meth:`overlapped_span`
        over every step, dropped ones included, plus host time). Always
        <= :meth:`modeled_time` (``max(a, b) <= a + b``)."""
        if not self.step_flops and not self.overlapped_dropped:
            return self.modeled_time(hw)
        return self.overlapped_dropped + self.overlapped_span(hw) + self.host_time

    def throughput(self, hw: HardwareProfile, batch: int = 1,
                   overlap: bool = False) -> float:
        t = self.modeled_time_overlapped(hw) if overlap else self.modeled_time(hw)
        return (self.decode_tokens * batch) / max(t, 1e-12)

    # -- durable state (recovery checkpoints) ------------------------------
    _STATE_SCALARS = (
        "decode_tokens", "transfers", "transfer_bytes", "prefetch_transfers",
        "prefetch_bytes", "host_executed", "compute_flops", "wall_time",
        "prefill_wall_time", "host_time", "fault_delay_s", "fetch_retries",
        "fetch_failures", "degraded_uses", "overlapped_dropped",
    )
    _STATE_LAYER_DICTS = (
        "layer_tx", "layer_tx_bytes", "layer_prefetch_tx", "layer_prefetch_bytes",
    )

    def state(self) -> dict:
        """Cumulative counters as a plain dict (the per-step records are
        transient and left out). Layer-dict keys become strings, as the
        reference's msgpack snapshots need."""
        out = {k: getattr(self, k) for k in self._STATE_SCALARS}
        for k in self._STATE_LAYER_DICTS:
            out[k] = {str(i): v for i, v in getattr(self, k).items()}
        return out

    def load_state(self, state: dict) -> None:
        for k in self._STATE_SCALARS:
            if k in state:
                setattr(self, k, state[k])
        for k in self._STATE_LAYER_DICTS:
            if k in state:
                setattr(self, k, {int(i): v for i, v in state[k].items()})

    # -- obs ---------------------------------------------------------------
    def publish(self, registry=None, **labels) -> None:
        """Publish the scalar counters onto a metrics registry (the
        global one by default) as labeled ``engine_*`` gauges."""
        from ..obs.registry import REGISTRY

        reg = registry if registry is not None else REGISTRY
        g = lambda name, v: reg.gauge("engine_" + name, **labels).set(v)  # noqa: E731
        g("decode_tokens", self.decode_tokens)
        g("transfers", self.transfers)
        g("transfer_bytes", self.transfer_bytes)
        g("prefetch_transfers", self.prefetch_transfers)
        g("prefetch_bytes", self.prefetch_bytes)
        g("host_executed", self.host_executed)
        g("compute_flops", self.compute_flops)
        g("wall_time_s", self.wall_time)
        g("prefill_wall_time_s", self.prefill_wall_time)
        g("host_time_s", self.host_time)
        g("fault_delay_s", self.fault_delay_s)
        g("fetch_retries", self.fetch_retries)
        g("fetch_failures", self.fetch_failures)
        g("degraded_uses", self.degraded_uses)


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
        # drop index), and slot -> expert id (the LoRA gather)
        self.slot_of_expert = np.full(num_experts, capacity, np.int64)
        self.slot_expert = np.zeros(max(capacity, 1), np.int64)
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
        self.slot_expert[slot] = e
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


def _host_buffer(shape, dtype, pin: bool) -> torch.Tensor:
    """An empty host buffer, page-locked with ``cudaHostRegister`` when
    ``pin``: exactly its own pages, released with the memory. (The caching
    pinned allocator behind ``pin_memory=True`` rounds each buffer up to a
    power of two and keeps freed ones for reuse, which a 30 GB store
    cannot afford.) The memory is an anonymous mapping of its own, advised
    into huge pages where the kernel has them: locking 8 GiB took 2.1 s
    so against 5.6 s in 4 KiB pages on the H100's host, and Mixtral's
    84 GiB store is locked as it is drawn. A numpy array over the mapping,
    which every tensor made of it keeps alive, holds the mapping; the lock
    is undone as that array goes, before the mapping is unmapped."""
    nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    if not pin:
        return torch.empty(shape, dtype=dtype)
    mm = mmap.mmap(-1, max(nbytes, 1))  # page-aligned
    if hasattr(mmap, "MADV_HUGEPAGE"):
        mm.madvise(mmap.MADV_HUGEPAGE)
    raw = np.frombuffer(mm, np.uint8, count=nbytes)
    cudart = torch.cuda.cudart()
    torch.cuda.check_error(cudart.cudaHostRegister(raw.ctypes.data, nbytes, 0))
    weakref.finalize(raw, cudart.cudaHostUnregister, raw.ctypes.data)
    return torch.from_numpy(raw).view(dtype).reshape(shape)


class HostExpertStore:
    """The engine's host store, written one ``(E, K, N)`` expert matrix at
    a time: per MoE layer one pinned ``(E, 3, d*f)`` buffer in which each
    expert's three matrices are contiguous (fp), or one ``(E,
    expert_bytes)`` byte buffer of INT4 codes (``quantized``), allocated at
    the layer's first matrix. ``put`` writes a matrix wherever it lies (on
    the device it was drawn on) straight into its layer's buffer, one
    expert row at a time, quantized first on ``device`` with
    ``quantize_linear(iters=4)`` and ``matmul_layout`` where the store is
    INT4; nothing else keeps it. :meth:`sink` is ``init_params``'
    ``expert_sink``, so a model's experts are drawn into the store and
    host memory never holds them twice; :meth:`finish` gives the engine's
    ``host_store``. Buffers are pinned where ``device`` is CUDA."""

    def __init__(self, cfg: ModelConfig, *, quantized: bool = False,
                 quant_group: int = 32, device=None):
        spec = cfg.moe_spec
        d, f = cfg.d_model, spec.d_ff
        self.device = resolve_device(device)
        self.pin = self.device.type == "cuda"
        self.quant_group = quant_group
        self.shapes = {"wg": (d, f), "wu": (d, f), "wd": (f, d)}
        self.layout = QuantLayout(self.shapes, quant_group) if quantized else None
        # (group, position, repeat) -> MoE layer, in the engine's layer order
        self.index: Dict[tuple, int] = moe_layers(cfg)
        self.layers: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(self.index)
        self._written = [set() for _ in self.index]
        self.quantize_s = 0.0  # seconds spent quantizing and writing the INT4 store

    def sink(self, gi: int, pi: int, name: str, idx: tuple, w: torch.Tensor) -> None:
        """``init_params``' ``expert_sink``: matrix ``name`` of repeat
        ``idx`` of block ``p{pi}`` in group ``g{gi}``."""
        self.put(self.index[(gi, pi, *idx)], name, w)

    def put(self, moe_idx: int, key: str, w: torch.Tensor) -> None:
        """MoE layer ``moe_idx``'s ``(E, K, N)`` matrix ``key``."""
        if self.layout is None:
            if self.layers[moe_idx] is None:
                E, n = w.shape[0], w[0].numel()
                buf = _host_buffer((E, 3, n), w.dtype, self.pin)
                self.layers[moe_idx] = {k: buf[:, i].unflatten(1, self.shapes[k])
                                        for i, k in enumerate(_EXPERT_KEYS)}
            dst = self.layers[moe_idx][key]
            for e in range(w.shape[0]):  # contiguous rows: one plain copy each
                dst[e].copy_(w[e])
            self._written[moe_idx].add(key)
            return
        t0 = time.perf_counter()
        mq = matmul_layout(quantize_linear(w.to(self.device), iters=4,
                                           group=self.quant_group))
        self._put_codes(moe_idx, key, mq)
        self.quantize_s += time.perf_counter() - t0

    def put_quantized(self, moe_idx: int, key: str, mq: MatmulQWeight) -> None:
        """MoE layer ``moe_idx``'s matrix ``key`` as INT4 codes already in
        the matmul layout (``(E, ...)`` leaves)."""
        t0 = time.perf_counter()
        self._put_codes(moe_idx, key, mq)
        self.quantize_s += time.perf_counter() - t0

    def _put_codes(self, moe_idx: int, key: str, mq: MatmulQWeight) -> None:
        E = mq.packed.shape[0]
        if self.layers[moe_idx] is None:
            self.layers[moe_idx] = {"q": _host_buffer((E, self.layout.nbytes), torch.uint8,
                                                      self.pin)}
        buf = self.layers[moe_idx]["q"]
        for k, leaf, off, n, _, _ in self.layout.fields:
            if k == key:
                src = getattr(mq, leaf).reshape(E, -1)
                for e in range(E):
                    buf[e, off:off + n].copy_(src[e].view(torch.uint8))
        self._written[moe_idx].add(key)

    def finish(self) -> List[Dict[str, torch.Tensor]]:
        """The store, every layer's three matrices written: the engine's
        ``host_store``."""
        for i, keys in enumerate(self._written):
            if keys != set(_EXPERT_KEYS):
                raise ValueError(f"host store: MoE layer {i} holds {sorted(keys)}, "
                                 f"want {list(_EXPERT_KEYS)}")
        return list(self.layers)


def stage_experts(layer: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """One MoE layer of a finished fp host store (``HostExpertStore``'s,
    an engine's ``host_store``) on ``device``, for a forward pass over that
    layer: ``{"wg", "wu", "wd"}``, each ``(E, K, N)`` in a device buffer of
    its own, filled by one ``non_blocking`` copy of each expert's
    contiguous matrix out of the pinned ``(E, 3, K*N)`` buffer (``moe_gmm``
    takes contiguous weights, which views of that buffer are not). An INT4
    store raises ``NotImplementedError``: what is staged this way is the
    full-precision experts (the weights of the oracle scores and of the
    predictor's routing trace)."""
    if set(layer) != set(_EXPERT_KEYS):
        raise NotImplementedError(
            f"stage_experts: a store of {sorted(layer)} (INT4 codes); staging takes the "
            f"full-precision experts")
    out = {}
    for k in _EXPERT_KEYS:
        v = layer[k]
        dst = torch.empty(v.shape, dtype=v.dtype, device=device)
        for e in range(v.shape[0]):
            dst[e].copy_(v[e], non_blocking=True)
        out[k] = dst
    return out


def _tree_map(fn, tree):
    return ({k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict)
            else fn(tree))


class OffloadedMoEEngine:
    """Greedy decoding with a per-layer offloaded expert cache."""

    def __init__(self, cfg: ModelConfig, params, *, capacity: int,
                 policy: str = "lfu", gamma: float = 0.9,
                 quantized: bool = False, quant_group: int = 32,
                 quantized_experts: Optional[List[Dict[str, MatmulQWeight]]] = None,
                 host_store: Optional[List[Dict[str, torch.Tensor]]] = None,
                 hw: HardwareProfile = HardwareProfile(),
                 cpu_execute: bool = False, stream_all: bool = False,
                 lora=None, lora_scale: float = 1.0,
                 kernel_backend: str = "auto", impl: str = "slab",
                 little_experts: bool = False, little_rank: int = 8,
                 little_quantized: bool = False, fetch_policy=None,
                 pressure_frac: float = 0.75, little_bank=None, device=None):
        """``quantized_experts`` (with ``quantized``): per MoE layer, the
        INT4 experts already in the matmul layout (``{k: MatmulQWeight}``
        of ``(E, ...)`` leaves, e.g. from :meth:`quantized_experts` or
        ``bridge.quantized_experts_from_jax``), stored as given instead of
        quantizing ``params``' experts. ``host_store``: the pinned expert
        store of another engine of the same config and quantization
        (``engine.host_store``), shared as it is: ``params``' expert
        leaves are then not read. ``lora`` (the model's adapter tree,
        ``core.lora``) is kept on the device, one slice per MoE layer.

        ``little_experts`` builds the low-rank bank (``LittleExpertBank``
        of rank ``little_rank``, INT4 left factors with
        ``little_quantized``) on the engine's device from the experts'
        weights with the LoRA delta folded in; ``little_bank`` serves a
        bank built before (another engine's ``little``, or
        ``bridge.little_bank_from_jax``) instead, and turns the tier on.
        ``pressure_frac``: the share of a ``deadline_s`` budget after
        which every miss goes to the little tier. ``fetch_policy``
        (``faults.FetchPolicy``, default ``FetchPolicy()``): the retry
        budget of a fetch the installed fault plan fails."""
        assert cfg.has_router, "offload engine needs an MoE architecture"
        if impl not in ("slab", "dict"):
            raise ValueError(f"impl {impl!r}: 'slab' or 'dict'")
        self.cfg = cfg
        self.impl = impl
        self.fetch_policy = fetch_policy or FetchPolicy()
        self.cpu_execute = cpu_execute
        self.stream_all = stream_all
        # deadline pressure: once a request has burned this fraction of its
        # Eq.-3 budget, remaining misses go all-little (quality 0)
        self.pressure_frac = pressure_frac
        self._step_quality = 1.0  # effective per-step quality dial
        self._gen_step = 0
        self.quantized = quantized
        self.quant_group = quant_group
        self.device = resolve_device(device)
        self.rt = Runtime(kernel_backend=kernel_backend, device=self.device)
        self.hw = hw
        self.capacity = capacity
        self.moe_spec = cfg.moe_spec
        self.lora_scale = lora_scale
        E, d, f = self.moe_spec.num_experts, cfg.d_model, self.moe_spec.d_ff
        dev = self.device
        self._qlayout = (QuantLayout({"wg": (d, f), "wu": (d, f), "wd": (f, d)},
                                     quant_group) if quantized else None)
        self.quantize_s = 0.0  # seconds spent building the INT4 store
        self.expert_copies = 0  # host -> device expert copies issued (slab + overflow)

        # ---- unstack the scanned groups into a flat per-layer list; the
        # expert weights go to the pinned host store, the rest (and the
        # LoRA adapters) to the device
        self.layers: List[dict] = []  # {"spec", "params", "lora", "moe_idx"}
        self.moe_layer_ids: List[int] = []
        # per MoE layer: wg/wu/wd (E, ...) views of one pinned (E, 3, d*f) buffer
        self.host_store: List[Dict[str, torch.Tensor]] = list(host_store or [])
        store = (HostExpertStore(cfg, quantized=quantized, quant_group=quant_group,
                                 device=dev) if host_store is None else None)
        # the little bank's source where the store holds INT4 codes
        fp_experts: List[Dict[str, torch.Tensor]] = []
        to_dev = lambda a: a.to(dev)  # noqa: E731
        shared = (_tree_map(to_dev, params["shared"]) if "shared" in params else None)
        for gi, g in enumerate(cfg.layout):
            gparams = params["groups"].get(f"g{gi}", {})
            glora = (lora or {}).get(f"g{gi}", {})
            for r in range(g.repeats):
                for pi, bname in enumerate(g.pattern):
                    b = cfg.block_defs[bname]
                    at_r = lambda a: a[r].to(dev)  # noqa: E731
                    if b.kind == "shared_attn":
                        self.layers.append({"spec": b, "params": shared, "lora": None})
                        continue
                    bp = gparams[f"p{pi}"]
                    if b.kind != "attn_moe":
                        self.layers.append({"spec": b, "params": _tree_map(at_r, bp),
                                            "lora": None})
                        continue
                    ffn = bp["ffn"]
                    lp = _tree_map(at_r, {k: v for k, v in bp.items() if k != "ffn"})
                    lp["ffn"] = _tree_map(
                        at_r, {k: v for k, v in ffn.items() if k not in _EXPERT_KEYS})
                    moe_idx = len(self.moe_layer_ids)
                    if quantized and little_experts and little_bank is None:
                        if any(ffn[k].is_meta for k in _EXPERT_KEYS):
                            raise ValueError("little_experts: the INT4 store holds no fp "
                                             "weights to distil and params' experts are "
                                             "not loaded; pass little_bank=")
                        fp_experts.append({k: ffn[k][r] for k in _EXPERT_KEYS})
                    for k in _EXPERT_KEYS if store is not None else ():
                        if quantized and quantized_experts is not None:
                            store.put_quantized(moe_idx, k, quantized_experts[moe_idx][k])
                        else:
                            store.put(moe_idx, k, ffn[k][r])
                    self.moe_layer_ids.append(len(self.layers))
                    ll = (_tree_map(at_r, glora[f"p{pi}"]) if f"p{pi}" in glora
                          else None)
                    self.layers.append({"spec": b, "params": lp, "lora": ll,
                                        "moe_idx": moe_idx})
        if store is not None:
            self.host_store, self.quantize_s = store.finish(), store.quantize_s
        if len(self.host_store) != len(self.moe_layer_ids):
            raise ValueError(f"host_store holds {len(self.host_store)} MoE layers, "
                             f"the config {len(self.moe_layer_ids)}")
        self.params_top = {k: v.to(dev) for k, v in params.items()
                           if k in ("embed", "lm_head", "final_norm")}
        leaf0 = next(iter(self.host_store[0].values()))
        self.expert_bytes = (self._qlayout.nbytes if quantized
                             else 3 * d * f * leaf0.element_size())
        # one pinned buffer per layer, every view of a layer on its storage
        self.host_store_bytes = sum(next(iter(s.values())).untyped_storage().nbytes()
                                    for s in self.host_store)

        self.cache = ModelExpertCache(len(self.moe_layer_ids), E, capacity,
                                      policy=policy, gamma=gamma)
        self.metrics = EngineMetrics()
        self._flops_per_token = cfg.param_counts()["active"] * 2  # fwd only
        # zero-filled slabs (never-written slots hold finite values); the
        # dict engine's residents instead: per MoE layer, expert id -> weights
        self._slabs = [
            ExpertSlab(E, capacity, {
                k: torch.zeros((capacity,) + tuple(v.shape[1:]), dtype=v.dtype,
                               device=dev)
                for k, v in self.host_store[0].items()})
            for _ in self.moe_layer_ids
        ] if impl == "slab" else []
        self.resident: List[Dict[int, dict]] = [{} for _ in self.moe_layer_ids]
        self.slab_bytes = sum(b.nbytes for s in self._slabs
                              for b in s.buffers.values())
        self.lora_bytes = sum(t.nbytes for layer in self.layers if layer["lora"]
                              for ab in layer["lora"].values() for t in ab.values())
        # INT4 leaves of each slab, viewed in place
        self._slab_q = ([self._qlayout.views(s.buffers["q"]) for s in self._slabs]
                        if quantized else None)
        self._overflow: Optional[Dict[str, torch.Tensor]] = None

        # always-resident low-rank distillates: the degraded-mode tier
        # (LoRA deltas folded in at build time)
        self.little: Optional[LittleExpertBank] = little_bank
        self.little_build_s = 0.0
        if little_bank is None and little_experts:
            t0 = time.perf_counter()
            self.little = LittleExpertBank(
                fp_experts if quantized else self.host_store, rank=little_rank,
                lora=[self.layers[li]["lora"] for li in self.moe_layer_ids],
                lora_scale=lora_scale, quantized=little_quantized,
                quant_group=quant_group, device=dev)
            self._sync()
            self.little_build_s = time.perf_counter() - t0

    # ------------------------------------------------------------------
    # host store and copies
    # ------------------------------------------------------------------
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
        self.expert_copies += 1

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

    def _device_weights(self, moe_idx: int, e: int) -> dict:
        """Expert ``e`` on the device, in buffers of its own (the dict
        engine's residents and transient experts): fp, ``{k: (K, N)}`` in
        the store's dtype; INT4, ``MatmulQWeight`` codes where
        ``int4_matmul`` launches its kernel, else the codes dequantized
        to fp32 once here (the reference's "ref" engine), so the products
        do not repeat the dequant. One copy of each stored leaf."""
        buf = {k: torch.empty((1,) + tuple(v.shape[1:]), dtype=v.dtype, device=self.device)
               for k, v in self.host_store[moe_idx].items()}
        self._load(moe_idx, e, buf, 0)
        if not self.quantized:
            return {k: v[0] for k, v in buf.items()}
        w = {k: MatmulQWeight(q.packed[0], q.scale[0], q.zero[0], q.group)
             for k, q in self._qlayout.views(buf["q"]).items()}
        if self.rt.kernel_choice("int4_matmul"):
            return w
        return {k: dequant_ref(q.packed, q.scale, q.zero, q.group) for k, q in w.items()}

    def _fetch(self, moe_idx: int, eid: int, *, prefetch: bool = False) -> None:
        """Host -> device copy of one expert into the dict engine's
        residents (a ``moe.fetch`` or ``moe.prefetch`` span), charged as a
        demand or a prefetch transfer; then the device budget: residents
        the cache manager no longer holds are dropped."""
        with get_tracer().span("moe.prefetch" if prefetch else "moe.fetch",
                               layer=moe_idx, experts=1):
            w = self._device_weights(moe_idx, eid)
            self._obs_sync()
        res = self.resident[moe_idx]
        res[eid] = w
        if prefetch:
            self.metrics.add_prefetch_transfers(moe_idx, 1, self.expert_bytes)
        else:
            self.metrics.add_demand_transfers(moe_idx, 1, self.expert_bytes)
        cached = self.cache.layers[moe_idx].resident
        for stale in [e for e in res if e not in cached and e != eid]:
            del res[stale]

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
        """Predictor-driven proactive cache load (Sec 3.2). scores (L, E).
        Under a fault plan each pending load first passes its fetch trial
        (:meth:`_guard_prefetch`)."""
        tr = get_tracer()
        with tr.span("engine.prefetch"):
            self.cache.prefill_from_scores(scores)
            if get_fault_plan().enabled:
                self._guard_prefetch()
            if self.impl == "dict":
                for moe_idx, cache in enumerate(self.cache.layers):
                    for e in cache.resident:
                        if e not in self.resident[moe_idx]:
                            self._fetch(moe_idx, e, prefetch=True)
                return
            for moe_idx in range(len(self.moe_layer_ids)):
                with tr.span("moe.prefetch", layer=moe_idx):
                    added = self._sync_slab(moe_idx)
                    self._obs_sync()
                self.metrics.add_prefetch_transfers(moe_idx, added,
                                                    added * self.expert_bytes)

    def _obs_sync(self) -> None:
        """Fence the device at a span boundary while tracing, so a span
        holds the work it wraps (the asynchronous copies and kernels
        included); nothing otherwise."""
        if self.device.type == "cuda" and get_tracer().enabled:
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # recovery: durable cache state, warm revival, integrity audit
    # ------------------------------------------------------------------
    def cache_state(self) -> List[dict]:
        """Per-layer cache snapshots (resident set + policy scores) for a
        recovery checkpoint."""
        return self.cache.state()

    def revive(self, cache_state: List[dict], *, warm: bool = True) -> dict:
        """Restore a checkpointed cache and (``warm=True``) copy the
        checkpointed resident set back into the device slabs before
        serving resumes. Returns ``{"loaded", "bytes", "modeled_s"}`` so a
        caller can charge the revival copies to its clock (they count as
        prefetch transfers, as a predictor prefetch)."""
        self.cache.load_state(cache_state, resident=warm)
        loaded = 0
        if warm:
            with get_tracer().span("engine.revive"):
                if self.impl == "dict":
                    for moe_idx, cache in enumerate(self.cache.layers):
                        for e in sorted(cache.resident):
                            if e not in self.resident[moe_idx]:
                                self._fetch(moe_idx, e, prefetch=True)
                                loaded += 1
                for moe_idx in range(len(self._slabs)):
                    added = self._sync_slab(moe_idx)
                    if added:
                        self.metrics.add_prefetch_transfers(moe_idx, added,
                                                            added * self.expert_bytes)
                    loaded += added
                self._obs_sync()
        nbytes = loaded * self.expert_bytes
        modeled = nbytes / self.hw.host_link_bw + loaded * self.hw.transfer_latency
        return {"loaded": loaded, "bytes": nbytes, "modeled_s": modeled}

    def resync_slabs(self) -> int:
        """Self-heal: force physical residency back in line with the cache
        manager (drop stale slab residents, load missing cached experts).
        Only the watchdog calls this, on detected drift. The dict engine
        drops its residents outside the manager's set."""
        healed = 0
        if self.impl == "dict":
            for moe_idx, cache in enumerate(self.cache.layers):
                res = self.resident[moe_idx]
                for e in [e for e in res if e not in cache.resident]:
                    del res[e]
                    healed += 1
        for moe_idx, slab in enumerate(self._slabs):
            target = self.cache.layers[moe_idx].resident
            drift = len(set(slab.residents) - target)
            healed += drift + self._sync_slab(moe_idx)
        return healed

    def audit(self) -> List[tuple]:
        """Integrity check (watchdog contract): the slab free-lists and
        slot maps against the cache manager's accounting. Returns
        ``(severity, message)`` tuples; ``"hard"`` means corrupted
        bookkeeping. Slab residents outside the manager's set are normal
        (the slab keeps evicted experts by compute-use recency). The dict
        engine's residents outside that set are ``"drift"`` (healed by
        :meth:`resync_slabs`), more than the capacity besides them hard."""
        v: List[tuple] = [("hard", f"cache: {msg}") for msg in self.cache.audit()]
        E = self.moe_spec.num_experts
        if self.impl == "dict":
            for moe_idx, cache in enumerate(self.cache.layers):
                res = self.resident[moe_idx]
                stale = sorted(set(res) - cache.resident)
                if stale:
                    v.append(("drift", f"dict[L{moe_idx}]: physical residents "
                              f"outside the cache budget: {stale[:8]}"))
                if len(res) > self.capacity + len(stale):
                    v.append(("hard", f"dict[L{moe_idx}]: {len(res)} residents "
                              f"exceed capacity {self.capacity}"))
        for moe_idx, slab in enumerate(self._slabs):
            pre = f"slab[L{moe_idx}]"
            if len(slab.free) + len(slab.residents) != slab.C:
                v.append(("hard", f"{pre}: free {len(slab.free)} + "
                          f"resident {len(slab.residents)} != C {slab.C}"))
            used = []
            for e in slab.residents:
                s = int(slab.slot_of_expert[e])
                if not (0 <= s < slab.C):
                    v.append(("hard", f"{pre}: resident {e} has no slot"))
                elif int(slab.slot_expert[s]) != e:
                    v.append(("hard", f"{pre}: slot map mismatch for expert {e} "
                              f"(slot {s} claims {int(slab.slot_expert[s])})"))
                else:
                    used.append(s)
            if sorted(used + list(slab.free)) != list(range(slab.C)):
                v.append(("hard", f"{pre}: slots not a disjoint partition of free + used"))
            ghosts = [e for e in range(E)
                      if int(slab.slot_of_expert[e]) != slab.C and e not in slab.residents]
            if ghosts:
                v.append(("hard", f"{pre}: non-resident experts with slots: {ghosts[:8]}"))
        return v

    # ------------------------------------------------------------------
    # grouped expert compute
    # ------------------------------------------------------------------
    def _low_rank(self, x, lora_t: dict, experts, out_dtype):
        """The LoRA term of one projection over (U, n, din) rows of the
        experts ``experts`` (U,): ``scale * (x @ a) @ b`` in fp32, cast to
        ``out_dtype`` (the reference's ``low_rank``)."""
        t = torch.bmm(x.float(), lora_t["a"][experts].float())
        return (self.lora_scale * torch.bmm(t, lora_t["b"][experts].float())).to(out_dtype)

    def _moe_sets(self, sets, h2f, gates, eids_np, lora):
        """The routed experts' FFN over one or more group sets (the slab,
        the overflow stack): each set is ``(w, slots, group_expert)`` with
        ``w`` {wg, wu, wd: (G, ...)}, ``slots`` (N, K) each assignment's
        group in the set (== G where no group of the set holds its
        expert) and ``group_expert`` (G,) each group's expert id.

        One grouped ``moe_gmm`` per projection and set, the tokens sorted
        into per-group buffers (ragged sizes), or, for a single token,
        broadcast into every active group (the reference's ``N == 1``
        branch). LoRA runs once over the step's routed experts (sorted by
        id) and one fp32 gate-combine takes every assignment, so which set
        holds an expert changes nothing that is computed: residency (the
        scheduling policy) never changes the tokens. Assignments in no set
        (the INT4 spillover's) are left out. The index arithmetic runs on
        the host, where the routed ids already are. Returns (N, d)."""
        N, K = eids_np.shape
        dm = h2f.shape[-1]
        dev = self.device
        to_dev = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32).to(dev)  # noqa: E731
        be = self.rt.kernel_backend
        stages = []
        for w, slots, ge in sets:
            G = w["wg"].shape[0]
            flat = slots.reshape(-1)
            oh = flat[:, None] == np.arange(G + 1)[None, :]
            counts = oh.sum(0)[:G]
            if N == 1:
                active = torch.as_tensor(counts > 0).to(dev)
                buf = h2f[None].expand(G, 1, dm) * active[:, None, None].to(h2f.dtype)
            else:
                pos = (np.cumsum(oh, axis=0) * oh).sum(-1) - 1  # occurrences before self
                keep = flat < G
                d = Dispatch(eids=to_dev(slots), pos=to_dev(np.where(keep, pos, 0).reshape(N, K)),
                             gates=gates, cap=N)
                buf = dispatch_tokens(d, h2f, G)  # (G, N, d) group-sorted
            sizes = to_dev(counts)  # tokens per group (ragged gmm groups)
            mm = lambda a, b, s=sizes: gmm_ops.gmm(a, b, s, backend=be)  # noqa: E731
            stages.append({"w": w, "G": G, "flat": flat, "mm": mm, "buf": buf,
                           "pos": None if N == 1 else np.where(flat < G, pos, 0),
                           "hg": mm(buf, w["wg"]), "hu": mm(buf, w["wu"]),
                           "ge": ge, "counts": counts})
        if lora is not None:
            routed = np.unique(eids_np)  # sorted; (U,)
            U = routed.size
            r_dev = torch.as_tensor(routed).to(dev)
            for st in stages:  # each group's row in the routed batch; U = none
                m = np.searchsorted(routed, st["ge"])
                st["map"] = torch.as_tensor(np.where(st["counts"] > 0, m, U)).to(dev)

            def routed_rows(key, width, dtype):  # every set's groups -> (U+1, n, width)
                out = torch.zeros((U + 1, stages[0][key].shape[1], width), dtype=dtype,
                                  device=dev)
                for st in stages:  # inactive groups are zero rows, written to U
                    out[st["map"]] = st[key]
                return out[:U]

            x_r = routed_rows("buf", dm, h2f.dtype)
            hu0 = stages[0]["hu"]
            lu = self._low_rank(x_r, lora["wu"], r_dev, hu0.dtype)
            lu = torch.cat([lu, torch.zeros_like(lu[:1])])
            for st in stages:
                st["hu"] = st["hu"] + lu[st["map"]]
        for st in stages:
            st["h_act"] = silu(st["hg"]) * st["hu"]
            st["yb"] = st["mm"](st["h_act"], st["w"]["wd"])
        if lora is not None:
            h_r = routed_rows("h_act", stages[0]["h_act"].shape[-1], stages[0]["h_act"].dtype)
            ld = self._low_rank(h_r, lora["wd"], r_dev, stages[0]["yb"].dtype)
            ld = torch.cat([ld, torch.zeros_like(ld[:1])])
            for st in stages:
                st["yb"] = st["yb"] + ld[st["map"]]
        # one gate-combine over every assignment: its row in the sets' outputs
        total = sum(st["G"] for st in stages)
        idx = np.full(N * K, total, np.int64)
        pos = np.zeros(N * K, np.int64)
        off = 0
        for st in stages:
            here = st["flat"] < st["G"]
            idx[here] = off + st["flat"][here]
            if N > 1:
                pos[here] = st["pos"][here]
            off += st["G"]
        yb = stages[0]["yb"] if len(stages) == 1 else torch.cat([st["yb"] for st in stages])
        keep_t = torch.as_tensor(idx < total).to(dev).reshape(N, K)
        g = torch.where(keep_t, gates, torch.zeros((), device=dev))
        if N == 1:  # gate-combine by direct group gather
            safe = torch.as_tensor(np.minimum(idx, total - 1)).to(dev)
            return torch.einsum("kd,k->d", yb[safe, 0].float(), g[0])[None].to(yb.dtype)
        d = Dispatch(eids=to_dev(idx.reshape(N, K)), pos=to_dev(pos.reshape(N, K)), gates=g,
                     cap=N)
        return combine_tokens(d, yb)  # (N, d)

    # ------------------------------------------------------------------
    # resilience: fault-injected transfer trials + the quality dial
    # ------------------------------------------------------------------
    def _resilience_active(self) -> bool:
        """One cheap guard for every hot-path hook: with no fault plan
        installed and the quality dial at 1.0, every resilience branch is
        skipped and decode is the unmodified engine."""
        return get_fault_plan().enabled or (
            self.little is not None and self._step_quality < 1.0)

    def _degrade_roll(self, moe_idx: int, e: int) -> bool:
        """Deterministic per-(layer, expert, step) quality roll: True
        means substitute the little expert instead of fetching the big
        one. quality 1.0 never degrades by choice; 0.0 always does."""
        q = self._step_quality
        if q >= 1.0:
            return False
        h = (moe_idx * 0x9E3779B1 ^ e * 0x85EBCA77
             ^ self._gen_step * 0xC2B2AE3D) & 0xFFFFFFFF
        h ^= h >> 16
        h = (h * 0x45D9F3B) & 0xFFFFFFFF
        h ^= h >> 16
        return (h / 2.0**32) >= q

    def _guard_fetch(self, moe_idx: int, eids, *, prefetch: bool = False) -> List[int]:
        """Fault-plan transfer trials for each expert in ``eids``, in order.
        Charges modeled fault delay for latency spikes, failed attempts
        (the failed copy burned link time) and retry backoff; returns the
        experts whose fetch was abandoned once the retry budget or the
        per-fetch deadline ran out. Demand fetches without a little bank
        cannot degrade: they retry until success (bounded by the policy's
        ``hard_cap``). Prefetches are best-effort: an abandoned one stays
        cold."""
        plan = get_fault_plan()
        if not plan.enabled:
            return []
        pol = self.fetch_policy
        m = self.metrics
        per_try = self.expert_bytes / self.hw.host_link_bw + self.hw.transfer_latency
        can_degrade = prefetch or self.little is not None
        dropped = []
        for e in eids:
            spent, attempt = 0.0, 0
            while True:
                spike = plan.transfer_spike(moe_idx)
                if spike:
                    m.add_fault_delay(spike)
                if not plan.fetch_fails(moe_idx):
                    break
                m.fetch_failures += 1
                delay = per_try + pol.backoff(attempt)
                spent += delay
                m.add_fault_delay(delay)
                attempt += 1
                if can_degrade and not pol.attempts_allowed(attempt, spent):
                    dropped.append(e)
                    break
                if attempt >= pol.hard_cap:  # runaway guard only
                    break
                m.fetch_retries += 1
        return dropped

    def _degrade_misses(self, moe_idx: int, missed):
        """Resilience verdicts over one step's modeled misses: the quality
        roll first (an expert degraded by choice is never fetched, so it
        skips the fault trial and pays nothing), then the fault trials of
        whatever still wants the link. Degraded experts leave the modeled
        resident set (future steps re-miss them honestly) and their
        transfers go uncharged. Returns (degraded_ids, n_charged)."""
        uniq = sorted(set(int(e) for e in missed))
        degraded = set()
        if self.little is not None and self._step_quality < 1.0:
            degraded = {e for e in uniq if self._degrade_roll(moe_idx, e)}
        degraded |= set(self._guard_fetch(moe_idx, [e for e in uniq if e not in degraded]))
        if not degraded:
            return [], len(missed)
        resident = self.cache.layers[moe_idx].resident
        for e in degraded:
            resident.discard(e)
        self.metrics.degraded_uses += len(degraded)
        n_charged = sum(1 for e in missed if int(e) not in degraded)
        return sorted(degraded), n_charged

    def _miss_verdict(self, moe_idx: int, e: int) -> bool:
        """One miss's degrade verdict on the dict engine's token-sequential
        path: the quality roll first (degrading by choice skips the copy
        and its fault trial), then the fault-plan trial."""
        if self.little is not None and self._degrade_roll(moe_idx, e):
            return True
        return bool(self._guard_fetch(moe_idx, [e]))

    def _apply_storm(self, frac: float) -> None:
        """Eviction storm: a co-tenant thrashes device memory; a ``frac``
        fraction of every layer's residents is dropped (modeled and from
        the slab), forcing re-misses on the next touch."""
        plan = get_fault_plan()
        for moe_idx, cache in enumerate(self.cache.layers):
            for v in plan.storm_victims(cache.resident, frac):
                cache.resident.discard(v)
                cache.evictions += 1
                if self.impl == "dict":
                    self.resident[moe_idx].pop(v, None)
                elif v in self._slabs[moe_idx].residents:
                    self._slabs[moe_idx].drop(v)

    def _guard_prefetch(self) -> None:
        """Fault trials for the pending prefetch loads (cache residents the
        slab does not hold yet): abandoned experts leave the modeled
        resident set before the copies, so they stay cold."""
        for moe_idx in range(len(self.moe_layer_ids)):
            target = self.cache.layers[moe_idx].resident
            have = (self.resident[moe_idx].keys() if self.impl == "dict"
                    else self._slabs[moe_idx].residents)
            new = sorted(e for e in target if e not in have)
            for e in self._guard_fetch(moe_idx, new, prefetch=True):
                target.discard(e)

    def _prep_moe(self, moe_idx: int, eids_np: np.ndarray):
        """Host half of a MoE layer's step: cache accounting (one
        vectorized call; ``stream_all`` charges every assignment,
        ``cpu_execute`` books the misses as host-executed, the quality
        dial sends misses to the little tier), then physical residency.
        Returns (the experts the slab does not hold, the degraded ones)."""
        N, K = eids_np.shape
        degraded: List[int] = []
        missed: List[int] = []
        tr = get_tracer()
        with tr.span("moe.account", layer=moe_idx):
            if self.stream_all:
                self.metrics.add_demand_transfers(moe_idx, N * K, N * K * self.expert_bytes)
            else:
                missed = self.cache.layers[moe_idx].access_batch(eids_np)
                if self.cpu_execute:
                    self.metrics.host_executed += len(missed)
                elif missed:
                    n_charged = len(missed)
                    if self._resilience_active():
                        degraded, n_charged = self._degrade_misses(moe_idx, missed)
                    if n_charged:
                        self.metrics.add_demand_transfers(moe_idx, n_charged,
                                                          n_charged * self.expert_bytes)
        slab = self._slabs[moe_idx]
        needed = sorted(set(eids_np.ravel().tolist()))
        if degraded:
            dset = set(degraded)
            needed = [e for e in needed if e not in dset]
            # a degraded expert is never served from a slot the slab retained
            for e in degraded:
                if e in slab.residents:
                    slab.drop(e)
        with tr.span("moe.fetch", layer=moe_idx):
            if self.cpu_execute or self.stream_all:
                # host-executed / streamed experts never persist on the
                # device: everything runs through the per-step overflow group
                missing = [e for e in needed if e not in slab.residents]
            elif self.quantized:  # the slab mirrors the manager's resident set
                if missed:
                    self._sync_slab(moe_idx)
                missing = [e for e in needed if e not in slab.residents]
            else:
                missing = self._ensure_resident(moe_idx, needed)
            self._obs_sync()
        return missing, degraded

    def _finish_moe(self, layer: dict, h2f, gates, eids, eids_np, missing, degraded):
        """Device half: grouped compute over the slab and, for the experts
        it does not hold, the overflow stack (fp) or the per-expert INT4
        spillover, + the shared expert, + the little experts standing in
        for the degraded ones. A group set that serves no assignment this
        step (the empty slab of ``stream_all`` and ``cpu_execute``, or one
        whose experts all degraded) launches nothing. h2f (N, d) -> (N, d)."""
        moe_idx = layer["moe_idx"]
        slab = self._slabs[moe_idx]
        lora = layer["lora"]
        tr = get_tracer()
        sets = []
        if not self.quantized:
            slots = slab.slot_of_expert[eids_np]
            if (slots < slab.C).any():
                sets.append((slab.buffers, slots, slab.slot_expert))
            if missing:  # the overflow group's copies
                with tr.span("moe.fetch", layer=moe_idx, experts=len(missing)):
                    sets.append(self._overflow_set(moe_idx, eids_np, missing))
                    self._obs_sync()
        with tr.span("moe.compute", layer=moe_idx):
            if self.quantized:
                qset = self._quant_slab_set(moe_idx, h2f, eids_np)
                sets = [qset] if qset[2].size else []
            y = (self._moe_sets(sets, h2f, gates, eids_np, lora) if sets
                 else torch.zeros_like(h2f))
            self._obs_sync()
        if self.quantized and missing:  # |needed| > C spillover, C < K, baselines
            with tr.span("moe.fetch", layer=moe_idx, experts=len(missing)):
                ws = self._spill_load(moe_idx, missing)
                self._obs_sync()
            with tr.span("moe.spillover", layer=moe_idx, experts=len(missing)):
                extra = self._quant_spillover(ws, h2f, gates, eids, missing, lora)
                y = y + extra.to(y.dtype)
                self._obs_sync()
        if self.moe_spec.shared_d_ff:
            with tr.span("moe.compute", layer=moe_idx, shared=True):
                y = y + apply_mlp(layer["params"]["ffn"]["shared"], h2f)
                self._obs_sync()
        if degraded:
            with tr.span("moe.degraded", layer=moe_idx, experts=len(degraded)):
                extra = self.little.contrib(moe_idx, h2f, gates, eids, degraded)
                y = y + extra.to(y.dtype)
                self._obs_sync()
        return y

    def _quant_slab_set(self, moe_idx: int, h2f, eids_np):
        """The INT4 slab as a group set: the slots this step uses are
        dequantized into the activation dtype (``dequant_ref`` batched
        over slots, the JAX ``_dequant_slab_mat``; an unused slot would
        only meet zero rows) and renumbered 0..G-1 (the LoRA gather
        follows the renumbering)."""
        slab = self._slabs[moe_idx]
        slots = slab.slot_of_expert[eids_np]
        # empty only where nothing is admitted (the baselines' empty slab, or
        # every miss degraded): otherwise the step's last routed expert is
        # resident, as the manager admits every miss
        used = np.unique(slots[slots < slab.C])
        remap = np.full(slab.C + 1, used.size, np.int64)
        remap[used] = np.arange(used.size)
        return self._dequant_slots(moe_idx, used, h2f.dtype), remap[slots], slab.slot_expert[used]

    def _dequant_slots(self, moe_idx: int, used: np.ndarray, dtype):
        """{k: (G, K, N)} weights of the slab slots ``used``, in ``dtype``:
        dequantized a part of at most _DEQUANT_PART_BYTES of fp32 at a time,
        each part cast as one call's would be (the same bits)."""
        idx = torch.as_tensor(used).to(self.device)
        out = {}
        for k, mq in self._slab_q[moe_idx].items():
            K, N = 2 * mq.packed.shape[-2], mq.packed.shape[-1]
            step = max(1, _DEQUANT_PART_BYTES // (K * N * 4))
            w = torch.empty((len(used), K, N), dtype=dtype, device=self.device)
            for s in range(0, len(used), step):
                part = idx[s:s + step]
                w[s:s + step] = dequant_ref(mq.packed[part], mq.scale[part], mq.zero[part],
                                            mq.group)
            out[k] = w
        return out

    def _spill_load(self, moe_idx: int, missing) -> Dict[str, MatmulQWeight]:
        """Copy the INT4 experts ``missing`` into a reused buffer; returns
        its ``{k: MatmulQWeight}`` views."""
        buf = self._overflow_buffers(len(missing))
        for i, e in enumerate(missing):
            self._load(moe_idx, e, buf, i)
        return self._qlayout.views(buf["q"])

    def _quant_spillover(self, ws, h2f, gates, eids, missing, lora):
        """The experts the INT4 slab could not hold (``ws``, as
        :meth:`_spill_load` copied them) through :meth:`_per_expert_contrib`.
        Returns (N, d) fp32."""
        slot = {e: i for i, e in enumerate(missing)}
        return self._per_expert_contrib(
            h2f, gates, eids, missing,
            lambda e: {k: MatmulQWeight(v.packed[slot[e]], v.scale[slot[e]],
                                        v.zero[slot[e]], v.group) for k, v in ws.items()},
            lora)

    def _per_expert_contrib(self, h2f, gates, eids, expert_ids, weight_for, lora):
        """The eager per-expert gated MLP of the dict engine and the INT4
        spillover (the JAX ``_per_expert_contrib``): for each expert of
        ``expert_ids`` in order, its weights ``weight_for(e)`` (fp ``(K,
        N)`` tensors, or ``MatmulQWeight`` codes), three products
        (``qmatmul`` for codes, the ``int4_matmul`` kernel on the card;
        ``torch.matmul`` in the promoted type of the activations and the
        weights otherwise, the reference's ``x @ w``), gate-massed fp32
        accumulation. LoRA as the reference's eager term: ``scale * ((x @
        a) @ b)`` in the promoted type of ``x`` and the adapters, cast to
        the activation type. Returns (N, d) fp32."""
        # gate mass per (token, expert): an expert appears at most once in a
        # token's top-k, so this is the where(eids == e, gates, 0).sum(-1)
        # of the reference exactly
        mass = torch.zeros((h2f.shape[0], self.moe_spec.num_experts),
                           dtype=torch.float32, device=self.device)
        mass.scatter_add_(1, eids.long(), gates.float())
        be = self.rt.kernel_backend
        sc = self.lora_scale

        def mm(x, w):
            if isinstance(w, MatmulQWeight):
                return qmatmul(x, w, backend=be)
            ct = torch.promote_types(x.dtype, w.dtype)
            return x.to(ct) @ w.to(ct)

        def low_rank(x, t, e, out_dtype):
            a, b = lora[t]["a"][e], lora[t]["b"][e]
            ct = torch.promote_types(x.dtype, a.dtype)
            return sc * ((x.to(ct) @ a.to(ct)) @ b.to(ct)).to(out_dtype)

        out = torch.zeros(h2f.shape, dtype=torch.float32, device=self.device)
        for e in expert_ids:
            w = weight_for(e)
            hg, hu = mm(h2f, w["wg"]), mm(h2f, w["wu"])
            if lora is not None:
                hu = hu + low_rank(h2f, "wu", e, hu.dtype)
            h_act = silu(hg) * hu
            ye = mm(h_act, w["wd"])
            if lora is not None:
                ye = ye + low_rank(h_act, "wd", e, ye.dtype)
            out = out + mass[:, e:e + 1] * ye.float()
        return out

    def _moe_forward(self, layer: dict, h2):
        """The dict engine's MoE layer, h2 (B, T, d) -> (B, T, d): router
        and top-k (``moe.pre``); the cache manager token by token
        (``moe.account``: ``stream_all`` charges every assignment,
        ``cpu_execute`` books each miss as host-executed, else each miss
        passes its degrade verdict under the resilience hooks and is
        fetched, in the reference's order); then the eager per-expert
        compute over the step's routed experts less the degraded ones
        (residents, or a transient copy), the little tier for those, and
        the shared expert (``moe.compute``)."""
        tr = get_tracer()
        moe_idx, spec = layer["moe_idx"], layer["spec"].moe
        B, T, dm = h2.shape
        h2f = h2.reshape(B * T, dm)
        with tr.span("moe.pre", layer=moe_idx):
            probs = router_probs(layer["params"]["ffn"], h2f, spec)
            gates, eids = top_k_route(probs, spec.top_k)
            eids_np = eids.cpu().numpy()
        m = self.metrics
        degraded: set = set()
        resilient = self._resilience_active()
        # the account span brackets the loop; the demand copies nest their
        # own moe.fetch spans inside it
        with tr.span("moe.account", layer=moe_idx, tokens=B * T):
            for n in range(B * T):
                if self.stream_all:
                    m.add_demand_transfers(moe_idx, spec.top_k,
                                           spec.top_k * self.expert_bytes)
                    continue
                for e in self.cache.access(moe_idx, eids_np[n]):
                    e = int(e)
                    if self.cpu_execute:  # a cost model: computed on the device
                        m.host_executed += 1
                    elif resilient and self._miss_verdict(moe_idx, e):
                        # abandoned fetch / quality roll: the little expert
                        # serves, and the expert stays modeled-non-resident
                        self.cache.layers[moe_idx].resident.discard(e)
                        if e not in degraded:
                            m.degraded_uses += 1
                        degraded.add(e)
                    else:  # a later fetch supersedes an earlier give-up
                        degraded.discard(e)
                        self._fetch(moe_idx, e)
        needed = sorted(set(np.unique(eids_np).tolist()) - degraded)
        res = self.resident[moe_idx]
        with tr.span("moe.compute", layer=moe_idx, experts=len(needed)):
            out = self._per_expert_contrib(
                h2f, gates, eids, needed,
                lambda e: res[e] if e in res else self._device_weights(moe_idx, e),
                layer["lora"])
            if degraded:
                with tr.span("moe.degraded", layer=moe_idx, experts=len(degraded)):
                    out = out + self.little.contrib(moe_idx, h2f, gates, eids,
                                                    sorted(degraded))
            y = out.to(h2.dtype)
            if spec.shared_d_ff:
                y = y + apply_mlp(layer["params"]["ffn"]["shared"], h2f)
            self._obs_sync()
        return y.reshape(B, T, dm)

    def _overflow_set(self, moe_idx: int, eids_np, missing):
        """A transient stack of the experts the slab could not hold this
        step, as a group set."""
        w = self._overflow_buffers(len(missing))
        soe = np.full(self.moe_spec.num_experts, len(missing), np.int64)
        for i, e in enumerate(missing):
            soe[e] = i
            self._load(moe_idx, e, w, i)
        return w, soe[eids_np], np.asarray(missing, np.int64)

    # ------------------------------------------------------------------
    def _forward_layers(self, x, positions, caches, decode_pos=None):
        """One engine step through every layer: attention (prefill through
        the flash kernel, or one decode position), router, MoE; a block
        without experts, and every block of the dict engine, runs through
        :meth:`_block_forward`."""
        cfg = self.cfg
        tr = get_tracer()
        for idx, layer in enumerate(self.layers):
            b, p = layer["spec"], layer["params"]
            if self.impl == "dict" or b.kind != "attn_moe":
                x = self._block_forward(layer, x, positions, caches, idx, decode_pos)
                continue
            with tr.span("moe.pre", layer=layer["moe_idx"]):
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
                # the host cache manager needs the ids (this copy waits for
                # the layer's device work)
                eids_np = eids.cpu().numpy()
            missing, degraded = self._prep_moe(layer["moe_idx"], eids_np)
            y = self._finish_moe(layer, h2f, gates, eids, eids_np, missing, degraded)
            x = xa + y.reshape(B, T, dm)
        return x

    def _block_forward(self, layer: dict, x, positions, caches, idx, decode_pos=None):
        """A block without experts (``attn_dense``, ``shared_attn``,
        ``mamba``), whole on the device, or a dict engine's ``attn_moe``
        block (attention and norms in a ``moe.pre`` span, then
        :meth:`_moe_forward`): full sequence (``decode_pos`` None, filling
        ``caches[idx]``) or one decode step."""
        cfg, b, p = self.cfg, layer["spec"], layer["params"]
        tr = get_tracer()
        if b.kind == "mamba":
            with tr.span("engine.block", kind="mamba", idx=idx):
                if decode_pos is None:
                    x2, aux = apply_block_full(p, cfg, b, x, positions, self.rt,
                                               want_cache=True, cache_slots=0)
                    caches[idx] = aux["kv"]
                else:
                    h = rms_norm(p["ln1"], x, cfg.norm_eps)
                    y, caches[idx] = apply_mamba_decode(p["mixer"], h, caches[idx], b.ssm)
                    x2 = x + y
                self._obs_sync()
            return x2
        moe = b.moe is not None
        with (tr.span("moe.pre", layer=layer["moe_idx"]) if moe
              else tr.span("engine.block", kind=b.kind, idx=idx)):
            h = rms_norm(p["ln1"], x, cfg.norm_eps)
            if decode_pos is None:
                y, (k, v) = attend_full(p["mixer"], b.attn, h, positions, b.attn.window,
                                        return_kv=True, rt=self.rt)
                caches[idx] = cache_from_prefill(k, v, b.attn, self._n_slots)
            else:
                y, caches[idx] = decode_attend(p["mixer"], b.attn, h, caches[idx],
                                               decode_pos, b.attn.window)
            x = x + y
            h2 = rms_norm(p["ln2"], x, cfg.norm_eps)
            self._obs_sync()
        if moe:
            return x + self._moe_forward(layer, h2)
        with tr.span("engine.block", kind="ffn", idx=idx):
            x = x + apply_mlp(p["ffn"], h2)
            self._obs_sync()
        return x

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate(self, prompt_tokens, max_new_tokens: int, prefix_embed=None, *,
                 quality: float = 1.0, deadline_s: Optional[float] = None) -> dict:
        """Greedy decoding. prompt_tokens (B, T) ints, after the P rows of
        ``prefix_embed`` (B, P, d) where one is given: the prefill runs
        over P + T positions and decoding starts at P + T. Returns a dict with
        tokens (B, n) int32 (n = ``max_new_tokens`` unless stopped early),
        the last prompt position's logits, metrics, both Eq.-3 clocks, the
        measured times, the host -> device expert copies and the kernel
        launches of each phase (by op and route).

        ``quality`` (the per-request quality-vs-latency dial; it needs a
        little bank and has no effect without one) sets the fraction of
        cache misses served by the big expert: 1.0 = always exact, 0.0 =
        always the little distillate. ``deadline_s`` bounds this call's
        serial Eq.-3 seconds: past ``pressure_frac`` of the budget the
        remaining misses go all-little, and once the budget is spent
        decoding stops (``stopped_early``). Under an installed fault plan
        each decode step first passes a crash point (``engine.decode``) and
        an eviction-storm draw, and every miss a fetch trial."""
        cfg = self.cfg
        tr = get_tracer()
        plan = get_fault_plan()
        self._gen_step = 0
        self._step_quality = quality if self.little is not None else 1.0
        routes0 = dispatch.route_snapshot()
        copies0 = self.expert_copies
        t0 = time.perf_counter()
        toks = torch.as_tensor(prompt_tokens).to(self.device, torch.long)
        B, T = toks.shape
        L_moe = len(self.moe_layer_ids)
        P = prefix_embed.shape[1] if prefix_embed is not None else 0
        self._n_slots = P + T + max_new_tokens
        m = self.metrics
        elapsed = 0.0  # serial Eq.-3 seconds of this call's steps
        stopped_early = False

        with tr.span("engine.prefill", batch=B, prompt_len=T, impl=self.impl):
            m.begin_step(L_moe)
            with tr.span("engine.embed"):
                x = embed_tokens(self.params_top, cfg, toks, prefix_embed)
                self._obs_sync()
            positions = torch.arange(P + T, device=self.device).expand(B, P + T)
            caches: List = [None] * len(self.layers)
            x = self._forward_layers(x, positions, caches)
            m.add_flops(self._flops_per_token * B * (P + T))
            with tr.span("engine.logits"):
                logits = compute_logits(self.params_top, cfg, x[:, -1:])
                next_tok = torch.argmax(logits, -1).to(torch.int32)
                self._sync()
        t_prefill = time.perf_counter()
        m.prefill_wall_time = t_prefill - t0
        routes1 = dispatch.route_snapshot()
        copies1 = self.expert_copies
        elapsed += m.serial_span(self.hw, len(m.step_flops) - 1)

        out_tokens = [next_tok]
        pos = P + T
        for step in range(max_new_tokens - 1):
            if deadline_s is not None:
                if elapsed >= deadline_s:
                    stopped_early = True
                    break
                if self.little is not None and elapsed >= self.pressure_frac * deadline_s:
                    self._step_quality = 0.0  # deadline pressure
            if plan.enabled:  # a crash point, then the step's eviction-storm draw
                plan.maybe_crash("engine.decode")
                frac = plan.eviction_storm()
                if frac:
                    self._apply_storm(frac)
            self._gen_step = step + 1
            with tr.span("engine.decode_step", step=step, batch=B, impl=self.impl):
                m.begin_step(L_moe)
                with tr.span("engine.embed"):
                    x = embed_tokens(self.params_top, cfg, next_tok.long())
                    self._obs_sync()
                x = self._forward_layers(x, positions, caches, decode_pos=pos)
                with tr.span("engine.logits"):
                    next_tok = torch.argmax(compute_logits(self.params_top, cfg, x), -1
                                            ).to(torch.int32)
                    self._obs_sync()
                out_tokens.append(next_tok)
                pos += 1
                m.decode_tokens += 1
                m.add_flops(self._flops_per_token * B)
            elapsed += m.serial_span(self.hw, len(m.step_flops) - 1)
        m.decode_tokens += 1
        self._step_quality = 1.0
        tokens = torch.cat(out_tokens, dim=1)
        self._sync()
        m.wall_time = time.perf_counter() - t0
        m.decode_wall_time = m.wall_time - m.prefill_wall_time
        m.host_time = (m.host_executed * (3 * 2 * cfg.d_model * self.moe_spec.d_ff)
                       / self.hw.host_flops)
        decode_steps = len(out_tokens) - 1
        return {
            "tokens": tokens,
            "prefill_logits": logits[:, 0],
            "metrics": m,
            "stopped_early": stopped_early,
            "cache_stats": self.cache.stats(),
            "transfers_per_layer": self.cache.transfers_per_layer(),
            "throughput_tok_s": m.throughput(self.hw, batch=B),
            "throughput_overlapped_tok_s": m.throughput(self.hw, batch=B, overlap=True),
            "modeled_time_s": m.modeled_time(self.hw),
            "modeled_time_overlapped_s": m.modeled_time_overlapped(self.hw),
            "prefill_s": m.prefill_wall_time,
            "decode_tok_s": (B * decode_steps / m.decode_wall_time
                             if decode_steps and m.decode_wall_time > 0 else 0.0),
            "expert_copies": {"prefill": copies1 - copies0,
                              "decode": self.expert_copies - copies1},
            "route_launches": {
                "prefill": dispatch.route_delta(routes0, routes1),
                "decode": dispatch.route_delta(routes1, dispatch.route_snapshot())},
        }
