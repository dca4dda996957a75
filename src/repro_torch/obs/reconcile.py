"""Reconcile the Eq.-3 modeled clock against measured trace spans (a
copy of ``repro/obs/reconcile.py``; the span-name contract is the
reference's, name for name).

The port's engine runs every call eagerly, so its spans fall finer than
the reference's: where the JAX engine fuses layer ``l``'s grouped
compute with layer ``l+1``'s attention and router in one call (charged
to ``moe.compute`` with ``fused=True``), the port records ``moe.compute``
and ``moe.pre`` apart. The modeled columns and per-layer transfer counts
depend only on counts and equal the reference's; the measured seconds
do not.

The offload engine charges a *modeled* serial clock (Eq. 3:
``t_compute + t_transfer``) and a modeled *overlapped* clock (layer
``l``'s compute hides layer ``l+1``'s fetches). Both were, until now,
unchecked assertions. Given the spans an instrumented engine run
recorded, this module:

1. buckets measured time into the model's own categories — *fetch*
   (demand + prefetch host->device staging) and *compute* (attention/
   router, grouped expert matmuls, spillover, embed/logits/non-MoE
   blocks) — per MoE layer;
2. measures the *actual* fetch/compute overlap per layer (wall-clock
   intersection of layer ``l`` compute spans with layer ``l+1`` fetch
   spans — the exact quantity the overlapped clock models);
3. calibrates an effective hardware profile from the run (achieved
   flops/s and link bytes/s) and rebuilds the Eq.-3 serial clock at
   measured rates;
4. checks the invariant: the rebuilt Eq.-3 serial clock explains the
   engine's measured step wall to within a stated tolerance (the
   residual is unmodeled overhead: cache accounting, dispatch, Python).

The per-layer table shows modeled (under the *configured* profile,
e.g. the H100 PCIe-gen5 constants), calibrated (measured rates), and measured
seconds side by side, absolute and as ratios, so "where does Eq. 3
disagree with reality" is one table read.

Span-name contract (what the engine instrumentation emits):

======================  =====================================  ========
name                    meaning                                category
======================  =====================================  ========
``engine.prefill``      one whole prefill step                 step
``engine.decode_step``  one whole decode step                  step
``engine.prefetch``     one whole proactive-prefetch pass      step
``moe.pre``             attention + router for a MoE layer     compute
``moe.compute``         grouped expert compute (or fused        compute
                        compute(l) + pre(l+1))
``moe.spillover``       overflow-bucket expert compute         compute
``engine.embed``        token embedding                        compute
``engine.logits``       lm-head logits + argmax                compute
``engine.block``        a non-MoE block                        compute
``moe.fetch``           demand expert staging + upload         fetch
``moe.prefetch``        proactive expert staging + upload      fetch
``moe.account``         host-side cache accounting             overhead
======================  =====================================  ========

MoE spans carry ``layer=<moe_idx>``; compute spans without a layer are
pooled into the "other" row (the model splits step flops uniformly over
MoE layers, so "other" has no modeled column).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import SpanRecord

FETCH_SPANS = frozenset({"moe.fetch", "moe.prefetch"})
COMPUTE_SPANS = frozenset({
    "moe.pre", "moe.compute", "moe.spillover",
    "engine.embed", "engine.logits", "engine.block",
})
OVERHEAD_SPANS = frozenset({"moe.account"})
STEP_SPANS = frozenset({"engine.prefill", "engine.decode_step",
                        "engine.prefetch"})

OTHER = -1  # pseudo-layer for compute not attributable to a MoE layer


def _intersect(a: List[Tuple[float, float]],
               b: List[Tuple[float, float]]) -> float:
    """Total overlap seconds between two interval lists (merge sweep)."""
    a = sorted(a)
    b = sorted(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclass
class LayerReconciliation:
    layer: int  # OTHER == unattributed compute
    transfers: int = 0
    transfer_bytes: int = 0
    measured_fetch_s: float = 0.0
    measured_compute_s: float = 0.0
    measured_overlap_s: float = 0.0  # compute(l) ∩ fetch(l+1), wall clock
    modeled_fetch_s: float = 0.0  # under the configured hw profile
    modeled_compute_s: float = 0.0
    calibrated_fetch_s: float = 0.0  # under measured effective rates
    calibrated_compute_s: float = 0.0

    @property
    def fetch_ratio(self) -> float:
        """measured / calibrated fetch (1.0 == layer behaves like the
        run-average link rate)."""
        return (self.measured_fetch_s / self.calibrated_fetch_s
                if self.calibrated_fetch_s > 0 else 0.0)

    @property
    def compute_ratio(self) -> float:
        return (self.measured_compute_s / self.calibrated_compute_s
                if self.calibrated_compute_s > 0 else 0.0)


@dataclass
class ReconciliationReport:
    hw_name: str
    tolerance: float
    # measured, from spans
    measured_serial_s: float  # Σ step spans: the engine runs serially
    measured_fetch_s: float
    measured_compute_s: float
    measured_account_s: float
    measured_overlap_s: float  # Σ per-layer compute(l) ∩ fetch(l+1)
    unmodeled_s: float  # step wall - (fetch + compute + host_time)
    # modeled, under the configured profile (prefetch included in serial
    # so it compares like-for-like with the measured fetch spans)
    modeled_serial_s: float
    modeled_overlapped_s: float
    modeled_hidden_s: float  # serial - overlapped: what Eq. 3 claims hides
    host_time_s: float
    # Eq. 3 rebuilt at measured rates — the checked invariant
    eq3_at_measured_rates_s: float
    serial_agreement_ratio: float  # eq3_at_measured_rates / measured_serial
    ok: bool
    effective_flops: float  # achieved flop/s over measured compute
    effective_link_bw: float  # achieved bytes/s over measured fetch
    layers: List[LayerReconciliation] = field(default_factory=list)

    # ------------------------------------------------------------------
    def to_json(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if k != "layers"}
        d["layers"] = [
            {**l.__dict__, "fetch_ratio": l.fetch_ratio,
             "compute_ratio": l.compute_ratio}
            for l in self.layers
        ]
        return d

    def format_table(self) -> str:
        """Per-layer modeled vs measured table + reconciliation footer."""
        ms = lambda s: f"{s * 1e3:9.3f}"
        hdr = (f"{'layer':>5} {'tx':>6} {'fetch meas(ms)':>14} "
               f"{'fetch cal(ms)':>13} {'f.ratio':>7} "
               f"{'comp meas(ms)':>13} {'comp cal(ms)':>12} {'c.ratio':>7} "
               f"{'hidden meas(ms)':>15}")
        lines = [hdr, "-" * len(hdr)]
        for l in self.layers:
            name = "other" if l.layer == OTHER else str(l.layer)
            lines.append(
                f"{name:>5} {l.transfers:>6d} {ms(l.measured_fetch_s):>14} "
                f"{ms(l.calibrated_fetch_s):>13} {l.fetch_ratio:>7.2f} "
                f"{ms(l.measured_compute_s):>13} "
                f"{ms(l.calibrated_compute_s):>12} {l.compute_ratio:>7.2f} "
                f"{ms(l.measured_overlap_s):>15}")
        lines += [
            "-" * len(hdr),
            f"measured serial (step wall)      {self.measured_serial_s * 1e3:10.3f} ms",
            f"  = fetch {self.measured_fetch_s * 1e3:.3f}"
            f" + compute {self.measured_compute_s * 1e3:.3f}"
            f" + host {self.host_time_s * 1e3:.3f}"
            f" + unmodeled {self.unmodeled_s * 1e3:.3f} ms"
            f" (accounting spans: {self.measured_account_s * 1e3:.3f} ms)",
            f"Eq.3 at measured rates           "
            f"{self.eq3_at_measured_rates_s * 1e3:10.3f} ms"
            f"  agreement {self.serial_agreement_ratio:.3f}"
            f" (tolerance ±{self.tolerance:.2f}) ->"
            f" {'OK' if self.ok else 'FAIL'}",
            f"modeled serial [{self.hw_name}]     "
            f"{self.modeled_serial_s * 1e3:10.3f} ms"
            f"   overlapped {self.modeled_overlapped_s * 1e3:.3f} ms"
            f"   (claims {self.modeled_hidden_s * 1e3:.3f} ms hidden;"
            f" measured overlap {self.measured_overlap_s * 1e3:.3f} ms)",
            f"effective rates: {self.effective_flops / 1e9:.2f} GFLOP/s, "
            f"{self.effective_link_bw / 1e9:.3f} GB/s link",
        ]
        return "\n".join(lines)


def reconcile(spans: Sequence[SpanRecord], metrics, hw, *,
              tolerance: float = 0.35) -> ReconciliationReport:
    """Check the Eq.-3 clocks of ``metrics`` (an ``EngineMetrics``)
    against the spans of the same run.

    ``ok`` asserts that the Eq.-3 serial decomposition, evaluated at the
    run's *measured* rates (achieved flops/s and link bytes/s), explains
    the measured step wall within ``tolerance`` — i.e. the model's two
    terms account for where the time actually went, with only a bounded
    unmodeled residual (cache accounting, dispatch, Python glue).
    """
    fetch_iv: Dict[int, List[Tuple[float, float]]] = {}
    comp_iv: Dict[int, List[Tuple[float, float]]] = {}
    fetch_s: Dict[int, float] = {}
    comp_s: Dict[int, float] = {}
    account_s = 0.0
    step_wall = 0.0
    for s in spans:
        layer = s.args.get("layer", OTHER)
        if s.name in FETCH_SPANS:
            fetch_s[layer] = fetch_s.get(layer, 0.0) + s.dur
            fetch_iv.setdefault(layer, []).append((s.t0, s.t1))
        elif s.name in COMPUTE_SPANS:
            comp_s[layer] = comp_s.get(layer, 0.0) + s.dur
            comp_iv.setdefault(layer, []).append((s.t0, s.t1))
        elif s.name in OVERHEAD_SPANS:
            account_s += s.dur
        elif s.name in STEP_SPANS:
            step_wall += s.dur

    layer_tx = dict(getattr(metrics, "layer_tx", {}))
    layer_tx_bytes = dict(getattr(metrics, "layer_tx_bytes", {}))
    for l, n in getattr(metrics, "layer_prefetch_tx", {}).items():
        layer_tx[l] = layer_tx.get(l, 0) + n
    for l, b in getattr(metrics, "layer_prefetch_bytes", {}).items():
        layer_tx_bytes[l] = layer_tx_bytes.get(l, 0) + b

    moe_layers = sorted(
        set(layer_tx) | {l for l in (set(fetch_s) | set(comp_s)) if l != OTHER}
    )
    L = max(len(moe_layers), 1)

    meas_fetch = sum(fetch_s.values())
    meas_comp = sum(comp_s.values())
    host_time = float(getattr(metrics, "host_time", 0.0))

    # -- calibration: effective rates achieved over this run -------------
    total_bytes = (metrics.transfer_bytes + metrics.prefetch_bytes)
    eff_flops = metrics.compute_flops / meas_comp if meas_comp > 0 else 0.0
    eff_bw = total_bytes / meas_fetch if meas_fetch > 0 else 0.0

    # -- modeled, configured profile (prefetch folded into serial) -------
    speed = hw.peak_flops * hw.mfu
    modeled_comp = metrics.compute_flops / speed
    modeled_fetch = (
        total_bytes / hw.host_link_bw
        + (metrics.transfers + metrics.prefetch_transfers)
        * hw.transfer_latency
    )
    # Injected fault delay is charged serially by both engine clocks
    # (EngineMetrics.modeled_time and the per-step overlapped spans), so
    # it belongs on the serial side here too — else overlapped > serial.
    fault_delay = float(getattr(metrics, "fault_delay_s", 0.0))
    modeled_serial = modeled_comp + modeled_fetch + host_time + fault_delay
    prefetch_t = (
        metrics.prefetch_bytes / hw.host_link_bw
        + metrics.prefetch_transfers * hw.transfer_latency
    )
    modeled_overlapped = metrics.modeled_time_overlapped(hw) + prefetch_t

    # -- per-layer rows ---------------------------------------------------
    rows: List[LayerReconciliation] = []
    for l in moe_layers:
        nxt = l + 1
        row = LayerReconciliation(
            layer=l,
            transfers=int(layer_tx.get(l, 0)),
            transfer_bytes=int(layer_tx_bytes.get(l, 0)),
            measured_fetch_s=fetch_s.get(l, 0.0),
            measured_compute_s=comp_s.get(l, 0.0),
            measured_overlap_s=_intersect(comp_iv.get(l, []),
                                          fetch_iv.get(nxt, [])),
            modeled_fetch_s=(
                layer_tx_bytes.get(l, 0) / hw.host_link_bw
                + layer_tx.get(l, 0) * hw.transfer_latency
            ),
            modeled_compute_s=modeled_comp / L,
            calibrated_fetch_s=(layer_tx_bytes.get(l, 0) / eff_bw
                                if eff_bw > 0 else 0.0),
            calibrated_compute_s=(metrics.compute_flops / L / eff_flops
                                  if eff_flops > 0 else 0.0),
        )
        rows.append(row)
    if OTHER in comp_s or OTHER in fetch_s:
        rows.append(LayerReconciliation(
            layer=OTHER,
            measured_fetch_s=fetch_s.get(OTHER, 0.0),
            measured_compute_s=comp_s.get(OTHER, 0.0),
        ))

    # -- the checked invariant -------------------------------------------
    eq3_measured = meas_fetch + meas_comp + host_time
    measured_serial = step_wall if step_wall > 0 else eq3_measured
    ratio = eq3_measured / measured_serial if measured_serial > 0 else 0.0
    ok = measured_serial > 0 and abs(1.0 - ratio) <= tolerance

    return ReconciliationReport(
        hw_name=getattr(hw, "name", "hw"),
        tolerance=tolerance,
        measured_serial_s=measured_serial,
        measured_fetch_s=meas_fetch,
        measured_compute_s=meas_comp,
        measured_account_s=account_s,
        measured_overlap_s=sum(r.measured_overlap_s for r in rows),
        unmodeled_s=max(measured_serial - eq3_measured, 0.0),
        modeled_serial_s=modeled_serial,
        modeled_overlapped_s=modeled_overlapped,
        modeled_hidden_s=max(modeled_serial - modeled_overlapped, 0.0),
        host_time_s=host_time,
        eq3_at_measured_rates_s=eq3_measured,
        serial_agreement_ratio=ratio,
        ok=ok,
        effective_flops=eff_flops,
        effective_link_bw=eff_bw,
        layers=rows,
    )
