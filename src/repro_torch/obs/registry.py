"""Labeled metrics: counters, gauges, histograms with snapshot/diff (a
copy of ``repro/obs/registry.py``: pure Python).

A deliberately small Prometheus-shaped surface: metrics are identified
by ``(name, sorted labels)``, instruments are get-or-create so call
sites never coordinate, and the registry exports both JSON (for bench
reports) and Prometheus text exposition (for scraping). ``snapshot()``
returns a flat ``{key: float}`` dict and ``diff()`` subtracts two
snapshots, so "what did this request/trial cost" is one dict diff —
the same pattern ``EngineMetrics``/``ServerMetrics`` already use for
their scalar counters, generalized.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_BUCKETS = (
    1e-5, 1e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class Counter:
    """Monotonically increasing value."""

    kind = "counter"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def samples(self) -> List[Tuple[str, float]]:
        return [(self.name + _fmt_labels(self.labels), self.value)]


class Gauge(Counter):
    """Value that can go anywhere (set wins over inc)."""

    kind = "gauge"

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound; +Inf bucket == count)."""

    kind = "histogram"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self.bounds = tuple(sorted(buckets))
        self.counts = [0] * (len(self.bounds) + 1)  # +Inf last
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.total += 1
        self.sum += v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def samples(self) -> List[Tuple[str, float]]:
        out = []
        cum = 0
        for b, c in zip(self.bounds, self.counts[:-1]):
            cum += c
            lab = self.labels + (("le", repr(float(b))),)
            out.append((f"{self.name}_bucket" + _fmt_labels(lab), float(cum)))
        lab = self.labels + (("le", "+Inf"),)
        out.append((f"{self.name}_bucket" + _fmt_labels(lab), float(self.total)))
        out.append((f"{self.name}_count" + _fmt_labels(self.labels),
                    float(self.total)))
        out.append((f"{self.name}_sum" + _fmt_labels(self.labels), self.sum))
        return out


class MetricsRegistry:
    """Get-or-create home for labeled instruments.

    One global :data:`REGISTRY` serves the repo (servers and engines
    publish onto it); tests construct private registries.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        self._help: Dict[str, str] = {}

    def _get(self, cls, name: str, help: str, labels: Dict[str, object],
             **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, key[1], **kw)
                if help:
                    self._help.setdefault(name, help)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # -- export ------------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """Flat ``{"name{label=...}": value}`` over every sample (bucket
        rows included), suitable for JSON dumps and :meth:`diff`."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, float] = {}
        for m in metrics:
            out.update(m.samples())
        return out

    @staticmethod
    def diff(new: Dict[str, float], old: Dict[str, float]) -> Dict[str, float]:
        """new - old per key; keys only in ``new`` diff against 0."""
        return {k: v - old.get(k, 0.0) for k, v in new.items()}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        with self._lock:
            metrics = list(self._metrics.values())
            help_ = dict(self._help)
        by_name: Dict[str, List] = {}
        for m in metrics:
            by_name.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(by_name):
            group = by_name[name]
            if name in help_:
                lines.append(f"# HELP {name} {help_[name]}")
            lines.append(f"# TYPE {name} {group[0].kind}")
            for m in group:
                for key, val in m.samples():
                    if math.isnan(val):  # pragma: no cover - defensive
                        val = 0.0
                    lines.append(f"{key} {val:g}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._help.clear()


REGISTRY = MetricsRegistry()
