"""Structured tracing: nested spans + instant events over perf_counter.

The repo's latency story (Eq. 3: expert transfers hidden under compute)
was previously *asserted* by a modeled clock; this module records where
the time actually goes so ``obs.reconcile`` can check the model against
measurement.

Design constraints, in order:

* **Zero overhead when disabled.** The module-global tracer defaults to
  :data:`NULL_TRACER`; hot paths either guard on ``tracer.enabled``
  (one attribute check) or call :meth:`NullTracer.span`, which returns a
  shared no-op context manager without touching any buffer.
* **Nested spans.** ``with tracer.span("decode_layer", layer=3):``
  records (name, start, duration, thread, depth, attrs). Depth comes
  from a per-thread stack, so spans nest correctly across threads.
* **Exporters.** Chrome trace-event JSON (``ph="X"`` complete events,
  microsecond timestamps — loads directly in Perfetto / chrome://tracing)
  and line-per-record JSONL.
* **Always-timed spans.** :class:`clock_span` measures with
  ``perf_counter`` regardless of tracing state and exposes ``.dur`` —
  the serving clocks consume that, so the ad-hoc ``t0 = perf_counter()``
  pairs collapse into the same spans the trace records.

Optional ``torch.profiler.record_function`` pass-through: when a tracer
is created with ``torch_annotations=True``, every span also opens a
profiler range of the same name, so spans line up inside
``torch.profiler`` captures (on the CPU as on the card).

(Counterpart of ``repro/obs/trace.py``; the records, exporters and the
``REPRO_TRACE`` opt-in are the reference's.)
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from torch.profiler import record_function as _ProfilerRange


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


@dataclass
class SpanRecord:
    """One completed span. Times are ``perf_counter`` seconds."""

    name: str
    t0: float
    dur: float
    tid: int
    depth: int
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def t1(self) -> float:
        return self.t0 + self.dur


@dataclass
class InstantRecord:
    """A point event (cache miss, retirement, dispatch decision...)."""

    name: str
    t0: float
    tid: int
    args: Dict[str, Any] = field(default_factory=dict)


def _jsonable(v: Any) -> Any:
    """Coerce span-arg values to JSON-native types (numpy scalars show
    up constantly in this codebase)."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    try:
        import numpy as np

        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
    except Exception:  # pragma: no cover
        pass
    return str(v)


# ---------------------------------------------------------------------------
# Tracers
# ---------------------------------------------------------------------------


class _SpanCtx:
    """Context manager for one live span on the real tracer."""

    __slots__ = ("_tr", "name", "args", "t0", "dur", "_depth", "_range")

    def __init__(self, tr: "Tracer", name: str, args: Dict[str, Any]):
        self._tr = tr
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.dur = 0.0
        self._depth = 0
        self._range = None

    def __enter__(self) -> "_SpanCtx":
        tr = self._tr
        stack = tr._stack()
        self._depth = len(stack)
        stack.append(self)
        if tr.torch_annotations:
            self._range = _ProfilerRange(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.dur = time.perf_counter() - self.t0
        tr = self._tr
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        tr._append_span(
            SpanRecord(self.name, self.t0, self.dur,
                       threading.get_ident(), self._depth, self.args))


class _NullCtx:
    """Shared no-op context manager: the cost of a disabled span."""

    __slots__ = ()
    name = ""
    dur = 0.0
    t0 = 0.0

    def __enter__(self) -> "_NullCtx":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_CTX = _NullCtx()


class NullTracer:
    """Disabled tracing: every operation is a no-op, nothing is stored.
    Hot paths may guard on :attr:`enabled` (a class attribute, so the
    check is one attribute load) to skip even argument construction."""

    enabled = False
    torch_annotations = False

    def span(self, name: str, **args) -> _NullCtx:
        return _NULL_CTX

    def instant(self, name: str, **args) -> None:
        pass

    def spans(self) -> List[SpanRecord]:
        return []

    def instants(self) -> List[InstantRecord]:
        return []

    def drain(self):
        return [], []

    def clear(self) -> None:
        pass


class Tracer:
    """In-memory span/instant recorder with a bounded buffer.

    Thread safety: records append under a lock; the per-thread nesting
    stack lives in a ``threading.local``. When ``max_records`` is hit the
    oldest half of the buffer is dropped (and counted) rather than
    growing without bound in long-lived servers.
    """

    enabled = True

    def __init__(self, *, torch_annotations: bool = False,
                 max_records: int = 1_000_000):
        self.torch_annotations = torch_annotations
        self.max_records = max_records
        self.dropped = 0
        self._lock = threading.Lock()
        self._spans: List[SpanRecord] = []
        self._instants: List[InstantRecord] = []
        self._local = threading.local()

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **args) -> _SpanCtx:
        return _SpanCtx(self, name, args)

    def instant(self, name: str, **args) -> None:
        rec = InstantRecord(name, time.perf_counter(),
                            threading.get_ident(), args)
        with self._lock:
            self._instants.append(rec)
            if len(self._instants) > self.max_records:
                drop = len(self._instants) // 2
                del self._instants[:drop]
                self.dropped += drop

    def _append_span(self, rec: SpanRecord) -> None:
        with self._lock:
            self._spans.append(rec)
            if len(self._spans) > self.max_records:
                drop = len(self._spans) // 2
                del self._spans[:drop]
                self.dropped += drop

    # -- access ------------------------------------------------------------
    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def instants(self) -> List[InstantRecord]:
        with self._lock:
            return list(self._instants)

    def drain(self):
        """Return (spans, instants) and clear the buffers."""
        with self._lock:
            s, i = self._spans, self._instants
            self._spans, self._instants = [], []
        return s, i

    def clear(self) -> None:
        self.drain()

    # -- export ------------------------------------------------------------
    def to_chrome_trace(self, *, process_name: str = "repro") -> Dict[str, Any]:
        return chrome_trace(self.spans(), self.instants(),
                            process_name=process_name)

    def export_chrome_trace(self, path, *, process_name: str = "repro") -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(process_name=process_name), f)

    def export_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for s in self.spans():
                f.write(json.dumps({
                    "kind": "span", "name": s.name, "t0": s.t0,
                    "dur": s.dur, "tid": s.tid, "depth": s.depth,
                    "args": {k: _jsonable(v) for k, v in s.args.items()},
                }) + "\n")
            for i in self.instants():
                f.write(json.dumps({
                    "kind": "instant", "name": i.name, "t0": i.t0,
                    "tid": i.tid,
                    "args": {k: _jsonable(v) for k, v in i.args.items()},
                }) + "\n")


def chrome_trace(spans: List[SpanRecord],
                 instants: Optional[List[InstantRecord]] = None,
                 *, process_name: str = "repro") -> Dict[str, Any]:
    """Records -> Chrome trace-event JSON (Perfetto-loadable).

    Spans become ``ph="X"`` complete events; instants become ``ph="i"``.
    Timestamps are microseconds relative to the earliest record, so the
    trace opens at t=0 in the viewer.
    """
    pid = os.getpid()
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0, "ts": 0,
        "args": {"name": process_name},
    }]
    all_t0 = [s.t0 for s in spans] + [i.t0 for i in (instants or [])]
    base = min(all_t0) if all_t0 else 0.0
    tids: Dict[int, int] = {}

    def tid_of(raw: int) -> int:
        if raw not in tids:
            tids[raw] = len(tids)
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tids[raw], "ts": 0,
                           "args": {"name": f"thread-{len(tids) - 1}"}})
        return tids[raw]

    for s in spans:
        events.append({
            "name": s.name, "ph": "X", "cat": s.name.split(".")[0],
            "pid": pid, "tid": tid_of(s.tid),
            "ts": (s.t0 - base) * 1e6, "dur": s.dur * 1e6,
            "args": {k: _jsonable(v) for k, v in s.args.items()},
        })
    for i in instants or []:
        events.append({
            "name": i.name, "ph": "i", "cat": i.name.split(".")[0],
            "s": "t", "pid": pid, "tid": tid_of(i.tid),
            "ts": (i.t0 - base) * 1e6,
            "args": {k: _jsonable(v) for k, v in i.args.items()},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Module-global tracer
# ---------------------------------------------------------------------------

NULL_TRACER = NullTracer()
_tracer: Any = NULL_TRACER

ENV_VAR = "REPRO_TRACE"


def get_tracer():
    """The active tracer — :data:`NULL_TRACER` unless tracing was
    enabled. Callers on hot paths should hold the result once per call
    site and guard bulk work on ``.enabled``."""
    return _tracer


def enable_tracing(*, torch_annotations: bool = False,
                   max_records: int = 1_000_000) -> Tracer:
    """Install (and return) a fresh recording tracer as the global."""
    global _tracer
    _tracer = Tracer(torch_annotations=torch_annotations,
                     max_records=max_records)
    return _tracer


def disable_tracing() -> None:
    global _tracer
    _tracer = NULL_TRACER


if os.environ.get(ENV_VAR):  # opt-in via environment for any entry point
    enable_tracing()


class clock_span:
    """Always-timed span: ``.dur`` is measured with ``perf_counter``
    whether or not tracing is enabled, and the span is recorded to the
    active tracer only when it is. This is what replaces the serving
    loops' ad-hoc ``t0 = perf_counter(); ...; now += perf_counter()-t0``
    pairs: the clock and the trace read the same interval."""

    __slots__ = ("name", "args", "t0", "dur", "_ctx")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.dur = 0.0
        self._ctx: Optional[_SpanCtx] = None

    def __enter__(self) -> "clock_span":
        tr = _tracer
        if tr.enabled:
            self._ctx = tr.span(self.name, **self.args)
            self._ctx.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.dur = time.perf_counter() - self.t0
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
            self._ctx = None
