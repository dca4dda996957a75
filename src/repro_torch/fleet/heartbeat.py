"""Atomic heartbeat files: the worker -> supervisor liveness channel
(counterpart of ``repro/fleet/heartbeat.py``, the same JSON keys, so a
file written by either package is read by the other).

One JSON file per worker, overwritten whole via tmp + ``os.replace``,
so the supervisor never reads a torn write and never needs a lock. The
payload carries everything the liveness loop classifies on: a
monotonic sequence number, the writer's pid (so a stale file from a
dead incarnation is never mistaken for the fresh process), the worker
phase (init / ready / serving / idle / drained / done), the cumulative
step watermark, queue depth, and a ``ServerMetrics`` summary snapshot.

Staleness — ``time.time() - hb["ts"]`` — is the *only* signal that can
catch a hung worker: a wedged process keeps its pid and its exit code,
but stops replacing this file.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, Optional

HEARTBEAT_NAME = "heartbeat.json"


class HeartbeatWriter:
    """Atomically publish the worker's latest liveness snapshot."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.seq = 0
        self.last_ts = 0.0

    def beat(self, *, phase: str, step: int = 0, now: float = 0.0,
             backlog: int = 0, in_flight: int = 0, finished: int = 0,
             generated: int = 0, metrics: Optional[Dict] = None,
             min_interval_s: float = 0.0) -> bool:
        """Write one heartbeat; returns False when throttled (a beat
        younger than ``min_interval_s`` already exists — phase changes
        should pass 0 to always publish)."""
        t = time.time()
        if min_interval_s > 0.0 and t - self.last_ts < min_interval_s:
            return False
        self.seq += 1
        self.last_ts = t
        payload = {
            "seq": self.seq, "ts": t, "pid": os.getpid(), "phase": phase,
            "step": int(step), "now": float(now), "backlog": int(backlog),
            "in_flight": int(in_flight), "finished": int(finished),
            "generated": int(generated), "metrics": metrics or {},
        }
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)
        return True


def read_heartbeat(path) -> Optional[Dict]:
    """Latest heartbeat, or None when missing/unreadable. A partial
    read can't happen (writes are atomic renames), but a worker that
    died before its first beat leaves no file at all."""
    try:
        return json.loads(Path(path).read_text(encoding="utf-8"))
    except (OSError, json.JSONDecodeError):
        return None
