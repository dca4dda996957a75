"""Crash-safe serving: journal, checkpoint/restore, integrity watchdog
(counterpart of ``repro/recovery/``).

Layers:
  serial.py     — shared array/bytes serialization + atomic file writes
                  (also used by ``training/checkpoint.py``)
  msgpack_lite.py — the msgpack subset both checkpoint kinds are written
                  in (byte for byte the reference's ``msgpack`` output)
  journal.py    — append-only JSONL write-ahead request journal with
                  atomic-rename rotation and crash-tolerant replay
  checkpoint.py — periodic server snapshots (queue, in-flight progress,
                  sampler seed, ServerMetrics, per-layer cache state)
                  and the restore path that rebuilds a resumable state
  audit.py      — invariant-audit watchdog cross-checking engine / cache
                  / queue / metrics accounting, publishing
                  ``audit_violations_total`` and self-healing slab drift
"""
from .audit import AuditError, Watchdog
from .checkpoint import (
    load_server_checkpoint,
    save_server_checkpoint,
)
from .journal import (
    JOURNAL_ENV_VAR,
    RecoveredState,
    RequestJournal,
    journal_dir_from_env,
    recover,
)
from .serial import array_record, atomic_write_bytes, record_array

__all__ = [
    "AuditError",
    "Watchdog",
    "RequestJournal",
    "RecoveredState",
    "recover",
    "journal_dir_from_env",
    "JOURNAL_ENV_VAR",
    "save_server_checkpoint",
    "load_server_checkpoint",
    "array_record",
    "record_array",
    "atomic_write_bytes",
]
