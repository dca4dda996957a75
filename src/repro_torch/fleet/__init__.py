"""Supervised serving fleet (counterpart of ``repro/fleet/``).

Layers:
  heartbeat.py  — atomic per-worker heartbeat files (seq, pid, phase,
                  step watermark, queue depth, metrics snapshot)
  worker.py     — ``python -m repro_torch.fleet.worker``: one journaled
                  server per process; implicit journal recovery, inbox
                  re-offers, step-hook heartbeats + worker faults,
                  SIGTERM drain; weights from a seed or a params-only
                  checkpoint, on ``cuda`` unless the spec says ``cpu``
  supervisor.py — :class:`FleetSupervisor`: partition the trace,
                  launch N workers, classify healthy/degraded/hung/
                  dead, SIGKILL hangs, restart from the journal under
                  jittered backoff, circuit-break flapping workers and
                  re-offer their unfinished requests, drain on
                  SIGTERM, aggregate journals + telemetry
"""
from .heartbeat import HEARTBEAT_NAME, HeartbeatWriter, read_heartbeat
from .supervisor import (
    FleetConfig,
    FleetSupervisor,
    WorkerHandle,
    parse_worker_fault_schedule,
)


def __getattr__(name):
    # the worker module is also ``python -m``'s entry point: importing it
    # here, ahead of runpy, would load it twice in every worker process
    if name == "KILL_EXIT_CODE":
        from .worker import KILL_EXIT_CODE
        return KILL_EXIT_CODE
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "HEARTBEAT_NAME",
    "HeartbeatWriter",
    "read_heartbeat",
    "FleetConfig",
    "FleetSupervisor",
    "WorkerHandle",
    "parse_worker_fault_schedule",
    "KILL_EXIT_CODE",
]
