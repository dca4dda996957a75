"""Continuous-batching serving subsystem with expert-affinity scheduling
(counterpart of ``repro/serving``).

Layers:
  request.py    — ServeRequest / ServeResult
  queue.py      — RequestQueue + synthetic Poisson/bursty traffic
  scheduler.py  — fcfs / sjf / expert-affinity admission policies
  batch.py      — slot-based in-flight BatchState
  metrics.py    — ServerMetrics telemetry
  scorers.py    — per-request expert-preference scorers (oracle; the
                  Psi predictor waits for core/predictor.py)
                  (``profiling.py`` is a deprecated alias)
  server.py     — ContinuousBatchingServer (fits path), serve_static,
                  and OffloadedWaveServer (offloaded path: expert-affinity
                  waves with scheduler-driven prefetch)
"""
from .batch import BatchState, SlotState
from .metrics import ServerMetrics
from .queue import RequestQueue, TrafficConfig, synthesize_workload
from .request import ServeRequest, ServeResult
from .scheduler import (
    SCHEDULERS,
    ExpertAffinityScheduler,
    FCFSScheduler,
    Scheduler,
    SJFScheduler,
    get_scheduler,
)
from .scorers import (
    predictor_expert_scores,
    prefill_expert_scores,
    prompt_router_profile,
)
from .server import ContinuousBatchingServer, OffloadedWaveServer, serve_static

__all__ = [
    "BatchState",
    "SlotState",
    "ServerMetrics",
    "RequestQueue",
    "TrafficConfig",
    "synthesize_workload",
    "ServeRequest",
    "ServeResult",
    "SCHEDULERS",
    "Scheduler",
    "FCFSScheduler",
    "SJFScheduler",
    "ExpertAffinityScheduler",
    "get_scheduler",
    "ContinuousBatchingServer",
    "OffloadedWaveServer",
    "serve_static",
    "prefill_expert_scores",
    "predictor_expert_scores",
    "prompt_router_profile",
]
