"""Fault injection + resilience primitives for the offloaded serving
stack (counterpart of ``repro/faults/``).

Layers:
  plan.py   — seedable deterministic :class:`FaultPlan` (env/config
              driven, NullTracer-style zero cost when disabled) injecting
              transfer latency spikes, transient fetch failures, eviction
              storms, server clock stalls, and traffic bursts
  retry.py  — :class:`FetchPolicy`: per-fetch deadline with bounded
              exponential-backoff retries for the engine's host-transfer
              seam
"""
from .plan import (
    NULL_FAULT_PLAN,
    FaultConfig,
    FaultPlan,
    InjectedCrash,
    NullFaultPlan,
    fault_plan_from_env,
    get_fault_plan,
    install_fault_plan,
    parse_fault_spec,
    uninstall_fault_plan,
)
from .retry import NAIVE_POLICY, FetchPolicy

__all__ = [
    "FaultConfig",
    "FaultPlan",
    "InjectedCrash",
    "NullFaultPlan",
    "NULL_FAULT_PLAN",
    "FetchPolicy",
    "NAIVE_POLICY",
    "get_fault_plan",
    "install_fault_plan",
    "uninstall_fault_plan",
    "parse_fault_spec",
    "fault_plan_from_env",
]
