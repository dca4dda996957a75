"""Supervised serving-fleet launcher, PyTorch (counterpart of
``repro.launch.bench_fleet``).

    # 2 workers over a Poisson trace; kill worker 0 mid-serve and let
    # the supervisor restart it from its journal
    PYTHONPATH=src python -m repro_torch.launch.bench_fleet \
        --arch granite-moe-1b-a400m-smoke --device cpu --dtype float32 \
        --workers 2 --n-requests 8 --worker-faults "0:kill_at=4,seed=0" \
        --dir /tmp/fleet --out /tmp/fleet/report.json --prom /tmp/fleet/fleet.prom

Partitions the synthesized workload across N ``repro_torch.fleet.worker``
processes (each with its own journal under ``--dir/worker-i/``),
supervises heartbeats, restarts crashed/hung workers, re-offers
requests from circuit-broken workers, and aggregates the journals into
one report. SIGTERM drains the whole fleet gracefully (workers finish
in-flight, checkpoint, exit 0) and still exits 0 as long as every
request is finished or checkpointed.

The workers run on ``--device`` (default ``cuda``, checked here before
any worker starts: no CPU fallback) in ``--dtype`` (default the
config's), on random weights from seed 0 or the params-only checkpoint
``--ckpt`` (either package's ``save_checkpoint``). With ``--offloaded``
the oracle ``prefill_expert_scores`` runs here, on the same weights and
device, and rides in the trace.

Exit status: 0 iff no request is unaccounted (finished nor journaled).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile

import torch

from ..configs import get_config
from ..data.synthetic import ClusterLM, SyntheticConfig
from ..fleet import FleetConfig, FleetSupervisor, parse_worker_fault_schedule
from ..models.common import cdtype
from ..models.model import init_params
from ..models.runtime import resolve_device
from ..serving import TrafficConfig, prefill_expert_scores, synthesize_workload
from .serve import load_params


def build_workload(args, cfg):
    lm = ClusterLM(SyntheticConfig(vocab=cfg.vocab,
                                   seq_len=args.prompt_len * 2,
                                   seed=args.seed + 3))
    tcfg = TrafficConfig(
        n_requests=args.n_requests, arrival=args.arrival, rate=args.rate,
        prompt_len=(max(args.prompt_len // 2, 1), args.prompt_len),
        max_new_tokens=(max(args.max_new // 2, 1), args.max_new),
        temperature=0.0, seed=args.seed,
    )
    return synthesize_workload(lm, tcfg)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m-smoke")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--offloaded", action="store_true",
                    help="wave workers over the offloaded expert cache "
                         "(default: continuous slot batching)")
    ap.add_argument("--slots", type=int, default=2,
                    help="KV slots / wave size per worker")
    ap.add_argument("--capacity", type=int, default=0)
    ap.add_argument("--scheduler", default="fcfs",
                    choices=["fcfs", "sjf", "expert-affinity"])
    ap.add_argument("--engine-impl", default="slab",
                    choices=["slab", "dict"],
                    help="offloaded engine implementation (dict: the per-expert engine)")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "bursty", "all_at_once"])
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default=None, help="default: the config's dtype")
    ap.add_argument("--device", default="cuda",
                    help="the workers' device (cuda unless 'cpu' is asked for)")
    ap.add_argument("--ckpt", default=None,
                    help="params-only checkpoint for every worker instead of "
                         "random weights")
    ap.add_argument("--worker-faults", default=None, metavar="SCHED",
                    help="worker-targeted fault schedule, e.g. "
                         "'0:kill_at=4,seed=0;2:hang_at=3:60' "
                         "(first incarnation only; restarts run clean)")
    ap.add_argument("--checkpoint-every", type=int, default=4)
    ap.add_argument("--retain-segments", type=int, default=2)
    ap.add_argument("--audit-every", type=int, default=0)
    ap.add_argument("--hang-deadline", type=float, default=10.0,
                    help="heartbeat staleness (s) while alive => hung "
                         "=> SIGKILL + restart")
    ap.add_argument("--degraded-after", type=float, default=3.0)
    ap.add_argument("--startup-grace", type=float, default=300.0)
    ap.add_argument("--heartbeat-s", type=float, default=0.25)
    ap.add_argument("--poll", type=float, default=0.1)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--max-wall", type=float, default=None,
                    help="drain the fleet after this many wall seconds")
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_fleet"),
                    metavar="DIR", help="fleet root; one subdirectory per worker")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the aggregated fleet report JSON")
    ap.add_argument("--prom", default=None, metavar="PATH",
                    help="write the supervisor Prometheus snapshot")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)  # fail here, not in every worker

    cfg = get_config(args.arch)
    requests = build_workload(args, cfg)
    if args.offloaded:
        if not cfg.has_router:
            raise SystemExit("--offloaded applies to MoE architectures")
        dt = cdtype(args.dtype or cfg.dtype)
        if args.ckpt:
            params, _ = load_params(cfg, args.ckpt, dtype=dt, device=dev)
        else:
            params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                 dtype=dt, device=dev)
        prefill_expert_scores(cfg, params, requests)  # ride in the trace
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    fcfg = FleetConfig(
        n_workers=args.workers, arch=args.arch,
        mode="wave" if args.offloaded else "continuous",
        slots=args.slots, capacity=args.capacity,
        scheduler=args.scheduler, seed=args.seed, param_seed=0,
        overlap=args.overlap, engine_impl=args.engine_impl,
        checkpoint_every=args.checkpoint_every,
        retain_segments=args.retain_segments,
        audit_every=args.audit_every, heartbeat_s=args.heartbeat_s,
        poll_s=args.poll, hang_deadline_s=args.hang_deadline,
        degraded_after_s=args.degraded_after,
        startup_grace_s=args.startup_grace,
        max_restarts=args.max_restarts,
        worker_faults=parse_worker_fault_schedule(args.worker_faults),
        dtype=args.dtype, device=args.device,
        ckpt=os.path.abspath(args.ckpt) if args.ckpt else None,
    )
    sup = FleetSupervisor(requests, fcfg, args.dir)
    prev = signal.signal(signal.SIGTERM, lambda *_: sup.request_drain())
    try:
        report = sup.run(max_wall_s=args.max_wall)
    finally:
        signal.signal(signal.SIGTERM, prev)

    prom = sup.prometheus_text()
    if args.prom:
        os.makedirs(os.path.dirname(args.prom) or ".", exist_ok=True)
        with open(args.prom, "w", encoding="utf-8") as f:
            f.write(prom)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2)

    print(f"fleet: {report['n_workers']} workers, "
          f"{report['finished']}/{report['n_requests']} finished, "
          f"{len(report['pending_checkpointed'])} checkpointed-pending, "
          f"{len(report['unaccounted'])} unaccounted"
          + (" [drained]" if report["drained"] else ""))
    print(f"restarts: {report['restarts']}  "
          f"reassigned: {report['reassigned']:.0f}  "
          f"failover_s: {report['failover_s']['samples']}")
    for w in report["workers"]:
        print(f"  worker-{w['idx']}: restarts={w['restarts']} "
              f"exit={w['exit_code']} phase={w['phase']}"
              + (" FAILED" if w["failed"] else ""))
    if report["unaccounted"]:
        print(f"LOST REQUESTS: {report['unaccounted']}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
