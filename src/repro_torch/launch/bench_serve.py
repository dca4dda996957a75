"""Serving launcher, PyTorch (counterpart of ``repro.launch.bench_serve``):

    # fits-in-memory path: continuous batching, the whole model resident
    PYTHONPATH=src python -m repro_torch.launch.bench_serve --arch olmoe \
        --slots 4 --n-requests 8 --prompt-len 128 --max-new 32 \
        --arrival all_at_once [--scheduler fcfs|sjf|expert-affinity]

    # offloaded path: expert-affinity waves with scheduler-driven prefetch
    # over the offloaded expert cache (Sec 3.2)
    PYTHONPATH=src python -m repro_torch.launch.bench_serve --arch olmoe \
        --offloaded --capacity 16 --scheduler expert-affinity --slots 4 \
        [--overlap] [--little [--little-rank 8] --quality 0.5]

Synthesizes a Poisson/bursty/all-at-once workload over the ClusterLM
prompt distribution (prompt lengths in [prompt-len/2, prompt-len],
budgets in [max-new/2, max-new]), serves it through
``ContinuousBatchingServer`` or, with ``--offloaded``,
``OffloadedWaveServer`` (waves of ``--slots`` requests; the affinity
scores are the oracle ``prefill_expert_scores``; C = ``--capacity``,
0 => E/4, also the affinity scheduler's top-C), and prints the
``ServerMetrics`` summary as JSON (offloaded: transfers, prefetch
transfers, hit rate and both Eq.-3 clocks too). Weights are random from
seed 0 in ``--dtype`` (default the config's), or ``--ckpt PATH`` (a
params-only checkpoint). Runs on ``cuda`` unless ``--device cpu``.

``--little`` (offloaded path) builds the engine's always-resident
low-rank little-expert bank (rank ``--little-rank``) on the device, and
``--quality q`` sets every request's quality dial: the fraction of cache
misses served by the big expert, the rest by its little distillate
(uncharged; the summary's ``degraded_requests`` counts the requests
that were served one).

The operations stack is not ported yet: its flags (``--faults``,
``--trace``, ``--journal``, ``--resume``, ``--checkpoint-every``,
``--audit-every``, ``--cold-restore``) exit with an error naming what is
missing, and ``--engine-impl dict`` raises in the engine.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..configs import get_config
from ..data.synthetic import ClusterLM, SyntheticConfig
from ..models.common import cdtype
from ..models.model import init_params
from ..models.runtime import resolve_device
from ..serving import (
    ContinuousBatchingServer,
    OffloadedWaveServer,
    RequestQueue,
    TrafficConfig,
    get_scheduler,
    prefill_expert_scores,
    synthesize_workload,
)
from .serve import load_params

# flag -> what it needs; a flag given on the command line exits with an error
UNPORTED = {
    "--faults": "faults/",
    "--trace": "obs/",
    "--journal": "recovery/",
    "--resume": "recovery/",
    "--checkpoint-every": "recovery/",
    "--audit-every": "recovery/",
    "--cold-restore": "recovery/",
}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-mini")
    ap.add_argument("--scheduler", default="fcfs",
                    choices=["fcfs", "sjf", "expert-affinity"])
    ap.add_argument("--slots", type=int, default=4, help="concurrent KV slots")
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "bursty", "all_at_once"])
    ap.add_argument("--rate", type=float, default=4.0, help="requests / second")
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slo", type=float, default=None,
                    help="per-request SLO in virtual seconds after arrival "
                         "(default: best effort, never shed)")
    ap.add_argument("--max-backlog", type=int, default=None,
                    help="bound the pending queue; the latest arrivals "
                         "beyond it are shed (admission control)")
    ap.add_argument("--dtype", default=None, help="default: the config's dtype")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=None,
                    help="params-only checkpoint instead of random weights")
    ap.add_argument("--offloaded", action="store_true",
                    help="serve through the offloaded expert cache (Sec 3.2)")
    ap.add_argument("--overlap", action="store_true",
                    help="advance the offloaded clock by the overlapped Eq.-3 "
                         "model; both clocks are reported either way")
    ap.add_argument("--capacity", type=int, default=0, help="0 => E/4 (offloaded)")
    ap.add_argument("--quality", type=float, default=1.0,
                    help="little-expert quality dial: fraction of cache "
                         "misses served by the big expert (needs --little)")
    ap.add_argument("--little", action="store_true",
                    help="build the always-resident low-rank little-expert "
                         "bank (degraded mode under the quality dial and "
                         "deadline pressure; offloaded path only)")
    ap.add_argument("--little-rank", type=int, default=8)
    ap.add_argument("--engine-impl", default="slab", choices=["slab", "dict"],
                    help="offloaded engine implementation (dict: not ported, raises)")
    for flag, needs in UNPORTED.items():
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=f"not ported yet (needs {needs})")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    given = [f for f in UNPORTED if getattr(args, f[2:].replace("-", "_")) is not None]
    if given:
        ap.error("not ported yet: " + ", ".join(f"{f} (needs {UNPORTED[f]})"
                                                for f in given))

    cfg = get_config(args.arch)
    if args.offloaded and not cfg.has_router:
        ap.error("--offloaded applies to MoE architectures")
    if args.little and not args.offloaded:
        ap.error("--little applies to the offloaded path (--offloaded)")
    dev = resolve_device(args.device)
    dt = cdtype(args.dtype or cfg.dtype)
    if args.ckpt:
        params, meta = load_params(cfg, args.ckpt, dtype=dt, device=dev)
        print(f"loaded {args.ckpt} ({meta})")
    else:
        params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                             dtype=dt, device=dev)
        print("using randomly initialized weights (demo mode)")

    lm = ClusterLM(SyntheticConfig(vocab=cfg.vocab, seq_len=args.prompt_len * 2,
                                   seed=args.seed + 3))
    tcfg = TrafficConfig(
        n_requests=args.n_requests, arrival=args.arrival, rate=args.rate,
        prompt_len=(max(args.prompt_len // 2, 1), args.prompt_len),
        max_new_tokens=(max(args.max_new // 2, 1), args.max_new),
        temperature=args.temperature, seed=args.seed, slo=args.slo,
        quality=args.quality,
    )
    requests = synthesize_workload(lm, tcfg)
    queue = RequestQueue(requests, max_pending=args.max_backlog)
    if args.offloaded:
        if args.temperature > 0:
            print("note: the offloaded engine decodes greedily; "
                  "--temperature is ignored on this path")
        capacity = args.capacity or cfg.melinoe_cache_capacity()
        prefill_expert_scores(cfg, params, requests)  # oracle profiles
        kw = {"top_c": capacity} if args.scheduler == "expert-affinity" else {}
        srv = OffloadedWaveServer(
            cfg, params, capacity=capacity, scheduler=get_scheduler(args.scheduler, **kw),
            wave_size=args.slots, overlap=args.overlap, engine_impl=args.engine_impl,
            little_experts=args.little, little_rank=args.little_rank,
            seed=args.seed, device=dev)
        del params  # the engine keeps its experts in pinned host memory
    else:
        srv = ContinuousBatchingServer(
            cfg, params, n_slots=args.slots, max_len=args.prompt_len + args.max_new + 1,
            scheduler=get_scheduler(args.scheduler), seed=args.seed)
    results, mt = srv.run(queue)
    for r in results[: min(4, len(results))]:
        print(f"  rid={r.rid} {len(r.tokens)} toks ({r.finish_reason}) "
              f"latency={r.latency:.4f}s tokens={r.tokens[:8].tolist()}...")
    print(json.dumps(mt.summary(), indent=2))
    return results, mt


if __name__ == "__main__":
    main()
