"""Continuous-batching serving launcher, PyTorch (counterpart of
``repro.launch.bench_serve``, the fits-in-memory path):

    PYTHONPATH=src python -m repro_torch.launch.bench_serve --arch olmoe \
        --slots 4 --n-requests 8 --prompt-len 128 --max-new 32 \
        --arrival all_at_once [--scheduler fcfs|sjf|expert-affinity]

Synthesizes a Poisson/bursty/all-at-once workload over the ClusterLM
prompt distribution (prompt lengths in [prompt-len/2, prompt-len],
budgets in [max-new/2, max-new]), serves it through
``ContinuousBatchingServer`` with the whole model resident on the device
(random weights from seed 0, ``--dtype``, default the config's), and
prints the ``ServerMetrics`` summary as JSON. Runs on ``cuda`` unless
``--device cpu``.

The offloaded path and the operations stack are not ported yet: their
flags (``--offloaded``, ``--faults``, ``--trace``, ``--journal``,
``--resume``, ``--little``, ``--ckpt``) exit with an error naming what
is missing.
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
    RequestQueue,
    TrafficConfig,
    get_scheduler,
    synthesize_workload,
)

# flag -> what it needs; a flag given on the command line exits with an error
UNPORTED = {
    "--offloaded": "the OffloadedWaveServer",
    "--little": "core/little_expert.py",
    "--faults": "faults/",
    "--trace": "obs/",
    "--journal": "recovery/",
    "--resume": "recovery/",
    "--ckpt": "a checkpoint loader (training/checkpoint.py)",
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
    dev = resolve_device(args.device)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=cdtype(args.dtype or cfg.dtype), device=dev)
    print("using randomly initialized weights (demo mode)")

    lm = ClusterLM(SyntheticConfig(vocab=cfg.vocab, seq_len=args.prompt_len * 2,
                                   seed=args.seed + 3))
    tcfg = TrafficConfig(
        n_requests=args.n_requests, arrival=args.arrival, rate=args.rate,
        prompt_len=(max(args.prompt_len // 2, 1), args.prompt_len),
        max_new_tokens=(max(args.max_new // 2, 1), args.max_new),
        temperature=args.temperature, seed=args.seed, slo=args.slo,
    )
    queue = RequestQueue(synthesize_workload(lm, tcfg), max_pending=args.max_backlog)
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
