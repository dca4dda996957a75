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

Offloaded, the device never holds the whole model: the experts are drawn
(or read from ``--ckpt``) one ``(E, i, o)`` matrix at a time straight
into the engine's pinned host store (``launch.serve.offloaded_params``),
the other weights go to the device, the oracle scores are computed
layer-major with one MoE layer's experts staged on the device at a time
(``prefill_expert_scores(host_store=...)``), and the wave server serves
from that store. A model whose experts do not fit the card (Mixtral-8x7B:
84 GiB in bf16 on an 80 GB card) is served this way at full width. The
launcher then prints a ``BUILD_LINE`` JSON report to standard error
(standard output ends with the summary): the build's and the
scoring's seconds, the host's MemAvailable before and after the build,
``host_store_bytes``, the launches of the scoring pass and of the served
prefills and decode steps, the served prefills' and decode steps' seconds
(device synchronized) and expert copies, and the peak device memory.

``--little`` (offloaded path) builds the engine's always-resident
low-rank little-expert bank (rank ``--little-rank``) on the device, and
``--quality q`` sets every request's quality dial: the fraction of cache
misses served by the big expert, the rest by its little distillate
(uncharged; the summary's ``degraded_requests`` counts the requests
that were served one).

The operations stack, as the reference's launcher:

* ``--faults SPEC`` installs a deterministic fault plan (the
  ``REPRO_FAULTS`` grammar, e.g. ``fail=0.1,spike=0.05:2e-3,seed=7``);
  an injected crash (``crash_at=K``) ends the run with the journal left
  recoverable;
* ``--trace DIR`` writes ``trace.json`` (Perfetto), ``trace.jsonl``,
  ``metrics.json`` / ``metrics.prom`` and, offloaded, the Eq.-3
  reconciliation ``reconcile.json`` (its table printed);
* ``--journal DIR`` (or ``REPRO_JOURNAL``) keeps a write-ahead request
  journal with a checkpoint every ``--checkpoint-every`` decode steps
  (continuous) or waves (offloaded); ``--resume`` recovers from it and
  finishes the interrupted run (offloaded: the slab revived warm, or cold
  with ``--cold-restore``); ``--audit-every N`` runs the invariant
  watchdog every N steps (and always after a restore).

``--engine-impl dict`` serves through the per-expert engine (the reference's
pre-rewrite baseline; tokens and accounting are the slab engine's).

A SIGTERM mid-serve drains the server gracefully: admission stops,
in-flight requests finish, a journaled run anchors a final checkpoint
(``--resume`` finishes the rest), ``DRAINED on SIGTERM`` is printed and
the launcher exits 0; one that lands before the serve or after its last
step, until the results are written, is a drain too (of everything, or of
nothing left in flight). ``--out-results PATH`` writes every finished
request's tokens and finish reason with the summary, as the reference's
launcher does (to diff a drained or crashed and resumed run against an
uninterrupted one).

    # crash mid-decode, then finish the run from the journal
    PYTHONPATH=src python -m repro_torch.launch.bench_serve --arch olmoe-mini-smoke \
        --device cpu --dtype float32 --n-requests 4 --slots 2 --prompt-len 8 \
        --max-new 6 --journal /tmp/jr --checkpoint-every 2 --faults crash_at=5
    PYTHONPATH=src python -m repro_torch.launch.bench_serve --arch olmoe-mini-smoke \
        --device cpu --dtype float32 --slots 2 --prompt-len 8 --max-new 6 \
        --journal /tmp/jr --resume --audit-every 1
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import torch

from ..configs import get_config
from ..data.synthetic import ClusterLM, SyntheticConfig
from ..faults import (InjectedCrash, get_fault_plan, install_fault_plan,
                      uninstall_fault_plan)
from ..kernels import dispatch
from ..models.common import cdtype
from ..models.model import init_params
from ..models.runtime import resolve_device
from ..obs import REGISTRY, disable_tracing, enable_tracing, get_tracer, reconcile
from ..recovery import RequestJournal, journal_dir_from_env, recover
from ..serving import (
    ContinuousBatchingServer,
    OffloadedWaveServer,
    RequestQueue,
    TrafficConfig,
    get_scheduler,
    prefill_expert_scores,
    synthesize_workload,
)
from .serve import _sync, host_available_bytes, load_params, offloaded_params

BUILD_LINE = "bench_serve offloaded: "


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
                    help="offloaded engine implementation (dict: the per-expert engine)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="install a deterministic fault plan, e.g. "
                         "'fail=0.1,spike=0.05:2e-3,storm=0.02:0.5,seed=7' "
                         "(same grammar as REPRO_FAULTS)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="enable structured tracing; write trace.json (Perfetto), "
                         "trace.jsonl, metrics.json/.prom and (offloaded) the Eq.-3 "
                         "reconciliation report into DIR")
    ap.add_argument("--journal", default=None, metavar="DIR",
                    help="write-ahead request journal + checkpoints into DIR "
                         "(default: $REPRO_JOURNAL); enables --resume")
    ap.add_argument("--checkpoint-every", type=int, default=8,
                    help="checkpoint + rotate the journal every N decode steps "
                         "(continuous) / waves (offloaded); needs --journal")
    ap.add_argument("--audit-every", type=int, default=0,
                    help="run the invariant-audit watchdog every N steps/waves "
                         "(0 = only after a restore)")
    ap.add_argument("--resume", action="store_true",
                    help="recover from the journal dir and continue the "
                         "interrupted run (token-identical under greedy)")
    ap.add_argument("--cold-restore", action="store_true",
                    help="with --resume on the offloaded path: skip the warm slab "
                         "revival (restore policy scores only)")
    ap.add_argument("--out-results", default=None, metavar="PATH",
                    help="write per-request tokens + summary JSON (use to diff a "
                         "drained or crashed and resumed run against an "
                         "uninterrupted one)")
    return ap


def main(argv=None):
    """Run the launcher; returns (results, ServerMetrics), or None after
    an injected crash. A fault plan or tracer this call installed is
    removed again before it returns."""
    ap = _parser()
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.offloaded and not cfg.has_router:
        ap.error("--offloaded applies to MoE architectures")
    if args.little and not args.offloaded:
        ap.error("--little applies to the offloaded path (--offloaded)")
    if args.cold_restore and not (args.resume and args.offloaded):
        ap.error("--cold-restore applies to --resume on the offloaded path")
    jdir = args.journal or journal_dir_from_env()
    if args.resume and not jdir:
        ap.error("--resume needs --journal DIR (or $REPRO_JOURNAL)")
    if args.trace:
        enable_tracing()
    if args.faults:
        install_fault_plan(args.faults)
    # graceful drain on SIGTERM: stop admission, finish in-flight, and
    # (journaled) anchor a final checkpoint instead of dying mid-step —
    # what a fleet supervisor or a preemption sends before SIGKILL. The
    # handler goes in before the journal's first line is written and stays
    # until the results are reported: a SIGTERM after the last step, while
    # they are written, is taken as a drain with nothing left in flight
    # (the default action would end the process and lose them).
    drain = {"flag": False}
    prev_term = signal.signal(signal.SIGTERM, lambda *_: drain.__setitem__("flag", True))
    try:
        return _serve(args, cfg, jdir, drain)
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        if args.trace:
            disable_tracing()
        if args.faults:
            uninstall_fault_plan()


def _serve(args, cfg, jdir, drain):
    # -- crash recovery: an optional restore from the journal ------------
    state = None
    if args.resume:
        state = recover(jdir)
        if state is None:
            raise SystemExit(f"nothing to recover in {jdir}")
        want = "wave" if args.offloaded else "continuous"
        if state.kind != want:
            raise SystemExit(f"journal was written by a {state.kind!r} server; rerun "
                             f"with the matching path (expected {want!r})")
        print(f"resuming from {jdir}: step={state.step} now={state.now:.3f}s "
              f"pending={len(state.pending)} finished={len(state.results)}")

    dev = resolve_device(args.device)
    dt = cdtype(args.dtype or cfg.dtype)
    build = {}
    if args.offloaded:  # the experts into the pinned store, the rest on the device
        build["host_available_before_build"], t0 = host_available_bytes(), time.perf_counter()
        params, store, meta = offloaded_params(cfg, dtype=dt, device=dev, ckpt=args.ckpt)
        build.update(build_s=time.perf_counter() - t0,
                     host_available_after_build=host_available_bytes())
    elif args.ckpt:
        params, meta = load_params(cfg, args.ckpt, dtype=dt, device=dev)
    else:
        params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                             dtype=dt, device=dev)
    if args.ckpt:
        print(f"loaded {args.ckpt} ({meta})")
    else:
        print("using randomly initialized weights (demo mode)")

    if state is not None:
        requests = state.pending  # expert scores ride in the records
        queue = state.build_queue(args.max_backlog)
    else:
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
        # the burst fault compresses arrival gaps in place (overload)
        get_fault_plan().compress_arrivals(requests)
        queue = RequestQueue(requests, max_pending=args.max_backlog)
    seed = state.seed if state else args.seed
    if args.offloaded:
        if args.temperature > 0:
            print("note: the offloaded engine decodes greedily; "
                  "--temperature is ignored on this path")
        capacity = args.capacity or cfg.melinoe_cache_capacity()
        if state is None:  # oracle profiles, one MoE layer on the device at a time
            before, t0 = dispatch.route_snapshot(), time.perf_counter()
            prefill_expert_scores(cfg, params, requests, host_store=store)
            _sync(dev)
            build.update(score_s=time.perf_counter() - t0,
                         score_launches=dispatch.route_delta(before, dispatch.route_snapshot()))
            if dev.type == "cuda":
                torch.cuda.empty_cache()  # the staged layer's memory, before the slabs
        kw = {"top_c": capacity} if args.scheduler == "expert-affinity" else {}
        srv = OffloadedWaveServer(
            cfg, params, capacity=capacity, scheduler=get_scheduler(args.scheduler, **kw),
            wave_size=args.slots, overlap=args.overlap, engine_impl=args.engine_impl,
            little_experts=args.little, little_rank=args.little_rank,
            seed=seed, device=dev, host_store=store)
        build["host_store_bytes"] = srv.engine.host_store_bytes
        del params, store  # the engine keeps the store
        if state is not None and state.engine is not None:
            srv.engine.metrics.load_state(state.engine["metrics"])
            rev = srv.engine.revive(state.engine["cache"], warm=not args.cold_restore)
            print(f"{'cold' if args.cold_restore else 'warm'} revival: "
                  f"{rev['loaded']} experts, {rev['bytes']} bytes")
    else:
        srv = ContinuousBatchingServer(
            cfg, params, n_slots=args.slots, max_len=args.prompt_len + args.max_new + 1,
            scheduler=get_scheduler(args.scheduler), seed=seed)

    jr = None
    try:
        jr = RequestJournal(jdir, seen=state.seen_rids if state else None) if jdir else None
        results, mt = srv.run(
            queue, state.metrics if state else None, journal=jr,
            checkpoint_every=args.checkpoint_every if jr else None,
            audit_every=args.audit_every or None, resume=state,
            should_drain=lambda: drain["flag"])
    except InjectedCrash as e:
        # a deliberate fault-injection exit: the journal holds everything
        # --resume needs
        print(f"CRASHED (injected): {e}")
        print(f"journal is recoverable at {jdir}" if jdir else
              "no journal configured; run is lost")
        return None
    finally:
        if jr is not None:
            jr.close()
    for r in results[: min(4, len(results))]:
        print(f"  rid={r.rid} {len(r.tokens)} toks ({r.finish_reason}) "
              f"latency={r.latency:.4f}s tokens={r.tokens[:8].tolist()}...")
    print(json.dumps(mt.summary(), indent=2))
    if args.out_results:
        payload = {
            "results": [{"rid": r.rid, "tokens": [int(t) for t in r.tokens],
                         "finish_reason": r.finish_reason} for r in results],
            "summary": mt.summary(),
        }
        with open(args.out_results, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"results: {args.out_results}")
    if args.offloaded:
        build.update(served_launches=srv.route_launches, expert_copies=srv.expert_copies,
                     prefill_s=sum(srv.span_s["serve.prefill"]),
                     decode_s=sum(srv.span_s["serve.decode"]),
                     decode_steps=sum(srv.span_s["decode_steps"]),
                     max_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                                           if dev.type == "cuda" else None))
        print(BUILD_LINE + json.dumps(build), file=sys.stderr, flush=True)
    if args.trace:
        _export_trace(args.trace, srv, mt, offloaded=args.offloaded)
    if srv.drained or drain["flag"]:
        print(f"DRAINED on SIGTERM: {len(results)} finished, {len(queue)} pending left "
              + (f"checkpointed in {jdir}" if jdir else "(no journal — lost)"), flush=True)
    return results, mt


def _export_trace(outdir: str, srv, mt, *, offloaded: bool) -> None:
    """Dump the run's spans and metrics and (offloaded) the per-layer
    reconciliation of the Eq.-3 modeled clock against the measured spans."""
    os.makedirs(outdir, exist_ok=True)
    tracer = get_tracer()
    trace_path = os.path.join(outdir, "trace.json")
    tracer.export_chrome_trace(trace_path, process_name="bench_serve")
    tracer.export_jsonl(os.path.join(outdir, "trace.jsonl"))

    mt.publish()
    get_fault_plan().publish()
    dispatch.publish()
    if offloaded:
        srv.engine.metrics.publish()
        srv.engine.cache.publish()
    with open(os.path.join(outdir, "metrics.json"), "w") as f:
        f.write(REGISTRY.to_json(indent=2))
    with open(os.path.join(outdir, "metrics.prom"), "w") as f:
        f.write(REGISTRY.to_prometheus_text())
    print(f"trace: {trace_path} ({len(tracer.spans())} spans)")
    if offloaded:
        report = reconcile(tracer.spans(), srv.engine.metrics, srv.engine.hw)
        with open(os.path.join(outdir, "reconcile.json"), "w") as f:
            json.dump(report.to_json(), f, indent=2)
        print(report.format_table())


if __name__ == "__main__":
    main()
