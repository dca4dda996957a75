"""Fleet worker: one journaled server under a heartbeat (counterpart of
``repro/fleet/worker.py``).

    python -m repro_torch.fleet.worker WORKER_DIR/spec.json [--clean]

The supervisor writes ``spec.json`` (serving config) and ``trace.json``
(this worker's request partition, as journal-compatible records) into
the worker directory and launches this module. Every incarnation runs
the same sequence — there is no separate "--resume" mode, recovery is
implicit:

* install the SIGTERM drain handler, then beat ``init`` (in this order:
  a SIGTERM that arrives once the supervisor can see the worker drains
  it instead of killing it),
* recover the journal under ``WORKER_DIR/journal`` (a fresh directory
  recovers to nothing),
* merge the trace with the recovered state — the journal's seen-rid
  set dedupes arrivals, so restarts and supervisor re-offers are safe,
* journal every pending arrival *before* the slow model build, so a
  kill during the build still leaves the work assignment durable,
* build the server: weights from the port's ``init_params`` with
  ``torch.Generator(device).manual_seed(param_seed)``, or the spec's
  ``ckpt`` (a params-only checkpoint of either package), in the spec's
  ``dtype`` (default the config's) on its ``device`` (default ``cuda``;
  no CPU fallback),
* serve through the standard journaled server run loop, emitting one
  atomic heartbeat per decode step / wave via the ``on_step`` hook,
* poll ``WORKER_DIR/inbox/`` for requests the supervisor re-offers
  from failed peers (journaled as arrivals before the inbox file is
  consumed, so a crash between the two only re-offers, never loses),
* drain gracefully on SIGTERM: stop admission, finish in-flight,
  final anchored checkpoint, ``results.json``, exit 0.

Worker-level faults (``kill=`` / ``hang=`` kinds from the spec; the
supervisor strips them on restart via ``--clean``) fire from the step
hook: a kill is ``os._exit`` mid-serve — no unwinding, the journal is
current through the last completed step — and a hang sleeps silently
so only the supervisor's heartbeat-staleness deadline can notice.

When it finishes, the worker prints one line to its log (stdout),
``LAUNCH_LINE`` followed by JSON: its kernel launches by op and by route
since the process started (``dispatch.LAUNCHES``, ``ROUTE_LAUNCHES``),
the device and, on a card, the peak device memory
(:func:`worker_launches` reads them back).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from pathlib import Path
from typing import Dict, List, Set

import torch

from ..configs import get_config
from ..faults import get_fault_plan, install_fault_plan, uninstall_fault_plan
from ..kernels import dispatch
from ..launch.serve import load_params
from ..models.common import cdtype
from ..models.model import init_params
from ..models.runtime import resolve_device
from ..recovery import RequestJournal, recover
from ..recovery.checkpoint import record_request
from ..serving import (
    ContinuousBatchingServer,
    OffloadedWaveServer,
    RequestQueue,
    get_scheduler,
)
from ..serving.metrics import ServerMetrics
from .heartbeat import HEARTBEAT_NAME, HeartbeatWriter

# hard-exit status for an injected kill; anything nonzero reads as a
# crash to the supervisor, this value just makes logs unambiguous
KILL_EXIT_CODE = 13

# prefix of the worker's closing log line (launches by op and route)
LAUNCH_LINE = "fleet-worker launches "


def write_results(path, results: Dict[int, object], mt, *,
                  drained: bool) -> None:
    """Atomic per-worker results artifact (convenience only — the
    journal is the authority; the supervisor aggregates via recover())."""
    payload = {
        "pid": os.getpid(),
        "drained": bool(drained),
        "results": [{"rid": r.rid, "tokens": [int(t) for t in r.tokens],
                     "finish_reason": r.finish_reason}
                    for r in sorted(results.values(), key=lambda r: r.rid)],
        "summary": mt.summary() if mt is not None else {},
    }
    tmp = str(path) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, path)


def poll_inbox(wdir: Path, enqueued: Set[int], queue: RequestQueue,
               jr: RequestJournal) -> int:
    """Consume supervisor re-offers: each inbox file is a JSON list of
    request records. The arrival is journaled (flushed) before the file
    is unlinked — a kill between the two replays as a duplicate offer,
    which the seen-rid dedupe absorbs."""
    inbox = wdir / "inbox"
    if not inbox.is_dir():
        return 0
    n = 0
    for p in sorted(inbox.glob("*.json")):
        try:
            recs = json.loads(p.read_text(encoding="utf-8"))
        except (OSError, json.JSONDecodeError):
            continue  # supervisor writes atomically; transient at worst
        for rec in recs:
            req = record_request(rec)
            if req.rid in enqueued:
                continue
            jr.arrival(req)
            queue.push(req)
            enqueued.add(req.rid)
            n += 1
        p.unlink(missing_ok=True)
    return n


def launch_report(dev: torch.device) -> Dict:
    """The closing log line's payload: launches since the process
    started, by op and by route, and the device's peak memory."""
    rep = {"launches": dict(dispatch.LAUNCHES),
           "route_launches": dispatch.route_snapshot(), "device": str(dev)}
    if dev.type == "cuda":
        rep["device_name"] = torch.cuda.get_device_name(dev)
        rep["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    return rep


def worker_launches(log_path) -> List[Dict]:
    """Every closing launch line in a worker log, one per incarnation
    that finished (a killed incarnation writes none)."""
    out = []
    for line in Path(log_path).read_text(encoding="utf-8",
                                         errors="replace").splitlines():
        if line.startswith(LAUNCH_LINE):
            out.append(json.loads(line[len(LAUNCH_LINE):]))
    return out


def _build_server(spec: Dict, pending: List, trace: List, state):
    """The spec's server on the spec's weights, dtype and device."""
    cfg = get_config(spec["arch"])
    dev = resolve_device(spec.get("device") or "cuda")
    dt = cdtype(spec.get("dtype") or cfg.dtype)
    if spec.get("ckpt"):
        params, _ = load_params(cfg, spec["ckpt"], dtype=dt, device=dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(int(spec.get("param_seed", 0)))
        params = init_params(cfg, generator=gen, dtype=dt, device=dev)
    scheduler = get_scheduler(spec.get("scheduler", "fcfs"))
    if spec.get("mode", "continuous") == "wave":
        srv = OffloadedWaveServer(
            cfg, params,
            capacity=int(spec.get("capacity") or cfg.melinoe_cache_capacity()),
            scheduler=scheduler, wave_size=int(spec.get("slots", 2)),
            overlap=bool(spec.get("overlap", False)),
            engine_impl=spec.get("engine_impl", "slab"),
            seed=int(spec.get("seed", 0)), device=dev)
        if state is not None and state.engine is not None:
            srv.engine.metrics.load_state(state.engine["metrics"])
            srv.engine.revive(state.engine["cache"], warm=True)
    else:
        max_len = int(spec.get("max_len") or (max(
            (r.prompt_len + r.max_new_tokens for r in (pending or trace)),
            default=32) + 1))
        srv = ContinuousBatchingServer(
            cfg, params, n_slots=int(spec.get("slots", 2)), max_len=max_len,
            scheduler=scheduler, seed=int(spec.get("seed", 0)))
    return srv, dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("spec", help="path to the worker's spec.json")
    ap.add_argument("--clean", action="store_true",
                    help="ignore the spec's fault plan (supervisor "
                         "restarts run clean so a deterministic fault "
                         "doesn't re-fire forever)")
    args = ap.parse_args(argv)

    spec = json.loads(Path(args.spec).read_text(encoding="utf-8"))
    wdir = Path(spec.get("dir") or Path(args.spec).parent)
    # the drain handler goes in before the first beat: once the
    # supervisor sees this worker, a SIGTERM drains it
    drain = {"flag": False}
    prev_term = signal.signal(signal.SIGTERM,
                              lambda *_: drain.__setitem__("flag", True))
    try:
        return _serve(args, spec, wdir, drain)
    finally:
        signal.signal(signal.SIGTERM, prev_term)


def _serve(args, spec: Dict, wdir: Path, drain: Dict) -> int:
    hb = HeartbeatWriter(wdir / HEARTBEAT_NAME)
    hb.beat(phase="init")
    hb_s = float(spec.get("heartbeat_s", 0.25))

    # fault plan: only what the spec says — a leaked REPRO_FAULTS env
    # var (already auto-installed at import) must not fault a worker
    if args.clean or not spec.get("faults"):
        uninstall_fault_plan()
    else:
        install_fault_plan(spec["faults"])
    plan = get_fault_plan()

    # -- recover + merge the trace (before any slow model work) --------
    trace = [record_request(rec) for rec in json.loads(
        (wdir / "trace.json").read_text(encoding="utf-8"))]
    jdir = wdir / "journal"
    state = recover(jdir)
    seen: Set[int] = set(state.seen_rids) if state else set()
    pending = list(state.pending) if state else []
    pending += [r for r in trace if r.rid not in seen]
    pending.sort(key=lambda r: (r.arrival_time, r.rid))
    enqueued: Set[int] = seen | {r.rid for r in pending}
    results = {r.rid: r for r in (state.results if state else [])}
    mt = state.metrics if state else ServerMetrics(
        policy=spec.get("scheduler", "fcfs"))

    jr = RequestJournal(jdir, seen=set(seen),
                        retain_segments=spec.get("retain_segments", 2))
    for r in pending:
        jr.arrival(r)  # durable before the build window

    # -- build the server (the slow part: weights + kernel warm-up) ----
    srv, dev = _build_server(spec, pending, trace, state)
    hb.beat(phase="ready")

    queue = RequestQueue(pending)
    steps = {"total": int(state.step) if state else 0}
    last = {"now": 0.0, "backlog": len(pending), "in_flight": 0}

    def step_hook(info: Dict) -> None:
        # worker-level faults first: the kill must look like SIGKILL
        # (journal flushed through this step, nothing else written)
        if plan.enabled:
            if plan.maybe_kill("fleet.worker.step"):
                os._exit(KILL_EXIT_CODE)
            hang_s = plan.maybe_hang()
            if hang_s > 0.0:
                time.sleep(hang_s)  # wedged: no beat, no progress
        poll_inbox(wdir, enqueued, queue, jr)
        steps["total"] += 1
        last.update(now=info["now"], backlog=info["backlog"],
                    in_flight=info["in_flight"])
        hb.beat(phase="serving", step=steps["total"], now=info["now"],
                backlog=info["backlog"], in_flight=info["in_flight"],
                finished=info["finished"], generated=info["generated"],
                metrics=mt.summary(), min_interval_s=hb_s)

    drained = False
    first_pass = True
    try:
        while True:
            poll_inbox(wdir, enqueued, queue, jr)
            if not len(queue):
                if drain["flag"]:
                    break
                hb.beat(phase="idle", step=steps["total"],
                        now=last["now"], backlog=0, in_flight=0,
                        finished=mt.requests_finished,
                        generated=mt.generated_tokens,
                        min_interval_s=hb_s)
                time.sleep(float(spec.get("poll_s", 0.05)))
                continue
            res, mt = srv.run(
                queue, mt, journal=jr,
                checkpoint_every=int(spec.get("checkpoint_every", 4)),
                audit_every=(int(spec.get("audit_every", 0)) or None
                             if first_pass else None),
                resume=state if first_pass else None,
                on_step=step_hook,
                should_drain=lambda: drain["flag"])
            first_pass = False
            state = None
            for r in res:
                results[r.rid] = r
            write_results(wdir / "results.json", results, mt,
                          drained=srv.drained)
            if srv.drained:
                drained = True
                break
    finally:
        jr.close()

    write_results(wdir / "results.json", results, mt, drained=drained)
    print(LAUNCH_LINE + json.dumps(launch_report(dev)), flush=True)
    hb.beat(phase="drained" if drained else "done", step=steps["total"],
            now=last["now"], backlog=0, in_flight=0,
            finished=mt.requests_finished, generated=mt.generated_tokens,
            metrics=mt.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
