"""Fleet supervisor: launch N journaled workers and keep them alive
(counterpart of ``repro/fleet/supervisor.py``).

The loop ROADMAP item 5 asks for — launch -> health-check -> collect ->
restart-from-journal — over local worker processes:

* **partition**: the request trace is split round-robin in arrival
  order; each worker gets ``worker-i/spec.json`` + ``trace.json`` and
  its own journal directory.
* **classify**: every poll the supervisor reads each worker's atomic
  heartbeat and classifies it healthy / degraded (beat older than the
  soft deadline) / hung (beat older than the hang deadline while the
  process still runs — SIGKILL it and treat as a crash) / dead
  (nonzero exit). Heartbeats carry the writer's pid, so a stale file
  from the previous incarnation never condemns a restarting process;
  phases ``init``/``ready`` get the startup grace instead (model build
  + jit warmup are legitimately silent).
* **restart**: a crashed or hung worker relaunches from its journal
  (recovery is implicit in the worker, and the continuation is
  token-identical), under capped exponential backoff with the seeded
  per-worker jitter from ``FetchPolicy`` so a correlated failure does
  not restart the fleet in lockstep. Injected fault specs are stripped
  on restart (``--clean``) so a deterministic ``kill_at`` cannot
  re-fire forever.
* **circuit breaker**: past ``max_restarts`` the worker is marked
  failed and its unfinished journaled requests (recovered pending —
  with watermarks — plus never-journaled trace rids) are re-offered
  round-robin to the survivors' inboxes; the journal's seen-rid set
  makes duplicate offers harmless.
* **drain**: SIGTERM (to the supervisor or via :meth:`request_drain`)
  forwards SIGTERM to every live worker; each stops admission,
  finishes in-flight, anchors a final checkpoint and exits 0.

Telemetry lands on a ``repro_torch.obs`` registry: per-worker heartbeat-age
and up gauges, ``worker_restarts_total{reason}``,
``requests_reassigned_total``, and a failover-time histogram (fault
detected -> first heartbeat of the replacement incarnation). Each
incarnation's start-up (launch -> first heartbeat past ``init``) is a
``ready`` event with its seconds.

Workers run ``repro_torch.fleet.worker`` on the config's ``device``
(default ``cuda``) in its ``dtype`` (default the config's), on random
weights from ``param_seed`` or the params-only checkpoint ``ckpt``; the
child inherits the environment (``REPRO_TORCH_KERNEL_BACKEND`` too) but
not ``REPRO_JOURNAL`` or ``REPRO_FAULTS``.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from ..faults import FetchPolicy, parse_fault_spec
from ..obs.registry import MetricsRegistry
from ..recovery import recover
from ..recovery.checkpoint import request_record
from .heartbeat import HEARTBEAT_NAME, read_heartbeat

# failover includes a fresh process's torch import, weight build and
# kernel warm-up, so the default obs buckets (<=10s) would clip every
# sample
FAILOVER_BUCKETS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 40.0, 80.0, 160.0)

# capped exponential restart backoff, in wall seconds; jitter_frac
# decorrelates workers that died together (salt = worker index)
RESTART_BACKOFF = FetchPolicy(
    max_retries=-1, backoff_base_s=0.25, backoff_mult=2.0,
    backoff_cap_s=4.0, jitter_frac=0.5, seed=0)


def parse_worker_fault_schedule(spec: Optional[str]) -> Dict[int, str]:
    """``"0:kill_at=6;2:hang_at=4:30,seed=1"`` -> {0: "...", 2: "..."}.
    Each entry is ``<worker_idx>:<REPRO_FAULTS grammar>``; specs are
    validated eagerly so a typo fails the launch, not the chaos run."""
    out: Dict[int, str] = {}
    if not spec:
        return out
    for item in spec.split(";"):
        item = item.strip()
        if not item:
            continue
        idx_s, _, plan = item.partition(":")
        idx = int(idx_s)
        parse_fault_spec(plan)  # raises on unknown keys
        out[idx] = plan
    return out


@dataclass
class FleetConfig:
    n_workers: int = 2
    arch: str = "olmoe-mini"
    mode: str = "continuous"  # "continuous" | "wave"
    slots: int = 2
    capacity: int = 0
    scheduler: str = "fcfs"
    seed: int = 0
    param_seed: int = 0
    overlap: bool = False
    engine_impl: str = "slab"
    checkpoint_every: int = 4
    retain_segments: int = 2
    audit_every: int = 0
    heartbeat_s: float = 0.25  # worker beat throttle
    worker_poll_s: float = 0.05  # worker idle/inbox poll
    poll_s: float = 0.1  # supervisor liveness poll
    degraded_after_s: float = 3.0  # stale-ish: flagged, not yet killed
    hang_deadline_s: float = 10.0  # stale while alive => SIGKILL
    startup_grace_s: float = 300.0  # init/ready phases (imports + build)
    max_restarts: int = 3  # circuit breaker: beyond => failed
    drain_timeout_s: float = 60.0
    # worker-targeted fault schedule {idx: REPRO_FAULTS spec}, first
    # incarnation only — restarts always run --clean
    worker_faults: Dict[int, str] = field(default_factory=dict)
    dtype: Optional[str] = None  # None: the config's
    device: str = "cuda"  # no CPU fallback: "cpu" only when asked
    ckpt: Optional[str] = None  # params-only checkpoint (either package)


@dataclass
class WorkerHandle:
    idx: int
    dir: Path
    assigned: List = field(default_factory=list)  # ServeRequest
    proc: Optional[subprocess.Popen] = None
    log_fh: Optional[object] = None
    state: str = "starting"
    phase: str = ""
    restarts: int = 0
    failed: bool = False
    completed: bool = False
    exit_code: Optional[int] = None
    launched_at: float = 0.0
    restart_at: Optional[float] = None  # backoff: relaunch not before
    down_at: Optional[float] = None  # failover clock start
    ready: bool = False  # the live incarnation is past ``init``
    hb: Optional[Dict] = None  # last heartbeat of the live incarnation

    @property
    def live(self) -> bool:
        return not (self.failed or self.completed)


class FleetSupervisor:
    """Drive a fleet of ``repro_torch.fleet.worker`` processes to completion."""

    def __init__(self, requests, cfg: FleetConfig, root,
                 registry: Optional[MetricsRegistry] = None):
        assert cfg.n_workers >= 1
        self.cfg = cfg
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.requests = sorted(requests,
                               key=lambda r: (r.arrival_time, r.rid))
        self.total_rids = {r.rid for r in self.requests}
        self.registry = registry if registry is not None else MetricsRegistry()
        self.workers: List[WorkerHandle] = []
        self.events: List[Dict] = []
        self.timeline: List[Dict] = []
        self.failover_samples: List[float] = []
        self._drain_requested = False
        self._reassign_seq = 0
        self._t0: Optional[float] = None
        # materialize the counters chaos dashboards alert on, so a
        # clean run still exports them at 0
        for reason in ("crash", "hang"):
            self.registry.counter(
                "worker_restarts_total",
                "fleet worker restarts by failure reason", reason=reason)
        self.registry.counter("requests_reassigned_total",
                              "requests re-offered after a circuit break")
        self.registry.histogram(
            "fleet_failover_s",
            "fault detected -> first heartbeat of the replacement",
            buckets=FAILOVER_BUCKETS)

    # -- setup -----------------------------------------------------------
    def _max_len(self) -> int:
        # one bound for the whole fleet: any request may be re-offered
        # to any worker, so every slot pool must fit the largest
        return max((r.prompt_len + r.max_new_tokens
                    for r in self.requests), default=32) + 1

    def _event(self, worker: int, event: str, **detail) -> None:
        t = 0.0 if self._t0 is None else time.time() - self._t0
        self.events.append({"t": round(t, 3), "worker": worker,
                            "event": event, **detail})

    def setup(self) -> None:
        """Partition the trace and write every worker directory."""
        c = self.cfg
        parts: List[List] = [[] for _ in range(c.n_workers)]
        for i, r in enumerate(self.requests):
            parts[i % c.n_workers].append(r)
        for idx in range(c.n_workers):
            wdir = self.root / f"worker-{idx}"
            (wdir / "inbox").mkdir(parents=True, exist_ok=True)
            w = WorkerHandle(idx=idx, dir=wdir, assigned=list(parts[idx]))
            spec = {
                "dir": str(wdir), "arch": c.arch, "mode": c.mode,
                "slots": c.slots, "capacity": c.capacity,
                "scheduler": c.scheduler, "seed": c.seed,
                "param_seed": c.param_seed, "overlap": c.overlap,
                "engine_impl": c.engine_impl, "max_len": self._max_len(),
                "checkpoint_every": c.checkpoint_every,
                "retain_segments": c.retain_segments,
                "audit_every": c.audit_every,
                "heartbeat_s": c.heartbeat_s, "poll_s": c.worker_poll_s,
                "faults": c.worker_faults.get(idx),
                "dtype": c.dtype, "device": c.device, "ckpt": c.ckpt,
            }
            (wdir / "spec.json").write_text(json.dumps(spec, indent=2),
                                            encoding="utf-8")
            (wdir / "trace.json").write_text(
                json.dumps([request_record(r, binary=False)
                            for r in parts[idx]]), encoding="utf-8")
            self.workers.append(w)

    def _launch(self, w: WorkerHandle, *, clean: bool) -> None:
        env = dict(os.environ)
        env.pop("REPRO_JOURNAL", None)  # per-worker journals only
        env.pop("REPRO_FAULTS", None)  # faults ride in the spec
        src = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = (src + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else src)
        cmd = [sys.executable, "-m", "repro_torch.fleet.worker",
               str(w.dir / "spec.json")]
        if clean:
            cmd.append("--clean")
        if w.log_fh is not None:
            w.log_fh.close()
        w.log_fh = open(w.dir / "worker.log", "ab")
        w.proc = subprocess.Popen(cmd, env=env, stdout=w.log_fh,
                                  stderr=subprocess.STDOUT)
        w.launched_at = time.time()
        w.restart_at = None
        w.state = "starting"
        w.hb = None
        w.ready = False
        self._event(w.idx, "launch", pid=w.proc.pid, clean=clean,
                    restarts=w.restarts)

    # -- liveness --------------------------------------------------------
    def _on_down(self, w: WorkerHandle, reason: str, now: float) -> None:
        """A live incarnation is gone (crash) or was just killed (hang):
        schedule a restart under backoff, or trip the circuit breaker."""
        self.registry.counter("worker_restarts_total",
                              reason=reason).inc()
        if w.down_at is None:
            w.down_at = now  # failover clock: first detection wins
        w.proc = None
        w.restarts += 1
        self._event(w.idx, reason, restarts=w.restarts)
        if w.restarts > self.cfg.max_restarts:
            self._circuit_break(w)
            return
        delay = RESTART_BACKOFF.backoff(w.restarts - 1, salt=w.idx)
        w.restart_at = now + delay
        w.state = "down"
        self._event(w.idx, "restart_scheduled", delay_s=round(delay, 3))

    def _circuit_break(self, w: WorkerHandle) -> None:
        """Flapping worker: mark failed and re-offer its unfinished
        requests to the survivors. Journal pending (watermarks intact)
        wins over the raw trace record for the same rid."""
        w.failed = True
        w.state = "failed"
        self._event(w.idx, "circuit_break", restarts=w.restarts)
        st = recover(w.dir / "journal")
        seen = st.seen_rids if st else set()
        by_rid = {r.rid: r for r in w.assigned if r.rid not in seen}
        for r in (st.pending if st else []):
            by_rid[r.rid] = r
        unfinished = sorted(by_rid.values(),
                            key=lambda r: (r.arrival_time, r.rid))
        if not unfinished:
            return
        survivors = [v for v in self.workers if v.live]
        if not survivors:
            # everyone else already finished and exited: bring the
            # least-flappy completed worker back (clean) to absorb it
            done = [v for v in self.workers if v.completed]
            assert done, "circuit break with no possible survivor"
            back = min(done, key=lambda v: v.restarts)
            back.completed = False
            self._launch(back, clean=True)
            survivors = [back]
        batches: List[List] = [[] for _ in survivors]
        for i, r in enumerate(unfinished):
            batches[i % len(survivors)].append(r)
        for v, batch in zip(survivors, batches):
            if not batch:
                continue
            self._reassign_seq += 1
            payload = json.dumps([request_record(r, binary=False)
                                  for r in batch])
            tmp = v.dir / "inbox" / f".reassign-{self._reassign_seq:04d}.tmp"
            tmp.write_text(payload, encoding="utf-8")
            os.replace(tmp, v.dir / "inbox"
                       / f"reassign-{self._reassign_seq:04d}.json")
            v.assigned.extend(batch)
            self.registry.counter("requests_reassigned_total").inc(len(batch))
            self._event(v.idx, "reassigned_to", n=len(batch),
                        source=w.idx)

    def poll_once(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        c = self.cfg
        finished_est = 0
        for w in self.workers:
            if not w.live:
                finished_est += (w.hb or {}).get("finished", 0)
                continue
            if w.proc is None:  # waiting out restart backoff
                if w.restart_at is not None and now >= w.restart_at:
                    self._launch(w, clean=True)
                continue
            rc = w.proc.poll()
            hb = read_heartbeat(w.dir / HEARTBEAT_NAME)
            cur = hb if hb and hb.get("pid") == w.proc.pid else None
            if cur is not None:
                w.hb = cur
                w.phase = cur.get("phase", "")
                if not w.ready and w.phase != "init":
                    w.ready = True
                    self._event(w.idx, "ready",
                                startup_s=round(now - w.launched_at, 3))
                if w.down_at is not None and cur.get("phase") not in (
                        "init", "ready"):
                    # replacement incarnation is past startup and
                    # serving/idle again: failover complete
                    dt = now - w.down_at
                    self.failover_samples.append(dt)
                    self.registry.histogram(
                        "fleet_failover_s", buckets=FAILOVER_BUCKETS
                    ).observe(dt)
                    self._event(w.idx, "failover_complete",
                                s=round(dt, 3))
                    w.down_at = None
            finished_est += (w.hb or {}).get("finished", 0)
            if rc is not None:  # process exited
                w.exit_code = rc
                if rc == 0 and w.phase in ("done", "drained"):
                    w.completed = True
                    w.state = "done"
                    self._event(w.idx, "completed", phase=w.phase)
                else:
                    self._on_down(w, "crash", now)
                continue
            # alive: staleness classification
            age = (now - cur["ts"]) if cur is not None \
                else (now - w.launched_at)
            self.registry.gauge("fleet_heartbeat_age_s",
                                "age of the worker's last heartbeat",
                                worker=str(w.idx)).set(age)
            self.registry.gauge("fleet_worker_up",
                                "1 while the worker process is live",
                                worker=str(w.idx)).set(1.0)
            in_startup = cur is None or cur.get("phase") in ("init",
                                                             "ready")
            deadline = c.startup_grace_s if in_startup \
                else c.hang_deadline_s
            if age > deadline:
                # hung: heartbeat stale while the process still runs —
                # only SIGKILL gets its slot back; recovery makes the
                # restart token-identical
                self._event(w.idx, "hang_detected", age_s=round(age, 3))
                w.proc.kill()
                w.proc.wait()
                self._on_down(w, "hang", now)
            elif age > c.degraded_after_s and not in_startup:
                w.state = "degraded"
            else:
                w.state = "healthy"
        for w in self.workers:
            if not w.live:
                self.registry.gauge("fleet_worker_up",
                                    "1 while the worker process is live",
                                    worker=str(w.idx)).set(0.0)
        if self._t0 is not None:
            self.timeline.append({
                "t": round(now - self._t0, 3),
                "finished": finished_est,
                "states": {str(w.idx): w.state for w in self.workers}})

    # -- completion ------------------------------------------------------
    def _finished_rids(self) -> set:
        done = set()
        for w in self.workers:
            st = recover(w.dir / "journal")
            if st is not None:
                done.update(r.rid for r in st.results)
        return done

    def _maybe_complete(self) -> bool:
        """Authoritative completion check, gated on cheap signals: every
        live worker idle-or-done, nothing waiting on a restart, and no
        unconsumed inbox re-offers."""
        for w in self.workers:
            if w.failed:
                continue
            if w.live and (w.proc is None
                           or (w.hb or {}).get("phase")
                           not in ("idle", "done", "drained")):
                return False
            if any((w.dir / "inbox").glob("*.json")):
                return False
        return self.total_rids <= self._finished_rids()

    def request_drain(self) -> None:
        self._drain_requested = True

    def drain(self) -> None:
        """Forward SIGTERM, wait for graceful exits, SIGKILL stragglers."""
        for w in self.workers:
            if w.live and w.proc is not None and w.proc.poll() is None:
                w.proc.send_signal(signal.SIGTERM)
                self._event(w.idx, "sigterm")
        deadline = time.time() + self.cfg.drain_timeout_s
        for w in self.workers:
            if w.proc is None:
                continue
            try:
                w.exit_code = w.proc.wait(
                    timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.exit_code = w.proc.wait()
                self._event(w.idx, "drain_kill")
            hb = read_heartbeat(w.dir / HEARTBEAT_NAME)
            if hb:
                w.phase = hb.get("phase", w.phase)
            if w.live and w.exit_code == 0:
                w.completed = True
                w.state = "done"
            if w.log_fh is not None:
                w.log_fh.close()
                w.log_fh = None

    # -- main loop -------------------------------------------------------
    def run(self, max_wall_s: Optional[float] = None) -> Dict:
        self.setup()
        self._t0 = time.time()
        for w in self.workers:
            self._launch(w, clean=w.idx not in self.cfg.worker_faults)
        drained = False
        try:
            while True:
                now = time.time()
                self.poll_once(now)
                if self._drain_requested:
                    drained = True
                    break
                if all(not w.live for w in self.workers):
                    break
                if self._maybe_complete():
                    break
                if max_wall_s is not None and now - self._t0 > max_wall_s:
                    self._event(-1, "wall_timeout")
                    drained = True
                    break
                time.sleep(self.cfg.poll_s)
        finally:
            self.drain()
        return self.collect(drained=drained)

    # -- aggregation -----------------------------------------------------
    def collect(self, *, drained: bool = False) -> Dict:
        """Authoritative fleet report, rebuilt from the journals (a
        worker's results.json can be a step stale; its journal cannot)."""
        finished: Dict[int, object] = {}
        pending: Dict[int, object] = {}
        for w in self.workers:
            st = recover(w.dir / "journal")
            if st is None:
                continue
            for r in st.results:
                finished.setdefault(r.rid, r)
            for r in st.pending:
                pending.setdefault(r.rid, r)
        pend_rids = {rid for rid in pending if rid not in finished}
        unaccounted = sorted(self.total_rids - set(finished) - pend_rids)
        restarts = {
            reason: self.registry.counter("worker_restarts_total",
                                          reason=reason).value
            for reason in ("crash", "hang")}
        fo = self.failover_samples
        report = {
            "n_requests": len(self.requests),
            "n_workers": self.cfg.n_workers,
            "drained": drained,
            "wall_s": round(time.time() - self._t0, 3) if self._t0 else 0.0,
            "workers": [{
                "idx": w.idx, "restarts": w.restarts,
                "failed": w.failed, "completed": w.completed,
                "exit_code": w.exit_code, "phase": w.phase,
            } for w in self.workers],
            "restarts": restarts,
            "reassigned": self.registry.counter(
                "requests_reassigned_total").value,
            "failover_s": {
                "count": len(fo),
                "mean": round(sum(fo) / len(fo), 3) if fo else None,
                "max": round(max(fo), 3) if fo else None,
                "samples": [round(s, 3) for s in fo]},
            "finished": len(finished),
            "pending_checkpointed": sorted(pend_rids),
            "unaccounted": unaccounted,
            "results": {str(rid): {
                "tokens": [int(t) for t in r.tokens],
                "finish_reason": r.finish_reason}
                for rid, r in sorted(finished.items())},
            "events": self.events,
            "timeline": self.timeline,
        }
        return report

    def prometheus_text(self) -> str:
        """Supervisor registry + the latest per-worker heartbeat metric
        summaries re-exported as ``fleet_worker_*`` gauges."""
        for w in self.workers:
            hb = w.hb or read_heartbeat(w.dir / HEARTBEAT_NAME)
            if not hb:
                continue
            for k, v in (hb.get("metrics") or {}).items():
                if isinstance(v, (int, float)) and v is not None:
                    self.registry.gauge(
                        f"fleet_worker_{k}",
                        "aggregated from worker heartbeat snapshots",
                        worker=str(w.idx)).set(float(v))
        return self.registry.to_prometheus_text()
