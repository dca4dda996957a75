"""Write-ahead request journal: the append-only half of crash recovery.

Every server event lands as one JSONL line, flushed per append so the
journal is current up to the instant of a crash:

  ``base``    first line of a fresh segment, pointing at the checkpoint
              that summarizes everything before it
  ``ckpt``    checkpoint marker appended just before rotation (also the
              recovery anchor when a crash interrupts rotation itself)
  ``arrival`` full request spec (prompt base64-encoded via the shared
              ``serial`` records)
  ``admit``   request left the queue for a slot / wave
  ``wm``      per-request emitted-token watermark (the tokens produced
              by one decode step — re-prefill target after a crash)
  ``retire``  final tokens + finish bookkeeping for one request
  ``shed``    admission control turned the request away

Rotation is atomic-rename: on checkpoint the active segment gains a
``ckpt`` marker, is renamed to ``journal-NNNN.jsonl``, and a fresh
``journal.jsonl`` opens with a ``base`` record — so recovery only ever
replays the active segment: last anchored checkpoint + events after it.
A torn tail line (crash mid-write) is detected and skipped.

``recover()`` folds checkpoint + tail back into a
:class:`RecoveredState`: finished results, restored metrics, engine
cache state for warm revival, and the still-live requests — in-flight
ones carrying their watermark as ``ServeRequest.resumed`` so greedy
decode continues token-identically to an uninterrupted run.

Counterpart of ``repro/recovery/journal.py``: the same events, rotation
and recovery, so a journal written by either package recovers in the
other (``REPRO_JOURNAL`` keeps the reference's name).
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Set

import numpy as np

from ..serving.metrics import ServerMetrics
from ..serving.queue import RequestQueue
from ..serving.request import ServeRequest, ServeResult
from .checkpoint import (
    load_server_checkpoint,
    record_request,
    record_result,
    request_record,
)

JOURNAL_ENV_VAR = "REPRO_JOURNAL"
_SEGMENT_RE = re.compile(r"journal-(\d+)\.jsonl$")


def journal_dir_from_env() -> Optional[str]:
    """Default journal directory (``REPRO_JOURNAL``), if configured."""
    return os.environ.get(JOURNAL_ENV_VAR) or None


class RequestJournal:
    """Append-only JSONL event log with atomic-rename rotation."""

    def __init__(self, directory, *, seen: Optional[Set[int]] = None,
                 retain_segments: Optional[int] = 2):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "journal.jsonl"
        # rids whose arrival is already durable (survives reopen-on-
        # restore: the recovered state hands its rid set back in)
        self._seen: Set[int] = set(seen or ())
        # rotated segments to keep beyond the active one (None = keep
        # everything). Recovery only ever replays the active segment +
        # its anchored checkpoint, so older segments are forensic
        # history; without pruning a long-lived worker grows one
        # segment + one checkpoint per rotation, forever.
        self.retain_segments = retain_segments
        segs = [int(m.group(1)) for p in self.dir.iterdir()
                if (m := _SEGMENT_RE.match(p.name))]
        self._seq = max(segs, default=-1) + 1
        self._fh = open(self.path, "a", encoding="utf-8")

    # -- low-level append ------------------------------------------------
    def append(self, ev: str, **fields) -> None:
        line = json.dumps({"ev": ev, **fields}, separators=(",", ":"))
        self._fh.write(line + "\n")
        self._fh.flush()

    # -- event helpers ---------------------------------------------------
    def arrival(self, req: ServeRequest) -> None:
        """Journal a request spec once (idempotent per rid)."""
        if req.rid in self._seen:
            return
        self._seen.add(req.rid)
        self.append("arrival", **request_record(req, binary=False))

    def admit(self, rid: int, now: float) -> None:
        self.append("admit", rid=int(rid), now=float(now))

    def watermark(self, toks: Dict[int, List[int]], now: float) -> None:
        """One decode step's newly emitted tokens, per rid."""
        if toks:
            self.append("wm", toks={str(r): [int(t) for t in ts]
                                    for r, ts in toks.items()},
                        now=float(now))

    def retire(self, res: ServeResult, *, plen: int, attained: bool,
               ttft: Optional[float] = None,
               itl: Optional[float] = None) -> None:
        self.append(
            "retire", rid=int(res.rid),
            tokens=[int(t) for t in res.tokens],
            reason=res.finish_reason, arrival=float(res.arrival_time),
            start=float(res.start_time), finish=float(res.finish_time),
            decode_steps=int(res.decode_steps), degraded=bool(res.degraded),
            attained=bool(attained), plen=int(plen),
            ttft=None if ttft is None else float(ttft),
            itl=None if itl is None else float(itl))

    def shed(self, req: ServeRequest, *, expired: bool, now: float) -> None:
        self.append("shed", rid=int(req.rid), expired=bool(expired),
                    arrival=float(req.arrival_time), now=float(now))

    # -- checkpoint + rotation -------------------------------------------
    def checkpoint_path(self, step: int) -> Path:
        return self.dir / f"ckpt-{int(step):08d}.msgpack"

    def rotate(self, ckpt_path, step: int, now: float) -> None:
        """Anchor the just-written checkpoint and start a fresh segment.
        The marker goes into the old segment BEFORE the rename so a
        crash at any point leaves a recoverable anchor somewhere."""
        self.append("ckpt", ckpt=str(ckpt_path), step=int(step),
                    now=float(now))
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        os.replace(self.path, self.dir / f"journal-{self._seq:04d}.jsonl")
        self._seq += 1
        self._fh = open(self.path, "a", encoding="utf-8")
        self.append("base", ckpt=str(ckpt_path), step=int(step),
                    now=float(now))
        self._prune()

    def _prune(self) -> None:
        """Segment retention: drop rotated segments beyond the newest
        ``retain_segments``, then any checkpoint file no retained
        segment (or the active one) anchors. Every retained segment
        still starts with a ``base`` record pointing at a live
        checkpoint, so recovery after pruning is unchanged."""
        if self.retain_segments is None or self.retain_segments < 0:
            return
        segs = sorted(
            (p for p in self.dir.iterdir() if _SEGMENT_RE.match(p.name)),
            key=lambda p: int(_SEGMENT_RE.match(p.name).group(1)))
        cut = len(segs) - self.retain_segments
        if cut <= 0:
            return
        drop, keep = segs[:cut], segs[cut:]
        referenced: Set[str] = set()
        for seg in [*keep, self.path]:
            try:
                with open(seg, "r", encoding="utf-8") as f:
                    for line in f:
                        try:
                            ev = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        if ev.get("ev") in ("base", "ckpt"):
                            referenced.add(Path(ev["ckpt"]).name)
            except OSError:
                continue
        for p in drop:
            p.unlink(missing_ok=True)
        for p in self.dir.glob("ckpt-*.msgpack"):
            if p.name not in referenced:
                p.unlink(missing_ok=True)

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


# ---------------------------------------------------------------------------
# recovery: checkpoint + journal tail -> resumable state
# ---------------------------------------------------------------------------


@dataclass
class RecoveredState:
    """Everything a server needs to resume after a crash."""

    kind: str = "continuous"  # which server wrote the journal
    now: float = 0.0
    step: int = 0
    seed: int = 0
    policy: str = "fcfs"
    results: List[ServeResult] = field(default_factory=list)
    metrics: ServerMetrics = field(default_factory=ServerMetrics)
    # still-live requests (pending + former in-flight, watermarks set)
    pending: List[ServeRequest] = field(default_factory=list)
    # {"cache": [...], "metrics": {...}} on the offloaded path
    engine: Optional[Dict] = None
    seen_rids: Set[int] = field(default_factory=set)
    # requests already resolved before the restore — the watchdog's
    # conservation offset (the rebuilt queue never sees them)
    offered_base: int = 0

    def build_queue(self, max_pending: Optional[int] = None) -> RequestQueue:
        return RequestQueue(self.pending, max_pending=max_pending)


def _read_events(path: Path) -> List[Dict]:
    """Parse a JSONL segment, skipping torn/corrupt lines (a crash can
    truncate the tail mid-write)."""
    events = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn write; everything before it is intact
    return events


def _active_segment(directory: Path) -> Optional[Path]:
    active = directory / "journal.jsonl"
    if active.exists():
        return active
    # crash between rotation's rename and the new segment's open: the
    # freshest rotated segment ends in a ckpt marker and anchors recovery
    segs = sorted(
        (p for p in directory.iterdir() if _SEGMENT_RE.match(p.name)),
        key=lambda p: int(_SEGMENT_RE.match(p.name).group(1)))
    return segs[-1] if segs else None


def recover(directory) -> Optional[RecoveredState]:
    """Rebuild a :class:`RecoveredState` from a journal directory, or
    None when there is nothing to recover from."""
    directory = Path(directory)
    seg = _active_segment(directory) if directory.exists() else None
    if seg is None:
        return None
    events = _read_events(seg)

    # find the last anchored checkpoint that actually loads
    ckpt = None
    start = 0
    for i in range(len(events) - 1, -1, -1):
        ev = events[i]
        if ev.get("ev") in ("base", "ckpt"):
            try:
                ckpt = load_server_checkpoint(ev["ckpt"])
            except (OSError, ValueError, KeyError, AssertionError):
                continue  # anchor's file lost/torn; try an earlier one
            start = i + 1
            break

    st = RecoveredState()
    requests: Dict[int, Dict] = {}
    emitted: Dict[int, List[int]] = {}
    done: Set[int] = set()

    if ckpt is not None:
        st.kind = ckpt["kind"]
        st.now = ckpt["now"]
        st.step = ckpt["step"]
        st.seed = ckpt["seed"]
        st.policy = ckpt["policy"]
        st.metrics = ServerMetrics.from_state(ckpt["metrics"])
        st.engine = ckpt.get("engine")
        for rec in ckpt["results"]:
            st.results.append(record_result(rec))
            done.add(int(rec["rid"]))
        for rec in ckpt["pending"]:
            requests[int(rec["rid"])] = rec
            emitted[int(rec["rid"])] = list(rec.get("emitted") or [])
        for rec in ckpt["inflight"]:
            requests[int(rec["rid"])] = rec
            emitted[int(rec["rid"])] = list(rec.get("emitted") or [])

    mt = st.metrics
    for ev in events[start:]:
        kind = ev.get("ev")
        if kind == "arrival":
            rid = int(ev["rid"])
            if rid not in requests and rid not in done:
                requests[rid] = ev
                emitted[rid] = list(ev.get("emitted") or [])
        elif kind == "wm":
            for rid_s, toks in ev["toks"].items():
                rid = int(rid_s)
                emitted.setdefault(rid, []).extend(int(t) for t in toks)
                mt.generated_tokens += len(toks)
        elif kind == "retire":
            rid = int(ev["rid"])
            done.add(rid)
            requests.pop(rid, None)
            emitted.pop(rid, None)
            res = ServeResult(
                rid=rid, tokens=np.asarray(ev["tokens"], np.int32),
                finish_reason=ev["reason"], arrival_time=ev["arrival"],
                start_time=ev["start"], finish_time=ev["finish"],
                decode_steps=int(ev.get("decode_steps", 0)),
                degraded=bool(ev.get("degraded", False)))
            st.results.append(res)
            mt.observe_finish(res.latency, ttft=ev.get("ttft"),
                              itl=ev.get("itl"))
            if ev["reason"] == "deadline":
                mt.deadline_retired += 1
            elif ev.get("attained", True):
                mt.slo_attained += 1
            if ev.get("degraded"):
                mt.degraded_requests += 1
            if st.kind == "wave":
                # the wave path counts these at retire (generated
                # tokens were already replayed from the wm event)
                mt.decode_steps += int(ev.get("decode_steps", 0))
                mt.prefill_tokens += int(ev.get("plen", 0))
            st.now = max(st.now, ev["finish"])
        elif kind == "shed":
            rid = int(ev["rid"])
            done.add(rid)
            requests.pop(rid, None)
            emitted.pop(rid, None)
            if ev.get("expired"):
                mt.requests_expired += 1
            else:
                mt.requests_shed += 1
            st.results.append(ServeResult(
                rid=rid, tokens=np.zeros(0, np.int32), finish_reason="shed",
                arrival_time=ev["arrival"], start_time=ev["now"],
                finish_time=ev["now"]))
            st.now = max(st.now, ev["now"])
        elif kind == "admit":
            st.now = max(st.now, ev.get("now", st.now))
        # base/ckpt markers inside the tail (partial rotation) were
        # already consumed by the anchor search above

    # live requests go back to the queue; watermarks that already
    # complete a request (crash between its last wm and its retire
    # line) retire here instead of re-entering service
    for rid in sorted(requests):
        rec = dict(requests[rid])
        rec["emitted"] = emitted.get(rid, [])
        req = record_request(rec)
        em = rec["emitted"]
        reason = None
        if em:
            stops = set(req.stop_tokens)
            hit = next((i for i, t in enumerate(em) if t in stops), None)
            if hit is not None:
                em = em[: hit + 1]
                reason = "stop"
            elif len(em) >= req.max_new_tokens:
                em = em[: req.max_new_tokens]
                reason = "length"
        if reason is not None:
            attained = req.deadline is None or st.now <= req.deadline
            st.results.append(ServeResult(
                rid=rid, tokens=np.asarray(em, np.int32),
                finish_reason=reason, arrival_time=req.arrival_time,
                start_time=req.arrival_time, finish_time=st.now))
            mt.observe_finish(st.now - req.arrival_time)
            if attained:
                mt.slo_attained += 1
            done.add(rid)
            continue
        st.pending.append(req)

    st.pending.sort(key=lambda r: (r.arrival_time, r.rid))
    st.seen_rids = set(requests) | done
    st.offered_base = (mt.requests_finished + mt.requests_shed
                       + mt.requests_expired)
    return st
