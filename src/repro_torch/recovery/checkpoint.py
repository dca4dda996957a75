"""Server snapshots: the periodic half of the crash-recovery story.

A checkpoint captures everything a server needs to resume mid-run:
the queue's pending requests, in-flight progress (per-request emitted-
token watermarks), the sampler seed, the full ``ServerMetrics`` state,
the results produced so far, and — the MELINOE-specific part — each
layer's expert-cache resident set + policy scores so ``revive()`` can
warm-load the slab instead of cold-starting. Payloads are msgpack via
the shared ``serial`` helpers and land atomically, so the journal can
always trust the last checkpoint it references.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..serving.metrics import ServerMetrics
from ..serving.request import ServeRequest, ServeResult
from . import msgpack_lite
from .serial import array_record, atomic_write_bytes
from .serial import record_array as _record_tensor


def record_array(rec: Optional[Dict]) -> Optional[np.ndarray]:
    """Decode an array record into a numpy array (None passes through)."""
    return None if rec is None else _record_tensor(rec).numpy()

CKPT_VERSION = 1


# ---------------------------------------------------------------------------
# request / result records (shared with the journal's JSONL events)
# ---------------------------------------------------------------------------


def request_record(req: ServeRequest, *, binary: bool = False,
                   emitted: Optional[Sequence[int]] = None) -> Dict:
    """Full request spec as a plain dict. ``emitted`` records the
    pre-crash watermark (in-flight checkpoints); a request resumed from
    an earlier crash folds its ``resumed`` prefix in, so the watermark
    is always absolute."""
    pre = [] if req.resumed is None else [int(t) for t in req.resumed]
    return {
        "rid": int(req.rid),
        "prompt": array_record(req.prompt, binary=binary),
        "max_new_tokens": int(req.max_new_tokens),
        "temperature": float(req.temperature),
        "stop_tokens": [int(t) for t in req.stop_tokens],
        "arrival_time": float(req.arrival_time),
        "cluster": None if req.cluster is None else int(req.cluster),
        "slo": None if req.slo is None else float(req.slo),
        "quality": float(req.quality),
        "expert_scores": (None if req.expert_scores is None
                          else array_record(req.expert_scores, binary=binary)),
        "emitted": pre + [int(t) for t in (emitted or [])],
    }


def record_request(rec: Dict) -> ServeRequest:
    """Rebuild a :class:`ServeRequest`; a non-empty ``emitted``
    watermark becomes the ``resumed`` prefix."""
    emitted = rec.get("emitted") or []
    return ServeRequest(
        rid=int(rec["rid"]),
        prompt=record_array(rec["prompt"]).astype(np.int32),
        max_new_tokens=int(rec["max_new_tokens"]),
        temperature=float(rec["temperature"]),
        stop_tokens=tuple(int(t) for t in rec["stop_tokens"]),
        arrival_time=float(rec["arrival_time"]),
        cluster=rec.get("cluster"),
        slo=rec.get("slo"),
        quality=float(rec.get("quality", 1.0)),
        expert_scores=record_array(rec.get("expert_scores")),
        resumed=(np.asarray(emitted, np.int32) if emitted else None),
    )


def result_record(res: ServeResult) -> Dict:
    return {
        "rid": int(res.rid),
        "tokens": [int(t) for t in res.tokens],
        "finish_reason": res.finish_reason,
        "arrival_time": float(res.arrival_time),
        "start_time": float(res.start_time),
        "finish_time": float(res.finish_time),
        "decode_steps": int(res.decode_steps),
        "degraded": bool(res.degraded),
    }


def record_result(rec: Dict) -> ServeResult:
    return ServeResult(
        rid=int(rec["rid"]),
        tokens=np.asarray(rec["tokens"], np.int32),
        finish_reason=rec["finish_reason"],
        arrival_time=float(rec["arrival_time"]),
        start_time=float(rec["start_time"]),
        finish_time=float(rec["finish_time"]),
        decode_steps=int(rec.get("decode_steps", 0)),
        degraded=bool(rec.get("degraded", False)),
    )


# ---------------------------------------------------------------------------
# engine cache state (array fields -> records)
# ---------------------------------------------------------------------------


def _enc_cache_layer(st: Dict) -> Dict:
    return {**st, "counts": array_record(st["counts"]),
            "last_used": array_record(st["last_used"])}


def _dec_cache_layer(st: Dict) -> Dict:
    return {**st, "counts": record_array(st["counts"]),
            "last_used": record_array(st["last_used"])}


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------


def save_server_checkpoint(
    path,
    *,
    kind: str,
    step: int,
    now: float,
    seed: int,
    policy: str,
    pending: Sequence[ServeRequest],
    inflight: Sequence[Tuple[ServeRequest, Sequence[int]]],
    results: Sequence[ServeResult],
    metrics: ServerMetrics,
    engine: Optional[Dict] = None,
) -> None:
    """Atomically write one server snapshot. ``inflight`` pairs each
    in-service request with its emitted-token watermark; ``engine`` is
    ``{"cache": OffloadedMoEEngine.cache_state(), "metrics":
    EngineMetrics.state()}`` on the offloaded path."""
    assert kind in ("continuous", "wave"), kind
    payload = {
        "version": CKPT_VERSION,
        "kind": kind,
        "step": int(step),
        "now": float(now),
        "seed": int(seed),
        "policy": policy,
        "pending": [request_record(r, binary=True) for r in pending],
        "inflight": [request_record(r, binary=True, emitted=em)
                     for r, em in inflight],
        "results": [result_record(r) for r in results],
        "metrics": metrics.to_state(),
        "engine": (None if engine is None else {
            "cache": [_enc_cache_layer(st) for st in engine["cache"]],
            "metrics": engine["metrics"],
        }),
    }
    atomic_write_bytes(path, msgpack_lite.packb(payload))


def load_server_checkpoint(path) -> Dict:
    """Decode a snapshot back to plain python (cache-layer arrays
    restored to numpy; request/result records left as dicts for the
    journal replay to merge with post-checkpoint events)."""
    payload = msgpack_lite.unpackb(Path(path).read_bytes())
    assert payload["version"] == CKPT_VERSION, payload["version"]
    if payload.get("engine") is not None:
        payload["engine"] = {
            "cache": [_dec_cache_layer(st)
                      for st in payload["engine"]["cache"]],
            "metrics": payload["engine"]["metrics"],
        }
    return payload
