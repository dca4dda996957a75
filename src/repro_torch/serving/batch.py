"""Slot-based in-flight batch state for continuous batching (a numpy-only
copy of ``repro/serving/batch.py``).

``BatchState`` owns the request<->slot binding and per-slot generation
bookkeeping; the KV rows themselves live in the model cache, indexed by
the same slot ids. Finished sequences retire on a stop token or their
token budget, freeing the slot for the next prefilled request — nobody
is padded to the longest request in the batch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .request import ServeRequest, ServeResult


@dataclass
class SlotState:
    request: Optional[ServeRequest] = None
    generated: List[int] = field(default_factory=list)
    start_time: float = 0.0
    decode_steps: int = 0

    @property
    def free(self) -> bool:
        return self.request is None


class BatchState:
    def __init__(self, n_slots: int, max_len: int):
        assert n_slots >= 1 and max_len >= 2
        self.n_slots = n_slots
        self.max_len = max_len
        self.slots = [SlotState() for _ in range(n_slots)]

    # -- queries -----------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.free]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.free]

    def active_requests(self) -> List[ServeRequest]:
        return [s.request for s in self.slots if not s.free]

    # -- transitions -------------------------------------------------------
    def occupy(self, slot: int, req: ServeRequest, now: float) -> None:
        s = self.slots[slot]
        assert s.free, f"slot {slot} already bound to rid {s.request.rid}"
        assert all(
            t.free or t.request.rid != req.rid for t in self.slots
        ), f"rid {req.rid} already placed"
        assert req.prompt_len + req.max_new_tokens <= self.max_len, (
            f"rid {req.rid}: {req.prompt_len}+{req.max_new_tokens} tokens "
            f"exceed the {self.max_len}-slot KV budget"
        )
        # a resumed request starts with its pre-crash watermark already
        # generated, so the budget check in append_token counts from the
        # uninterrupted run's position
        pre = [] if req.resumed is None else [int(t) for t in req.resumed]
        assert len(pre) < req.max_new_tokens, (
            f"rid {req.rid}: resumed watermark {len(pre)} >= budget "
            f"{req.max_new_tokens} — should have been retired at replay"
        )
        self.slots[slot] = SlotState(request=req, start_time=now, generated=pre)

    def append_token(self, slot: int, token: int) -> Optional[str]:
        """Record one generated token; returns the finish reason if the
        sequence is now complete ("stop" | "length"), else None."""
        s = self.slots[slot]
        assert not s.free
        s.generated.append(int(token))
        if token in s.request.stop_tokens:
            return "stop"
        if len(s.generated) >= s.request.max_new_tokens:
            return "length"
        return None

    def audit(self) -> List[str]:
        """Slot-liveness check (watchdog contract): rid uniqueness and
        per-slot token budgets. Returns violation strings, empty when
        healthy."""
        v = []
        rids = [s.request.rid for s in self.slots if not s.free]
        if len(rids) != len(set(rids)):
            v.append(f"duplicate rid across slots: {sorted(rids)}")
        for i, s in enumerate(self.slots):
            if s.free:
                continue
            if len(s.generated) > s.request.max_new_tokens:
                v.append(
                    f"slot {i} rid {s.request.rid}: generated "
                    f"{len(s.generated)} > budget {s.request.max_new_tokens}")
        return v

    def retire(self, slot: int, now: float, reason: str) -> ServeResult:
        s = self.slots[slot]
        assert not s.free
        req = s.request
        self.slots[slot] = SlotState()
        return ServeResult(
            rid=req.rid,
            tokens=np.asarray(s.generated, np.int32),
            finish_reason=reason,
            arrival_time=req.arrival_time,
            start_time=s.start_time,
            finish_time=now,
            decode_steps=s.decode_steps,
        )
