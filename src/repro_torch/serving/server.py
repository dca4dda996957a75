"""Continuous-batching server over the full model (counterpart of
``repro/serving/server.py``, the fits-in-memory half).

``ContinuousBatchingServer`` runs the single-step decode over a fixed
pool of KV slots. Sequences live at independent positions (the per-row
``pos`` vector threaded through ``decode_attend``); finished sequences
retire on a stop token or their token budget and the freed slot is
re-prefilled with the next scheduled request — no one is padded to the
longest prompt or decoded past their own budget.

Clock semantics: the virtual clock counts measured host time for
prefill + decode. A span ends only once the step's tokens are on the
host (``.cpu()``), so it holds the device's work too. The constructor
runs one prefill and one decode (building the kernels on a card) so that
no set-up lands on a request's latency. The spans only time, and the
last ``run`` keeps them in ``span_s`` ({"serve.prefill": [s, ...],
"serve.decode_step": [s, ...]}). The reference's tracer spans
(``clock_span``) and fault seams (``get_fault_plan``) come with ``obs/``
and ``faults/``, not ported yet.
So do the crash-safety knobs of ``run`` (``journal``,
``checkpoint_every``, ``audit_every``, ``resume``), which raise, and
``OffloadedWaveServer``.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..inference.engine import Request, ServingEngine, truncate_at_stop
from ..inference.sampling import greedy, row_generator, sample_per_row
from ..models.model import decode_step, prefill
from ..models.runtime import Runtime
from .batch import BatchState
from .metrics import ServerMetrics
from .queue import RequestQueue
from .request import ServeRequest, ServeResult
from .scheduler import FCFSScheduler, Scheduler


class _Span:
    """Host seconds between enter and exit (``dur``), appended to ``into``."""

    def __init__(self, into: list):
        self.into = into

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dur = time.perf_counter() - self._t0
        self.into.append(self.dur)
        return False


def _reject_unservable(queue: RequestQueue, now: float, mt: ServerMetrics,
                       results: List[ServeResult]) -> None:
    """Admission control: turn bound-overflow and expired-while-queued
    requests into "shed" results — they never reach a slot.
    ``drop_expired`` routes its victims through the queue's shed pool,
    so one drain covers both kinds; identity tells them apart."""
    expired = {id(r) for r in queue.drop_expired(now)}
    queue.enforce_bound(now)
    for r in queue.drain_shed():
        if id(r) in expired:
            mt.requests_expired += 1
        else:
            mt.requests_shed += 1
        results.append(ServeResult(
            rid=r.rid, tokens=np.zeros(0, np.int32), finish_reason="shed",
            arrival_time=r.arrival_time, start_time=now, finish_time=now,
        ))


class ContinuousBatchingServer:
    """In-flight batching over the single-step decode."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        n_slots: int = 4,
        max_len: int = 128,
        scheduler: Optional[Scheduler] = None,
        rt: Optional[Runtime] = None,
        lora=None,
        window_override: Optional[int] = None,
        seed: int = 0,
    ):
        if lora is not None:
            raise NotImplementedError("ContinuousBatchingServer: LoRA is not ported yet")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.rt = rt or Runtime(device=self.device, zero_drop=True)
        self.scheduler = scheduler or FCFSScheduler()
        self.n_slots = n_slots
        self.max_len = max_len
        self.window_override = window_override
        self.seed = seed  # request-keyed sampling: row_generator(seed, rid, step)
        self.cache = self._fresh_cache()
        # warm one decode over the pool and one prefill + insert now, so
        # the serving clock never charges the kernel build or first-call
        # set-up to the first requests
        with torch.inference_mode():
            dummy = torch.zeros((n_slots, 1), dtype=torch.long, device=self.device)
            decode_step(params, cfg, dummy, self.cache, self.rt,
                        window_override=window_override)
            self.cache["pos"].zero_()
            _, pre = prefill(params, cfg, dummy[:1], self.rt, n_slots=max_len,
                             window_override=window_override)
            self._insert_row(self.cache, pre, 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _fresh_cache(self):
        """Slot-pool cache: a dummy 1-token prefill fixes the tree
        structure (ring sizes etc.) to exactly what per-request prefills
        produce; rows are garbage until a request is inserted."""
        dummy = torch.zeros((self.n_slots, 1), dtype=torch.long, device=self.device)
        _, cache = prefill(self.params, self.cfg, dummy, self.rt, n_slots=self.max_len,
                           window_override=self.window_override)
        cache["pos"] = torch.zeros((self.n_slots,), dtype=torch.long,
                                   device=self.device)  # per-row positions
        return cache

    @staticmethod
    def _insert_row(cache, pre_cache, slot: int) -> None:
        """Splice a freshly prefilled request (batch of 1) into slot
        ``slot`` of the pooled cache, in place. Group leaves are stacked
        (R, B, ...), so one copy per leaf covers KV, ring positions and
        SSM state alike."""
        cache["pos"][slot] = pre_cache["pos"]
        for g, sub in cache.items():
            if g == "pos":
                continue
            for p, leaves in sub.items():
                for big, small in zip(leaves, pre_cache[g][p]):
                    big[:, slot].copy_(small[:, 0])

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _admit(self, state: BatchState, slot: int, req: ServeRequest,
               cur: np.ndarray, now: float, mt: ServerMetrics) -> Optional[str]:
        """Prefill one request into a free slot; start_time is the
        admission moment (queueing ends, service begins). Returns the
        finish reason if the request completed immediately (budget of
        1 / instant stop) — the caller retires it with a clock that
        includes this prefill's cost. A request carrying a ``resumed``
        prefix prefills ``prompt + resumed``."""
        inp = (req.prompt if req.resumed is None else
               np.concatenate([req.prompt, req.resumed]).astype(np.int32))
        logits, pre_cache = prefill(
            self.params, self.cfg,
            torch.as_tensor(inp, dtype=torch.long, device=self.device)[None],
            self.rt, n_slots=self.max_len, window_override=self.window_override)
        self._insert_row(self.cache, pre_cache, slot)
        state.occupy(slot, req, now)
        mt.prefill_tokens += len(inp)
        # first generated token comes from the prefill logits (greedy, to
        # match ServingEngine.generate_batch semantics); .item() waits for
        # the device
        tok = int(greedy(logits)[0, 0].item())
        cur[slot, 0] = tok
        mt.generated_tokens += 1
        return state.append_token(slot, tok)

    @torch.inference_mode()
    def _decode(self, state: BatchState, cur: np.ndarray, active) -> np.ndarray:
        """One decode step over the whole slot pool -> (n_slots, 1) tokens on
        the host. A row at temperature > 0 samples from
        ``row_generator(seed, rid, tokens generated so far)``."""
        logits, self.cache, _ = decode_step(
            self.params, self.cfg, torch.as_tensor(cur, dtype=torch.long,
                                                   device=self.device),
            self.cache, self.rt, window_override=self.window_override)
        temps = np.zeros(self.n_slots, np.float32)
        gens: list = [None] * self.n_slots
        for s in active:
            slot = state.slots[s]
            temps[s] = slot.request.temperature
            if temps[s] > 0:
                gens[s] = row_generator(self.seed, slot.request.rid, len(slot.generated))
        toks = sample_per_row(logits, temps, gens) if np.any(temps > 0) else greedy(logits)
        return toks.cpu().numpy()

    def run(self, queue: RequestQueue,
            metrics: Optional[ServerMetrics] = None,
            *,
            journal=None,
            checkpoint_every: Optional[int] = None,
            audit_every: Optional[int] = None,
            resume=None,
            on_step=None,
            should_drain=None,
            ) -> Tuple[List[ServeResult], ServerMetrics]:
        """Serve the queue.

        * ``on_step`` — liveness hook called after every decode step
          with a dict (step/now/backlog/in_flight/finished/generated)
        * ``should_drain`` — polled each loop iteration; once it
          returns True admission stops, in-flight requests finish, and
          ``self.drained`` is set — still-pending requests stay queued

        ``journal``, ``checkpoint_every``, ``audit_every`` and ``resume``
        need ``recovery/``, which is not ported yet: they raise."""
        unported = {"journal": journal is not None, "checkpoint_every": bool(checkpoint_every),
                    "audit_every": bool(audit_every), "resume": resume is not None}
        if any(unported.values()):
            raise NotImplementedError(
                f"ContinuousBatchingServer.run: {[k for k, v in unported.items() if v]} "
                "need recovery/, not ported yet")
        mt = metrics or ServerMetrics(policy=self.scheduler.name)
        self.span_s = {"serve.prefill": [], "serve.decode_step": []}
        state = BatchState(self.n_slots, self.max_len)
        cur = np.zeros((self.n_slots, 1), np.int64)
        results: List[ServeResult] = []
        # virtual first-token time per live rid, for TTFT/ITL at retire
        first_tok: dict = {}
        now = 0.0
        step_idx = 0
        t_wall0 = time.perf_counter()

        def _retire(s: int, reason: str) -> None:
            req = state.slots[s].request
            res = state.retire(s, now, reason)
            if reason == "deadline":
                mt.deadline_retired += 1
            elif req.deadline is None or now <= req.deadline:
                mt.slo_attained += 1
            ft = first_tok.pop(res.rid, None)
            ttft = None if ft is None else ft - res.arrival_time
            itl = (None if ft is None else
                   (now - ft) / max(len(res.tokens) - 1, 1))
            mt.observe_finish(res.latency, ttft=ttft, itl=itl)
            results.append(res)

        self.drained = False
        while len(queue) or state.active_slots():
            draining = should_drain is not None and should_drain()
            # -- admission control: shed what can't be served -----------
            _reject_unservable(queue, now, mt, results)
            # -- admission: scheduler fills freed slots -----------------
            free = state.free_slots() if not draining else []
            if free:
                ready = queue.ready(now)
                if ready:
                    order = self.scheduler.order(ready, hot=state.active_requests())
                    for slot, req in zip(free, order):
                        queue.admit(req)
                        # prefill is service time: it advances the clock
                        with _Span(self.span_s["serve.prefill"]) as cs:
                            reason = self._admit(state, slot, req, cur, now, mt)
                        now += cs.dur
                        # the first token materializes with the prefill
                        first_tok[req.rid] = now
                        if reason is not None:
                            _retire(slot, reason)
                        elif req.deadline is not None and now >= req.deadline:
                            # earlier admissions' prefills ate the budget
                            _retire(slot, "deadline")
            active = state.active_slots()
            if not active:
                if draining:
                    break  # nothing in flight: pending stays queued
                # idle: jump the virtual clock to the next arrival
                nxt = queue.next_arrival()
                if nxt is not None:
                    now = max(now, nxt)
                continue

            # -- one decode step over the whole slot pool ---------------
            with _Span(self.span_s["serve.decode_step"]) as cs:
                toks_np = self._decode(state, cur, active)
            now += cs.dur

            retire_now: List[Tuple[int, str]] = []
            for s in active:
                state.slots[s].decode_steps += 1
                tok = int(toks_np[s, 0])
                cur[s, 0] = tok
                mt.generated_tokens += 1
                reason = state.append_token(s, tok)
                if reason is None:
                    dl = state.slots[s].request.deadline
                    if dl is not None and now >= dl:
                        reason = "deadline"
                if reason is not None:
                    retire_now.append((s, reason))
            mt.observe_step(len(active), self.n_slots, queue.backlog(now))
            for s, reason in retire_now:
                _retire(s, reason)

            step_idx += 1
            if on_step is not None:
                on_step({"step": step_idx, "now": now,
                         "backlog": queue.backlog(now),
                         "in_flight": len(state.active_slots()),
                         "finished": mt.requests_finished,
                         "generated": mt.generated_tokens})

        _reject_unservable(queue, now, mt, results)
        self.drained = should_drain is not None and should_drain()
        mt.wall_time += time.perf_counter() - t_wall0
        return sorted(results, key=lambda r: r.rid), mt


def serve_static(cfg: ModelConfig, params, requests: Sequence[ServeRequest], *,
                 batch_size: int, rt: Optional[Runtime] = None,
                 ) -> Tuple[List[ServeResult], int]:
    """Serve in arrival-order chunks with the padded static engine; every
    request in a chunk decodes to the chunk max budget. Returns results
    (stop-token truncated) and the total number of decode iterations."""
    eng = ServingEngine(cfg, params, rt=rt, max_batch=batch_size)
    ordered = sorted(requests, key=lambda r: (r.arrival_time, r.rid))
    results: List[ServeResult] = []
    decode_iters = 0
    for i in range(0, len(ordered), batch_size):
        chunk = ordered[i : i + batch_size]
        comps = eng.generate_batch([
            Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature) for r in chunk
        ])
        decode_iters += max(r.max_new_tokens for r in chunk) - 1
        for r, c in zip(chunk, comps):
            toks, reason = truncate_at_stop(c.tokens, r.stop_tokens)
            results.append(ServeResult(rid=r.rid, tokens=toks, finish_reason=reason,
                                       arrival_time=r.arrival_time))
    return sorted(results, key=lambda r: r.rid), decode_iters
