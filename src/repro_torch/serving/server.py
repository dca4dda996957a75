"""Continuous-batching and wave servers over both inference engines
(counterpart of ``repro/serving/server.py``).

``ContinuousBatchingServer`` (fits-in-memory path) runs the single-step decode over a fixed
pool of KV slots. Sequences live at independent positions (the per-row
``pos`` vector threaded through ``decode_attend``); finished sequences
retire on a stop token or their token budget and the freed slot is
re-prefilled with the next scheduled request — no one is padded to the
longest prompt or decoded past their own budget.

Clock semantics: the virtual clock counts measured host time for
prefill + decode, read from ``obs.clock_span`` (``serve.prefill``,
``serve.decode_step``), which the active tracer also records. A span ends
only once the step's tokens are on the host (``.cpu()``), so it holds the
device's work too. The constructor runs one prefill and one decode
(building the kernels on a card) so that no set-up lands on a request's
latency. The last ``run`` keeps the spans' seconds in ``span_s``
({"serve.prefill": [s, ...], "serve.decode_step": [s, ...]}).

Both servers carry the reference's operations stack: tracer instants
(``serve.shed``, ``serve.queue_wait``, ``serve.retire``), the fault
plan's crash point (``serve.decode``) and clock stalls
(``step_delay``), and the crash-safety knobs of ``run`` (``journal``,
``checkpoint_every``, ``audit_every``, ``resume``; ``recovery/``).

``OffloadedWaveServer`` (memory-constrained path, Sec 3.2) drives the
port's ``OffloadedMoEEngine``: the scheduler picks the next wave of
requests, the mean of their predicted expert scores is prefetched (Eq.
7), and the wave is decoded one request at a time over the shared
resident cache. Its clock advances by the Eq.-3 cost model (demand
misses AND prefetch copies), serial or overlapped, so its latencies are
the reference's exactly for the same counts. The measured seconds are
kept beside it: ``wall_time``, and per request the engine's prefill and
decode wall seconds and decode steps (``span_s``). Its checkpoints
carry the engine's cache state, so a resumed server revives the slab
warm (``engine.revive``).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.offload_engine import HardwareProfile, OffloadedMoEEngine
from ..inference.engine import Request, ServingEngine, truncate_at_stop
from ..inference.sampling import greedy, row_generator, sample_per_row
from ..models.model import decode_step, prefill
from ..faults import get_fault_plan
from ..models.runtime import Runtime
from ..obs.trace import clock_span, get_tracer
from .batch import BatchState
from .metrics import ServerMetrics
from .queue import RequestQueue
from .request import ServeRequest, ServeResult
from .scheduler import FCFSScheduler, Scheduler


def _reject_unservable(queue: RequestQueue, now: float, mt: ServerMetrics,
                       results: List[ServeResult], tr, jr=None) -> None:
    """Admission control: turn bound-overflow and expired-while-queued
    requests into "shed" results — they never reach a slot or wave.
    ``drop_expired`` routes its victims through the queue's shed pool,
    so one drain covers both kinds; identity tells them apart. ``jr``
    (a recovery ``RequestJournal``) makes each shed durable."""
    expired = {id(r) for r in queue.drop_expired(now)}
    queue.enforce_bound(now)
    for r in queue.drain_shed():
        if id(r) in expired:
            mt.requests_expired += 1
        else:
            mt.requests_shed += 1
        if tr.enabled:
            tr.instant("serve.shed", rid=r.rid, expired=id(r) in expired,
                       wait_s=now - r.arrival_time)
        if jr is not None:
            jr.shed(r, expired=id(r) in expired, now=now)
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
        lora_scale: float = 1.0,
        window_override: Optional[int] = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.rt = rt or Runtime(device=self.device, zero_drop=True)
        self.scheduler = scheduler or FCFSScheduler()
        self.n_slots = n_slots
        self.max_len = max_len
        self.lora = lora
        self.lora_scale = lora_scale
        self.window_override = window_override
        self.seed = seed  # request-keyed sampling: row_generator(seed, rid, step)
        self.cache = self._fresh_cache()
        # warm one decode over the pool and one prefill + insert now, so
        # the serving clock never charges the kernel build or first-call
        # set-up to the first requests
        with torch.inference_mode():
            dummy = torch.zeros((n_slots, 1), dtype=torch.long, device=self.device)
            decode_step(params, cfg, dummy, self.cache, self.rt,
                        window_override=window_override, lora=lora,
                        lora_scale=lora_scale)
            self.cache["pos"].zero_()
            _, pre = prefill(params, cfg, dummy[:1], self.rt, n_slots=max_len,
                             window_override=window_override, lora=lora,
                             lora_scale=lora_scale)
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
                           window_override=self.window_override, lora=self.lora,
                           lora_scale=self.lora_scale)
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
            self.rt, n_slots=self.max_len, window_override=self.window_override,
            lora=self.lora, lora_scale=self.lora_scale)
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
            self.cache, self.rt, window_override=self.window_override,
            lora=self.lora, lora_scale=self.lora_scale)
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
        """Serve the queue. Crash-safety knobs (all optional):

        * ``journal`` — a ``recovery.RequestJournal``; every arrival /
          admit / emitted-token watermark / retire / shed lands as a
          flushed JSONL event
        * ``checkpoint_every`` — snapshot + journal rotation every N
          decode steps (requires ``journal``)
        * ``audit_every`` — run the invariant watchdog every N steps
        * ``resume`` — a ``recovery.RecoveredState``; the clock, step
          counter and finished results continue from it (pass
          ``resume.metrics`` as ``metrics`` and a queue built via
          ``resume.build_queue()`` for full continuity)
        * ``on_step`` — liveness hook called after every decode step
          with a dict (step/now/backlog/in_flight/finished/generated)
        * ``should_drain`` — polled each loop iteration; once it
          returns True admission stops, in-flight requests finish, a
          final checkpoint anchors the journal, and ``self.drained``
          is set — still-pending requests stay journaled for a resume
        """
        mt = metrics or ServerMetrics(policy=self.scheduler.name)
        tr = get_tracer()
        plan = get_fault_plan()
        jr = journal
        self.span_s = {"serve.prefill": [], "serve.decode_step": []}
        state = BatchState(self.n_slots, self.max_len)
        cur = np.zeros((self.n_slots, 1), np.int64)
        results: List[ServeResult] = []
        # virtual first-token time per live rid, for TTFT/ITL at retire
        first_tok: dict = {}
        now = 0.0
        step_idx = 0
        wd = None
        if resume is not None:
            now = resume.now
            step_idx = resume.step
            results = list(resume.results)
        if audit_every or resume is not None:
            from ..recovery.audit import Watchdog
            wd = Watchdog(queue=queue, metrics=mt, batch=state,
                          offered_base=resume.offered_base if resume else 0)
            if resume is not None:
                wd.check(in_flight=0)  # trust nothing restored, audited
        if jr is not None:
            for r in queue.pending():
                jr.arrival(r)
        t_wall0 = time.perf_counter()

        def _retire(s: int, reason: str) -> None:
            req = state.slots[s].request
            res = state.retire(s, now, reason)
            attained = False
            if reason == "deadline":
                mt.deadline_retired += 1
            elif req.deadline is None or now <= req.deadline:
                mt.slo_attained += 1
                attained = True
            ft = first_tok.pop(res.rid, None)
            ttft = None if ft is None else ft - res.arrival_time
            itl = (None if ft is None else
                   (now - ft) / max(len(res.tokens) - 1, 1))
            mt.observe_finish(res.latency, ttft=ttft, itl=itl)
            if tr.enabled:
                tr.instant("serve.retire", rid=res.rid, reason=reason,
                           tokens=len(res.tokens))
            if jr is not None:
                jr.retire(res, plen=req.prompt_len, attained=attained,
                          ttft=ttft, itl=itl)
            results.append(res)

        def _checkpoint(inflight) -> None:
            from ..recovery.checkpoint import save_server_checkpoint
            ck = jr.checkpoint_path(step_idx)
            save_server_checkpoint(
                ck, kind="continuous", step=step_idx, now=now, seed=self.seed,
                policy=self.scheduler.name, pending=queue.pending(),
                inflight=inflight, results=results, metrics=mt)
            jr.rotate(ck, step_idx, now)

        self.drained = False
        while len(queue) or state.active_slots():
            draining = should_drain is not None and should_drain()
            # -- admission control: shed what can't be served -----------
            _reject_unservable(queue, now, mt, results, tr, jr)
            # -- admission: scheduler fills freed slots -----------------
            free = state.free_slots() if not draining else []
            if free:
                ready = queue.ready(now)
                if ready:
                    order = self.scheduler.order(ready, hot=state.active_requests())
                    for slot, req in zip(free, order):
                        queue.admit(req)
                        if tr.enabled:
                            tr.instant("serve.queue_wait", rid=req.rid,
                                       wait_s=now - req.arrival_time)
                        # prefill is service time: the clock_span both
                        # advances the serving clock and (when tracing)
                        # records the same interval as a span
                        with clock_span("serve.prefill", rid=req.rid,
                                        prompt_len=req.prompt_len) as cs:
                            reason = self._admit(state, slot, req, cur, now, mt)
                        self.span_s["serve.prefill"].append(cs.dur)
                        now += cs.dur
                        # the first token materializes with the prefill
                        first_tok[req.rid] = now
                        if jr is not None:
                            jr.admit(req.rid, now)
                            jr.watermark({req.rid: [int(cur[slot, 0])]}, now)
                        if reason is not None:
                            _retire(slot, reason)
                        elif req.deadline is not None and now >= req.deadline:
                            # earlier admissions' prefills ate the budget
                            _retire(slot, "deadline")
            active = state.active_slots()
            if not active:
                if draining:
                    break  # nothing in flight: pending stays journaled
                # idle: jump the virtual clock to the next arrival
                nxt = queue.next_arrival()
                if nxt is not None:
                    now = max(now, nxt)
                continue

            # injected crash: raises InjectedCrash between steps — the
            # journal is flushed through the last completed step, so
            # recovery resumes exactly here
            if plan.enabled:
                plan.maybe_crash("serve.decode")

            # -- one decode step over the whole slot pool ---------------
            with clock_span("serve.decode_step", active=len(active),
                            slots=self.n_slots) as cs:
                toks_np = self._decode(state, cur, active)
            self.span_s["serve.decode_step"].append(cs.dur)
            # charge the step (plus any injected scheduler hiccup) before
            # retiring
            now += cs.dur + plan.step_delay()

            step_toks: dict = {}
            retire_now: List[Tuple[int, str]] = []
            for s in active:
                state.slots[s].decode_steps += 1
                tok = int(toks_np[s, 0])
                cur[s, 0] = tok
                mt.generated_tokens += 1
                step_toks[state.slots[s].request.rid] = [tok]
                reason = state.append_token(s, tok)
                if reason is None:
                    dl = state.slots[s].request.deadline
                    if dl is not None and now >= dl:
                        reason = "deadline"
                if reason is not None:
                    retire_now.append((s, reason))
            mt.observe_step(len(active), self.n_slots, queue.backlog(now))
            # watermark BEFORE the retires so replay sees tokens first
            if jr is not None:
                jr.watermark(step_toks, now)
            for s, reason in retire_now:
                _retire(s, reason)

            step_idx += 1
            if on_step is not None:
                on_step({"step": step_idx, "now": now,
                         "backlog": queue.backlog(now),
                         "in_flight": len(state.active_slots()),
                         "finished": mt.requests_finished,
                         "generated": mt.generated_tokens})
            if wd is not None and audit_every and step_idx % audit_every == 0:
                wd.check(in_flight=len(state.active_slots()))
            if jr is not None and checkpoint_every and step_idx % checkpoint_every == 0:
                # a slot's absolute watermark is its generated list; the
                # record folds the resumed prefix in itself, so hand it
                # only the tokens emitted THIS incarnation
                _checkpoint([(state.slots[s].request,
                              state.slots[s].generated[state.slots[s].request.n_resumed:])
                             for s in state.active_slots()])

        _reject_unservable(queue, now, mt, results, tr, jr)
        self.drained = should_drain is not None and should_drain()
        if jr is not None and self.drained:
            # final drain checkpoint: everything finished or pending is
            # anchored, so a later resume picks up exactly here
            _checkpoint([])
        mt.wall_time += time.perf_counter() - t_wall0
        return sorted(results, key=lambda r: r.rid), mt


# ---------------------------------------------------------------------------
# Offloaded path: scheduler-driven prefetch between batch waves
# ---------------------------------------------------------------------------


class OffloadedWaveServer:
    """Wave scheduling over the offloaded expert cache (Sec 3.2).

    Requests are served greedily in scheduler order, ``wave_size`` at a
    time; before each wave the mean of the wave's predicted expert
    scores is prefetched so the resident set matches the co-scheduled
    requests. The expert cache (and its residency) persists across
    waves — that persistence is exactly what the affinity policy
    exploits. The serving clock advances by the Eq. 3 cost model:
    serial by default, or the engine's overlapped clock with
    ``overlap=True``; both cumulative modeled times are reported either
    way. ``engine_kw`` goes to the engine as it is (``device``,
    ``kernel_backend``, ``host_store``, ``quantized_experts``,
    ``little_bank``, ...). With ``little_experts`` each request's
    ``quality`` dial and its SLO's deadline pressure send misses to the
    engine's low-rank little tier; ``fetch_policy`` is the engine's retry
    budget under an installed fault plan. ``engine_impl="dict"`` serves
    through the per-expert engine."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        capacity: int,
        policy: str = "lfu",
        gamma: float = 0.9,
        scheduler: Optional[Scheduler] = None,
        wave_size: int = 4,
        quantized: bool = False,
        hw: HardwareProfile = HardwareProfile(),
        use_prefetch: bool = True,
        lora=None,
        lora_scale: float = 1.0,
        overlap: bool = False,
        engine_impl: str = "slab",
        little_experts: bool = False,
        little_rank: int = 8,
        little_quantized: bool = False,
        fetch_policy=None,
        pressure_frac: float = 0.75,
        max_backlog: Optional[int] = None,
        seed: int = 0,
        **engine_kw,
    ):
        self.cfg = cfg
        self.seed = seed
        self.scheduler = scheduler or FCFSScheduler()
        self.wave_size = wave_size
        self.hw = hw
        self.use_prefetch = use_prefetch
        self.overlap = overlap
        self.max_backlog = max_backlog
        self.engine = OffloadedMoEEngine(
            cfg, params, capacity=capacity, policy=policy, gamma=gamma,
            quantized=quantized, hw=hw, lora=lora, lora_scale=lora_scale,
            impl=engine_impl, little_experts=little_experts,
            little_rank=little_rank, little_quantized=little_quantized,
            fetch_policy=fetch_policy, pressure_frac=pressure_frac, **engine_kw)

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
        """Serve the queue, one wave at a time. Same crash-safety knobs as
        :meth:`ContinuousBatchingServer.run`, on wave granularity:
        checkpoints land every ``checkpoint_every`` waves (with the
        engine's cache state for warm revival; in-flight is always empty,
        a request is atomic within a wave), the watchdog runs every
        ``audit_every`` waves, ``on_step`` fires once per completed wave,
        and ``should_drain`` stops scheduling further waves (the current
        one finishes, a final checkpoint anchors the journal, and
        ``self.drained`` is set). Revive the engine
        (``engine.revive(resume.engine["cache"])`` after restoring
        ``engine.metrics``) before calling run with ``resume``."""
        mt = metrics or ServerMetrics(policy=self.scheduler.name)
        tr = get_tracer()
        plan = get_fault_plan()
        eng = self.engine
        em = eng.metrics
        jr = journal
        # measured per request (device synchronized): prefill s, decode s
        # and decode steps of its generate call
        self.span_s = {"serve.prefill": [], "serve.decode": [], "decode_steps": []}
        results: List[ServeResult] = []
        now = 0.0
        wave_idx = 0
        wd = None
        if resume is not None:
            now = resume.now
            wave_idx = resume.step
            results = list(resume.results)
        if audit_every or resume is not None:
            from ..recovery.audit import Watchdog
            wd = Watchdog(queue=queue, metrics=mt, engine=eng,
                          offered_base=resume.offered_base if resume else 0)
            if resume is not None:
                wd.check(in_flight=0)  # trust nothing restored, audited
        if jr is not None:
            for r in queue.pending():
                jr.arrival(r)
        t_wall0 = time.perf_counter()
        prev_wave: List[ServeRequest] = []
        if self.max_backlog is not None:
            queue.set_bound(self.max_backlog)

        def _checkpoint() -> None:
            from ..recovery.checkpoint import save_server_checkpoint
            ck = jr.checkpoint_path(wave_idx)
            save_server_checkpoint(
                ck, kind="wave", step=wave_idx, now=now, seed=self.seed,
                policy=self.scheduler.name, pending=queue.pending(), inflight=[],
                results=results, metrics=mt,
                engine={"cache": eng.cache_state(), "metrics": em.state()})
            jr.rotate(ck, wave_idx, now)

        self.drained = False
        while len(queue):
            if should_drain is not None and should_drain():
                break
            # -- admission control: shed what can't be served -----------
            _reject_unservable(queue, now, mt, results, tr, jr)
            if not len(queue):
                break
            ready = queue.ready(now)
            if not ready:
                now = max(now, queue.next_arrival())
                continue
            order = self.scheduler.order(ready, hot=prev_wave)
            wave = order[: self.wave_size]
            mt.observe_queue_depth(queue.backlog(now))
            # injected scheduling hiccup (traffic burst / host jitter)
            now += plan.step_delay()

            if self.use_prefetch:
                scored = [r.expert_scores for r in wave if r.expert_scores is not None]
                if scored:
                    # prefetch copies are real link traffic: charged to the
                    # wave on the same Eq. 3 terms as demand misses (they
                    # precede the wave, so neither clock hides them), with
                    # any spike/retry stall injected during the prefetch
                    p_tx0, p_b0, fd0 = (em.prefetch_transfers, em.prefetch_bytes,
                                        em.fault_delay_s)
                    eng.prefetch(np.mean(scored, axis=0))
                    dt = ((em.prefetch_bytes - p_b0) / self.hw.host_link_bw
                          + (em.prefetch_transfers - p_tx0) * self.hw.transfer_latency
                          + (em.fault_delay_s - fd0))
                    now += dt
                    mt.modeled_time_serial += dt
                    mt.modeled_time_overlapped += dt

            for req in wave:
                queue.admit(req)
                if jr is not None:
                    jr.admit(req.rid, now)
                if tr.enabled:
                    tr.instant("serve.queue_wait", rid=req.rid,
                               wait_s=now - req.arrival_time)
                start = now
                before_s = em.modeled_time(self.hw)
                step0 = len(em.step_flops)
                host0 = em.host_time
                deg0 = em.degraded_uses
                # SLO budget left on the engine's own (serial) clock
                deadline_s = (None if req.slo is None
                              else max(req.deadline - now, 0.0))
                # a request resumed from a crash re-prefills up to its
                # journaled watermark and only generates the remainder
                inp = (req.prompt if req.resumed is None else
                       np.concatenate([req.prompt, req.resumed]).astype(np.int32))
                res = eng.generate(inp[None, :],
                                   max_new_tokens=req.max_new_tokens - req.n_resumed,
                                   quality=req.quality, deadline_s=deadline_s)
                d_serial = em.modeled_time(self.hw) - before_s
                # delta over only this request's recorded steps
                d_overlap = em.overlapped_span(self.hw, step0) + em.host_time - host0
                # the prefill step alone (step0) dates the first token on
                # whichever Eq.-3 clock drives this server's time
                d_first = (em.overlapped_span(self.hw, step0, step0 + 1) if self.overlap
                           else em.serial_span(self.hw, step0, step0 + 1))
                em.drop_step_records(self.hw)  # consumed
                self.span_s["serve.prefill"].append(em.prefill_wall_time)
                self.span_s["serve.decode"].append(em.decode_wall_time)
                self.span_s["decode_steps"].append(int(res["tokens"].shape[1]) - 1)
                mt.modeled_time_serial += d_serial
                mt.modeled_time_overlapped += d_overlap
                now += d_overlap if self.overlap else d_serial
                new = res["tokens"][0].cpu().numpy()
                full = (new if req.resumed is None else
                        np.concatenate([req.resumed, new]))
                toks, reason = truncate_at_stop(full, req.stop_tokens)
                if res["stopped_early"] and reason == "length":
                    reason = "deadline"  # cut mid-decode at the SLO
                degraded = em.degraded_uses > deg0
                first_tok_time = start + d_first
                # the resumed prefix was generated (and counted) before the
                # crash; only this incarnation's tokens count here
                n_new = len(toks) - req.n_resumed
                mt.generated_tokens += n_new
                mt.prefill_tokens += len(inp)
                mt.decode_steps += n_new
                ttft = first_tok_time - req.arrival_time
                itl = (now - first_tok_time) / max(len(toks) - 1, 1)
                mt.observe_finish(now - req.arrival_time, ttft=ttft, itl=itl)
                attained = False
                if reason == "deadline":
                    mt.deadline_retired += 1
                elif req.slo is None or now <= req.deadline:
                    mt.slo_attained += 1
                    attained = True
                if degraded:
                    mt.degraded_requests += 1
                if tr.enabled:
                    tr.instant("serve.retire", rid=req.rid, reason=reason,
                               tokens=len(toks))
                result = ServeResult(
                    rid=req.rid, tokens=toks, finish_reason=reason,
                    arrival_time=req.arrival_time, start_time=start,
                    finish_time=now, decode_steps=n_new, degraded=degraded)
                if jr is not None:
                    # watermark BEFORE retire so replay sees tokens first
                    jr.watermark({req.rid: [int(t) for t in toks[req.n_resumed:]]}, now)
                    jr.retire(result, plen=len(inp), attained=attained,
                              ttft=ttft, itl=itl)
                results.append(result)
            prev_wave = wave

            wave_idx += 1
            if on_step is not None:
                on_step({"step": wave_idx, "now": now,
                         "backlog": queue.backlog(now), "in_flight": 0,
                         "finished": mt.requests_finished,
                         "generated": mt.generated_tokens})
            if wd is not None and audit_every and wave_idx % audit_every == 0:
                wd.check(in_flight=0)
            if jr is not None and checkpoint_every and wave_idx % checkpoint_every == 0:
                _checkpoint()

        _reject_unservable(queue, now, mt, results, tr, jr)
        self.drained = should_drain is not None and should_drain()
        if jr is not None and self.drained:
            _checkpoint()
        stats = eng.cache.stats()
        mt.transfers = em.transfers
        mt.transfer_bytes = em.transfer_bytes
        mt.prefetch_transfers = em.prefetch_transfers
        mt.cache_hits, mt.cache_misses = stats.hits, stats.misses
        mt.modeled_time = now
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
