"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

From the root of a checkout, with CUDA available:

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds the Hopper kernels from ``src/repro_torch/kernels/*/csrc``;
3. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes, in bf16 and fp32, and times kernel, plain
   version and one library call (a yardstick the port never calls);
   kernels and library calls are timed as CUDA graphs (device time),
   plain versions and ``eager_ms`` eagerly. Every case reports the route it
   took and, where that is a fast route (tensor cores, or ``int4_matmul``'s
   split-K stream), the kept CUDA-core kernel's time at the same case
   (``fma_ms``); a repeated run must give equal bits. ``int4_matmul`` is
   also timed against ``torch._weight_int4pack_mm`` where the card's torch
   has it (``library_int4pack_ms``, a time only);
4. serves 4 x (128 + 32) tokens of full-width OLMoE-1B-7B (random
   weights from a seed) through ``repro_torch.launch.serve.run`` with the
   launch counters set to 0 just before, asserts the path's launch totals
   (``PATH_LAUNCHES``) and that every ``moe_gmm`` and ``flash_attn`` launch
   took a tensor-core route (``FAST_ROUTES``), and holds the prefill
   logits against a run of the same prompts through the plain versions
   (``kernel_backend="ref"``);
5. serves the same batch again with HQQ INT4 experts (``quantized=True``,
   paper Sec 3.2), counters set to 0 just before, asserts its launch
   totals and routes as for step 4 (``int4_matmul`` per phase too: "tc"
   in prefill, "stream" in decode), and holds its prefill logits against a
   plain run on the same INT4 codes;
   the INT4-vs-bf16 logits difference is printed, not gated (it is the
   quantization error);
6. frees the OLMoE runs, then serves full-width zamba2-7b and mamba2-130m
   (bf16, random weights from seed 0) through the full-model path,
   ``repro_torch.launch.serve.run_full``: 4 x (512 + 32) tokens each,
   prefill and the decode loop timed to a device synchronize, counters
   set to 0 just before each model. It asserts the launches of one prefill
   (zamba2: 68 ``ssd_scan`` and 13 ``flash_attn``; mamba2: 24
   ``ssd_scan``; decode none; both on the tensor-core routes),
   that ``ServingEngine.generate_batch``
   gives the same tokens, and holds the prefill logits against plain
   prefills on the same weights (``kernel_backend="ref"``): in fp32 first,
   then in bf16 within a fixed limit per model and against the plain
   path's own bf16 round-off (see ``FP32_LOGITS_REL_TOL``);
7. frees those models, then serves full-width OLMoE-1B-7B whole on the
   card (bf16, random weights from seed 0) through the continuous-batching
   server, ``repro_torch.serving.ContinuousBatchingServer`` (fcfs, 4 slots,
   8 requests of 128 prompt tokens arriving at once, budgets 8, 32, 16, 24
   twice over, so slots free and refill mid-flight), counters set to 0
   after the server's constructor (its warm-up launches kernels too), just
   before ``run``. It asserts the launches (``flash_attn`` 16 per prefill
   on "tc"; ``moe_gmm`` 48 per prefill on "tc" and 48 per decode step on
   "stream"), holds the first request's prefill logits against the plain
   versions (``LOGITS_REL_TOL``), and, with the weights in fp32, that the
   server gives 4 of the requests the tokens of ``ServingEngine`` at batch
   1 (the bf16 agreement is printed, not gated); it prints throughput,
   latency, TTFT, ms per decode step and peak memory against the weight
   bytes;
8. frees that model, then serves full-width OLMoE-1B-7B offloaded behind
   ``repro_torch.serving.OffloadedWaveServer`` (bf16, random weights from
   seed 0, LoRA rank 32 / alpha 16 on every MoE layer with ``b`` drawn
   N(0, 1/r)), C = 16, policy gamma, waves of 4: the continuous phase's 8
   requests, their affinity scores the oracle ``prefill_expert_scores`` of
   the same model and LoRA (the whole model on the card, then freed). One
   fresh server per policy (fcfs, expert-affinity with top-C 16; the
   pinned expert store built once and shared), counters set to 0 just
   before each ``run``. It asserts launch totals (``PATH_LAUNCHES``) and
   routes, equal tokens under both policies, and, on the first request's
   prefill logits: kernels against plain versions in fp32 on the same
   weights within ``FP32_LOGITS_REL_TOL`` and in bf16 within
   ``WAVE_BF16_LOGITS_REL_TOL``, the adapters against ``merge_lora``'d
   experts without them (fp32) within ``FP32_LOGITS_REL_TOL``, while the
   engines without LoRA are more than ``LORA_MOVES`` x
   ``LOGITS_REL_TOL`` from them. It prints each policy's
   ``ServerMetrics`` summary (both Eq.-3 clocks, transfers, prefetch
   transfers, hit rate, latency and TTFT on the modeled clock), wall
   seconds, tokens per wall second, ms per decode step and peak device
   memory against slab and LoRA bytes;
9. serves full-width DeepSeek-MoE-16B (bf16, random weights from seed 0;
   a dense first layer, 27 MoE layers with 2 shared experts) offloaded
   through ``repro_torch.launch.serve.run``: C = 16, batch 4, prompt 128,
   32 new tokens, counters set to 0 just before; asserts launches per
   phase and route and holds the prefill logits against the plain
   versions, in fp32 first (``FP32_LOGITS_REL_TOL``), then in bf16
   (``DEEPSEEK_BF16_LOGITS_REL_TOL``);
10. writes a params-only checkpoint of olmoe-mini-smoke with the port's
   ``save_checkpoint``, serves it with ``launch.serve --ckpt`` on the card
   and asserts the tokens of the in-memory run;
11. serves step 4's batch again through ``launch.serve.run(...,
   predictor=True)``: the whole model on the card traces 32 more prompts
   (``routing_trace``, 16 new tokens each), the activation predictor Psi
   is trained on them, the traced model is freed, and the engine
   prefetches Psi's scores; counters set to 0 just before. Gates: Psi's KL
   falls, prefetch transfers > 0, tokens equal step 4's; it prints
   transfers and hit rate with and without Psi;
12. the gradient gate: full-width OLMoE cut to 2 layers in fp32 (random
   weights from seed 0, LoRA ``b`` ~ N(0, 1/r)), one fine-tune loss and
   its gradients (router, expert wg, LoRA a/b) through the kernels
   (``TRAIN_KERNEL_BACKEND``: ``moe_gmm`` forward and backward,
   ``GmmFn``) and through the plain versions, per leaf ||delta|| / ||ref||
   <= ``GRAD_REL_TOL``, with exact launch counts; then ``GmmFn``'s
   backward against ``gmm_ref`` under autograd at the fine-tune's shapes
   (E 64, capacity 160) in bf16 and fp32, the ``dA`` and ``dB`` products
   timed with their bounds, the transposed copies and ``torch.bmm`` at
   the same shapes, and a capacity that is not a multiple of 8 (157),
   whose ``dB`` leaves "tc" for "fma";
13. the MELINOE fine-tune of full-width, full-depth OLMoE-1B-7B in bf16
   (random base from seed 0), ``training.melinoe_finetune``, 4 steps at
   batch 8 x 128 tokens of the synthetic ClusterLM corpus, counters set to
   0 just before: the step-0 loss through the kernels against the plain
   versions (``FINETUNE_LOSS_REL_TOL``), ``moe_gmm`` launches per step and
   route exactly (48 forward, 46 dA, 48 dB, all "tc"), no ``flash_attn``,
   every loss finite; it prints ms per step, tokens per second, the
   cache-simulation scan's share of a step, loss / nll / cs / rm per step,
   and peak device memory against the bytes of weights, trainable copies,
   LoRA, gradients and moments;
14. runs ``python -m repro_torch.launch.train --arch olmoe-mini --mode
   both`` for a few steps on the card and reads both checkpoints back
   (the ``_melinoe`` one as ``(params, lora)``);
15. the paper's comparison systems (Sec 4.2, Fig 3): step 4's batch and
   weights through every ``core.baselines.BASELINES`` entry via
   ``make_engine`` (C = 16; the bf16 ones on one pinned store, quant_cache
   INT4 at C = 48 quantized here, melinoe prefetching step 11's Psi
   scores), counters set to 0 just before each serve. It prints one row
   per baseline (transfers, ``host_executed``, hit rate, both Eq.-3 clocks
   and modeled tok/s, measured prefill s and decode tok/s, peak memory,
   launches by phase and route) and asserts: ``stream_all`` charges
   exactly layers x top-k x (4 x 128 + 4 x 31) transfers; ``cpu_execute``
   charges none and host-executes exactly ``static_lfu``'s transfers;
   every bf16 baseline gives step 4's tokens; launch totals by phase and
   route (``BASELINE_GMM``: tensor-core routes only; the empty slab of
   stream_all and cpu_execute launches nothing, their prefill overflow
   group holds all 64 experts); ``stream_all``'s prefill logits against a
   plain run within ``LOGITS_REL_TOL``;
16. the little-expert tier on the same batch and weights: a rank-8 bank
   (fp32 factors, ``LITTLE_BANK_BYTES``) built on the card, printed with
   its build seconds; served at quality 1.0 (the bank is inert: step 4's
   tokens, transfers and launches), 0.5 and 0.0 (no transfer, little
   substitutions, a lower modeled clock), then under a deadline of half
   the quality-1.0 run's serial modeled seconds (the prefill spends it:
   the call stops after the prefill) and under one that the prefill and
   the first decode step take past ``pressure_frac`` of (deadline
   pressure: every later miss goes little, uncharged, and the call runs
   to its end inside its budget); each run's prefill-logits distance
   from the exact run and decode tok/s are printed, not gated; then
   ``launch.bench_serve
   --offloaded --little --quality 0.5`` at full width (4 requests), whose
   summary must count degraded requests;
17. the operations stack (``obs/``, ``faults/``, ``recovery/``) on phase
   15's weights, pinned store and batch (phase 4's): (a) the batch served
   with tracing on, bf16 and INT4 (phase 5's codes, quantized again from
   the store): tokens, transfers and launches by route equal to phases 4
   and 5, the Chrome trace valid (``obs.validate``), ``reconcile``'s
   per-layer table and ``ok`` printed, the split of a decode step and of
   the prefill into ``moe.fetch``, ``moe.compute``, ``moe.spillover``,
   ``moe.account``, ``moe.pre`` and the rest, the host -> device expert
   copies, traced against untraced decode tok/s; (b) the engine under a
   transient fetch-failure plan with the naive policy (phase 4's tokens
   and transfers, ``fetch_failures`` > 0, a serial clock >= phase 4's)
   and under eviction storms (phase 4's tokens, more transfers), each
   ``audit()`` empty; (c) the crash-safe wave server on the wave phase's 8
   requests (waves of 4, C = 16, no LoRA): journaled, checkpointed and
   audited every wave, crashed mid-serve by ``crash_at``, then resumed
   warm and, from a copy of the journal, cold: every request finishes
   with the uninterrupted run's tokens (the wave server re-generates a
   request whole, and residency never enters the arithmetic), the
   watchdog finds nothing, warm revival loads the checkpointed resident
   count and the warm-resumed run pays exactly the uninterrupted run's
   demand transfers after the checkpoint (cold's are printed beside);
   on the checkpoint's own traffic (wave 1's last prompt re-prefilled on
   engines revived from the snapshot) warm pays fewer than cold;
   (d) ``launch.bench_serve --offloaded --trace DIR`` at full width (the
   trace, metrics and ``reconcile.json`` written, the trace valid), and
   ``--journal DIR --faults crash_at=10`` (the injected-crash exit) then
   ``--resume`` on the continuous path in fp32, whose tokens must equal
   an uninterrupted run's (a resumed request re-prefills its prompt and
   watermark; only in fp32 is that the arithmetic of its uninterrupted
   decode);
18. prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Any failure raises (non-zero exit, no result line). Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): memory rate and arithmetic rates.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: no tensor cores

# |kernel - plain| <= atol + rtol * |plain|. fp32: both accumulate in fp32,
# only the summation order differs. bf16: the output is rounded to bf16
# (8-bit mantissa), so the two may differ by about one ulp (2^-7 relative).
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2**-7, atol=1.6e-2)}
# ssd_scan against its plain version, the sequential recurrence: the
# chunked form takes each decay as exp(sum) instead of a product of exps,
# a few ulp per step, carried through the state (the tolerance of the
# JAX package's chunked-vs-sequential test). y in bf16 as for TOL; the
# final state is fp32 at any input type.
TOL_SSD = {torch.float32: dict(rtol=1e-3, atol=5e-4),
           torch.bfloat16: TOL[torch.bfloat16]}
# prefill logits of the kernel run vs the plain run, both bf16 end to end:
# ||delta|| / ||plain|| over the (B, V) logits. bf16 activations round at
# every layer (2^-8 relative) and the sums run in another order, through
# 16 layers with residual adds.
LOGITS_REL_TOL = 2e-2
# The full-model phase (81 and 24 layers, random weights) is held first in
# fp32 at full width, kernel run vs plain run: only the summation order
# differs, through every layer.
FP32_LOGITS_REL_TOL = 1e-4
# In bf16 any change of summation order, by either kernel alone, moves
# these logits about as far as bf16 round-off itself does, so 2e-2 cannot
# hold for zamba2's 81 layers. Fixed per model, between the sound kernels'
# readings on the H100 (zamba2 0.0418, mamba2 0.0190) and what a wrong
# rounding gives (zamba2: the plain bf16 run is 0.0503 from fp32 on the
# same weights; rounding y before the D skip moved it 0.0519 in
# tools/roundoff.py).
BF16_FULL_LOGITS_REL_TOL = {"zamba2-7b": 4.5e-2, "mamba2-130m": LOGITS_REL_TOL}
# bf16 accuracy: the kernel run no farther from fp32 than the plain bf16
# run, up to this factor (a second rounding inside a kernel, as of y
# before the D skip, would add its own round-off and exceed it).
ACCURACY_RATIO = 1.25
# Kernel launches of each serve path, counted from 0 just before it, and
# the routes that the bf16 launches of moe_gmm and flash_attn must take:
# the tensor-core ones. Every total but one is fixed by the path's shape
# (per layer-step: 3 gmm for the slab group and 3 for the overflow group;
# one flash per attention layer of the prefill). The INT4 path's
# int4_matmul total (None) is 3 per spilled expert, and which experts
# spill follows the random model's routing, which moves with any change
# of rounding in the kernels before it (17,682 with the CUDA-core bf16
# kernels); it must be a positive multiple of 3.
PATH_LAUNCHES = {
    "bf16": {"moe_gmm": 3072, "flash_attn": 16, "int4_matmul": 0},
    "int4": {"moe_gmm": 1536, "flash_attn": 16, "int4_matmul": None},
    "zamba2-7b": {"ssd_scan": 68, "flash_attn": 13},
    "mamba2-130m": {"ssd_scan": 24, "flash_attn": 0},
    # the wave server, one request at a time: per prefill (128 tokens, which
    # route to more than C = 16 of the 64 experts in every layer) 16 flash
    # and 6 gmm a layer (slab and overflow groups, "tc"); per decode step (1
    # token: its 8 experts always fit the slab) 3 gmm a layer ("stream"):
    # 8 prefills and 152 decode steps, under either policy
    "wave-olmoe-fcfs": {"moe_gmm": 8 * 96 + 152 * 48, "flash_attn": 128,
                        "int4_matmul": 0},
    "wave-olmoe-affinity": {"moe_gmm": 8 * 96 + 152 * 48, "flash_attn": 128,
                            "int4_matmul": 0},
    # deepseek, batch 4: one flash per attention layer (28) in prefill; gmm
    # 6 a MoE layer in prefill (all 64 experts: slab and overflow, "tc"),
    # then 3 a layer-step for the slab group and 3 more where the step's
    # up to 24 routed experts overflow C = 16, which follows the routing
    # ("stream"; a multiple of 3, at least 31 x 81)
    "deepseek-offloaded": {"moe_gmm": None, "flash_attn": 28, "int4_matmul": 0},
}
FAST_ROUTES = {"moe_gmm": ("stream", "tc"), "flash_attn": ("tc",),
               "int4_matmul": ("stream", "tc"), "ssd_scan": ("tc",)}
# The INT4 path's int4_matmul launches by phase: prefill multiplies all
# 512 prompt tokens ("tc"), decode the batch's 4 rows ("stream").
INT4_PHASE_ROUTES = {"prefill": ("tc",), "decode": ("stream",)}
# deepseek's moe_gmm launches by phase and route: prefill exactly 27 x 6
# on "tc"; decode only "stream", at least the slab group's 31 x 27 x 3
DEEPSEEK_PREFILL_GMM = {"tc": 27 * 6}
DEEPSEEK_DECODE_GMM_MIN = 31 * 27 * 3
# The wave phase's LoRA: b ~ N(0, 1/r) (r = 32), so that scale * a @ b is
# about the size of the expert weights themselves (b = N(0, 1/(4r)) moved
# OLMoE's first prefill logits 0.068 from the engine without LoRA, on an
# H100 80GB HBM3 at 700 W). The engine without LoRA must be farther than
# LORA_MOVES x LOGITS_REL_TOL from the LoRA engines' logits, so a dropped
# LoRA term fails the run.
LORA_B_STD = 32**-0.5
LORA_MOVES = 5
# The LoRA'd OLMoE's bf16 kernel run against its plain run: the adapters
# make the random model amplify round-off more (b = N(0, 1/r): 0.0206;
# N(0, 1/(4r)): 0.0096; H100 80GB HBM3, 700 W), so LOGITS_REL_TOL cannot hold at the
# LoRA strength the movement gate needs. The same pair is held in fp32 on
# the same weights to FP32_LOGITS_REL_TOL, where only the order of sums
# differs; a wrong kernel or LoRA term moves these logits by O(1).
WAVE_BF16_LOGITS_REL_TOL = 3e-2
# deepseek's 28 random bf16 layers: the kernel run read 0.0288 from the
# plain run (H100 80GB HBM3, 700 W), as zamba2's 81 layers read 0.0418 (its limit
# 4.5e-2); held first in fp32 at full width and depth to
# FP32_LOGITS_REL_TOL, where only the order of sums differs.
DEEPSEEK_BF16_LOGITS_REL_TOL = 4e-2
# The MELINOE fine-tune (phases 12-13): batch 8 x 128 tokens, 4 steps.
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 128, 4
# fp32 gradients of the 2-layer full-width fine-tune, kernels against plain
# versions, per leaf: only the order of sums differs (as FP32_LOGITS_REL_TOL).
GRAD_REL_TOL = 1e-4
# The full-depth bf16 fine-tune's step-0 loss, kernels against plain versions,
# relative. Its logits differ as the whole-model prefill's do (up to
# LOGITS_REL_TOL in norm, bf16 round-off through 16 layers), but the loss is
# a mean over 1024 tokens of per-token NLL errors of either sign (about 0.02
# each on O(1) logits, so about 6e-4 / 10.8 = 6e-5 relative), plus the cs
# and rm terms, which see only the router distributions.
FINETUNE_LOSS_REL_TOL = 1e-3
# The paper's comparison systems (phase 15) on the main path's batch and
# weights, C = 16. moe_gmm per layer-step: 6 where the step's experts fill
# the slab and overflow it (every step of this batch: 64 experts in the
# prefill, 25-28 in each decode step against C = 16), 3 where only one
# group set serves (stream_all and cpu_execute keep the slab empty: the
# overflow group alone, all 64 experts in the prefill; quant_cache's INT4
# slab at C = 48, its spilled experts on int4_matmul), by phase and route.
BASELINE_GMM = {"six": {"prefill": {"tc": 16 * 6}, "decode": {"stream": 31 * 16 * 6}},
                "three": {"prefill": {"tc": 16 * 3}, "decode": {"stream": 31 * 16 * 3}}}
BASELINE_SETS = {"static_lru": "six", "static_lfu": "six", "profile_prefetch": "six",
                 "melinoe": "six", "stream_all": "three", "cpu_execute": "three",
                 "quant_cache": "three"}
for _name, _sets in BASELINE_SETS.items():
    PATH_LAUNCHES[f"baseline-{_name}"] = {
        "moe_gmm": sum(n for ph in BASELINE_GMM[_sets].values() for n in ph.values()),
        "flash_attn": 16, "int4_matmul": None if _name == "quant_cache" else 0}
# The little tier (phase 16): at quality 1.0 the bank is inert, so the
# launches are the main path's.
PATH_LAUNCHES["little-q1.0"] = PATH_LAUNCHES["bf16"]
# rank-8 fp32 factors of OLMoE's 16 layers: 3 projections x
# (64 x 2048 x 8 + 64 x 8 x 1024) x 4 B a layer
LITTLE_RANK = 8
LITTLE_BANK_BYTES = 16 * 3 * (64 * 2048 * 8 + 64 * 8 * 1024) * 4


def check_path(path: str, launches: dict, routes: dict) -> None:
    """Launch totals of a serve path as PATH_LAUNCHES says, every bf16
    launch of each op on its fast route (FAST_ROUTES)."""
    want = PATH_LAUNCHES[path]
    got = {op: launches[op] for op in want}
    if any(got[op] != n if n is not None else got[op] <= 0 or got[op] % 3
           for op, n in want.items()):
        raise AssertionError(f"{path}: launches {got}, want {want}")
    for op, fast in FAST_ROUTES.items():
        off = {r: n for r, n in routes[op].items() if r not in fast}
        if off or sum(routes[op].values()) != launches[op]:
            raise AssertionError(f"{path}: {op} launches {launches[op]} by route "
                                 f"{routes[op]}, want all on {fast}")
    print(f"{path}: launches {got}, routes {routes}")


def time_ms(fn, reps: int = 20, warmup: int = 3, graph: bool = True) -> float:
    """Mean device milliseconds per call. With ``graph`` the ``reps`` calls
    are captured once into a CUDA graph, which is replayed between two
    events: the device's time alone. The launch cost of a Python wrapper
    (tens of microseconds, and it moves with the host's CPU from machine
    to machine) is not in it. Without ``graph``: ``reps`` back-to-back eager
    calls between two events, the host's dispatch included wherever it is
    slower than the device (the plain versions, and ``eager_ms``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, dtype) -> tuple:
    """Least time the card could take: max(bytes / HBM rate, ops / peak)."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, out, ref, tol) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), **tol):
        raise AssertionError(f"{name}: kernel disagrees with plain, max abs err {err}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    return err


def route_of(op, fn):
    """Call ``fn`` once and return the route its one launch took."""
    from repro_torch.kernels import dispatch

    before = dict(dispatch.ROUTE_LAUNCHES[op])
    fn()
    after = dispatch.ROUTE_LAUNCHES[op]
    (which,) = [r for r in after if after[r] != before.get(r, 0)]
    return which


def gmm_cases(gen):
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for N in (1, 4, 512):
            for K, F in ((2048, 1024), (1024, 2048)):
                E = 16
                sizes = torch.randint(0, N + 1, (E,), generator=gen, device="cuda",
                                      dtype=torch.int32)
                sizes[::5] = 0  # some empty slots
                a = torch.randn(E, N, K, generator=gen, device="cuda")
                a = (a * (torch.arange(N, device="cuda")[None, :, None]
                          < sizes[:, None, None])).to(dtype)
                b = (torch.randn(E, K, F, generator=gen, device="cuda")
                     * K**-0.5).to(dtype)
                cases.append(gmm_case(a, b, sizes, dtype))
        # the full-model path's MoE layer (E = 64, top-8, zero_drop): the
        # decode pool's 4 rows and one 128-token prefill, with the group
        # sizes a real route gives
        for M in (4, 128):
            eids = torch.randn(M, 64, generator=gen, device="cuda").topk(8, dim=-1).indices
            sizes = torch.bincount(eids.reshape(-1), minlength=64).to(torch.int32)
            for K, F in ((2048, 1024), (1024, 2048)):
                a = torch.randn(64, M, K, generator=gen, device="cuda")
                a = (a * (torch.arange(M, device="cuda")[None, :, None]
                          < sizes[:, None, None])).to(dtype)
                b = (torch.randn(64, K, F, generator=gen, device="cuda") * K**-0.5).to(dtype)
                cases.append(gmm_case(a, b, sizes, dtype))
        # deepseek-moe-16b's routed experts (d_ff 1408, top-6 of 64, C = 16):
        # the slab group of a batch-4 decode step and a prefill's overflow
        # group (48 experts, 512 rows)
        for G, M in ((16, 4), (48, 512)):
            for K, F in ((2048, 1408), (1408, 2048)):
                sizes = torch.randint(0, M + 1, (G,), generator=gen, device="cuda",
                                      dtype=torch.int32)
                a = torch.randn(G, M, K, generator=gen, device="cuda")
                a = (a * (torch.arange(M, device="cuda")[None, :, None]
                          < sizes[:, None, None])).to(dtype)
                b = (torch.randn(G, K, F, generator=gen, device="cuda") * K**-0.5).to(dtype)
                cases.append(gmm_case(a, b, sizes, dtype))
    return cases


def gmm_case(a, b, sizes, dtype) -> dict:
    """One moe_gmm case: the kernel against the plain version and
    ``torch.bmm``, its route, the CUDA-core route beside a fast one."""
    from repro_torch.kernels.moe_gmm import gmm_hopper, gmm_ref

    E, N, K = a.shape
    F = b.shape[2]
    label = f"gmm {str(dtype)[6:]} a({E},{N},{K}) b({E},{K},{F})"
    out = gmm_hopper(a, b, sizes)
    ref = gmm_ref(a, b)
    torch.cuda.synchronize()
    err = check(label, out, ref, TOL[dtype])
    for e, s in enumerate(sizes.tolist()):  # zero tails exactly zero
        if out[e, s:].any():
            raise AssertionError(f"{label}: group {e} tail not zero")
    if not torch.equal(out, gmm_hopper(a, b, sizes)):
        raise AssertionError(f"{label}: a repeated run gave other bits")
    which = route_of("moe_gmm", lambda: gmm_hopper(a, b, sizes))
    fma = {}
    if which != "fma":  # the kept CUDA-core kernel at the same case
        err_fma = check(label + " fma", gmm_hopper(a, b, sizes, force_route="fma"),
                        ref, TOL[dtype])
        fma = {"fma_ms": time_ms(lambda: gmm_hopper(a, b, sizes,
                                                    force_route="fma")),
               "max_abs_err_fma": err_fma}
    active = sizes > 0
    rows = int(sizes.sum())
    it = a.element_size()
    nbytes = (rows * K + int(active.sum()) * K * F + E * N * F) * it
    t_bound, by = bound(nbytes, 2.0 * rows * K * F, dtype)
    return {
        "case": label, "route": which, "max_abs_err": err, "tol": TOL[dtype],
        "ms": time_ms(lambda: gmm_hopper(a, b, sizes)), **fma,
        "eager_ms": time_ms(lambda: gmm_hopper(a, b, sizes), graph=False),
        "plain_ms": time_ms(lambda: gmm_ref(a, b), graph=False),
        "library_ms": time_ms(lambda: torch.bmm(a, b)),
        "bound_ms": t_bound, "bound_by": by}


def flash_cases(gen):
    from repro_torch.kernels.flash_attn import attention_ref, flash_hopper
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    cases = []
    shapes = [(4, 128, 16, 1, 128, None, None), (4, 100, 16, 1, 128, None, None),
              (1, 128, 16, 1, 128, None, None),  # the continuous server's prefill
              (4, 128, 8, 2, 64, None, None), (4, 128, 16, 1, 128, 50.0, 32),
              (4, 512, 32, 1, 112, None, None)]  # zamba2-7b's shared attention
    for dtype in (torch.bfloat16, torch.float32):
        for B, T, Hkv, G, hd, cap, win in shapes:
            q = torch.randn(B, T, Hkv, G, hd, generator=gen, device="cuda").to(dtype)
            k = torch.randn(B, T, Hkv, hd, generator=gen, device="cuda").to(dtype)
            v = torch.randn(B, T, Hkv, hd, generator=gen, device="cuda").to(dtype)
            label = (f"flash {str(dtype)[6:]} B{B} T{T} Hkv{Hkv} G{G} hd{hd}"
                     f" softcap={cap} window={win}")
            out = flash_hopper(q, k, v, softcap=cap, window=win)
            ref = attention_ref(q, k, v, softcap=cap, window=win)
            torch.cuda.synchronize()
            err = check(label, out, ref, TOL[dtype])
            which = route_of("flash_attn",
                             lambda: flash_hopper(q, k, v, softcap=cap, window=win))
            fma = {}
            if which != "fma":  # the kept CUDA-core kernel at the same case
                fwd = lambda: flash_hopper(q, k, v, softcap=cap, window=win,  # noqa: E731
                                           force_route="fma")
                fma = {"fma_ms": time_ms(fwd),
                       "max_abs_err_fma": check(label + " fma", fwd(), ref, TOL[dtype])}
            t = torch.arange(T)
            pairs = int(torch.minimum(t + 1, torch.tensor(win or T)).sum())
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            t_bound, by = bound(nbytes, 4.0 * hd * pairs * B * Hkv * G, dtype)
            lib = None
            if cap is None and win is None:  # SDPA has no softcap
                qs = q.reshape(B, T, Hkv * G, hd).transpose(1, 2).contiguous()
                ks = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
                vs = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
                lib = time_ms(lambda: sdpa(qs, ks, vs, is_causal=True))
            cases.append({
                "case": label, "route": which, "max_abs_err": err, "tol": TOL[dtype],
                "ms": time_ms(lambda: flash_hopper(q, k, v, softcap=cap, window=win)),
                "eager_ms": time_ms(lambda: flash_hopper(q, k, v, softcap=cap, window=win),
                                    graph=False),
                **fma,
                "plain_ms": time_ms(lambda: attention_ref(q, k, v, softcap=cap,
                                                          window=win), graph=False),
                "library_ms": lib, "bound_ms": t_bound, "bound_by": by})
    return cases


def int4_cases(gen):
    from repro_torch.kernels.int4_matmul import (dequant_ref, int4_matmul_hopper,
                                                 int4_matmul_ref, quantize_matmul_weight)

    cases = []
    g = 32
    shapes = [(M, K, N) for M in (1, 4, 512) for K, N in ((2048, 1024), (1024, 2048))]
    shapes.append((7, 2048, 1000))  # ragged: M and N tails of both tiles
    for dtype in (torch.bfloat16, torch.float32):
        for M, K, N in shapes:
            x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
            w = torch.randn(K, N, generator=gen, device="cuda") * K**-0.5
            p, sc, z, _ = quantize_matmul_weight(w, g)
            label = f"int4 {str(dtype)[6:]} x({M},{K}) w({K},{N}) g{g}"
            out = int4_matmul_hopper(x, p, sc, z, g)
            ref = int4_matmul_ref(x, p, sc, z, g)
            torch.cuda.synchronize()
            err = check(label, out, ref, TOL[dtype])
            if not torch.equal(out, int4_matmul_hopper(x, p, sc, z, g)):
                raise AssertionError(f"{label}: a repeated run gave other bits")
            which = route_of("int4_matmul", lambda: int4_matmul_hopper(x, p, sc, z, g))
            fma = {}
            if which != "fma":  # the kept CUDA-core kernel at the same case
                fwd = lambda: int4_matmul_hopper(x, p, sc, z, g,  # noqa: E731
                                                 force_route="fma")
                fma = {"fma_ms": time_ms(fwd),
                       "max_abs_err_fma": check(label + " fma", fwd(), ref, TOL[dtype])}
            it = x.element_size()
            nbytes = M * K * it + p.numel() + 4 * (sc.numel() + z.numel()) + M * N * it
            t_bound, by = bound(nbytes, 2.0 * M * K * N, dtype)
            w_deq = dequant_ref(p, sc, z, g).to(dtype)  # for the matmul-only yardstick
            cases.append({
                "case": label, "route": which, "max_abs_err": err, "tol": TOL[dtype],
                "ms": time_ms(lambda: int4_matmul_hopper(x, p, sc, z, g)), **fma,
                "eager_ms": time_ms(lambda: int4_matmul_hopper(x, p, sc, z, g),
                                    graph=False),
                "plain_ms": time_ms(lambda: int4_matmul_ref(x, p, sc, z, g), graph=False),
                "library_ms": time_ms(lambda: torch.matmul(x, w_deq)),
                "library": "torch.matmul on a pre-dequantized weight (matmul only, "
                           "no dequant)",
                **(int4pack_yardstick(x, p, sc, z, g, ref) if dtype == torch.bfloat16
                   else {}),
                "bound_ms": t_bound, "bound_by": by})
    return cases


def int4pack_yardstick(x, packed, scale, zero, g, ref) -> dict:
    """PyTorch's own INT4 kernel, ``torch._weight_int4pack_mm``, on the same
    codes: a time only. Its scale and zero are bf16 and it computes
    (q - 8) s + z', so HQQ's (q - z) s maps onto it with z' = (8 - z) s,
    rounded to bf16; no correctness oracle (its error is printed). Where
    the card's torch lacks it or rejects the shapes, the reason is kept."""
    try:
        q = torch.stack((packed & 0x0F, packed >> 4), dim=1).reshape(-1, packed.shape[1])
        qt = q.t().contiguous().to(torch.int32)  # (N, K) codes
        w_u8 = ((qt[:, ::2] << 4) | qt[:, 1::2]).to(torch.uint8)
        w_pack = torch._convert_weight_to_int4pack(w_u8, 8)
        sz = torch.stack((scale, (8.0 - zero) * scale), dim=-1).to(torch.bfloat16).contiguous()
        fn = lambda: torch._weight_int4pack_mm(x, w_pack, g, sz)  # noqa: E731
        err = (fn().float() - ref.float()).abs().max().item()
        return {"library_int4pack_ms": time_ms(fn), "int4pack_max_abs_err": err}
    except Exception as e:  # a yardstick only: the port never calls it
        return {"library_int4pack_ms": None,
                "int4pack_unavailable": f"{type(e).__name__}: {e}"[:200]}


def ssd_cases(gen):
    """ssd_scan against the sequential recurrence at the serve shapes of
    both models, a T tail, two groups and a non-zero initial state.
    Inputs are model-like: dt = softplus(N(-4.6, 0.5)) (about 0.01, the
    init's dt_bias), A = -(1..16) as the init's A_log, so the state
    carries across chunks."""
    from repro_torch.configs.base import SSMSpec
    from repro_torch.kernels.ssd_scan import ssd_hopper, ssd_scan_ref
    from repro_torch.models.mamba2 import ssd_chunked

    cases = []
    shapes = [  # name, B, T, H, P, N, G, init, D (the fused skip, as the model passes)
        ("zamba2", 4, 512, 112, 64, 64, 1, False, True),
        ("mamba2", 4, 512, 24, 64, 128, 1, False, True),
        ("T tail", 4, 100, 112, 64, 64, 1, False, False),
        ("G2", 4, 512, 112, 64, 64, 2, False, False),
        ("init", 4, 512, 24, 64, 128, 1, True, True),
    ]
    chunk = 128
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, T, H, P, N, G, with_init, with_d in shapes:
            x = torch.randn(B, T, H, P, generator=gen, device="cuda").to(dtype)
            dt = torch.nn.functional.softplus(
                torch.randn(B, T, H, generator=gen, device="cuda") * 0.5 - 4.6)
            A = -torch.linspace(1.0, 16.0, H, device="cuda")
            Bm = torch.randn(B, T, G, N, generator=gen, device="cuda").to(dtype)
            Cm = torch.randn(B, T, G, N, generator=gen, device="cuda").to(dtype)
            init = (torch.randn(B, H, P, N, generator=gen, device="cuda") * 0.5
                    if with_init else None)
            D = (1.0 + 0.1 * torch.randn(H, generator=gen, device="cuda")
                 if with_d else None)
            label = (f"ssd {str(dtype)[6:]} {name} x({B},{T},{H},{P}) N{N} G{G} "
                     f"init={with_init} D={with_d}")
            y, fin = ssd_hopper(x, dt, A, Bm, Cm, init, D=D, chunk=chunk)
            yr, fr = ssd_scan_ref(x, dt, A, Bm, Cm, init, D=D)
            torch.cuda.synchronize()
            err = check(label, y, yr, TOL_SSD[dtype])
            err_state = check(label + " state", fin, fr, TOL_SSD[torch.float32])
            y2, fin2 = ssd_hopper(x, dt, A, Bm, Cm, init, D=D, chunk=chunk)
            if not (torch.equal(y, y2) and torch.equal(fin, fin2)):
                raise AssertionError(f"{label}: a repeated run gave other bits")
            which = route_of("ssd_scan", lambda: ssd_hopper(x, dt, A, Bm, Cm, init, D=D,
                                                            chunk=chunk))
            fma = {}
            if which != "fma":  # the kept CUDA-core kernel at the same case
                fwd = lambda: ssd_hopper(x, dt, A, Bm, Cm, init, D=D,  # noqa: E731
                                         chunk=chunk, force_route="fma")
                fma = {"fma_ms": time_ms(fwd),
                       "max_abs_err_fma": check(label + " fma", fwd()[0], yr, TOL_SSD[dtype])}
            # bytes: inputs once, outputs once; ops: the chunked algorithm on
            # this run's rows (C.B^T once per group, causal half of each chunk)
            it = x.element_size()
            nbytes = (2 * x.numel() + 2 * Bm.numel()) * it + 4 * (
                dt.numel() + A.numel() + fin.numel() + (init.numel() if with_init else 0)
                + (H if with_d else 0))
            rows = [min(chunk, T - c) for c in range(0, T, chunk)]
            tri = sum(r * (r + 1) // 2 for r in rows)
            macs = B * G * tri * N + B * H * tri * P + 2 * B * H * T * P * N
            t_bound, by = bound(nbytes, 2.0 * macs, dtype)
            spec = SSMSpec(N, head_dim=P, chunk=chunk, n_groups=G)
            cases.append({
                "case": label, "route": which, "max_abs_err": max(err, err_state), **fma,
                "max_abs_err_y": err, "max_abs_err_state": err_state,
                "tol": TOL_SSD[dtype], "tol_state": TOL_SSD[torch.float32],
                "ms": time_ms(lambda: ssd_hopper(x, dt, A, Bm, Cm, init, D=D,
                                                 chunk=chunk)),
                "eager_ms": time_ms(lambda: ssd_hopper(x, dt, A, Bm, Cm, init, D=D,
                                                       chunk=chunk), graph=False),
                "plain_ms": time_ms(lambda: ssd_scan_ref(x, dt, A, Bm, Cm, init, D=D),
                                    reps=5, graph=False),
                "plain_chunked_ms": time_ms(
                    lambda: ssd_chunked(x, dt, A, Bm, Cm, spec, init), reps=5,
                    graph=False),
                "library_ms": None, "library": "none: no single PyTorch call computes SSD",
                "bound_ms": t_bound, "bound_by": by})
    return cases


def serve_full(arch: str, n_ssd: int, n_flash: int) -> dict:
    """Serve 4 x (512 + 32) tokens of ``arch`` through the full-model path
    (counters set to 0 just before), check launches, shapes and the serving
    engine's tokens, and hold the prefill logits against a plain prefill
    on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.inference import Request, ServingEngine
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import make_prompts, run_full
    from repro_torch.models.model import prefill
    from repro_torch.models.runtime import Runtime

    cfg = get_config(arch)
    B, T, new = 4, 512, 32
    dispatch.reset_launches()
    rep = run_full(arch, batch=B, prompt_len=T, max_new=new, dtype=torch.bfloat16,
                   device="cuda", seed=0, keep_params=True)
    launches = dict(dispatch.LAUNCHES)
    routes = {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}
    params = rep.pop("params")
    want = {"ssd_scan": n_ssd, "flash_attn": n_flash}
    got = {op: rep["launches"]["prefill"][op] for op in want}
    if got != want or any(rep["launches"]["decode"].values()):
        raise AssertionError(f"{arch}: launches {rep['launches']}, want {want} per "
                             "prefill and none in decode")
    if any(launches[op] != rep["launches"]["prefill"][op] for op in launches):
        raise AssertionError(f"{arch}: counters {launches} vs report {rep['launches']}")
    check_path(arch, launches, routes)
    tokens, logits = rep.pop("tokens"), rep.pop("prefill_logits")
    if tokens.shape != (B, new) or logits.shape != (B, cfg.vocab):
        raise AssertionError(f"{arch} shapes: tokens {tokens.shape} logits {logits.shape}")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{arch}: non-finite prefill logits")
    print(f"serve {arch}:", json.dumps(rep))

    prompts = make_prompts(cfg.vocab, B, T)
    rt = Runtime(device=torch.device("cuda"))
    comps = ServingEngine(cfg, params, rt=rt, max_batch=B).generate_batch(
        [Request(p, new) for p in prompts])
    eng = torch.as_tensor(np.stack([c.tokens for c in comps]))
    same = bool((eng == torch.as_tensor(tokens)).all())
    print(f"{arch}: ServingEngine.generate_batch tokens equal the timed loop's: {same}")
    if not same:
        raise AssertionError(f"{arch}: generate_batch gave other tokens")

    toks = torch.as_tensor(prompts, dtype=torch.long, device="cuda")

    def last_logits(p, backend):
        with torch.inference_mode():
            lg, _ = prefill(p, cfg, toks, Runtime(kernel_backend=backend,
                                                  device=torch.device("cuda")),
                            n_slots=T + new)
        return lg[:, -1].float().cpu()

    def rel_top1(a, b):
        r = ((a - b).norm() / b.norm()).item()
        return r, (a.argmax(-1) == b.argmax(-1)).float().mean().item()

    ref = last_logits(params, "ref")
    # the same (bf16-valued) weights in fp32: the plain path's own round-off
    p32 = _tree_float(params)
    k32, r32 = last_logits(p32, "auto"), last_logits(p32, "ref")
    del p32
    rel, top1 = rel_top1(logits, ref)
    rel32, top32 = rel_top1(k32, r32)
    floor, _ = rel_top1(ref, r32)
    acc, _ = rel_top1(logits, r32)
    tol = BF16_FULL_LOGITS_REL_TOL[arch]
    print(f"{arch} prefill logits kernel vs plain: fp32 rel {rel32:.3g} (tol "
          f"{FP32_LOGITS_REL_TOL}), top-1 {top32:.2f}; bf16 rel {rel:.4g} (tol {tol}), "
          f"max abs {(logits - ref).abs().max().item():.3g}, top-1 agreement "
          f"{top1:.2f}; plain bf16 vs fp32 rel {floor:.4g}, bf16 kernel run vs fp32 "
          f"rel {acc:.4g} (tol {ACCURACY_RATIO} x {floor:.4g})")
    if not (math.isfinite(rel32) and rel32 <= FP32_LOGITS_REL_TOL):
        raise AssertionError(f"{arch}: fp32 prefill logits disagree: rel {rel32}")
    if not (math.isfinite(rel) and rel <= tol):
        raise AssertionError(f"{arch}: bf16 prefill logits disagree: rel {rel}")
    if not (math.isfinite(acc) and acc <= ACCURACY_RATIO * floor):
        raise AssertionError(f"{arch}: bf16 kernel run rel {acc} from fp32, plain "
                             f"run {floor}")
    by_kernel = {}  # one kernel at a time, the other op plain (printed, not gated)
    if n_flash:
        for only, spec in (("ssd_scan", "auto,flash_attn=ref"),
                           ("flash_attn", "auto,ssd_scan=ref")):
            by_kernel[only] = rel_top1(last_logits(params, spec), ref)[0]
        print(f"{arch} bf16 rel vs plain with one kernel only: {by_kernel}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rep.update(launches_total=launches, route_launches=routes, logits_rel=rel, top1=top1, logits_tol=tol,
               fp32_logits_rel=rel32, bf16_roundoff_rel=floor, kernel_vs_fp32_rel=acc,
               rel_one_kernel_only=by_kernel)
    return rep


# The continuous-batching phase: 8 requests of 128 prompt tokens, budgets
# cycling so that slots free and refill mid-flight, 4 slots, fcfs.
SERVE_PROMPT, SERVE_BUDGETS, SERVE_SLOTS = 128, (8, 32, 16, 24) * 2, 4
# per prefill (16 attn_moe layers, one request, zero_drop: cap = 128 rows)
# and per decode step over the pool (4 rows): one flash per layer in
# prefill, three gmm per layer in both
CONT_PER_PREFILL = {"flash_attn": ("tc", 16), "moe_gmm": ("tc", 48)}
CONT_PER_DECODE_STEP = {"moe_gmm": ("stream", 48)}
# fp32 token identity of the continuous server against batch-1 serving, on
# the 4 requests admitted into freed slots mid-flight
TOKEN_GATE_RIDS = (4, 5, 6, 7)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def serve_continuous() -> dict:
    """Serve full-width OLMoE-1B-7B whole on the card through the port's
    ``ContinuousBatchingServer`` (bf16, random weights from seed 0): launch
    totals per route, the first request's prefill logits against the plain
    versions, and, in fp32, the server's tokens against ``ServingEngine``
    at batch 1 for the requests ``TOKEN_GATE_RIDS``."""
    from repro_torch.configs import get_config
    from repro_torch.inference import Request, ServingEngine
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import init_params, prefill
    from repro_torch.models.runtime import Runtime
    from repro_torch.serving import (ContinuousBatchingServer, RequestQueue,
                                     ServeRequest, get_scheduler)

    t_phase = time.perf_counter()
    cfg = get_config("olmoe")
    dev = torch.device("cuda")
    n = len(SERVE_BUDGETS)
    prompts = make_prompts(cfg.vocab, n, SERVE_PROMPT)
    max_len = SERVE_PROMPT + max(SERVE_BUDGETS) + 1

    def serve(params):
        srv = ContinuousBatchingServer(cfg, params, n_slots=SERVE_SLOTS, max_len=max_len,
                                       scheduler=get_scheduler("fcfs"))
        torch.cuda.synchronize()
        dispatch.reset_launches()  # after the constructor's warm-up launches
        results, mt = srv.run(RequestQueue([
            ServeRequest(rid=i, prompt=prompts[i], max_new_tokens=SERVE_BUDGETS[i])
            for i in range(n)]))
        return srv, results, mt

    def same_as_batch1(params, results):
        eng = ServingEngine(cfg, params, max_batch=1)
        return [bool(np.array_equal(results[i].tokens, eng.generate_batch(
            [Request(prompts[i], SERVE_BUDGETS[i])])[0].tokens)) for i in TOKEN_GATE_RIDS]

    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    weight_bytes = _tree_bytes(params)
    torch.cuda.reset_peak_memory_stats(dev)
    srv, results, mt = serve(params)
    launches = dict(dispatch.LAUNCHES)
    routes = {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}
    peak = torch.cuda.max_memory_allocated(dev)
    want = {op: {} for op in FAST_ROUTES}
    for op, (route, k) in CONT_PER_PREFILL.items():
        want[op][route] = want[op].get(route, 0) + k * n
    for op, (route, k) in CONT_PER_DECODE_STEP.items():
        want[op][route] = want[op].get(route, 0) + k * mt.decode_steps
    if routes != want or any(launches[op] != sum(r.values()) for op, r in want.items()):
        raise AssertionError(f"continuous olmoe: launches {launches} by route {routes}, "
                             f"want {want} ({mt.decode_steps} decode steps)")
    print(f"continuous olmoe: launches {launches}, routes {routes} over {n} prefills and "
          f"{mt.decode_steps} decode steps")
    toks = [r.tokens for r in results]
    if [len(t) for t in toks] != list(SERVE_BUDGETS) or any(
            r.finish_reason != "length" for r in results):
        raise AssertionError(f"continuous olmoe: token counts {[len(t) for t in toks]}, "
                             f"want {SERVE_BUDGETS}")
    summ = mt.summary()
    steps = srv.span_s["serve.decode_step"]
    stats = {
        "requests": summ["requests"], "decode_steps": mt.decode_steps,
        "generated_tokens": mt.generated_tokens, "prefill_tokens": mt.prefill_tokens,
        "throughput_tok_s": summ["throughput_tok_s"], "latency_p50_s": summ["latency_p50"],
        "latency_p99_s": summ["latency_p99"], "ttft_p50_s": summ["ttft_p50"],
        "ttft_p99_s": float(np.percentile(np.asarray(mt.ttfts), 99)),
        "ms_per_decode_step": 1e3 * float(np.mean(steps)),
        "ms_per_decode_step_p50": 1e3 * float(np.median(steps)),
        "ms_per_prefill": 1e3 * float(np.mean(srv.span_s["serve.prefill"])),
        "slot_occupancy": summ["slot_occupancy"], "wall_time_s": mt.wall_time,
        "max_memory_allocated": peak, "weight_bytes": weight_bytes,
    }
    print("continuous olmoe serve:", json.dumps(stats))

    x = torch.as_tensor(prompts[:1], dtype=torch.long, device=dev)

    def first_logits(backend):
        with torch.inference_mode():
            lg, _ = prefill(params, cfg, x, Runtime(kernel_backend=backend, device=dev,
                                                    zero_drop=True), n_slots=max_len)
        return lg[:, -1].float().cpu()

    kern, plain = first_logits("auto"), first_logits("ref")
    rel = ((kern - plain).norm() / plain.norm()).item()
    print(f"continuous olmoe first prefill logits kernel vs plain: rel {rel:.4g} (tol "
          f"{LOGITS_REL_TOL}), top-1 agree {bool(kern.argmax() == plain.argmax())}")
    if not (math.isfinite(rel) and rel <= LOGITS_REL_TOL):
        raise AssertionError(f"continuous olmoe: prefill logits disagree: rel {rel}")

    k = len(TOKEN_GATE_RIDS)
    bf16_same = same_as_batch1(params, results)
    print(f"continuous olmoe bf16: server tokens equal batch-1 serving for "
          f"{sum(bf16_same)}/{k} of rids {TOKEN_GATE_RIDS} (printed, not gated)")
    p32 = _tree_float(params)
    del params, srv
    gc.collect()
    torch.cuda.empty_cache()
    _, res32, _ = serve(p32)
    same32 = same_as_batch1(p32, res32)
    print(f"continuous olmoe fp32: server tokens equal batch-1 serving for "
          f"{sum(same32)}/{k} of rids {TOKEN_GATE_RIDS}")
    if not all(same32):
        raise AssertionError(f"continuous olmoe fp32: server tokens differ from batch-1 "
                             f"serving: {same32}")
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    stats.update(launches_total=launches, route_launches=routes, logits_rel=rel,
                 bf16_token_identity=bf16_same, fp32_token_identity=same32,
                 phase_s=time.perf_counter() - t_phase)
    print(f"continuous olmoe phase: {stats['phase_s']:.1f} s")
    return stats


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    return tree.float()


def _host_available_gib() -> float:
    """MemAvailable of the host (the wave and deepseek phases hold 30-60 GB
    of experts in host memory), or NaN where /proc/meminfo is missing."""
    try:
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return float("nan")


def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _strip_experts(params) -> None:
    """Drop the stacked expert leaves of every MoE block (the engine's
    pinned store holds them), so the device keeps only the rest."""
    for g in params["groups"].values():
        for bp in g.values():
            for k in ("wg", "wu", "wd"):
                if "router" in bp.get("ffn", {}):
                    bp["ffn"].pop(k, None)


def _lora_b_drawn(cfg, dev, seed: int = 1):
    """The port's LoRA init with ``b`` ~ N(0, 1/r) (fp32), so that every
    adapter moves the output and has a gradient."""
    from repro_torch.core.lora import init_lora

    g = torch.Generator(device=dev).manual_seed(seed)
    lora = init_lora(cfg, cfg.melinoe, generator=g, device=dev)
    for gt in lora.values():
        for pt in gt.values():
            for ab in pt.values():
                ab["b"] = torch.randn(ab["b"].shape, generator=g, device=dev) * LORA_B_STD
    return lora


def serve_wave(arch: str = "olmoe", device: str = "cuda") -> dict:
    """Phase 8: full-width OLMoE-1B-7B offloaded behind the port's
    ``OffloadedWaveServer`` with LoRA on every MoE layer, under fcfs and
    expert-affinity, and the LoRA gates on the first request's prefill
    logits (see the module docstring). ``arch``/``device``: a smaller
    model or the CPU, to rehearse the phase's logic."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import lora_scale
    from repro_torch.core.offload_engine import OffloadedMoEEngine
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import init_params
    from repro_torch.serving import (OffloadedWaveServer, RequestQueue, ServeRequest,
                                     get_scheduler, prefill_expert_scores)
    from repro_torch.training import merge_lora

    t_phase = time.perf_counter()
    print(f"wave phase: host memory available {_host_available_gib():.1f} GiB")
    cfg = get_config(arch)
    dev = torch.device(device)
    n, C = len(SERVE_BUDGETS), 16
    prompts = make_prompts(cfg.vocab, n, SERVE_PROMPT)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    lora = _lora_b_drawn(cfg, dev)  # fp32, as the reference's
    sc = lora_scale(cfg.melinoe)
    scores = prefill_expert_scores(cfg, params, [
        ServeRequest(rid=i, prompt=prompts[i], max_new_tokens=1) for i in range(n)],
        lora=lora, lora_scale=sc)
    (gname, pname), = [(gk, pk) for gk, gt in params["groups"].items() for pk in gt]
    # the same (bf16-valued) experts in fp32 on the host, for the merge gate
    experts32 = {k: params["groups"][gname][pname]["ffn"][k].float().cpu()
                 for k in ("wg", "wu", "wd")}

    out, store = {}, None
    for policy, path in (("fcfs", "wave-olmoe-fcfs"), ("expert-affinity", "wave-olmoe-affinity")):
        sched = get_scheduler(policy) if policy == "fcfs" else get_scheduler(policy, top_c=C)
        srv = OffloadedWaveServer(cfg, params, capacity=C, policy="gamma", scheduler=sched,
                                  wave_size=4, lora=lora, lora_scale=sc, device=dev,
                                  host_store=store)
        if store is None:  # the store is built: the device keeps the rest
            store = srv.engine.host_store
            _strip_experts(params)
            gc.collect()
            torch.cuda.empty_cache()
        reqs = [ServeRequest(rid=i, prompt=prompts[i], max_new_tokens=SERVE_BUDGETS[i],
                             expert_scores=scores[i]) for i in range(n)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        dispatch.reset_launches()
        results, mt = srv.run(RequestQueue(reqs))
        torch.cuda.synchronize()
        launches = dict(dispatch.LAUNCHES)
        routes = {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}
        check_path(path, launches, routes)
        toks = [r.tokens for r in results]
        if [len(t) for t in toks] != list(SERVE_BUDGETS) or any(
                r.finish_reason != "length" for r in results):
            raise AssertionError(f"{path}: token counts {[len(t) for t in toks]}")
        summ = mt.summary()
        dec_s, dec_n = sum(srv.span_s["serve.decode"]), sum(srv.span_s["decode_steps"])
        stats = {k: summ[k] for k in (
            "requests", "generated_tokens", "prefill_tokens", "modeled_time_serial_s",
            "modeled_time_overlapped_s", "transfers", "transfer_bytes", "prefetch_transfers",
            "cache_hit_rate", "latency_p50", "latency_p99", "ttft_p50", "ttft_p95")}
        stats.update(
            wall_time_s=mt.wall_time, tok_per_wall_s=mt.generated_tokens / mt.wall_time,
            ms_per_decode_step=1e3 * dec_s / dec_n, decode_steps=dec_n,
            ms_per_prefill=1e3 * float(np.mean(srv.span_s["serve.prefill"])),
            max_memory_allocated=torch.cuda.max_memory_allocated(dev),
            slab_bytes=srv.engine.slab_bytes, lora_bytes=srv.engine.lora_bytes,
            host_store_bytes=srv.engine.host_store_bytes,
            launches_total=launches, route_launches=routes)
        print(f"{path}:", json.dumps(stats))
        out[policy] = (toks, stats)
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    same = all(np.array_equal(a, b) for a, b in zip(out["fcfs"][0], out["expert-affinity"][0]))
    print(f"wave olmoe: per-request tokens equal under fcfs and expert-affinity: {same}")
    if not same:
        raise AssertionError("wave olmoe: the policies gave other tokens")

    def first_logits(p, store_, lora_, backend="auto"):
        eng = OffloadedMoEEngine(cfg, p, capacity=C, policy="gamma", lora=lora_,
                                 lora_scale=sc, host_store=store_, kernel_backend=backend,
                                 device=dev)
        lg = eng.generate(prompts[:1], max_new_tokens=1)["prefill_logits"].float().cpu()
        del eng
        return lg

    # bf16, as served: kernels against plain versions, both with LoRA, and
    # the base without it
    kern = first_logits(params, store, lora)
    plain = first_logits(params, store, lora, "ref")
    base = first_logits(params, store, None)
    del store
    # fp32 on the same weights: the adapters served against merge_lora'd
    # experts without them (bf16 would round every merged weight once more,
    # and that rounding alone moves a random bf16 model's logits as far as
    # its own round-off does)
    p32 = _tree_float(params)
    layers = lambda t: [{k: v[r] for k, v in t.items()}  # noqa: E731
                        for r in range(next(iter(t.values())).shape[0])]
    term32 = first_logits(p32, layers(experts32), lora)
    plain32 = first_logits(p32, layers(experts32), lora, "ref")
    base32 = first_logits(p32, layers(experts32), None)
    merged = merge_lora(cfg, {"groups": {gname: {pname: {"ffn": experts32}}}}, lora, sc)
    merged32 = first_logits(p32, layers(merged["groups"][gname][pname]["ffn"]), None)
    del merged, experts32, p32
    gates = {"kernel_vs_plain": _rel(kern, plain),
             "fp32_kernel_vs_plain": _rel(term32, plain32),
             "fp32_lora_vs_merged": _rel(term32, merged32),
             "no_lora_vs_kernel": _rel(base, kern),
             "fp32_no_lora_vs_lora": _rel(base32, term32),
             "fp32_no_lora_vs_merged": _rel(base32, merged32),
             "bf16_kernel_vs_fp32": _rel(kern, term32), "bf16_plain_vs_fp32": _rel(plain, term32)}
    print(f"wave olmoe first prefill logits rel: {gates} (bf16 tol {WAVE_BF16_LOGITS_REL_TOL}, "
          f"fp32 tol {FP32_LOGITS_REL_TOL}; without LoRA more than "
          f"{LORA_MOVES * LOGITS_REL_TOL})")
    moves = LORA_MOVES * LOGITS_REL_TOL
    if not (gates["kernel_vs_plain"] <= WAVE_BF16_LOGITS_REL_TOL
            and gates["fp32_kernel_vs_plain"] <= FP32_LOGITS_REL_TOL
            and gates["fp32_lora_vs_merged"] <= FP32_LOGITS_REL_TOL):
        raise AssertionError(f"wave olmoe: LoRA logits disagree: {gates}")
    if not (gates["no_lora_vs_kernel"] > moves and gates["fp32_no_lora_vs_lora"] > moves
            and gates["fp32_no_lora_vs_merged"] > moves):
        raise AssertionError(f"wave olmoe: the LoRA term moves nothing: {gates}")
    del params, lora
    gc.collect()
    torch.cuda.empty_cache()
    rep = {"fcfs": out["fcfs"][1], "affinity": out["expert-affinity"][1], "logits_rel": gates,
           "phase_s": time.perf_counter() - t_phase}
    print(f"wave olmoe phase: {rep['phase_s']:.1f} s")
    return rep


def deepseek_fp32_rel(arch: str, device: str, capacity: int) -> float:
    """The deepseek phase's prefill (4 x 128 tokens, full width and depth)
    in fp32, kernels against plain versions: fp32 weights from seed 0,
    the experts kept in pageable host memory and served as the engines'
    store as they are (60 GB: a second, pinned copy would not fit the
    host). Returns ||kernel - plain|| / ||plain||."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import OffloadedMoEEngine
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import init_params

    cfg = get_config(arch)
    dev = torch.device(device)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev, expert_device="cpu")
    store = [{k: bp["ffn"][k][r] for k in ("wg", "wu", "wd")}
             for gi, g in enumerate(cfg.layout) for r in range(g.repeats)
             for pi, bname in enumerate(g.pattern)
             if cfg.block_defs[bname].kind == "attn_moe"
             for bp in (params["groups"][f"g{gi}"][f"p{pi}"],)]
    prompts = make_prompts(cfg.vocab, 4, 128)
    out = []
    for backend in ("auto", "ref"):
        eng = OffloadedMoEEngine(cfg, params, capacity=capacity, policy="gamma",
                                 host_store=store, kernel_backend=backend, device=dev)
        out.append(eng.generate(prompts, max_new_tokens=1)["prefill_logits"].float().cpu())
        del eng
    del params, store
    gc.collect()
    torch.cuda.empty_cache()
    return _rel(out[0], out[1])


def check_deepseek_phases(by_phase: dict) -> None:
    """deepseek's moe_gmm launches by phase and route (see
    DEEPSEEK_PREFILL_GMM)."""
    dec = by_phase["decode"]
    if (by_phase["prefill"] != DEEPSEEK_PREFILL_GMM or set(dec) != {"stream"}
            or dec["stream"] < DEEPSEEK_DECODE_GMM_MIN or dec["stream"] % 3):
        raise AssertionError(f"deepseek: moe_gmm by phase {by_phase}, want prefill "
                             f"{DEEPSEEK_PREFILL_GMM}, decode stream >= "
                             f"{DEEPSEEK_DECODE_GMM_MIN}, a multiple of 3")


def serve_deepseek(arch: str = "deepseek-moe-16b", device: str = "cuda",
                   capacity: int = 16) -> dict:
    """Phase 9: full-width DeepSeek-MoE-16B offloaded through
    ``launch.serve.run`` (bf16, random weights from seed 0), C = 16,
    4 x (128 + 32) tokens: launches per phase and route, and the prefill
    logits against a plain run on the same pinned store."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import run

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    print(f"deepseek phase: host memory available {_host_available_gib():.1f} GiB")
    vocab = get_config(arch).vocab
    kw = dict(capacity=capacity, policy="gamma", batch=4, prompt_len=128,
              dtype=torch.bfloat16, device=device, seed=0)
    dispatch.reset_launches()
    rep = run(arch, max_new=32, keep_store=True, **kw)
    launches = dict(dispatch.LAUNCHES)
    routes = {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}
    check_path("deepseek-offloaded", launches, routes)
    by_phase = {ph: r["moe_gmm"] for ph, r in rep["route_launches"].items()}
    check_deepseek_phases(by_phase)
    tokens, logits = rep.pop("tokens"), rep.pop("prefill_logits")
    if tokens.shape != (4, 32) or logits.shape != (4, vocab) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"deepseek: tokens {tokens.shape} logits {logits.shape}")
    store = rep.pop("host_store")
    print("serve deepseek-moe-16b:", json.dumps(rep))
    ref = run(arch, max_new=1, kernel_backend="ref", host_store=store, **kw)
    rel = _rel(logits, ref["prefill_logits"])
    top1 = (logits.argmax(-1) == ref["prefill_logits"].argmax(-1)).float().mean().item()
    del store, ref
    gc.collect()
    torch.cuda.empty_cache()
    rel32 = deepseek_fp32_rel(arch, device, capacity)
    print(f"deepseek prefill logits kernel vs plain: fp32 rel {rel32:.3g} (tol "
          f"{FP32_LOGITS_REL_TOL}); bf16 rel {rel:.4g} (tol {DEEPSEEK_BF16_LOGITS_REL_TOL}), "
          f"top-1 agreement {top1:.2f}")
    if not (math.isfinite(rel32) and rel32 <= FP32_LOGITS_REL_TOL):
        raise AssertionError(f"deepseek: fp32 prefill logits disagree: rel {rel32}")
    if not (math.isfinite(rel) and rel <= DEEPSEEK_BF16_LOGITS_REL_TOL):
        raise AssertionError(f"deepseek: prefill logits disagree: rel {rel}")
    rep.update(launches_total=launches, route_launches_total=routes, gmm_by_phase=by_phase,
               logits_rel=rel, fp32_logits_rel=rel32, top1=top1,
               phase_s=time.perf_counter() - t_phase)
    print(f"deepseek phase: {rep['phase_s']:.1f} s")
    return rep


def checkpoint_phase(device: str = "cuda") -> dict:
    """Phase 10: a params-only checkpoint of olmoe-mini-smoke written by
    the port, served with ``launch.serve --ckpt`` on the card, gives the
    tokens of the in-memory run of the same weights."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params
    from repro_torch.training import save_checkpoint

    arch = "olmoe-mini-smoke"
    cfg = get_config(arch)
    dev = torch.device(device)
    kw = ["--batch", "2", "--prompt-len", "16", "--max-new", "8", "--capacity", "2"]
    mem = serve.run(arch, batch=2, prompt_len=16, max_new=8, capacity=2, device=dev, seed=0)
    # the weights run() drew: the same generator, dtype and expert placement
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev, expert_device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "olmoe-mini-smoke.ckpt")
        save_checkpoint(path, params, step=0, metadata={"arch": arch})
        ck = serve.main(["--arch", arch, "--ckpt", path, "--device", device, *kw])
    same = bool(np.array_equal(ck["tokens"], mem["tokens"]))
    print(f"checkpoint: serve --ckpt tokens equal the in-memory run: {same}")
    if not same:
        raise AssertionError("checkpoint: served tokens differ from the in-memory run")
    return {"tokens_equal": same}


def slab_dequant_ms(gen, C=16, d=2048, f=1024, g=32) -> float:
    """The INT4 slab step's plain dequant of C slots for wg, wu and wd into
    bf16 (what one MoE layer-step computes before its gmm calls)."""
    from repro_torch.kernels.int4_matmul import dequant_ref

    mats = []
    for K, N in ((d, f), (d, f), (f, d)):
        p = torch.randint(0, 256, (C, K // 2, N), generator=gen, device="cuda",
                          dtype=torch.uint8)
        s = torch.rand(C, K // g, N, generator=gen, device="cuda") * 1e-3
        z = torch.rand(C, K // g, N, generator=gen, device="cuda") * 15
        mats.append((p, s, z))
    return time_ms(lambda: [dequant_ref(p, s, z, g).to(torch.bfloat16)
                            for p, s, z in mats], reps=5, warmup=1, graph=False)


# ---------------------------------------------------------------------------
# MELINOE training and the activation predictor (phases 11-14)
# ---------------------------------------------------------------------------


def _grad_leaves(tree, path=""):
    """(path, gradient) of a gradient tree, per-repeat lists stacked."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _grad_leaves(v, f"{path}/{k}")
    elif tree is not None:
        yield path, torch.stack(tree) if isinstance(tree, list) else tree


def _gmm_launches() -> dict:
    from repro_torch.kernels import dispatch

    return {"launches": dispatch.LAUNCHES["moe_gmm"],
            "routes": dict(dispatch.ROUTE_LAUNCHES["moe_gmm"]),
            "by_product": dict(dispatch.GRAD_LAUNCHES["moe_gmm"]),
            "flash_attn": dispatch.LAUNCHES["flash_attn"]}


def predictor_phase(main_tokens, main_stats: dict, serve_kw: dict,
                    arch: str = "olmoe") -> dict:
    """Phase 11: the main path's batch served again with the activation
    predictor (``run(..., predictor=True)``, 32 training prompts): Psi's KL
    falls, prefetch transfers > 0, tokens equal the run without it.
    ``arch``: a smaller model, to rehearse the phase's logic."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import run

    t_phase = time.perf_counter()
    dispatch.reset_launches()
    rep = run(arch, max_new=32, predictor=True, n_train_prompts=32, **serve_kw)
    launches = dict(dispatch.LAUNCHES)
    routes = {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}
    kl = rep["predictor_kl"]
    same = bool(np.array_equal(rep["tokens"], main_tokens))
    stats = {"with_psi": {k: rep[k] for k in ("transfers", "prefetch_transfers", "hit_rate",
                                              "modeled_time_s", "decode_tok_s",
                                              "prefill_s")},
             "without_psi": main_stats, "predictor_kl": kl, "trace_s": rep["trace_s"],
             "predictor_train_s": rep["predictor_train_s"],
             "tokens_equal_without_psi": same, "launches_total": launches,
             "route_launches": routes}
    print("predictor serve olmoe:", json.dumps(stats))
    if not (kl[-1] < kl[0] and all(math.isfinite(x) for x in kl)):
        raise AssertionError(f"predictor: KL did not fall: {kl}")
    if not rep["prefetch_transfers"] > 0:
        raise AssertionError("predictor: no prefetch transfers")
    if not same:
        raise AssertionError("predictor: tokens differ from the run without Psi")
    if launches["moe_gmm"] <= 0 or launches["flash_attn"] <= 0:
        raise AssertionError(f"predictor: launches {launches}")
    for op, fast in FAST_ROUTES.items():
        if set(routes[op]) - set(fast):
            raise AssertionError(f"predictor: {op} routes {routes[op]}, want {fast}")
    gc.collect()
    torch.cuda.empty_cache()
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"predictor phase: {stats['phase_s']:.1f} s")
    stats["psi_scores"] = rep["predictor_scores"]  # melinoe's prefetch in phase 15
    return stats


def finetune_grad_gate(device: str = "cuda", depth: int = 2, arch: str = "olmoe") -> dict:
    """Phase 12, first half: one fine-tune loss and its gradients of
    full-width OLMoE cut to ``depth`` layers, fp32, through the kernels and
    through the plain versions (per leaf ||delta|| / ||ref||)."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import extract_base_routers, melinoe_trainable_mask
    from repro_torch.data.synthetic import ClusterLM, SyntheticConfig
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import build_finetune_step
    from repro_torch.models.model import init_params
    from repro_torch.models.runtime import Runtime
    from repro_torch.training import TRAIN_KERNEL_BACKEND, OptConfig

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, layout=(dataclasses.replace(cfg.layout[0],
                                                               repeats=depth),))
    dev = torch.device(device)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    lora = _lora_b_drawn(cfg, dev)
    mask = melinoe_trainable_mask(params)
    base = extract_base_routers(params, cfg)
    batch = next(ClusterLM(SyntheticConfig(vocab=cfg.vocab, seq_len=TRAIN_T, seed=0))
                 .batches(TRAIN_B, seed=1))
    out = {}
    for spec in (TRAIN_KERNEL_BACKEND, "ref"):
        step = build_finetune_step(cfg, Runtime(kernel_backend=spec, device=dev),
                                   OptConfig(), mask)
        dispatch.reset_launches()
        loss, _, grads = step.loss_and_grads(params, lora, batch, base)
        torch.cuda.synchronize()
        out[spec] = (loss.item(), dict(_grad_leaves({"params": grads[0], "lora": grads[1]})),
                     _gmm_launches())
        if spec == TRAIN_KERNEL_BACKEND:
            totals = (dict(dispatch.LAUNCHES),
                      {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES})
    (loss, grads, kl), (loss_r, grads_r, kl_r) = out.values()
    rel = {p: ((g - grads_r[p]).norm() / grads_r[p].norm()).item() for p, g in grads.items()}
    L = depth
    want = {"launches": 3 * L + 6 * L - 2, "routes": {"fma": 3 * L + 6 * L - 2},
            "by_product": {"dA": 3 * L - 2, "dB": 3 * L}, "flash_attn": 0}
    rep = {"depth": depth, "loss": loss, "loss_ref": loss_r,
           "loss_rel": abs(loss - loss_r) / abs(loss_r), "grad_rel": rel,
           "launches": kl, "launches_ref": kl_r, "tol": GRAD_REL_TOL,
           "launches_total": totals[0], "route_launches": totals[1]}
    print("fine-tune gradient gate (fp32):", json.dumps(rep))
    if kl != want or kl_r["launches"] or kl_r["flash_attn"]:
        raise AssertionError(f"gradient gate: launches {kl} (plain {kl_r}), want {want}")
    if len(rel) != 6 or not all(math.isfinite(r) and r <= GRAD_REL_TOL for r in rel.values()):
        raise AssertionError(f"gradient gate: gradients disagree: {rel}")
    if not rep["loss_rel"] <= GRAD_REL_TOL:
        raise AssertionError(f"gradient gate: loss {loss} vs {loss_r}")
    del params, lora, grads, grads_r, out
    gc.collect()
    torch.cuda.empty_cache()
    return rep


def gmm_backward_cases(gen) -> list:
    """Phase 12, second half: ``GmmFn``'s backward against ``gmm_ref``
    under autograd at the fine-tune's shapes (E 64, top-8 of a random route
    of B x T tokens, capacity ceil(8 B T / 64 x 1.25)), bf16 and fp32; the
    dA and dB products timed apart, with their bounds, the transposed
    copies and ``torch.bmm`` at the same shapes."""
    from repro_torch.kernels.moe_gmm import gmm, gmm_hopper, gmm_ref

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for n_tok, (K, F) in ((1024, (2048, 1024)), (1024, (1024, 2048)),
                              (1000, (2048, 1024))):
            E = 64
            cap = math.ceil(n_tok * 8 / E * 1.25)
            eids = torch.randn(n_tok, E, generator=gen, device="cuda").topk(8, dim=-1).indices
            sizes = torch.clamp(torch.bincount(eids.reshape(-1), minlength=E), max=cap
                                ).to(torch.int32)
            live = (torch.arange(cap, device="cuda")[None, :, None] < sizes[:, None, None])
            a = (torch.randn(E, cap, K, generator=gen, device="cuda") * live).to(dtype)
            b = (torch.randn(E, K, F, generator=gen, device="cuda") * K**-0.5).to(dtype)
            dy = (torch.randn(E, cap, F, generator=gen, device="cuda") * live).to(dtype)
            got = []
            for backend in ("hopper", "ref"):
                aa, bb = a.clone().requires_grad_(), b.clone().requires_grad_()
                gmm(aa, bb, sizes, backend=backend).backward(dy)
                got.append((aa.grad, bb.grad))
            torch.cuda.synchronize()
            label = f"gmm backward {str(dtype)[6:]} a({E},{cap},{K}) b({E},{K},{F})"
            err_da = check(label + " dA", got[0][0], got[1][0], TOL[dtype])
            err_db = check(label + " dB", got[0][1], got[1][1], TOL[dtype])
            bT, aT = b.transpose(1, 2).contiguous(), a.transpose(1, 2).contiguous()
            route_da = route_of("moe_gmm", lambda: gmm_hopper(dy, bT, sizes))
            route_db = route_of("moe_gmm", lambda: gmm_hopper(aT, dy))
            rows, act = int(sizes.sum()), int((sizes > 0).sum())
            it = a.element_size()
            # dA: dY's live rows, B of the live groups, dA written whole
            bd_a = bound((rows * F + act * F * K + E * cap * K) * it, 2.0 * rows * F * K,
                         dtype)
            # dB: A's and dY's live rows, dB written whole
            bd_b = bound((rows * K + rows * F + E * K * F) * it, 2.0 * rows * K * F, dtype)
            cases.append({
                "case": label, "capacity": cap, "dtype": str(dtype)[6:],
                "max_abs_err": max(err_da, err_db), "max_abs_err_dA": err_da,
                "max_abs_err_dB": err_db, "tol": TOL[dtype], "route_dA": route_da,
                "route_dB": route_db,
                "dA_ms": time_ms(lambda: gmm_hopper(dy, bT, sizes)),
                "dB_ms": time_ms(lambda: gmm_hopper(aT, dy)),
                "copy_bT_ms": time_ms(lambda: b.transpose(1, 2).contiguous()),
                "copy_aT_ms": time_ms(lambda: a.transpose(1, 2).contiguous()),
                "dA_plain_ms": time_ms(lambda: gmm_ref(dy, bT), graph=False),
                "dB_plain_ms": time_ms(lambda: gmm_ref(aT, dy), graph=False),
                "dA_library_ms": time_ms(lambda: torch.bmm(dy, bT)),
                "dB_library_ms": time_ms(lambda: torch.bmm(aT, dy)),
                "dA_bound_ms": bd_a[0], "dA_bound_by": bd_a[1],
                "dB_bound_ms": bd_b[0], "dB_bound_by": bd_b[1]})
            print(f"  {label}: dA {route_da} {cases[-1]['dA_ms']:.4f} ms (bound "
                  f"{bd_a[0]:.4f}, bmm {cases[-1]['dA_library_ms']:.4f}), dB {route_db} "
                  f"{cases[-1]['dB_ms']:.4f} ms (bound {bd_b[0]:.4f}, bmm "
                  f"{cases[-1]['dB_library_ms']:.4f}); copies Bt "
                  f"{cases[-1]['copy_bT_ms']:.4f} At {cases[-1]['copy_aT_ms']:.4f} ms; "
                  f"err {cases[-1]['max_abs_err']:.3g}")
            del got, a, b, dy, aT, bT
    # bf16 takes the tensor cores, but dB's inner dimension is the capacity:
    # one that is not a multiple of 8 falls back to the CUDA-core kernel
    want = {c["case"]: ("tc", "tc" if c["capacity"] % 8 == 0 else "fma") for c in cases
            if c["dtype"] == "bfloat16"}
    got = {c["case"]: (c["route_dA"], c["route_dB"]) for c in cases if c["case"] in want}
    if got != want:
        raise AssertionError(f"gmm backward routes {got}, want {want}")
    return cases


def _cs_scan_ms(cfg, dev, B: int, T: int, impl: str, reps: int = 3) -> float:
    """Device-synchronized ms of the cache-simulation loss, forward and
    backward, of every MoE layer of ``cfg`` on (B, T, E) router
    distributions (what one fine-tune step computes for L_cs)."""
    from repro_torch.core.cache_sim import cache_sim_loss

    spec, moe = cfg.melinoe, cfg.moe_spec
    p = torch.softmax(torch.randn(B, T, moe.num_experts, device=dev), -1).requires_grad_()
    kw = dict(top_k=moe.top_k, gamma=spec.gamma, cache_capacity=cfg.melinoe_cache_capacity(),
              request_mode=spec.request_mode, impl=impl)
    out = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cfg.n_moe_layers):
            torch.autograd.grad(cache_sim_loss(p, **kw), p)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return float(np.mean(out[1:]))


def finetune_phase(device: str = "cuda", arch: str = "olmoe", steps: int = TRAIN_STEPS) -> dict:
    """Phase 13: ``training.melinoe_finetune`` of full-width, full-depth
    OLMoE-1B-7B in bf16 (random base from seed 0), ``steps`` steps at batch
    TRAIN_B x TRAIN_T (see the module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import (extract_base_routers, init_lora,
                                       melinoe_trainable_mask)
    from repro_torch.data.synthetic import ClusterLM, SyntheticConfig
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import build_finetune_step
    from repro_torch.models.model import init_params
    from repro_torch.models.runtime import Runtime
    from repro_torch.training import (TRAIN_KERNEL_BACKEND, OptConfig, melinoe_finetune,
                                      train_runtime)

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    dev = torch.device(device)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    lm = ClusterLM(SyntheticConfig(vocab=cfg.vocab, seq_len=TRAIN_T, seed=0))
    mask = melinoe_trainable_mask(params)
    # step 0's loss through the kernels and the plain versions: the adapters
    # and the first batch that melinoe_finetune draws (seed + 1, data seed 2)
    lora0 = init_lora(cfg, cfg.melinoe, generator=torch.Generator(device=dev).manual_seed(1),
                      device=dev)
    batch0 = next(lm.batches(TRAIN_B, seed=2))
    base = extract_base_routers(params, cfg)
    loss0 = {}
    with torch.no_grad():
        for spec in (TRAIN_KERNEL_BACKEND, "ref"):
            step = build_finetune_step(cfg, Runtime(kernel_backend=spec, device=dev),
                                       OptConfig(), mask)
            loss0[spec] = {k: float(v) for k, v in step.loss(params, lora0, batch0, base)[1]
                           .items()}
    del lora0, base
    rel0 = abs(loss0[TRAIN_KERNEL_BACKEND]["loss"] - loss0["ref"]["loss"]) / abs(
        loss0["ref"]["loss"])
    print(f"fine-tune step-0 loss kernels vs plain: {loss0} rel {rel0:.3g} "
          f"(tol {FINETUNE_LOSS_REL_TOL})")
    if not (math.isfinite(rel0) and rel0 <= FINETUNE_LOSS_REL_TOL):
        raise AssertionError(f"fine-tune: step-0 loss disagrees: rel {rel0}")

    def nbytes(tree, m=True):
        if isinstance(tree, dict):
            return sum(nbytes(v, m[k] if isinstance(m, dict) else m) for k, v in tree.items())
        return tree.numel() * tree.element_size() if m else 0

    def numel(tree, m=True):
        if isinstance(tree, dict):
            return sum(numel(v, m[k] if isinstance(m, dict) else m) for k, v in tree.items())
        return tree.numel() if m else 0

    weight_bytes, trainable_bytes = nbytes(params), nbytes(params, mask)
    rt = train_runtime(dev)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    dispatch.reset_launches()
    res = melinoe_finetune(cfg, params, lm.batches(TRAIN_B, seed=2), steps=steps, rt=rt,
                           seed=0, log_every=1)
    torch.cuda.synchronize()
    kl = _gmm_launches()
    totals = (dict(dispatch.LAUNCHES),
              {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES})
    peak = torch.cuda.max_memory_allocated(dev)
    L = cfg.n_moe_layers
    per_step = {"forward": 3 * L, "dA": 3 * L - 2, "dB": 3 * L}
    n = steps * sum(per_step.values())
    want = {"launches": n, "routes": {"tc": n},
            "by_product": {"dA": steps * per_step["dA"], "dB": steps * per_step["dB"]},
            "flash_attn": 0}
    hist = res.history
    times = [h["time"] for h in hist]
    step_ms = [1e3 * (t - p) for t, p in zip(times, [0.0] + times[:-1])]
    ms = float(np.mean(step_ms[1:]))
    lora_bytes = nbytes(res.lora)
    n_train = numel(params, mask) + numel(res.lora)
    rep = {
        "arch": arch, "batch": TRAIN_B, "seq": TRAIN_T, "steps": steps,
        "kernel_backend": TRAIN_KERNEL_BACKEND, "step_ms": step_ms,
        "ms_per_step": ms, "tokens_per_s": TRAIN_B * TRAIN_T / (ms / 1e3),
        "history": [{k: h[k] for k in ("loss", "nll", "cs_loss", "rm_loss")} for h in hist],
        "launches": kl, "launches_per_step": per_step, "step0_loss_rel": rel0,
        "launches_total": totals[0], "route_launches": totals[1],
        "max_memory_allocated": peak, "weight_bytes": weight_bytes,
        "trainable_copy_bytes": trainable_bytes, "lora_bytes": lora_bytes,
        "grad_bytes": trainable_bytes + lora_bytes, "moment_bytes": 2 * 4 * n_train,
    }
    print("fine-tune olmoe:", json.dumps(rep))
    if kl != want:
        raise AssertionError(f"fine-tune: launches {kl}, want {want}")
    if not all(math.isfinite(h[k]) for h in hist for k in ("loss", "nll", "cs_loss",
                                                           "rm_loss")):
        raise AssertionError(f"fine-tune: non-finite loss {hist}")
    if len(hist) != steps:
        raise AssertionError(f"fine-tune: {len(hist)} logged steps, want {steps}")
    del res, params
    gc.collect()
    torch.cuda.empty_cache()
    rep["cs_scan_ms"] = _cs_scan_ms(cfg, dev, TRAIN_B, TRAIN_T, "scan")
    rep["cs_assoc_ms"] = _cs_scan_ms(cfg, dev, TRAIN_B, TRAIN_T, "assoc")
    rep["cs_scan_share"] = rep["cs_scan_ms"] / ms
    rep["phase_s"] = time.perf_counter() - t_phase
    print(f"fine-tune olmoe: {ms:.1f} ms a step, {rep['tokens_per_s']:.1f} tokens/s; "
          f"cache-sim loss (scan, fwd+bwd, {L} layers) {rep['cs_scan_ms']:.1f} ms = "
          f"{100 * rep['cs_scan_share']:.1f}% of a step (assoc {rep['cs_assoc_ms']:.1f} ms); "
          f"peak {peak} B; phase {rep['phase_s']:.1f} s")
    return rep


def train_launcher_phase(device: str = "cuda") -> dict:
    """Phase 14: ``python -m repro_torch.launch.train --mode both`` on
    olmoe-mini for a few steps on the card; both checkpoints read back."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.core.lora import init_lora
    from repro_torch.models.model import init_params
    from repro_torch.training import load_checkpoint

    arch = "olmoe-mini"
    cfg = get_config(arch)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--mode",
               "both", "--steps", "3", "--ft-steps", "3", "--batch", "4", "--seq", "64",
               "--device", device, "--out", d]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                                   if os.environ.get("PYTHONPATH") else [])))
        out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600,
                             cwd=str(ROOT))
        if out.returncode != 0 or "done" not in out.stdout:
            raise AssertionError(f"launch.train exited {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
        like = init_params(cfg, generator=torch.Generator(), dtype=torch.float32,
                           device="meta")
        lora_like = init_lora(cfg, cfg.melinoe, generator=torch.Generator(), device="meta")
        base, step_b, meta_b = load_checkpoint(Path(d) / f"{arch}_base.ckpt", like)
        (fp, fl), step_f, meta_f = load_checkpoint(Path(d) / f"{arch}_melinoe.ckpt",
                                                   (like, lora_like))
        hist = json.loads((Path(d) / f"{arch}_melinoe_history.json").read_text())
    leaves = [t for tr in (base, fp, fl) for _, t in _grad_leaves(tr)]
    ok = (step_b == 3 and step_f == 3 and meta_b["stage"] == "pretrain"
          and meta_f["stage"] == "melinoe" and all(torch.isfinite(t).all() for t in leaves)
          and not torch.equal(fp["groups"]["g0"]["p0"]["ffn"]["router"],
                              base["groups"]["g0"]["p0"]["ffn"]["router"]))
    rep = {"arch": arch, "leaves": len(leaves), "finetune_history": hist,
           "wall_s": time.perf_counter() - t0, "ok": ok}
    print("launch.train olmoe-mini:", json.dumps(rep))
    if not ok:
        raise AssertionError("launch.train: checkpoints not as written")
    return rep


# ---------------------------------------------------------------------------
# The paper's comparison systems and the little-expert tier (phases 15-16)
# ---------------------------------------------------------------------------


def _check_phases(path: str, by_phase: dict, want: dict) -> None:
    """moe_gmm launches of a serve by phase and route, exactly ``want``."""
    got = {ph: r.get("moe_gmm", {}) for ph, r in by_phase.items()}
    if got != want:
        raise AssertionError(f"{path}: moe_gmm by phase {got}, want {want}")


def _serve_row(eng, prompts, dev, **gen_kw) -> tuple:
    """One ``generate`` of ``eng``, counters set to 0 just before: (its
    result, a row of its numbers)."""
    from repro_torch.kernels import dispatch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dispatch.reset_launches()
    res = eng.generate(prompts, max_new_tokens=32, **gen_kw)
    torch.cuda.synchronize()
    m, st = res["metrics"], res["cache_stats"]
    row = {"capacity": eng.capacity, "transfers": m.transfers,
           "host_executed": m.host_executed, "degraded_uses": m.degraded_uses,
           "hit_rate": st.hit_rate, "hits": st.hits, "misses": st.misses,
           "modeled_time_s": res["modeled_time_s"],
           "modeled_time_overlapped_s": res["modeled_time_overlapped_s"],
           "modeled_tok_s": res["throughput_tok_s"],
           "modeled_overlapped_tok_s": res["throughput_overlapped_tok_s"],
           "prefill_s": res["prefill_s"], "decode_tok_s": res["decode_tok_s"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "slab_bytes": eng.slab_bytes, "quantize_s": eng.quantize_s,
           "stopped_early": res["stopped_early"],
           "launches_total": dict(dispatch.LAUNCHES),
           "route_launches": {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES},
           "by_phase": res["route_launches"]}
    return res, row


def serve_baselines(main_tokens, psi_scores, arch: str = "olmoe",
                    device: str = "cuda") -> tuple:
    """Phase 15: the main path's batch (4 x (128 + 32) tokens, weights of
    seed 0, bf16, C = 16) through every ``core.baselines.BASELINES`` entry
    via ``make_engine``: the bf16 ones on one pinned store, quant_cache on
    its own INT4 store (phase 5's is gone by now: quantized here, with
    ``quantize_s``), melinoe prefetching phase 11's Psi scores. Gates (see
    the module docstring). Returns (report, (params, store, prompts)) for
    phases 16 and 17 (a list, which phase 17 empties). ``arch``/``device``: a
    smaller model or the CPU, to rehearse the phase's logic."""
    from repro_torch.configs import get_config
    from repro_torch.core.baselines import BASELINES, make_engine
    from repro_torch.core.offload_engine import HardwareProfile
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import init_params

    t_phase = time.perf_counter()
    print(f"baselines phase: host memory available {_host_available_gib():.1f} GiB")
    cfg = get_config(arch)
    dev = torch.device(device)
    B, T, new, C = 4, 128, 32, 16
    prompts = make_prompts(cfg.vocab, B, T)
    # the main path's weights: launch.serve.run's draw, experts on the host
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev, expert_device="cpu")
    rows, store, logits = {}, None, {}
    for name, spec in BASELINES.items():
        path = f"baseline-{name}"
        eng = make_engine(cfg, params, spec, capacity=C, hw=HardwareProfile(), device=dev,
                          **({} if spec.quantized else {"host_store": store}))
        if store is None and not spec.quantized:
            store = eng.host_store
        if spec.use_predictor:
            eng.prefetch(psi_scores)
        res, row = _serve_row(eng, prompts, dev)
        check_path(path, row["launches_total"], row["route_launches"])
        _check_phases(path, row["by_phase"], BASELINE_GMM[BASELINE_SETS[name]])
        if spec.quantized:
            int4 = {ph: r["int4_matmul"] for ph, r in row["by_phase"].items()}
            if any(set(r) - set(INT4_PHASE_ROUTES[ph]) for ph, r in int4.items()):
                raise AssertionError(f"{path}: int4_matmul by phase {int4}")
        toks = res["tokens"].cpu().numpy()
        row["tokens_equal_main"] = bool(np.array_equal(toks, main_tokens))
        row["prefetch_transfers"] = res["metrics"].prefetch_transfers
        logits[name] = res["prefill_logits"].float().cpu()
        rows[name] = row
        print(f"{path}:", json.dumps({k: v for k, v in row.items() if k != "by_phase"}),
              f"by phase {row['by_phase']}")
        del eng, res
        gc.collect()
        torch.cuda.empty_cache()
    _strip_experts(params)  # the shared store holds them
    gc.collect()
    # the plain run of stream_all's prefill: every expert through the overflow
    # group, without kernels
    plain = make_engine(cfg, params, BASELINES["stream_all"], capacity=C, hw=HardwareProfile(),
                        device=dev, host_store=store, kernel_backend="ref")
    plain_logits = plain.generate(prompts, max_new_tokens=1)["prefill_logits"].float().cpu()
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    stream_rel = _rel(logits["stream_all"], plain_logits)

    print("baseline            transfers  host_exec  hit_rate  serial_s  overlap_s  "
          "model_tok/s  prefill_s  decode_tok/s  peak_GB  gmm(pre/dec)  int4")
    for name, r in rows.items():
        ph = r["by_phase"]
        print(f"{name:18s} {r['transfers']:10d} {r['host_executed']:10d} "
              f"{r['hit_rate']:9.4f} {r['modeled_time_s']:9.4f} "
              f"{r['modeled_time_overlapped_s']:10.4f} {r['modeled_tok_s']:12.2f} "
              f"{r['prefill_s']:10.4f} {r['decode_tok_s']:13.2f} "
              f"{r['max_memory_allocated'] / 1e9:8.2f}  "
              f"{ph['prefill'].get('moe_gmm')}/{ph['decode'].get('moe_gmm')}  "
              f"{ph['prefill'].get('int4_matmul')}/{ph['decode'].get('int4_matmul')}")
    L, K = cfg.n_moe_layers, cfg.moe_spec.top_k
    want_stream = L * K * (B * T + B * (new - 1))
    print(f"stream_all transfers {rows['stream_all']['transfers']} (want {want_stream}); "
          f"cpu_execute transfers {rows['cpu_execute']['transfers']}, host_executed "
          f"{rows['cpu_execute']['host_executed']} (static_lfu transfers "
          f"{rows['static_lfu']['transfers']}); stream_all prefill logits kernel vs plain "
          f"rel {stream_rel:.3g} (tol {LOGITS_REL_TOL})")
    if rows["stream_all"]["transfers"] != want_stream:
        raise AssertionError(f"stream_all: {rows['stream_all']['transfers']} transfers, "
                             f"want {want_stream}")
    if not (rows["cpu_execute"]["transfers"] == 0 and rows["cpu_execute"]["host_executed"]
            == rows["static_lfu"]["transfers"] > 0):
        raise AssertionError(f"cpu_execute: {rows['cpu_execute']}")
    bad = [n for n, r in rows.items() if n != "quant_cache" and not r["tokens_equal_main"]]
    if bad:
        raise AssertionError(f"baselines {bad}: tokens differ from the main path's")
    if not (math.isfinite(stream_rel) and stream_rel <= LOGITS_REL_TOL):
        raise AssertionError(f"stream_all prefill logits disagree: rel {stream_rel}")
    rep = {"rows": rows, "stream_all_logits_rel": stream_rel,
           "phase_s": time.perf_counter() - t_phase}
    print(f"baselines phase: {rep['phase_s']:.1f} s")
    return rep, [params, store, prompts]


def little_phase(main_tokens, main_stats: dict, shared: tuple, arch: str = "olmoe",
                 device: str = "cuda") -> dict:
    """Phase 16: the little-expert tier on the main path's batch and
    weights (``shared``: phase 15's params, pinned store and prompts), C =
    16, gamma: a rank-8 bank built on the card, then serves at quality 1.0,
    0.5 and 0.0 and under a deadline of half the quality-1.0 run's serial
    modeled seconds (each on a fresh engine serving the same bank), then
    ``bench_serve --offloaded --little --quality 0.5`` at full width."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import OffloadedMoEEngine
    from repro_torch.launch import bench_serve

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    dev = torch.device(device)
    params, store, prompts = shared
    eng_kw = dict(capacity=16, policy="gamma", host_store=store, device=dev)
    eng = OffloadedMoEEngine(cfg, params, little_experts=True, little_rank=LITTLE_RANK,
                             **eng_kw)
    bank = eng.little
    print(f"little bank: rank {bank.rank}, {bank.n_layers} layers built in "
          f"{eng.little_build_s:.2f} s ({eng.little_build_s / bank.n_layers:.3f} s a layer), "
          f"{bank.device_bytes} B ({bank.bytes_per_layer()} B a layer)")
    if arch == "olmoe" and bank.device_bytes != LITTLE_BANK_BYTES:
        raise AssertionError(f"little bank: {bank.device_bytes} B, want {LITTLE_BANK_BYTES}")
    rows, logits = {}, {}
    for label, kw in (("q1.0", {"quality": 1.0}), ("q0.5", {"quality": 0.5}),
                      ("q0.0", {"quality": 0.0})):
        e = eng if label == "q1.0" else OffloadedMoEEngine(cfg, params, little_bank=bank,
                                                            **eng_kw)
        subs0 = bank.substitutions
        res, row = _serve_row(e, prompts, dev, **kw)
        row["substitutions"] = bank.substitutions - subs0
        row["tokens_equal_main"] = bool(np.array_equal(res["tokens"].cpu().numpy(),
                                                       main_tokens))
        logits[label] = res["prefill_logits"].float().cpu()
        row["prefill_logits_rel_vs_q1.0"] = _rel(logits[label], logits["q1.0"])
        if label == "q1.0":
            row["prefill_serial_s"] = e.metrics.serial_span(e.hw, 0, 1)
            row["step1_serial_s"] = e.metrics.serial_span(e.hw, 1, 2)
        for op, fast in FAST_ROUTES.items():
            if set(row["route_launches"][op]) - set(fast):
                raise AssertionError(f"little {label}: {op} routes {row['route_launches'][op]}")
        rows[label] = row
        print(f"little {label}:", json.dumps({k: v for k, v in row.items() if k != "by_phase"}))
        if e is not eng:
            del e
    check_path("little-q1.0", rows["q1.0"]["launches_total"], rows["q1.0"]["route_launches"])
    q1, q0 = rows["q1.0"], rows["q0.0"]
    if not (q1["tokens_equal_main"] and q1["transfers"] == main_stats["transfers"]
            and q1["degraded_uses"] == 0):
        raise AssertionError(f"little q1.0: the bank is not inert: {q1}")
    if not (q0["transfers"] == 0 and q0["degraded_uses"] > 0
            and q0["modeled_time_s"] < q1["modeled_time_s"]):
        raise AssertionError(f"little q0.0: {q0}")

    # deadlines. Half the exact run's serial seconds: its prefill alone (the
    # batch's 512 prompt tokens, most of the run's misses) spends that, so
    # the call stops after the prefill. A budget that the prefill and the
    # first decode step take past pressure_frac of, and not whole: every
    # later miss goes little and is not charged, so the call runs to its
    # end inside the budget.
    budgets = {"deadline_half": 0.5 * q1["modeled_time_s"],
               "deadline_pressure": (q1["prefill_serial_s"] + q1["step1_serial_s"]) / 0.8}
    for label, budget in budgets.items():
        e = OffloadedMoEEngine(cfg, params, little_bank=bank, **eng_kw)
        res, row = _serve_row(e, prompts, dev, deadline_s=budget)
        row.update(deadline_s=budget, decode_steps=int(res["tokens"].shape[1]) - 1,
                   prefill_logits_rel_vs_q1_0=_rel(res["prefill_logits"].float().cpu(),
                                                   logits["q1.0"]))
        rows[label] = row
        print(f"little {label}:", json.dumps({k: v for k, v in row.items()
                                              if k != "by_phase"}))
        del e, res
    half, press = rows["deadline_half"], rows["deadline_pressure"]
    if not (half["stopped_early"] and half["modeled_time_s"] >= half["deadline_s"]):
        raise AssertionError(f"little deadline_half: {half}")
    if not (press["degraded_uses"] > 0 and not press["stopped_early"]
            and press["decode_steps"] == 31 and press["modeled_time_s"] <= press["deadline_s"]
            and press["transfers"] < q1["transfers"]):
        raise AssertionError(f"little deadline_pressure: {press}")
    del eng, bank, params, store
    gc.collect()
    torch.cuda.empty_cache()

    # the launcher at full width: 4 requests in one wave, quality 0.5
    t0 = time.perf_counter()
    results, mt = bench_serve.main([
        "--arch", arch, "--device", device, "--offloaded", "--capacity", "16",
        "--slots", "4", "--n-requests", "4", "--prompt-len", "128", "--max-new", "32",
        "--arrival", "all_at_once", "--little", "--quality", "0.5"])
    summ = mt.summary()
    rows["bench_serve"] = {k: summ[k] for k in (
        "requests", "generated_tokens", "transfers", "degraded_requests",
        "modeled_time_serial_s", "modeled_time_overlapped_s", "cache_hit_rate")}
    rows["bench_serve"]["wall_s"] = time.perf_counter() - t0
    print("bench_serve --offloaded --little --quality 0.5:", json.dumps(rows["bench_serve"]))
    if not (summ["degraded_requests"] > 0 and summ["requests"] == len(results) == 4):
        raise AssertionError(f"bench_serve --little: {summ}")
    gc.collect()
    torch.cuda.empty_cache()
    rep = {"rows": rows, "phase_s": time.perf_counter() - t_phase}
    print(f"little phase: {rep['phase_s']:.1f} s")
    return rep


# The operations phase (17): phase 15's weights, pinned store and batch
# (phase 4's). The fault specs: a transient fetch failure on 5% of copy
# attempts, retried without limit (the naive policy: no little bank, so no
# miss may degrade), and an eviction storm at a quarter of the decode steps
# dropping half of every layer's residents. The crash-safe wave server crashes at the
# fifth decode step of its second wave (its first wave decodes 7 + 31 + 15 +
# 23 = 76 steps), after a checkpoint per wave.
OPS_FETCH_FAIL = "fail=0.05,seed=0"
OPS_STORM = "storm=0.25:0.5,seed=1"
OPS_WAVE_CRASH_AT = sum(b - 1 for b in SERVE_BUDGETS[:4]) + 5
# bench_serve's journaled continuous serve in fp32 (the token-identity gate
# of a crash and a resume: a resumed request re-prefills prompt +
# watermark, which in bf16 is not the arithmetic of its uninterrupted
# decode): 4 requests, 2 slots, 128 + up to 16 tokens, a checkpoint every
# 4 decode steps, a crash at the tenth. The traced offloaded serve: the same
# 4 requests in one wave, C = 16.
OPS_BENCH = ["--n-requests", "4", "--prompt-len", "128", "--max-new", "16",
             "--arrival", "all_at_once"]
OPS_BENCH_CRASH_AT = 10


def _step_split(spans) -> dict:
    """The seconds inside each ``engine.prefill`` / ``engine.decode_step``
    span, by the name of its direct children (``moe.fetch``,
    ``moe.compute``, ...) and the rest as ``other``: ms per decode step
    (the mean over the run's decode steps) and ms of the prefill."""
    import bisect

    steps = sorted((s.t0, s.t1, s.name) for s in spans
                   if s.name in ("engine.prefill", "engine.decode_step"))
    starts = [s[0] for s in steps]
    split = {"engine.prefill": {}, "engine.decode_step": {}}
    count = {"engine.prefill": 0, "engine.decode_step": 0}
    for t0, t1, name in steps:
        split[name]["step"] = split[name].get("step", 0.0) + (t1 - t0)
        count[name] += 1
    for s in spans:
        if s.depth != 1:
            continue
        i = bisect.bisect_right(starts, s.t0) - 1
        if i < 0 or s.t1 > steps[i][1] + 1e-9:
            continue
        d = split[steps[i][2]]
        d[s.name] = d.get(s.name, 0.0) + s.dur
    out = {}
    for name, d in split.items():
        n = max(count[name], 1)
        ms = {k: 1e3 * v / n for k, v in d.items()}
        ms["other"] = ms.get("step", 0.0) - sum(v for k, v in ms.items() if k != "step")
        out["prefill" if name == "engine.prefill" else "decode_step"] = ms
    out["decode_steps"] = count["engine.decode_step"]
    return out


def _traced_serve(label, eng, prompts, dev, main: dict) -> dict:
    """One traced ``generate`` of ``eng`` (counters set to 0 just before):
    tokens, transfers and launches by route equal to the untraced run's
    (``main``), the Chrome trace valid, ``reconcile``'s per-layer table and
    ``ok``, the split of a step, traced against untraced decode tok/s."""
    from repro_torch.obs import disable_tracing, enable_tracing, reconcile
    from repro_torch.obs.validate import main as validate_main

    tr = enable_tracing()
    try:
        res, row = _serve_row(eng, prompts, dev)
    finally:
        disable_tracing()
    spans = tr.spans()
    if not (np.array_equal(res["tokens"].cpu().numpy(), main["tokens"])
            and row["transfers"] == main["transfers"]
            and row["launches_total"] == main["launches"]
            and row["route_launches"] == main["routes"]):
        raise AssertionError(f"traced {label}: tokens equal "
                             f"{np.array_equal(res['tokens'].cpu().numpy(), main['tokens'])}, "
                             f"transfers {row['transfers']} (untraced {main['transfers']}), "
                             f"launches {row['launches_total']} {row['route_launches']} "
                             f"(untraced {main['launches']} {main['routes']})")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        tr.export_chrome_trace(path, process_name="chip_smoke")
        if validate_main([path]) != 0:
            raise AssertionError(f"traced {label}: the Chrome trace does not validate")
    rep = reconcile(spans, eng.metrics, eng.hw)
    print(f"reconcile, traced {label} serve:\n{rep.format_table()}")
    split = _step_split(spans)
    row.update(spans=len(spans), reconcile_ok=rep.ok,
               serial_agreement_ratio=rep.serial_agreement_ratio,
               measured_fetch_s=rep.measured_fetch_s,
               measured_compute_s=rep.measured_compute_s,
               measured_account_s=rep.measured_account_s, unmodeled_s=rep.unmodeled_s,
               effective_link_bw=rep.effective_link_bw, split_ms=split,
               expert_copies=res["expert_copies"],
               copy_GB_per_s=(sum(res["expert_copies"].values()) * eng.expert_bytes
                              / rep.measured_fetch_s / 1e9 if rep.measured_fetch_s else 0.0),
               untraced_decode_tok_s=main["decode_tok_s"])
    print(f"traced {label}: {len(spans)} spans, reconcile ok {rep.ok} (agreement "
          f"{rep.serial_agreement_ratio:.3f}); decode tok/s traced {row['decode_tok_s']:.2f} "
          f"untraced {main['decode_tok_s']:.2f}; expert copies {res['expert_copies']} "
          f"({eng.expert_bytes} B each) at {row['copy_GB_per_s']:.2f} GB/s over the "
          f"moe.fetch spans")
    print(f"traced {label} split, ms per decode step over {split['decode_steps']}: "
          + json.dumps({k: round(v, 4) for k, v in split["decode_step"].items()}))
    print(f"traced {label} split, ms of the prefill: "
          + json.dumps({k: round(v, 4) for k, v in split["prefill"].items()}))
    return row


def _crash_and_resume(cfg, params, store, dev, jdir, warm: bool, capacity: int) -> dict:
    """Recover the crashed wave server's journal in ``jdir`` and finish the
    run on a fresh server reviving the checkpointed cache warm or cold;
    counters set to 0 just before the resumed ``run``."""
    from repro_torch.kernels import dispatch
    from repro_torch.recovery import RequestJournal, recover
    from repro_torch.serving import OffloadedWaveServer

    state = recover(jdir)
    srv = OffloadedWaveServer(cfg, params, capacity=capacity, policy="gamma", wave_size=4,
                              host_store=store, device=dev)
    srv.engine.metrics.load_state(state.engine["metrics"])
    t0 = srv.engine.metrics.transfers
    rev = srv.engine.revive(state.engine["cache"], warm=warm)
    checkpointed = sum(len(st["resident"]) for st in state.engine["cache"])
    jr = RequestJournal(jdir, seen=state.seen_rids)
    torch.cuda.synchronize()
    dispatch.reset_launches()
    results, mt = srv.run(state.build_queue(), state.metrics, journal=jr, checkpoint_every=1,
                          audit_every=1, resume=state)  # the watchdog raises on a finding
    torch.cuda.synchronize()
    jr.close()
    return {"results": results, "loaded": rev["loaded"], "checkpointed": checkpointed,
            "checkpoint_transfers": t0,
            "demand_transfers_after_resume": srv.engine.metrics.transfers - t0,
            "pending_at_resume": len(state.pending), "finished_at_resume": len(state.results),
            "audit": srv.engine.audit(), "generated_tokens": mt.generated_tokens,
            "launches_total": dict(dispatch.LAUNCHES),
            "route_launches": {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}}


def _first_difference(a, b):
    """The first (request, position) where two token lists differ, or None."""
    for rid, (x, y) in enumerate(zip(a, b)):
        n = min(len(x), len(y))
        bad = np.nonzero(np.asarray(x[:n]) != np.asarray(y[:n]))[0]
        if bad.size or len(x) != len(y):
            return rid, int(bad[0]) if bad.size else n
    return None


def ops_phase(main: dict, int4: dict, shared: list, arch: str = "olmoe",
              device: str = "cuda", capacity: int = 16) -> dict:
    """Phase 17, the operations stack: (a) phase 4's batch traced, bf16 and
    INT4; (b) the engine under a fetch-failure plan and an eviction storm;
    (c) the crash-safe wave server: journaled, checkpointed and audited,
    crashed mid-serve, resumed warm and, separately, cold; (d)
    ``bench_serve`` with ``--trace``, and with ``--journal --faults
    crash_at=`` then ``--resume`` in fp32. ``main`` / ``int4``: phases 4
    and 5 (tokens, transfers, launches by route, decode tok/s); ``shared``:
    phase 15's params, pinned store and prompts, emptied here.
    ``arch``/``device``/``capacity``: a smaller model or the CPU, to
    rehearse the phase's logic."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import OffloadedMoEEngine
    from repro_torch.core.quant import matmul_layout, quantize_linear
    from repro_torch.faults import (NAIVE_POLICY, InjectedCrash, install_fault_plan,
                                    uninstall_fault_plan)
    from repro_torch.kernels import dispatch
    from repro_torch.launch import bench_serve
    from repro_torch.launch.serve import make_prompts
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.recovery import RequestJournal, recover
    from repro_torch.serving import OffloadedWaveServer, RequestQueue, ServeRequest

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    dev = torch.device(device)
    params, store, prompts = shared
    rows = {}
    eng_kw = dict(capacity=capacity, policy="gamma", device=dev)

    # ---- (a) the traced serves
    rows["traced-bf16"] = _traced_serve("bf16", OffloadedMoEEngine(
        cfg, params, host_store=store, **eng_kw), prompts, dev, main)
    t0 = time.perf_counter()
    # phase 5's codes again: the same experts (the store's), quantized on the card
    qexp = [{k: matmul_layout(quantize_linear(layer[k].to(dev), iters=4, group=32))
             for k in ("wg", "wu", "wd")} for layer in store]
    for gi, g in enumerate(cfg.layout):  # the engine reads only the experts' shapes
        for bp in params["groups"][f"g{gi}"].values():
            if "router" in bp.get("ffn", {}):
                for k, v in store[0].items():
                    bp["ffn"][k] = torch.empty((g.repeats,) + tuple(v.shape), dtype=v.dtype,
                                               device="meta")
    qeng = OffloadedMoEEngine(cfg, params, quantized=True, quantized_experts=qexp, **eng_kw)
    del qexp
    print(f"INT4 store for the traced serve: {time.perf_counter() - t0:.1f} s")
    rows["traced-int4"] = _traced_serve("INT4", qeng, prompts, dev, int4)
    del qeng
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) faults on the engine
    for label, spec in (("fault-fetch", OPS_FETCH_FAIL), ("fault-storm", OPS_STORM)):
        eng = OffloadedMoEEngine(cfg, params, host_store=store, fetch_policy=NAIVE_POLICY,
                                 **eng_kw)
        plan = install_fault_plan(spec)
        try:
            res, row = _serve_row(eng, prompts, dev)
        finally:
            uninstall_fault_plan()
        m = res["metrics"]
        row.update(fault_counters=dict(plan.counters), fetch_failures=m.fetch_failures,
                   fetch_retries=m.fetch_retries, fault_delay_s=m.fault_delay_s,
                   evictions=res["cache_stats"].evictions, audit=eng.audit(),
                   tokens_equal_main=bool(np.array_equal(res["tokens"].cpu().numpy(),
                                                         main["tokens"])))
        rows[label] = row
        print(f"{label} ({spec}):", json.dumps({k: v for k, v in row.items()
                                                if k != "by_phase"}))
        if not (row["tokens_equal_main"] and row["audit"] == []):
            raise AssertionError(f"{label}: tokens equal {row['tokens_equal_main']}, "
                                 f"audit {row['audit']}")
        del eng, res
    ff, st = rows["fault-fetch"], rows["fault-storm"]
    if not (ff["fetch_failures"] > 0 and ff["transfers"] == main["transfers"]
            and ff["modeled_time_s"] >= main["modeled_time_s"] and ff["degraded_uses"] == 0):
        raise AssertionError(f"fault-fetch: {ff}")
    if not (st["fault_counters"]["storm"] > 0 and st["transfers"] > main["transfers"]):
        raise AssertionError(f"fault-storm: {st}")

    # ---- (c) the crash-safe wave server: the wave phase's 8 requests
    n = len(SERVE_BUDGETS)
    wprompts = make_prompts(cfg.vocab, n, SERVE_PROMPT)

    def reqs_of():
        return [ServeRequest(rid=i, prompt=wprompts[i], max_new_tokens=SERVE_BUDGETS[i])
                for i in range(n)]

    wave_kw = dict(capacity=capacity, policy="gamma", wave_size=4, host_store=store,
                   device=dev)
    ref_srv = OffloadedWaveServer(cfg, params, **wave_kw)
    ref, _ = ref_srv.run(RequestQueue(reqs_of()))
    ref_toks = [r.tokens.tolist() for r in ref]
    ref_transfers = ref_srv.engine.metrics.transfers
    del ref_srv
    with tempfile.TemporaryDirectory() as d:
        jdir, cold_dir = os.path.join(d, "journal"), os.path.join(d, "journal-cold")
        jr = RequestJournal(jdir)
        install_fault_plan(f"crash_at={OPS_WAVE_CRASH_AT},seed=0")
        try:
            OffloadedWaveServer(cfg, params, **wave_kw).run(
                RequestQueue(reqs_of()), journal=jr, checkpoint_every=1, audit_every=1)
            raise AssertionError("the wave server did not crash")
        except InjectedCrash as e:
            print(f"wave server: {e}")
        finally:
            uninstall_fault_plan()
            jr.close()
        shutil.copytree(jdir, cold_dir)
        snapshot = recover(jdir).engine["cache"]  # the checkpoint after wave 1
        resumed = {"warm": _crash_and_resume(cfg, params, store, dev, jdir, True, capacity),
                   "cold": _crash_and_resume(cfg, params, store, dev, cold_dir, False,
                                             capacity)}
    for mode, r in resumed.items():
        toks = [x.tokens.tolist() for x in r.pop("results")]
        r["tokens_equal_uninterrupted"] = toks == ref_toks
        r["first_difference"] = _first_difference(toks, ref_toks)
        rows[f"wave-resume-{mode}"] = r
        print(f"wave server resumed {mode}:", json.dumps(r))
        if not (len(toks) == n and r["audit"] == [] and r["tokens_equal_uninterrupted"]):
            raise AssertionError(f"wave server resumed {mode}: {r}")
    # Warm revival restores the cache's accounting exactly: the resumed run
    # repeats the uninterrupted run's misses after the checkpoint. The
    # resumed requests are new prompts of a random model, whose routing
    # shares nothing with the checkpoint's residents, so after a full wave
    # warm and cold need not differ in sign (the saving is at most the C
    # residents of each layer, touched before the first evictions). The
    # checkpoint's own traffic again (wave 1's last prompt re-prefilled on
    # engines revived from the snapshot, as the reference's test does)
    # shows the saving.
    warm, cold = resumed["warm"], resumed["cold"]
    want = ref_transfers - warm["checkpoint_transfers"]
    same = {}
    for mode in ("warm", "cold"):
        eng = OffloadedMoEEngine(cfg, params, host_store=store, **eng_kw)
        eng.revive(snapshot, warm=mode == "warm")
        t0 = eng.metrics.transfers
        eng.generate(wprompts[3][None], max_new_tokens=1)
        same[mode] = eng.metrics.transfers - t0
        del eng
    rows["wave-revival"] = {"uninterrupted_after_checkpoint": want,
                            "warm_after_resume": warm["demand_transfers_after_resume"],
                            "cold_after_resume": cold["demand_transfers_after_resume"],
                            "same_traffic_warm": same["warm"], "same_traffic_cold": same["cold"]}
    print("wave revival, demand transfers:", json.dumps(rows["wave-revival"]))
    if not (warm["loaded"] == warm["checkpointed"] > 0 and cold["loaded"] == 0
            and warm["demand_transfers_after_resume"] == want
            and same["warm"] < same["cold"]):
        raise AssertionError(f"wave revival: {rows['wave-revival']}, warm {warm}, cold {cold}")
    shared.clear()
    del params, store, prompts
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) bench_serve on the card
    base = ["--arch", arch, "--device", device]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        bench_serve.main(base + OPS_BENCH + ["--offloaded", "--capacity", str(capacity),
                                             "--slots", "4", "--trace", d])
        names = sorted(os.listdir(d))
        with open(os.path.join(d, "reconcile.json")) as f:
            rec = json.load(f)
        with open(os.path.join(d, "trace.json")) as f:
            errs = validate_chrome_trace(json.load(f))
        rows["bench-trace"] = {"files": names, "reconcile_ok": rec["ok"],
                               "serial_agreement_ratio": rec["serial_agreement_ratio"],
                               "trace_errors": errs[:5], "wall_s": time.perf_counter() - t0}
        print("bench_serve --offloaded --trace:", json.dumps(rows["bench-trace"]))
        if errs or not {"trace.json", "trace.jsonl", "metrics.json", "metrics.prom",
                        "reconcile.json"} <= set(names):
            raise AssertionError(f"bench_serve --trace: {rows['bench-trace']}")

        t0 = time.perf_counter()
        fp32 = base + OPS_BENCH + ["--slots", "2", "--dtype", "float32"]
        full, _ = bench_serve.main(fp32)
        jdir = os.path.join(d, "journal")
        if bench_serve.main(fp32 + ["--journal", jdir, "--checkpoint-every", "4",
                                    "--faults", f"crash_at={OPS_BENCH_CRASH_AT}"]) is not None:
            raise AssertionError("bench_serve --faults crash_at: no injected crash")
        res, mt = bench_serve.main(fp32 + ["--journal", jdir, "--resume"])
        toks = {k: [r.tokens.tolist() for r in rs] for k, rs in (("full", full),
                                                                  ("resumed", res))}
        rows["bench-crash-resume-fp32"] = {
            "requests": len(toks["resumed"]), "tokens_equal": toks["resumed"] == toks["full"],
            "first_difference": _first_difference(toks["resumed"], toks["full"]),
            "generated_tokens": mt.generated_tokens, "wall_s": time.perf_counter() - t0}
        print("bench_serve --journal --faults crash_at, then --resume (fp32):",
              json.dumps(rows["bench-crash-resume-fp32"]))
        if not (rows["bench-crash-resume-fp32"]["tokens_equal"]
                and len(toks["resumed"]) == 4
                and mt.generated_tokens == sum(len(t) for t in toks["full"])):
            raise AssertionError(f"bench_serve crash/resume: {rows['bench-crash-resume-fp32']}")
    gc.collect()
    torch.cuda.empty_cache()
    rep = {"rows": rows, "phase_s": time.perf_counter() - t_phase}
    print(f"operations phase: {rep['phase_s']:.1f} s")
    return rep


def kernel_entry(name, source, replaces, cases, main_case, launches, fma_source=None):
    """One line entry: the main-path case's numbers, the worst error over
    every case, and every case beside it. ``source`` is the kernel the
    main-path case runs; ``fma_source`` the kept CUDA-core kernel (fp32,
    and ``fma_ms``) where the op has routes."""
    head = next(c for c in cases if c["case"] == main_case)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tol": head["tol"], "case": main_case, "ms": head["ms"],
            "kernel_ms": head["ms"], "eager_ms": head["eager_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            **({"fma_ms": head["fma_ms"], "fma_source": fma_source}
               if fma_source else {}), "cases": cases}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this "
                         "smoke run needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references in fp32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build, dispatch
    from repro_torch.launch.serve import run

    t0 = t_start = time.perf_counter()
    _build.lib()
    print(f"kernel build and load: {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    g_cases = gmm_cases(gen)
    f_cases = flash_cases(gen)
    i_cases = int4_cases(gen)
    s_cases = ssd_cases(gen)
    for c in g_cases + f_cases + i_cases + s_cases:
        print(f"  {c['case']}: route {c.get('route', 'cuda')} err {c['max_abs_err']:.3g} "
              f"kernel {c['ms']:.4f} ms"
              + (f" (CUDA-core route {c['fma_ms']:.4f} ms)" if "fma_ms" in c else "")
              + f" eager {c['eager_ms']:.4f} ms"
              + f" plain {c['plain_ms']:.4f} ms bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}) library {c['library_ms']}"
              + (f" plain chunked {c['plain_chunked_ms']:.4f} ms"
                 if "plain_chunked_ms" in c else "")
              + (f" int4pack {c['library_int4pack_ms']}" if "library_int4pack_ms" in c
                 else ""))

    # ---- the main path: full-width olmoe through the port's serve entry
    serve_kw = dict(capacity=16, policy="gamma", batch=4, prompt_len=128,
                    dtype=torch.bfloat16, device="cuda", seed=0)
    dispatch.reset_launches()
    rep = run("olmoe", max_new=32, **serve_kw)
    launches = dict(dispatch.LAUNCHES)
    routes = {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}
    check_path("bf16", launches, routes)
    tokens, logits = rep["tokens"], rep["prefill_logits"]
    if tokens.shape != (4, 32) or logits.shape != (4, 50_304):
        raise AssertionError(f"shapes: tokens {tokens.shape} logits {logits.shape}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    print("serve olmoe:", json.dumps({k: v for k, v in rep.items()
                                      if k not in ("tokens", "prefill_logits")}))
    print(f"launches on the main path: {launches}")
    main_stats = {k: rep[k] for k in ("transfers", "prefetch_transfers", "hit_rate",
                                      "modeled_time_s", "decode_tok_s", "prefill_s")}
    ops_main = dict(main_stats, tokens=tokens, launches=launches, routes=routes)

    ref = run("olmoe", max_new=1, kernel_backend="ref", **serve_kw)
    diff = (logits - ref["prefill_logits"]).float()
    rel = (diff.norm() / ref["prefill_logits"].float().norm()).item()
    top1 = (logits.argmax(-1) == ref["prefill_logits"].argmax(-1)).float().mean().item()
    print(f"prefill logits kernel vs plain: rel {rel:.3g} (tol {LOGITS_REL_TOL}), "
          f"max abs {diff.abs().max().item():.3g}, top-1 agreement {top1:.2f}")
    if not (math.isfinite(rel) and rel <= LOGITS_REL_TOL):
        raise AssertionError(f"prefill logits disagree: rel {rel}")

    # ---- the INT4 path (Sec 3.2): the same batch with HQQ INT4 experts
    dispatch.reset_launches()
    qrep = run("olmoe", max_new=32, quantized=True, keep_store=True, **serve_kw)
    q_launches = dict(dispatch.LAUNCHES)
    q_routes = {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}
    check_path("int4", q_launches, q_routes)
    q_logits = qrep["prefill_logits"]
    if qrep["tokens"].shape != (4, 32) or q_logits.shape != (4, 50_304):
        raise AssertionError(f"INT4 shapes: tokens {qrep['tokens'].shape} "
                             f"logits {q_logits.shape}")
    if not torch.isfinite(q_logits).all():
        raise AssertionError("non-finite INT4 prefill logits")
    print("serve olmoe quantized:", json.dumps(
        {k: v for k, v in qrep.items()
         if k not in ("tokens", "prefill_logits", "quantized_experts", "host_store")}))
    print(f"launches on the INT4 path: {q_launches}")
    ops_int4 = {"tokens": qrep["tokens"], "transfers": qrep["transfers"],
                "decode_tok_s": qrep["decode_tok_s"], "launches": q_launches,
                "routes": q_routes}
    int4_phases = {ph: r["int4_matmul"] for ph, r in qrep["route_launches"].items()}
    print(f"INT4 path int4_matmul launches by phase and route: {int4_phases}")
    if sum(n for r in int4_phases.values() for n in r.values()) != q_launches["int4_matmul"] \
            or any(set(r) - set(INT4_PHASE_ROUTES[ph]) for ph, r in int4_phases.items()):
        raise AssertionError(f"INT4 path: int4_matmul by phase {int4_phases}, want "
                             f"{INT4_PHASE_ROUTES} summing to {q_launches['int4_matmul']}")
    print(f"slab dequant per MoE layer-step (16 slots x wg/wu/wd -> bf16, plain "
          f"torch): {slab_dequant_ms(gen):.4f} ms")

    qref = run("olmoe", max_new=1, kernel_backend="ref", quantized=True,
               quantized_experts=qrep.pop("quantized_experts"), **serve_kw)
    qdiff = (q_logits - qref["prefill_logits"]).float()
    qrel = (qdiff.norm() / qref["prefill_logits"].float().norm()).item()
    qtop1 = (q_logits.argmax(-1) == qref["prefill_logits"].argmax(-1)
             ).float().mean().item()
    print(f"INT4 prefill logits kernel vs plain (same codes): rel {qrel:.3g} "
          f"(tol {LOGITS_REL_TOL}), max abs {qdiff.abs().max().item():.3g}, "
          f"top-1 agreement {qtop1:.2f}")
    if not (math.isfinite(qrel) and qrel <= LOGITS_REL_TOL):
        raise AssertionError(f"INT4 prefill logits disagree: rel {qrel}")
    vs_bf16 = (q_logits - logits).float()
    print(f"INT4 vs bf16 prefill logits (quantization error, not a gate): rel "
          f"{(vs_bf16.norm() / logits.float().norm()).item():.3g}, top-1 "
          f"agreement {(q_logits.argmax(-1) == logits.argmax(-1)).float().mean().item():.2f}")

    # ---- the full-model path: mamba2/zamba2 through ssd_scan and flash_attn
    del rep, ref, qrep, qref
    gc.collect()
    torch.cuda.empty_cache()
    z_rep = serve_full("zamba2-7b", n_ssd=68, n_flash=13)
    m_rep = serve_full("mamba2-130m", n_ssd=24, n_flash=0)

    # ---- the continuous-batching server: olmoe whole on the card
    c_rep = serve_continuous()

    # ---- the offloaded wave server with LoRA; deepseek offloaded; a checkpoint
    w_rep = serve_wave()
    d_rep = serve_deepseek()
    checkpoint_phase()

    # ---- the activation predictor, and MELINOE training through moe_gmm
    p_rep = predictor_phase(tokens, main_stats, serve_kw)
    from repro_torch.training import TRAIN_KERNEL_BACKEND

    print(f"training kernel spec: {TRAIN_KERNEL_BACKEND}")
    gg_rep = finetune_grad_gate()
    gb_cases = gmm_backward_cases(gen)
    ft_rep = finetune_phase()
    train_launcher_phase()

    # ---- the paper's comparison systems and the little-expert tier
    b_rep, shared = serve_baselines(tokens, p_rep["psi_scores"])
    l_rep = little_phase(tokens, main_stats, shared)

    # ---- the operations stack: tracing, faults, crash-safe serving
    o_rep = ops_phase(ops_main, ops_int4, shared)

    kernels = [
        kernel_entry("moe_gmm", "src/repro_torch/kernels/moe_gmm/csrc/gmm_tc.cu",
                     "src/repro/kernels/moe_gmm/kernel.py:64", g_cases,
                     "gmm bfloat16 a(16,4,2048) b(16,2048,1024)", launches["moe_gmm"],
                     fma_source="src/repro_torch/kernels/moe_gmm/csrc/gmm.cu"),
        kernel_entry("flash_attn", "src/repro_torch/kernels/flash_attn/csrc/flash_attn_tc.cu",
                     "src/repro/kernels/flash_attn/kernel.py:80", f_cases,
                     "flash bfloat16 B4 T128 Hkv16 G1 hd128 softcap=None window=None",
                     launches["flash_attn"],
                     fma_source="src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu"),
        kernel_entry("int4_matmul",
                     "src/repro_torch/kernels/int4_matmul/csrc/int4_matmul_tc.cu",
                     "src/repro/kernels/int4_matmul/kernel.py:55", i_cases,
                     "int4 bfloat16 x(4,2048) w(2048,1024) g32",
                     q_launches["int4_matmul"],
                     fma_source="src/repro_torch/kernels/int4_matmul/csrc/int4_matmul.cu"),
        kernel_entry("ssd_scan", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_tc.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:76", s_cases,
                     "ssd bfloat16 zamba2 x(4,512,112,64) N64 G1 init=False D=True",
                     z_rep["launches_total"]["ssd_scan"]
                     + m_rep["launches_total"]["ssd_scan"],
                     fma_source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"),
    ]
    paths = {"bf16": launches, "int4": q_launches,
             "zamba2-7b": z_rep["launches_total"], "mamba2-130m": m_rep["launches_total"],
             "continuous-olmoe": c_rep["launches_total"],
             "wave-olmoe-fcfs": w_rep["fcfs"]["launches_total"],
             "wave-olmoe-affinity": w_rep["affinity"]["launches_total"],
             "deepseek-offloaded": d_rep["launches_total"],
             "predictor-serve": p_rep["launches_total"],
             "finetune-grad-gate": gg_rep["launches_total"],
             "finetune": ft_rep["launches_total"],
             **{f"baseline-{n}": r["launches_total"] for n, r in b_rep["rows"].items()},
             **{f"little-{n}": r["launches_total"] for n, r in l_rep["rows"].items()
                if "launches_total" in r},
             **{f"ops-{n}": r["launches_total"] for n, r in o_rep["rows"].items()
                if "launches_total" in r}}
    routes = {"bf16": routes, "int4": q_routes, "zamba2-7b": z_rep["route_launches"],
              "mamba2-130m": m_rep["route_launches"],
              "continuous-olmoe": c_rep["route_launches"],
              "wave-olmoe-fcfs": w_rep["fcfs"]["route_launches"],
              "wave-olmoe-affinity": w_rep["affinity"]["route_launches"],
              "deepseek-offloaded": d_rep["route_launches_total"],
              "predictor-serve": p_rep["route_launches"],
              "finetune-grad-gate": gg_rep["route_launches"],
              "finetune": ft_rep["route_launches"],
             **{f"baseline-{n}": r["route_launches"] for n, r in b_rep["rows"].items()},
             **{f"little-{n}": r["route_launches"] for n, r in l_rep["rows"].items()
                if "route_launches" in r},
             **{f"ops-{n}": r["route_launches"] for n, r in o_rep["rows"].items()
                if "route_launches" in r}}
    for k in kernels:  # launches of each path, each counted from 0
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
        if k["name"] in FAST_ROUTES:
            k["routes_by_path"] = {p: r[k["name"]] for p, r in routes.items()}
        if k["name"] == "int4_matmul":
            k["int4_path_by_phase"] = int4_phases
        if k["name"] == "moe_gmm":  # GmmFn: the fine-tune's backward launches
            main_bwd = next(c for c in gb_cases
                            if c["case"] == "gmm backward bfloat16 a(64,160,2048) b(64,2048,1024)")
            k["backward"] = {
                "launches_per_finetune_step": ft_rep["launches_per_step"],
                "finetune_by_product": ft_rep["launches"]["by_product"],
                "grad_gate_by_product": gg_rep["launches"]["by_product"],
                "main_case": main_bwd["case"],
                **{f: main_bwd[f] for f in ("dA_ms", "dB_ms", "dA_bound_ms", "dB_bound_ms",
                                            "dA_library_ms", "dB_library_ms", "copy_bT_ms",
                                            "copy_aT_ms", "route_dA", "route_dB")},
                "cases": gb_cases}
    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
