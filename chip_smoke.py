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
   has it (``library_int4pack_ms``, a time only); and holds the plain
   blockwise attention (``models/attention.py::blockwise_attention``, every
   train step's) against ``attention_ref`` in fp32, output and gradients,
   with its time and peak beside the oracle's (``BLOCKWISE_CASES``);
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
8. frees that model, then serves full-width OLMoE-1B-7B on its first
   ``LAUNCHER_LAYERS`` layers offloaded behind
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
   versions, in bf16 (``DEEPSEEK_BF16_LOGITS_REL_TOL``) and in fp32 on its
   first ``DEEPSEEK_FP32_LAYERS`` layers (``FP32_LOGITS_REL_TOL``);
10. writes a params-only checkpoint of olmoe-mini-smoke with the port's
   ``save_checkpoint``, serves it with ``launch.serve --ckpt`` on the card
   and asserts the tokens of the in-memory run;
11. serves step 4's batch again through ``launch.serve.run(...,
   predictor=True)``: the model traces 32 more prompts in one batch
   (``routing_trace``, 16 new tokens each), its experts staged from the
   engine's pinned store one MoE layer at a time in every forward pass,
   the activation predictor Psi is trained on them, and the engine
   prefetches Psi's scores; counters set to 0 just before. Gates: Psi's KL
   falls, prefetch transfers > 0, tokens equal step 4's, the trace's
   launches (``moe_gmm`` 3 a MoE layer and pass, ``flash_attn`` one a
   layer, all "tc"), and the trace Psi trained on bit-equal to
   ``routing_trace`` of the whole tree drawn on the card from the same
   seed; it prints transfers and hit rate with and without Psi;
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
16. the little-expert tier on the same batch and weights cut to their
   first ``LITTLE_LAYERS`` layers: the cut served without a bank, then a
   rank-8 bank (fp32 factors, ``LITTLE_BANK_BYTES``) built on the card,
   printed with its build seconds; served at quality 1.0 (the bank is
   inert: the tokens, transfers and launches of the cut without a bank),
   0.5 and 0.0 (no transfer, little
   substitutions, a lower modeled clock), then under a deadline of half
   the quality-1.0 run's serial modeled seconds (the prefill spends it:
   the call stops after the prefill) and under one that the prefill and
   the first decode step take past ``pressure_frac`` of (deadline
   pressure: every later miss goes little, uncharged, and the call runs
   to its end inside its budget); each run's prefill-logits distance
   from the exact run and decode tok/s are printed, not gated; then
   ``launch.bench_serve
   --offloaded --little --quality 0.5`` at full width on the first
   ``LAUNCHER_LAYERS`` layers (4 requests), whose summary must count
   degraded requests;
17. the dense and prefix-conditioned configs at full width, bf16, random
   weights from seed 0, each through ``repro_torch.launch.serve.run_full``
   at 4 x (512 + 32) tokens (``DENSE_PATHS``): qwen3-4b (36 layers),
   musicgen-medium (48) and stablelm-12b (40, head dim 160) at full
   depth, gemma2-27b cut to 16 layers, command-r-plus-104b to 4 and
   internvl2-76b to 8 (the layout's repeats replaced; the cut config
   registered under a name of its own); musicgen and internvl2 with a
   ``prefix_embed`` of their published ``prefix_len`` (64 and 256 rows)
   drawn from a seed. Counters set to 0 just before each model: one
   ``flash_attn`` a layer in the prefill, all on "tc", nothing else, and
   nothing in decode. The prefill logits against plain prefills: bf16 at
   the served depth within ``DENSE_BF16_LOGITS_REL_TOL``; then on the
   first layers of the same weights (all of them for qwen3 and musicgen)
   fp32 within ``FP32_LOGITS_REL_TOL`` and the bf16 kernel run within
   ``ACCURACY_RATIO`` of the plain path's own round-off. It prints prefill
   seconds, decode tok/s and peak memory against the weight bytes. Then
   gemma2-27b cut to one local and one global layer on one prompt of
   ``GEMMA2_WINDOW_T`` tokens, past the 4096-token window (bf16 and fp32
   against the plain versions), and the offloaded OLMoE engine on phase
   15's weights, store and prompts with a ``prefix_embed`` of
   ``OFFLOAD_PREFIX_LEN`` rows (launches by phase and route; prefill
   logits against a plain run within ``LOGITS_REL_TOL``);
18. the operations stack (``obs/``, ``faults/``, ``recovery/``) on phase
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
   ``audit()`` empty; (c) the crash-safe wave server (on the first
   ``LAUNCHER_LAYERS`` layers of the same weights and store) on the wave phase's 8
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
   (d) ``launch.bench_serve --offloaded --trace DIR`` at full width on
   ``LAUNCHER_LAYERS`` layers (the
   trace, metrics and ``reconcile.json`` written, the trace valid), and
   ``--journal DIR --faults crash_at=10`` (the injected-crash exit) then
   ``--resume`` on the continuous path in fp32, whose tokens must equal
   an uninterrupted run's (a resumed request re-prefills its prompt and
   watermark; only in fp32 is that the arithmetic of its uninterrupted
   decode);
19. the supervised fleet (``fleet/``): two ``repro_torch.fleet.worker``
   processes of full-width OLMoE-1B-7B on its first ``LAUNCHER_LAYERS``
   layers (``olmoe-4l``) whole on the one card (continuous
   batching, 4 slots each, step 7's 8 requests split between them; the
   environment sets ``REPRO_TORCH_KERNEL_BACKEND=hopper``), after a check
   that the free device memory holds two fp32 copies of the weights:
   (a) fp32, no fault: every request finishes, none unaccounted; (b) fp32
   with worker 0 killed (``os._exit``) at its fourth decode step: a crash
   restart from the journal, a failover time, (a)'s tokens; (c) bf16
   ``python -m repro_torch.launch.bench_fleet`` (16 requests, so a worker
   holds more than its slots) sent SIGTERM once every worker serves: exit
   0, every worker exits 0, every request finished or checkpointed; (d) fp32 ``launch.bench_serve`` on the same model and
   traffic shape: uninterrupted with ``--out-results``, a ``--journal``
   run (its own process) sent SIGTERM mid-serve (exit 0, the ``DRAINED``
   banner), then ``--resume``: the union of tokens equals the
   uninterrupted run. It prints each worker's start-up seconds, launches
   by op and route (read from its log) and peak memory, the fleet's wall
   seconds and tokens per wall second, and failover seconds, and gates
   that ``moe_gmm`` and ``flash_attn`` launched in every worker (``fma``
   in fp32, ``tc``/``stream`` in bf16);
20. the per-expert engine (``OffloadedMoEEngine(impl="dict")``) beside the
   slab engine on phase 4's batch, full-width OLMoE at C = 16: (a) fp32 on
   the first 4 layers, dict against slab on one pinned store: equal
   tokens, transfers, bytes, hits, misses, evictions and both Eq.-3
   clocks; (b) bf16 on the first ``DICT_LAYERS`` layers, both on one store:
   the dict engine's prefill logits against its plain run, one
   ``flash_attn`` ``tc`` a layer in its prefill and no ``moe_gmm`` or
   ``int4_matmul`` launch (its expert products are ``torch.matmul``); (c)
   INT4 codes of the same experts, both engines: the dict engine's
   ``int4_matmul`` on ``tc`` in prefill and ``stream`` in decode, its
   logits against the INT4 slab engine's on the same codes; (d)
   ``launch.bench_serve --offloaded --engine-impl dict`` at full width on
   ``LAUNCHER_LAYERS`` layers, phase 4's shape (4 requests of 128 + 32
   tokens, one wave);
   each engine's prefill s, decode tok/s, transfers, hit rate, clocks and
   launches by phase and route printed side by side (``dict_phase``);
21. expert parallelism: two processes over gloo (NCCL takes one rank per
   device), (1, 2) ("data", "model") meshes: (a) on the card,
   ``apply_moe_sharded`` at OLMoE's MoE width (32 experts a rank), 4 x 128
   tokens, against ``apply_moe_local`` (fp32 1e-5, bf16 2e-2 relative),
   ``moe_gmm`` launches per rank by route ("tc" in bf16); the DTensor model
   path cannot run on CUDA tensors over gloo (DTensor's functional
   collectives end the process with SIGSEGV there; the plain collectives
   work), so (b) and (c) run it on a host mesh at OLMoE's full width cut to
   2 layers, fp32, against the single-device run on the card: (b) a
   prefill and 8 greedy decode steps (the card's tokens, prefill logits
   within 1e-4), (c) the MELINOE train step's loss and gradients (the
   card's loss, grad_norm and every leaf's gradient) (gloo stages CUDA
   tensors through the host: (a)'s time is gloo's transport, not the
   card's); (d) the head-parallel Mamba2 mixer and (e) the shared block's
   MLP split over "model", each at zamba2-7b's width on the card against
   its local version (fp32 1e-5, bf16 2e-2; (e) its weights' gradients
   too); (f) the train step's loss on vocab-split logits
   (``core.losses.vocab_parallel_nll``) at OLMoE's vocab, 4 x 512 rows,
   fp32, against one rank's ``nll_loss`` of the whole logits (loss and
   gradient within 1e-6), its peak beside the gathering form's.
   ``tools/ep_mesh.py`` runs the DTensor path on four cards over NCCL;
22. the dry run (``repro_torch.launch.dryrun``): (a) its one-card
   prediction held against the card, full-width OLMoE-1B-7B in bf16 on a
   ``Runtime`` without a mesh: a prefill of 4 x 512 tokens, a decode step
   over a 4 x 1024-slot cache, and the full-parameter MELINOE train step
   at 8 x 128 cut to ``DRY_TRAIN_LAYERS`` layers (at full depth it is
   predicted only: AdamW's fp32 moments alone do not leave it room on one
   card); for each, ``dry_run`` on fake tensors of the card first, then
   the real step on the card: predicted argument bytes within 1% of the
   ``memory_allocated`` rise as the arguments are placed, predicted peak
   within 10% of ``max_memory_allocated`` over the step (from before the
   arguments), the step's own rise (peak less arguments, which the
   arguments would otherwise hide) within 10% of the card's
   (``max_memory_allocated`` less ``memory_allocated`` after placement),
   and the predicted launches by op and route equal to the
   card's; the shape function's split-K count of ``int4_matmul`` equal to
   the kernel library's at phase 3's shapes; (b) the production meshes,
   ``python -m repro_torch.launch.dryrun --arch olmoe`` over
   ``decode_32k``, ``prefill_32k`` and ``long_500k`` on both meshes
   (``train_4k`` is left out: ``DRY_CLI``), in a child process group that
   sees no card, started right after the kernel build so that it runs
   beside phases 3-21 (within ``DRY_CLI_LIMIT_S``): per record a device's
   argument and peak GB, TFLOP, collective GB by kind, launches by op,
   trace seconds and whether the peak fits the card; every record's
   collective bytes above 0;
23. Mixtral-8x7B (paper Table 6/7: 32 layers, d 4096, 32 q / 8 kv heads of
   128, 8 experts top-2, d_ff 14,336, vocab 32,000; C = 2, gamma) offloaded
   at full width through ``repro_torch.launch.serve.run``, 4 x (128 + 16)
   tokens, random weights from seed 0, each store drawn into one expert
   matrix at a time (``HostExpertStore``) in a child process of its own:
   (a) INT4 at full depth (a 33.8 GB store), (b) bf16 at full depth where
   the host's MemAvailable holds the 84.0 GiB store plus
   ``MIXTRAL_HOST_HEADROOM_GIB``, else at the deepest depth that does
   (printed as a cut). Counters from 0 in each child. Gates: one
   ``flash_attn`` "tc" a layer in the prefill and none in decode;
   ``moe_gmm`` "tc" in the prefill and "stream" in decode, and
   ``int4_matmul`` by ``INT4_PHASE_ROUTES``, each total a positive multiple
   of 3; the prefill logits against a plain run on the same pinned store
   within ``MIXTRAL_ROUNDOFF_SPAN`` x the plain path's own bf16 round-off
   (its distance from a plain run in fp32 activations on the INT4 codes,
   at full depth), the INT4 kernel run within ``ACCURACY_RATIO`` x of it
   from that fp32 run; the build's rise of the child's resident-set
   high-water mark (VmHWM) and the host's MemAvailable drop each within
   ``host_store_bytes`` + ``MIXTRAL_RSS_MARGIN`` (a second host copy of the
   experts would exceed them); and, at full width on ``MIXTRAL_FP32_LAYERS``
   layers, the fp32 kernel run against the plain one within
   ``FP32_LOGITS_REL_TOL``. It prints transfers, hit rate, both Eq.-3 clocks, decode
   tok/s, prefill s, ``quantize_s``, the build's seconds, the host's
   MemAvailable before and after each build, expert copies a decode step,
   and peak device memory beside the slab bytes. (b) then serves its batch
   again with Psi on its kept store (``run(predictor=True, host_store=)``:
   32 training prompts traced 16 tokens each, every forward pass staging
   each MoE layer from the store): Psi's KL falls and is finite, C x layers
   prefetch transfers, the tokens of the run without Psi, the trace's
   launches (``moe_gmm`` 3 x layers x 16 "tc", ``flash_attn`` one "tc" a
   layer), its peak device memory below the non-expert weights + one
   staged layer + ``_mixtral_trace_act_bytes``, the MemAvailable drop
   across the run within ``MIXTRAL_RSS_MARGIN``; it prints the trace's
   seconds, staged bytes and GB/s. (c) ``bench_serve
   --offloaded`` (``MIXTRAL_BENCH``: the wave server, expert-affinity, 2
   requests in one wave) at the bf16 row's depth, its experts drawn into
   the pinned store and its oracle scores streamed one staged layer at a
   time: every request finished, transfers, a hit rate in (0, 1), the
   MemAvailable drop within the store + one layer of experts +
   ``MIXTRAL_RSS_MARGIN``, the peak device memory below the non-expert
   weights + slabs + one layer + ``MIXTRAL_BENCH_ACT_BYTES`` (and the whole
   model), ``moe_gmm`` "tc" in the oracle and the prefills and "stream" in
   decode, one ``flash_attn`` "tc" a layer and request in the oracle and in
   the prefills. (d) Mixtral cut to ``MIXTRAL_CKPT_LAYERS`` layers at full
   width: the streamed oracle and Psi's streamed routing trace (tokens
   and router distributions) equal to the whole tree's, ``save_checkpoint``
   of the tree, ``serve.run(ckpt=)`` with ``serve.run()``'s tokens,
   transfers and hits, ``bench_serve --offloaded --ckpt`` finishing every
   request, each checkpoint read's MemAvailable drop within the store + one
   layer + ``MIXTRAL_RSS_MARGIN``; (c) then (d) in a third child. (e)
   the paper's comparison systems (``core/baselines.py``, Fig. 3), each
   built by ``make_engine(..., capacity=C)`` on a child's kept store with
   the other weights re-drawn from the seed (``mixtral_baselines``): the
   six bf16 ones in the bf16 child after (b), ``melinoe`` prefetching (b)'s
   Psi scores, and ``quant_cache`` (INT4, 3C = 6) in the INT4 child, each
   serving the batch's prompts, ``MIXTRAL_BASELINE_NEW`` new tokens,
   counters from 0. Printed: each row's transfers, ``host_executed``,
   hits, misses, both clocks and their tokens/s, prefill s, decode tok/s,
   expert copies, peak device memory, ``slab_bytes`` and launches, then
   the Fig.-3 ratios of ``melinoe``. Gates: ``stream_all`` L x K x (B x T +
   B x (new - 1)) transfers and no cache access; ``cpu_execute`` none, its
   ``host_executed`` equal to ``static_lfu``'s transfers; ``profile_prefetch``
   equal to ``static_lfu``; the six bf16 rows' tokens equal; ``stream_all``'s
   prefill logits within ``MIXTRAL_ROUNDOFF_SPAN`` x r of the bf16 child's
   plain run; launches by phase and route (``_baseline_launches_ok``); each
   child's MemAvailable drop across its rows under
   ``MIXTRAL_BASELINE_HOST_BYTES``; each row's peak device memory within the
   non-expert weights + its slab + one layer's experts +
   ``MIXTRAL_BASELINE_ACT_BYTES``. C is the config's cache capacity
   (``OFFLOAD_SERVE``). The kernel cases of step 3 include Mixtral's shapes
   (``offload_gmm_cases``, ``MIXTRAL_FLASH_SHAPES``,
   ``offload_int4_shapes``; the gmm shapes of (e),
   ``MIXTRAL_BASELINE_GMM_SHAPES``);
24. Phi-3.5-MoE (paper Table 6/7: 32 layers, d 4096, 32 q / 8 kv heads of
   128, 16 experts top-2, d_ff 6400, vocab 32,064; C = 4) offloaded at full
   width as step 23(a) serves Mixtral, in two child processes: INT4 at
   full depth, then bf16 at the depth MemAvailable allows (the 75.0 GiB
   store + ``MIXTRAL_HOST_HEADROOM_GIB``), 4 x (128 + 16) tokens, gamma,
   seed 0 (``phi_phase``). It prints and gates each row as 23(a) does
   (``_offload_rows``), and also the peak device memory within the
   non-expert weights + the slabs + one layer's overflow group (its 12
   other experts) + ``OFFLOAD_ACT_BYTES``. The kernel cases of step 3
   include Phi's ``moe_gmm`` and ``int4_matmul`` shapes (its
   ``flash_attn`` shape is Mixtral's);
25. prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Any failure raises (non-zero exit, no result line). Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import atexit
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import signal
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
    # the wave server's paths ("wave-olmoe-fcfs", "wave-olmoe-affinity")
    # follow LAUNCHER_LAYERS, below
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
# plain run (H100 80GB HBM3, 700 W; 0.0322 with the plain path's attention
# blockwise), as zamba2's 81 layers read 0.0418 (its limit 4.5e-2); held
# first in fp32 at full width to FP32_LOGITS_REL_TOL, where only the order
# of sums differs. At full depth that check also met a router's top-k
# choice at a near tie: with the blockwise plain attention two tokens'
# top-6 experts differ (the first where two router probabilities lie
# 7.1e-08 apart) and it read 8.54e-05, with the kernel run's routes
# replayed 1.73e-06 (tools/route_flips.py).
DEEPSEEK_BF16_LOGITS_REL_TOL = 4e-2
# The fp32 check takes deepseek's first DEEPSEEK_FP32_LAYERS layers (the
# dense layer and three MoE layers), as phase 23 holds Mixtral's kernels in
# fp32 on its first layers: it reads each kernel's arithmetic at full width,
# which depth does not change. At full depth its fp32 store (60 GB, in
# pageable host memory: a pinned copy beside it does not fit the host) and
# two prefills through it were most of the phase's 72.3 s of a 947.4 s run
# (H100 80GB HBM3, 700 W); cut so that phase 24 fits the whole run's time.
DEEPSEEK_FP32_LAYERS = 4
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
# The little tier (phase 16) serves the main path's weights on their first
# LITTLE_LAYERS layers: the bank's build (one fp64 eigendecomposition per
# expert and projection, 2.6-3.0 s a layer on an H100 80GB HBM3 at 700 W,
# 45-75 s for all 16) is what the phase spends, and its gates read
# the tier against an engine without a bank on the same cut (the tokens,
# transfers and launches of quality 1.0; no transfer at 0.0; the two
# deadlines), which depth does not change. Cut so that phase 23(e), the
# paper's comparison at Mixtral's width, fits the whole run's time.
# At quality 1.0 the bank is inert: the launches of the main path's cut,
# 6 gmm a layer-step (slab and overflow groups) and one flash a layer.
LITTLE_LAYERS = 4
PATH_LAUNCHES["little-q1.0"] = {"moe_gmm": LITTLE_LAYERS * 6 * 32,
                                "flash_attn": LITTLE_LAYERS, "int4_matmul": 0}
# rank-8 fp32 factors: 3 projections x (64 x 2048 x 8 + 64 x 8 x 1024) x
# 4 B a layer of OLMoE
LITTLE_RANK = 8
# The launchers' own runs at OLMoE's full width (``bench_serve --little``,
# ``--trace``, the journaled fp32 serve and its resume, ``--engine-impl
# dict``) take its first LAUNCHER_LAYERS layers: their gates read the
# launcher's plumbing (requests finished, degraded requests, a valid trace,
# tokens equal after a resume), which depth does not change, and the
# engines' full-depth runs are their phases' own. Cut so that the whole run
# stays inside its time limit (1227.8 s with them at full depth on an H100
# 80GB HBM3 at 700 W, whose host ran the host-bound phases slowly). Since
# phase 23 (Mixtral, ~110 s) the crash-safe wave server of phase 18(c) takes
# them too: its gates read the journal, checkpoint and revival plumbing
# (92.5 s for phase 18 with it at full depth, 41.1 s after the cut). Since
# phase 23 traces Mixtral for Psi (~70 s) the wave phase (8) takes them as
# well (79.5 s at full depth, H100 80GB HBM3, 700 W): its gates read the
# server (both policies' tokens equal, launch totals) and the LoRA term
# against merged experts, which depth does not change. Since phase 23(e)
# (Mixtral's comparison systems, ~66-83 s) the fleet phase (19) takes them
# too: its gates read the supervisor's plumbing (every request finished or
# checkpointed, a killed worker restarted from its journal with the
# uninterrupted run's tokens, a drain exiting 0, the launch routes of each
# dtype), which depth does not change; its workers resolve the cut by name
# (``<arch>-<N>l``).
LAUNCHER_LAYERS = 4
# the wave server, one request at a time: per prefill (128 tokens, which
# route to more than C = 16 of the 64 experts in every layer) one flash
# and 6 gmm a layer (slab and overflow groups, "tc"); per decode step (1
# token: its 8 experts always fit the slab) 3 gmm a layer ("stream"): 8
# prefills and 152 decode steps, under either policy
for _path in ("wave-olmoe-fcfs", "wave-olmoe-affinity"):
    PATH_LAUNCHES[_path] = {"moe_gmm": LAUNCHER_LAYERS * (8 * 6 + 152 * 3),
                            "flash_attn": 8 * LAUNCHER_LAYERS, "int4_matmul": 0}
LITTLE_BANK_BYTES = LITTLE_LAYERS * 3 * (64 * 2048 * 8 + 64 * 8 * 1024) * 4


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


# Phase 23(e)'s own moe_gmm shapes at Mixtral-8x7B's width: stream_all's
# prefill overflow group (all 8 experts of 4 x 128 tokens' top-2 route,
# "tc") and quant_cache's dequantized INT4 slab in a batch-4 decode step
# (3C = 6 slots of up to 4 rows, "stream")
MIXTRAL_BASELINE_GMM_SHAPES = ((8, 512), (6, 4))


def offload_gmm_cases(gen, arch: str, shapes=None):
    """moe_gmm at ``arch``'s expert shapes (its experts, top-k, d_model and
    d_ff; C its config's cache capacity, the paper's Table 7), (groups,
    rows) by ``shapes``: by default the slab group of a batch-4 decode step
    (C slots of up to 4 rows, "stream") and a prefill's overflow group (the
    E - C other experts of 4 x 128 tokens' top-k route, "tc"), both
    projections' shapes. Mixtral-8x7B: (2, 4) and (6, 512) of 8 experts,
    d_ff 14,336; Phi-3.5-MoE: (4, 4) and (12, 512) of 16, d_ff 6400."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    spec = cfg.moe_spec
    E, k, d, f = spec.num_experts, spec.top_k, cfg.d_model, spec.d_ff
    C = cfg.melinoe_cache_capacity()
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for G, M in shapes or ((C, 4), (E - C, 512)):
            if M == 4:
                sizes = torch.randint(1, M + 1, (G,), generator=gen, device="cuda",
                                      dtype=torch.int32)
            else:  # the rows a real top-k route of M tokens gives G of the E experts
                eids = torch.randn(M, E, generator=gen, device="cuda").topk(k, dim=-1).indices
                sizes = torch.bincount(eids.reshape(-1), minlength=E)[:G].to(torch.int32)
            for K, F in ((d, f), (f, d)):
                a = torch.randn(G, M, K, generator=gen, device="cuda")
                a = (a * (torch.arange(M, device="cuda")[None, :, None]
                          < sizes[:, None, None])).to(dtype)
                b = (torch.randn(G, K, F, generator=gen, device="cuda") * K**-0.5).to(dtype)
                cases.append(gmm_case(a, b, sizes, dtype))
                del a, b
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


FLASH_SHAPES = [(4, 128, 16, 1, 128, None, None), (4, 100, 16, 1, 128, None, None),
                (1, 128, 16, 1, 128, None, None),  # the continuous server's prefill
                (4, 128, 8, 2, 64, None, None), (4, 128, 16, 1, 128, 50.0, 32),
                (4, 512, 32, 1, 112, None, None),  # zamba2-7b's shared attention
                (4, 512, 8, 4, 160, None, None)]  # stablelm-12b's prefill
MIXTRAL_FLASH_SHAPES = [(4, 128, 8, 4, 128, None, None)]  # Mixtral-8x7B's prefill


def flash_cases(gen, shapes=FLASH_SHAPES):
    from repro_torch.kernels.flash_attn import attention_ref, flash_hopper
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    cases = []
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


# The reference's blockwise plain attention (models/attention.py::
# blockwise_attention), attend_full's path wherever the flash kernel does not
# run (every train step, whose attention needs a backward): at the flash
# cases' olmoe and zamba2 shapes (B, T, Hkv, G, hd), fp32, its output and the
# gradients of q, k and v for one random output gradient against
# attention_ref and attention_ref's autograd, each within BLOCKWISE_REL of
# the reference's largest element (both fp32: only the order of sums
# differs); its eager forward + backward time and the peak it adds to the
# card beside attention_ref's. It is plain torch, not a kernel: it launches
# none and is not in the kernels line.
BLOCKWISE_CASES = ((4, 128, 16, 1, 128), (4, 512, 32, 1, 112))
BLOCKWISE_REL = 1e-5


def blockwise_cases(gen) -> list:
    from repro_torch.kernels.flash_attn import attention_ref
    from repro_torch.models.attention import blockwise_attention

    rows = []
    for B, T, Hkv, G, hd in BLOCKWISE_CASES:
        q = torch.randn(B, T, Hkv, G, hd, generator=gen, device="cuda").requires_grad_()
        k, v = (torch.randn(B, T, Hkv, hd, generator=gen, device="cuda").requires_grad_()
                for _ in range(2))
        do = torch.randn(B, T, Hkv, G, hd, generator=gen, device="cuda")

        def fwd_bwd(fn):
            out = fn(q, k, v)
            return (out.detach(), *torch.autograd.grad(out, (q, k, v), do))

        row = {"case": f"blockwise float32 B{B} T{T} Hkv{Hkv} G{G} hd{hd}"}
        got = {}
        for name, fn in (("blockwise", blockwise_attention), ("attention_ref", attention_ref)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got[name] = fwd_bwd(fn)
            torch.cuda.synchronize()
            row[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated() - base
            row[f"{name}_ms"] = time_ms(lambda: fwd_bwd(fn), graph=False)
        rel = [((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(got["blockwise"], got["attention_ref"])]
        row.update(out_rel=rel[0], grad_rel_worst=max(rel[1:]), tol=BLOCKWISE_REL)
        if not (max(rel) <= BLOCKWISE_REL and all(torch.isfinite(t).all()
                                                  for t in got["blockwise"])):
            raise AssertionError(f"{row['case']}: against attention_ref {row}")
        print(f"  {row['case']}: out rel {rel[0]:.3g}, dq/dk/dv worst rel {max(rel[1:]):.3g} "
              f"(tol {BLOCKWISE_REL}); forward + backward {row['blockwise_ms']:.4f} ms, "
              f"peak +{row['blockwise_peak_bytes']} B; attention_ref "
              f"{row['attention_ref_ms']:.4f} ms, peak +{row['attention_ref_peak_bytes']} B")
        rows.append(row)
        del q, k, v, do, got
    return rows


INT4_SHAPES = [(M, K, N) for M in (1, 4, 512) for K, N in ((2048, 1024), (1024, 2048))]
INT4_SHAPES.append((7, 2048, 1000))  # ragged: M and N tails of both tiles


def offload_int4_shapes(arch: str) -> list:
    """``arch``'s INT4 spillover: every token of the step against one
    spilled expert's (d_model, d_ff) and (d_ff, d_model) matrices, 4 rows in
    decode ("stream"), 512 in prefill ("tc"), as (M, K, N)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    d, f = cfg.d_model, cfg.moe_spec.d_ff
    return [(M, K, N) for M in (4, 512) for K, N in ((d, f), (f, d))]


def int4_cases(gen, shapes=INT4_SHAPES):
    from repro_torch.kernels.int4_matmul import (dequant_ref, int4_matmul_hopper,
                                                 int4_matmul_ref, quantize_matmul_weight)

    cases = []
    g = 32
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
    """MemAvailable of the host (the wave, deepseek and Mixtral phases hold
    30-90 GB of experts in host memory), or NaN where /proc/meminfo is
    missing."""
    from repro_torch.launch.serve import host_available_bytes

    b = host_available_bytes()
    return float("nan") if b is None else b / 2**30


def _rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm()).item()


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
    """Phase 8: full-width OLMoE-1B-7B on its first LAUNCHER_LAYERS layers
    offloaded behind the port's ``OffloadedWaveServer`` with LoRA on every
    MoE layer, under fcfs and expert-affinity, and the LoRA gates on the
    first request's prefill logits (see the module docstring).
    ``arch``/``device``: a smaller model or the CPU, to rehearse the
    phase's logic."""
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
    cfg = get_config(_launcher_arch(arch))
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
    """The deepseek phase's prefill (4 x 128 tokens, full width) in fp32 on
    its first DEEPSEEK_FP32_LAYERS layers, kernels against plain versions: fp32
    weights from seed 0, the experts kept in pageable host memory and served
    as the engines' store as they are (at full depth 60 GB: a second,
    pinned copy would not fit the host). Returns ||kernel - plain|| /
    ||plain||."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import OffloadedMoEEngine
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import init_params

    cfg = get_config(arch)
    groups, left = [], DEEPSEEK_FP32_LAYERS
    for g in cfg.layout:  # the layout's groups in order, up to that depth
        r = min(g.repeats, left // len(g.pattern))
        if r:
            groups.append(dataclasses.replace(g, repeats=r))
        left -= r * len(g.pattern)
    cfg = dataclasses.replace(cfg, layout=tuple(groups))
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
    t = time.perf_counter()
    rel32 = deepseek_fp32_rel(arch, device, capacity)
    fp32_s = time.perf_counter() - t
    print(f"deepseek prefill logits kernel vs plain: fp32 rel {rel32:.3g} on "
          f"{DEEPSEEK_FP32_LAYERS} layers (tol {FP32_LOGITS_REL_TOL}; {fp32_s:.1f} s); bf16 "
          f"rel {rel:.4g} (tol {DEEPSEEK_BF16_LOGITS_REL_TOL}), top-1 agreement {top1:.2f}")
    if not (math.isfinite(rel32) and rel32 <= FP32_LOGITS_REL_TOL):
        raise AssertionError(f"deepseek: fp32 prefill logits disagree: rel {rel32}")
    if not (math.isfinite(rel) and rel <= DEEPSEEK_BF16_LOGITS_REL_TOL):
        raise AssertionError(f"deepseek: prefill logits disagree: rel {rel}")
    rep.update(launches_total=launches, route_launches_total=routes, gmm_by_phase=by_phase,
               logits_rel=rel, fp32_logits_rel=rel32, fp32_s=fp32_s, top1=top1,
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


def _grad_leaves_raw(tree, path=""):
    """(path, gradient) of a gradient tree, per-repeat lists as they are."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _grad_leaves_raw(v, f"{path}/{k}")
    elif tree is not None:
        yield path, tree


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


# serve --predictor (phases 11 and 23): Psi trained on this many more
# prompts of the batch's stream, each traced this many tokens in one batch
# (the reference launcher's defaults); each forward pass of the trace (its
# prefill and every decode step) stages each MoE layer from the store once
PSI_TRAIN_PROMPTS = 32
PSI_TRACE_NEW = 16


def _trace_launches(routes: dict, served: dict) -> dict:
    """The routing trace's ``moe_gmm`` and ``flash_attn`` launches by route:
    a ``run(predictor=True)``'s launches (counted from 0 before it) less
    its served batch's (``route_launches`` by phase)."""
    out = {}
    for op in ("moe_gmm", "flash_attn"):
        left = dict(routes[op])
        for ph in served.values():
            for route, k in ph[op].items():
                left[route] = left.get(route, 0) - k
        out[op] = {route: k for route, k in left.items() if k}
    return out


def _trace_want(cfg) -> dict:
    """A routing trace's launches: 3 ``moe_gmm`` a MoE layer and forward
    pass, all "tc" (the capacity is the whole batch of PSI_TRAIN_PROMPTS
    rows under zero_drop, above the "stream" route's 16 rows); one
    ``flash_attn`` "tc" an attention layer, in the prefill only."""
    return {"moe_gmm": {"tc": 3 * cfg.n_moe_layers * PSI_TRACE_NEW},
            "flash_attn": {"tc": cfg.n_layers}}


def predictor_phase(main_tokens, main_stats: dict, serve_kw: dict,
                    arch: str = "olmoe") -> dict:
    """Phase 11: the main path's batch served again with the activation
    predictor (``run(..., predictor=True)``, 32 training prompts, traced
    from the engine's store one staged MoE layer at a time): Psi's KL
    falls, prefetch transfers > 0, tokens equal the run without it, the
    trace's launches (``_trace_want``), and the trace it trained on bit-equal
    to ``routing_trace`` of the whole tree (the same seed drawn whole on the
    device) on the same training prompts. ``arch``: a smaller model, to
    rehearse the phase's logic."""
    from repro_torch.configs import get_config
    from repro_torch.inference import routing_trace
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params
    from repro_torch.models.runtime import Runtime

    t_phase = time.perf_counter()
    traced = []

    def recorded(*a, **k):  # the trace the run trains Psi on
        out = serve_trace(*a, **k)
        traced.append((k.get("host_store") is not None, *out))
        return out

    serve_trace, serve.routing_trace = serve.routing_trace, recorded
    try:
        dispatch.reset_launches()
        rep = serve.run(arch, max_new=32, predictor=True, n_train_prompts=PSI_TRAIN_PROMPTS,
                        **serve_kw)
        launches = dict(dispatch.LAUNCHES)
        routes = {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}
    finally:
        serve.routing_trace = serve_trace
    cfg = get_config(arch)
    trace = _trace_launches(routes, rep["route_launches"])
    kl = rep["predictor_kl"]
    same = bool(np.array_equal(rep["tokens"], main_tokens))
    stats = {"with_psi": {k: rep[k] for k in ("transfers", "prefetch_transfers", "hit_rate",
                                              "modeled_time_s", "decode_tok_s",
                                              "prefill_s")},
             "without_psi": main_stats, "predictor_kl": kl, "trace_s": rep["trace_s"],
             "trace_max_memory_allocated": rep["trace_max_memory_allocated"],
             "predictor_train_s": rep["predictor_train_s"],
             "tokens_equal_without_psi": same, "launches_total": launches,
             "route_launches": routes, "trace_launches": trace}
    # the same training prompts through the whole tree on the device
    dev = torch.device(serve_kw["device"])
    t = time.perf_counter()
    whole = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(serve_kw["seed"]),
                        dtype=serve_kw["dtype"], device=dev)
    train = serve.make_prompts(cfg.vocab, serve_kw["batch"] + PSI_TRAIN_PROMPTS,
                               serve_kw["prompt_len"])[serve_kw["batch"]:]
    wt, wp = routing_trace(cfg, whole, train, max_new=PSI_TRACE_NEW,
                           rt=Runtime(device=dev, zero_drop=True))
    del whole
    (streamed, st, sp), = traced
    stats.update(trace_streamed=streamed, trace_tokens_equal=bool(np.array_equal(st, wt)),
                 trace_probs_equal=bool(np.array_equal(sp, wp)),
                 trace_probs_max_abs=float(np.abs(sp - wp).max()),
                 whole_trace_s=time.perf_counter() - t)
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
    if dev.type == "cuda" and trace != _trace_want(cfg):
        raise AssertionError(f"predictor: the trace's launches {trace}, want "
                             f"{_trace_want(cfg)}")
    if not (streamed and stats["trace_tokens_equal"] and stats["trace_probs_equal"]):
        raise AssertionError(f"predictor: the streamed trace (from the store: {streamed}) "
                             f"differs from the whole tree's: tokens equal "
                             f"{stats['trace_tokens_equal']}, probs max abs "
                             f"{stats['trace_probs_max_abs']}")
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


def _src_env() -> dict:
    """This environment with the checkout's ``src`` first on PYTHONPATH
    (for the launchers this script runs as processes of their own)."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else [])))


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
        out = subprocess.run(cmd, env=_src_env(), capture_output=True, text=True,
                             timeout=600, cwd=str(ROOT))
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


def _serve_row(eng, prompts, dev, max_new: int = 32, **gen_kw) -> tuple:
    """One ``generate`` of ``eng`` (``max_new`` tokens), counters and the
    peak device memory set to 0 just before: (its result, a row of its
    numbers)."""
    from repro_torch.kernels import dispatch

    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dispatch.reset_launches()
    res = eng.generate(prompts, max_new_tokens=max_new, **gen_kw)
    _sync(dev)
    m, st = res["metrics"], res["cache_stats"]
    row = {"capacity": eng.capacity, "transfers": m.transfers,
           "host_executed": m.host_executed, "degraded_uses": m.degraded_uses,
           "hit_rate": st.hit_rate, "hits": st.hits, "misses": st.misses,
           "evictions": st.evictions, "prefetch_transfers": m.prefetch_transfers,
           "modeled_time_s": res["modeled_time_s"],
           "modeled_time_overlapped_s": res["modeled_time_overlapped_s"],
           "modeled_tok_s": res["throughput_tok_s"],
           "modeled_overlapped_tok_s": res["throughput_overlapped_tok_s"],
           "prefill_s": res["prefill_s"], "decode_tok_s": res["decode_tok_s"],
           "expert_copies": res["expert_copies"],
           "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else None),
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
    phases 16 to 18 (a list, which phase 18 empties). ``arch``/``device``: a
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
              f"{(r['max_memory_allocated'] or 0) / 1e9:8.2f}  "
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


def little_phase(shared: tuple, arch: str = "olmoe", device: str = "cuda",
                 layers: int = LITTLE_LAYERS) -> dict:
    """Phase 16: the little-expert tier on the main path's batch and
    weights (``shared``: phase 15's params, pinned store and prompts) cut
    to their first ``layers`` layers, C = 16, gamma: the cut served
    without a bank (the reference), a rank-8 bank built on the card, then
    serves at quality 1.0, 0.5 and 0.0 and under a deadline of half the
    quality-1.0 run's serial modeled seconds (each on a fresh engine
    serving the same bank), then ``bench_serve --offloaded --little
    --quality 0.5`` at full width on LAUNCHER_LAYERS layers."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import OffloadedMoEEngine
    from repro_torch.launch import bench_serve

    t_phase = time.perf_counter()
    dev = torch.device(device)
    full, store, prompts = shared
    params, cfg = _first_layers(full, get_config(arch), layers)
    store = store[:cfg.n_moe_layers]
    eng_kw = dict(capacity=16, policy="gamma", host_store=store, device=dev)
    ref = OffloadedMoEEngine(cfg, params, **eng_kw)
    res, main = _serve_row(ref, prompts, dev)
    main_tokens = res["tokens"].cpu().numpy()
    print(f"little: the main path's weights on {layers} of {get_config(arch).n_layers} layers, "
          f"without a bank:", json.dumps({k: v for k, v in main.items() if k != "by_phase"}))
    del ref, res
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
    rows["no-bank"] = main
    q1, q0 = rows["q1.0"], rows["q0.0"]
    if not (q1["tokens_equal_main"] and q1["transfers"] == main["transfers"]
            and q1["launches_total"] == main["launches_total"] and q1["degraded_uses"] == 0):
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

    # the launcher at full width, LAUNCHER_LAYERS layers: 4 requests in one
    # wave, quality 0.5
    t0 = time.perf_counter()
    (results, mt), build = _bench_serve([
        "--arch", _launcher_arch(arch), "--device", device, "--offloaded", "--capacity", "16",
        "--slots", "4", "--n-requests", "4", "--prompt-len", "128", "--max-new", "32",
        "--arrival", "all_at_once", "--little", "--quality", "0.5"])
    summ = mt.summary()
    rows["bench_serve"] = {k: summ[k] for k in (
        "requests", "generated_tokens", "transfers", "degraded_requests",
        "modeled_time_serial_s", "modeled_time_overlapped_s", "cache_hit_rate")}
    rows["bench_serve"].update(wall_s=time.perf_counter() - t0, build_s=build["build_s"],
                               score_s=build["score_s"])
    print("bench_serve --offloaded --little --quality 0.5:", json.dumps(rows["bench_serve"]))
    if not (summ["degraded_requests"] > 0 and summ["requests"] == len(results) == 4):
        raise AssertionError(f"bench_serve --little: {summ}")
    gc.collect()
    torch.cuda.empty_cache()
    rep = {"rows": rows, "phase_s": time.perf_counter() - t_phase}
    print(f"little phase: {rep['phase_s']:.1f} s")
    return rep


# The dense phase (17): the six dense and prefix-conditioned configs at full
# width, bf16, random weights from seed 0, each through launch.serve.run_full
# at 4 x (512 + 32) tokens. arch -> (layers served, None: all; layers of the
# fp32 check, None: all). Cut in depth where the card cannot hold the model,
# or its fp32 copy beside it, by replacing the layout's repeats:
# gemma2-27b (46 layers, 54 GB in bf16) to 8 local/global pairs; command-r-
# plus-104b (64 layers of 1.57 B parameters, 12.6 GB of embeddings and head)
# to 4; internvl2-76b (80 layers of 0.86 B) to 8. The fp32 check takes the
# first layers of the same weights.
DENSE_PATHS = {"qwen3-4b": (None, None), "musicgen-medium": (None, None),
               "stablelm-12b": (None, 8), "gemma2-27b": (16, 4),
               "command-r-plus-104b": (4, 1), "internvl2-76b": (8, 2)}
DENSE_B, DENSE_T, DENSE_NEW = 4, 512, 32
# bf16 kernel run against the plain run, ||delta|| / ||plain|| of the (B, V)
# prefill logits, per path (LOGITS_REL_TOL unless said). The three served at
# full depth amplify round-off past 2e-2 as zamba2's 81 layers do: the
# kernel runs read qwen3-4b 0.0227, musicgen-medium 0.0246, stablelm-12b
# 0.0245 from the plain runs, whose own bf16 round-off (plain bf16 against
# plain fp32) is 0.0193, 0.0211 and (at 8 layers) 0.0115, while the kernel
# runs were no farther from fp32 than the plain ones (ratio 0.98-1.02; H100
# 80GB HBM3, 700 W). The limit sits above those readings; the fp32 check
# and ACCURACY_RATIO are what hold the kernels' arithmetic.
DENSE_BF16_LOGITS_REL_TOL = {"qwen3-4b": 3e-2, "musicgen-medium": 3e-2,
                             "stablelm-12b": 3e-2}
# gemma2 past its 4096-token window: one prompt of 4608 tokens through one
# local and one global layer (softcap 50 in both, the window in the first)
GEMMA2_WINDOW_T = 4608
# the offloaded OLMoE serve with a prefix: 64 rows ahead of each of phase
# 4's prompts, C = 16, gamma
OFFLOAD_PREFIX_LEN = 64


def _cut_arch(arch: str, layers) -> str:
    """The name of ``arch`` cut to ``layers`` layers, ``<arch>-<layers>l``
    (its single layout group's repeats replaced), which the port's config
    registry resolves in any process; ``arch`` itself where ``layers`` is
    None or its depth."""
    from repro_torch.configs import get_config

    if layers is None or layers == get_config(arch).n_layers:
        return arch
    name = f"{arch}-{layers}l"
    get_config(name)  # a depth the layout cannot take raises here
    return name


def _launcher_arch(arch: str) -> str:
    """``arch`` cut to LAUNCHER_LAYERS layers (or as it is, if not deeper)."""
    from repro_torch.configs import get_config

    return _cut_arch(arch, min(LAUNCHER_LAYERS, get_config(arch).n_layers))


def _first_layers(params, cfg, layers: int):
    """The first ``layers`` layers of ``params`` (stacked leaves sliced,
    the rest as they are) as copies, and the config cut alike."""
    (g,) = cfg.layout
    r = layers // len(g.pattern)
    cut = dataclasses.replace(cfg, layout=(dataclasses.replace(g, repeats=r),))

    def walk(t, stacked):
        if isinstance(t, dict):
            return {k: walk(v, stacked or k == "groups") for k, v in t.items()}
        return (t[:r] if stacked else t).clone()

    return walk(params, False), cut


def _dense_prefill_logits(params, cfg, toks, prefix, backend: str, n_slots: int):
    from repro_torch.models.model import prefill
    from repro_torch.models.runtime import Runtime

    with torch.inference_mode():
        lg, _ = prefill(params, cfg, toks, Runtime(kernel_backend=backend,
                                                   device=toks.device),
                        prefix_embed=prefix, n_slots=n_slots)
    return lg[:, -1].float().cpu()


def serve_dense(arch: str, layers, fp32_layers, device: str = "cuda") -> dict:
    """One dense path: ``arch`` (cut to ``layers``) through ``run_full``,
    counters set to 0 just before; launches (one ``flash_attn`` a layer in
    the prefill, "tc", nothing else, nothing in decode); the prefill logits
    against plain prefills: bf16 at the served depth, then at
    ``fp32_layers`` fp32 kernel vs plain and the bf16 kernel run against
    the plain path's own round-off. ``device``: the CPU and a smoke
    config, to rehearse the logic (no launch gates there)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import make_prefix, make_prompts, run_full

    t0 = time.perf_counter()
    name = _cut_arch(arch, layers)
    cfg = get_config(name)
    B, T, new = DENSE_B, DENSE_T, DENSE_NEW
    prefix = make_prefix(cfg, B, seed=0) if cfg.prefix_len else None
    P = cfg.prefix_len
    dispatch.reset_launches()
    rep = run_full(name, batch=B, prompt_len=T, max_new=new, dtype=torch.bfloat16,
                   device=device, seed=0, keep_params=True, prefix_embed=prefix)
    launches = dict(dispatch.LAUNCHES)
    routes = {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}
    path = f"dense-{arch}"
    PATH_LAUNCHES[path] = {"flash_attn": cfg.n_layers, "moe_gmm": 0, "ssd_scan": 0,
                           "int4_matmul": 0}
    if device == "cuda":
        check_path(path, launches, routes)
    if rep["launches"]["prefill"] != launches or any(rep["launches"]["decode"].values()):
        raise AssertionError(f"{path}: launches {rep['launches']}, want "
                             f"{cfg.n_layers} flash_attn in the prefill, none in decode")
    params = rep.pop("params")
    tokens, logits = rep.pop("tokens"), rep.pop("prefill_logits")
    if tokens.shape != (B, new) or logits.shape != (B, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"{path}: tokens {tokens.shape}, logits {logits.shape} "
                             "(or not finite)")
    toks = torch.as_tensor(make_prompts(cfg.vocab, B, T), dtype=torch.long, device=device)
    pe = None if prefix is None else torch.as_tensor(prefix, device=device)
    n_slots = P + T + new
    ref = _dense_prefill_logits(params, cfg, toks, pe, "ref", n_slots)
    rel = _rel(logits, ref)
    top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    d32 = fp32_layers or cfg.n_layers
    if d32 < cfg.n_layers:  # the first layers of the same weights, the rest freed
        params, cfg32 = _first_layers(params, cfg, d32)
        gc.collect()
        torch.cuda.empty_cache()
        k16 = _dense_prefill_logits(params, cfg32, toks, pe, "auto", n_slots)
        r16 = _dense_prefill_logits(params, cfg32, toks, pe, "ref", n_slots)
    else:
        cfg32, k16, r16 = cfg, logits, ref
    p32 = _tree_float(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    pe32 = None if pe is None else pe.float()
    k32 = _dense_prefill_logits(p32, cfg32, toks, pe32, "auto", n_slots)
    r32 = _dense_prefill_logits(p32, cfg32, toks, pe32, "ref", n_slots)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    rel32, floor, acc = _rel(k32, r32), _rel(r16, r32), _rel(k16, r32)
    tol = DENSE_BF16_LOGITS_REL_TOL.get(arch, LOGITS_REL_TOL)
    rep.update(path=path, layers=cfg.n_layers, full_layers=get_config(arch).n_layers,
               fp32_layers=d32, launches_total=launches, route_launches=routes,
               logits_rel=rel, top1=top1, logits_tol=tol, fp32_logits_rel=rel32,
               bf16_roundoff_rel=floor, kernel_vs_fp32_rel=acc,
               phase_s=time.perf_counter() - t0)
    print(f"serve {path}:", json.dumps(rep))
    print(f"{path} ({cfg.n_layers} of {rep['full_layers']} layers, prefix {P}): prefill "
          f"{rep['prefill_s']:.4f} s, decode {rep['decode_tok_s']:.2f} tok/s, peak "
          f"{rep['max_memory_allocated']} B against {rep['param_bytes']} B of weights; "
          f"logits kernel vs plain: bf16 rel {rel:.4g} (tol {tol}), top-1 {top1:.2f}; at "
          f"{d32} layers fp32 rel {rel32:.3g} (tol {FP32_LOGITS_REL_TOL}), plain bf16 vs "
          f"fp32 {floor:.4g}, bf16 kernel vs fp32 {acc:.4g} (tol {ACCURACY_RATIO} x "
          f"{floor:.4g})")
    if not (math.isfinite(rel32) and rel32 <= FP32_LOGITS_REL_TOL):
        raise AssertionError(f"{path}: fp32 prefill logits disagree: rel {rel32}")
    if not (math.isfinite(rel) and rel <= tol):
        raise AssertionError(f"{path}: bf16 prefill logits disagree: rel {rel}")
    if not (math.isfinite(acc) and acc <= ACCURACY_RATIO * floor):
        raise AssertionError(f"{path}: bf16 kernel run rel {acc} from fp32, plain run "
                             f"{floor}")
    return rep


def gemma2_window_phase(arch: str = "gemma2-27b", device: str = "cuda") -> dict:
    """gemma2-27b cut to one local and one global layer: one prompt of
    ``GEMMA2_WINDOW_T`` tokens, past the local layer's 4096-token window,
    through ``run_full`` (2 flash launches on "tc"), its prefill logits
    against the plain versions in bf16 and in fp32. ``arch``/``device``:
    the smoke config on the CPU, to rehearse the logic."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import make_prompts, run_full

    name = _cut_arch(arch, 2)
    cfg = get_config(name)
    T, new = GEMMA2_WINDOW_T, 8
    if not T > cfg.block_defs["local"].attn.window:
        raise AssertionError(f"gemma2 window phase: {T} tokens do not pass the window")
    dispatch.reset_launches()
    rep = run_full(name, batch=1, prompt_len=T, max_new=new, dtype=torch.bfloat16,
                   device=device, seed=0, keep_params=True)
    launches = dict(dispatch.LAUNCHES)
    routes = {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}
    PATH_LAUNCHES["dense-gemma2-window"] = {"flash_attn": 2, "moe_gmm": 0, "ssd_scan": 0,
                                            "int4_matmul": 0}
    if device == "cuda":
        check_path("dense-gemma2-window", launches, routes)
    params, logits = rep.pop("params"), rep.pop("prefill_logits")
    rep.pop("tokens")
    toks = torch.as_tensor(make_prompts(cfg.vocab, 1, T), dtype=torch.long, device=device)
    ref = _dense_prefill_logits(params, cfg, toks, None, "ref", T + new)
    p32 = _tree_float(params)
    del params
    k32 = _dense_prefill_logits(p32, cfg, toks, None, "auto", T + new)
    r32 = _dense_prefill_logits(p32, cfg, toks, None, "ref", T + new)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    rel, rel32 = _rel(logits, ref), _rel(k32, r32)
    rep.update(path="dense-gemma2-window", launches_total=launches, route_launches=routes,
               logits_rel=rel, fp32_logits_rel=rel32, bf16_roundoff_rel=_rel(ref, r32),
               kernel_vs_fp32_rel=_rel(logits, r32))
    print("serve dense-gemma2-window:", json.dumps(rep))
    if not (math.isfinite(rel32) and rel32 <= FP32_LOGITS_REL_TOL
            and math.isfinite(rel) and rel <= LOGITS_REL_TOL):
        raise AssertionError(f"gemma2 past its window: fp32 rel {rel32}, bf16 rel {rel}")
    return rep


def offload_prefix_phase(shared: list, arch: str = "olmoe", device: str = "cuda",
                         capacity: int = 16) -> dict:
    """The offloaded OLMoE engine with a prefix, on phase 15's weights,
    pinned store and prompts: ``generate(prompts, 32, prefix_embed)`` with
    ``OFFLOAD_PREFIX_LEN`` rows ahead of each prompt, C = 16, gamma,
    counters set to 0 just before; launches by phase and route; the
    prefill logits against a plain run on the same store.
    ``arch``/``device``/``capacity``: a smaller model or the CPU, to
    rehearse the phase's logic (no launch gates there)."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import OffloadedMoEEngine

    cfg = get_config(arch)
    dev = torch.device(device)
    params, store, prompts = shared
    B = prompts.shape[0]
    prefix = np.random.default_rng(0).standard_normal(
        (B, OFFLOAD_PREFIX_LEN, cfg.d_model)).astype(np.float32)
    eng_kw = dict(capacity=capacity, policy="gamma", host_store=store, device=dev)
    res, row = _serve_row(OffloadedMoEEngine(cfg, params, **eng_kw), prompts, dev,
                          prefix_embed=prefix)
    plain = OffloadedMoEEngine(cfg, params, kernel_backend="ref", **eng_kw).generate(
        prompts, 1, prefix)["prefill_logits"].float().cpu()
    gc.collect()
    torch.cuda.empty_cache()
    logits = res["prefill_logits"].float().cpu()
    path = "offloaded-olmoe-prefix"
    row.update(path=path, prefix_len=OFFLOAD_PREFIX_LEN, logits_rel=_rel(logits, plain),
               top1=(logits.argmax(-1) == plain.argmax(-1)).float().mean().item())
    print("offloaded olmoe with a prefix:", json.dumps(
        {k: v for k, v in row.items() if k != "by_phase"}), f"by phase {row['by_phase']}")
    if device != "cuda":
        return row
    PATH_LAUNCHES[path] = {"moe_gmm": None, "flash_attn": cfg.n_layers, "int4_matmul": 0}
    check_path(path, row["launches_total"], row["route_launches"])
    gmm = {ph: r.get("moe_gmm", {}) for ph, r in row["by_phase"].items()}
    L = cfg.n_moe_layers
    if gmm["prefill"] != {"tc": 6 * L} or set(gmm["decode"]) != {"stream"} \
            or gmm["decode"]["stream"] < 31 * L * 3:
        raise AssertionError(f"{path}: moe_gmm by phase {gmm}, want {6 * L} 'tc' in the "
                             f"prefill and at least {31 * L * 3} 'stream' in decode")
    if res["tokens"].shape != (B, 32) or not (math.isfinite(row["logits_rel"])
                                              and row["logits_rel"] <= LOGITS_REL_TOL):
        raise AssertionError(f"{path}: tokens {tuple(res['tokens'].shape)}, prefill "
                             f"logits rel {row['logits_rel']}")
    return row


def dense_phase(shared: list) -> dict:
    """Phase 17: the dense paths (``DENSE_PATHS``), gemma2 past its window
    and the offloaded OLMoE serve with a prefix."""
    t_phase = time.perf_counter()
    rows = {arch: serve_dense(arch, *depths) for arch, depths in DENSE_PATHS.items()}
    rows["gemma2-window"] = gemma2_window_phase()
    rows["offloaded-olmoe-prefix"] = offload_prefix_phase(shared)
    rep = {"rows": rows, "phase_s": time.perf_counter() - t_phase}
    print("dense path            layers  prefill_s  decode_tok/s  peak_B  weights_B  "
          "bf16_rel  fp32_rel")
    for arch in DENSE_PATHS:
        r = rows[arch]
        print(f"{arch:21s} {r['layers']:3d}/{r['full_layers']:<3d} {r['prefill_s']:9.4f} "
              f"{r['decode_tok_s']:13.2f} {r['max_memory_allocated']} {r['param_bytes']} "
              f"{r['logits_rel']:.4g} {r['fp32_logits_rel']:.3g}")
    print(f"dense phase: {rep['phase_s']:.1f} s")
    return rep


# The operations phase (18): phase 15's weights, pinned store and batch
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
    """Phase 18, the operations stack: (a) phase 4's batch traced, bf16 and
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

    # ---- (c) the crash-safe wave server: the wave phase's 8 requests, on the
    # first LAUNCHER_LAYERS layers (its gates read the journal, checkpoint and
    # revival plumbing, which depth does not change)
    wparams, wcfg = _first_layers(params, cfg, min(LAUNCHER_LAYERS, cfg.n_layers))
    wstore = store[:wcfg.n_moe_layers]
    n = len(SERVE_BUDGETS)
    wprompts = make_prompts(wcfg.vocab, n, SERVE_PROMPT)

    def reqs_of():
        return [ServeRequest(rid=i, prompt=wprompts[i], max_new_tokens=SERVE_BUDGETS[i])
                for i in range(n)]

    wave_kw = dict(capacity=capacity, policy="gamma", wave_size=4, host_store=wstore,
                   device=dev)
    ref_srv = OffloadedWaveServer(wcfg, wparams, **wave_kw)
    ref, _ = ref_srv.run(RequestQueue(reqs_of()))
    ref_toks = [r.tokens.tolist() for r in ref]
    ref_transfers = ref_srv.engine.metrics.transfers
    del ref_srv
    with tempfile.TemporaryDirectory() as d:
        jdir, cold_dir = os.path.join(d, "journal"), os.path.join(d, "journal-cold")
        jr = RequestJournal(jdir)
        install_fault_plan(f"crash_at={OPS_WAVE_CRASH_AT},seed=0")
        try:
            OffloadedWaveServer(wcfg, wparams, **wave_kw).run(
                RequestQueue(reqs_of()), journal=jr, checkpoint_every=1, audit_every=1)
            raise AssertionError("the wave server did not crash")
        except InjectedCrash as e:
            print(f"wave server: {e}")
        finally:
            uninstall_fault_plan()
            jr.close()
        shutil.copytree(jdir, cold_dir)
        snapshot = recover(jdir).engine["cache"]  # the checkpoint after wave 1
        resumed = {"warm": _crash_and_resume(wcfg, wparams, wstore, dev, jdir, True, capacity),
                   "cold": _crash_and_resume(wcfg, wparams, wstore, dev, cold_dir, False,
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
        eng = OffloadedMoEEngine(wcfg, wparams, host_store=wstore, **eng_kw)
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
    del params, store, prompts, wparams, wstore
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) bench_serve on the card, LAUNCHER_LAYERS layers
    base = ["--arch", _launcher_arch(arch), "--device", device]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        _, build = _bench_serve(base + OPS_BENCH + ["--offloaded", "--capacity", str(capacity),
                                                    "--slots", "4", "--trace", d])
        names = sorted(os.listdir(d))
        with open(os.path.join(d, "reconcile.json")) as f:
            rec = json.load(f)
        with open(os.path.join(d, "trace.json")) as f:
            errs = validate_chrome_trace(json.load(f))
        rows["bench-trace"] = {"files": names, "reconcile_ok": rec["ok"],
                               "serial_agreement_ratio": rec["serial_agreement_ratio"],
                               "trace_errors": errs[:5], "wall_s": time.perf_counter() - t0,
                               "build_s": build["build_s"], "score_s": build["score_s"]}
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


# The fleet phase (19): two workers of full-width OLMoE on the one card,
# continuous batching with SERVE_SLOTS slots each, the continuous phase's
# requests. fp32 workers take the CUDA-core routes, bf16 ones the
# tensor-core and stream routes.
FLEET_WORKERS = 2
FLEET_KILL = "kill_at=4,seed=0"
FLEET_ROUTES = {"float32": {"moe_gmm": {"fma"}, "flash_attn": {"fma"}},
                "bfloat16": {"moe_gmm": {"tc", "stream"}, "flash_attn": {"tc"}}}
# per worker, beside its fp32 weights: a CUDA context, the slot pool's KV
# cache and the prefill's activations
FLEET_WORKER_HEADROOM = 2 << 30
# the launchers' traffic: prompts of 64-128 tokens, budgets of 16-32, all
# at once; the drained fleet gets twice the requests, so that each worker
# has more than its slots and the drain leaves some checkpointed
FLEET_BENCH = ["--n-requests", str(len(SERVE_BUDGETS)), "--prompt-len", str(SERVE_PROMPT),
               "--max-new", str(max(SERVE_BUDGETS)), "--arrival", "all_at_once",
               "--slots", str(SERVE_SLOTS), "--seed", "0"]
FLEET_DRAIN_REQUESTS = 2 * len(SERVE_BUDGETS)




def _wait(pred, what: str, proc, timeout_s: float = 300.0) -> None:
    deadline = time.time() + timeout_s
    while not pred():
        if proc.poll() is not None:
            raise AssertionError(f"{what}: the process exited ({proc.returncode}) first")
        if time.time() > deadline:
            raise AssertionError(f"{what}: not within {timeout_s} s")
        time.sleep(0.05)


def _fleet_workers(root, report: dict, dtype: str, device: str) -> list:
    """Per worker: start-up seconds of each incarnation (launch -> first
    heartbeat past ``init``), exit code, and the closing launch line of
    the incarnation that finished (launches by op and route, peak memory);
    on the card, the gate that ``moe_gmm`` and ``flash_attn`` launched on
    the routes of ``dtype``."""
    from repro_torch.fleet.worker import worker_launches

    rows = []
    for w in report["workers"]:
        lines = worker_launches(Path(root) / f"worker-{w['idx']}" / "worker.log")
        if not lines:
            raise AssertionError(f"fleet worker {w['idx']}: no launch line in its log")
        last = lines[-1]
        rows.append({
            "worker": w["idx"], "exit_code": w["exit_code"], "restarts": w["restarts"],
            "startup_s": [e["startup_s"] for e in report["events"]
                          if e["event"] == "ready" and e["worker"] == w["idx"]],
            "launches": last["launches"], "route_launches": last["route_launches"],
            "max_memory_allocated": last.get("max_memory_allocated")})
        if device == "cuda":
            for op, want in FLEET_ROUTES[dtype].items():
                got = last["route_launches"][op]
                if not last["launches"][op] or set(got) - want:
                    raise AssertionError(f"fleet worker {w['idx']} ({dtype}): {op} "
                                         f"launches {got}, want > 0 on {sorted(want)}")
    return rows


def _fleet_row(report: dict, t_wall: float) -> dict:
    gen = sum(len(r["tokens"]) for r in report["results"].values())
    return {"finished": report["finished"],
            "pending_checkpointed": len(report["pending_checkpointed"]),
            "unaccounted": report["unaccounted"], "drained": report["drained"],
            "restarts": report["restarts"], "failover_s": report["failover_s"]["samples"],
            "wall_s": report["wall_s"], "generated_tokens": gen,
            "tokens_per_wall_s": gen / report["wall_s"] if report["wall_s"] else 0.0,
            "call_s": time.perf_counter() - t_wall}


def fleet_phase(arch: str = "olmoe", device: str = "cuda") -> dict:
    """Phase 19, the supervised fleet: two ``repro_torch.fleet.worker``
    processes of full-width OLMoE on its first LAUNCHER_LAYERS layers
    (``<arch>-<N>l``, a name each worker resolves) on the one card. (a)
    fp32, no fault;
    (b) fp32 with worker 0 killed at its fourth decode step (restart from
    its journal, tokens equal (a)'s); (c) bf16 ``python -m
    repro_torch.launch.bench_fleet`` with ``FLEET_DRAIN_REQUESTS`` sent
    SIGTERM once every worker is serving (drain: exit 0 everywhere, every
    request finished or checkpointed); (d) fp32 ``bench_serve``: uninterrupted with
    ``--out-results``, a ``--journal`` run sent SIGTERM mid-serve (exit 0,
    the ``DRAINED`` banner), then ``--resume``: the union of tokens equals
    the uninterrupted run. ``arch``/``device``: a smaller model or the
    CPU, to rehearse the phase's logic (no launch gates there)."""
    from repro_torch.configs import get_config
    from repro_torch.fleet import FleetConfig, FleetSupervisor
    from repro_torch.launch import bench_serve
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServeRequest

    t_phase = time.perf_counter()
    arch = _launcher_arch(arch)
    cfg = get_config(arch)
    n = len(SERVE_BUDGETS)
    prompts = make_prompts(cfg.vocab, n, SERVE_PROMPT)
    requests = [ServeRequest(rid=i, prompt=prompts[i], max_new_tokens=SERVE_BUDGETS[i])
                for i in range(n)]
    rows = {}
    if device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        weights = _tree_bytes(init_params(cfg, generator=torch.Generator(),
                                          dtype=torch.float32, device="meta"))
        need = FLEET_WORKERS * (weights + FLEET_WORKER_HEADROOM)
        print(f"fleet phase: device memory free {free} B of {total} B; {FLEET_WORKERS} fp32 "
              f"workers need {need} B ({weights} B of weights each)")
        if free < need:
            raise AssertionError(f"fleet phase: {free} B free, {need} B needed for "
                                 f"{FLEET_WORKERS} fp32 workers")
    saved = os.environ.get("REPRO_TORCH_KERNEL_BACKEND")
    if device == "cuda":  # a kernel that cannot run raises in the worker
        os.environ["REPRO_TORCH_KERNEL_BACKEND"] = "hopper"
    try:
        with tempfile.TemporaryDirectory() as d:
            # ---- (a), (b): the supervisor in this process, fp32 workers
            reports = {}
            for name, faults in (("fp32", {}), ("fp32-kill", {0: FLEET_KILL})):
                t0 = time.perf_counter()
                root = Path(d) / name
                fcfg = FleetConfig(n_workers=FLEET_WORKERS, arch=arch, slots=SERVE_SLOTS,
                                   dtype="float32", device=device, worker_faults=faults)
                rep = FleetSupervisor(requests, fcfg, root).run(max_wall_s=600.0)
                reports[name] = rep
                rows[name] = dict(_fleet_row(rep, t0),
                                  workers=_fleet_workers(root, rep, "float32", device))
                print(f"fleet {name}:", json.dumps(rows[name]))
            a, b = reports["fp32"], reports["fp32-kill"]
            toks = {k: {rid: r["tokens"] for rid, r in rep["results"].items()}
                    for k, rep in reports.items()}
            if not (a["finished"] == n and a["unaccounted"] == []
                    and not a["pending_checkpointed"]
                    and [len(toks["fp32"][str(i)]) for i in range(n)] == list(SERVE_BUDGETS)
                    and all(w["exit_code"] == 0 for w in a["workers"])):
                raise AssertionError(f"fleet fp32: {rows['fp32']}")
            rows["fp32-kill"]["tokens_equal_fp32"] = toks["fp32-kill"] == toks["fp32"]
            if not (b["restarts"]["crash"] >= 1 and b["failover_s"]["count"] >= 1
                    and b["unaccounted"] == [] and rows["fp32-kill"]["tokens_equal_fp32"]
                    and all(w["exit_code"] == 0 for w in b["workers"])):
                raise AssertionError(f"fleet fp32 kill: {rows['fp32-kill']}")

            # ---- (c): bf16 bench_fleet, SIGTERM once every worker serves
            t0 = time.perf_counter()
            root, out = Path(d) / "bf16-drain", Path(d) / "bf16-drain.json"
            drain_dtype = "bfloat16" if device == "cuda" else "float32"  # CPU: rehearsal
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.bench_fleet", "--arch", arch,
                 "--device", device, "--dtype", drain_dtype, "--workers",
                 str(FLEET_WORKERS), *FLEET_BENCH, "--n-requests", str(FLEET_DRAIN_REQUESTS),
                 "--dir", str(root), "--out", str(out)],
                env=_src_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, cwd=str(ROOT))
            try:
                from repro_torch.fleet import read_heartbeat

                def all_serving():
                    wd = [root / f"worker-{i}" for i in range(FLEET_WORKERS)]
                    return all((w / "journal" / "journal.jsonl").exists()
                               and (w / "journal" / "journal.jsonl").stat().st_size > 0
                               and (read_heartbeat(w / "heartbeat.json") or {}).get(
                                   "phase") not in (None, "init", "ready") for w in wd)
                _wait(all_serving, "bench_fleet: every worker serving", proc)
                t_term = time.perf_counter() - t0
                proc.send_signal(signal.SIGTERM)
                stdout, _ = proc.communicate(timeout=300)
            finally:
                proc.kill()
            if proc.returncode != 0:
                raise AssertionError(f"bench_fleet drain exited {proc.returncode}: "
                                     f"{stdout[-3000:]}")
            c = json.loads(out.read_text())
            rows["bf16-drain"] = dict(_fleet_row(c, t0), sigterm_after_s=t_term,
                                      workers=_fleet_workers(root, c, drain_dtype, device))
            print("fleet bf16 bench_fleet SIGTERM drain:", json.dumps(rows["bf16-drain"]))
            if not (c["finished"] + len(c["pending_checkpointed"]) == FLEET_DRAIN_REQUESTS
                    and c["drained"] and c["unaccounted"] == []
                    and all(w["exit_code"] == 0 for w in c["workers"])):
                raise AssertionError(f"fleet bf16 drain: {rows['bf16-drain']}")

            # ---- (d): fp32 bench_serve, SIGTERM mid-serve, then --resume
            t0 = time.perf_counter()
            base = ["--arch", arch, "--device", device, "--dtype", "float32", *FLEET_BENCH]
            full_path, jdir = Path(d) / "serve-full.json", Path(d) / "serve-journal"
            bench_serve.main(base + ["--out-results", str(full_path)])
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
            want = {r["rid"]: r["tokens"] for r in json.loads(full_path.read_text())["results"]}
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.bench_serve", *base, "--journal",
                 str(jdir), "--checkpoint-every", "4", "--out-results",
                 str(Path(d) / "serve-drained.json")],
                env=_src_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, cwd=str(ROOT))
            try:
                _wait(lambda: any('"ev":"wm"' in p.read_text()
                                  for p in jdir.glob("journal*.jsonl")),
                      "bench_serve: a decode step journaled", proc)
                proc.send_signal(signal.SIGTERM)
                stdout, _ = proc.communicate(timeout=300)
            finally:
                proc.kill()
            if proc.returncode != 0 or "DRAINED on SIGTERM" not in stdout:
                raise AssertionError(f"bench_serve drain exited {proc.returncode}: "
                                     f"{stdout[-3000:]}")
            got = {r["rid"]: r["tokens"] for r in json.loads(
                (Path(d) / "serve-drained.json").read_text())["results"]}
            drained = len(got)
            bench_serve.main(base + ["--journal", str(jdir), "--resume", "--out-results",
                                     str(Path(d) / "serve-resumed.json")])
            for r in json.loads((Path(d) / "serve-resumed.json").read_text())["results"]:
                got[r["rid"]] = r["tokens"]
            rows["bench-serve-drain-fp32"] = {
                "finished_before_drain": drained, "resumed": len(got) - drained,
                "tokens_equal": got == want, "requests": len(want),
                "wall_s": time.perf_counter() - t0}
            print("bench_serve fp32 SIGTERM drain, then --resume:",
                  json.dumps(rows["bench-serve-drain-fp32"]))
            if not (got == want and len(want) == n and drained < n):
                raise AssertionError(f"bench_serve drain/resume: "
                                     f"{rows['bench-serve-drain-fp32']}")
    finally:
        if saved is None:
            os.environ.pop("REPRO_TORCH_KERNEL_BACKEND", None)
        else:
            os.environ["REPRO_TORCH_KERNEL_BACKEND"] = saved
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    rep = {"rows": rows, "phase_s": time.perf_counter() - t_phase}
    print(f"fleet phase: {rep['phase_s']:.1f} s")
    return rep


# ---------------------------------------------------------------------------
# The per-expert engine (phase 20) and expert parallelism (phase 21)
# ---------------------------------------------------------------------------

# Phase 20's fp32 comparison of the two engines on one store: the first
# DICT_FP32_LAYERS layers of full-width OLMoE (as phase 17 cuts its fp32
# checks), the main batch
DICT_FP32_LAYERS = 4
# (b) and (c), the dict engine's bf16 and INT4 serves beside the slab
# engine's on the same store or codes, take the first LAUNCHER_LAYERS layers
# of full-width OLMoE: their gates read the dict engine's plumbing (one
# flash_attn a layer, no moe_gmm; int4_matmul by phase and route; its
# logits against its plain run and against the slab engine on the same
# codes), which depth does not change. Cut so that phase 24 (Phi-3.5-MoE
# offloaded) fits the whole run's time: the full-depth serves took 63.7 s
# of a 947.4 s run (H100 80GB HBM3, 700 W).
DICT_LAYERS = LAUNCHER_LAYERS
# the dict engine's bf16 serve: one flash_attn a layer in the prefill, its
# expert products torch.matmul (no moe_gmm); INT4: int4_matmul, three per
# needed expert and layer-step (a positive multiple of 3)
PATH_LAUNCHES["dict-bf16"] = {"moe_gmm": 0, "flash_attn": DICT_LAYERS, "int4_matmul": 0}
PATH_LAUNCHES["dict-int4"] = {"moe_gmm": 0, "flash_attn": DICT_LAYERS, "int4_matmul": None}
# (d): the launcher at full width on phase 4's shape, one wave
DICT_BENCH = ["--arch", "olmoe", "--offloaded", "--engine-impl", "dict", "--n-requests",
              "4", "--slots", "4", "--prompt-len", "128", "--max-new", "32", "--arrival",
              "all_at_once"]
_COUNTS = ("transfers", "transfer_bytes", "hits", "misses", "evictions", "modeled_time_s",
           "modeled_time_overlapped_s")


def _engine_row(eng, prompts, dev) -> tuple:
    """:func:`_serve_row` with the transfer bytes, evictions and the
    expert copies by phase beside it."""
    res, row = _serve_row(eng, prompts, dev)
    m, st = res["metrics"], res["cache_stats"]
    row.update(transfer_bytes=m.transfer_bytes, evictions=st.evictions, hits=st.hits,
               misses=st.misses, modeled_time_s=res["modeled_time_s"],
               modeled_time_overlapped_s=res["modeled_time_overlapped_s"],
               expert_copies=res["expert_copies"], impl=eng.impl,
               transfers=m.transfers)
    return res, row


def dict_bench(device: str = "cuda", capacity: int = 16, bench=DICT_BENCH) -> dict:
    """Phase 20(d): ``launch.bench_serve --offloaded --engine-impl dict``;
    every request finishes (its token budget or an end token), and
    experts move."""
    from repro_torch.launch import bench_serve

    t0 = time.perf_counter()
    bench = list(bench)
    bench[bench.index("--arch") + 1] = _launcher_arch(bench[bench.index("--arch") + 1])
    results, mt = bench_serve.main(["--device", device, "--capacity", str(capacity)] + bench)
    n = int(bench[bench.index("--n-requests") + 1])
    row = {"requests": len(results), "transfers": mt.transfers,
           "finish": sorted({r.finish_reason for r in results}),
           "generated_tokens": mt.generated_tokens, "wall_s": time.perf_counter() - t0}
    print("bench_serve --offloaded --engine-impl dict:", json.dumps(row))
    if not (len(results) == n and set(row["finish"]) <= {"length", "eos"}
            and mt.generated_tokens > 0 and mt.transfers > 0):
        raise AssertionError(f"bench_serve --engine-impl dict: {row}")
    return row


def dict_phase(arch: str = "olmoe", device: str = "cuda",
               fp32_layers: int = DICT_FP32_LAYERS, capacity: int = 16,
               bench=DICT_BENCH, layers: int = DICT_LAYERS) -> dict:
    """Phase 20, the per-expert engine (``impl="dict"``) beside the slab
    engine, full-width OLMoE at C = 16 (gamma), phase 4's batch: (a) fp32 on
    the first ``fp32_layers`` layers, dict against slab on one store:
    equal tokens, transfers and bytes, hits, misses, evictions and both
    Eq.-3 clocks; (b) bf16 on the first ``layers`` layers (DICT_LAYERS),
    phase 4's weights: the dict engine's prefill logits against its plain
    run (LOGITS_REL_TOL), one ``flash_attn`` ``tc`` launch a layer in the
    prefill, no ``moe_gmm`` and no ``int4_matmul`` launch, the slab engine
    on its store beside it; (c) INT4 codes of the same experts, bf16, the
    slab engine then the dict engine on them: the dict engine's
    ``int4_matmul`` on ``tc`` in the prefill and ``stream`` in decode, both
    > 0, tokens equal to the slab engine's or prefill logits within
    LOGITS_REL_TOL of them; (d) :func:`dict_bench`. Prints each engine's
    prefill s, decode tok/s, transfers, hit rate, both clocks and launches
    by phase and route side by side. ``arch``/``device``/``fp32_layers``/
    ``capacity``/``bench``/``layers``: a smaller model or the CPU, to
    rehearse the phase's logic."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload_engine import OffloadedMoEEngine
    from repro_torch.core.quant import matmul_layout, quantize_linear
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import init_params

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    dev = torch.device(device)
    prompts = make_prompts(cfg.vocab, 4, 128)
    kw = dict(capacity=capacity, policy="gamma", device=dev)
    rows = {}

    # ---- (a) fp32, the first layers: dict against slab on one store
    cut = get_config(_cut_arch(arch, fp32_layers))
    params = init_params(cut, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev, expert_device="cpu")
    eng = OffloadedMoEEngine(cut, params, **kw)
    store = eng.host_store
    _strip_experts(params)
    res_s, rows["fp32-slab"] = _engine_row(eng, prompts, dev)
    del eng
    eng = OffloadedMoEEngine(cut, params, host_store=store, impl="dict", **kw)
    res_d, rows["fp32-dict"] = _engine_row(eng, prompts, dev)
    del eng, params, store
    gc.collect()
    torch.cuda.empty_cache()
    tok_eq = bool(torch.equal(res_s["tokens"], res_d["tokens"]))
    diff = {k: (rows["fp32-dict"][k], rows["fp32-slab"][k]) for k in _COUNTS
            if rows["fp32-dict"][k] != rows["fp32-slab"][k]}
    fp32_rel = _rel(res_d["prefill_logits"], res_s["prefill_logits"])
    print(f"dict vs slab, fp32, {fp32_layers} layers: tokens equal {tok_eq}, counts "
          f"differing {diff}, prefill logits rel {fp32_rel:.3g}")
    if not tok_eq or diff or not fp32_rel <= FP32_LOGITS_REL_TOL:
        raise AssertionError(f"dict vs slab fp32: tokens equal {tok_eq}, counts {diff}, "
                             f"logits rel {fp32_rel}")
    del res_s, res_d

    # ---- (b) bf16, the first layers: phase 4's weights, the plain run and
    # the slab engine on the dict engine's store
    cut = get_config(_cut_arch(arch, min(layers, cfg.n_layers)))
    n = cut.n_layers
    params = init_params(cut, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev, expert_device="cpu")
    eng = OffloadedMoEEngine(cut, params, impl="dict", **kw)
    store = eng.host_store
    _strip_experts(params)
    gc.collect()
    res, rows["dict-bf16"] = _engine_row(eng, prompts, dev)
    del eng
    plain = OffloadedMoEEngine(cut, params, host_store=store, impl="dict",
                               kernel_backend="ref", **kw)
    plain_logits = plain.generate(prompts, max_new_tokens=1)["prefill_logits"]
    del plain
    rows["dict-bf16"]["logits_rel_plain"] = rel = _rel(res["prefill_logits"], plain_logits)
    del res
    _, rows["slab-bf16"] = _engine_row(OffloadedMoEEngine(cut, params, host_store=store, **kw),
                                       prompts, dev)
    if dev.type == "cuda":
        check_path("dict-bf16", rows["dict-bf16"]["launches_total"],
                   rows["dict-bf16"]["route_launches"])
    flash_pre = rows["dict-bf16"]["by_phase"]["prefill"].get("flash_attn", {})
    print(f"dict engine bf16, {n} layers, prefill logits vs plain: rel {rel:.3g} (tol "
          f"{LOGITS_REL_TOL}); flash_attn in its prefill {flash_pre}")
    if (dev.type == "cuda" and flash_pre != {"tc": n}) or not (
            math.isfinite(rel) and rel <= LOGITS_REL_TOL):
        raise AssertionError(f"dict engine bf16: flash {flash_pre}, logits rel {rel}")

    # ---- (c) INT4: codes of the same experts, the slab engine then the dict engine
    t0 = time.perf_counter()
    qexp = [{k: matmul_layout(quantize_linear(layer[k].to(dev), iters=4, group=32))
             for k in ("wg", "wu", "wd")} for layer in store]
    for gi, g in enumerate(cut.layout):  # the engines read only the experts' shapes
        for bp in params["groups"][f"g{gi}"].values():
            if "router" in bp.get("ffn", {}):
                for k, v in store[0].items():
                    bp["ffn"][k] = torch.empty((g.repeats,) + tuple(v.shape), dtype=v.dtype,
                                               device="meta")
    del store
    print(f"INT4 codes for the dict phase: {time.perf_counter() - t0:.1f} s")
    slab_q, rows["slab-int4"] = _engine_row(
        OffloadedMoEEngine(cut, params, quantized=True, quantized_experts=qexp, **kw),
        prompts, dev)
    eng = OffloadedMoEEngine(cut, params, quantized=True, quantized_experts=qexp,
                             impl="dict", **kw)
    res, rows["dict-int4"] = _engine_row(eng, prompts, dev)
    if dev.type == "cuda":
        check_path("dict-int4", rows["dict-int4"]["launches_total"],
                   rows["dict-int4"]["route_launches"])
    del eng, qexp, params
    gc.collect()
    torch.cuda.empty_cache()
    int4 = {ph: r.get("int4_matmul", {}) for ph, r in rows["dict-int4"]["by_phase"].items()}
    qrel = rows["dict-int4"]["logits_rel_slab"] = _rel(res["prefill_logits"],
                                                       slab_q["prefill_logits"])
    q_eq = rows["dict-int4"]["tokens_equal_slab"] = bool(torch.equal(
        res["tokens"].cpu(), slab_q["tokens"].cpu()))
    del res, slab_q
    print(f"dict engine INT4: int4_matmul by phase and route {int4}; tokens equal the INT4 "
          f"slab engine's {q_eq}, prefill logits vs its rel {qrel:.3g} (tol {LOGITS_REL_TOL})")
    if (dev.type == "cuda" and (set(int4["prefill"]) != {"tc"} or set(int4["decode"]) != {
            "stream"} or min(c for r in int4.values() for c in r.values()) <= 0)
            or not (q_eq or (math.isfinite(qrel) and qrel <= LOGITS_REL_TOL))):
        raise AssertionError(f"dict engine INT4: int4_matmul {int4}, tokens equal {q_eq}, "
                             f"logits rel {qrel}")

    rows["bench-dict"] = dict_bench(device, capacity, bench)

    print(f"(fp32 rows on {fp32_layers} layers, the others on {n}; bench-dict below)")
    print("engine          prefill_s  decode_tok/s  transfers  hit_rate  serial_s  "
          "overlap_s  copies(pre/dec)  gmm(pre/dec)  flash(pre)  int4(pre/dec)")
    for name, r in rows.items():
        if "by_phase" not in r:
            continue
        ph, cp = r["by_phase"], r.get("expert_copies", {})
        print(f"{name:15s} {r['prefill_s']:10.4f} {r['decode_tok_s']:13.2f} "
              f"{r['transfers']:10d} {r['hit_rate']:9.4f} {r['modeled_time_s']:9.4f} "
              f"{r['modeled_time_overlapped_s']:10.4f}  "
              f"{cp.get('prefill')}/{cp.get('decode')}  "
              f"{ph['prefill'].get('moe_gmm')}/{ph['decode'].get('moe_gmm')}  "
              f"{ph['prefill'].get('flash_attn')}  "
              f"{ph['prefill'].get('int4_matmul')}/{ph['decode'].get('int4_matmul')}")
    rep = {"rows": rows, "layers": n, "phase_s": time.perf_counter() - t_phase}
    print(f"dict phase: {rep['phase_s']:.1f} s")
    return rep


# Phase 21: two processes on the one card over gloo (NCCL takes one rank
# per device), (1, 2) ("data", "model") meshes. gloo runs the plain c10d
# collectives on CUDA tensors (all_reduce, all_gather, reduce_scatter,
# all_to_all, broadcast; staged through the host), but DTensor's
# redistribute runs the functional collectives, which end the process with
# SIGSEGV on CUDA tensors over gloo (torch 2.11.0+cu128, NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md, PR 23). So: (a) the expert-parallel MoE layer on
# the card, whose only collective is the c10d all_to_all (its DTensors keep
# their placements, and on a data axis of 1 a rank's output is the whole):
# OLMoE's MoE width, 4 x 128 tokens, zero_drop, fp32 within EP_FP32_REL of
# apply_moe_local on the card (the order of sums differs), bf16 within
# LOGITS_REL_TOL, moe_gmm launches per rank by route; (b) and (c) the
# DTensor model path on a host mesh (gloo, CPU tensors, EP_HOST_THREADS
# threads a rank) at OLMoE's full width cut to EP_FP32_LAYERS layers, fp32,
# against the single-device run of the same weights on the card: (b) a
# prefill and EP_DECODE greedy steps, the card's tokens and prefill logits
# within FP32_LOGITS_REL_TOL; (c) the MELINOE train step's loss and
# gradients (EP_TRAIN_B x EP_TRAIN_T tokens; on the card under the
# trainer's kernel spec): the card's loss within EP_LOSS_REL, every leaf's
# gradient within GRAD_REL_TOL of its largest element and grad_norm within
# GRAD_REL_TOL (the fine-tune's fp32 gradient gate: kernels against plain
# versions, only the order of sums differs). The parameters after a first
# AdamW step are not compared: it moves each element by about lr x the
# sign of its gradient, so a gradient off by a factor passes such a check.
# (d) the head-parallel Mamba2 mixer (models/mamba2.py::apply_mamba_sharded)
# on the card: one mixer at EP_MAMBA_ARCH's full width (d 3584, 112 heads,
# 56 a rank), its weights placed by distributed/sharding.py's rules, a
# prefill of EP_MAMBA_B x EP_MAMBA_T then EP_MAMBA_DECODE steps from the
# state it returns, against the local mixer on the card on the same weights
# and inputs: y of every step and the state after each (each rank's shard),
# fp32 within EP_FP32_REL (the order of sums differs: the gated norm's
# squares and the output are summed over the ranks), bf16 within
# LOGITS_REL_TOL; ssd_scan launches per rank by route ("tc" in bf16, one a
# prefill: each rank's heads). Its collectives are c10d ones (all_to_all,
# all_reduce) on the card's tensors.
# (e) the shared block's MLP split over "model" (models/mlp.py::
# apply_mlp_sharded) on the card: EP_MAMBA_ARCH's shared MLP (d 3584 ->
# d_ff 14,336), its weights placed by distributed/sharding.py's rules (wg
# and wu split along d_model, re-laid to d_ff blocks by one all_to_all
# each; wd along d_ff), EP_MAMBA_B x EP_MAMBA_T rows, against the local
# apply_mlp on the card: y, and the gradient of each weight for one random
# output gradient (each rank's shard), fp32 within EP_FP32_REL (norm
# relative, each leaf), bf16 within LOGITS_REL_TOL. x is replicated and
# takes no gradient: its gradient, partial over "model", would meet
# DTensor's functional all_reduce, which gloo cannot run on the card; the
# body's own collectives are c10d ones.
# (f) the train step's loss on vocab-split logits (core/losses.py::
# vocab_parallel_nll, which nll_loss_on_mesh takes where the logits are
# split along the vocab over "model"): EP_LOSS_B x EP_LOSS_T rows of fp32
# logits at the MoE arch's vocab (OLMoE: 50,304, 25,152 a rank), the same on
# both ranks from one seed, each rank its block; the loss and the block's
# gradient against one rank's plain nll_loss of the whole logits on the
# card, within EP_LOSS_TOL of the largest element. Its collectives are c10d
# all_reduces of (B, T - 1) floats on the card's tensors. Its peak
# (max_memory_allocated above what was allocated before) beside the
# gathering form's, the loss's path before it (the blocks all_gathered
# whole on every rank, then nll_loss), which must be higher.
EP_MAMBA_ARCH = "zamba2-7b"
EP_MAMBA_B, EP_MAMBA_T, EP_MAMBA_DECODE = 4, 512, 8
EP_RANKS = 2
EP_FP32_REL = 1e-5
EP_DECODE = 8
EP_FP32_LAYERS = 2
EP_HOST_THREADS = 4
EP_TRAIN_B, EP_TRAIN_T, EP_TRAIN_LR = 4, 128, 1e-3
EP_LOSS_REL = 1e-5
EP_LIMIT_S = 600
EP_LOSS_B, EP_LOSS_T = 4, 512
EP_LOSS_TOL = 1e-6


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _ep_serve(cfg, params, host, single, toks, steps: int) -> dict:
    """``params`` (a whole tree on the card, the same on every rank): the
    single-device prefill + ``steps`` greedy decode steps on the card, then
    the same on ``host``'s mesh from a CPU copy of the weights, sharded."""
    from repro_torch.distributed.sharding import distribute_params
    from repro_torch.launch.steps import build_decode_step, build_prefill_step

    def serve(p, rt, tk):
        _sync(tk.device)
        t0 = time.perf_counter()
        logits, cache = build_prefill_step(cfg, rt, n_slots=tk.shape[1] + steps)(
            p, {"tokens": tk})
        first = logits.full_tensor() if hasattr(logits, "full_tensor") else logits
        _sync(tk.device)
        t1 = time.perf_counter()
        out = [first.argmax(-1)]
        dec = build_decode_step(cfg, rt)
        for _ in range(steps):
            logits, cache = dec(p, {"tokens": out[-1], "cache": cache})
            out.append((logits.full_tensor() if hasattr(logits, "full_tensor")
                        else logits).argmax(-1))
        _sync(tk.device)
        return {"prefill_logits": first[:, 0].float().cpu(), "tokens": torch.cat(out, 1).cpu(),
                "prefill_s": t1 - t0,
                "decode_tok_s": tk.shape[0] * steps / (time.perf_counter() - t1)}

    with torch.no_grad():
        one = serve(params, single, toks)
        sharded = serve(distribute_params(_to(params, "cpu"), cfg, host), host, toks.cpu())
    return {"tokens_equal_card": bool(torch.equal(sharded["tokens"], one["tokens"])),
            "logits_rel_card": _rel(sharded["prefill_logits"], one["prefill_logits"]),
            "tokens": sharded["tokens"].tolist(),
            "card_prefill_s": one["prefill_s"], "card_decode_tok_s": one["decode_tok_s"],
            "host_prefill_s": sharded["prefill_s"],
            "host_decode_tok_s": sharded["decode_tok_s"]}


def _shard_of(whole, dt):
    """This rank's part of ``whole`` as the DTensor ``dt`` splits it (its
    local tensor's place), without a collective."""
    mesh = dt.device_mesh
    for i, p in enumerate(dt.placements):
        if p.is_shard():
            n = whole.shape[p.dim] // mesh.shape[i]
            whole = whole.narrow(p.dim, mesh.get_local_rank(i) * n, n)
    return whole


def _ep_mamba(mesh, dev, arch: str = EP_MAMBA_ARCH) -> dict:
    """Phase 21(d) on this rank (see EP_MAMBA_ARCH)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import distribute, leaf_spec
    from repro_torch.kernels import dispatch
    from repro_torch.models import mamba2, tensor_parallel
    from repro_torch.models.runtime import Runtime

    cfg = get_config(arch)
    spec, d = cfg.block_defs["mamba"].ssm, cfg.d_model
    rt, one = Runtime(device=dev, mesh=mesh), Runtime(device=dev)
    rows = ("data", None, None)
    out = {}
    for dtype, tol in ((torch.float32, EP_FP32_REL), (torch.bfloat16, LOGITS_REL_TOL)):
        gen = torch.Generator(device=dev).manual_seed(0)
        p = mamba2.init_mamba(d, spec, dtype, generator=gen, device=dev)
        p["norm_w"] = (0.1 * torch.randn(p["norm_w"].shape, generator=gen, device=dev)
                       ).to(dtype)  # zeros at init: a wrong slice of it would not show
        p["conv_b"] = (0.1 * torch.randn(p["conv_b"].shape, generator=gen, device=dev)
                       ).to(dtype)
        x = torch.randn((EP_MAMBA_B, EP_MAMBA_T, d), generator=gen, device=dev).to(dtype)
        xs = [torch.randn((EP_MAMBA_B, 1, d), generator=gen, device=dev).to(dtype)
              for _ in range(EP_MAMBA_DECODE)]
        with torch.no_grad():
            y1, st1 = mamba2.apply_mamba_full(p, x, spec, return_state=True, rt=one)
            want = [(y1, st1)]
            for xt in xs:
                want.append(mamba2.apply_mamba_decode(p, xt, want[-1][1], spec))
            dp = {k: distribute(v, rt.prune_spec(v.shape, leaf_spec(
                f"mixer/{k}", v, fsdp=False, data_axes=rt.data_axes)), mesh)
                for k, v in p.items()}
            _sync(dev)
            dispatch.reset_launches()
            t1 = time.perf_counter()
            with rt.dist():
                got = [mamba2.apply_mamba_full(dp, distribute(x, rows, mesh), spec,
                                               return_state=True, rt=rt)]
                ssd = dict(dispatch.ROUTE_LAUNCHES["ssd_scan"])
                _sync(dev)
                t2 = time.perf_counter()
                for xt in xs:
                    got.append(mamba2.apply_mamba_decode(dp, distribute(xt, rows, mesh),
                                                         got[-1][1], spec, rt=rt))
            _sync(dev)
            t3 = time.perf_counter()
        # the data axis is 1: a rank's y is the whole; its state its shard
        rel = [max(_rel(gy.to_local(), wy),
                   *(_rel(g.to_local(), _shard_of(w, g)) for g, w in zip(gs, ws)))
               for (gy, gs), (wy, ws) in zip(got, want)]
        out[str(dtype).replace("torch.", "")] = {
            "rel_prefill": rel[0], "rel_decode_worst": max(rel[1:]), "tol": tol,
            "ssd_scan_routes": ssd, "prefill_s": t2 - t1,
            "decode_step_ms": 1e3 * (t3 - t2) / EP_MAMBA_DECODE,
            "heads": [tensor_parallel.block_of(spec.n_heads(d), mesh.shape[-1], r)
                      for r in range(mesh.shape[-1])],
            "placements": {k: str(tuple(v.placements)) for k, v in dp.items()},
            "state_placements": [str(tuple(t.placements)) for t in got[-1][1]]}
        del p, dp, x, xs, want, got
    return out


def _ep_mlp(mesh, dev, arch: str = EP_MAMBA_ARCH) -> dict:
    """Phase 21(e) on this rank (see EP_MAMBA_ARCH)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import distribute, leaf_spec
    from repro_torch.models.mlp import apply_mlp, apply_mlp_sharded, init_mlp
    from repro_torch.models.runtime import Runtime

    cfg = get_config(arch)
    d_ff = next(b.d_ff for b in cfg.block_defs.values() if b.kind == "shared_attn")
    rt = Runtime(device=dev, mesh=mesh)
    out = {}
    for dtype, tol in ((torch.float32, EP_FP32_REL), (torch.bfloat16, LOGITS_REL_TOL)):
        gen = torch.Generator(device=dev).manual_seed(0)
        p = init_mlp(cfg.d_model, d_ff, dtype, generator=gen, device=dev)
        x = torch.randn((EP_MAMBA_B, EP_MAMBA_T, cfg.d_model), generator=gen,
                        device=dev).to(dtype)
        dy = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
        w = {k: t.clone().requires_grad_() for k, t in p.items()}
        want_y = apply_mlp(w, x)
        want = torch.autograd.grad(want_y, list(w.values()), dy)
        dp = {k: distribute(t, rt.prune_spec(t.shape, leaf_spec(
            f"shared/ffn/{k}", t, fsdp=False, data_axes=rt.data_axes)), mesh).requires_grad_()
            for k, t in p.items()}
        rep = (None, None, None)
        _sync(dev)
        t1 = time.perf_counter()
        with rt.dist():
            y = apply_mlp_sharded(dp, distribute(x, rep, mesh), rt)
            got = torch.autograd.grad(y, list(dp.values()), distribute(dy, rep, mesh))
        _sync(dev)
        out[str(dtype).replace("torch.", "")] = {
            "rel_y": _rel(y.to_local(), want_y.detach()),
            "rel_grad": {k: _rel(g.to_local(), _shard_of(wg, g))
                         for k, g, wg in zip(dp, got, want)},
            "tol": tol, "s": time.perf_counter() - t1,
            "placements": {k: str(tuple(t.placements)) for k, t in dp.items()}}
        del p, x, dy, w, want_y, want, dp, y, got
    return out


def _ep_loss(mesh, dev, arch: str) -> dict:
    """Phase 21(f) on this rank (see EP_LOSS_B): the split loss, then the
    gathering form, each forward + backward from a fresh copy of the block."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.losses import next_token_shift, nll_loss, vocab_parallel_nll

    V = get_config(arch).vocab
    md = mesh.mesh_dim_names.index("model")
    ms, me, group = mesh.shape[md], mesh.get_local_rank(md), mesh.get_group(md)
    assert V % ms == 0, (arch, V, ms)
    lo, c = me * (V // ms), V // ms
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = 2.0 * torch.randn((EP_LOSS_B, EP_LOSS_T, V), generator=gen, device=dev)
    labels = torch.randint(0, V, (EP_LOSS_B, EP_LOSS_T), generator=gen, device=dev)
    start, tgt = next_token_shift(labels)
    n = tgt.shape[1]
    whole = logits.requires_grad_()
    want = nll_loss(whole[:, start:start + n], tgt)
    want_g = torch.autograd.grad(want, [whole])[0][..., lo:lo + c].contiguous()
    block = logits.detach()[..., lo:lo + c].contiguous()
    del logits, whole

    def split():
        x = block.clone().requires_grad_()
        loss = vocab_parallel_nll(x, tgt, lo=lo, group=group, start=start)
        return loss.detach(), torch.autograd.grad(loss, [x])[0]

    def gathered():
        x = block.clone().requires_grad_()
        parts = [torch.empty_like(block) for _ in range(ms)]
        dist.all_gather(parts, block, group=group)
        parts[me] = x
        full = torch.cat(parts, -1)
        loss = nll_loss(full[:, start:start + n], tgt)
        return loss.detach(), torch.autograd.grad(loss, [x])[0]

    out = {"vocab": V, "block": [lo, lo + c], "tol": EP_LOSS_TOL}
    for name, fn in (("split", split), ("gathered", gathered)):
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        loss, grad = fn()
        _sync(dev)
        out[name] = {
            "s": time.perf_counter() - t1,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev) - base
                           if dev.type == "cuda" else None),
            "rel_loss": abs(loss.item() - want.item()) / abs(want.item()),
            "rel_grad": ((grad - want_g).abs().max() / want_g.abs().max()).item()}
        del loss, grad
    return out


def _ep_worker(rank: int, world: int, port: int, out_dir: str, arch: str,
               device: str, mamba_arch: str = EP_MAMBA_ARCH) -> None:
    """One rank of phase 21; rank 0 writes ``out_dir/ep.json``."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(EP_HOST_THREADS)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        from repro_torch.configs import get_config
        from repro_torch.distributed.sharding import distribute, distribute_params
        from repro_torch.kernels import _build, dispatch
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.launch.steps import build_train_step
        from repro_torch.models.model import init_params
        from repro_torch.models.moe import apply_moe_local, apply_moe_sharded, init_moe
        from repro_torch.models.runtime import Runtime
        from repro_torch.training.optim import OptConfig
        from repro_torch.training.trainer import train_runtime

        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(0)  # every rank on the one card
            _build.lib()
        mesh = make_debug_mesh(1, world, device_type=dev.type)
        host_mesh = make_debug_mesh(1, world, device_type="cpu")
        single = Runtime(device=dev)
        host = Runtime(device=torch.device("cpu"), mesh=host_mesh)
        cfg = get_config(arch)
        rep = {"rank": rank, "device": str(dev)}
        t0 = time.perf_counter()

        # ---- (a) the expert-parallel MoE layer on the card, OLMoE's width
        spec, d = cfg.moe_spec, cfg.d_model
        zrt = Runtime(device=dev, mesh=mesh, zero_drop=True)
        moe = {}
        for dtype, tol in ((torch.float32, EP_FP32_REL), (torch.bfloat16, LOGITS_REL_TOL)):
            gen = torch.Generator(device=dev).manual_seed(0)
            p = init_moe(d, spec, dtype, generator=gen, device=dev)
            x = torch.randn((4 * 128, d), generator=gen, device=dev).to(dtype)
            with torch.no_grad():
                y_loc, _ = apply_moe_local(p, x, spec, zrt.local())
                dp = {"router": distribute(p["router"], (None, None), mesh),
                      **{k: distribute(p[k], ("model", None, None), mesh)
                         for k in ("wg", "wu", "wd")}}
                dx = distribute(x, ("data", None), mesh)
                _sync(dev)
                dispatch.reset_launches()
                t1 = time.perf_counter()
                with zrt.dist():
                    y, _ = apply_moe_sharded(dp, dx, spec, zrt)
                y = y.to_local()  # the data axis is 1: the whole output
                _sync(dev)
                moe[str(dtype).replace("torch.", "")] = {
                    "rel": _rel(y, y_loc), "tol": tol, "s": time.perf_counter() - t1,
                    "moe_gmm_routes": dict(dispatch.ROUTE_LAUNCHES["moe_gmm"])}
            del p, x, dp, dx, y, y_loc
        rep["moe"] = moe

        # ---- (d) the head-parallel Mamba2 mixer on the card, zamba2-7b's width
        t1 = time.perf_counter()
        rep["mamba"] = _ep_mamba(mesh, dev, mamba_arch)
        rep["mamba_s"] = time.perf_counter() - t1

        # ---- (e) the shared MLP split over "model" on the card, its width
        t1 = time.perf_counter()
        rep["mlp"] = _ep_mlp(mesh, dev, mamba_arch)
        rep["mlp_s"] = time.perf_counter() - t1

        # ---- (f) the train step's loss on vocab-split logits on the card
        t1 = time.perf_counter()
        rep["loss"] = _ep_loss(mesh, dev, arch)
        rep["loss_s"] = time.perf_counter() - t1

        # ---- (b) the sharded model path on the host mesh, fp32, first layers
        cut = get_config(_cut_arch(arch, EP_FP32_LAYERS))
        fp32 = init_params(cut, generator=torch.Generator(device=dev).manual_seed(0),
                           dtype=torch.float32, device=dev)
        toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (4, 128)),
                               device=dev)
        rep["serve_fp32"] = _ep_serve(cut, fp32, host, single, toks, EP_DECODE)

        # ---- (c) the MELINOE train step's loss and gradients, same layers
        batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab,
                                                             (EP_TRAIN_B, EP_TRAIN_T))}
        batch["labels"] = batch["tokens"]
        oc = OptConfig(peak_lr=EP_TRAIN_LR, total_steps=10)
        l1, _, g1 = build_train_step(cut, train_runtime(dev), oc, melinoe=True).loss_and_grads(
            fp32, batch)
        g1 = {p: g.cpu() for p, g in _grad_leaves(g1)}
        dp = distribute_params(_to(fp32, "cpu"), cut, host)
        del fp32
        t1 = time.perf_counter()
        l2, _, g2 = build_train_step(cut, host, oc, melinoe=True).loss_and_grads(dp, batch)
        g2 = {p: (torch.stack([x.full_tensor() for x in g]) if isinstance(g, list)
                  else g.full_tensor()) for p, g in _grad_leaves_raw(g2)}
        host_s = time.perf_counter() - t1
        loss1, loss2 = l1.item(), l2.full_tensor().item()
        rel = {p: ((g2[p] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
               for p, g in g1.items()}
        gn1, gn2 = (math.sqrt(sum(float(g.double().square().sum()) for g in t.values()))
                    for t in (g1, g2))
        worst = max(rel, key=rel.get)
        rep["train"] = {"loss_card": loss1, "loss_host_sharded": loss2,
                        "loss_rel": abs(loss2 - loss1) / abs(loss1),
                        "grad_rel_worst_leaf": rel[worst], "worst_leaf": worst,
                        "grad_norm_rel": abs(gn2 - gn1) / gn1,
                        "leaves": len(rel), "leaves_equal": sorted(g1) == sorted(g2),
                        "host_loss_and_grads_s": host_s}
        rep["worker_s"] = time.perf_counter() - t0
        reps = [None] * world
        dist.all_gather_object(reps, rep)
        if rank == 0:
            Path(out_dir, "ep.json").write_text(json.dumps(reps))
    finally:
        dist.destroy_process_group()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ep_phase(arch: str = "olmoe", device: str = "cuda",
             mamba_arch: str = EP_MAMBA_ARCH) -> dict:
    """Phase 21 (see EP_RANKS): spawns the two ranks, waits for them within
    EP_LIMIT_S, stops both, and gates their report. ``arch``/``device``/
    ``mamba_arch``: smaller models or the CPU, to rehearse the phase's
    logic."""
    import socket

    t_phase = time.perf_counter()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        ctx = torch.multiprocessing.start_processes(
            _ep_worker, args=(EP_RANKS, port, d, arch, device, mamba_arch),
            nprocs=EP_RANKS,
            join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t_phase > EP_LIMIT_S:
                    raise TimeoutError(f"phase 21: the ranks took over {EP_LIMIT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        reps = json.loads(Path(d, "ep.json").read_text())
    for r in reps:
        print(f"ep rank {r['rank']}:", json.dumps(r))
    bad = []
    for r in reps:
        for name, m in r["moe"].items():
            if not m["rel"] <= m["tol"] or (device == "cuda"
                                            and sum(m["moe_gmm_routes"].values()) <= 0):
                bad.append((r["rank"], "moe", name, m))
        if device == "cuda" and set(r["moe"]["bfloat16"]["moe_gmm_routes"]) != {"tc"}:
            bad.append((r["rank"], "moe bf16 routes", r["moe"]["bfloat16"]["moe_gmm_routes"]))
        for name, m in r["mamba"].items():
            if not (m["rel_prefill"] <= m["tol"] and m["rel_decode_worst"] <= m["tol"]):
                bad.append((r["rank"], "mamba", name, m))
            want = {"tc": 1} if name == "bfloat16" else {"fma": 1}
            if device == "cuda" and m["ssd_scan_routes"] != want:
                bad.append((r["rank"], "mamba ssd_scan routes", name, m["ssd_scan_routes"]))
        for name, m in r["mlp"].items():
            if not (m["rel_y"] <= m["tol"] and max(m["rel_grad"].values()) <= m["tol"]):
                bad.append((r["rank"], "shared mlp", name, m))
        lo = r["loss"]
        if not all(lo[k]["rel_loss"] <= lo["tol"] and lo[k]["rel_grad"] <= lo["tol"]
                   for k in ("split", "gathered")) or (
                device == "cuda" and not lo["split"]["peak_bytes"] < lo["gathered"]["peak_bytes"]):
            bad.append((r["rank"], "vocab-split loss", lo))
        t, s32 = r["train"], r["serve_fp32"]
        if not (t["leaves_equal"] and t["loss_rel"] <= EP_LOSS_REL
                and t["grad_rel_worst_leaf"] <= GRAD_REL_TOL
                and t["grad_norm_rel"] <= GRAD_REL_TOL):
            bad.append((r["rank"], "train", t))
        if not (s32["tokens_equal_card"] and s32["logits_rel_card"] <= FP32_LOGITS_REL_TOL):
            bad.append((r["rank"], "serve fp32", s32))
    r0 = reps[0]
    print(f"expert parallelism, {EP_RANKS} ranks over gloo: MoE layer on the card rel "
          f"{ {k: v['rel'] for k, v in r0['moe'].items()} }, moe_gmm a rank "
          f"{ {k: v['moe_gmm_routes'] for k, v in r0['moe'].items()} }; sharded on the host "
          f"mesh, {EP_FP32_LAYERS} layers fp32: tokens equal the card's "
          f"{r0['serve_fp32']['tokens_equal_card']}, logits rel "
          f"{r0['serve_fp32']['logits_rel_card']:.3g}; train loss rel "
          f"{r0['train']['loss_rel']:.3g}, gradients worst leaf rel "
          f"{r0['train']['grad_rel_worst_leaf']:.3g} (tol {GRAD_REL_TOL}), grad_norm rel "
          f"{r0['train']['grad_norm_rel']:.3g}")
    for r in reps:
        print(f"head-parallel Mamba2 mixer ({mamba_arch} width) on the card, rank "
              f"{r['rank']}: " + "; ".join(
                  f"{k} prefill rel {m['rel_prefill']:.3g}, decode worst rel "
                  f"{m['rel_decode_worst']:.3g} (tol {m['tol']}), ssd_scan "
                  f"{m['ssd_scan_routes']}, prefill {m['prefill_s']:.4f} s, decode "
                  f"{m['decode_step_ms']:.3f} ms a step" for k, m in r["mamba"].items())
              + f"; part (d) {r['mamba_s']:.1f} s")
        print(f"shared MLP split over 'model' ({mamba_arch} width) on the card, rank "
              f"{r['rank']}: " + "; ".join(
                  f"{k} y rel {m['rel_y']:.3g}, gradients worst leaf rel "
                  f"{max(m['rel_grad'].values()):.3g} (tol {m['tol']}), {m['s']:.3f} s"
                  for k, m in r["mlp"].items()) + f"; part (e) {r['mlp_s']:.1f} s")
        lo = r["loss"]
        print(f"loss on vocab-split logits (vocab {lo['vocab']}, block {lo['block']}, "
              f"{EP_LOSS_B} x {EP_LOSS_T} rows, fp32) on the card, rank {r['rank']}: "
              + "; ".join(f"{k} loss rel {m['rel_loss']:.3g}, gradient rel "
                          f"{m['rel_grad']:.3g} (tol {lo['tol']}), peak {m['peak_bytes']} B, "
                          f"{m['s']:.3f} s" for k, m in ((k, lo[k]) for k in
                                                        ("split", "gathered")))
              + f"; part (f) {r['loss_s']:.1f} s")
    if bad:
        raise AssertionError(f"phase 21: {bad}")
    rep = {"ranks": reps, "phase_s": time.perf_counter() - t_phase}
    print(f"expert-parallel phase: {rep['phase_s']:.1f} s")
    return rep


# ---------------------------------------------------------------------------
# The dry run (phase 22)
# ---------------------------------------------------------------------------

# (a) full-width OLMoE-1B-7B, bf16, one card: (name, mode, batch, length,
# layers). The full-parameter train step at full depth does not fit one
# card (AdamW's fp32 moments alone are 55.4 GB): it is predicted at full
# depth and run, and predicted again, at DRY_TRAIN_LAYERS.
DRY_TRAIN_LAYERS = 8
DRY_CASES = (("prefill", "prefill", 4, 512, None), ("decode", "decode", 4, 1024, None),
             ("train", "train", TRAIN_B, TRAIN_T, DRY_TRAIN_LAYERS))
# the gates: arguments, peak and the step's own rise (peak less arguments,
# which the arguments do not dominate: prefill's rise is 8% of its peak,
# decode's 0.5%) as a share of the card's
DRY_ARG_REL, DRY_PEAK_REL, DRY_RISE_REL = 0.01, 0.10, 0.10
# (b) the production meshes, by the command line in a child process that
# sees no card: (shape, meshes). train_4k on the single pod is left out: its
# trace took 237.4 s on the host of an H100 80GB HBM3 machine (the cs-loss
# scan runs 4096 steps a layer), above the 150 s this phase allows it;
# ``python -m repro_torch.launch.dryrun --shape train_4k`` runs it.
DRY_CLI = (("decode_32k", "both"), ("prefill_32k", "both"), ("long_500k", "both"))
DRY_CLI_LIMIT_S = 900


def start_production_dryruns(out_dir: Path, arch: str = "olmoe") -> subprocess.Popen:
    """Phase 22(b), started right after the kernel build so that it runs
    beside phases 3-21: ``python -m repro_torch.launch.dryrun`` for each of
    ``DRY_CLI`` in turn, in one child process group that sees no card
    (``CUDA_VISIBLE_DEVICES`` empty: the production meshes are a host
    computation, the fake tensors stand in for the card), one torch thread.
    Stopped at exit whatever happens."""
    import atexit
    import shlex

    cmds = [f"{shlex.quote(sys.executable)} -m repro_torch.launch.dryrun --arch {arch} "
            f"--shape {shape} --mesh {mesh} --out-dir {shlex.quote(str(out_dir))}"
            for shape, mesh in DRY_CLI]
    env = dict(_src_env(), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    log = open(out_dir / "dryrun.log", "w")
    proc = subprocess.Popen(["sh", "-c", " && ".join(cmds)], stdout=log,
                            stderr=subprocess.STDOUT, env=env, start_new_session=True)
    proc.t0, proc.arch = time.perf_counter(), arch

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(10)
        log.close()

    atexit.register(stop)
    return proc


def _dry_inputs(cfg, mode: str, B: int, T: int, dev):
    """The real step's arguments on the card: seeded weights (bf16), the
    batch's tokens, the optimizer state or an empty cache of T slots."""
    from repro_torch.models.model import init_cache, init_params
    from repro_torch.training.optim import init_opt_state

    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=gen, dtype=torch.bfloat16, device=dev)
    toks = torch.randint(0, cfg.vocab, (B, T if mode != "decode" else 1), generator=gen,
                         device=dev)
    if mode == "train":
        labels = torch.randint(0, cfg.vocab, (B, T), generator=gen, device=dev)
        return (params, init_opt_state(params), {"tokens": toks, "labels": labels})
    if mode == "prefill":
        return (params, {"tokens": toks})
    return (params, {"tokens": toks, "cache": init_cache(cfg, B, T, torch.bfloat16, device=dev)})


def _dry_card(cfg, mode: str, B: int, T: int, device: str = "cuda") -> dict:
    """The step of ``mode`` on the card: the rise of memory_allocated as the
    arguments are placed, max_memory_allocated over the step from before
    them, and the launches by op and route (on the CPU, to rehearse: no
    memory figures)."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import build_decode_step, build_prefill_step, build_train_step
    from repro_torch.models.runtime import Runtime
    from repro_torch.training import TRAIN_KERNEL_BACKEND, OptConfig

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def allocated():
        _sync(dev)
        return torch.cuda.memory_allocated() if cuda else 0

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    base = allocated()
    args = _dry_inputs(cfg, mode, B, T, dev)
    placed = allocated()
    if mode == "train":
        step = build_train_step(cfg, Runtime(kernel_backend=TRAIN_KERNEL_BACKEND, device=dev),
                                OptConfig(total_steps=1000), melinoe=True)
    elif mode == "prefill":
        step = build_prefill_step(cfg, Runtime(device=dev), n_slots=T)
    else:
        step = build_decode_step(cfg, Runtime(device=dev))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    t0 = time.perf_counter()
    out = step(*args)
    _sync(dev)
    step_s = time.perf_counter() - t0
    launches = dict(dispatch.LAUNCHES)
    routes = dispatch.route_snapshot()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    logits = out[0] if mode != "train" else out[2]["loss"]
    finite = bool(torch.isfinite(logits.float()).all())
    del out, args
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"argument_bytes": placed - base, "peak_bytes": peak - base,
            "step_rise_bytes": peak - placed, "launches": launches,
            "routes": routes, "finite": finite, "step_s": step_s}


def _gb(n) -> str:
    return f"{n / 1e9:.3f}"


def dryrun_phase(bg: subprocess.Popen, out_dir: Path, arch: str = "olmoe",
                 cases=DRY_CASES, cli=DRY_CLI, device: str = "cuda") -> dict:
    """Phase 22: (a) the dry run's one-card prediction against the card for
    each of ``cases``, (b) the production-mesh records of ``bg``
    (:func:`start_production_dryruns`). ``arch``/``cases``/``cli``/
    ``device``: a smaller model, shapes and the CPU, to rehearse the
    phase's logic (no gate in (a) there: the CPU has no memory figures and
    launches no kernel)."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels.int4_matmul.ops import fake_splits, splits
    from repro_torch.launch.dryrun import dry_run
    from repro_torch.models.runtime import Runtime

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    total = torch.cuda.get_device_properties(0).total_memory if cuda else 80e9
    # (a) the prediction against the card
    rows, bad = {}, []
    for name, mode, B, T, layers in cases:
        shape = ShapeSpec(name, T, B, mode)
        if layers is not None:  # the full depth, predicted only
            full = dry_run(get_config(arch), shape, Runtime(device=torch.device("cuda")))
            fm = full["memory_analysis"]
            print(f"dry run {arch} {name} {B}x{T}, all {get_config(arch).n_layers} layers "
                  f"(predicted only): arguments {_gb(fm['argument_size_in_bytes'])} GB, peak "
                  f"{_gb(fm['peak_bytes'])} GB, fits the card's {_gb(total)} GB: "
                  f"{fm['peak_bytes'] <= total}; trace {full['trace_s']} s")
        cfg = get_config(_cut_arch(arch, layers))
        pred = dry_run(cfg, shape, Runtime(device=torch.device("cuda")))
        card = _dry_card(cfg, mode, B, T, device)
        pm = pred["memory_analysis"]
        arg_rel = abs(pm["argument_size_in_bytes"] - card["argument_bytes"]) / max(
            card["argument_bytes"], 1)
        peak_rel = abs(pm["peak_bytes"] - card["peak_bytes"]) / max(card["peak_bytes"], 1)
        rise = pm["peak_bytes"] - pm["argument_size_in_bytes"]
        launches = {op: n for op, n in pred["kernel_launches"].items()}
        row = {"layers": cfg.n_layers, "batch": B, "length": T, "predicted": pred,
               "card": card, "argument_rel": arg_rel, "peak_rel": peak_rel,
               "step_rise_rel": abs(rise - card["step_rise_bytes"]) / max(card["step_rise_bytes"], 1),
               "launches_equal": launches == card["launches"] and pred["kernel_routes"]
               == {op: r for op, r in card["routes"].items() if r}}
        rows[name] = row
        print(f"dry run vs card, {arch} {name} {B}x{T} ({cfg.n_layers} layers): arguments "
              f"{pm['argument_size_in_bytes']} predicted, {card['argument_bytes']} on the card "
              f"(rel {arg_rel:.3g}); peak {pm['peak_bytes']} / {card['peak_bytes']} (rel "
              f"{peak_rel:.3g}); the step's own rise {rise} / {card['step_rise_bytes']} (rel "
              f"{row['step_rise_rel']:.3g}); launches {pred['kernel_routes']} / "
              f"{card['routes']}; trace {pred['trace_s']} s, step {card['step_s']:.3f} s")
        if cuda and not (arg_rel <= DRY_ARG_REL and peak_rel <= DRY_PEAK_REL
                         and row["step_rise_rel"] <= DRY_RISE_REL
                         and row["launches_equal"] and card["finite"]):
            bad.append((name, {k: row[k] for k in ("argument_rel", "peak_rel", "step_rise_rel",
                                                   "launches_equal")}, card["finite"]))
    # the shape function's split-K count against the kernel library's
    for M in (1, 4, 7, 512) if cuda else ():
        for K, N in ((2048, 1024), (1024, 2048), (2048, 1000)):
            for route in ("stream", "tc") if M <= 16 else ("tc",):
                if fake_splits(route, M, K, N, 32) != splits(route, M, K, N, 32):
                    bad.append(("int4 splits", route, M, K, N))
    # (b) the production meshes
    try:
        bg.wait(max(1.0, DRY_CLI_LIMIT_S - (time.perf_counter() - bg.t0)))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"phase 22(b): the production dry runs took over "
                           f"{DRY_CLI_LIMIT_S} s") from None
    bg_s = time.perf_counter() - bg.t0
    log = (out_dir / "dryrun.log").read_text()
    print("\n".join(line for line in log.splitlines() if line.startswith(("[ok]", "[FAIL]"))))
    if bg.returncode != 0:
        raise AssertionError(f"phase 22(b): the dry run exited {bg.returncode}: {log[-3000:]}")
    records = []
    for shape, mesh in cli:
        for kind in (("single", "multi") if mesh == "both" else (mesh,)):
            rec = json.loads((out_dir / f"{bg.arch}__{shape}__{kind}.json").read_text())
            mem, coll = rec["memory_analysis"], rec["collectives"]
            records.append(rec)
            print(f"dry run {bg.arch} {shape} on {kind} {rec['mesh_shape']}: a device holds "
                  f"{_gb(mem['argument_size_in_bytes'])} GB of arguments, peaks at "
                  f"{_gb(mem['peak_bytes'])} GB (fits {_gb(total)} GB: "
                  f"{mem['peak_bytes'] <= total}), computes "
                  f"{rec['flops_per_device'] / 1e12:.3f} TFLOP, sends "
                  f"{ {k: round(v / 1e9, 3) for k, v in coll['bytes_by_kind'].items()} } GB; "
                  f"launches {rec['kernel_launches']}; trace {rec['trace_s']} s")
            if not coll["total_bytes"] > 0:
                bad.append((shape, kind, "no collective bytes"))
    if bad:
        raise AssertionError(f"phase 22: {bad}")
    rep = {"rows": rows, "records": records, "production_s": bg_s,
           "phase_s": time.perf_counter() - t_phase}
    print(f"dry-run phase: {rep['phase_s']:.1f} s (the production dry runs, started with the "
          f"kernel build, traced {sum(r['trace_s'] for r in records):.1f} s in all and were "
          f"collected {bg_s:.1f} s after their start)")
    return rep


# Phase 23: Mixtral-8x7B (paper Table 6/7: 8 experts, top-2, d_ff 14,336,
# C = 2) offloaded at full width through launch.serve.run, 4 x (128 + 16)
# tokens, gamma, random weights from seed 0, one child process per store
# (INT4 at full depth, then bf16) so that each build's host memory is its own.
# Phase 24 serves Phi-3.5-MoE (PHI) the same way. C is each config's cache
# capacity (paper Table 7: E/4), which run(capacity=0) and bench_serve's
# --capacity 0 take: Mixtral 2, Phi 4.
MIXTRAL = "mixtral-8x7b"
OFFLOAD_SERVE = dict(policy="gamma", batch=4, prompt_len=128, seed=0)
OFFLOAD_NEW = 16
# host memory the bf16 phase leaves free beside its store: it serves at
# full depth where MemAvailable at its start holds the 84.0 GiB store plus
# this, else at the deepest depth that does (2.625 GiB of experts a layer)
MIXTRAL_HOST_HEADROOM_GIB = 8
MIXTRAL_FP32_LAYERS = 2
# The child's resident-set high-water mark after the build
# (launch.serve.max_rss_bytes) less the same before it (torch, the CUDA
# context and the kernel library loaded), and the host's MemAvailable
# before the build less after it, each against host_store_bytes: this
# margin is what else the build may allocate in host memory (numpy's and
# torch's bookkeeping, CUDA's host-side state as the draws and the
# quantization first launch their kernels). One expert matrix is drawn or
# quantized at a time on the card; a second host copy of the experts would
# add 31.5 GiB (INT4) or 84.0 GiB (bf16). On the card's host /proc has no
# VmHWM and a child's resident set follows the sandbox's (its VmRSS at its
# start is its parent's), so the first bound is loose there; the
# MemAvailable drop is the tight one.
MIXTRAL_RSS_MARGIN = 2 << 30
# The served prefill logits (bf16 activations, bf16 or INT4 experts), the
# kernel run against the plain run on the same store. A fixed limit of 4e-2
# (deepseek's, written before the first run) failed on the INT4 path at
# 0.0531 (H100 80GB HBM3, 700 W): at C = 2 three of every four routed
# experts run through the INT4 spillover, whose plain version multiplies in
# fp32 where the kernel rounds each product to bf16, through 32 random
# layers. The limit is therefore the path's own bf16 round-off, measured
# in the same run at full depth: the plain run in fp32 activations on the
# same INT4 codes (the codes do not depend on the activation type, and the
# other weights are the fp32 draws that the bf16 ones round) is the
# reference; the plain bf16 run lies r from it. The INT4 kernel run must lie
# within ACCURACY_RATIO x r of it (a second rounding inside a kernel would
# exceed that), and each path's kernel run within (1 + ACCURACY_RATIO) x r
# of its plain run, what two runs that near the reference can be apart
# (the bf16 experts' path has no fp32 store at full depth: 168 GiB; it is
# held to the same architecture's r). The kernels' arithmetic is held
# first in fp32 at full width on MIXTRAL_FP32_LAYERS layers to
# FP32_LOGITS_REL_TOL, where only the order of sums differs.
MIXTRAL_ROUNDOFF_SPAN = 1 + ACCURACY_RATIO
# (c) the offloaded wave server from the command line, at the bf16 row's
# depth: bench_serve --offloaded, its experts drawn into the pinned store,
# the oracle scores streamed one staged MoE layer at a time, 2 requests of
# 64-128 prompt tokens and 4-8 new tokens in one wave, at C = 2. (4
# requests in waves of 2 took 40.8 s of a 1124.5 s chip_smoke run on a
# slow host, H100 80GB HBM3, 700 W; two fewer requests save about 8 s.)
MIXTRAL_BENCH_REQUESTS = 2
MIXTRAL_BENCH = ["--dtype", "bfloat16", "--offloaded",
                 "--scheduler", "expert-affinity", "--n-requests",
                 str(MIXTRAL_BENCH_REQUESTS), "--slots", "2", "--prompt-len", "128",
                 "--max-new", "8", "--arrival", "all_at_once"]
# What (c) may hold on the card beside the weights it must: the non-expert
# weights, the slabs (C experts a layer) and one staged layer of experts
# (the oracle's; the served prefill's overflow group, at most E - C = 6
# experts a layer, is smaller), plus this for activations, KV caches and
# logits of one request at a time (a 128-token prefill's are tens of MB).
MIXTRAL_BENCH_ACT_BYTES = 1 << 30
# (d) Mixtral cut to this many layers at full width, from a checkpoint:
# the oracle on the whole tree against the streamed one, save_checkpoint,
# serve.run(ckpt=) against serve.run() from the seed, bench_serve --ckpt.
MIXTRAL_CKPT_LAYERS = 2
MIXTRAL_CKPT_NEW = 4
# (b) also serves its batch with Psi on the kept store (``run(predictor=True,
# host_store=)``): PSI_TRAIN_PROMPTS prompts traced PSI_TRACE_NEW tokens
# each, every forward pass staging each MoE layer from the store. The
# trace's peak device memory must stay below the non-expert weights, one
# staged layer and the activations of the trace's prefill
# (``_mixtral_trace_act_bytes``); the whole model is 93.4 GB.
# the three children together ((a) ~55 s, (b) ~63 s + ~70 s for Psi, (c)
# then (d) ~90 s, each besides its start-up and the waits for MemAvailable
# to settle; 261.1 s for the phase before Psi on a slow host, H100 80GB
# HBM3, 700 W); a guard against a hang, inside the whole run's 1200 s
MIXTRAL_LIMIT_S = 600
# (e) the paper's comparison systems (core/baselines.py, Fig. 3), each built
# as the reference builds it, make_engine(cfg, params, BASELINES[name],
# capacity=C), on a child's kept store, with the other weights re-drawn
# from the seed (experts on meta): the six bf16 systems in the bf16 child
# after (b), melinoe prefetching (b)'s own Psi scores; quant_cache (INT4
# residents at 3C = 6) in the INT4 child on its INT4 store (84.0 + 31.5 GiB
# of stores do not fit the host together). Each serves phase 23's prompts,
# MIXTRAL_BASELINE_NEW new tokens, counters and the peak device memory
# from 0, its engine freed before the next.
MIXTRAL_BASELINE_NEW = 8
MIXTRAL_BF16_SYSTEMS = ("static_lru", "static_lfu", "stream_all", "profile_prefetch",
                        "cpu_execute", "melinoe")
MIXTRAL_INT4_SYSTEMS = ("quant_cache",)
# What (e) may take from the host's MemAvailable across a child's rows (the
# re-drawn params' host side, the engines' bookkeeping): a second host copy
# of any expert would take 352 MB (bf16) a matrix set
MIXTRAL_BASELINE_HOST_BYTES = 1 << 30
# What a row may hold on the card beside the non-expert weights, its slab
# and one layer's overflow group (all E experts of a layer): activations,
# KV caches, logits
MIXTRAL_BASELINE_ACT_BYTES = 1 << 30


def _mixtral_trace_act_bytes(cfg, layers: int) -> dict:
    """What the routing trace's prefill (PSI_TRAIN_PROMPTS x prompt_len
    tokens, bf16, ``cfg`` cut to ``layers``) may hold on the card beside the
    non-expert weights and the staged layer, by part: the logits of every
    position in fp32 and the bf16 product they are cast from; the KV
    caches of prompt_len + PSI_TRACE_NEW slots a layer and their stack
    (``model._stack``); one MoE layer's dispatched rows (the (E + 1, n, d)
    buffer, three (E, n, d_ff) products alive at once in ``expert_ffn``, the
    combine's repeated, gathered and fp32 rows); the prompt embedder's fp32
    table."""
    from repro_torch.core.predictor import D_EMB

    spec = cfg.moe_spec
    (attn,) = {b.attn for b in cfg.block_defs.values()}
    B, T = PSI_TRAIN_PROMPTS, OFFLOAD_SERVE["prompt_len"]
    n, E, d, f = B * T, spec.num_experts, cfg.d_model, spec.d_ff
    return {"logits": n * cfg.vocab * (4 + 2),
            "kv": 2 * 2 * layers * B * (T + PSI_TRACE_NEW) * attn.n_kv_heads
            * attn.head_dim * 2,
            "moe": ((E + 1) * n * d + 3 * E * n * f) * 2 + n * spec.top_k * d * (2 + 2 + 4),
            "embedder": cfg.vocab * D_EMB * 4}


def mixtral_baselines(store, names, psi_scores=None, arch: str = MIXTRAL,
                      device: str = "cuda", dtype=torch.bfloat16,
                      batch: int = OFFLOAD_SERVE["batch"],
                      prompt_len: int = OFFLOAD_SERVE["prompt_len"],
                      new: int = MIXTRAL_BASELINE_NEW) -> dict:
    """Phase 23(e) on one kept store (``run(keep_store=True)``'s
    ``host_store``, bf16 or INT4): ``arch``'s other weights re-drawn from
    OFFLOAD_SERVE's seed with the experts on ``meta`` (``init_params``
    draws the same stream whether or not a store is given, so these are
    the weights the store was drawn with), then each system of ``names``
    built by ``make_engine(cfg, params, BASELINES[name], capacity=C,
    host_store=store, device=)`` and serving ``batch`` x (``prompt_len`` +
    ``new``) tokens of ``make_prompts`` (``melinoe`` prefetching
    ``psi_scores`` first), counters and the peak device memory from 0, each
    engine freed (and the allocator's cache emptied) before the next.
    Returns the rows (``_serve_row``'s numbers, ``slab_bytes``, the build's
    seconds, launches by phase and route), each row's tokens and prefill
    logits, and the host's MemAvailable before and after."""
    from repro_torch.configs import get_config
    from repro_torch.core.baselines import BASELINES, make_engine
    from repro_torch.core.offload_engine import HardwareProfile
    from repro_torch.launch.serve import host_available_bytes, make_prompts
    from repro_torch.models.model import init_params

    t0 = time.perf_counter()
    cfg = get_config(arch)
    dev = torch.device(device)
    avail0 = host_available_bytes()
    params = init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(OFFLOAD_SERVE["seed"]),
        dtype=dtype, device=dev, expert_device="meta")
    prompts = make_prompts(cfg.vocab, batch, prompt_len)
    rows, tokens, logits = {}, {}, {}
    for name in names:
        spec = BASELINES[name]
        t = time.perf_counter()
        eng = make_engine(cfg, params, spec, capacity=cfg.melinoe_cache_capacity(),
                          hw=HardwareProfile(), device=dev, host_store=store)
        if spec.use_predictor:
            eng.prefetch(psi_scores)
        build_s = time.perf_counter() - t
        res, row = _serve_row(eng, prompts, dev, max_new=new)
        row.update(layers=cfg.n_layers, build_s=build_s, host_time_s=res["metrics"].host_time,
                   quantized=spec.quantized)
        tokens[name] = res["tokens"].cpu().numpy()
        logits[name] = res["prefill_logits"].float().cpu()
        rows[name] = row
        del eng, res
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    del params
    gc.collect()
    return {"layers": cfg.n_layers, "batch": batch, "prompt_len": prompt_len, "new": new,
            "rows": rows, "tokens": tokens, "logits": logits,
            "host_available_before": avail0, "host_available_after": host_available_bytes(),
            "secs": time.perf_counter() - t0}


def _child_start(device: str) -> torch.device:
    """A phase-23 child's start: fp32 products in fp32, the CUDA context and
    the kernel library loaded (built by the parent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        _build.lib()
    return dev


def _offload_child(rank: int, kind: str, layers: int, out: str, arch: str,
                   device: str, fp32_layers: int, extras: bool = True) -> None:
    """One store of phase 23 or 24 in a process of its own:
    ``launch.serve.run`` of ``arch`` cut to ``layers`` with ``kind``
    ("int4" or "bf16") experts at the config's C, counters from 0, then the
    plain run on the same store (``max_new`` 1); for "int4" also the plain
    run in fp32 activations on the same codes, and the fp32 kernel-vs-plain
    prefill at full width on ``fp32_layers`` layers. With ``extras`` (phase
    23): for "bf16" the batch served again with Psi on the same store
    (``run(predictor=True, host_store=)``, counters from 0); then (e),
    ``mixtral_baselines`` on the same store: quant_cache for "int4", the six
    bf16 systems for "bf16". Writes the reports, launches, logits and the
    seconds of each step to ``out`` (``torch.save``)."""
    t0 = time.perf_counter()
    dev = _child_start(device)
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import max_rss_bytes, run

    kw = dict(OFFLOAD_SERVE, dtype=torch.bfloat16, device=device)
    q = kind == "int4"
    name = _cut_arch(arch, layers)
    secs = {"start": time.perf_counter() - t0}
    baseline = max_rss_bytes()
    dispatch.reset_launches()
    t = time.perf_counter()
    rep = run(name, max_new=OFFLOAD_NEW, quantized=q, keep_store=True, **kw)
    secs["serve"] = time.perf_counter() - t
    launches = dict(dispatch.LAUNCHES)
    routes = {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}
    store = rep.pop("host_store")
    rep.pop("quantized_experts", None)
    t = time.perf_counter()
    ref = run(name, max_new=1, kernel_backend="ref", quantized=q, host_store=store, **kw)
    secs["plain"] = time.perf_counter() - t
    res = {"kind": kind, "layers": layers, "rep": rep, "baseline_rss": baseline,
           "launches": launches, "routes": routes, "plain_logits": ref["prefill_logits"]}
    if q:  # the plain run in fp32 activations on the same codes
        t = time.perf_counter()
        ref32 = run(name, max_new=1, kernel_backend="ref", quantized=True, host_store=store,
                    **dict(kw, dtype=torch.float32))
        res["plain_fp32_logits"] = ref32["prefill_logits"]
        secs["plain_fp32"] = time.perf_counter() - t
        del ref32
        gc.collect()
        if extras:  # (e) quant_cache on this child's INT4 store
            res["baselines"] = mixtral_baselines(store, MIXTRAL_INT4_SYSTEMS, arch=name,
                                                 device=device)
            secs["baselines"] = res["baselines"]["secs"]
    elif extras:  # Psi, traced from this store (no second store is built)
        gc.collect()  # the earlier runs' engines and their slabs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dispatch.reset_launches()
        t = time.perf_counter()
        psi = run(name, max_new=OFFLOAD_NEW, predictor=True, n_train_prompts=PSI_TRAIN_PROMPTS,
                  host_store=store, **kw)
        secs["predictor"] = time.perf_counter() - t
        res["predictor"] = {
            "rep": {k: psi[k] for k in (
                "predictor_kl", "trace_s", "trace_max_memory_allocated", "predictor_train_s",
                "transfers", "prefetch_transfers", "hit_rate", "modeled_time_s",
                "prefill_s", "decode_tok_s", "max_memory_allocated", "host_store_bytes",
                "host_available_before_build", "host_available_after_build",
                "route_launches")},
            "tokens_equal": bool(np.array_equal(psi["tokens"], rep["tokens"])),
            "launches": dict(dispatch.LAUNCHES),
            "routes": {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES}}
        scores = psi["predictor_scores"]
        del psi
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # (e) the six bf16 systems on this store, melinoe on (b)'s scores
        res["baselines"] = mixtral_baselines(store, MIXTRAL_BF16_SYSTEMS, psi_scores=scores,
                                             arch=name, device=device)
        secs["baselines"] = res["baselines"]["secs"]
    del store, ref
    gc.collect()
    if q:  # the fp32 check at full width on a few layers
        t = time.perf_counter()
        short = _cut_arch(arch, fp32_layers)
        kw32 = dict(kw, dtype=torch.float32)
        k = run(short, max_new=1, keep_store=True, **kw32)
        st = k.pop("host_store")
        p = run(short, max_new=1, kernel_backend="ref", host_store=st, **kw32)
        res["fp32_short"] = (k["prefill_logits"], p["prefill_logits"])
        del st, k, p
        gc.collect()
        secs["fp32_short"] = time.perf_counter() - t
    secs["child"] = time.perf_counter() - t0
    res["secs"] = secs
    torch.save(res, out)


class _Tee:
    """A text stream that writes to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self) -> None:
        for st in self.streams:
            st.flush()


def _bench_serve(argv) -> tuple:
    """``bench_serve.main(argv)``, its standard error passed through and
    read: (what it returns, its offloaded build report, the
    ``BUILD_LINE`` JSON)."""
    import contextlib
    import io

    from repro_torch.launch import bench_serve

    buf = io.StringIO()
    with contextlib.redirect_stderr(_Tee(sys.stderr, buf)):
        ret = bench_serve.main(argv)
    line = next(ln for ln in buf.getvalue().splitlines()
                if ln.startswith(bench_serve.BUILD_LINE))
    return ret, json.loads(line[len(bench_serve.BUILD_LINE):])


def _mixtral_bench_child(rank: int, kind: str, layers: int, out: str, arch: str,
                         device: str, fp32_layers: int) -> None:
    """Phase 23 (c) and (d) in a process of their own: ``bench_serve
    --offloaded`` (MIXTRAL_BENCH) of ``arch`` cut to ``layers``, counters
    and the peak device memory from 0; then, its store gone,
    ``_mixtral_ckpt`` at MIXTRAL_CKPT_LAYERS layers. Writes (c)'s summary,
    the launcher's build report, the launches and the seconds, and (d)'s
    readings, to ``out``."""
    t0 = time.perf_counter()
    dev = _child_start(device)
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch

    name = _cut_arch(arch, layers)
    secs = {"start": time.perf_counter() - t0}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dispatch.reset_launches()
    t = time.perf_counter()
    (results, mt), build = _bench_serve(["--arch", name, "--device", device, *MIXTRAL_BENCH])
    secs["bench"] = time.perf_counter() - t
    bench = {"kind": kind, "layers": layers, "summary": mt.summary(),
             "finished": [(r.rid, len(r.tokens), r.finish_reason) for r in results],
             "build": build, "launches": dict(dispatch.LAUNCHES),
             "routes": {op: dict(dispatch.ROUTE_LAUNCHES[op]) for op in FAST_ROUTES},
             "secs": secs}
    del results, mt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ckpt = _mixtral_ckpt(dev, device, arch,
                         min(MIXTRAL_CKPT_LAYERS, get_config(arch).n_layers))
    secs["child"] = time.perf_counter() - t0
    torch.save({"bench": bench, "ckpt": ckpt}, out)


def _mixtral_ckpt(dev, device: str, arch: str, layers: int) -> dict:
    """Phase 23 (d), ``arch`` cut to ``layers`` at full width in bf16: the
    seeded draw whole on the device and its oracle scores and Psi's
    routing trace (PSI_TRAIN_PROMPTS prompts, PSI_TRACE_NEW tokens) against
    the streamed ones (the same seed drawn into a store, one staged layer
    at a time); ``save_checkpoint`` of that tree; ``serve.run(ckpt=)`` against
    ``serve.run()`` from the seed; and ``bench_serve --offloaded --ckpt``
    from the file. Returns the readings."""
    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    from repro_torch.inference import routing_trace
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params
    from repro_torch.models.runtime import Runtime
    from repro_torch.serving import ServeRequest, prefill_expert_scores
    from repro_torch.training import save_checkpoint

    name = _cut_arch(arch, layers)
    cfg = get_config(name)
    dt = torch.bfloat16
    secs = {}
    prompts = serve.make_prompts(cfg.vocab, OFFLOAD_SERVE["batch"], OFFLOAD_SERVE["prompt_len"])

    def requests():
        return [ServeRequest(rid=i, prompt=p, max_new_tokens=1) for i, p in enumerate(prompts)]

    t = time.perf_counter()
    whole = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), dtype=dt,
                        device=dev)
    want = prefill_expert_scores(cfg, whole, requests())
    _sync(dev)
    secs["whole_oracle"] = time.perf_counter() - t
    t = time.perf_counter()
    params, store, _ = serve.offloaded_params(cfg, dtype=dt, device=dev)
    secs["store"] = time.perf_counter() - t
    t = time.perf_counter()
    got = prefill_expert_scores(cfg, params, requests(), host_store=store)
    _sync(dev)
    secs["streamed_oracle"] = time.perf_counter() - t
    res = {"kind": "ckpt", "layers": layers,
           "scores_equal": all(np.array_equal(g, w) for g, w in zip(got, want)),
           "scores_max_abs": max(float(np.abs(g - w).max()) for g, w in zip(got, want)),
           "scores_shape": [tuple(g.shape) for g in got]}
    # Psi's routing trace, the whole tree against the store's staged layers
    B = OFFLOAD_SERVE["batch"]
    train = serve.make_prompts(cfg.vocab, B + PSI_TRAIN_PROMPTS,
                               OFFLOAD_SERVE["prompt_len"])[B:]
    rt = Runtime(device=dev, zero_drop=True)
    t = time.perf_counter()
    wt, wp = routing_trace(cfg, whole, train, max_new=PSI_TRACE_NEW, rt=rt)
    _sync(dev)
    secs["whole_trace"] = time.perf_counter() - t
    t = time.perf_counter()
    st, sp = routing_trace(cfg, params, train, max_new=PSI_TRACE_NEW, rt=rt, host_store=store)
    _sync(dev)
    secs["streamed_trace"] = time.perf_counter() - t
    res.update(trace_equal=bool(np.array_equal(st, wt) and np.array_equal(sp, wp)),
               trace_probs_max_abs=float(np.abs(sp - wp).max()),
               trace_shape=tuple(sp.shape))
    del params, store, got, wp, sp
    gc.collect()
    kw = dict(OFFLOAD_SERVE, dtype=dt, device=device)
    with tempfile.TemporaryDirectory() as d:
        usage = shutil.disk_usage(d)
        print(f"mixtral checkpoint: {d} holds {usage.free / 2**30:.1f} GiB free of "
              f"{usage.total / 2**30:.1f} GiB", flush=True)
        path = Path(d) / f"{name}.ckpt"
        t = time.perf_counter()
        save_checkpoint(path, whole)
        secs["save"] = time.perf_counter() - t
        res["ckpt_bytes"] = path.stat().st_size
        del whole
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # each build starts once the host's memory has settled (the save's
        # buffers and the last store given back), so that its MemAvailable
        # drop is its own
        _settled_available_gib(10.0)
        t = time.perf_counter()
        ck = serve.run(name, ckpt=str(path), max_new=MIXTRAL_CKPT_NEW, **kw)
        secs["run_ckpt"] = time.perf_counter() - t
        gc.collect()
        _settled_available_gib(10.0)
        t = time.perf_counter()
        sd = serve.run(name, max_new=MIXTRAL_CKPT_NEW, **kw)
        secs["run_seed"] = time.perf_counter() - t
        gc.collect()
        _settled_available_gib(10.0)
        t = time.perf_counter()
        (results, mt), build = _bench_serve(["--arch", name, "--device", device,
                                             *MIXTRAL_BENCH, "--ckpt", str(path)])
        secs["bench_ckpt"] = time.perf_counter() - t
    keys = ("transfers", "hits", "misses", "prefetch_transfers", "host_store_bytes",
            "host_available_before_build", "host_available_after_build", "build_s",
            "prefill_s", "decode_tok_s")
    res.update(run_ckpt={k: ck[k] for k in keys}, run_seed={k: sd[k] for k in keys},
               tokens_equal=bool(np.array_equal(ck["tokens"], sd["tokens"])),
               bench_summary=mt.summary(),
               bench_finished=[(r.rid, len(r.tokens), r.finish_reason) for r in results],
               bench_build=build)
    secs["all"] = time.perf_counter() - t0
    res["secs"] = secs
    return res


def _offload_spawn(kind: str, layers: int, d: str, arch: str, device: str,
                   fp32_layers: int, deadline: float, extras: bool = True) -> dict:
    """Runs one child of phase 23 or 24 (``_offload_child``, or for
    "bench" ``_mixtral_bench_child``) in a spawned process, waits for it
    until ``deadline`` (``time.perf_counter``), kills it past that, and
    returns what it wrote."""
    out = str(Path(d, f"{arch}-{kind}.pt"))
    fn = _mixtral_bench_child if kind == "bench" else functools.partial(
        _offload_child, extras=extras)
    ctx = torch.multiprocessing.start_processes(
        fn, args=(kind, layers, out, arch, device, fp32_layers),
        nprocs=1, join=False, start_method="spawn")
    t0 = time.perf_counter()
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{arch} {kind} child: still running at the phase's "
                                   "deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    res = torch.load(out, weights_only=False)
    res["spawn_s"] = time.perf_counter() - t0  # start-up and exit included
    return res


def _settled_available_gib(limit_s: float = 30.0) -> float:
    """The host's MemAvailable once it stops rising (a child's pinned
    store goes back to the host after the child has exited): read every
    0.5 s until two reads lie within 0.25 GiB, at most ``limit_s``."""
    t_end = time.perf_counter() + limit_s
    prev = _host_available_gib()
    while time.perf_counter() < t_end:
        time.sleep(0.5)
        cur = _host_available_gib()
        if abs(cur - prev) < 0.25:
            return cur
        prev = cur
    return prev


def _offload_depth(label: str, what: str, avail: float, layers: int, layer_gib: float) -> int:
    """The depth a bf16 store of ``layer_gib`` GiB a layer may take: all
    ``layers`` where ``avail`` GiB of MemAvailable holds them plus
    MIXTRAL_HOST_HEADROOM_GIB, else the deepest that does (printed as a
    cut)."""
    if avail >= layers * layer_gib + MIXTRAL_HOST_HEADROOM_GIB:
        print(f"{label} {what}: host memory available {avail:.1f} GiB: {layers} layers")
        return layers
    cut = int((avail - MIXTRAL_HOST_HEADROOM_GIB) // layer_gib)
    print(f"{label} {what}: host memory available {avail:.1f} GiB < {layers * layer_gib:.1f} "
          f"GiB of experts + {MIXTRAL_HOST_HEADROOM_GIB} GiB: CUT to {cut} of {layers} layers")
    if cut < 1:
        raise AssertionError(f"{label} {what}: {avail:.1f} GiB of host memory holds no layer")
    return cut


def _offload_pair(label: str, arch: str, d: str, device: str, fp32_layers: int,
                  deadline: float, extras: bool) -> dict:
    """Phase 23's or 24's first two children: INT4 at full depth, then,
    once the host's MemAvailable has settled, bf16 at the depth it allows
    (``_offload_depth``). Returns both children's results by kind."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    spec = cfg.moe_spec
    layer_gib = spec.num_experts * 3 * cfg.d_model * spec.d_ff * 2 / 2**30
    print(f"{label} phase: host memory available {_host_available_gib():.1f} GiB")
    rows = {"int4": _offload_spawn("int4", cfg.n_layers, d, arch, device, fp32_layers,
                                   deadline, extras)}
    layers = _offload_depth(label, "bf16", _settled_available_gib(), cfg.n_layers, layer_gib)
    rows["bf16"] = _offload_spawn("bf16", layers, d, arch, device, fp32_layers, deadline,
                                  extras)
    return rows


def mixtral_phase(arch: str = MIXTRAL, device: str = "cuda",
                  fp32_layers: int = MIXTRAL_FP32_LAYERS) -> dict:
    """Phase 23 (see MIXTRAL): full-width Mixtral-8x7B offloaded, INT4 at
    full depth, then bf16 at the depth the host's memory allows; each
    store drawn into by ``launch.serve.run`` in a child process
    (``_offload_pair``); then (c) ``bench_serve --offloaded`` at the bf16
    row's depth and (d) a checkpoint at MIXTRAL_CKPT_LAYERS layers,
    together in a third child; (e) the comparison systems inside the first
    two children (``mixtral_baselines``, gated by
    ``_mixtral_baselines_rows``). Every row is printed first, then gated:
    (a) as ``_offload_rows`` gates it, (b) to (e) as ``_mixtral_psi_row``,
    ``_mixtral_bench_row``, ``_mixtral_ckpt_row`` and
    ``_mixtral_baselines_rows`` do. ``arch``/``device``: a smaller model or
    the CPU, to rehearse the phase's logic."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    deadline = t_phase + MIXTRAL_LIMIT_S
    cfg = get_config(arch)
    spec = cfg.moe_spec
    layer_gib = spec.num_experts * 3 * cfg.d_model * spec.d_ff * 2 / 2**30
    with tempfile.TemporaryDirectory() as d:
        rows = _offload_pair("mixtral", arch, d, device, fp32_layers, deadline, extras=True)
        # (c) the wave server from the command line, at the bf16 row's depth
        bench_layers = _offload_depth("mixtral", "bench_serve", _settled_available_gib(),
                                      rows["bf16"]["layers"], layer_gib)
        # then (d), a checkpoint of Mixtral cut to MIXTRAL_CKPT_LAYERS layers,
        # in the same child (which waits for MemAvailable to settle before
        # each of (d)'s builds)
        both = _offload_spawn("bench", bench_layers, d, arch, device, fp32_layers, deadline)
        bench, ckpt = both["bench"], both["ckpt"]
    print(f"mixtral children: seconds from spawn to exit "
          f"{ {k: round(r['spawn_s'], 1) for k, r in (*rows.items(), ('bench', both))} }")
    bad = []
    out, roundoff = _offload_rows("mixtral", rows, cfg, device, fp32_layers, bad)
    out["predictor"] = _mixtral_psi_row(rows["bf16"], cfg, device, bad)
    out["bench"] = _mixtral_bench_row(bench, cfg, device, bad)
    out["ckpt"] = _mixtral_ckpt_row(ckpt, cfg, bad)
    out["baselines"] = _mixtral_baselines_rows(rows["bf16"], rows["int4"], cfg, device, bad,
                                               roundoff)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"mixtral phase: {out['phase_s']:.1f} s")
    if bad:
        raise AssertionError("mixtral phase: " + "; ".join(bad))
    return out


def _offload_rows(label: str, rows: dict, cfg, device: str, fp32_layers: int, bad: list,
                  peak_gate: bool = False) -> tuple:
    """The rows of phase 23(a) or 24 (``rows``: ``_offload_child``'s INT4
    and bf16 results; ``cfg`` the full config), printed, then gated into
    ``bad``: launch totals (``flash_attn`` one "tc" a layer in the prefill;
    ``moe_gmm`` and ``int4_matmul`` positive multiples of 3, ``moe_gmm``
    "tc" in the prefill and "stream" in decode, ``int4_matmul`` by
    INT4_PHASE_ROUTES), the prefill logits (see MIXTRAL_ROUNDOFF_SPAN), the
    fp32 check on ``fp32_layers`` layers (FP32_LOGITS_REL_TOL), the build's
    host memory against the store (MIXTRAL_RSS_MARGIN) and, with
    ``peak_gate`` (phase 24), the peak device memory within the non-expert
    weights + the slabs + one layer's overflow group (its E - C experts) +
    OFFLOAD_ACT_BYTES. Returns the rows by kind (and the logits checks) and
    the plain path's bf16 round-off r."""
    C = cfg.melinoe_cache_capacity()
    i4 = rows["int4"]
    fp32_ref = i4["plain_fp32_logits"]
    roundoff = _rel(i4["plain_logits"], fp32_ref)
    k32, p32 = i4["fp32_short"]
    checks = {"fp32_short_kernel_vs_plain": _rel(k32, p32),
              "int4_plain_bf16_vs_fp32": roundoff,
              "int4_kernel_bf16_vs_fp32": None}
    out = {}
    gib = lambda b: f"{b / 2**30:.2f} GiB" if b is not None else "n/a"  # noqa: E731
    for kind, r in rows.items():
        rep, q, n = r["rep"], kind == "int4", r["layers"]
        path = f"{label}-{kind}"
        PATH_LAUNCHES[path] = {"moe_gmm": None, "flash_attn": n,
                               "int4_matmul": None if q else 0}
        by_phase = rep["route_launches"]
        tokens, logits = rep.pop("tokens"), rep.pop("prefill_logits")
        rel = _rel(logits, r["plain_logits"])
        if q:
            checks["int4_kernel_bf16_vs_fp32"] = _rel(logits, fp32_ref)
        top1 = (logits.argmax(-1) == r["plain_logits"].argmax(-1)).float().mean().item()
        rss = rep["max_rss_after_build"] - r["baseline_rss"]
        drop = rep["host_available_before_build"] - rep["host_available_after_build"]
        steps = max(rep["max_new"] - 1, 1)
        size = _offload_bytes(cfg, n)
        peak_bound = size["nonexpert"] + rep["slab_bytes"] + size["overflow"] \
            + OFFLOAD_ACT_BYTES
        row = {k: rep[k] for k in (
            "capacity", "transfers", "transfer_bytes", "hit_rate", "modeled_time_s",
            "modeled_time_overlapped_s", "decode_tok_s", "prefill_s", "quantize_s",
            "build_s", "max_memory_allocated", "slab_bytes", "host_store_bytes",
            "host_available_before_build", "host_available_after_build", "expert_copies")}
        row.update(layers=n, logits_rel=rel, top1=top1, build_rss_bytes=rss,
                   baseline_rss_bytes=r["baseline_rss"], host_available_drop_bytes=drop,
                   rss_margin=MIXTRAL_RSS_MARGIN, secs=r["secs"],
                   copies_per_decode_step=rep["expert_copies"]["decode"] / steps,
                   memory_bound_bytes=peak_bound, nonexpert_bytes=size["nonexpert"],
                   whole_model_bytes=size["whole"],
                   launches_total=r["launches"], route_launches=r["routes"],
                   route_launches_by_phase=by_phase)
        print(f"{path} ({n} layers, C = {rep['capacity']}): transfers {row['transfers']}, "
              f"hit rate {row['hit_rate']:.3f}, modeled {row['modeled_time_s']:.3f} s serial / "
              f"{row['modeled_time_overlapped_s']:.3f} s overlapped; prefill "
              f"{row['prefill_s']:.3f} s, decode {row['decode_tok_s']:.2f} tok/s, "
              f"{row['copies_per_decode_step']:.1f} moe.fetch copies a decode step; store "
              f"{gib(row['host_store_bytes'])} built in {row['build_s']:.1f} s (quantize "
              f"{row['quantize_s']:.1f} s); host MemAvailable "
              f"{gib(row['host_available_before_build'])} before, "
              f"{gib(row['host_available_after_build'])} after (-{gib(drop)}); resident-set "
              f"high-water +{gib(rss)} over the child's {gib(r['baseline_rss'])} (limits "
              f"store + {gib(MIXTRAL_RSS_MARGIN)}); peak "
              f"device {gib(row['max_memory_allocated'])} beside slabs "
              f"{gib(row['slab_bytes'])} (bound {gib(peak_bound)}); logits vs plain rel "
              f"{rel:.4g} (limit {MIXTRAL_ROUNDOFF_SPAN} x {roundoff:.4g}), top-1 {top1:.2f}; "
              f"child seconds { {k: round(v, 1) for k, v in r['secs'].items()} }")
        print(f"{path}: launches {r['launches']}, by phase {by_phase}")
        if device == "cuda":
            try:
                check_path(path, r["launches"], r["routes"])
            except AssertionError as e:
                bad.append(str(e))
            want = {"prefill": {"moe_gmm": {"tc"}, "flash_attn": {"tc"}},
                    "decode": {"moe_gmm": {"stream"}, "flash_attn": set()}}
            got = {ph: {op: set(by_phase[ph][op]) for op in ("moe_gmm", "flash_attn")}
                   for ph in want}
            if got != want or by_phase["prefill"]["flash_attn"].get("tc") != n:
                bad.append(f"{path}: launches by phase {by_phase}, want routes {want} and "
                           f"{n} flash_attn a prefill")
            i4_phase = {ph: by_phase[ph]["int4_matmul"] for ph in by_phase}
            if q and any(set(v) - set(INT4_PHASE_ROUTES[ph]) or sum(v.values()) % 3
                         for ph, v in i4_phase.items()):
                bad.append(f"{path}: int4_matmul by phase {i4_phase}, want "
                           f"{INT4_PHASE_ROUTES}, multiples of 3")
        if (tokens.shape != (OFFLOAD_SERVE["batch"], OFFLOAD_NEW)
                or logits.shape != (OFFLOAD_SERVE["batch"], cfg.vocab)
                or not torch.isfinite(logits).all()):
            bad.append(f"{path}: tokens {tokens.shape} logits {logits.shape}")
        if rep["capacity"] != C:
            bad.append(f"{path}: served at C = {rep['capacity']}, want the config's {C}")
        for what, b in (("resident-set high-water mark", rss), ("MemAvailable drop", drop)):
            if not b <= rep["host_store_bytes"] + MIXTRAL_RSS_MARGIN:
                bad.append(f"{path}: the build's {what} {b} B, over the store's "
                           f"{rep['host_store_bytes']} B + {MIXTRAL_RSS_MARGIN}")
        if not (math.isfinite(rel) and rel <= MIXTRAL_ROUNDOFF_SPAN * roundoff):
            bad.append(f"{path}: prefill logits kernel vs plain rel {rel}, over "
                       f"{MIXTRAL_ROUNDOFF_SPAN} x the plain path's round-off {roundoff}")
        peak = row["max_memory_allocated"]
        if peak_gate and peak is not None and not peak <= min(peak_bound, size["whole"]):
            bad.append(f"{path}: peak device memory {peak} B, over the non-expert weights + "
                       f"slabs + one layer's overflow group + {OFFLOAD_ACT_BYTES} B = "
                       f"{peak_bound} B (whole model {size['whole']} B)")
        out[kind] = row
    print(f"{label} prefill logits: {checks} (fp32 on {fp32_layers} layers tol "
          f"{FP32_LOGITS_REL_TOL}; INT4 kernel vs the fp32 plain run tol {ACCURACY_RATIO} x "
          f"the plain bf16 run's)")
    if not checks["fp32_short_kernel_vs_plain"] <= FP32_LOGITS_REL_TOL:
        bad.append(f"{label}: fp32 prefill logits disagree: {checks}")
    if not checks["int4_kernel_bf16_vs_fp32"] <= ACCURACY_RATIO * roundoff:
        bad.append(f"{label}-int4: the kernel run lies farther from the fp32 plain run "
                   f"than {ACCURACY_RATIO} x the plain bf16 run: {checks}")
    out["checks"] = checks
    return out, roundoff


def _offload_bytes(cfg, layers: int) -> dict:
    """Bytes of ``cfg`` cut to ``layers`` in bf16: one MoE layer's experts,
    the non-expert weights (the router fp32), the whole model's, the slabs
    at the config's C and one layer's overflow group (its E - C other
    experts)."""
    from repro_torch.models.model import param_shapes
    from repro_torch.training.checkpoint import tree_leaves

    spec = cfg.moe_spec
    C = cfg.melinoe_cache_capacity()
    layer = spec.num_experts * 3 * cfg.d_model * spec.d_ff * 2
    cut = dataclasses.replace(cfg, layout=(dataclasses.replace(
        cfg.layout[0], repeats=layers // len(cfg.layout[0].pattern)),))
    total = sum(t.numel() * t.element_size()
                for t in tree_leaves(param_shapes(cut, torch.bfloat16)))
    return {"layer": layer, "nonexpert": total - layers * layer, "whole": total,
            "slabs": layers * C * layer // spec.num_experts,
            "overflow": (spec.num_experts - C) * layer // spec.num_experts}


def _mixtral_bench_row(r: dict, cfg, device: str, bad: list) -> dict:
    """Phase 23 (c)'s row, printed, then gated into ``bad``."""
    n, b, summ = r["layers"], r["build"], r["summary"]
    size = _offload_bytes(cfg, n)
    bound = size["nonexpert"] + size["slabs"] + size["layer"] + MIXTRAL_BENCH_ACT_BYTES
    drop = b["host_available_before_build"] - b["host_available_after_build"] \
        if b["host_available_before_build"] is not None else None
    served = b["served_launches"]
    row = {"layers": n, "requests": summ["requests"], "finished": r["finished"],
           "transfers": summ["transfers"], "prefetch_transfers": summ["prefetch_transfers"],
           "hit_rate": summ["cache_hit_rate"],
           "modeled_time_serial_s": summ["modeled_time_serial_s"],
           "modeled_time_overlapped_s": summ["modeled_time_overlapped_s"],
           "build_s": b["build_s"], "score_s": b["score_s"],
           "host_store_bytes": b["host_store_bytes"], "host_available_drop_bytes": drop,
           "drop_limit_bytes": b["host_store_bytes"] + size["layer"] + MIXTRAL_RSS_MARGIN,
           "max_memory_allocated": b["max_memory_allocated"], "memory_bound_bytes": bound,
           "whole_model_bytes": size["whole"], "score_launches": b["score_launches"],
           "served_launches": served, "launches_total": r["launches"],
           "route_launches": r["routes"], "secs": r["secs"],
           "prefill_s": b["prefill_s"], "decode_steps": b["decode_steps"],
           "decode_tok_s": b["decode_steps"] / b["decode_s"] if b["decode_s"] > 0 else None,
           "expert_copies": b["expert_copies"],
           "copies_per_decode_step": b["expert_copies"]["decode"] / max(b["decode_steps"], 1)}
    print("mixtral bench_serve --offloaded:", json.dumps(row))
    want_flash = {"tc": MIXTRAL_BENCH_REQUESTS * n}
    if not (summ["requests"] == len(r["finished"]) == MIXTRAL_BENCH_REQUESTS
            and summ["transfers"] > 0 and 0 < summ["cache_hit_rate"] < 1):
        bad.append(f"mixtral bench_serve: {MIXTRAL_BENCH_REQUESTS} requests with transfers "
                   f"and a hit rate in (0, 1), got {summ}")
    if drop is not None and not drop <= row["drop_limit_bytes"]:
        bad.append(f"mixtral bench_serve: MemAvailable fell {drop} B across the build, "
                   f"over {row['drop_limit_bytes']} B")
    if device == "cuda":
        peak = b["max_memory_allocated"]
        if not peak < min(bound, size["whole"]):
            bad.append(f"mixtral bench_serve: peak device memory {peak} B, bound {bound} B "
                       f"(whole model {size['whole']} B)")
        got = {"score": {op: b["score_launches"].get(op, {}) for op in ("moe_gmm", "flash_attn")},
               **{ph: {op: served[ph].get(op, {}) for op in ("moe_gmm", "flash_attn")}
                  for ph in ("prefill", "decode")}}
        if not (set(got["score"]["moe_gmm"]) == {"tc"} and got["score"]["flash_attn"] == want_flash
                and set(got["prefill"]["moe_gmm"]) == {"tc"}
                and got["prefill"]["flash_attn"] == want_flash
                and set(got["decode"]["moe_gmm"]) == {"stream"}
                and not got["decode"]["flash_attn"]):
            bad.append(f"mixtral bench_serve: launches {got}, want moe_gmm 'tc' in the oracle "
                       f"and the prefills, 'stream' in decode, and flash_attn {want_flash} in "
                       f"the oracle and in the prefills")
    return row


def _mixtral_psi_row(r: dict, cfg, device: str, bad: list) -> dict:
    """Phase 23 (b)'s run with Psi, on the bf16 child's store: printed, then
    gated into ``bad``."""
    p, n = r["predictor"], r["layers"]
    rep = p["rep"]
    cut = dataclasses.replace(cfg, layout=(dataclasses.replace(
        cfg.layout[0], repeats=n // len(cfg.layout[0].pattern)),))
    size = _offload_bytes(cfg, n)
    act = _mixtral_trace_act_bytes(cfg, n)
    bound = size["nonexpert"] + size["layer"] + sum(act.values())
    staged = PSI_TRACE_NEW * n * size["layer"]
    trace = _trace_launches(p["routes"], rep["route_launches"])
    drop = (rep["host_available_before_build"] - rep["host_available_after_build"]
            if rep["host_available_before_build"] is not None else None)
    kl = rep["predictor_kl"]
    row = dict({k: v for k, v in rep.items() if k != "route_launches"},
               layers=n, tokens_equal_without_psi=p["tokens_equal"], trace_staged_bytes=staged,
               trace_gb_s=staged / rep["trace_s"] / 1e9, trace_memory_bound_bytes=bound,
               trace_act_bytes=act, whole_model_bytes=size["whole"],
               host_available_drop_bytes=drop, trace_launches=trace,
               launches_total=p["launches"], route_launches=p["routes"],
               route_launches_by_phase=rep["route_launches"], secs=r["secs"]["predictor"])
    print(f"mixtral-bf16 with Psi ({n} layers): KL {kl[0]:.4f} -> {kl[-1]:.4f}; trace "
          f"{rep['trace_s']:.2f} s, {staged} B staged ({row['trace_gb_s']:.2f} GB/s over the "
          f"trace), peak {rep['trace_max_memory_allocated']} B (bound {bound} B); prefetch "
          f"{rep['prefetch_transfers']}, transfers {rep['transfers']}, decode "
          f"{rep['decode_tok_s']:.2f} tok/s; MemAvailable drop {drop} B; trace launches "
          f"{trace}")
    print("mixtral-bf16 with Psi:", json.dumps(row))
    if not (all(math.isfinite(x) for x in kl) and kl[-1] < kl[0]):
        bad.append(f"mixtral Psi: KL did not fall: {kl}")
    C = cfg.melinoe_cache_capacity()
    if rep["prefetch_transfers"] != C * n:
        bad.append(f"mixtral Psi: {rep['prefetch_transfers']} prefetch transfers, want "
                   f"C x layers = {C * n}")
    if not p["tokens_equal"]:
        bad.append("mixtral Psi: tokens differ from the run without Psi")
    if drop is not None and not drop <= MIXTRAL_RSS_MARGIN:
        bad.append(f"mixtral Psi: MemAvailable fell {drop} B across the run, over "
                   f"{MIXTRAL_RSS_MARGIN} B")
    if device == "cuda":
        if trace != _trace_want(cut):
            bad.append(f"mixtral Psi: the trace's launches {trace}, want {_trace_want(cut)}")
        if not rep["trace_max_memory_allocated"] < min(bound, size["whole"]):
            bad.append(f"mixtral Psi: the trace's peak device memory "
                       f"{rep['trace_max_memory_allocated']} B, bound {bound} B")
    return row


def _mixtral_ckpt_row(r: dict, cfg, bad: list) -> dict:
    """Phase 23 (d)'s row, printed, then gated into ``bad``."""
    n = r["layers"]
    size = _offload_bytes(cfg, n)
    ck, sd, b = r["run_ckpt"], r["run_seed"], r["bench_build"]
    drops = {"run_ckpt": ck["host_available_before_build"] - ck["host_available_after_build"]
             if ck["host_available_before_build"] is not None else None,
             "bench_ckpt": b["host_available_before_build"] - b["host_available_after_build"]
             if b["host_available_before_build"] is not None else None}
    limit = ck["host_store_bytes"] + size["layer"] + MIXTRAL_RSS_MARGIN
    row = {"layers": n, "scores_equal": r["scores_equal"], "scores_max_abs": r["scores_max_abs"],
           "trace_equal": r["trace_equal"], "trace_probs_max_abs": r["trace_probs_max_abs"],
           "trace_shape": r["trace_shape"],
           "ckpt_bytes": r["ckpt_bytes"], "tokens_equal": r["tokens_equal"],
           "run_ckpt": ck, "run_seed": sd, "host_available_drop_bytes": drops,
           "drop_limit_bytes": limit, "bench_requests": r["bench_summary"]["requests"],
           "bench_finished": r["bench_finished"], "bench_build_s": b["build_s"],
           "bench_transfers": r["bench_summary"]["transfers"], "secs": r["secs"]}
    print("mixtral checkpoint:", json.dumps(row))
    if not (r["scores_equal"] and r["tokens_equal"] and r["trace_equal"]
            and all(ck[k] == sd[k] for k in ("transfers", "hits", "misses"))):
        bad.append(f"mixtral checkpoint: streamed oracle equal {r['scores_equal']}, streamed "
                   f"trace equal {r['trace_equal']}, run(ckpt=) against run(): tokens equal "
                   f"{r['tokens_equal']}, {ck} vs {sd}")
    if not r["bench_summary"]["requests"] == len(r["bench_finished"]) == MIXTRAL_BENCH_REQUESTS:
        bad.append(f"mixtral checkpoint: bench_serve --ckpt finished {r['bench_finished']}")
    for what, drop in drops.items():
        if drop is not None and not drop <= limit:
            bad.append(f"mixtral checkpoint: {what}'s MemAvailable fell {drop} B, over {limit} B")
    return row


# profile_prefetch's spec is static_lfu's but for its name, and make_engine
# wires no prefetcher in either package: these numbers are equal
_PROFILE_SAME = ("transfers", "hits", "misses", "evictions", "modeled_time_s",
                 "modeled_time_overlapped_s")


def _baseline_launches_ok(r: dict, n: int, steps: int, name: str) -> bool:
    """Phase 23(e): one row's launches by phase and route, on ``n`` layers
    and ``steps`` decode steps. ``flash_attn`` one "tc" a layer in the
    prefill, none in decode; ``moe_gmm`` "tc" in the prefill and "stream"
    in decode, 3 a group set: the empty slab of stream_all and cpu_execute
    leaves the overflow group alone, every layer-step (exact); the other
    fp systems' prefill routes all 8 experts past C = 2, slab and overflow
    (exact), their decode steps one or both sets; quant_cache's INT4 slab
    one set, its spilled experts on ``int4_matmul`` (INT4_PHASE_ROUTES,
    three a spilled expert); no ``int4_matmul`` in an fp row; every
    launch on FAST_ROUTES."""
    ph = r["by_phase"]
    get = lambda p, op: ph[p].get(op) or {}  # noqa: E731
    pre, dec = get("prefill", "moe_gmm"), get("decode", "moe_gmm")
    npre, ndec = sum(pre.values()), sum(dec.values())
    i4 = {p: get(p, "int4_matmul") for p in ("prefill", "decode")}
    n_i4 = sum(sum(v.values()) for v in i4.values())
    ok = (get("prefill", "flash_attn") == {"tc": n} and not get("decode", "flash_attn")
          and set(pre) <= {"tc"} and set(dec) <= {"stream"}
          and r["launches_total"]["moe_gmm"] == npre + ndec
          and r["launches_total"]["flash_attn"] == n
          and r["launches_total"]["int4_matmul"] == n_i4
          and all(set(r["route_launches"][op]) <= set(fast)
                  for op, fast in FAST_ROUTES.items()))
    if name in ("stream_all", "cpu_execute"):
        ok = ok and (npre, ndec) == (3 * n, 3 * n * steps)
    elif r["quantized"]:
        ok = ok and npre == 3 * n and 0 < ndec <= 3 * n * steps and ndec % 3 == 0
    else:
        ok = ok and npre == 6 * n and 3 * n * steps <= ndec <= 6 * n * steps and ndec % 3 == 0
    if r["quantized"]:
        return ok and n_i4 > 0 and n_i4 % 3 == 0 and all(
            set(v) <= set(INT4_PHASE_ROUTES[p]) for p, v in i4.items())
    return ok and n_i4 == 0


def _mixtral_baselines_rows(bf16: dict, int4: dict, cfg, device: str, bad: list,
                            roundoff: float) -> dict:
    """Phase 23(e)'s rows (``mixtral_baselines`` of the bf16 and INT4
    children, full config ``cfg``), printed with the Fig.-3 table, then
    gated into ``bad`` (see the module docstring); ``roundoff``: the INT4
    child's plain bf16 round-off r."""
    spec, C = cfg.moe_spec, cfg.melinoe_cache_capacity()
    parts = {"bf16": bf16["baselines"], "int4": int4["baselines"]}
    rows, drops = {}, {}
    for kind, b in parts.items():
        n = b["layers"]
        size = _offload_bytes(cfg, n)
        before = b["host_available_before"]
        drops[kind] = None if before is None else before - b["host_available_after"]
        print(f"mixtral baselines, {kind} child: {n} of {cfg.n_layers} layers, {b['batch']} x "
              f"({b['prompt_len']} + {b['new']}) tokens, C = {C}; MemAvailable drop "
              f"{drops[kind]} B across its rows (limit {MIXTRAL_BASELINE_HOST_BYTES} B); "
              f"{b['secs']:.1f} s")
        for name, r in b["rows"].items():
            r = dict(r, kind=kind, memory_bound_bytes=size["nonexpert"] + r["slab_bytes"]
                     + size["layer"] + MIXTRAL_BASELINE_ACT_BYTES,
                     copies_per_decode_step=r["expert_copies"]["decode"] / max(b["new"] - 1, 1))
            rows[name] = r
            print(f"mixtral-baseline-{name}:", json.dumps({k: v for k, v in r.items()
                                                          if k != "by_phase"}),
                  f"by phase {r['by_phase']}")
    gb = lambda x: f"{x / 1e9:7.2f}" if x is not None else "    n/a"  # noqa: E731
    print("system           layers transfers host_exec   hits  misses hit_rate  serial_s "
          "overlap_s serial_tok/s overlap_tok/s prefill_s decode_tok/s copies(pre/dec) "
          "peak_GB slab_GB")
    for name, r in rows.items():
        print(f"{name:16s} {r['layers']:6d} {r['transfers']:9d} {r['host_executed']:9d} "
              f"{r['hits']:6d} {r['misses']:7d} {r['hit_rate']:8.4f} "
              f"{r['modeled_time_s']:9.3f} {r['modeled_time_overlapped_s']:9.3f} "
              f"{r['modeled_tok_s']:12.3f} {r['modeled_overlapped_tok_s']:13.3f} "
              f"{r['prefill_s']:9.3f} {r['decode_tok_s']:12.3f} "
              f"{r['expert_copies']['prefill']:7d}/{r['expert_copies']['decode']:<7d} "
              f"{gb(r['max_memory_allocated'])} {gb(r['slab_bytes'])}")
    mel = rows["melinoe"]
    fig3 = {}
    for name, r in rows.items():
        if name != "melinoe" and r["layers"] == mel["layers"]:
            fig3[name] = {"serial": mel["modeled_tok_s"] / r["modeled_tok_s"],
                          "overlapped": mel["modeled_overlapped_tok_s"]
                          / r["modeled_overlapped_tok_s"],
                          "measured": (mel["decode_tok_s"] / r["decode_tok_s"]
                                       if r["decode_tok_s"] > 0 else None)}
    print(f"Fig. 3 on {cfg.name} ({mel['layers']} layers, C = {C}): melinoe's "
          f"decode tokens/s over each system's, serial-modeled / overlapped-modeled / "
          f"measured")
    for name, f in fig3.items():
        meas = f"{f['measured']:.3f}" if f["measured"] is not None else "n/a"
        print(f"  melinoe / {name:16s} {f['serial']:7.3f} {f['overlapped']:7.3f} {meas:>7s}")
    print("  (random weights, and Mixtral not fine-tuned: no path of either package "
          "fine-tunes with the experts offloaded, so these ratios are not the paper's)")

    bl = parts["bf16"]
    n, steps, B, T = bl["layers"], bl["new"] - 1, bl["batch"], bl["prompt_len"]
    n_moe = n * cfg.n_moe_layers // cfg.n_layers
    want_stream = n_moe * spec.top_k * (B * T + B * steps)
    sa, cx, lfu, pp = (rows[k] for k in ("stream_all", "cpu_execute", "static_lfu",
                                         "profile_prefetch"))
    toks = bl["tokens"]
    first = next(iter(toks))
    differ = [k for k, t in toks.items() if not np.array_equal(t, toks[first])]
    names = list(bl["logits"])
    pair_rel = max((_rel(bl["logits"][a], bl["logits"][b])
                    for i, a in enumerate(names) for b in names[i + 1:]), default=0.0)
    stream_rel = _rel(bl["logits"]["stream_all"], bf16["plain_logits"])
    print(f"mixtral baselines: stream_all transfers {sa['transfers']} (want {want_stream}), "
          f"hits + misses {sa['hits'] + sa['misses']}; cpu_execute transfers "
          f"{cx['transfers']}, host_executed {cx['host_executed']} (static_lfu transfers "
          f"{lfu['transfers']}); profile_prefetch vs static_lfu equal "
          f"{all(pp[k] == lfu[k] for k in _PROFILE_SAME)}; the six bf16 rows' tokens "
          f"{'equal' if not differ else f'differ: {differ}'}, prefill logits at most "
          f"{pair_rel:.4g} apart; stream_all prefill logits vs the plain run rel "
          f"{stream_rel:.4g} (limit {MIXTRAL_ROUNDOFF_SPAN} x {roundoff:.4g})")
    if not (sa["transfers"] == want_stream and sa["hits"] + sa["misses"] == 0):
        bad.append(f"mixtral stream_all: {sa['transfers']} transfers, hits + misses "
                   f"{sa['hits'] + sa['misses']}, want {want_stream} and 0")
    if not (cx["transfers"] == 0 and cx["host_executed"] == lfu["transfers"] > 0):
        bad.append(f"mixtral cpu_execute: transfers {cx['transfers']}, host_executed "
                   f"{cx['host_executed']}, want 0 and static_lfu's {lfu['transfers']}")
    if any(pp[k] != lfu[k] for k in _PROFILE_SAME):
        bad.append(f"mixtral profile_prefetch differs from static_lfu: "
                   f"{ {k: (pp[k], lfu[k]) for k in _PROFILE_SAME} }")
    if differ or not all(t.shape == (B, bl["new"]) for t in toks.values()):
        bad.append(f"mixtral baselines: the bf16 rows' tokens differ ({differ})")
    if not all(torch.isfinite(x).all() and x.shape == (B, cfg.vocab)
               for x in bl["logits"].values()):
        bad.append("mixtral baselines: prefill logits not finite or of another shape")
    if not (math.isfinite(stream_rel) and stream_rel <= MIXTRAL_ROUNDOFF_SPAN * roundoff):
        bad.append(f"mixtral stream_all: prefill logits vs plain rel {stream_rel}, over "
                   f"{MIXTRAL_ROUNDOFF_SPAN} x {roundoff}")
    if device == "cuda":
        for kind, drop in drops.items():
            if drop is None or not drop < MIXTRAL_BASELINE_HOST_BYTES:
                bad.append(f"mixtral baselines ({kind} child): MemAvailable fell {drop} B, "
                           f"limit {MIXTRAL_BASELINE_HOST_BYTES} B")
        for name, r in rows.items():
            b = parts[r["kind"]]
            if not _baseline_launches_ok(r, b["layers"], b["new"] - 1, name):
                bad.append(f"mixtral baseline {name}: launches {r['launches_total']} by "
                           f"phase {r['by_phase']}")
            if not r["max_memory_allocated"] <= r["memory_bound_bytes"]:
                bad.append(f"mixtral baseline {name}: peak device memory "
                           f"{r['max_memory_allocated']} B, bound {r['memory_bound_bytes']} B")
    return {"rows": rows, "fig3": fig3, "stream_all_logits_rel": stream_rel,
            "logits_max_pairwise_rel": pair_rel, "tokens_equal": not differ,
            "host_available_drop_bytes": drops,
            "launches_total": {k: r["launches_total"] for k, r in rows.items()},
            "route_launches": {k: r["route_launches"] for k, r in rows.items()}}


# Phase 24: Phi-3.5-MoE (paper Table 6: 32 layers, d 4096, 32 q / 8 kv heads
# of 128, 16 experts top-2, d_ff 6400, vocab 32,064; Table 7: C = 4), the
# paper's third backbone, offloaded at full width through launch.serve.run
# as phase 23(a) serves Mixtral (``_offload_pair``, ``_offload_rows``): INT4
# at full depth (a 30.2 GB store), then bf16 (75.0 GiB) at the depth the
# host's MemAvailable allows, each store drawn one expert matrix at a time
# in a child process of its own, phase 23's traffic (4 x (128 + 16) tokens,
# gamma, seed 0), so that the two backbones' rows read side by side. At
# 16 experts top-2 and C = 4 the slab holds a quarter of the experts, as
# Mixtral's does, but a prefill's overflow group takes up to 12 experts a
# layer and its row count per expert is about 64 (4 x 128 x 2 / 16). Its
# rows are gated as phase 23's, and on the peak device memory: the model
# (83.75 GB) does not fit the card, so what it holds there is bounded by
# the non-expert weights, the slabs, one layer's overflow group and
# OFFLOAD_ACT_BYTES.
PHI = "phi35-moe"
# activations, KV caches and logits of the batch beside the weights a row
# must hold (a 512-token prefill's are tens of MB)
OFFLOAD_ACT_BYTES = 1 << 30
# the two children (41.9 and 40.1 s from spawn to exit, the phase 90.3 s
# with the settling of MemAvailable, on an H100 80GB HBM3 at 700 W); a guard
# against a hang, inside the whole run's 1200 s
PHI_LIMIT_S = 400


def phi_phase(arch: str = PHI, device: str = "cuda",
              fp32_layers: int = MIXTRAL_FP32_LAYERS) -> dict:
    """Phase 24 (see PHI): full-width Phi-3.5-MoE offloaded, INT4 at full
    depth, then bf16 at the depth the host's memory allows, each in a child
    process (``_offload_pair`` without phase 23's extras); the rows printed,
    then gated by ``_offload_rows`` with its peak-memory gate.
    ``arch``/``device``: a smaller model or the CPU, to rehearse the
    phase's logic."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    with tempfile.TemporaryDirectory() as d:
        rows = _offload_pair("phi", arch, d, device, fp32_layers, t_phase + PHI_LIMIT_S,
                             extras=False)
    print(f"phi children: seconds from spawn to exit "
          f"{ {k: round(r['spawn_s'], 1) for k, r in rows.items()} }")
    bad = []
    out, _ = _offload_rows("phi", rows, cfg, device, fp32_layers, bad, peak_gate=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phi phase: {out['phase_s']:.1f} s")
    if bad:
        raise AssertionError("phi phase: " + "; ".join(bad))
    return out


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
    dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    atexit.register(shutil.rmtree, dry_dir, True)
    dry_bg = start_production_dryruns(dry_dir)  # phase 22(b), beside phases 3-21

    gen = torch.Generator(device="cuda").manual_seed(0)
    g_cases = gmm_cases(gen)
    f_cases = flash_cases(gen)
    # its own generator: the kernels' cases draw what they drew before it
    blockwise_cases(torch.Generator(device="cuda").manual_seed(1))
    i_cases = int4_cases(gen)
    s_cases = ssd_cases(gen)
    # Mixtral-8x7B's shapes, from a generator of their own (the cases above
    # draw what they drew before them)
    mgen = torch.Generator(device="cuda").manual_seed(2)
    g_cases += offload_gmm_cases(mgen, MIXTRAL)
    f_cases += flash_cases(mgen, MIXTRAL_FLASH_SHAPES)
    i_cases += int4_cases(mgen, offload_int4_shapes(MIXTRAL))
    g_cases += offload_gmm_cases(torch.Generator(device="cuda").manual_seed(3), MIXTRAL,
                                 MIXTRAL_BASELINE_GMM_SHAPES)
    # Phi-3.5-MoE's (phase 24; its flash_attn shape is Mixtral's), from a
    # generator of their own
    pgen = torch.Generator(device="cuda").manual_seed(4)
    g_cases += offload_gmm_cases(pgen, PHI)
    i_cases += int4_cases(pgen, offload_int4_shapes(PHI))
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
    l_rep = little_phase(shared)

    # ---- the dense and prefix-conditioned configs; OLMoE offloaded with a prefix
    dn_rep = dense_phase(shared)

    # ---- the operations stack: tracing, faults, crash-safe serving
    o_rep = ops_phase(ops_main, ops_int4, shared)

    # ---- the supervised fleet: two OLMoE workers on the card
    f_rep = fleet_phase()

    # ---- the per-expert engine beside the slab engine; expert parallelism
    dc_rep = dict_phase()
    ep_rep = ep_phase()

    # ---- the dry run: its one-card prediction against the card; the production meshes
    dr_rep = dryrun_phase(dry_bg, dry_dir)

    # ---- Mixtral-8x7B offloaded at full width: INT4 at full depth, then bf16
    mx_rep = mixtral_phase()

    # ---- Phi-3.5-MoE offloaded at full width: INT4 at full depth, then bf16
    phi_rep = phi_phase()
    ep_paths = {}
    for r in ep_rep["ranks"]:
        gmm = r["moe"]["bfloat16"]["moe_gmm_routes"]
        ep_paths[f"ep-moe-bf16-rank{r['rank']}"] = (
            {"moe_gmm": sum(gmm.values()), "flash_attn": 0, "int4_matmul": 0, "ssd_scan": 0},
            {"moe_gmm": gmm, "flash_attn": {}, "int4_matmul": {}, "ssd_scan": {}})
        ssd = r["mamba"]["bfloat16"]["ssd_scan_routes"]
        ep_paths[f"ep-mamba-bf16-rank{r['rank']}"] = (
            {"moe_gmm": 0, "flash_attn": 0, "int4_matmul": 0, "ssd_scan": sum(ssd.values())},
            {"moe_gmm": {}, "flash_attn": {}, "int4_matmul": {}, "ssd_scan": ssd})

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
             **{r["path"]: r["launches_total"] for r in dn_rep["rows"].values()},
             **{f"ops-{n}": r["launches_total"] for n, r in o_rep["rows"].items()
                if "launches_total" in r},
             **{f"fleet-{n}-worker{w['worker']}": w["launches"]
                for n, r in f_rep["rows"].items() for w in r.get("workers", ())},
             **{f"phase20-{n}": r["launches_total"] for n, r in dc_rep["rows"].items()
                if "launches_total" in r},
             **{p: lr[0] for p, lr in ep_paths.items()},
             **{f"dryrun-{n}": r["card"]["launches"] for n, r in dr_rep["rows"].items()},
             **{f"mixtral-{n}": mx_rep[n]["launches_total"]
                for n in ("int4", "bf16", "predictor", "bench")},
             **{f"mixtral-baseline-{n}": lt
                for n, lt in mx_rep["baselines"]["launches_total"].items()},
             **{f"phi-{n}": phi_rep[n]["launches_total"] for n in ("int4", "bf16")}}
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
             **{r["path"]: r["route_launches"] for r in dn_rep["rows"].values()},
             **{f"ops-{n}": r["route_launches"] for n, r in o_rep["rows"].items()
                if "route_launches" in r},
             **{f"fleet-{n}-worker{w['worker']}": w["route_launches"]
                for n, r in f_rep["rows"].items() for w in r.get("workers", ())},
             **{f"phase20-{n}": r["route_launches"] for n, r in dc_rep["rows"].items()
                if "route_launches" in r},
             **{p: lr[1] for p, lr in ep_paths.items()},
             **{f"dryrun-{n}": r["card"]["routes"] for n, r in dr_rep["rows"].items()},
             **{f"mixtral-{n}": mx_rep[n]["route_launches"]
                for n in ("int4", "bf16", "predictor", "bench")},
             **{f"mixtral-baseline-{n}": rl
                for n, rl in mx_rep["baselines"]["route_launches"].items()},
             **{f"phi-{n}": phi_rep[n]["route_launches"] for n in ("int4", "bf16")}}
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
