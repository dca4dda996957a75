"""Serving launcher, PyTorch: offloaded MoE serving (post-deployment
stage, Sec 3.2), or the full-model path with the whole model resident.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe \
        --capacity 16 --policy gamma --batch 4 --prompt-len 128 --max-new 32 \
        [--quantized]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --batch 4 --prompt-len 128 --max-new 16 [--quantized]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --batch 4 --prompt-len 512 --max-new 32

A MoE architecture goes through ``run`` (below); an SSM, hybrid or dense
one through ``run_full``, which also takes a MoE one (served whole from
the command line by ``launch.bench_serve``), and a prefix-conditioned one
(musicgen, internvl2) with ``prefix_len`` rows drawn from ``--seed``
ahead of each prompt: random weights from ``--seed`` resident on the device, one
prefill (``models.model.prefill``, where the Mamba2 layers launch the
``ssd_scan`` kernel, attention the ``flash_attn`` kernel and the MoE
layers ``moe_gmm``) and a greedy ``decode_step`` loop, each timed to a
device synchronize, with the launches of each phase and the peak device
memory.

Random weights from ``--seed``, or a params-only checkpoint
(``--ckpt PATH``: ``training.save_checkpoint`` of the parameter tree, in
either package; read leaf by leaf with a like-tree of the config's fp32
shapes, as the reference does, then cast to ``--dtype``, the experts one
``(E, i, o)`` matrix at a time into the engine's store), the slab offload engine
with the cache policy and capacity C, batched greedy generation, then a
report of transfers, hit rate, both Eq.-3 modeled clocks and the
measured prefill seconds and decode tokens/s. ``--quantized`` keeps
every expert in HQQ INT4 (paper Sec 3.2, group 32); the report then
also gives ``quantize_s``, the seconds spent building the INT4 store
(not part of ``prefill_s``). Runs on ``cuda`` unless ``--device cpu``.

``--predictor`` (with ``--n-train-prompts N``) trains the activation
predictor Psi first, as ``repro.launch.serve`` does: the model traces N
more prompts of the same stream in one batch (``routing_trace``, 16 new
tokens each), Psi is fit to their per-layer mean router distributions,
and the engine prefetches Psi's scores for the batch's mean prompt
embedding before ``generate`` (``run``'s report keeps them, (L, E), under
``predictor_scores``). The experts stay in the engine's store: every
forward pass of the trace stages each MoE layer on the device in turn
and drops it before the next (``routing_trace(host_store=)``), so a
model whose experts exceed the card (Mixtral-8x7B's 84.0 GiB) is traced
on it with the same tokens and router distributions as the whole tree.
With ``--quantized`` the store keeps no full-precision experts: they are
drawn onto the device whole for the trace, and a model whose experts do
not fit the card raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import resource
import time
from pathlib import Path

import numpy as np
import torch

from ..configs import get_config
from ..core.offload_engine import HardwareProfile, HostExpertStore, OffloadedMoEEngine
from ..bridge import params_from_jax
from ..data.synthetic import ClusterLM, SyntheticConfig
from ..core.predictor import (PromptEmbedder, init_predictor, predict_scores,
                              train_predictor)
from ..inference.engine import routing_trace
from ..inference.sampling import greedy
from ..kernels import _build, dispatch
from ..models.common import cdtype
from ..models.model import decode_step, init_params, prefill
from ..models.runtime import Runtime, resolve_device
from ..training.checkpoint import load_checkpoint, tree_leaves


def make_prompts(vocab: int, batch: int, prompt_len: int) -> np.ndarray:
    """The JAX launcher's prompts: ClusterLM(seed=3), sampled with rng 0."""
    lm = ClusterLM(SyntheticConfig(vocab=vocab, seq_len=prompt_len, seed=3))
    rng = np.random.default_rng(0)
    return np.stack([lm.sample_sequence(rng)[0] for _ in range(batch)]
                    ).astype(np.int32)


def make_prefix(cfg, batch: int, seed: int = 0) -> np.ndarray:
    """(batch, cfg.prefix_len, d_model) fp32 conditioning rows standing in
    for a frontend's output (image patches, audio codes), drawn N(0, 1)
    like the token embeddings with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.prefix_len, cfg.d_model)).astype(np.float32)


def _leaf_paths(tree, pre: str = ""):
    """The tree with each leaf replaced by its path ("groups/g0/p0/ffn/wg")."""
    if isinstance(tree, dict):
        return {k: _leaf_paths(v, f"{pre}/{k}" if pre else k) for k, v in tree.items()}
    return pre


def load_params(cfg, ckpt, *, dtype, device, expert_sink=None, expert_device=None):
    """A params-only checkpoint (either package's ``save_checkpoint`` of
    the parameter tree) read with a like-tree of the config's fp32 shapes
    (built on the ``meta`` device: no memory), then through the bridge:
    floating leaves cast to ``dtype`` (the router and SSM constants stay
    fp32), on ``device``. Returns (params, metadata).

    ``expert_sink`` / ``expert_device``, as ``init_params`` takes them:
    the MoE blocks' experts are read one repeat's ``(E, i, o)`` matrix at
    a time, cast to ``dtype``, and handed to ``expert_sink(gi, pi, name,
    (r,), w)`` (``HostExpertStore.sink``: the store is filled from the
    file, and host memory holds no other copy of the experts) and kept
    on ``expert_device``; the tree's expert leaves stay on ``meta`` unless
    ``expert_device`` says otherwise. With neither, they are read whole
    into the tree with the rest."""
    dt = cdtype(dtype)
    like = init_params(cfg, generator=torch.Generator(), dtype=torch.float32,
                       device="meta")
    experts, slices = {}, {}
    if expert_sink is not None or expert_device is not None:
        index = {path: i for i, path in enumerate(tree_leaves(_leaf_paths(like)))}
        for gi, g in enumerate(cfg.layout):
            for pi, bname in enumerate(g.pattern):
                if cfg.block_defs[bname].kind != "attn_moe":
                    continue
                for name in ("wg", "wu", "wd"):
                    w = torch.empty(like["groups"][f"g{gi}"][f"p{pi}"]["ffn"][name].shape,
                                    dtype=dt, device=expert_device or "meta")
                    experts[gi, pi, name] = w

                    def each(r, t, gi=gi, pi=pi, name=name, w=w):
                        t = t.to(dt)
                        if expert_sink is not None:
                            expert_sink(gi, pi, name, (r,), t)
                        if not w.is_meta:
                            w[r] = t

                    slices[index[f"groups/g{gi}/p{pi}/ffn/{name}"]] = each
    tree, _, meta = load_checkpoint(ckpt, like, slices=slices)
    for (gi, pi, name), w in experts.items():  # the bridge keeps them where they are
        tree["groups"][f"g{gi}"][f"p{pi}"]["ffn"][name] = w
    return params_from_jax(tree, cfg, dtype=dt, device=device), meta


def offloaded_params(cfg, *, dtype, device, ckpt=None, seed: int = 0):
    """An offloaded server's weights: the experts drawn from ``seed`` (the
    stream ``init_params`` draws from ``torch.Generator(device=device)``)
    or read from ``ckpt``, one ``(E, i, o)`` matrix at a time, straight
    into a ``HostExpertStore`` (pinned where ``device`` is CUDA); every
    other weight on ``device``. Returns (params, their expert leaves on
    ``meta``; the finished store, an engine's ``host_store``; the
    checkpoint's metadata, or None)."""
    dev = torch.device(device)
    store = HostExpertStore(cfg, device=dev)
    if ckpt is not None:
        params, meta = load_params(cfg, ckpt, dtype=dtype, device=dev,
                                   expert_sink=store.sink)
    else:
        params, meta = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                                   dtype=dtype, device=dev, expert_sink=store.sink), None
    return params, store.finish(), meta


def _tree_to(tree, dev):
    """``tree`` on ``dev``; a ``meta`` leaf (an expert kept in a host store)
    stays where it is."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree if tree.is_meta else tree.to(dev)


def _check_trace_fits(cfg, dtype, dev) -> None:
    """``--predictor`` with INT4 experts traces the whole model on the
    device (the store holds no full-precision experts to stage): refuse a
    model whose experts alone exceed the card's free memory."""
    if dev.type != "cuda":
        return
    spec = cfg.moe_spec
    need = (cfg.n_moe_layers * spec.num_experts * 3 * cfg.d_model * spec.d_ff
            * torch.empty((), dtype=dtype).element_size())
    free = torch.cuda.mem_get_info(dev)[0]
    if need > free:
        raise NotImplementedError(
            f"predictor with INT4 experts: the routing trace takes the full-precision "
            f"experts, which an INT4 store does not keep, so the whole model runs on the "
            f"device, and {cfg.name}'s experts ({need} B) exceed its free memory "
            f"({free} B); a trace from an INT4 store is not ported")


def train_psi(cfg, params, train_prompts, prompts, *, device, kernel_backend="auto",
              predictor_init=None, trace_new: int = 16, host_store=None) -> tuple:
    """The reference launcher's predictor step: trace ``train_prompts``
    (a device copy of ``params``, freed before this returns), fit Psi
    (``predictor_init``, else drawn from seed 1) to the per-layer mean
    router distributions, and score the mean embedding of ``prompts``.
    With ``host_store`` (``params``' experts on ``meta``) the trace stages
    each MoE layer from it in every forward pass and the device copy holds
    the other weights only. Returns ((L, E) scores, report); the report's
    ``trace_max_memory_allocated`` is the device's peak during the trace
    (None off CUDA)."""
    dev = torch.device(device)
    emb = PromptEmbedder(cfg.vocab, device=dev)
    t0 = time.perf_counter()
    traced = _tree_to(params, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _, probs = routing_trace(cfg, traced, train_prompts, max_new=trace_new,
                             rt=Runtime(kernel_backend=kernel_backend, device=dev,
                                        zero_drop=True), host_store=host_store)
    trace_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    del traced
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    trace_s = time.perf_counter() - t0
    targets = probs.mean(axis=2)  # (N, L, E)
    embs = torch.stack([emb(p) for p in train_prompts])
    pp = predictor_init or init_predictor(
        targets.shape[1], targets.shape[2],
        generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    t1 = time.perf_counter()
    pp, hist = train_predictor(pp, embs, targets)
    scores = predict_scores(pp, emb(prompts).mean(0))
    return scores, {"predictor_kl": hist, "trace_s": trace_s,
                    "trace_max_memory_allocated": trace_peak,
                    "predictor_train_s": time.perf_counter() - t1,
                    "n_train_prompts": len(train_prompts), "predictor_scores": scores}


def host_available_bytes():
    """The host's MemAvailable in bytes (``/proc/meminfo``), or None
    where the file is missing."""
    try:
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def max_rss_bytes() -> int:
    """This process's resident-set high-water mark in bytes: ``VmHWM`` of
    ``/proc/self/status``, its own address space's, which starts afresh at
    ``exec`` (``getrusage``'s ``ru_maxrss``, the fallback, starts at the
    resident set of the process that forked it)."""
    try:
        for line in Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _experts_to_meta(cfg, params) -> None:
    """Replace the MoE blocks' stacked expert leaves with ``meta`` tensors
    of their shape: the device memory they held is freed."""
    for gi, g in enumerate(cfg.layout):
        for pi, bname in enumerate(g.pattern):
            if cfg.block_defs[bname].kind == "attn_moe":
                ffn = params["groups"][f"g{gi}"][f"p{pi}"]["ffn"]
                for k in ("wg", "wu", "wd"):
                    ffn[k] = torch.empty_like(ffn[k], device="meta")


def run(arch: str, *, capacity: int = 0, policy: str = "gamma", batch: int = 2,
        prompt_len: int = 32, max_new: int = 64, dtype=None, device=None,
        seed: int = 0, kernel_backend: str = "auto", quantized: bool = False,
        quantized_experts=None, keep_store: bool = False, host_store=None,
        ckpt=None, predictor: bool = False, n_train_prompts: int = 32,
        predictor_init=None) -> dict:
    """Build a random-init model (or read ``ckpt``), serve one batch
    through the offloaded engine, and return the report (scalars, plus
    ``tokens`` and the last prompt position's ``prefill_logits``).

    Random experts are drawn one ``(E, i, o)`` matrix at a time on the
    device straight into the engine's pinned store
    (``HostExpertStore.sink``; INT4: quantized on the device first), so
    host memory holds the store and nothing else of them: Mixtral-8x7B's
    84 GiB of bf16 experts (31.5 GiB INT4) are served from a host that
    could not hold them twice. The report gives the host's MemAvailable
    before and after the build, the process's resident-set high-water mark
    after it (``max_rss_bytes``),
    ``host_store_bytes``, ``slab_bytes`` and the peak device memory of
    the served batch. A ``ckpt`` fills the store the same way, one
    ``(E, i, o)`` matrix at a time as it is read (``load_params``).

    ``keep_store`` puts the engine's pinned expert store into the report
    under ``host_store`` (and, quantized, under ``quantized_experts`` as
    INT4 views); an earlier report's ``host_store`` given back serves
    those experts without drawing or copying them again (the same seed
    gives the same other weights). With ``quantized``,
    ``quantized_experts`` serves those INT4 codes instead of quantizing
    again. ``predictor`` trains Psi on a routing trace (``train_psi``)
    whose experts come from the store, one staged MoE layer at a time, a
    given ``host_store`` included; with ``quantized`` the trace needs the
    full-precision experts the INT4 store does not keep: they are drawn
    onto the device too (a model whose experts exceed the card raises
    ``NotImplementedError``; a given INT4 ``host_store`` ``ValueError``)
    and dropped before the engine is built."""
    cfg = get_config(arch)
    if not cfg.has_router:
        raise ValueError("offloaded serving applies to MoE architectures")
    dev = resolve_device(device)
    dt = cdtype(dtype or cfg.dtype)
    # an INT4 store keeps no full-precision experts to trace: they go to
    # the device whole beside it
    whole_trace = predictor and quantized
    if whole_trace and host_store is not None:
        raise ValueError("predictor: the routing trace takes the full-precision experts, "
                         "which a given INT4 host_store does not hold")
    avail_before, t_build = host_available_bytes(), time.perf_counter()
    store = None
    if host_store is None and not (quantized and quantized_experts is not None):
        store = HostExpertStore(cfg, quantized=quantized, device=dev)
    if whole_trace:
        _check_trace_fits(cfg, dt, dev)
    # the experts go into the store as they are drawn or read (the same
    # stream whether or not a store or codes were given)
    kw = dict(expert_device=dev if whole_trace else "meta",
              expert_sink=None if store is None else store.sink)
    if ckpt is not None:
        params, _ = load_params(cfg, ckpt, dtype=dt, device=dev, **kw)
    else:
        params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                             dtype=dt, device=dev, **kw)
    capacity = capacity or cfg.melinoe_cache_capacity()
    # the training prompts continue the batch's stream, as the reference's
    all_prompts = make_prompts(cfg.vocab, batch + (n_train_prompts if predictor else 0),
                               prompt_len)
    prompts = all_prompts[:batch]
    if store is not None:
        host_store = store.finish()
    psi = {}
    if predictor:
        scores, psi = train_psi(cfg, params, all_prompts[batch:], prompts, device=dev,
                                kernel_backend=kernel_backend,
                                predictor_init=predictor_init,
                                host_store=None if whole_trace else host_store)
        if whole_trace:
            _experts_to_meta(cfg, params)
    engine = OffloadedMoEEngine(cfg, params, capacity=capacity, policy=policy,
                                quantized=quantized,
                                quantized_experts=quantized_experts,
                                host_store=host_store,
                                hw=HardwareProfile(), kernel_backend=kernel_backend,
                                device=dev)
    del params  # the engine holds the experts in its pinned store
    build_s, rss_build = time.perf_counter() - t_build, max_rss_bytes()
    avail_after = host_available_bytes()
    if dev.type == "cuda":
        _build.lib()  # build the kernels now, not inside the timed prefill
    if predictor:
        engine.prefetch(scores)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = engine.generate(prompts, max_new_tokens=max_new)
    m, st = res["metrics"], res["cache_stats"]
    rep = {
        "arch": arch, "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dtype": str(dt).replace("torch.", ""), "capacity": capacity,
        "policy": policy, "batch": batch, "prompt_len": prompt_len,
        "max_new": max_new, "kernel_backend": kernel_backend,
        "quantized": quantized, "expert_bytes": engine.expert_bytes,
        "quantize_s": engine.quantize_s if store is None else store.quantize_s,
        "build_s": build_s, "host_available_before_build": avail_before,
        "host_available_after_build": avail_after, "max_rss_after_build": rss_build,
        "decode_tokens": m.decode_tokens, "transfers": m.transfers,
        "transfer_bytes": m.transfer_bytes,
        "transfers_per_layer": res["transfers_per_layer"],
        "prefetch_transfers": m.prefetch_transfers,
        "hits": st.hits, "misses": st.misses, "evictions": st.evictions,
        "hit_rate": st.hit_rate, "hw": engine.hw.name,
        "modeled_time_s": res["modeled_time_s"],
        "modeled_time_overlapped_s": res["modeled_time_overlapped_s"],
        "modeled_tok_s": res["throughput_tok_s"],
        "modeled_overlapped_tok_s": res["throughput_overlapped_tok_s"],
        "prefill_s": res["prefill_s"], "decode_tok_s": res["decode_tok_s"],
        "route_launches": res["route_launches"], "expert_copies": res["expert_copies"],
        "wall_s": m.wall_time,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
        "slab_bytes": engine.slab_bytes, "host_store_bytes": engine.host_store_bytes,
        "tokens": res["tokens"].cpu().numpy(),
        "prefill_logits": res["prefill_logits"].cpu(),
        **psi,
    }
    if keep_store:
        rep["host_store"] = engine.host_store
        if quantized:
            rep["quantized_experts"] = engine.quantized_experts()
    return rep


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_full(arch: str, *, batch: int = 2, prompt_len: int = 32, max_new: int = 64,
             dtype=None, device=None, seed: int = 0, kernel_backend: str = "auto",
             keep_params: bool = False, ckpt=None, prefix_embed=None) -> dict:
    """Serve one batch through the full-model path, the whole model
    resident on the device (random from ``seed``, or read from ``ckpt``),
    and return the report (scalars, the launches of each phase,
    ``tokens`` (B, max_new) and the last prompt position's
    ``prefill_logits`` (B, V)). ``prefix_embed`` (B, P, d): rows the
    prefill takes ahead of each prompt (``make_prefix``). ``keep_params``
    puts the weights into the report under ``params``."""
    cfg = get_config(arch)
    dev = resolve_device(device)
    dt = cdtype(dtype or cfg.dtype)
    if ckpt is not None:
        params, _ = load_params(cfg, ckpt, dtype=dt, device=dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, generator=gen, dtype=dt, device=dev)
    rt = Runtime(kernel_backend=kernel_backend, device=dev)
    if dev.type == "cuda":
        _build.lib()  # build the kernels now, not inside the timed prefill
        torch.cuda.reset_peak_memory_stats(dev)
    toks = torch.as_tensor(make_prompts(cfg.vocab, batch, prompt_len), dtype=torch.long,
                           device=dev)
    n_prefix = 0
    if prefix_embed is not None:
        prefix_embed = torch.as_tensor(prefix_embed).to(dev, dt)
        n_prefix = prefix_embed.shape[1]
    with torch.inference_mode():
        _sync(dev)
        before = dict(dispatch.LAUNCHES)
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, toks, rt, prefix_embed=prefix_embed,
                                n_slots=n_prefix + prompt_len + max_new)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        mid = dict(dispatch.LAUNCHES)
        cur = greedy(logits)
        outs = [cur]
        t1 = time.perf_counter()
        for _ in range(max_new - 1):
            logits_d, cache, _ = decode_step(params, cfg, cur, cache, rt)
            cur = greedy(logits_d)
            outs.append(cur)
        _sync(dev)
        decode_s = time.perf_counter() - t1
    after = dict(dispatch.LAUNCHES)
    rep = {
        "arch": arch, "path": "full", "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dtype": str(dt).replace("torch.", ""), "batch": batch,
        "prompt_len": prompt_len, "prefix_len": n_prefix, "max_new": max_new,
        "kernel_backend": kernel_backend,
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in _leaves(params)),
        "prefill_s": prefill_s, "decode_s": decode_s,
        "decode_tok_s": batch * (max_new - 1) / decode_s if decode_s > 0 else None,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
        "launches": {"prefill": {k: mid[k] - before[k] for k in mid},
                     "decode": {k: after[k] - mid[k] for k in mid}},
        "tokens": torch.cat(outs, dim=1).cpu().numpy(),
        "prefill_logits": logits[:, -1].float().cpu(),
    }
    if keep_params:
        rep["params"] = params
    return rep


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-mini")
    ap.add_argument("--capacity", type=int, default=0, help="0 => E/4")
    ap.add_argument("--policy", default="gamma", choices=["lru", "lfu", "gamma"])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--dtype", default=None, help="default: the config's dtype")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quantized", action="store_true",
                    help="HQQ INT4 experts (Sec 3.2)")
    ap.add_argument("--ckpt", default=None,
                    help="params-only checkpoint (save_checkpoint of the parameter "
                         "tree, e.g. a merge_lora'd fine-tune) instead of random weights")
    ap.add_argument("--predictor", action="store_true", help="train + use Psi prefetch")
    ap.add_argument("--n-train-prompts", type=int, default=32)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if not cfg.has_router:
        if args.quantized or args.predictor:
            ap.error("--quantized and --predictor apply to the offloaded MoE path")
        rep = run_full(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                       max_new=args.max_new, dtype=args.dtype, device=args.device,
                       seed=args.seed, ckpt=args.ckpt,
                       prefix_embed=(make_prefix(cfg, args.batch, args.seed)
                                     if cfg.prefix_len else None))
        print(f"full-model path: {args.max_new} tokens x batch {args.batch} on "
              f"{rep['device_name']}; prefill={rep['prefill_s']:.4f} s, "
              f"decode={rep['decode_tok_s']:.2f} tok/s, launches {rep['launches']}")
        print(json.dumps({k: v for k, v in rep.items()
                          if k not in ("tokens", "prefill_logits")}))
        return rep
    rep = run(args.arch, capacity=args.capacity, policy=args.policy,
              batch=args.batch, prompt_len=args.prompt_len, max_new=args.max_new,
              dtype=args.dtype, device=args.device, seed=args.seed,
              quantized=args.quantized, ckpt=args.ckpt, predictor=args.predictor,
              n_train_prompts=args.n_train_prompts)
    if args.ckpt:
        print(f"loaded {args.ckpt}")
    if args.predictor:
        kl = rep["predictor_kl"]
        peak = rep["trace_max_memory_allocated"]
        print(f"predictor KL {kl[0]:.4f} -> {kl[-1]:.4f}; routing trace "
              f"{rep['trace_s']:.2f} s, peak device memory "
              f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    print(f"generated {rep['decode_tokens']} tokens x batch {args.batch} "
          f"on {rep['device_name']}")
    print(f"transfers={rep['transfers']} ({rep['transfers_per_layer']:.1f}/layer), "
          f"prefetch={rep['prefetch_transfers']}")
    print(f"hit rate={rep['hit_rate']:.3f}")
    if rep["quantized"]:
        print(f"INT4 experts: {rep['expert_bytes']} bytes each, quantized in "
              f"{rep['quantize_s']:.2f} s")
    gib = lambda n: "n/a" if n is None else f"{n / 2**30:.2f} GiB"  # noqa: E731
    print(f"host store {gib(rep['host_store_bytes'])} built in {rep['build_s']:.2f} s; "
          f"host MemAvailable {gib(rep['host_available_before_build'])} before, "
          f"{gib(rep['host_available_after_build'])} after; resident-set high-water "
          f"{gib(rep['max_rss_after_build'])}; device slabs {gib(rep['slab_bytes'])}, "
          f"peak {gib(rep['max_memory_allocated'])}")
    print(f"modeled throughput={rep['modeled_tok_s']:.2f} tok/s serial, "
          f"{rep['modeled_overlapped_tok_s']:.2f} overlapped (hw={rep['hw']}, Eq. 3)")
    print(f"measured prefill={rep['prefill_s']:.4f} s, "
          f"decode={rep['decode_tok_s']:.2f} tok/s")
    print(json.dumps({k: v for k, v in rep.items()
                      if k not in ("tokens", "prefill_logits", "predictor_scores")}))
    return rep


if __name__ == "__main__":
    main()
