"""Serving launcher, PyTorch: offloaded MoE serving (post-deployment
stage, Sec 3.2), or the full-model path with the whole model resident.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe \
        --capacity 16 --policy gamma --batch 4 --prompt-len 128 --max-new 32 \
        [--quantized]
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
either package; read with a like-tree of the config's fp32 shapes, as
the reference does, then cast to ``--dtype``), the slab offload engine
with the cache policy and capacity C, batched greedy generation, then a
report of transfers, hit rate, both Eq.-3 modeled clocks and the
measured prefill seconds and decode tokens/s. ``--quantized`` keeps
every expert in HQQ INT4 (paper Sec 3.2, group 32); the report then
also gives ``quantize_s``, the seconds spent building the INT4 store
(not part of ``prefill_s``). Runs on ``cuda`` unless ``--device cpu``.

``--predictor`` (with ``--n-train-prompts N``) trains the activation
predictor Psi first, as ``repro.launch.serve`` does: the whole model on
the device traces N more prompts of the same stream (``routing_trace``,
16 new tokens each), Psi is fit to their per-layer mean router
distributions, the traced model is freed, and the engine prefetches
Psi's scores for the batch's mean prompt embedding before ``generate``
(``run``'s report keeps them, (L, E), under ``predictor_scores``).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.offload_engine import HardwareProfile, OffloadedMoEEngine
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
from ..training.checkpoint import load_checkpoint


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


def load_params(cfg, ckpt, *, dtype, device):
    """A params-only checkpoint (either package's ``save_checkpoint`` of
    the parameter tree) read with a like-tree of the config's fp32 shapes
    (built on the ``meta`` device: no memory), then through the bridge:
    floating leaves cast to ``dtype`` (the router and SSM constants stay
    fp32), on ``device``. Returns (params, metadata)."""
    like = init_params(cfg, generator=torch.Generator(), dtype=torch.float32,
                       device="meta")
    tree, _, meta = load_checkpoint(ckpt, like)
    return params_from_jax(tree, cfg, dtype=dtype, device=device), meta


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def train_psi(cfg, params, train_prompts, prompts, *, device, kernel_backend="auto",
              predictor_init=None, trace_new: int = 16) -> tuple:
    """The reference launcher's predictor step: trace ``train_prompts``
    through the whole model (a device copy of ``params``, freed before
    this returns), fit Psi (``predictor_init``, else drawn from seed 1) to
    the per-layer mean router distributions, and score the mean
    embedding of ``prompts``. Returns ((L, E) scores, report)."""
    dev = torch.device(device)
    emb = PromptEmbedder(cfg.vocab, device=dev)
    t0 = time.perf_counter()
    traced = _tree_to(params, dev)
    _, probs = routing_trace(cfg, traced, train_prompts, max_new=trace_new,
                             rt=Runtime(kernel_backend=kernel_backend, device=dev,
                                        zero_drop=True))
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
                    "predictor_train_s": time.perf_counter() - t1,
                    "n_train_prompts": len(train_prompts), "predictor_scores": scores}


def run(arch: str, *, capacity: int = 0, policy: str = "gamma", batch: int = 2,
        prompt_len: int = 32, max_new: int = 64, dtype=None, device=None,
        seed: int = 0, kernel_backend: str = "auto", quantized: bool = False,
        quantized_experts=None, keep_store: bool = False, host_store=None,
        ckpt=None, predictor: bool = False, n_train_prompts: int = 32,
        predictor_init=None) -> dict:
    """Build a random-init model (or read ``ckpt``), serve one batch
    through the offloaded engine, and return the report (scalars, plus
    ``tokens`` and the last prompt position's ``prefill_logits``).

    ``keep_store`` puts the engine's pinned expert store into the report
    under ``host_store`` (and, quantized, under ``quantized_experts`` as
    INT4 views); an earlier report's ``host_store`` given back serves
    those experts without drawing or copying them again (the same seed
    gives the same other weights). With ``quantized``,
    ``quantized_experts`` serves those INT4 codes instead of quantizing
    again."""
    cfg = get_config(arch)
    if not cfg.has_router:
        raise ValueError("offloaded serving applies to MoE architectures")
    dev = resolve_device(device)
    dt = cdtype(dtype or cfg.dtype)
    if ckpt is not None:  # the engine moves what it keeps on the device
        params, _ = load_params(cfg, ckpt, dtype=dt, device="cpu")
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        # a model served from host memory keeps its experts there from the
        # start; with a store given they are drawn (the same stream) and dropped
        params = init_params(cfg, generator=gen, dtype=dt, device=dev,
                             expert_device="cpu" if host_store is None else "meta")
    capacity = capacity or cfg.melinoe_cache_capacity()
    # the training prompts continue the batch's stream, as the reference's
    all_prompts = make_prompts(cfg.vocab, batch + (n_train_prompts if predictor else 0),
                               prompt_len)
    prompts = all_prompts[:batch]
    psi = {}
    if predictor:
        if host_store is not None:
            raise ValueError("predictor: the routing trace needs the experts of params")
        scores, psi = train_psi(cfg, params, all_prompts[batch:], prompts, device=dev,
                                kernel_backend=kernel_backend,
                                predictor_init=predictor_init)
    engine = OffloadedMoEEngine(cfg, params, capacity=capacity, policy=policy,
                                quantized=quantized,
                                quantized_experts=quantized_experts,
                                host_store=host_store,
                                hw=HardwareProfile(), kernel_backend=kernel_backend,
                                device=dev)
    del params  # the engine holds the experts in its pinned store
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
        "quantize_s": engine.quantize_s,
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
        print(f"predictor KL {kl[0]:.4f} -> {kl[-1]:.4f}")
    print(f"generated {rep['decode_tokens']} tokens x batch {args.batch} "
          f"on {rep['device_name']}")
    print(f"transfers={rep['transfers']} ({rep['transfers_per_layer']:.1f}/layer), "
          f"prefetch={rep['prefetch_transfers']}")
    print(f"hit rate={rep['hit_rate']:.3f}")
    if rep["quantized"]:
        print(f"INT4 experts: {rep['expert_bytes']} bytes each, store built in "
              f"{rep['quantize_s']:.2f} s")
    print(f"modeled throughput={rep['modeled_tok_s']:.2f} tok/s serial, "
          f"{rep['modeled_overlapped_tok_s']:.2f} overlapped (hw={rep['hw']}, Eq. 3)")
    print(f"measured prefill={rep['prefill_s']:.4f} s, "
          f"decode={rep['decode_tok_s']:.2f} tok/s")
    print(json.dumps({k: v for k, v in rep.items()
                      if k not in ("tokens", "prefill_logits", "predictor_scores")}))
    return rep


if __name__ == "__main__":
    main()
