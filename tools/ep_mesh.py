"""Expert parallelism and the sharded model path on a mesh of cards over
NCCL: one process per card, a ("data", "model") mesh, every sharded
result held against the single-device path on the rank's own card.

    PYTHONPATH=src python tools/ep_mesh.py                 # 4 cards, (2, 2), OLMoE
    PYTHONPATH=src python tools/ep_mesh.py --device cpu --arch olmoe-mini   # 4 gloo processes
    PYTHONPATH=src python tools/ep_mesh.py --arch zamba2-7b --fp32-layers 6 --layers 12

Needs one card per rank (MESH: 2 x 2). Every rank runs:

(a) the expert-parallel MoE layer at the arch's MoE width, 4 x 128 tokens
    (rows over "data"), zero_drop: ``apply_moe_sharded`` against
    ``apply_moe_local`` on the rank's card, fp32 (MOE_FP32_REL) and bf16
    (BF16_REL); ``moe_gmm`` launches by route. For an arch with Mamba2
    blocks, also its mixer head-parallel over "model"
    (``mamba2.apply_mamba_sharded``) against the local mixer: a prefill of
    4 x 128 tokens and DECODE steps from the state it returns, y and the
    state of every step, fp32 within MOE_FP32_REL, bf16 within BF16_REL;
    ``ssd_scan`` launches by route;
(b) fp32, the arch at full width cut to ``--fp32-layers`` layers (weights from
    seed 0, the same on every rank): a sharded prefill of 4 x 128 tokens
    and DECODE greedy decode steps against the single-device run (equal
    tokens, prefill logits within FP32_REL), and the MELINOE train step's
    loss and gradients against the single-device step, both under the
    trainer's kernel spec (loss within LOSS_REL; each leaf's gradient
    within GRAD_REL of its largest element; grad_norm within GRAD_REL),
    with the card's ``memory_allocated`` before the sharded step and its
    ``max_memory_allocated`` during it (the rank's peak). Both zero_drop: the sharded MoE sizes its capacity from each rank's
    own tokens (the reference's rule), so where the capacity drops tokens
    the two paths drop different ones by design;
(c) bf16 at full depth (or cut to ``--layers``): the sharded prefill and
    DECODE greedy decode steps, timed, with the kernel launches by op and
    route counted from 0 just before it (``moe_gmm`` in the expert-parallel
    body, ``flash_attn`` shard by shard in the prefill and ``ssd_scan`` on
    each rank's heads must launch on a card where the arch has such
    layers).

Prints each rank's report as JSON, then a summary line; exits non-zero
when any gate fails. ``--out PATH`` also writes the reports there.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

MOE_FP32_REL, BF16_REL = 1e-5, 2e-2
FP32_REL, LOSS_REL, GRAD_REL = 1e-4, 1e-5, 1e-4
FP32_LAYERS = 2
DECODE = 8
BATCH, PROMPT = 4, 128
LIMIT_S = 900
MESH = (2, 2)  # ("data", "model")
CPU_THREADS = 2  # a rank, on the CPU


def _rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).norm() / b.norm()).item()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _cut(arch: str, layers):
    """``arch``'s config cut to its first ``layers`` layers (None: whole),
    whole repeats of its layout groups in order."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers is None:
        return cfg
    groups, left = [], layers
    for g in cfg.layout:
        r = min(g.repeats, left // len(g.pattern))
        if r:
            groups.append(dataclasses.replace(g, repeats=r))
            left -= r * len(g.pattern)
    if left:
        raise ValueError(f"{arch}: {layers} layers is not whole repeats of "
                         f"{[(g.pattern, g.repeats) for g in cfg.layout]}")
    return dataclasses.replace(cfg, name=f"{arch}-{layers}l", layout=tuple(groups))


def _kinds(cfg) -> set:
    return {cfg.block_defs[b].kind for g in cfg.layout for b in g.pattern}


def _mamba_layer(cfg, mesh, dev) -> dict:
    """(a) for a Mamba2 arch: its mixer head-parallel against the local one."""
    from repro_torch.distributed.sharding import distribute, leaf_spec
    from repro_torch.kernels import dispatch
    from repro_torch.models import mamba2
    from repro_torch.models.runtime import Runtime

    spec = next(b.ssm for b in cfg.block_defs.values() if b.kind == "mamba")
    d, rows = cfg.d_model, ("data", None, None)
    rt, one = Runtime(device=dev, mesh=mesh), Runtime(device=dev)
    out = {}
    for dtype, tol in ((torch.float32, MOE_FP32_REL), (torch.bfloat16, BF16_REL)):
        gen = torch.Generator(device=dev).manual_seed(0)
        p = mamba2.init_mamba(d, spec, dtype, generator=gen, device=dev)
        for k in ("norm_w", "conv_b"):  # zeros at init: a wrong slice would not show
            p[k] = (0.1 * torch.randn(p[k].shape, generator=gen, device=dev)).to(dtype)
        x = torch.randn((BATCH, PROMPT, d), generator=gen, device=dev).to(dtype)
        xs = [torch.randn((BATCH, 1, d), generator=gen, device=dev).to(dtype)
              for _ in range(DECODE)]
        with torch.no_grad():
            want = [mamba2.apply_mamba_full(p, x, spec, return_state=True, rt=one)]
            for xt in xs:
                want.append(mamba2.apply_mamba_decode(p, xt, want[-1][1], spec))
            dp = {k: distribute(v, rt.prune_spec(v.shape, leaf_spec(
                f"mixer/{k}", v, fsdp=False, data_axes=rt.data_axes)), mesh)
                for k, v in p.items()}
            _sync(dev)
            dispatch.reset_launches()
            t0 = time.perf_counter()
            with rt.dist():
                got = [mamba2.apply_mamba_full(dp, distribute(x, rows, mesh), spec,
                                               return_state=True, rt=rt)]
                routes = dict(dispatch.ROUTE_LAUNCHES["ssd_scan"])
                for xt in xs:
                    got.append(mamba2.apply_mamba_decode(dp, distribute(xt, rows, mesh),
                                                         got[-1][1], spec, rt=rt))
                rel = [max(_rel(_full(gy), wy), *(_rel(_full(g), w) for g, w in zip(gs, ws)))
                       for (gy, gs), (wy, ws) in zip(got, want)]
            _sync(dev)
        out[str(dtype).replace("torch.", "")] = {
            "rel_prefill": rel[0], "rel_decode_worst": max(rel[1:]), "tol": tol,
            "s": time.perf_counter() - t0, "ssd_scan_routes": routes}
    return out


def _grads(tree, path=""):
    """(path, whole gradient) of a gradient tree, per-repeat lists stacked."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _grads(v, f"{path}/{k}")
    elif tree is not None:
        yield path, (torch.stack([_full(x) for x in tree]) if isinstance(tree, list)
                     else _full(tree)).detach().cpu()


def _serve(cfg, params, rt, toks, steps: int) -> dict:
    """A prefill of ``toks`` and ``steps`` greedy decode steps, timed."""
    from repro_torch.launch.steps import build_decode_step, build_prefill_step

    with torch.no_grad():
        _sync(toks.device)
        t0 = time.perf_counter()
        logits, cache = build_prefill_step(cfg, rt, n_slots=toks.shape[1] + steps)(
            params, {"tokens": toks})
        first = _full(logits)
        _sync(toks.device)
        t1 = time.perf_counter()
        out = [first.argmax(-1)]
        dec = build_decode_step(cfg, rt)
        for _ in range(steps):
            logits, cache = dec(params, {"tokens": out[-1], "cache": cache})
            out.append(_full(logits).argmax(-1))
        _sync(toks.device)
    return {"prefill_logits": first[:, 0].float().cpu(), "tokens": torch.cat(out, 1).cpu(),
            "prefill_s": t1 - t0, "decode_tok_s": toks.shape[0] * steps / (
                time.perf_counter() - t1)}


def _worker(rank: int, args, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    world = MESH[0] * MESH[1]
    cuda = args.device == "cuda"
    dev = torch.device(f"cuda:{rank}" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(CPU_THREADS)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.configs import get_config
        from repro_torch.distributed.sharding import distribute, distribute_params
        from repro_torch.kernels import dispatch
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.launch.steps import build_train_step
        from repro_torch.models.model import init_params
        from repro_torch.models.moe import apply_moe_local, apply_moe_sharded, init_moe
        from repro_torch.models.runtime import Runtime
        from repro_torch.training.optim import OptConfig
        from repro_torch.training.trainer import TRAIN_KERNEL_BACKEND

        mesh = make_debug_mesh(*MESH, device_type=dev.type)
        cfg = get_config(args.arch)
        rep = {"rank": rank, "device": str(dev)}
        t_worker = time.perf_counter()

        # ---- (a) the expert-parallel MoE layer; the head-parallel Mamba2 mixer
        spec, d = cfg.moe_spec, cfg.d_model
        zrt = Runtime(device=dev, mesh=mesh, zero_drop=True)
        rep["moe"] = {}
        if "mamba" in _kinds(cfg):
            rep["mamba"] = _mamba_layer(cfg, mesh, dev)
        for dtype, tol in ((torch.float32, MOE_FP32_REL), (torch.bfloat16, BF16_REL)):
            if spec is None:
                break
            gen = torch.Generator(device=dev).manual_seed(0)
            p = init_moe(d, spec, dtype, generator=gen, device=dev)
            x = torch.randn((BATCH * PROMPT, d), generator=gen, device=dev).to(dtype)
            with torch.no_grad():
                y_loc, _ = apply_moe_local(p, x, spec, zrt.local())
                dp = {"router": distribute(p["router"], (None, None), mesh),
                      **{k: distribute(p[k], ("model", None, None), mesh)
                         for k in ("wg", "wu", "wd")}}
                dx = distribute(x, ("data", None), mesh)
                _sync(dev)
                dispatch.reset_launches()
                t0 = time.perf_counter()
                with zrt.dist():
                    y, _ = apply_moe_sharded(dp, dx, spec, zrt)
                _sync(dev)
                s = time.perf_counter() - t0
                routes = dict(dispatch.ROUTE_LAUNCHES["moe_gmm"])
                rep["moe"][str(dtype).replace("torch.", "")] = {
                    "rel": _rel(y.full_tensor(), y_loc), "tol": tol, "s": s,
                    "moe_gmm_routes": routes}

        # ---- (b) fp32, the first layers: serve and the train step's gradients
        cut = _cut(args.arch, args.fp32_layers)
        toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, PROMPT)),
                               device=dev)
        params = init_params(cut, generator=torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.float32, device=dev)
        single = Runtime(kernel_backend=TRAIN_KERNEL_BACKEND, device=dev, zero_drop=True)
        sharded = Runtime(kernel_backend=TRAIN_KERNEL_BACKEND, device=dev, mesh=mesh,
                          zero_drop=True)
        dparams = distribute_params(params, cut, sharded)
        one, many = (_serve(cut, p, rt, toks, DECODE)
                     for p, rt in ((params, single), (dparams, sharded)))
        rep["serve_fp32"] = {
            "tokens_equal": bool(torch.equal(one["tokens"], many["tokens"])),
            "logits_rel": _rel(many["prefill_logits"], one["prefill_logits"])}
        batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab, (BATCH, PROMPT))}
        batch["labels"] = batch["tokens"]
        oc = OptConfig(peak_lr=1e-3, total_steps=10)
        l1, _, g1 = build_train_step(cut, single, oc, melinoe=True).loss_and_grads(params, batch)
        _sync(dev)
        if cuda:  # the sharded step's peak above what is allocated before it
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        l2, _, g2 = build_train_step(cut, sharded, oc, melinoe=True).loss_and_grads(
            dparams, batch)
        _sync(dev)
        step_s = time.perf_counter() - t0
        mem = ({"allocated_before_bytes": before,
                "max_allocated_bytes": torch.cuda.max_memory_allocated(dev)} if cuda else {})
        g1, g2 = dict(_grads(g1)), dict(_grads(g2))
        rel = {k: ((g2[k] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
               for k, g in g1.items()}
        gn1, gn2 = (math.sqrt(sum(float(g.double().square().sum()) for g in t.values()))
                    for t in (g1, g2))
        worst = max(rel, key=rel.get)
        loss1, loss2 = l1.item(), _full(l2).item()
        rep["train_fp32"] = {"loss_rel": abs(loss2 - loss1) / abs(loss1),
                             "grad_rel_worst_leaf": rel[worst], "worst_leaf": worst,
                             "grad_norm_rel": abs(gn2 - gn1) / gn1,
                             "leaves_equal": sorted(g1) == sorted(g2),
                             "loss_and_grads_s": step_s, **mem}
        del params, dparams, g1, g2
        if cuda:
            torch.cuda.empty_cache()

        # ---- (c) bf16 at full depth, the kernels counted from 0
        cfg = _cut(args.arch, args.layers)
        params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.bfloat16, device=dev)
        rt = Runtime(device=dev, mesh=mesh)
        dparams = distribute_params(params, cfg, rt)
        del params
        if cuda:
            torch.cuda.empty_cache()
        dispatch.reset_launches()
        bf = _serve(cfg, dparams, rt, toks, DECODE)
        rep["serve_bf16"] = {
            "layers": sum(len(g.pattern) * g.repeats for g in cfg.layout),
            "kinds": sorted(_kinds(cfg)),
            "prefill_s": bf["prefill_s"], "decode_tok_s": bf["decode_tok_s"],
            "finite": bool(torch.isfinite(bf["prefill_logits"]).all()),
            "tokens_shape": list(bf["tokens"].shape),
            "launches": {op: dict(r) for op, r in dispatch.ROUTE_LAUNCHES.items() if r},
            "max_memory_gib": (torch.cuda.max_memory_allocated(dev) / 2**30 if cuda
                               else None)}
        rep["worker_s"] = time.perf_counter() - t_worker
        reps = [None] * world
        dist.all_gather_object(reps, rep)
        if rank == 0:
            Path(out_dir, "ep_mesh.json").write_text(json.dumps(reps))
    finally:
        dist.destroy_process_group()


def _failures(r: dict, cuda: bool) -> list:
    bad = []
    for name, m in r.get("mamba", {}).items():
        want = {"tc": 1} if name == "bfloat16" else {"fma": 1}
        if not (m["rel_prefill"] <= m["tol"] and m["rel_decode_worst"] <= m["tol"]) or (
                cuda and m["ssd_scan_routes"] != want):
            bad.append(("mamba", name, m))
    for name, m in r["moe"].items():
        if not m["rel"] <= m["tol"] or (cuda and sum(m["moe_gmm_routes"].values()) <= 0):
            bad.append(("moe", name, m))
    if cuda and r["moe"] and set(r["moe"]["bfloat16"]["moe_gmm_routes"]) != {"tc"}:
        bad.append(("moe bf16 routes", r["moe"]["bfloat16"]["moe_gmm_routes"]))
    s, t, b = r["serve_fp32"], r["train_fp32"], r["serve_bf16"]
    # the kernels each kind of layer launches in the bf16 serve
    need = {"attn_moe": "moe_gmm", "mamba": "ssd_scan"}
    ops = {need[k] for k in b["kinds"] if k in need} | (
        {"flash_attn"} if set(b["kinds"]) - {"mamba"} else set())
    if not (s["tokens_equal"] and s["logits_rel"] <= FP32_REL):
        bad.append(("serve fp32", s))
    if not (t["leaves_equal"] and t["loss_rel"] <= LOSS_REL
            and t["grad_rel_worst_leaf"] <= GRAD_REL and t["grad_norm_rel"] <= GRAD_REL):
        bad.append(("train fp32", t))
    if not (b["finite"] and b["tokens_shape"] == [BATCH, DECODE + 1]) or (cuda and not all(
            b["launches"].get(op) for op in ops)):
        bad.append(("serve bf16", b))
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmoe")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="also write the reports here (JSON)")
    ap.add_argument("--fp32-layers", type=int, default=FP32_LAYERS,
                    help="depth of (b), whole repeats of the layout")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth of (c) (default: the arch's whole depth)")
    args = ap.parse_args(argv)
    world = MESH[0] * MESH[1]
    cuda = args.device == "cuda"
    if cuda:
        if torch.cuda.device_count() < world:
            raise SystemExit(f"ep_mesh: {world} ranks need {world} cards, "
                             f"{torch.cuda.device_count()} visible")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        _build.lib()  # once, before the ranks load it
        print(f"kernel build and load: {time.perf_counter() - t0:.1f} s")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ctx = torch.multiprocessing.start_processes(
            _worker, args=(args, port, d), nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t0 > LIMIT_S:
                    raise TimeoutError(f"ep_mesh: the ranks took over {LIMIT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        reps = json.loads(Path(d, "ep_mesh.json").read_text())
    for r in reps:
        print(f"rank {r['rank']}:", json.dumps(r))
    bad = [(r["rank"], *f) for r in reps for f in _failures(r, cuda)]
    r0 = reps[0]
    summary = {"arch": args.arch, "mesh": list(MESH), "device": args.device,
               "moe_rel": {k: v["rel"] for k, v in r0["moe"].items()},
               "mamba": r0.get("mamba"),
               "moe_gmm_routes": {k: v["moe_gmm_routes"] for k, v in r0["moe"].items()},
               "serve_fp32": r0["serve_fp32"], "train_fp32": r0["train_fp32"],
               "serve_bf16": r0["serve_bf16"], "wall_s": time.perf_counter() - t0,
               "ok": not bad}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"ranks": reps, "summary": summary}, indent=1))
    print(json.dumps(summary))
    if bad:
        print(f"ep_mesh: failed: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
