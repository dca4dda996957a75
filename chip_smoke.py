"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

From the root of a checkout, with CUDA available:

1. prints the card (``nvidia-smi`` name and power limit) and versions;
2. builds the Hopper kernels from ``src/repro_torch/kernels/*/csrc``;
3. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes, in bf16 and fp32, and times kernel, plain
   version and one library call (a yardstick the port never calls);
4. serves 4 x (128 + 32) tokens of full-width OLMoE-1B-7B (random
   weights from a seed) through ``repro_torch.launch.serve.run`` with the
   launch counters set to 0 just before, asserts that both kernels were
   launched on that path, and holds the prefill logits against a run of
   the same prompts through the plain versions (``kernel_backend="ref"``);
5. serves the same batch again with HQQ INT4 experts (``quantized=True``,
   paper Sec 3.2), counters set to 0 just before, asserts that
   ``int4_matmul``, ``moe_gmm`` and ``flash_attn`` were all launched, and
   holds its prefill logits against a plain run on the same INT4 codes;
   the INT4-vs-bf16 logits difference is printed, not gated (it is the
   quantization error);
6. prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Any failure raises (non-zero exit, no result line). Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

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
# prefill logits of the kernel run vs the plain run, both bf16 end to end:
# ||delta|| / ||plain|| over the (B, V) logits. bf16 activations round at
# every layer (2^-8 relative) and the sums run in another order, through
# 16 layers with residual adds.
LOGITS_REL_TOL = 2e-2


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call (CUDA events around ``reps``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def check(name, out, ref, dtype) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), **TOL[dtype]):
        raise AssertionError(f"{name}: kernel disagrees with plain, max abs err {err}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    return err


def gmm_cases(gen):
    from repro_torch.kernels.moe_gmm import gmm_hopper, gmm_ref

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
                label = f"gmm {str(dtype)[6:]} a({E},{N},{K}) b({E},{K},{F})"
                out = gmm_hopper(a, b, sizes)
                ref = gmm_ref(a, b)
                torch.cuda.synchronize()
                err = check(label, out, ref, dtype)
                for e, s in enumerate(sizes.tolist()):  # zero tails exactly zero
                    if out[e, s:].any():
                        raise AssertionError(f"{label}: group {e} tail not zero")
                active = sizes > 0
                rows = int(sizes.sum())
                it = a.element_size()
                nbytes = (rows * K + int(active.sum()) * K * F + E * N * F) * it
                t_bound, by = bound(nbytes, 2.0 * rows * K * F, dtype)
                cases.append({
                    "case": label, "max_abs_err": err, "tol": TOL[dtype],
                    "ms": time_ms(lambda: gmm_hopper(a, b, sizes)),
                    "plain_ms": time_ms(lambda: gmm_ref(a, b)),
                    "library_ms": time_ms(lambda: torch.bmm(a, b)),
                    "bound_ms": t_bound, "bound_by": by})
    return cases


def flash_cases(gen):
    from repro_torch.kernels.flash_attn import attention_ref, flash_hopper
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    cases = []
    shapes = [(4, 128, 16, 1, 128, None, None), (4, 100, 16, 1, 128, None, None),
              (4, 128, 8, 2, 64, None, None), (4, 128, 16, 1, 128, 50.0, 32)]
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
            err = check(label, out, ref, dtype)
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
                "case": label, "max_abs_err": err, "tol": TOL[dtype],
                "ms": time_ms(lambda: flash_hopper(q, k, v, softcap=cap, window=win)),
                "plain_ms": time_ms(lambda: attention_ref(q, k, v, softcap=cap,
                                                          window=win)),
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
            err = check(label, out, ref, dtype)
            it = x.element_size()
            nbytes = M * K * it + p.numel() + 4 * (sc.numel() + z.numel()) + M * N * it
            t_bound, by = bound(nbytes, 2.0 * M * K * N, dtype)
            w_deq = dequant_ref(p, sc, z, g).to(dtype)  # for the matmul-only yardstick
            cases.append({
                "case": label, "max_abs_err": err, "tol": TOL[dtype],
                "ms": time_ms(lambda: int4_matmul_hopper(x, p, sc, z, g)),
                "plain_ms": time_ms(lambda: int4_matmul_ref(x, p, sc, z, g)),
                "library_ms": time_ms(lambda: torch.matmul(x, w_deq)),
                "library": "torch.matmul on a pre-dequantized weight (matmul only, "
                           "no dequant)",
                "bound_ms": t_bound, "bound_by": by})
    return cases


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
                            for p, s, z in mats], reps=5, warmup=1)


def kernel_entry(name, source, replaces, cases, main_case, launches):
    """One line entry: the main-path case's numbers, the worst error over
    every case, and every case beside it."""
    head = next(c for c in cases if c["case"] == main_case)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "tol": head["tol"], "case": main_case, "ms": head["ms"],
            "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "cases": cases}


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

    t0 = time.perf_counter()
    _build.lib()
    print(f"kernel build and load: {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    g_cases = gmm_cases(gen)
    f_cases = flash_cases(gen)
    i_cases = int4_cases(gen)
    for c in g_cases + f_cases + i_cases:
        print(f"  {c['case']}: err {c['max_abs_err']:.3g} kernel {c['ms']:.4f} ms "
              f"plain {c['plain_ms']:.4f} ms bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}) library {c['library_ms']}")

    # ---- the main path: full-width olmoe through the port's serve entry
    serve_kw = dict(capacity=16, policy="gamma", batch=4, prompt_len=128,
                    dtype=torch.bfloat16, device="cuda", seed=0)
    dispatch.reset_launches()
    rep = run("olmoe", max_new=32, **serve_kw)
    launches = dict(dispatch.LAUNCHES)
    for op in ("moe_gmm", "flash_attn"):
        if launches[op] <= 0:
            raise AssertionError(f"main path launched no {op} kernel: {launches}")
    tokens, logits = rep["tokens"], rep["prefill_logits"]
    if tokens.shape != (4, 32) or logits.shape != (4, 50_304):
        raise AssertionError(f"shapes: tokens {tokens.shape} logits {logits.shape}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    print("serve olmoe:", json.dumps({k: v for k, v in rep.items()
                                      if k not in ("tokens", "prefill_logits")}))
    print(f"launches on the main path: {launches}")

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
    for op in ("int4_matmul", "moe_gmm", "flash_attn"):
        if q_launches[op] <= 0:
            raise AssertionError(f"INT4 path launched no {op} kernel: {q_launches}")
    q_logits = qrep["prefill_logits"]
    if qrep["tokens"].shape != (4, 32) or q_logits.shape != (4, 50_304):
        raise AssertionError(f"INT4 shapes: tokens {qrep['tokens'].shape} "
                             f"logits {q_logits.shape}")
    if not torch.isfinite(q_logits).all():
        raise AssertionError("non-finite INT4 prefill logits")
    print("serve olmoe quantized:", json.dumps(
        {k: v for k, v in qrep.items()
         if k not in ("tokens", "prefill_logits", "quantized_experts")}))
    print(f"launches on the INT4 path: {q_launches}")
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

    kernels = [
        kernel_entry("moe_gmm", "src/repro_torch/kernels/moe_gmm/csrc/gmm.cu",
                     "src/repro/kernels/moe_gmm/kernel.py:64", g_cases,
                     "gmm bfloat16 a(16,4,2048) b(16,2048,1024)", launches["moe_gmm"]),
        kernel_entry("flash_attn", "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
                     "src/repro/kernels/flash_attn/kernel.py:80", f_cases,
                     "flash bfloat16 B4 T128 Hkv16 G1 hd128 softcap=None window=None",
                     launches["flash_attn"]),
        kernel_entry("int4_matmul",
                     "src/repro_torch/kernels/int4_matmul/csrc/int4_matmul.cu",
                     "src/repro/kernels/int4_matmul/kernel.py:55", i_cases,
                     "int4 bfloat16 x(4,2048) w(2048,1024) g32",
                     q_launches["int4_matmul"]),
    ]
    for k in kernels:  # launches of each path, each counted from 0
        k["launches_by_path"] = {"bf16": launches[k["name"]],
                                 "int4": q_launches[k["name"]]}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
