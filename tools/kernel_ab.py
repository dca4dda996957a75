"""A/B the compile-time configuration of the port's Hopper kernels on one
card.

    python tools/kernel_ab.py \
        --variant 'k4:flash_attn/csrc/flash_attn_tc.cu:launch_cfg<HD, 2, 64, 2>=>launch_cfg<HD, 1, 64, 4>'
    python tools/kernel_ab.py --gates \
        --variant 'hi:ssd_scan/csrc/ssd_scan_tc.cu:SPLIT = true=>SPLIT = false'

A variant is NAME:SOURCE:OLD=>NEW[;;OLD=>NEW...]: a copy of the port in
which each OLD text of ``src/repro_torch/kernels/SOURCE`` is replaced by
NEW (it must occur), built into its own kernel library. The tree as it
is runs as ``base``. Each version runs in its own process, in turns
(base, v1, ..., vn, vn, ..., v1, base), and times every kernel in bf16 at
the main path's shapes with ``chip_smoke.time_ms`` (CUDA graphs: device
time): ``flash_attn`` and ``moe_gmm`` beside the library call (SDPA,
``torch.bmm``), ``int4_matmul`` at decode and prefill beside ``torch.matmul``
on the dequantized weight, ``ssd_scan`` at zamba2-7b's and mamba2-130m's
prefill shapes, each after checking its output against the plain version
with chip_smoke's tolerance. ``--gates`` also reads, in the first turn of
each version, the serve gates that a change of rounding can move: the
zamba2-7b bf16 prefill logits (kernel vs plain, and the ratio of its
distance from fp32 to the plain run's) and the olmoe INT4 prefill logits
(kernel vs plain on the same codes), printed, not enforced. One JSON line
per run. Needs a card; the copies and their libraries go under
``src/repro_torch/kernels/build/ab/``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
AB_DIR = ROOT / "src" / "repro_torch" / "kernels" / "build" / "ab"


def make_variant(spec: str) -> tuple:
    name, source, subs = spec.split(":", 2)
    dest = AB_DIR / name
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dest / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = dest / "src" / "repro_torch" / "kernels" / source
    text = path.read_text()
    for sub in subs.split(";;"):
        old, new = sub.split("=>")
        if old not in text:
            raise SystemExit(f"{name}: {old!r} not in {source}")
        text = text.replace(old, new)
    path.write_text(text)
    return name, dest / "src"


def gates(cs) -> dict:
    """The serve readings that rounding inside a kernel moves, without
    their limits enforced (a variant may be the one that fails them)."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import run

    out = {}
    try:
        rep = cs.serve_full("zamba2-7b", n_ssd=68, n_flash=13)
        out["zamba2_logits_rel"] = rep["logits_rel"]
        out["zamba2_vs_fp32_ratio"] = rep["kernel_vs_fp32_rel"] / rep["bf16_roundoff_rel"]
    except AssertionError as e:  # the reading was printed before the check
        out["zamba2_failed"] = str(e)
    kw = dict(capacity=16, policy="gamma", batch=4, prompt_len=128,
              dtype=torch.bfloat16, device="cuda", seed=0, quantized=True)
    dispatch.reset_launches()
    q = run("olmoe", max_new=1, keep_store=True, **kw)
    r = run("olmoe", max_new=1, kernel_backend="ref",
            quantized_experts=q.pop("quantized_experts"), **kw)
    a, b = q["prefill_logits"].float(), r["prefill_logits"].float()
    out["int4_logits_rel"] = ((a - b).norm() / b.norm()).item()
    return out


def child(src: str, tag: str, with_library: bool, with_gates: bool) -> None:
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    # the version under test first: chip_smoke puts the tree's own src/
    # on the path when it is imported
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import attention_ref, flash_hopper
    from repro_torch.kernels.int4_matmul import (dequant_ref, int4_matmul_hopper,
                                                 int4_matmul_ref, quantize_matmul_weight)
    from repro_torch.kernels.moe_gmm import gmm_hopper, gmm_ref
    from repro_torch.kernels.ssd_scan import ssd_hopper, ssd_scan_ref
    import chip_smoke as cs

    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    out = {"tag": tag, "kernels": str(_build.KERNELS_DIR.relative_to(ROOT))}
    for B, T, H, hd in ((4, 512, 32, 112), (4, 128, 16, 128)):
        q = torch.randn(B, T, H, 1, hd, generator=gen, device="cuda").to(bf16)
        k = torch.randn(B, T, H, hd, generator=gen, device="cuda").to(bf16)
        v = torch.randn(B, T, H, hd, generator=gen, device="cuda").to(bf16)
        cs.check(tag, flash_hopper(q, k, v), attention_ref(q, k, v), cs.TOL[bf16])
        row = {"ms": cs.time_ms(lambda: flash_hopper(q, k, v), reps=50)}
        if with_library:
            qs, ks, vs = (x.reshape(B, T, H, hd).transpose(1, 2).contiguous()
                          for x in (q, k, v))
            row["sdpa_ms"] = cs.time_ms(lambda: sdpa(qs, ks, vs, is_causal=True), reps=50)
        out[f"flash B{B} T{T} Hkv{H} hd{hd}"] = row
    for M, K, N in ((4, 2048, 1024), (512, 2048, 1024)):
        a = torch.randn(16, M, K, generator=gen, device="cuda").to(bf16)
        b = (torch.randn(16, K, N, generator=gen, device="cuda") * K**-0.5).to(bf16)
        sizes = torch.full((16,), M, dtype=torch.int32, device="cuda")
        cs.check(tag, gmm_hopper(a, b, sizes), gmm_ref(a, b), cs.TOL[bf16])
        row = {"ms": cs.time_ms(lambda: gmm_hopper(a, b, sizes), reps=50)}
        if with_library:
            row["bmm_ms"] = cs.time_ms(lambda: torch.bmm(a, b), reps=50)
        out[f"gmm a(16,{M},{K}) b(16,{K},{N}) every row"] = row
    for M, K, N in ((4, 2048, 1024), (4, 1024, 2048), (512, 2048, 1024),
                    (512, 1024, 2048)):
        x = torch.randn(M, K, generator=gen, device="cuda").to(bf16)
        w = torch.randn(K, N, generator=gen, device="cuda") * K**-0.5
        p, sc, z, _ = quantize_matmul_weight(w, 32)
        ref = int4_matmul_ref(x, p, sc, z, 32)
        row = {"max_abs_err": cs.check(tag, int4_matmul_hopper(x, p, sc, z, 32), ref,
                                       cs.TOL[bf16]),
               "ms": cs.time_ms(lambda: int4_matmul_hopper(x, p, sc, z, 32), reps=50)}
        if with_library:
            wd = dequant_ref(p, sc, z, 32).to(bf16)
            row["matmul_ms"] = cs.time_ms(lambda: torch.matmul(x, wd), reps=50)
        out[f"int4 x({M},{K}) w({K},{N}) g32"] = row
    for B, T, H, P, N in ((4, 512, 112, 64, 64), (4, 512, 24, 64, 128)):
        x = torch.randn(B, T, H, P, generator=gen, device="cuda").to(bf16)
        dt = torch.nn.functional.softplus(
            torch.randn(B, T, H, generator=gen, device="cuda") * 0.5 - 4.6)
        A = -torch.linspace(1.0, 16.0, H, device="cuda")
        Bm = torch.randn(B, T, 1, N, generator=gen, device="cuda").to(bf16)
        Cm = torch.randn(B, T, 1, N, generator=gen, device="cuda").to(bf16)
        D = torch.ones(H, device="cuda")
        y, _ = ssd_hopper(x, dt, A, Bm, Cm, D=D)
        yr, _ = ssd_scan_ref(x, dt, A, Bm, Cm, D=D)
        out[f"ssd x({B},{T},{H},{P}) N{N}"] = {
            "max_abs_err": cs.check(tag, y, yr, cs.TOL_SSD[bf16]),
            "ms": cs.time_ms(lambda: ssd_hopper(x, dt, A, Bm, Cm, D=D), reps=50)}
    if with_gates:
        out["gates"] = gates(cs)
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--child", nargs=2, metavar=("SRC", "TAG"), help=argparse.SUPPRESS)
    ap.add_argument("--gates", action="store_true",
                    help="also read the zamba2 and INT4 logits gates (first turn)")
    ap.add_argument("--library", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--child-gates", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(*args.child, args.library, args.child_gates)
        return 0
    versions = [("base", ROOT / "src")] + [make_variant(v) for v in args.variant]
    order = versions + versions[::-1]
    for i, (name, src) in enumerate(order):
        cmd = [sys.executable, __file__, "--child", str(src), name]
        if name == "base":
            cmd.append("--library")
        if args.gates and i < len(versions):
            cmd.append("--child-gates")
        subprocess.run(cmd, check=True, env={**os.environ, "PYTHONPATH": str(src)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
