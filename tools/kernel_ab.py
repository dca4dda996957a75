"""A/B the compile-time configuration of the port's Hopper kernels on one
card.

    python tools/kernel_ab.py \
        --variant 'k4:flash_attn/csrc/flash_attn_tc.cu:launch_cfg<HD, 2, 64, 2>=>launch_cfg<HD, 1, 64, 4>'

A variant is NAME:SOURCE:OLD=>NEW[;;OLD=>NEW...]: a copy of the port in
which each OLD text of ``src/repro_torch/kernels/SOURCE`` is replaced by
NEW (it must occur), built into its own kernel library. The tree as it
is runs as ``base``. Each version runs in its own process, in turns
(base, v1, ..., vn, vn, ..., v1, base), and times ``flash_attn`` and
``moe_gmm`` in bf16 at the main path's shapes with ``chip_smoke.time_ms``
(CUDA graphs: device time), beside the library call (SDPA, ``torch.bmm``),
after checking each output against the plain version with chip_smoke's
tolerance. One JSON line per run. Needs a card; the copies and their
libraries go under ``src/repro_torch/kernels/build/ab/``.
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


def child(src: str, tag: str, with_library: bool) -> None:
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    # the version under test first: chip_smoke puts the tree's own src/
    # on the path when it is imported
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import attention_ref, flash_hopper
    from repro_torch.kernels.moe_gmm import gmm_hopper, gmm_ref
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
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--child", nargs=2, metavar=("SRC", "TAG"), help=argparse.SUPPRESS)
    ap.add_argument("--library", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(*args.child, args.library)
        return 0
    versions = [("base", ROOT / "src")] + [make_variant(v) for v in args.variant]
    order = versions + versions[::-1]
    for name, src in order:
        cmd = [sys.executable, __file__, "--child", str(src), name]
        if name == "base":
            cmd.append("--library")
        subprocess.run(cmd, check=True, env={**os.environ, "PYTHONPATH": str(src)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
