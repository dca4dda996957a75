"""Device time of each CUDA kernel that one call of a port op launches, on
one card, at the main path's shapes (bf16).

    python tools/kernel_profile.py [--reps 20]

Runs ``int4_matmul`` (decode x(4, K) and prefill x(512, K), both olmoe
widths, group 32) and ``ssd_scan`` (zamba2-7b's and mamba2-130m's prefill
shapes) ``--reps`` times each under ``torch.profiler`` and prints, per
case, one JSON line: every kernel name with its mean device microseconds
per call, and their sum. A route that starts several kernels
(``int4_matmul`` "stream": the split-K stream and the split reduction;
``ssd_scan`` "tc": chunk states, state pass, chunk outputs) shows each.
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def profile(fn, reps: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = getattr(evt, "cuda_time_total", 0)
        if total > 0 and evt.count:
            out[evt.key[:120]] = total / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_profile: needs a CUDA card")
    from repro_torch.kernels import _build
    from repro_torch.kernels.int4_matmul import int4_matmul_hopper, quantize_matmul_weight
    from repro_torch.kernels.ssd_scan import ssd_hopper

    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    cases = []
    for M, K, N in ((4, 2048, 1024), (4, 1024, 2048), (512, 2048, 1024), (512, 1024, 2048)):
        x = torch.randn(M, K, generator=gen, device="cuda").to(bf16)
        p, s, z, _ = quantize_matmul_weight(
            torch.randn(K, N, generator=gen, device="cuda") * K**-0.5, 32)
        cases.append((f"int4 x({M},{K}) w({K},{N}) g32",
                      lambda x=x, p=p, s=s, z=z: int4_matmul_hopper(x, p, s, z, 32)))
    for B, T, H, P, N in ((4, 512, 112, 64, 64), (4, 512, 24, 64, 128)):
        x = torch.randn(B, T, H, P, generator=gen, device="cuda").to(bf16)
        dt = torch.nn.functional.softplus(
            torch.randn(B, T, H, generator=gen, device="cuda") * 0.5 - 4.6)
        A = -torch.linspace(1.0, 16.0, H, device="cuda")
        Bm = torch.randn(B, T, 1, N, generator=gen, device="cuda").to(bf16)
        Cm = torch.randn(B, T, 1, N, generator=gen, device="cuda").to(bf16)
        D = torch.ones(H, device="cuda")
        cases.append((f"ssd x({B},{T},{H},{P}) N{N}",
                      lambda x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, D=D:
                      ssd_hopper(x, dt, A, Bm, Cm, D=D)))
    print(torch.cuda.get_device_name(0))
    for name, fn in cases:
        us = profile(fn, args.reps)
        print(json.dumps({"case": name, "kernels_us": us,
                          "sum_us": sum(us.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
