"""Seconds to build the little-expert bank's rank-r factors on one card,
by the two routes that give the same truncation, at OLMoE-1B-7B's shapes.

    python tools/bank_truncation.py [--rank 8] [--svd-experts 4]

For one projection of 64 experts (wg: (64, 2048, 1024), wd:
(64, 1024, 2048); random bf16 weights from seed 0, as chip_smoke draws
them) it times ``core.little_expert.truncate`` (an fp64 eigendecomposition
of each weight's smaller Gram matrix, the route the bank takes) and
``torch.linalg.svd`` in fp32 (the reference's route, on ``--svd-experts``
experts, scaled to 64), and holds both truncations against an fp64 SVD of
two experts (||delta|| / ||ref||). Prints the card's name and power limit,
then one JSON line. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    import torch

    from repro_torch.core.little_expert import truncate

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--svd-experts", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bank_truncation: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    g = torch.Generator(device="cuda").manual_seed(0)
    E, d, f, r = 64, 2048, 1024, args.rank
    out = {"rank": r, "experts": E}

    def timed(fn):
        fn()  # warm-up: the solver's workspace and handles
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    for name, shape in (("wg", (E, d, f)), ("wd", (E, f, d))):
        w = torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16) * 0.02
        t_eigh, (left, right) = timed(lambda: truncate(w, r))
        n = args.svd_experts
        t_svd, _ = timed(lambda: torch.linalg.svd(w[:n].float(), full_matrices=False))
        u, s, vt = torch.linalg.svd(w[:2].double(), full_matrices=False)
        want = (u[..., :r] * s[..., None, :r]) @ vt[..., :r, :]
        u32, s32, vt32 = torch.linalg.svd(w[:2].float(), full_matrices=False)
        svd32 = ((u32[..., :r] * s32[..., None, :r]) @ vt32[..., :r, :]).double()
        out[name] = {
            "shape": list(shape), "eigh_route_s": t_eigh, "svd_fp32_s": t_svd * E / n,
            "eigh_route_rel": ((left[:2] @ right[:2]).double() - want).norm().item()
            / want.norm().item(),
            "svd_fp32_rel": (svd32 - want).norm().item() / want.norm().item()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
