"""Host microseconds a call of the kernel wrappers on the card, at chip
smoke's decode cases (and its main prefill attention case), and of the
same wrappers behind a ``torch.library.custom_op`` with a registered fake
implementation: what reaching the kernels' shape functions through
PyTorch's custom-op machinery would add to every launch, against the
fake-tensor check each wrapper makes instead.

    python3 tools/fake_op_cost.py [--src DIR] [--custom-op]

``--src``: the ``src`` directory to import ``repro_torch`` from (another
checkout's, to compare two trees in one call); ``--custom-op``: time the
custom-op form too. Each time is the median over 7 runs of 200
back-to-back calls on the host's clock, the device synchronized only
between runs (the wrappers enqueue and return; 200 calls stay inside
the launch queue). Prints one JSON line.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def host_us(fn, calls: int = 200, runs: int = 7) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--custom-op", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fake_op_cost: needs a CUDA device")
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import flash_hopper
    from repro_torch.kernels.int4_matmul import int4_matmul_hopper, quantize_matmul_weight
    from repro_torch.kernels.moe_gmm import gmm_hopper

    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    a = torch.randn(16, 4, 2048, generator=gen, device="cuda").to(bf)
    b = (torch.randn(16, 2048, 1024, generator=gen, device="cuda") * 2048**-0.5).to(bf)
    sizes = torch.full((16,), 4, dtype=torch.int32, device="cuda")
    x = torch.randn(4, 2048, generator=gen, device="cuda").to(bf)
    q = quantize_matmul_weight(torch.randn(2048, 1024, generator=gen, device="cuda") * 0.02, 32)
    qq = torch.randn(4, 128, 16, 1, 128, generator=gen, device="cuda").to(bf)
    kk = torch.randn(4, 128, 16, 128, generator=gen, device="cuda").to(bf)
    cases = {
        "gmm bf16 a(16,4,2048) b(16,2048,1024)": lambda: gmm_hopper(a, b, sizes),
        "int4 bf16 x(4,2048) w(2048,1024) g32":
            lambda: int4_matmul_hopper(x, q.packed, q.scale, q.zero, 32),
        "flash bf16 B4 T128 Hkv16 G1 hd128": lambda: flash_hopper(qq, kk, kk),
    }
    out = {"src": args.src, "wrapper_us": {k: host_us(f) for k, f in cases.items()}}
    if args.custom_op:
        @torch.library.custom_op("fake_op_cost::gmm", mutates_args=())
        def gmm_op(a: torch.Tensor, b: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
            return gmm_hopper(a, b, sizes)

        @gmm_op.register_fake
        def _(a, b, sizes):
            return a.new_empty(a.shape[0], a.shape[1], b.shape[2])

        @torch.library.custom_op("fake_op_cost::int4", mutates_args=())
        def int4_op(x: torch.Tensor, p: torch.Tensor, s: torch.Tensor, z: torch.Tensor,
                    group: int) -> torch.Tensor:
            return int4_matmul_hopper(x, p, s, z, group)

        @int4_op.register_fake
        def _(x, p, s, z, group):
            return x.new_empty(x.shape[0], p.shape[1])

        @torch.library.custom_op("fake_op_cost::flash", mutates_args=())
        def flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
            return flash_hopper(q, k, v)

        @flash_op.register_fake
        def _(q, k, v):
            return torch.empty_like(q)

        ops = {
            "gmm bf16 a(16,4,2048) b(16,2048,1024)": lambda: gmm_op(a, b, sizes),
            "int4 bf16 x(4,2048) w(2048,1024) g32":
                lambda: int4_op(x, q.packed, q.scale, q.zero, 32),
            "flash bf16 B4 T128 Hkv16 G1 hd128": lambda: flash_op(qq, kk, kk),
        }
        out["custom_op_us"] = {k: host_us(f) for k, f in ops.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out.update(card=smi, torch=torch.__version__)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
