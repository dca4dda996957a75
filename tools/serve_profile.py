"""Where a full-model serving step spends its time on one card: host wall,
device busy time and kernels per call, for the continuous-batching
server's two steps at full width (bf16, random weights from seed 0).

    python tools/serve_profile.py [--arch olmoe] [--slots 4] \
        [--prompt-len 128] [--reps 10]

``prefill``: one request's prefill (batch 1, ``--prompt-len`` tokens), as
the server admits it. ``decode``: one ``decode_step`` over the server's
slot pool (``--slots`` rows at their own positions). Each runs ``--reps``
times after a warm-up timed on the host to a device synchronize (both
steps before any profiling), then ``--reps`` times under
``torch.profiler``. Prints one JSON line per step: wall ms per
call, device busy ms per call (the sum of its kernels' device time; one
stream, so they do not overlap), the idle share 1 - busy / wall, kernels
per call, and the device ms per call of the heaviest kernels, with the
port's own kernels named by op and route. Needs a card.
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

# the port's own kernels (``__global__`` names in csrc/*.cu) and their routes
PORT_KERNELS = {"gmm_stream_kernel": "moe_gmm (stream)", "gmm_tc_kernel": "moe_gmm (tc)",
                "gmm_kernel": "moe_gmm (fma)", "flash_tc_kernel": "flash_attn (tc)",
                "flash_fwd_kernel": "flash_attn (fma)"}


def wall_ms(fn, reps: int) -> float:
    """Host milliseconds per call, to a device synchronize, after a warm-up."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def device_profile(fn, reps: int) -> dict:
    """Device-side events of ``reps`` calls under ``torch.profiler``: busy
    ms per call, events per call, and the heaviest kernels' ms per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels, n_kernels = {}, 0
    for evt in prof.events():  # device-side events: kernels, copies, sets
        if evt.device_type != DeviceType.CUDA:
            continue
        name = next((op for frag, op in PORT_KERNELS.items() if frag in evt.name),
                    evt.name)[:90]
        kernels[name] = kernels.get(name, 0.0) + evt.time_range.elapsed_us() / reps / 1e3
        n_kernels += 1
    if not n_kernels:
        raise SystemExit("serve_profile: the profiler recorded no device events")
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    return {"device_busy_ms": sum(kernels.values()), "kernels_per_call": n_kernels / reps,
            "top_kernels_ms": top}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmoe")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("serve_profile: needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models.model import decode_step, init_params, prefill
    from repro_torch.serving import ContinuousBatchingServer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    cfg = get_config(args.arch)
    dev = torch.device("cuda")
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    max_len = args.prompt_len + 33
    srv = ContinuousBatchingServer(cfg, params, n_slots=args.slots, max_len=max_len)
    prompt = torch.as_tensor(make_prompts(cfg.vocab, 1, args.prompt_len), dtype=torch.long,
                             device=dev)
    cur = torch.as_tensor(np.arange(args.slots)[:, None], device=dev)

    def one_prefill():
        with torch.inference_mode():
            prefill(params, cfg, prompt, srv.rt, n_slots=max_len)

    def one_decode():
        with torch.inference_mode():
            srv.cache["pos"] = srv.cache["pos"] % args.prompt_len  # stay inside max_len
            decode_step(params, cfg, cur, srv.cache, srv.rt)

    steps = (("prefill", one_prefill), ("decode", one_decode))
    # every host timing before the first profiler session, which may leave
    # the device tracing attached and slow later launches
    walls = {name: wall_ms(fn, args.reps) for name, fn in steps}
    for name, fn in steps:
        prof = device_profile(fn, args.reps)
        print(json.dumps({"arch": args.arch, "step": name, "slots": args.slots,
                          "prompt_len": args.prompt_len, "wall_ms": walls[name],
                          "idle_share": 1.0 - prof["device_busy_ms"] / walls[name],
                          **prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
