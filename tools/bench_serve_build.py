"""How long ``bench_serve --offloaded`` takes to build before it serves:
the seconds from the launcher's call to the wave server's first
``OffloadedMoEEngine.generate`` (the weights, the oracle scores, the
engine and, with ``--little``, its bank), and the whole call, for the two
launcher runs chip_smoke makes at OLMoE's full width on its first
``LAUNCHER_LAYERS`` layers: the little phase's ``--little --quality 0.5``
and the operations phase's ``--trace``.

    PYTHONPATH=src python tools/bench_serve_build.py --out chiprun_out/build.json

It times the package on ``PYTHONPATH``, so two trees are compared in one
call on one card by running it once with each tree's ``src`` (the kernels
build once where ``REPRO_TORCH_BUILD_DIR`` is shared); ``--label`` names
the tree in the output. Prints one JSON object: per run the build and
call seconds, the card's name and its power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import register
from repro_torch.core import offload_engine
from repro_torch.kernels import _build
from repro_torch.launch import bench_serve

# chip_smoke's LAUNCHER_LAYERS and OPS_BENCH (this tool imports no
# chip_smoke: it puts the checkout's own src first on the path)
LAUNCHER_LAYERS = 4
OPS_BENCH = ["--n-requests", "4", "--prompt-len", "128", "--max-new", "16",
             "--arrival", "all_at_once"]


def launcher_arch(arch: str = "olmoe") -> str:
    """``arch`` cut to its first LAUNCHER_LAYERS layers, registered."""
    cfg = get_config(arch)
    name = f"{arch}-{LAUNCHER_LAYERS}l"
    register(name)(lambda: dataclasses.replace(cfg, name=name, layout=(dataclasses.replace(
        cfg.layout[0], repeats=LAUNCHER_LAYERS // len(cfg.layout[0].pattern)),)))
    return name


def timed(argv) -> dict:
    """``bench_serve.main(argv)``: the seconds to the first served request
    and the seconds of the whole call."""
    first = []
    generate = offload_engine.OffloadedMoEEngine.generate

    def probed(self, *a, **k):
        if not first:
            torch.cuda.synchronize()
            first.append(time.perf_counter())
        return generate(self, *a, **k)

    offload_engine.OffloadedMoEEngine.generate = probed
    try:
        t0 = time.perf_counter()
        bench_serve.main(argv)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        offload_engine.OffloadedMoEEngine.generate = generate
    return {"to_first_request_s": first[0] - t0, "call_s": t1 - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_serve_build: no CUDA device")
    _build.lib()
    arch = launcher_arch()
    base = ["--arch", arch, "--device", "cuda"]
    runs = {"little": base + ["--offloaded", "--capacity", "16", "--slots", "4",
                              "--n-requests", "4", "--prompt-len", "128", "--max-new", "32",
                              "--arrival", "all_at_once", "--little", "--quality", "0.5"]}
    with tempfile.TemporaryDirectory() as d:
        runs["trace"] = base + OPS_BENCH + ["--offloaded", "--capacity", "16", "--slots",
                                            "4", "--trace", d]
        rep = {name: timed(a) for name, a in runs.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    out = {"label": args.label, "package": str(Path(bench_serve.__file__).parents[2]),
           "card": smi, "runs": rep}
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
