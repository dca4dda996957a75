"""A/B chip_smoke's phase 13 (the full-depth bf16 MELINOE fine-tune of
OLMoE, 8 x 128 tokens, 4 steps) between checkouts of the repo on one card.

    python tools/finetune_ab.py --pairs 5 parent=archive_check/parent change=.

Each NAME=DIR is a checkout (``DIR/chip_smoke.py``, ``DIR/src``). The
versions run in turns, each in its own process, A B B A A B B A ... for
``--pairs`` pairs, so that drift of the host or the card falls on both
alike. Each run prints ``NAME: {json}`` with the phase's step times
(steps 1-3; step 0 compiles and warms the allocator), ms a step, peak
memory and the step-0 kernels-vs-plain loss; the last line is a summary:
each version's ms a step in run order, mean and spread. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

RUN = """
import json, torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.kernels import _build
_build.lib()
import chip_smoke
rep = chip_smoke.finetune_phase()
print("FINETUNE_AB " + json.dumps({k: rep[k] for k in (
    "step_ms", "ms_per_step", "max_memory_allocated", "step0_loss_rel")}))
"""


def run_one(tree: Path, timeout: float) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    res = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env, timeout=timeout,
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{tree}: rc {res.returncode}\n{res.stderr[-4000:]}")
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("FINETUNE_AB ")][-1]
    return json.loads(line[len("FINETUNE_AB "):])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs=2, help="NAME=DIR of each checkout")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds a run")
    args = ap.parse_args(argv)
    (a, da), (b, db) = (t.split("=", 1) for t in args.trees)
    order = [(a, da), (b, db)]
    ms: dict = {a: [], b: []}
    for i in range(args.pairs):
        for name, tree in (order if i % 2 == 0 else order[::-1]):
            rep = run_one(Path(tree).resolve(), args.timeout)
            ms[name].append(rep["ms_per_step"])
            print(f"{name}: {json.dumps(rep)}", flush=True)
    print(json.dumps({name: {"ms_per_step": v, "mean": statistics.mean(v),
                             "stdev": statistics.stdev(v) if len(v) > 1 else 0.0}
                      for name, v in ms.items()}))


if __name__ == "__main__":
    main()
