"""What the Mamba mixer's rank-by-rank form (``models/mamba2.py::on_rows``)
costs a device of a production mesh, from the dry run: the mixer's dot
and kernel FLOPs and the collective bytes it adds (its weights gathered
whole, and its state's re-placement), beside the step's whole per-device
FLOPs and an estimate of the same step with the mixer split over the
"model" axis as the reference splits it (the mixer's FLOPs divided by
that axis's size, the rest as counted).

    PYTHONPATH=src python tools/mixer_cost.py [--arch zamba2-7b] \
        [--shape prefill_32k decode_32k] [--mesh single|multi]

Forward steps only (prefill, decode): a train step's backward runs
outside the mixer's call and is not apportioned. Prints one JSON line a
shape.
"""
import argparse
import json
import tempfile

from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.launch import dryrun
from repro_torch.models import mamba2


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--shape", nargs="+", default=["prefill_32k", "decode_32k"])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args()
    tally = {}
    raw = mamba2.on_rows

    def counted(*a, **k):
        led = next(m for m in _get_current_dispatch_mode_stack() if isinstance(m, dryrun.Ledger))
        f0, c0 = led.flops, sum(led.coll_bytes.values())
        try:
            return raw(*a, **k)
        finally:
            tally["calls"] += 1
            tally["flops"] += led.flops - f0
            tally["coll_bytes"] += sum(led.coll_bytes.values()) - c0

    mamba2.on_rows = counted
    for shape in args.shape:
        tally.update(calls=0, flops=0.0, coll_bytes=0.0)
        with tempfile.TemporaryDirectory() as out:
            rec = dryrun.run_one(args.arch, shape, args.mesh, out_dir=out)
        ms = rec["mesh_shape"]["model"]
        total = rec["flops_per_device"]
        print(json.dumps({
            "arch": args.arch, "shape": shape, "mesh": rec["mesh_shape"],
            "mixer_calls": tally["calls"], "step_flops_per_device": total,
            "mixer_flops_per_device": tally["flops"],
            "mixer_share": tally["flops"] / total if total else None,
            "reference_split_estimate": total - tally["flops"] * (1 - 1 / ms),
            "mixer_collective_bytes": tally["coll_bytes"],
            "step_collective_bytes": rec["collectives"]["total_bytes"],
            "trace_s": rec["trace_s"]}), flush=True)


if __name__ == "__main__":
    main()
