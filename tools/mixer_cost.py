"""What the head-parallel Mamba mixer (``models/mamba2.py::apply_mamba_sharded``)
costs a device of a production mesh, from the dry run, and the check of
it against the reference's split: the mixer's dot and kernel FLOPs and
collective bytes a device (counted under the dry run's ``Ledger`` from the
block's call of the mixer to its return), the attention mixers' collective
bytes and the step's whole per-device FLOPs, beside an estimate of the same
step with the mixer split over the "model" axis as the reference splits
it: the step's other FLOPs plus the mixer's FLOPs computed whole on the
rank's batch rows (one device's mixer on them, on fake tensors, counted
apart), divided by that axis's size.

    PYTHONPATH=src python tools/mixer_cost.py [--arch zamba2-7b] \
        [--shape prefill_32k decode_32k] [--mesh single|multi] [--limit 1.1]

Forward steps only (prefill, decode): a train step's backward runs
outside the mixer's call and is not apportioned. Prints one JSON line a
shape, and exits 1 where the step's FLOPs a device exceed ``--limit``
times the estimate.
"""
import argparse
import json
import sys
import tempfile

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.kernels import dispatch
from repro_torch.launch import dryrun
from repro_torch.models import blocks, mamba2
from repro_torch.models.runtime import is_distributed


def _whole_rows(t, rows: int):
    """A fake tensor of ``t``'s global shape with dim 0 cut to ``rows``
    (``rows`` None: the whole global shape)."""
    shape = tuple(t.shape) if rows is None else (rows, *t.shape[1:])
    return torch.empty(shape, dtype=t.dtype, device=t.device)


def _unsplit(fn_name: str, into: dict):
    """The mixer entry ``fn_name`` of ``blocks``, wrapped: on a DTensor input,
    the one-device mixer also runs on the rank's batch rows with every
    weight and state channel whole, its FLOPs counted apart into
    ``into["unsplit_flops"]`` (the step's own count untouched)."""
    raw = getattr(blocks, fn_name)

    def run(params, x, *a, **k):
        if is_distributed(x):
            led = next(m for m in _get_current_dispatch_mode_stack()
                       if isinstance(m, dryrun.Ledger))
            inner = dryrun.Ledger(led.device_type)
            led.hidden += 1
            try:
                with dispatch.observe_fake(inner.kernel), inner:
                    n = x.to_local().shape[0]
                    w = {key: _whole_rows(v, None) for key, v in params.items()}
                    xl = _whole_rows(x, n)
                    if fn_name == "apply_mamba_decode":
                        state, spec = a
                        st = mamba2.MambaState(*(_whole_rows(t, n) for t in state))
                        mamba2.apply_mamba_decode(w, xl, st, spec)
                    else:
                        (spec,) = a
                        init = k.get("init_state")
                        init = None if init is None else mamba2.MambaState(
                            *(_whole_rows(t, n) for t in init))
                        mamba2.apply_mamba_full(w, xl, spec, init_state=init,
                                                return_state=k.get("return_state", False),
                                                rt=k["rt"].local())
            finally:
                led.hidden -= 1
            into["unsplit_flops"] += inner.flops
        return raw(params, x, *a, **k)

    return run


def measure(arch: str, shape: str, mesh: str) -> dict:
    mixer, attn = {}, {}
    extra = {"unsplit_flops": 0.0}
    names = ("apply_mamba_full", "apply_mamba_decode")
    raw = {n: getattr(blocks, n) for n in names}
    for n in names:
        setattr(blocks, n, _unsplit(n, extra))
    try:
        with dryrun.tally(blocks, names, mixer), \
                dryrun.tally(blocks, ("attend_full", "decode_attend"), attn), \
                tempfile.TemporaryDirectory() as out:
            rec = dryrun.run_one(arch, shape, mesh, out_dir=out)
    finally:
        for n, fn in raw.items():
            setattr(blocks, n, fn)
    ms = rec["mesh_shape"]["model"]
    total = rec["flops_per_device"]
    estimate = total - mixer["flops"] + extra["unsplit_flops"] / ms
    return {
        "arch": arch, "shape": shape, "mesh": rec["mesh_shape"],
        "mixer_calls": mixer["calls"], "step_flops_per_device": total,
        "mixer_flops_per_device": mixer["flops"],
        "mixer_share": mixer["flops"] / total if total else None,
        "mixer_unsplit_flops_per_device": extra["unsplit_flops"],
        "reference_split_estimate": estimate,
        "measured_over_estimate": total / estimate if estimate else None,
        "mixer_collective_bytes": sum(mixer["coll_bytes"].values()),
        "mixer_collective_bytes_by_kind": dict(mixer["coll_bytes"]),
        "attention_collective_bytes": sum(attn["coll_bytes"].values()),
        "step_collective_bytes": rec["collectives"]["total_bytes"],
        "peak_bytes": rec["memory_analysis"]["peak_bytes"],
        "argument_bytes": rec["memory_analysis"]["argument_size_in_bytes"],
        "trace_s": rec["trace_s"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--shape", nargs="+", default=["prefill_32k", "decode_32k"])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--limit", type=float, default=1.1,
                    help="the most the step's FLOPs a device may be, times the estimate")
    args = ap.parse_args()
    over = []
    for shape in args.shape:
        row = measure(args.arch, shape, args.mesh)
        print(json.dumps(row), flush=True)
        if row["measured_over_estimate"] is not None and \
                row["measured_over_estimate"] > args.limit:
            over.append(shape)
    if over:
        print(f"above {args.limit} x the reference-split estimate: {over}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
