"""What the head-parallel Mamba mixer (``models/mamba2.py::apply_mamba_sharded``)
and the shared block's MLP (``models/mlp.py::apply_mlp_sharded``) cost a
device of a production mesh, from the dry run, and the check of the mixer
against the reference's split: the mixer's dot and kernel FLOPs and
collective bytes a device (counted under the dry run's ``Ledger`` from the
block's call of the mixer to its return), the attention mixers' collective
bytes and the step's whole per-device FLOPs, beside an estimate of the same
step with the mixer split over the "model" axis as the reference splits
it: the step's other FLOPs plus the mixer's FLOPs computed whole on the
rank's batch rows (one device's mixer on them, on fake tensors, counted
apart), divided by that axis's size.

The shared MLP is counted by its products' shapes: every product with a
matrix dim (an operand's last two) of the block's d_ff or of a model
rank's block of it (no other product of zamba2 has one), forward (grad mode on: the step's
forward and the train step's recompute) and backward (the autograd
engine's, grad mode off) apart, beside the split estimate: 2 x rows x d x
d_ff / model for each of its three products, once a forward and twice a
backward. It reads the step alone, so it counts a tree whose shared MLP
runs through DTensor's strategies as well.

    PYTHONPATH=src python tools/mixer_cost.py [--arch zamba2-7b] \
        [--shape prefill_32k decode_32k train_4k] [--mesh single|multi] \
        [--limit 1.1] [--layout mamba shared_attn]

``--layout`` cuts the model to one repeat of that pattern (``mamba
shared_attn``: a 2-layer cut at full width, one Mamba and one shared block). The mixer's
estimate is for forward steps only (prefill, decode): a train step's
backward runs outside the mixer's call and is not apportioned. Prints one
JSON line a shape, and exits 1 where the step's FLOPs a device exceed
``--limit`` times the estimate.
"""
import argparse
import dataclasses
import json
import sys
import tempfile
from collections import defaultdict

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import LayoutGroup
from repro_torch.configs.registry import register
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


def _ffn_ledger(d_ff: int, ms: int, into: dict):
    """A ``dryrun.Ledger`` class that also adds every product with a matrix
    dim of ``d_ff`` or of a model rank's block of it to
    ``into["forward"|"backward"]`` (by grad mode), and each such product's
    shape to ``into["shapes"]``."""
    marks = {d_ff, -(-d_ff // ms), d_ff // ms}

    class FfnLedger(dryrun.Ledger):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            f0 = self.flops
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = func._overloadpacket.__name__
            if out is NotImplemented or self.hidden or name not in dryrun._DOT_OPS:
                return out
            ops = args[-2:]
            if marks & {n for t in ops for n in t.shape[-2:]}:
                into["forward" if torch.is_grad_enabled() else "backward"] += self.flops - f0
                into["shapes"][str(tuple(tuple(t.shape) for t in ops))] += 1
            return out

    return FfnLedger


def cut(arch: str, pattern) -> str:
    """``arch`` cut to one repeat of ``pattern``, registered; its name."""
    cfg = get_config(arch)
    name = f"{arch}-{'+'.join(pattern)}"
    register(name)(lambda: dataclasses.replace(
        cfg, name=name, layout=(LayoutGroup(tuple(pattern), 1),)))
    return name


def measure(arch: str, shape: str, mesh: str) -> dict:
    mixer, attn = {}, {}
    extra = {"unsplit_flops": 0.0}
    cfg = get_config(arch)
    shared = [b for b in cfg.block_defs.values() if b.kind == "shared_attn"]
    ffn = {"forward": 0.0, "backward": 0.0, "shapes": defaultdict(int)}
    names = ("apply_mamba_full", "apply_mamba_decode")
    raw = {n: getattr(blocks, n) for n in names}
    raw_ledger = dryrun.Ledger
    for n in names:
        setattr(blocks, n, _unsplit(n, extra))
    dims, axes = dryrun.PRODUCTION_SHAPES[mesh == "multi"]
    ms = dims[axes.index("model")]
    if shared:
        dryrun.Ledger = _ffn_ledger(shared[0].d_ff, ms, ffn)
    ffn_calls = {}
    try:
        with dryrun.tally(blocks, names, mixer), \
                dryrun.tally(blocks, ("attend_full", "decode_attend"), attn), \
                dryrun.tally(blocks, ("_ffn",), ffn_calls), \
                tempfile.TemporaryDirectory() as out:
            rec = dryrun.run_one(arch, shape, mesh, out_dir=out)
    finally:
        dryrun.Ledger = raw_ledger
        for n, fn in raw.items():
            setattr(blocks, n, fn)
    total = rec["flops_per_device"]
    estimate = total - mixer["flops"] + extra["unsplit_flops"] / ms
    if shared:  # the FFN calls are the shared block's (zamba2's blocks)
        sh = SHAPES[shape]
        layers = sum(g.repeats * sum(cfg.block_defs[b].kind == "shared_attn" for b in g.pattern)
                     for g in cfg.layout)
        T = 1 if sh.mode == "decode" else sh.seq_len
        rows = sh.global_batch // (rec["n_devices"] // ms) * T  # a rank's
        one = 2.0 * 3 * rows * cfg.d_model * shared[0].d_ff / ms  # a call, split
        mlp = {"shared_mlp_calls": ffn_calls["calls"],
               "shared_mlp_forward_flops": ffn["forward"],
               "shared_mlp_backward_flops": ffn["backward"],
               "shared_mlp_split_estimate_forward": one * ffn_calls["calls"],
               "shared_mlp_split_estimate_backward": 2 * one * layers
               if sh.mode == "train" else 0.0,
               "shared_mlp_products": dict(ffn["shapes"])}
    else:
        mlp = {}
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
        "trace_s": rec["trace_s"], **mlp}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--shape", nargs="+", default=["prefill_32k", "decode_32k"])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--limit", type=float, default=1.1,
                    help="the most the step's FLOPs a device may be, times the estimate")
    ap.add_argument("--layout", nargs="+", default=None,
                    help="cut the model to one repeat of these block kinds")
    args = ap.parse_args()
    arch = cut(args.arch, args.layout) if args.layout else args.arch
    over = []
    for shape in args.shape:
        row = measure(arch, shape, args.mesh)
        print(json.dumps(row), flush=True)
        if row["measured_over_estimate"] is not None and \
                row["measured_over_estimate"] > args.limit:
            over.append(shape)
    if over:
        print(f"above {args.limit} x the reference-split estimate: {over}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
