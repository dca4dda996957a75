"""Dry run of the production meshes (counterpart of
``repro/launch/dryrun.py``): what each card of a 256- or 512-card job
would hold, compute and send for an (architecture x input shape), without
those cards.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe --shape decode_32k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each step on 512 placeholder host
devices and reads XLA's analyses. Here the step runs once, eagerly, on
fake tensors (``FakeTensorMode``: shape, dtype and device, no data) of
the card ("cuda"), as rank 0 of a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once). So the dry run takes the card's own decisions: the
same step builders, placements (``launch/steps.py::train_shardings`` /
``decode_shardings``), DTensor redistributions and kernel routes, each
kernel reached through its shape function (``kernels/dispatch.py``). On
a ``Runtime`` without a mesh it predicts one card, which chip_smoke
holds against the card itself.

:func:`dry_run` counts on rank 0's local tensors (rank 0 holds the
largest shard, as the reference's padded per-device figure does),
through a dispatch mode beneath DTensor, with the conventions of
``benchmarks/hlo_analysis.py``:

  * ``flops_per_device``: dot FLOPs, 2 x prod(result) x prod(contracting)
    of every ``mm``/``addmm``/``bmm``/``baddbmm``, plus each kernel's own
    count (its bound's; ``moe_gmm`` all rows, a fake tensor's group sizes
    having no values);
  * ``bytes_accessed_per_device``: result + operand bytes of every op
    that is not a view (kernels: inputs + outputs);
  * ``memory_analysis``: the bytes of the storages on the card (the CUDA
    caching allocator rounds each up to a 512-byte block; these do not):
    ``argument_size_in_bytes``
    (the placed arguments), ``output_size_in_bytes`` (the storages the
    step newly returns; its in-place updates of its arguments are not
    output), ``peak_bytes`` (the most alive at once, arguments and what
    autograd saves included) and ``temp_size_in_bytes`` (peak less
    arguments and output);
  * ``collectives``: result-shape bytes and counts by kind, DTensor's
    functional collectives and the plain c10d ones (the expert-parallel
    ``all_to_all``) alike;
  * ``kernel_launches``: the kernels' shape-function calls by op (and
    ``kernel_routes`` by op and route), what the card would launch.

DTensor's propagation of global metadata (an op run once at global shape
per new signature) is not counted. ``trace_s`` (the step's wall time on
fake tensors) stands in for the reference's ``lower_s``/``compile_s``.
XLA's ``cost_analysis``, ``xla_flops_per_device`` and the HLO text
(``--save-hlo``) have no counterpart.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from collections import defaultdict
from pathlib import Path
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import SHAPES, get_config
from ..configs.base import ModelConfig, ShapeSpec
from ..configs.registry import ASSIGNED
from ..distributed.sharding import needs_fsdp
from ..kernels import dispatch
from ..models.model import param_shapes
from ..models.runtime import Runtime
from ..training.optim import OptConfig, init_opt_state
from ..training.trainer import TRAIN_KERNEL_BACKEND
from .mesh import PRODUCTION_SHAPES, make_production_mesh
from .specs import decode_window_override, input_specs
from .steps import (build_decode_step, build_prefill_step, build_train_step,
                    decode_shardings, train_shardings)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

_DOT_OPS = ("mm", "addmm", "bmm", "baddbmm")
# c10d and functional collectives -> the reference's kinds
_COLLECTIVES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
                ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
                ("alltoall", "all-to-all"), ("broadcast", "broadcast"))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _dot_flops(name: str, args, out) -> float:
    """2 x prod(result) x the contracting dim of an mm / bmm (and their
    add- forms, whose first argument is the addend)."""
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


class Ledger(TorchDispatchMode):
    """Counts one rank's local work: a dispatch mode that lets DTensor (and
    any other subclass) run first and sees the ops DTensor then runs on
    its local tensors. Storages on the card are followed from their first
    op to their release (a weak reference each)."""

    def __init__(self, device_type: str = "cuda"):
        super().__init__()
        self.device_type = device_type  # the card's (or its stand-in's)
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes: dict = defaultdict(float)
        self.coll_count: dict = defaultdict(int)
        self.kernels: dict = defaultdict(lambda: defaultdict(int))
        self.cur = 0
        self.peak = 0
        self.hidden = 0  # > 0 while DTensor propagates global metadata
        self._live: dict = {}

    # -- storages --------------------------------------------------------
    def track(self, t) -> None:
        """Follow ``t``'s storage (local) if it lies on the card and is new."""
        t = _local(t)
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        weakref.finalize(st, self._free, key)
        self.cur += n
        self.peak = max(self.peak, self.cur)

    def _free(self, key) -> None:
        self.cur -= self._live.pop(key, 0)

    def storages(self, tree) -> dict:
        """{storage id: bytes} of the tree's local tensors on the card."""
        out = {}
        for t in _tensors(tree):
            t = _local(t)
            if t.device.type == self.device_type:
                st = t.untyped_storage()
                out[id(st)] = st.nbytes()
        return out

    # -- kernels ---------------------------------------------------------
    def kernel(self, op: str, route: str, operations: float, nbytes: float) -> None:
        if not self.hidden:
            self.kernels[op][route] += 1
            self.flops += operations
            self.bytes += nbytes

    # -- every local op --------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(not issubclass(t, FakeTensor) and t is not torch.Tensor for t in types):
            return NotImplemented  # DTensor first: it calls back with local tensors
        out = func(*args, **kwargs)
        if self.hidden:
            return out
        outs = list(_tensors(out))
        for t in outs:
            self.track(t)
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional"):
            kind = next((k for key, k in _COLLECTIVES if key in name), None)
            if kind is not None:
                res = outs[0] if outs and ns == "_c10d_functional" else next(
                    _tensors(args), None)
                self.coll_count[kind] += 1
                self.coll_bytes[kind] += 0 if res is None else sum(
                    x.numel() * x.element_size() for x in _tensors(res))
            return out
        if name in _DOT_OPS:
            self.flops += _dot_flops(name, args, out)
        if not func.is_view and outs and not name.startswith("empty"):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in list(_tensors(args)) + outs)
        return out


@contextlib.contextmanager
def _dtensor_metadata_hidden(ledger: Ledger):
    """DTensor's own metadata work, kept out of a rank's count: its
    propagation of each new op signature at global shapes, and its sizes of
    strided shards (computed with index tensors, which must be real where a
    fake mode is on: a fake tensor has no values to read)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import placement_types

    def hidden(fn, real=False):
        def run(*a, **k):
            ledger.hidden += 1
            try:
                with unset_fake_temporarily() if real else contextlib.nullcontext():
                    return fn(*a, **k)
            finally:
                ledger.hidden -= 1
        return run

    prop = DTensor._op_dispatcher.sharding_propagator
    name = next(n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                if hasattr(prop, n))
    setattr(prop, name, hidden(getattr(prop, name)))  # on the instance, over its class's
    strided = getattr(placement_types, "_StridedShard", None)
    raw = None if strided is None else strided.__dict__.get("local_shard_size_and_offset")
    if raw is not None:
        fn = hidden(raw.__func__ if isinstance(raw, staticmethod) else raw, real=True)
        strided.local_shard_size_and_offset = (staticmethod(fn) if isinstance(raw, staticmethod)
                                               else fn)
    try:
        yield
    finally:
        delattr(prop, name)
        if raw is not None:
            strided.local_shard_size_and_offset = raw


@contextlib.contextmanager
def tally(module, names, into: dict):
    """Inside the block, every call of ``module.<name>`` (``name`` in
    ``names``, looked up in ``module`` at call time) adds to ``into`` what
    the :class:`Ledger` on the dispatch stack counts during it: ``calls``,
    ``flops`` and ``coll_bytes`` (a dict by kind). The originals come back
    on exit."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    into.setdefault("calls", 0)
    into.setdefault("flops", 0.0)
    into.setdefault("coll_bytes", defaultdict(float))

    def counted(fn):
        def run(*a, **k):
            led = next(m for m in _get_current_dispatch_mode_stack() if isinstance(m, Ledger))
            f0, c0 = led.flops, dict(led.coll_bytes)
            try:
                return fn(*a, **k)
            finally:
                into["calls"] += 1
                into["flops"] += led.flops - f0
                for kind, n in led.coll_bytes.items():
                    into["coll_bytes"][kind] += n - c0.get(kind, 0.0)
        return run

    raw = {n: getattr(module, n) for n in names}
    for n, fn in raw.items():
        setattr(module, n, counted(fn))
    try:
        yield into
    finally:
        for n, fn in raw.items():
            setattr(module, n, fn)


def _placed(meta_tree, pl_tree, rt: Runtime):
    """Fake tensors on the card of ``meta_tree``'s shapes and dtypes: on a
    mesh rank 0's shard of each as a DTensor of its placements, whole
    otherwise. Non-tensor leaves (a cache's ``pos``) as they are."""
    if isinstance(meta_tree, dict):
        return {k: _placed(v, None if pl_tree is None else pl_tree[k], rt)
                for k, v in meta_tree.items()}
    if hasattr(meta_tree, "_fields"):
        return type(meta_tree)(*(_placed(v, None if pl_tree is None else p, rt)
                                 for v, p in zip(meta_tree, pl_tree or meta_tree)))
    if not isinstance(meta_tree, torch.Tensor):
        return meta_tree
    if not rt.sharded:
        return torch.empty(meta_tree.shape, dtype=meta_tree.dtype, device=rt.device)
    from torch.distributed.tensor import DTensor

    shape = list(meta_tree.shape)  # rank 0's: the first chunk of every split
    for size, p in zip(rt.mesh.shape, pl_tree):
        if p.is_shard():
            shape[p.dim] = -(-shape[p.dim] // size)
    loc = torch.empty(shape, dtype=meta_tree.dtype, device=rt.device)
    return DTensor.from_local(loc, rt.mesh, pl_tree, run_check=False,
                              shape=meta_tree.shape, stride=meta_tree.stride())


def card_device() -> torch.device:
    """The device of the dry run's fake tensors (and of its mesh): "cuda"
    where this torch has CUDA; "cpu" standing in for the card elsewhere (a
    torch without CUDA cannot index a fake CUDA tensor;
    ``dispatch.card_stand_in``)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def dry_run(cfg: ModelConfig, shape: ShapeSpec, rt: Runtime) -> dict:
    """Run the step of ``shape.mode`` once on fake tensors of the card,
    placed on ``rt``'s mesh (or whole, without one; a mesh of
    :func:`card_device`'s type), and return the per-device record of the
    module docstring (without the mesh's names, which :func:`run_one`
    adds). The train step runs under the trainer's kernel spec
    (``TRAIN_KERNEL_BACKEND``), as on the card."""
    dev = card_device()
    rt = dataclasses.replace(rt, device=dev)
    if shape.mode == "train":
        rt = dataclasses.replace(rt, kernel_backend=TRAIN_KERNEL_BACKEND)
    specs = input_specs(cfg, shape)
    pshapes = param_shapes(cfg)
    wo = decode_window_override(cfg, shape)
    ledger = Ledger(dev.type)
    stand_in = dispatch.card_stand_in() if dev.type == "cpu" else contextlib.nullcontext()
    with stand_in, FakeTensorMode(), dispatch.observe_fake(ledger.kernel):
        if shape.mode == "decode":
            ps, bs = decode_shardings(cfg, rt, specs) if rt.sharded else (None, None)
            step = build_decode_step(cfg, rt, window_override=wo)
            args = (_placed(pshapes, ps, rt), _placed(specs, bs, rt))
        else:
            ps, _, bs = train_shardings(cfg, rt, specs) if rt.sharded else (None, None, None)
            params = _placed(pshapes, ps, rt)
            if shape.mode == "train":
                step = build_train_step(cfg, rt, OptConfig(total_steps=1000), melinoe=True)
                args = (params, init_opt_state(params), _placed(specs, bs, rt))
            else:
                step = build_prefill_step(cfg, rt, n_slots=shape.seq_len)
                args = (params, _placed(specs, bs, rt))
        for t in _tensors(args):
            ledger.track(t)
        arg_ids = ledger.storages(args)
        ledger.peak = ledger.cur
        hide = _dtensor_metadata_hidden(ledger) if rt.sharded else contextlib.nullcontext()
        t0 = time.perf_counter()
        with hide, ledger:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        out_ids = {k: n for k, n in ledger.storages(out).items() if k not in arg_ids}
    argument = sum(arg_ids.values())
    output = sum(out_ids.values())
    launches = {op: sum(r.values()) for op, r in ledger.kernels.items()}
    return {
        "mode": shape.mode,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "fsdp": bool(needs_fsdp(cfg, rt)),
        "param_counts": cfg.param_counts(),
        "flops_per_device": ledger.flops,
        "bytes_accessed_per_device": ledger.bytes,
        "memory_analysis": {
            "argument_size_in_bytes": argument,
            "output_size_in_bytes": output,
            "temp_size_in_bytes": ledger.peak - argument - output,
            "peak_bytes": ledger.peak,
        },
        "collectives": {
            "total_bytes": float(sum(ledger.coll_bytes.values())),
            "bytes_by_kind": dict(ledger.coll_bytes),
            "count_by_kind": dict(ledger.coll_count),
        },
        "kernel_launches": {op: launches.get(op, 0) for op in dispatch.OPS},
        "kernel_routes": {op: dict(r) for op, r in ledger.kernels.items()},
        "trace_s": round(trace_s, 2),
        "window_override": wo,
        "profile": rt.profile,
        "opts": os.environ.get("REPRO_TORCH_OPT", ""),
    }


@contextlib.contextmanager
def fake_group(world: int):
    """This process as rank 0 of a fake process group of ``world`` ranks
    (no communication), torn down on exit. Refuses a process that already
    has a process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group; this process "
                           "already has one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_one(arch: str, shape_name: str, mesh_kind: str, *, profile: str = "tp",
            out_dir: Optional[Path] = None) -> dict:
    """One (arch x shape x mesh) on its production mesh ("single" (16, 16),
    "multi" (2, 16, 16)): the record, written to
    ``out_dir/<arch>__<shape>__<mesh>.json``."""
    out_dir = Path(out_dir or OUT_DIR)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    multi = mesh_kind == "multi"
    dims, _ = PRODUCTION_SHAPES[multi]
    with fake_group(math.prod(dims)):
        mesh = make_production_mesh(multi_pod=multi, device_type=card_device().type)
        rt = Runtime(mesh=mesh, profile=profile)
        rec = dry_run(cfg, shape, rt)
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "n_devices": mesh.size(), **rec}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{arch}__{shape_name}__{mesh_kind}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="all assigned archs x shapes")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--profile", default="tp", choices=["tp", "pure_fsdp"])
    ap.add_argument("--out-dir", default=None, help="override output dir (opt runs)")
    args = ap.parse_args(argv)
    if not args.all and args.arch is None:
        ap.error("name an --arch or pass --all")

    archs = ASSIGNED if args.all else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out_dir = Path(args.out_dir) if args.out_dir else OUT_DIR

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch} x {shape} x {mesh_kind}"
                if args.skip_existing and (out_dir / f"{arch}__{shape}__{mesh_kind}.json").exists():
                    print(f"[skip] {tag}")
                    continue
                try:
                    rec = run_one(arch, shape, mesh_kind, profile=args.profile, out_dir=out_dir)
                    mem = rec["memory_analysis"]
                    print(f"[ok]   {tag}: flops/dev={rec['flops_per_device']:.3e} "
                          f"args/dev={mem['argument_size_in_bytes']:.3e}B "
                          f"peak/dev={mem['peak_bytes']:.3e}B "
                          f"coll={rec['collectives']['total_bytes']:.3e}B "
                          f"trace={rec['trace_s']}s", flush=True)
                except Exception as e:  # one record's failure is reported, the rest run
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        sys.exit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
