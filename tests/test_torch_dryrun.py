"""The dry run (``repro_torch.launch.dryrun``) and the kernels' shape
functions, on the CPU.

* Each kernel wrapper given fake tensors of the card (``FakeTensorMode``,
  device "cuda") returns the plain version's shapes and dtype at the cases
  of ``tests/test_torch_kernels.py`` (and of the mamba and INT4 tests),
  launches nothing, and reports the operation count of its bound in
  ``PERF.md``, computed here again from the shapes. Real CPU tensors
  never reach a shape function.
* The per-device counts on one rank's local tensors: x (4096, 2048)
  Shard(0) @ w (2048, 8192) Shard(1) on the (16, 16) mesh is 2 x 256 x
  2048 x 512 FLOPs and a (256, 512) fp32 output.
* Smoke parity with the JAX package's lowering on a (2, 2, 2) mesh (the
  JAX side in a subprocess with 8 host devices and a mesh of Auto axes,
  which its sharded path needs on jax 0.9): per-device argument bytes
  equal, apart from the reference's int32 scalars (the optimizer's
  ``step``, the cache's ``pos``; the port's are Python ints) and its
  int32 tokens (the port's are int64). zamba2-7b-smoke's Mamba mixer,
  head-parallel over "model": its dot FLOPs a device (counted under the
  ``Ledger`` from the block's call to its return, as
  ``tools/mixer_cost.py`` counts them) times the mesh's 8 devices within
  1.15 x one device's, in prefill and decode.
* OLMoE's ``decode_32k`` and ``prefill_32k`` through the command line on
  both production meshes: argument bytes equal the local shapes of the
  JAX package's specs, 873,148,416 B of parameters a device.

On a host whose torch has no CUDA the dry run's fake tensors lie on the
CPU and stand in for the card (``dispatch.card_stand_in``); a torch
without CUDA cannot index a fake CUDA tensor."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.model import param_shapes as jax_param_shapes  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attn import attention_ref, flash_hopper  # noqa: E402
from repro_torch.kernels.int4_matmul import (int4_matmul, int4_matmul_hopper,  # noqa: E402
                                             int4_matmul_ref, quantize_matmul_weight)
from repro_torch.kernels.int4_matmul.ops import fake_splits  # noqa: E402
from repro_torch.kernels.moe_gmm import gmm, gmm_hopper, gmm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_hopper  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    monkeypatch.delenv("REPRO_TORCH_OPT", raising=False)


def _fake_call(fn, *shapes_dtypes, **kw):
    """fn on fake CUDA tensors of (shape, dtype) -> (outputs, fake calls)."""
    seen = []
    dispatch.reset_launches()
    with FakeTensorMode(), dispatch.observe_fake(lambda *r: seen.append(r)):
        args = [None if sd is None else torch.empty(sd[0], dtype=sd[1], device="cuda")
                for sd in shapes_dtypes]
        out = fn(*args, **kw)
    assert sum(dispatch.LAUNCHES.values()) == 0  # a shape function launches nothing
    outs = out if isinstance(out, tuple) else (out,)
    assert all(isinstance(o, FakeTensor) and o.device.type == "cuda" for o in outs)
    return outs, seen


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,M,K,N", [(4, 64, 128, 96), (8, 33, 256, 128), (2, 7, 64, 32),
                                     (3, 16, 96, 64), (16, 4, 2048, 1024)])
def test_gmm_shape_function(E, M, K, N, dtype):
    (out,), seen = _fake_call(gmm_hopper, ((E, M, K), dtype), ((E, K, N), dtype),
                              ((E,), torch.int32))
    ref = gmm_ref(torch.zeros(E, M, K, dtype=dtype), torch.zeros(E, K, N, dtype=dtype))
    assert out.shape == ref.shape and out.dtype == ref.dtype and out.is_contiguous()
    it = torch.empty((), dtype=dtype).element_size()
    route = "fma" if dtype == torch.float32 else ("stream" if M <= 16 else "tc")
    # the bound's count with every row of every group (a fake has no sizes)
    assert seen == [("moe_gmm", route, 2.0 * E * M * K * N,
                     (E * M * K + E * K * N + E * M * N) * it)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,Hkv,G,hd,cap,win", [
    (2, 64, 2, 2, 16, None, None), (1, 128, 1, 4, 32, 50.0, None), (2, 96, 2, 1, 16, None, 32),
    (1, 64, 2, 2, 16, 30.0, 24), (4, 128, 16, 1, 128, None, None), (4, 512, 8, 4, 160, None, 700)])
def test_flash_shape_function(B, T, Hkv, G, hd, cap, win, dtype):
    (out,), seen = _fake_call(flash_hopper, ((B, T, Hkv, G, hd), dtype),
                              ((B, T, Hkv, hd), dtype), ((B, T, Hkv, hd), dtype),
                              softcap=cap, window=win)
    q = torch.zeros(B, T, Hkv, G, hd, dtype=dtype)
    k = torch.zeros(B, T, Hkv, hd, dtype=dtype)
    ref = attention_ref(q, k, k, softcap=cap, window=win)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    t = torch.arange(T)
    pairs = int(torch.minimum(t + 1, torch.tensor(win or T)).sum())  # chip_smoke's count
    route = "fma" if dtype == torch.float32 else "tc"
    assert seen == [("flash_attn", route, 4.0 * hd * pairs * B * Hkv * G,
                     (2 * q.numel() + 2 * k.numel()) * q.element_size())]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,H,P,N,G,chunk,init", [  # test_torch_mamba.py's; the serve's
    (2, 64, 3, 32, 16, None, 16, False), (1, 100, 4, 32, 16, 2, 32, True),
    (4, 512, 112, 64, 64, 1, 128, False), (4, 512, 24, 64, 128, 1, 128, True)])
def test_ssd_shape_function(B, T, H, P, N, G, chunk, init, dtype):
    gshape = (B, T, N) if G is None else (B, T, G, N)
    f32 = torch.float32
    (y, fin), seen = _fake_call(
        lambda x, dt, A, Bm, Cm, i0, D: ssd_hopper(x, dt, A, Bm, Cm, i0, D=D, chunk=chunk),
        ((B, T, H, P), dtype), ((B, T, H), f32), ((H,), f32), (gshape, dtype), (gshape, dtype),
        ((B, H, P, N), f32) if init else None, ((H,), f32))
    yr, fr = ssd_chunked(torch.zeros(B, T, H, P, dtype=dtype), torch.zeros(B, T, H),
                         torch.zeros(H), torch.zeros(gshape, dtype=dtype),
                         torch.zeros(gshape, dtype=dtype), chunk)
    assert y.shape == yr.shape and y.dtype == dtype and fin.shape == fr.shape \
        and fin.dtype == torch.float32
    # chip_smoke's count: C Bᵀ once per group, the causal half of each chunk
    g = G or 1
    rows = [min(chunk, T - c) for c in range(0, T, chunk)]
    tri = sum(r * (r + 1) // 2 for r in rows)
    macs = B * g * tri * N + B * H * tri * P + 2 * B * H * T * P * N
    ((op, route, ops, _),) = seen
    assert (op, route, ops) == ("ssd_scan", "fma" if dtype == f32 else "tc", 2.0 * macs)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N,group", [(64, 128, 96, 32), (256, 512, 256, 64),
                                         (8, 256, 128, 64), (128, 1024, 64, 128),
                                         (4, 2048, 1024, 32)])
def test_int4_shape_function(M, K, N, group, dtype):
    (out,), seen = _fake_call(
        lambda x, p, s, z: int4_matmul_hopper(x, p, s, z, group), ((M, K), dtype),
        ((K // 2, N), torch.uint8), ((K // group, N), torch.float32),
        ((K // group, N), torch.float32))
    q = quantize_matmul_weight(torch.zeros(K, N), group)
    ref = int4_matmul_ref(torch.zeros(M, K, dtype=dtype), q.packed, q.scale, q.zero, group)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    ((op, route, ops, _),) = seen
    want = "fma" if dtype == torch.float32 else ("stream" if M <= 16 else "tc")
    assert (op, route, ops) == ("int4_matmul", want, 2.0 * M * K * N)
    if route != "fma":
        assert 1 <= fake_splits(route, M, K, N, group) <= max(K // group, K // 64)


def test_real_tensors_never_reach_a_shape_function():
    a, b = torch.zeros(2, 4, 32), torch.zeros(2, 32, 16)
    with pytest.raises(ValueError, match="CUDA"):
        gmm_hopper(a, b)
    with pytest.raises(RuntimeError, match="hopper"):
        gmm(a, b, backend="hopper")
    q = torch.zeros(1, 8, 1, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_hopper(q, q[:, :, :, 0], q[:, :, :, 0])
    x, qw = torch.zeros(4, 64), quantize_matmul_weight(torch.zeros(64, 32), 32)
    with pytest.raises(RuntimeError, match="hopper"):
        int4_matmul(x, qw.packed, qw.scale, qw.zero, group=32, backend="hopper")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_hopper(torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2), torch.zeros(2),
                   torch.zeros(1, 8, 16), torch.zeros(1, 8, 16))
    # a fake CPU tensor is no card outside a dry run's stand-in, and takes the
    # plain version under "auto" inside nothing
    with FakeTensorMode():
        fa, fb = torch.empty(2, 4, 32), torch.empty(2, 32, 16)
        with pytest.raises(ValueError, match="CUDA"):
            gmm_hopper(fa, fb)
        assert not dispatch.use_kernel("moe_gmm", "auto", fa.device)
        with dispatch.card_stand_in():
            assert dispatch.use_kernel("moe_gmm", "auto", fa.device)
            assert gmm_hopper(fa, fb).shape == (2, 4, 16)
    # one predicate says what counts as the card: inside the stand-in the CPU
    # is the card's device, and a real CPU tensor still has no kernel
    assert not dispatch.on_card_device(a.device)
    with dispatch.card_stand_in():
        assert dispatch.on_card_device(a.device) and not dispatch.on_card(a)
        with pytest.raises(ValueError, match="CUDA"):
            gmm_hopper(a, b)
    assert sum(dispatch.LAUNCHES.values()) == 0


def test_per_device_counts_are_a_ranks_local_work():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dev = dryrun.card_device()
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type=dev.type)
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(256, 2048, device=dev), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            w = DTensor.from_local(torch.empty(2048, 512, device=dev), mesh,
                                   [Replicate(), Shard(1)], run_check=False)
            ledger = dryrun.Ledger(dev.type)
            for t in (x, w):
                ledger.track(t)
            base = ledger.cur
            with dryrun._dtensor_metadata_hidden(ledger), ledger:
                y = x @ w
            assert y.shape == (4096, 8192) and y.to_local().shape == (256, 512)
            assert ledger.flops == 2 * 256 * 2048 * 512 == 536_870_912
            assert ledger.peak - base == sum(ledger.storages(y).values()) == 524_288
            assert not ledger.coll_bytes
            with dryrun._dtensor_metadata_hidden(ledger), ledger:
                y.redistribute(mesh, [Replicate(), Replicate()])
            assert ledger.coll_count["all-gather"] == 2 and ledger.coll_bytes["all-gather"] > 0
    # the dry run refuses a process that already has a process group
    with dryrun.fake_group(8):
        with pytest.raises(RuntimeError, match="already"):
            with dryrun.fake_group(8):
                pass


_JAX_LOWER = r"""
import json, os, sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import jax
from jax.sharding import AxisType
from benchmarks.hlo_analysis import full_costs
from repro.configs import ShapeSpec, get_config
from repro.launch.specs import input_specs
from repro.launch.steps import (build_decode_step, build_prefill_step, build_train_step,
                                decode_shardings, train_shardings)
from repro.models.model import param_shapes
from repro.models.runtime import Runtime
from repro.training.optim import OptConfig, init_opt_state

mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
rt = Runtime(mesh=mesh, use_kernels=False)
out = {}
for arch in sys.argv[2:]:
    cfg, p = get_config(arch), param_shapes(get_config(arch))
    for mode in ("train", "prefill", "decode"):
        specs = input_specs(cfg, ShapeSpec(mode, 64, 8, mode))
        if mode == "train":
            ps, os_, bs = train_shardings(cfg, rt, specs)
            low = jax.jit(build_train_step(cfg, rt, OptConfig(total_steps=1000), melinoe=True),
                          in_shardings=(ps, os_, bs)).lower(
                p, jax.eval_shape(init_opt_state, p), specs)
        elif mode == "prefill":
            ps, _, bs = train_shardings(cfg, rt, specs)
            low = jax.jit(build_prefill_step(cfg, rt, n_slots=64),
                          in_shardings=(ps, bs)).lower(p, specs)
        else:
            ps, bs = decode_shardings(cfg, rt, specs)
            low = jax.jit(build_decode_step(cfg, rt), in_shardings=(ps, bs)).lower(p, specs)
        comp = low.compile()
        costs = full_costs(comp.as_text())
        out.setdefault(arch, {})[mode] = {
            "argument_size_in_bytes": int(comp.memory_analysis().argument_size_in_bytes),
            "flops": costs.flops, "collective_bytes": sum(costs.coll_by_kind.values())}
print(json.dumps(out))
"""

SMOKE = ("granite-moe-1b-a400m-smoke", "zamba2-7b-smoke")
MIXER = ("apply_mamba_full", "apply_mamba_decode")  # the blocks' calls of the Mamba mixer


@pytest.mark.fleet
def test_smoke_dry_runs_match_the_jax_lowering():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_LOWER, str(ROOT), *SMOKE],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ours, one, mixer = {}, {}, {}
        for arch in SMOKE:
            cfg = get_config(arch)
            for mode in ("train", "prefill", "decode"):
                shape = ShapeSpec(mode, 64, 8, mode)
                tally = {"mesh": {}, "one": {}}
                with dryrun.fake_group(8):
                    mesh = make_debug_mesh(2, 2, pod=2, device_type=dryrun.card_device().type)
                    with dryrun.tally(blocks, MIXER, tally["mesh"]):
                        ours[arch, mode] = dryrun.dry_run(cfg, shape, Runtime(mesh=mesh))
                with dryrun.tally(blocks, MIXER, tally["one"]):
                    one[arch, mode] = dryrun.dry_run(cfg, shape, Runtime())
                mixer[arch, mode] = tally
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    theirs = json.loads(out.strip().splitlines()[-1])
    for (arch, mode), rec in ours.items():
        j = theirs[arch][mode]
        rows = 8 // 4  # the batch over ("pod", "data")
        tokens = {"train": 2 * rows * 64, "prefill": rows * 64, "decode": rows}[mode]
        scalar = 4 if mode in ("train", "decode") else 0  # step / pos: int32 in JAX
        args = rec["memory_analysis"]["argument_size_in_bytes"]
        assert args == j["argument_size_in_bytes"] - scalar + 4 * tokens, (arch, mode)
        assert rec["collectives"]["total_bytes"] > 0 and j["collective_bytes"] > 0, (arch, mode)
        assert rec["flops_per_device"] * 8 >= one[arch, mode]["flops_per_device"], (arch, mode)
        print(f"{arch} {mode}: argument bytes {args} (JAX {j['argument_size_in_bytes']}), "
              f"dot FLOPs a device {rec['flops_per_device']:.4g} (JAX {j['flops']:.4g}), "
              f"collective bytes {rec['collectives']['total_bytes']:.4g} "
              f"(JAX {j['collective_bytes']:.4g})")
    # the Mamba mixer splits its work 8 ways: rows over ("pod", "data"), heads
    # over "model"; the slack is the B/C columns both model ranks compute
    # (32 of 552 in_proj columns), and the rank-by-rank form read 2x
    for mode in ("prefill", "decode"):
        t = mixer["zamba2-7b-smoke", mode]
        assert t["mesh"]["calls"] == t["one"]["calls"] > 0, mode
        assert t["mesh"]["flops"] * 8 <= 1.15 * t["one"]["flops"], (mode, t)
        print(f"zamba2-7b-smoke {mode}: mixer dot FLOPs a device x 8 "
              f"{t['mesh']['flops'] * 8:.4g} against one device's {t['one']['flops']:.4g}")
    granite = ours["granite-moe-1b-a400m-smoke", "train"]["memory_analysis"]
    assert granite["argument_size_in_bytes"] == 2_149_636 - 4 + 4 * 256


def _jax_local_bytes(arch, shape_name, key):
    """Rank 0's bytes of the JAX package's parameter, batch and cache specs
    on a production mesh, tokens at the port's 8 bytes, no scalar ``pos``."""
    shape, names = {"single": ((16, 16), ("data", "model")),
                    "multi": ((2, 16, 16), ("pod", "data", "model"))}[key]
    mesh = JaxAbstractMesh(shape, names)
    rt = JaxRuntime(mesh=mesh)
    sizes = dict(zip(names, shape))
    cfg = jax_get_config(arch)
    specs = jspecs.input_specs(cfg, JAX_SHAPES[shape_name])
    pshapes = jax_param_shapes(cfg)
    tree = [(pshapes, jsharding.param_pspecs(pshapes, cfg, rt, fsdp=False))]
    if "cache" in specs:
        tree += [(specs["tokens"], jsharding.batch_pspecs(specs["tokens"], rt)),
                 (specs["cache"], jsharding.cache_pspecs(specs["cache"], rt))]
    else:
        tree += [(specs, jsharding.batch_pspecs(specs, rt))]
    total = {"params": 0, "kv": 0, "all": 0}
    for i, (leaves, spec_tree) in enumerate(tree):
        flat = jax.tree_util.tree_leaves(leaves)
        fspecs = jax.tree_util.tree_leaves(
            spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(flat) == len(fspecs)
        for leaf, spec in zip(flat, fspecs):
            if leaf.shape == ():
                continue
            local = list(leaf.shape)
            for d, entry in enumerate(tuple(spec)):
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    if a is not None:
                        local[d] //= sizes[a]
            item = 8 if i == 1 and str(leaf.dtype) == "int32" else leaf.dtype.itemsize
            n = math.prod(local) * item
            total["all"] += n
            total["params"] += n if i == 0 else 0
            total["kv"] += n if leaf.ndim == 5 else 0
    return total


@pytest.mark.fleet
def test_production_records_of_olmoe_from_the_command_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {s: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmoe", "--shape", s,
         "--mesh", "both", "--out-dir", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for s in ("decode_32k", "prefill_32k")}
    for s, p in procs.items():
        try:
            out, _ = p.communicate(timeout=300)
        finally:
            p.kill()
        assert p.returncode == 0 and "all dry-runs passed" in out, out[-3000:]
    keys = {"arch", "shape", "mesh", "mesh_shape", "n_devices", "fsdp", "mode", "seq_len",
            "global_batch", "param_counts", "flops_per_device", "bytes_accessed_per_device",
            "memory_analysis", "collectives", "kernel_launches", "trace_s",
            "window_override", "profile", "opts"}
    for s in procs:
        for key, n_dev in (("single", 256), ("multi", 512)):
            rec = json.loads((tmp_path / f"olmoe__{s}__{key}.json").read_text())
            assert keys <= rec.keys() and rec["n_devices"] == n_dev and not rec["fsdp"]
            assert set(rec["memory_analysis"]) == {"argument_size_in_bytes",
                                                   "output_size_in_bytes",
                                                   "temp_size_in_bytes", "peak_bytes"}
            want = _jax_local_bytes("olmoe", s, key)
            assert want["params"] == 873_148_416
            assert rec["memory_analysis"]["argument_size_in_bytes"] == want["all"], (s, key)
            assert rec["collectives"]["total_bytes"] > 0 and rec["flops_per_device"] > 0
            if s == "decode_32k":
                assert want["kv"] == {"single": 2_147_483_648, "multi": 1_073_741_824}[key]
                assert rec["kernel_launches"] == {"flash_attn": 0, "int4_matmul": 0,
                                                  "moe_gmm": 48, "ssd_scan": 0}
            else:  # one flash a layer, shard by shard; three gmm a layer in the EP body
                assert rec["kernel_launches"] == {"flash_attn": 16, "int4_matmul": 0,
                                                  "moe_gmm": 48, "ssd_scan": 0}
            assert rec["memory_analysis"]["peak_bytes"] >= \
                rec["memory_analysis"]["argument_size_in_bytes"]


def test_one_row_a_shard_takes_the_kernel():
    """long_500k decodes one sequence: each rank's expert buffer holds one
    row a shard, which the exchange leaves strided; the kernel takes it
    contiguous (it raised before)."""
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type=dryrun.card_device().type)
        rec = dryrun.dry_run(get_config("olmoe"), ShapeSpec("long_500k", 524_288, 1, "decode"),
                             Runtime(mesh=mesh))
    assert rec["window_override"] == 8192 and rec["kernel_launches"]["moe_gmm"] == 48
