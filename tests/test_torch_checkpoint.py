"""The port's checkpoints against the JAX package's on the CPU: its msgpack
subset against ``msgpack`` itself, files the JAX package writes (fp32 and
bf16 leaves; params-only and ``(params, lora)``) loading bit for bit,
the port writing the same bytes for the same tree, and the launchers'
``--ckpt`` and ``bench_serve --offloaded`` at smoke size.
"""
import json

import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_wave import lora_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.offload_engine import OffloadedMoEEngine as JaxEngine  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro_torch.bridge import lora_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import bench_serve, serve  # noqa: E402
from repro_torch.recovery import array_record, record_array  # noqa: E402
from repro_torch.recovery.msgpack_lite import packb, unpackb  # noqa: E402
from repro_torch.training import load_checkpoint, merge_lora, save_checkpoint  # noqa: E402
from repro_torch.training.checkpoint import tree_leaves, treedef_str  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

ARCH = "olmoe-mini-smoke"


def _ints():
    edges = [0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1]
    return edges + [-v for v in edges[1:-1]] + [-33, -128, -129, -2**15 - 1, -2**31 - 1,
                                                -2**63]


@pytest.mark.parametrize("obj", [
    None, True, False, 0.5, -1e300, float("inf"), "", "a" * 31, "é" * 20, "b" * 300,
    "c" * 70000, b"", b"x" * 255, b"y" * 256, b"z" * 70000, list(range(15)),
    list(range(16)), list(range(70000)), {str(i): i for i in range(15)},
    {str(i): [i, None] for i in range(16)}, {"k": {"n": (1, 2.0, b"b")}}, _ints()])
def test_msgpack_subset_matches_msgpack(obj):
    ref = msgpack.packb(obj, use_bin_type=True)
    assert packb(obj) == ref
    assert unpackb(ref) == msgpack.unpackb(ref, raw=False)


@pytest.fixture(scope="module")
def jax_tree():
    jcfg = jax_get_config(ARCH)
    params = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    return jcfg, params, jax.tree.map(jnp.asarray, lora_tree(jcfg, 3))


def _as_port(tree, tcfg):
    params, lora = tree if isinstance(tree, tuple) else (tree, None)
    p = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    if lora is None:
        return p
    return p, lora_from_jax(tcfg, jax.tree.map(np.asarray, lora))


def _bits(x):
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["params", "params+lora"])
def test_jax_checkpoint_loads_bit_exact_and_port_writes_same_bytes(tmp_path, jax_tree,
                                                                   dtype, form):
    jcfg, params, lora = jax_tree
    dt = jnp.dtype(dtype)
    params = jax.tree.map(lambda a: a if a.dtype != jnp.float32 or a.ndim == 0
                          else a.astype(dt), params)
    tree = params if form == "params" else (params, lora)
    jpath = tmp_path / "jax.ckpt"
    jckpt.save_checkpoint(jpath, tree, step=7, metadata={"arch": ARCH, "lr": 3e-4})
    raw = jpath.read_bytes()
    assert unpackb(raw) == msgpack.unpackb(raw, raw=False)

    tcfg = get_config(ARCH)
    port_tree = _as_port(tree, tcfg)
    if dtype == "bfloat16":  # the bridge reads bf16 as fp32: cast back exactly
        port_tree = _cast_like(port_tree, tree)
    assert treedef_str(port_tree) == str(jax.tree_util.tree_flatten(tree)[1])
    loaded, step, meta = load_checkpoint(jpath, port_tree)
    assert step == 7 and meta == {"arch": ARCH, "lr": 3e-4}
    jleaves = jax.tree.leaves(tree)
    assert len(tree_leaves(loaded)) == len(jleaves)
    for t, j in zip(tree_leaves(loaded), jleaves):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        np.testing.assert_array_equal(_bits(t), _bits(j))
    tpath = tmp_path / "port.ckpt"
    save_checkpoint(tpath, port_tree, step=7, metadata={"arch": ARCH, "lr": 3e-4})
    assert tpath.read_bytes() == raw


def _cast_like(port_tree, jtree):
    """Cast the port tree's leaves to the JAX tree's dtypes, leaf by leaf."""
    dts = [str(x.dtype) for x in jax.tree.leaves(jtree)]
    it = iter(dts)

    def walk(t):
        if isinstance(t, dict):
            out = {k: walk(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple):
            return tuple(walk(v) for v in t)
        return t.to(getattr(torch, next(it)))

    return walk(port_tree)


def test_array_records_round_trip():
    for t in (torch.arange(6, dtype=torch.int32).reshape(2, 3),
              torch.randn(3, 4).to(torch.bfloat16), torch.tensor(2.5), torch.zeros(0, 3)):
        for binary in (True, False):
            back = record_array(array_record(t, binary=binary))
            assert back.dtype == t.dtype and back.shape == t.shape
            assert torch.equal(back, t)
    assert record_array(None) is None
    rec = array_record(np.arange(3, dtype=np.float32))
    assert rec["dtype"] == "float32" and rec["shape"] == [3]


def test_serve_ckpt_matches_the_reference_engine(tmp_path, jax_tree, capsys):
    """A params-only checkpoint of merged weights (the deployment form)
    served with ``serve --ckpt`` on the CPU gives the JAX engine's tokens
    on the same file and prompts."""
    jcfg, params, lora = jax_tree
    from repro.training.trainer import merge_lora as jax_merge_lora

    merged = jax_merge_lora(jcfg, params, lora, 0.5)
    path = tmp_path / "merged.ckpt"
    jckpt.save_checkpoint(path, merged, step=1, metadata={"arch": ARCH})
    rep = serve.main(["--arch", ARCH, "--device", "cpu", "--dtype", "float32", "--ckpt",
                      str(path), "--batch", "2", "--prompt-len", "8", "--max-new", "4",
                      "--capacity", "2"])
    assert f"loaded {path}" in capsys.readouterr().out
    jeng = JaxEngine(jcfg, merged, capacity=2, policy="gamma", kernel_backend="ref")
    jr = jeng.generate(serve.make_prompts(jcfg.vocab, 2, 8), max_new_tokens=4)
    np.testing.assert_array_equal(rep["tokens"], np.asarray(jr["tokens"]))
    assert rep["transfers"] == jr["metrics"].transfers
    # the port's own merge writes a file the launcher reads the same way
    tcfg = get_config(ARCH)
    tp, tl = _as_port((params, lora), tcfg)
    path2 = tmp_path / "port_merged.ckpt"
    save_checkpoint(path2, merge_lora(tcfg, tp, tl, 0.5))
    rep2 = serve.run(ARCH, device="cpu", dtype="float32", ckpt=str(path2), batch=2,
                     prompt_len=8, max_new=4, capacity=2)
    np.testing.assert_array_equal(rep2["tokens"], rep["tokens"])
    # a (params, lora) file is not a params-only checkpoint, as in the reference
    both = tmp_path / "both.ckpt"
    jckpt.save_checkpoint(both, (params, lora))
    with pytest.raises(ValueError, match="leaf count"):
        serve.run(ARCH, device="cpu", dtype="float32", ckpt=str(both))


def test_bench_serve_offloaded_on_the_cpu(tmp_path, capsys):
    out = {}
    for sched in ("fcfs", "expert-affinity"):
        results, mt = bench_serve.main(
            ["--arch", ARCH, "--device", "cpu", "--dtype", "float32", "--offloaded",
             "--capacity", "2", "--n-requests", "5", "--slots", "2", "--prompt-len", "10",
             "--max-new", "5", "--arrival", "all_at_once", "--scheduler", sched, "--overlap"])
        text = capsys.readouterr().out
        summary = json.loads(text[text.index("{"):])
        assert summary["requests"] == 5 and summary["transfers"] == mt.transfers > 0
        assert summary["prefetch_transfers"] > 0 and 0 < summary["cache_hit_rate"] < 1
        assert mt.modeled_time_overlapped <= mt.modeled_time_serial
        np.testing.assert_allclose(mt.modeled_time, mt.modeled_time_overlapped, rtol=1e-12)
        out[sched] = [r.tokens.tolist() for r in results]
    assert out["fcfs"] == out["expert-affinity"]
    # the dict engine serves too (tests/test_torch_engine_dict.py holds it)
    results, mt = bench_serve.main(["--arch", ARCH, "--device", "cpu", "--offloaded",
                                    "--engine-impl", "dict", "--n-requests", "1"])
    capsys.readouterr()
    assert len(results) == 1 and mt.transfers > 0
