"""Checkpoints read as a stream (``training.load_checkpoint``: each leaf's
bytes straight from the file into its tensor; ``launch.serve.load_params``
with an ``expert_sink``: each repeat's ``(E, i, o)`` expert matrix into
the engine's host store as it is read) against the whole read the port
made before (``msgpack_lite.unpackb`` of the file's bytes, then
``serial.record_array`` of each leaf), on the CPU:

* the tree is bit-equal to the whole read for a JAX-written fp32 file and
  a port-written bf16 one, at olmoe-mini cut to two repeats (so that an
  expert leaf holds two matrices a name);
* the store filled from the file is bit-equal to the store an engine
  builds from the whole read, for an fp32 file into an fp32, bf16 or INT4
  store and a bf16 file into a bf16 store; the tree's expert leaves stay
  on ``meta``;
* ``serve.run(ckpt=)`` gives ``serve.run()``'s tokens, logits and counts
  on the same weights (bf16, INT4, and with the predictor, whose trace
  keeps the experts on the device too);
* a truncated file, a leaf count or a leaf shape that differs raise
  ``ValueError``;
* in a subprocess at the inflated config of ``tests/_torch_rss.py`` (604
  MB of fp32 experts), ``serve.run(ckpt=)``'s resident-set high-water mark
  as serving starts stays below its baseline + the store + one layer of
  experts + the non-expert weights (the whole read held the file's bytes,
  a copy of each field and a copy of each array, then the store).
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_rss import run_child, write_inflated_checkpoint  # noqa: E402
from _torch_wave import lora_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.offload_engine import HostExpertStore, OffloadedMoEEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.recovery.msgpack_lite import unpackb  # noqa: E402
from repro_torch.recovery.serial import record_array  # noqa: E402
from repro_torch.training import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.training.checkpoint import _unflatten, tree_leaves  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("wg", "wu", "wd")


def _two_repeats(cfg):
    return dataclasses.replace(cfg, layout=(dataclasses.replace(cfg.layout[0], repeats=2),))


def _whole_read(path, like):
    """The read before the stream: the file's bytes, unpacked whole, each
    array record decoded with a copy."""
    payload = unpackb(Path(path).read_bytes())
    return [record_array(rec) for rec in payload["leaves"]], payload["step"], \
        payload["metadata"]


def _like(cfg):
    return init_params(cfg, generator=torch.Generator(), dtype=torch.float32, device="meta")


def _bits(t):
    return t.view(torch.uint8) if t.dim() else t.reshape(1).view(torch.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """olmoe-mini at two repeats: a JAX-written fp32 checkpoint and a
    port-written bf16 one (a port draw from seed 3)."""
    d = tmp_path_factory.mktemp("ckpt")
    jcfg = _two_repeats(jax_get_config("olmoe-mini"))
    tcfg = _two_repeats(get_config("olmoe-mini"))
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    jckpt.save_checkpoint(d / "jax_fp32.ckpt", jparams, step=4, metadata={"from": "jax"})
    save_checkpoint(d / "port_bf16.ckpt",
                    init_params(tcfg, generator=torch.Generator().manual_seed(3),
                                dtype=torch.bfloat16, device="cpu"), step=2)
    return tcfg, {"jax_fp32": d / "jax_fp32.ckpt", "port_bf16": d / "port_bf16.ckpt"}


@pytest.mark.parametrize("name", ["jax_fp32", "port_bf16"])
def test_streamed_tree_is_bit_equal_to_the_whole_read(files, name):
    cfg, paths = files
    like = _like(cfg)
    tree, step, meta = load_checkpoint(paths[name], like)
    want, wstep, wmeta = _whole_read(paths[name], like)
    assert (step, meta) == (wstep, wmeta)
    got = tree_leaves(tree)
    assert len(got) == len(want) == len(tree_leaves(like))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


def test_sliced_leaves_are_handed_over_one_repeat_at_a_time(files):
    cfg, paths = files
    like = _like(cfg)
    names = tree_leaves(serve._leaf_paths(like))
    i = names.index("groups/g0/p0/ffn/wg")
    seen = []
    tree, _, _ = load_checkpoint(paths["jax_fp32"], like,
                                 slices={i: lambda r, t: seen.append((r, t))})
    want = _whole_read(paths["jax_fp32"], like)[0][i]
    assert [r for r, _ in seen] == [0, 1]
    for r, t in seen:
        assert torch.equal(t, want[r])
    assert tree["groups"]["g0"]["p0"]["ffn"]["wg"] is like["groups"]["g0"]["p0"]["ffn"]["wg"]


@pytest.mark.parametrize("name,dtype,quantized", [
    ("jax_fp32", torch.float32, False), ("jax_fp32", torch.bfloat16, False),
    ("jax_fp32", torch.float32, True), ("port_bf16", torch.bfloat16, False)],
    ids=["fp32-to-fp32", "fp32-to-bf16", "fp32-to-int4", "bf16-to-bf16"])
def test_store_read_is_bit_equal_to_the_whole_read_s_store(files, name, dtype, quantized):
    cfg, paths = files
    store = HostExpertStore(cfg, quantized=quantized, device="cpu")
    params, _ = serve.load_params(cfg, paths[name], dtype=dtype, device="cpu",
                                  expert_sink=store.sink)
    layers = store.finish()
    like = _like(cfg)
    whole = _unflatten(like, _whole_read(paths[name], like)[0])
    wparams = params_from_jax(whole, cfg, dtype=dtype)
    eng = OffloadedMoEEngine(cfg, wparams, capacity=2, quantized=quantized, device="cpu")
    assert len(layers) == len(eng.host_store) == cfg.n_moe_layers
    for got, want in zip(layers, eng.host_store):
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert torch.equal(got[k].view(torch.uint8), want[k].view(torch.uint8))
    # every other leaf as the bridge makes it; the experts on meta
    for path, got, want in zip(tree_leaves(serve._leaf_paths(like)), tree_leaves(params),
                               tree_leaves(wparams)):
        if path.rsplit("/", 1)[-1] in KEYS:
            assert got.is_meta and got.shape == want.shape and got.dtype == dtype
        else:
            assert got.dtype == want.dtype and torch.equal(got, want), path


@pytest.mark.parametrize("arch,dtype,quantized,predictor", [
    ("mixtral-8x7b-smoke", torch.bfloat16, False, False),
    ("olmoe-mini", torch.bfloat16, False, False),
    ("mixtral-8x7b-smoke", torch.float32, True, False),
    ("mixtral-8x7b-smoke", torch.float32, False, True)],
    ids=["bf16", "olmoe-mini-bf16", "int4", "predictor"])
def test_run_ckpt_gives_run_s_tokens_and_counts(tmp_path, arch, dtype, quantized, predictor):
    cfg = get_config(arch)
    path = tmp_path / "w.ckpt"
    # run() draws from the same seed, one expert matrix at a time
    save_checkpoint(path, init_params(cfg, generator=torch.Generator().manual_seed(0),
                                      dtype=dtype, device="cpu"))
    kw = dict(batch=2, prompt_len=8, max_new=4, capacity=2, dtype=dtype, device="cpu",
              quantized=quantized, predictor=predictor, n_train_prompts=4)
    got = serve.run(arch, ckpt=str(path), **kw)
    want = serve.run(arch, **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert torch.equal(got["prefill_logits"], want["prefill_logits"])
    for k in ("transfers", "transfer_bytes", "prefetch_transfers", "hits", "misses",
              "evictions", "modeled_time_s", "modeled_time_overlapped_s",
              "host_store_bytes", "slab_bytes", "expert_bytes", "expert_copies"):
        assert got[k] == want[k], k
    assert got["transfers"] > 0
    if predictor:
        assert got["prefetch_transfers"] > 0
        np.testing.assert_array_equal(got["predictor_scores"], want["predictor_scores"])


def test_bad_files_raise_value_error(files, tmp_path):
    cfg, paths = files
    like = _like(cfg)
    raw = paths["jax_fp32"].read_bytes()
    for cut in (len(raw) - 1, len(raw) // 2, 3):
        bad = tmp_path / f"cut{cut}.ckpt"
        bad.write_bytes(raw[:cut])
        with pytest.raises(ValueError, match="truncated"):
            load_checkpoint(bad, like)
    extra = tmp_path / "extra.ckpt"
    extra.write_bytes(raw + b"\xc0")
    with pytest.raises(ValueError, match="extra data"):
        load_checkpoint(extra, like)
    # a (params, lora) file is not a params-only checkpoint
    jcfg = _two_repeats(jax_get_config("olmoe-mini"))
    both = tmp_path / "both.ckpt"
    jckpt.save_checkpoint(both, (jax_init_params(jax.random.key(0), jcfg, jnp.float32),
                                 jax.tree.map(jnp.asarray, lora_tree(jcfg, 1))))
    with pytest.raises(ValueError, match="leaf count"):
        serve.load_params(cfg, both, dtype=torch.float32, device="cpu")
    # a config whose experts are wider
    b = cfg.block_defs["moe"]
    wide = dataclasses.replace(cfg, block_defs={"moe": dataclasses.replace(
        b, moe=dataclasses.replace(b.moe, d_ff=2 * b.moe.d_ff))})
    store = HostExpertStore(wide, device="cpu")
    with pytest.raises(ValueError, match="leaf shape"):
        serve.load_params(wide, paths["jax_fp32"], dtype=torch.float32, device="cpu",
                          expert_sink=store.sink)


# serve.run(ckpt=) at the inflated config, C = 1, one 4-token prompt.
RUN_BODY = r"""
serve.run("mixtral-8x7b-smoke", device="cpu", dtype="float32", batch=1, prompt_len=4,
          max_new=1, capacity=1, ckpt=sys.argv[1])
print(json.dumps({"baseline": baseline, "build_rss": probe[0],
                  "store_bytes": cfg.n_moe_layers * layer_bytes, "layer_bytes": layer_bytes,
                  "nonexpert_bytes": nonexpert_bytes}))
"""


def ckpt_read_rss(src: Path, ckpt: Path, timeout_s: float = 300.0) -> dict:
    """``serve.run(ckpt=)`` of the package under ``src`` in a fresh process."""
    return run_child(RUN_BODY, src, timeout_s, args=[str(ckpt)])


def test_run_ckpt_holds_the_experts_once(tmp_path):
    path = tmp_path / "inflated.ckpt"
    write_inflated_checkpoint(path)
    r = ckpt_read_rss(ROOT / "src", path)
    assert r["store_bytes"] >= 512 * 2**20
    limit = r["baseline"] + r["store_bytes"] + r["layer_bytes"] + r["nonexpert_bytes"]
    assert r["build_rss"] < limit, r
