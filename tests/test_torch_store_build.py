"""The offload engine's host store built one expert matrix at a time, as
``launch.serve.run`` draws the experts (``HostExpertStore.sink`` as
``init_params``' ``expert_sink``), against the store the engine builds
from a tree whose experts were drawn whole into host memory first (the
two-copy build): bit-equal in bf16, fp32 and INT4; ``serve.run`` gives
the tokens and counts of the two-copy build; and a subprocess at a
config of 604 MB of fp32 experts whose resident-set high-water mark,
when the store is built, stays below the store plus one layer of experts
over its own baseline (the two-copy build holds every expert twice)."""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.offload_engine import (HostExpertStore,  # noqa: E402
                                             OffloadedMoEEngine)
from repro_torch.core.quant import matmul_layout, quantize_linear  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from _torch_rss import run_child  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mixtral-8x7b-smoke"
KEYS = ("wg", "wu", "wd")


def _two_copy(cfg, dtype, quantized):
    """The experts drawn whole into host memory, then copied by the
    engine into its store: (params, engine)."""
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=dtype,
                         device="cpu", expert_device="cpu")
    eng = OffloadedMoEEngine(cfg, params, capacity=2, quantized=quantized, device="cpu")
    return params, eng


def _sinked(cfg, dtype, quantized):
    store = HostExpertStore(cfg, quantized=quantized, device="cpu")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=dtype,
                         device="cpu", expert_sink=store.sink)
    return params, store.finish()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("dtype,quantized", [(torch.bfloat16, False), (torch.float32, False),
                                             (torch.float32, True)],
                         ids=["bf16", "fp32", "int4"])
def test_store_drawn_into_is_bit_equal_to_two_copy_store(dtype, quantized):
    cfg = get_config(ARCH)
    whole, eng = _two_copy(cfg, dtype, quantized)
    params, store = _sinked(cfg, dtype, quantized)
    assert len(store) == len(eng.host_store) == cfg.n_moe_layers
    for got, want in zip(store, eng.host_store):
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert torch.equal(got[k].view(torch.uint8), want[k].view(torch.uint8))
    # the layout itself: each layer's experts from the whole tree, in the
    # engine's layer order (g0 repeat 0: p0, p1)
    ffns = [whole["groups"]["g0"][f"p{pi}"]["ffn"] for pi in range(2)]
    for layer, ffn in zip(store, ffns):
        if quantized:
            buf = layer["q"]
            assert buf.shape == (cfg.moe_spec.num_experts, eng.expert_bytes)
            off = 0
            for k in KEYS:
                mq = matmul_layout(quantize_linear(ffn[k][0], iters=4, group=32))
                for leaf in ("packed", "scale", "zero"):
                    src = getattr(mq, leaf).reshape(buf.shape[0], -1)
                    n = src[0].numel() * src.element_size()
                    for e in range(buf.shape[0]):
                        assert torch.equal(buf[e, off:off + n], src[e].view(torch.uint8))
                    off += n
            assert off == eng.expert_bytes
        else:
            (storage,) = {v.untyped_storage().data_ptr() for v in layer.values()}
            for i, k in enumerate(KEYS):
                assert torch.equal(layer[k], ffn[k][0])
                for e in range(layer[k].shape[0]):  # each expert's matrices contiguous
                    assert layer[k][e].is_contiguous()
                    assert (layer[k][e].data_ptr() - layer["wg"][0].data_ptr()
                            == (3 * e + i) * layer[k][e].nbytes)
    # the rest of the tree is the same draw; the experts stay on meta
    got, want = dict(_leaves(params)), dict(_leaves(whole))
    assert got.keys() == want.keys()
    for path, v in got.items():
        if path.rsplit("/", 1)[-1] in KEYS and "/ffn/" in path:
            assert v.is_meta and v.shape == want[path].shape
        else:
            assert torch.equal(v, want[path]), path


def test_store_finish_refuses_a_layer_not_written():
    cfg = get_config(ARCH)
    store = HostExpertStore(cfg, device="cpu")
    w = torch.zeros(cfg.moe_spec.num_experts, cfg.d_model, cfg.moe_spec.d_ff)
    store.put(0, "wg", w)
    with pytest.raises(ValueError, match="MoE layer 0 holds"):
        store.finish()


def _serve_two_copy(arch, *, dtype, quantized, predictor, **kw):
    """``serve.run``'s path with the experts drawn whole into host memory
    first and copied into the engine's store (the build before the store
    was drawn into)."""
    cfg = get_config(arch)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=dtype,
                         device="cpu", expert_device="cpu")
    n_train = 4 if predictor else 0
    prompts = serve.make_prompts(cfg.vocab, kw["batch"] + n_train, kw["prompt_len"])
    scores = None
    if predictor:
        scores, _ = serve.train_psi(cfg, params, prompts[kw["batch"]:],
                                    prompts[:kw["batch"]], device="cpu")
    eng = OffloadedMoEEngine(cfg, params, capacity=kw["capacity"], policy="gamma",
                             quantized=quantized, device="cpu")
    if predictor:
        eng.prefetch(scores)
    return eng.generate(prompts[:kw["batch"]], max_new_tokens=kw["max_new"]), eng


@pytest.mark.parametrize("dtype,quantized,predictor",
                         [(torch.bfloat16, False, False), (torch.float32, True, False),
                          (torch.float32, False, True)], ids=["bf16", "int4", "predictor"])
def test_serve_run_gives_the_two_copy_build_s_tokens_and_counts(dtype, quantized, predictor):
    kw = dict(batch=2, prompt_len=8, max_new=4, capacity=2)
    rep = serve.run(ARCH, dtype=dtype, device="cpu", quantized=quantized, predictor=predictor,
                    n_train_prompts=4, **kw)
    res, eng = _serve_two_copy(ARCH, dtype=dtype, quantized=quantized, predictor=predictor,
                               **kw)
    np.testing.assert_array_equal(rep["tokens"], res["tokens"].numpy())
    assert torch.equal(rep["prefill_logits"], res["prefill_logits"].cpu())
    m, st = res["metrics"], res["cache_stats"]
    assert (rep["transfers"], rep["transfer_bytes"], rep["prefetch_transfers"]) == \
        (m.transfers, m.transfer_bytes, m.prefetch_transfers)
    assert (rep["hits"], rep["misses"], rep["evictions"]) == (st.hits, st.misses, st.evictions)
    assert rep["modeled_time_s"] == res["modeled_time_s"]
    assert rep["modeled_time_overlapped_s"] == res["modeled_time_overlapped_s"]
    assert (rep["host_store_bytes"], rep["slab_bytes"], rep["expert_bytes"]) == \
        (eng.host_store_bytes, eng.slab_bytes, eng.expert_bytes)
    assert rep["quantize_s"] > 0 if quantized else rep["quantize_s"] == 0
    assert rep["max_rss_after_build"] > 0 and rep["build_s"] > 0
    if predictor:
        assert rep["prefetch_transfers"] > 0
    if Path("/proc/meminfo").exists():
        assert rep["host_available_before_build"] > 0
        assert rep["host_available_after_build"] > 0


# serve.run at the inflated config of tests/_torch_rss.py (604 MB of fp32
# experts), served on the CPU at C = 1 (slabs 75 MB) with one 4-token prompt.
RSS_BODY = r"""
rep = serve.run("mixtral-8x7b-smoke", device="cpu", dtype="float32", batch=1,
                prompt_len=4, max_new=1, capacity=1)
print(json.dumps({"baseline": baseline, "build_rss": probe[0],
                  "host_store_bytes": rep["host_store_bytes"],
                  "layer_bytes": layer_bytes}))
"""


def store_build_rss(src: Path, timeout_s: float = 300.0) -> dict:
    """Run the build against the package under ``src`` in a fresh process."""
    return run_child(RSS_BODY, src, timeout_s)


def test_store_build_holds_the_experts_once():
    r = store_build_rss(ROOT / "src")
    assert r["host_store_bytes"] >= 512 * 2**20
    limit = r["baseline"] + r["host_store_bytes"] + r["layer_bytes"]
    assert r["build_rss"] < limit, r


@pytest.mark.parametrize("experts", ["int4", "bf16"])
def test_predictor_refuses_experts_that_do_not_fit_the_card(monkeypatch, experts):
    """``--predictor`` with INT4 experts traces the whole model on the card
    (the INT4 store keeps no full-precision experts to stage): where the
    experts alone exceed its free memory (Mixtral's 84.0 GiB on an 80 GB
    card) it raises instead of drawing them there; on the CPU it does not
    check. With bf16 (any full-precision) experts the trace stages them
    from the store, and ``run`` never calls the check."""
    called = []
    check = serve._check_trace_fits

    def counted(*a):
        called.append(a)
        return check(*a)

    monkeypatch.setattr(serve, "_check_trace_fits", counted)
    kw = dict(batch=1, prompt_len=6, max_new=2, capacity=2, n_train_prompts=2,
              device="cpu", predictor=True)
    if experts == "int4":
        cfg = get_config("mixtral-8x7b")
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda dev=None: (80 * 10**9, 85 * 10**9))
        with pytest.raises(NotImplementedError, match="INT4 experts: the routing trace"):
            serve._check_trace_fits(cfg, torch.bfloat16, torch.device("cuda"))
        small = get_config("olmoe")  # 12.9 GB of bf16 experts
        serve._check_trace_fits(small, torch.bfloat16, torch.device("cuda"))
        serve._check_trace_fits(cfg, torch.bfloat16, torch.device("cpu"))
        called.clear()
        serve.run(ARCH, dtype=torch.float32, quantized=True, **kw)
        assert len(called) == 1
    else:
        rep = serve.run(ARCH, dtype=torch.bfloat16, **kw)
        assert called == [] and rep["prefetch_transfers"] > 0
