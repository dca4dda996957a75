"""The predictor's routing trace streamed from the engine's host store
(``inference.routing_trace(host_store=...)``: every forward pass, the
prefill and each decode step, stages each MoE layer with
``core.offload_engine.stage_experts`` as the walk reaches it and drops it
before the next), and ``serve.run(predictor=True)`` built on it, on the CPU:

* the streamed trace's tokens and router distributions are bit-equal to
  the whole-tree trace on mixtral-8x7b-smoke, olmoe-mini and
  deepseek-moe-16b-smoke (a dense block ahead of its MoE block), in fp32
  and bf16, with and without a LoRA tree; it stages each MoE layer once a
  forward pass, ``n_moe_layers x max_new`` stagings in all, and no staged
  layer is alive when the next is staged (weak references);
* tokens equal and probs within 1e-5 (fp32) of the JAX package's
  ``routing_trace`` on the same weights (``bridge.params_from_jax``);
* ``serve.run(predictor=True)`` from a drawn store, from ``--ckpt`` and
  from a given ``host_store`` gives the KL history, Psi's scores, the
  transfers, prefetch transfers and tokens of the whole-tree ``train_psi``
  on the same weights, and traces with every expert leaf on ``meta``;
* a MoE block whose experts are on ``meta`` with no ``experts`` raises
  ``ValueError`` in ``apply_model``, ``prefill`` and ``decode_step``;
* in a subprocess at the inflated config of ``tests/_torch_rss.py`` (604
  MB of fp32 experts), ``serve.run(predictor=True)``'s resident-set
  high-water mark as serving starts stays below its baseline + the store
  + two layers of experts + the non-expert weights (a trace of the whole
  tree holds every expert twice: the tree and the store).
"""
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_rss import run_child  # noqa: E402
from _torch_wave import lora_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.inference.engine import routing_trace as jax_routing_trace  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import lora_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.lora import lora_scale  # noqa: E402
from repro_torch.core.offload_engine import OffloadedMoEEngine, stage_experts  # noqa: E402
from repro_torch.inference import engine as inference_engine  # noqa: E402
from repro_torch.inference import routing_trace  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import (apply_model, decode_step, init_cache,  # noqa: E402
                                      init_params, prefill)
from repro_torch.models.runtime import Runtime  # noqa: E402
from repro_torch.training import save_checkpoint  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["mixtral-8x7b-smoke", "olmoe-mini", "deepseek-moe-16b-smoke"]
MAX_NEW = 4


class Staged:
    """``stage_experts`` counted: the stagings, and the most earlier staged
    tensors still alive (weak references) when a layer is staged."""

    def __init__(self):
        self.calls, self.refs, self.alive_at_stage = 0, [], 0

    def __call__(self, layer, device):
        self.alive_at_stage = max(self.alive_at_stage,
                                  sum(r() is not None for r in self.refs))
        self.calls += 1
        out = stage_experts(layer, device)
        self.refs += [weakref.ref(t) for t in out.values()]
        return out


def _draws(cfg, dtype):
    """The seed's tree with its experts (the whole tree), and the same
    draw offloaded: (whole, params with meta experts, the host store)."""
    whole = init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=dtype,
                        device="cpu")
    params, store, _ = serve.offloaded_params(cfg, dtype=dtype, device="cpu")
    return whole, params, store


@pytest.fixture(scope="module")
def draws():
    """``_draws`` once per config and dtype for the module's tests (a
    trace reads the trees and the store and writes none of them)."""
    memo = {}

    def get(cfg, dtype):
        if (cfg.name, dtype) not in memo:
            memo[cfg.name, dtype] = _draws(cfg, dtype)
        return memo[cfg.name, dtype]

    yield get
    memo.clear()


@pytest.mark.parametrize("lora", [False, True], ids=["nolora", "lora"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_trace_is_bit_equal_to_the_whole_tree(monkeypatch, draws, arch, dtype, lora):
    cfg = get_config(arch)
    whole, params, store = draws(cfg, dtype)
    kw = {}
    if lora:
        kw = dict(lora=lora_from_jax(cfg, lora_tree(cfg, 1), dtype=dtype),
                  lora_scale=lora_scale(cfg.melinoe))
    staged = Staged()
    monkeypatch.setattr(inference_engine, "stage_experts", staged)
    prompts = serve.make_prompts(cfg.vocab, 4, 8)
    want_t, want_p = routing_trace(cfg, whole, prompts, max_new=MAX_NEW, **kw)
    assert staged.calls == 0
    got_t, got_p = routing_trace(cfg, params, prompts, max_new=MAX_NEW, host_store=store,
                                 **kw)
    assert got_p.shape == (4, cfg.n_moe_layers, MAX_NEW - 1, cfg.moe_spec.num_experts)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_p, want_p)
    # each MoE layer staged once a forward pass (the prefill and MAX_NEW - 1
    # decode steps), each dropped before the next is staged
    assert staged.calls == cfg.n_moe_layers * MAX_NEW
    assert staged.alive_at_stage == 0
    assert all(r() is None for r in staged.refs)


@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_trace_stages_one_layer_at_a_time_whatever_the_batch(monkeypatch, draws, arch):
    cfg = get_config(arch)
    _, params, store = draws(cfg, torch.float32)
    for n, max_new in ((1, 2), (7, 5)):
        staged = Staged()
        monkeypatch.setattr(inference_engine, "stage_experts", staged)
        routing_trace(cfg, params, serve.make_prompts(cfg.vocab, n, 6), max_new=max_new,
                      host_store=store)
        assert staged.calls == cfg.n_moe_layers * max_new
        assert staged.alive_at_stage == 0


@pytest.mark.parametrize("lora", [False, True], ids=["nolora", "lora"])
@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_trace_matches_the_jax_reference(arch, lora):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    # the bridged experts into an engine's store; the tree's own are not read
    store = OffloadedMoEEngine(tcfg, tparams, capacity=2, device="cpu").host_store
    serve._experts_to_meta(tcfg, tparams)
    jkw, tkw = {}, {}
    if lora:
        lt = lora_tree(jcfg, 1)
        sc = lora_scale(tcfg.melinoe)
        jkw = dict(lora=jax.tree.map(jnp.asarray, lt), lora_scale=sc)
        tkw = dict(lora=lora_from_jax(tcfg, lt), lora_scale=sc)
    prompts = serve.make_prompts(tcfg.vocab, 3, 8)
    jt, jp = jax_routing_trace(jcfg, jparams, prompts, max_new=MAX_NEW, **jkw)
    tt, tp = routing_trace(tcfg, tparams, prompts, max_new=MAX_NEW, host_store=store, **tkw)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_allclose(tp, np.asarray(jp), **TOL)


def test_an_int4_store_is_not_traced():
    cfg = get_config("mixtral-8x7b-smoke")
    eng_store = OffloadedMoEEngine(
        cfg, init_params(cfg, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu"),
        capacity=2, quantized=True, device="cpu").host_store
    params, _, _ = serve.offloaded_params(cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="INT4"):
        routing_trace(cfg, params, serve.make_prompts(cfg.vocab, 2, 6), max_new=2,
                      host_store=eng_store)
    with pytest.raises(ValueError, match="MoE layers"):
        routing_trace(cfg, params, serve.make_prompts(cfg.vocab, 2, 6), max_new=2,
                      host_store=eng_store[:1])


# -- serve.run(predictor=True) against the whole-tree train_psi ------------

RUN = dict(batch=2, prompt_len=8, max_new=4, capacity=2, n_train_prompts=4)


def _whole_tree_run(cfg, whole, dtype):
    """``run(predictor=True)``'s steps on the whole tree ``whole``: the
    whole-tree trace, Psi, the engine built from the tree, its prefetch."""
    b = RUN["batch"]
    prompts = serve.make_prompts(cfg.vocab, b + RUN["n_train_prompts"], RUN["prompt_len"])
    scores, psi = serve.train_psi(cfg, whole, prompts[b:], prompts[:b], device="cpu")
    eng = OffloadedMoEEngine(cfg, whole, capacity=RUN["capacity"], policy="gamma",
                             device="cpu")
    eng.prefetch(scores)
    return eng.generate(prompts[:b], max_new_tokens=RUN["max_new"]), psi


@pytest.mark.parametrize("source", ["drawn", "ckpt", "host_store"])
def test_run_predictor_traces_from_the_store(monkeypatch, tmp_path, source):
    arch, dtype = "mixtral-8x7b-smoke", torch.float32
    cfg = get_config(arch)
    kw = dict(RUN, dtype=dtype, device="cpu")
    if source == "ckpt":
        path = tmp_path / "w.ckpt"
        save_checkpoint(path, init_params(cfg, generator=torch.Generator().manual_seed(5),
                                          dtype=dtype, device="cpu"))
        kw["ckpt"] = str(path)
        whole, _ = serve.load_params(cfg, path, dtype=dtype, device="cpu")
    else:
        whole = init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=dtype,
                            device="cpu")
    if source == "host_store":
        kw["host_store"] = serve.run(arch, keep_store=True, **RUN, dtype=dtype,
                                     device="cpu")["host_store"]
    traces = []
    real = serve.routing_trace

    def traced(cfg, params, prompts, **k):
        ffns = [params["groups"][g][p]["ffn"] for g in params["groups"]
                for p in params["groups"][g] if "wg" in params["groups"][g][p]["ffn"]]
        traces.append((k["host_store"] is not None,
                       all(f[n].is_meta for f in ffns for n in ("wg", "wu", "wd"))))
        return real(cfg, params, prompts, **k)

    monkeypatch.setattr(serve, "routing_trace", traced)
    rep = serve.run(arch, predictor=True, **kw)
    assert traces == [(True, True)]
    res, psi = _whole_tree_run(cfg, whole, dtype)
    assert rep["predictor_kl"] == psi["predictor_kl"]
    assert rep["predictor_kl"][-1] < rep["predictor_kl"][0]
    np.testing.assert_array_equal(rep["predictor_scores"], psi["predictor_scores"])
    np.testing.assert_array_equal(rep["tokens"], res["tokens"].numpy())
    m = res["metrics"]
    assert (rep["transfers"], rep["prefetch_transfers"]) == (m.transfers, m.prefetch_transfers)
    assert rep["prefetch_transfers"] > 0
    assert rep["trace_s"] > 0 and rep["trace_max_memory_allocated"] is None


def test_run_predictor_refuses_a_given_int4_store():
    arch = "mixtral-8x7b-smoke"
    store = serve.run(arch, keep_store=True, quantized=True, **RUN, dtype=torch.float32,
                      device="cpu")["host_store"]
    with pytest.raises(ValueError, match="INT4"):
        serve.run(arch, predictor=True, quantized=True, host_store=store, **RUN,
                  dtype=torch.float32, device="cpu")


# -- a MoE block on meta experts without experts= --------------------------

@pytest.mark.parametrize("entry", ["apply_model", "prefill", "decode_step"])
def test_meta_experts_without_a_stager_raise(entry):
    cfg = get_config("deepseek-moe-16b-smoke")  # the MoE block at position 1
    params, store, _ = serve.offloaded_params(cfg, dtype=torch.float32, device="cpu")
    rt = Runtime(device="cpu", zero_drop=True)
    toks = torch.as_tensor(serve.make_prompts(cfg.vocab, 2, 6), dtype=torch.long)
    with pytest.raises(ValueError, match=r"MoE layer 0 \(group 0, position 1, repeat 0\)"):
        if entry == "apply_model":
            apply_model(params, cfg, toks, rt)
        elif entry == "prefill":
            prefill(params, cfg, toks, rt)
        else:
            decode_step(params, cfg, toks[:, :1],
                        init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu"), rt)
    # with the stager the same call runs
    stager = inference_engine.ServingEngine(cfg, params, host_store=store).experts
    logits, _ = apply_model(params, cfg, toks, rt, experts=stager)
    assert torch.isfinite(logits).all()


# -- host memory at the inflated config -----------------------------------

# serve.run(predictor=True) at the inflated config of tests/_torch_rss.py
# (604 MB of fp32 experts), on the CPU at C = 1 with one 4-token prompt and
# two training prompts, 16 traced tokens each.
PSI_BODY = r"""
rep = serve.run("mixtral-8x7b-smoke", device="cpu", dtype="float32", batch=1,
                prompt_len=4, max_new=1, capacity=1, predictor=True, n_train_prompts=2)
print(json.dumps({"baseline": baseline, "build_rss": probe[0],
                  "host_store_bytes": rep["host_store_bytes"], "layer_bytes": layer_bytes,
                  "nonexpert_bytes": nonexpert_bytes}))
"""


def predictor_rss(src: Path, timeout_s: float = 300.0) -> dict:
    """Run ``serve --predictor`` against the package under ``src`` in a
    fresh process."""
    return run_child(PSI_BODY, src, timeout_s)


def test_run_predictor_holds_the_experts_once():
    r = predictor_rss(ROOT / "src")
    assert r["host_store_bytes"] >= 512 * 2**20
    limit = r["baseline"] + r["host_store_bytes"] + 2 * r["layer_bytes"] + r["nonexpert_bytes"]
    assert r["build_rss"] < limit, r
