"""The port's offload engine on models whose layers are not all
``attn_moe``, against the JAX slab engine on the CPU
(``kernel_backend="ref"``), from the same bridged weights:

* ``deepseek-moe-16b-smoke`` (a dense first layer, then MoE layers with
  two shared experts): fp experts with and without LoRA, and HQQ INT4 on
  the codes the JAX engine made (carried across by the bridge);
* a hand-built ``mamba`` + ``attn_moe`` config and a hand-built
  ``shared_attn`` + ``attn_moe`` config, built identically in both
  packages (``tests/test_torch_engine_hybrid.py``, through ``build`` and
  ``run_case`` below).

Greedy tokens, demand and prefetch transfers, hits, misses and evictions
and both Eq.-3 clocks must equal the reference's; so must the tokens and
``stopped_early`` of a ``deadline_s`` call.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_wave import lora_tree  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.offload_engine import PCIE5_H100  # noqa: E402
from repro.core.offload_engine import OffloadedMoEEngine as JaxEngine  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import lora_from_jax, params_from_jax, quantized_experts_from_jax  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.lora import lora_scale  # noqa: E402
from repro_torch.core.offload_engine import HardwareProfile, OffloadedMoEEngine  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

HW = HardwareProfile(**{f.name: getattr(PCIE5_H100, f.name)
                        for f in dataclasses.fields(HardwareProfile)})


def hand_built(base, kind: str):
    """A two-repeat model of ``kind`` + ``attn_moe`` at smoke widths, from
    ``base`` (either package's ``configs.base``)."""
    attn = base.AttnSpec(n_heads=4, n_kv_heads=2, head_dim=16)
    moe_blk = base.BlockSpec(kind="attn_moe", attn=attn,
                             moe=base.MoESpec(num_experts=8, top_k=2, d_ff=64))
    if kind == "mamba":
        other = base.BlockSpec(kind="mamba", ssm=base.SSMSpec(d_state=16, head_dim=32,
                                                              chunk=8))
    else:
        other = base.BlockSpec(kind="shared_attn", attn=attn, d_ff=96)
    return base.ModelConfig(
        name=f"hand-{kind}-moe", family="hybrid", d_model=64, vocab=256,
        block_defs={"other": other, "moe": moe_blk},
        layout=(base.LayoutGroup(("other", "moe"), 2),), dtype="float32",
        melinoe=base.MelinoeSpec(lora_rank=4))


ARCHS = {  # id -> (JAX config, port config, cache capacity)
    "deepseek-smoke": (lambda: jax_get_config("deepseek-moe-16b-smoke"),
                       lambda: get_config("deepseek-moe-16b-smoke"), 2),
    "mamba+moe": (lambda: hand_built(jbase, "mamba"),
                  lambda: hand_built(tbase, "mamba"), 3),
    "shared_attn+moe": (lambda: hand_built(jbase, "shared_attn"),
                        lambda: hand_built(tbase, "shared_attn"), 3),
}


def build(keys):
    out = {}
    for key in keys:
        jmk, tmk, C = ARCHS[key]
        jcfg, tcfg = jmk(), tmk()
        jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
        rng = np.random.default_rng(3)
        toks = rng.integers(0, jcfg.vocab, (2, 10)).astype(np.int32)
        scores = rng.random((jcfg.n_moe_layers, jcfg.moe_spec.num_experts))
        out[key] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                        tree=jax.tree.map(np.asarray, jparams), toks=toks,
                        scores=scores, C=C, lora=lora_tree(jcfg, 2))
    return out


@pytest.fixture(scope="module")
def models():
    return build(["deepseek-smoke"])


_SHARED = {}


def _jax_engine(key, m, **kw):
    eng = JaxEngine(m["jcfg"], m["jparams"], capacity=m["C"], policy="gamma",
                    kernel_backend="ref", hw=PCIE5_H100, impl="slab", **kw)
    names = ("_jit_cache", "_embed_fn", "_next_tok_fn", "_slab_scatter", "_slab_set")
    shared = _SHARED.setdefault((key, kw.get("quantized", False)),
                                {n: getattr(eng, n) for n in names})
    for n, v in shared.items():
        setattr(eng, n, v)
    return eng


def assert_same_run(jr, tr):
    np.testing.assert_array_equal(tr["tokens"].numpy(), np.asarray(jr["tokens"]))
    jm, tm = jr["metrics"], tr["metrics"]
    assert (tm.transfers, tm.transfer_bytes) == (jm.transfers, jm.transfer_bytes)
    assert (tm.prefetch_transfers, tm.prefetch_bytes) == \
        (jm.prefetch_transfers, jm.prefetch_bytes)
    assert tm.decode_tokens == jm.decode_tokens
    js, ts = jr["cache_stats"], tr["cache_stats"]
    assert (ts.hits, ts.misses, ts.evictions) == (js.hits, js.misses, js.evictions)
    assert tr["modeled_time_s"] == jr["modeled_time_s"]
    assert tr["modeled_time_overlapped_s"] == jr["modeled_time_overlapped_s"]
    assert tr["stopped_early"] == jr["stopped_early"]


def run_case(m, key, variant):
    # one scale for every engine: the JAX steps shared between engines
    # keep the scale of the engine that traced them
    sc = lora_scale(m["jcfg"].melinoe)
    kw, tkw = dict(lora_scale=sc), dict(lora_scale=sc)
    if variant == "fp+lora":
        kw["lora"] = jax.tree.map(jnp.asarray, m["lora"])
        tkw["lora"] = lora_from_jax(m["tcfg"], m["lora"])
    je = _jax_engine(key, m, quantized=variant == "int4", **kw)
    if variant == "int4":
        tkw = dict(quantized=True, quantized_experts=quantized_experts_from_jax(je.host_store))
    te = OffloadedMoEEngine(m["tcfg"], params_from_jax(m["tree"], m["tcfg"]),
                            capacity=m["C"], policy="gamma", hw=HW, device="cpu", **tkw)
    je.prefetch(m["scores"])
    te.prefetch(m["scores"])
    jr = je.generate(m["toks"], max_new_tokens=5)
    tr = te.generate(m["toks"], max_new_tokens=5)
    assert_same_run(jr, tr)
    assert tr["metrics"].transfers > 0
    # a budget the prefill alone spends: both stop before the first
    # decode step (mid-decode cuts: tests/test_torch_wave.py's SLO case)
    jr = je.generate(m["toks"], max_new_tokens=5, deadline_s=1e-9)
    tr = te.generate(m["toks"], max_new_tokens=5, deadline_s=1e-9)
    assert_same_run(jr, tr)
    assert tr["stopped_early"] and tr["tokens"].shape == (2, 1)


@pytest.mark.parametrize("variant", ["fp", "fp+lora", "int4"])
def test_engine_blocks_match_jax(models, variant):
    run_case(models["deepseek-smoke"], "deepseek-smoke", variant)


def test_pinned_store_is_released_with_its_views(monkeypatch):
    """The engine's page-locked store buffer: registered once at its exact
    size, unregistered once when the last tensor made of it goes, and its
    memory freed then (the registration itself is faked: no card here)."""
    import gc

    from repro_torch.core import offload_engine as oe

    calls = []

    class FakeCudart:
        def cudaHostRegister(self, ptr, n, flags):
            calls.append(("register", ptr, n))
            return 0

        def cudaHostUnregister(self, ptr):
            calls.append(("unregister", ptr))
            return 0

    monkeypatch.setattr(torch.cuda, "cudart", lambda: FakeCudart())
    monkeypatch.setattr(torch.cuda, "check_error", lambda err: None)
    buf = oe._host_buffer((4, 3, 1000), torch.bfloat16, pin=True)
    assert buf.shape == (4, 3, 1000) and buf.dtype == torch.bfloat16
    assert calls == [("register", buf.data_ptr(), 4 * 3 * 1000 * 2)]
    assert buf.data_ptr() % 4096 == 0
    views = [buf[:, i].unflatten(1, (10, 100)) for i in range(3)]
    views[0].fill_(1.0)
    del buf
    gc.collect()
    assert len(calls) == 1  # the views still hold the memory: still locked
    del views
    gc.collect()
    assert calls[1][0] == "unregister" and calls[1][1] == calls[0][1] and len(calls) == 2
