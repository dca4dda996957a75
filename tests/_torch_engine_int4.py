"""Shared checks of the port's INT4 offload engine (``quantized=True``)
against the JAX slab engine with ``quantized=True, kernel_backend="ref"``
on the CPU.

Both engines compute on the same codes: the JAX engine quantizes its
experts (HQQ, ``iters=4``), and its host store crosses to the port
through ``bridge.quantized_experts_from_jax``. (Quantizing on both sides
would flip a few codes in a million: the zero-point mean sums in another
order, see ``tests/test_torch_quant.py``.) Routed ids per layer, greedy
tokens, transfers and bytes, prefetch counts and bytes, hits, misses,
evictions and both Eq.-3 clocks must then be exactly equal. The JAX
"auto" engine is not the reference: its quantized slab test fails on
this tree (ROADMAP, Queue 3).

The test files ``tests/test_torch_engine_int4.py`` (granite smoke),
``tests/test_torch_engine_int4_olmoe.py`` and
``tests/test_torch_engine_int4_olmoe_gamma.py`` (olmoe-mini cut to 2
layers, lfu and gamma), ``tests/test_torch_engine_int4_paper.py``
(mixtral-8x7b and phi35-moe smoke) and
``tests/test_torch_phi35_offloaded.py`` (phi35-moe smoke at 16 experts)
import the checks below and define the ``models`` fixture for their config (one file per config, and per policy for
olmoe-mini, puts each file's JAX quantization and compile time on its
own worker).
"""
import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.offload_engine as jax_engine_mod  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.offload_engine import PCIE5_H100  # noqa: E402
from repro.core.offload_engine import OffloadedMoEEngine as JaxEngine  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import params_from_jax, quantized_experts_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.offload_engine import HardwareProfile, OffloadedMoEEngine  # noqa: E402
from _torch_mixtral8 import SMOKE as MIXTRAL_SMOKE, eight_experts  # noqa: E402
from _torch_phi16 import SMOKE as PHI_SMOKE, sixteen_experts  # noqa: E402

HW = HardwareProfile(**{f.name: getattr(PCIE5_H100, f.name)
                        for f in dataclasses.fields(HardwareProfile)})


def _two_layers(cfg):
    return dataclasses.replace(cfg, layout=(dataclasses.replace(cfg.layout[0], repeats=2),))


ARCHS = {  # id -> (config name, reduction applied to both packages' configs)
    "granite-smoke": ("granite-moe-1b-a400m-smoke", lambda c: c),
    "olmoe-mini-2l": ("olmoe-mini", _two_layers),
    # the paper's two backbones whose experts do not fit one card
    "mixtral-smoke": ("mixtral-8x7b-smoke", lambda c: c),
    "phi35-smoke": ("phi35-moe-smoke", lambda c: c),
    # Mixtral's expert ratios (8 experts, top-2; tests/_torch_mixtral8.py)
    "mixtral8-smoke": (MIXTRAL_SMOKE, eight_experts),
    # Phi's (16 experts, top-2; tests/_torch_phi16.py)
    "phi16-smoke": (PHI_SMOKE, sixteen_experts),
}

# The JAX engine quantizes every expert eagerly in its constructor, one
# quantize_linear call per expert matrix, and each eager call compiles its
# HQQ scan anew (0.3 s a call: 65 s for olmoe-mini's 2 layers). The memo
# returns what quantize_linear returns for the same bytes: engines of one
# config share the codes of the first, and the experts of each tree that
# ``build`` made are quantized beforehand one stacked (E, i, o) leaf per
# eager call of the same ``quantize`` (its ops act group by group along the
# last axis, so each expert's codes, scales and zero points are the bits of
# its own call; ``_prequantize`` holds one expert against that call).
_QMEMO = {}
_PENDING = []  # JAX trees whose experts _prequantize has not memoized yet
_real_quantize_linear = jax_engine_mod.quantize_linear
_ENGINE_QUANT_KW = {"group": 32, "iters": 4}  # the JAX engine's call


def _memo_key(a: np.ndarray, kw: dict) -> tuple:
    return (hashlib.sha1(a.tobytes()).hexdigest(), a.shape, tuple(sorted(kw.items())))


def _prequantize(jparams) -> None:
    """Memoize quantize_linear(w, **_ENGINE_QUANT_KW) for every expert
    matrix of ``jparams``, one eager ``quantize`` call per stacked leaf."""
    from repro.core.quant import QTensor, quantize

    checked = False
    for g in jparams["groups"].values():
        for blk in g.values():
            ffn = blk.get("ffn", {})
            if "router" not in ffn:
                continue
            for k in ("wg", "wu", "wd"):
                for stack in np.asarray(ffn[k]):  # (E, i, o) a repeat
                    qt = quantize(jnp.swapaxes(jnp.asarray(stack), -1, -2), **_ENGINE_QUANT_KW)
                    packed, scale, zero = (np.asarray(x) for x in (qt.packed, qt.scale, qt.zero))
                    for e, w in enumerate(stack):
                        got = QTensor(packed=jnp.asarray(packed[e]), scale=jnp.asarray(scale[e]),
                                      zero=jnp.asarray(zero[e]), shape=tuple(qt.shape[1:]),
                                      group=qt.group)
                        if not checked:  # the bits of the engine's own call
                            want = _real_quantize_linear(jnp.asarray(w), **_ENGINE_QUANT_KW)
                            assert want.shape == got.shape and want.group == got.group
                            for f in ("packed", "scale", "zero"):
                                np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                                              np.asarray(getattr(want, f)))
                            checked = True
                        _QMEMO[_memo_key(w, _ENGINE_QUANT_KW)] = got


def _memo_quantize_linear(w, **kw):
    a = np.asarray(w)
    key = _memo_key(a, kw)
    while key not in _QMEMO and _PENDING:
        _prequantize(_PENDING.pop())
    if key not in _QMEMO:
        _QMEMO[key] = _real_quantize_linear(w, **kw)
    return _QMEMO[key]


def build(key: str) -> dict:
    """The ``models`` fixture's value for the config ``key`` of ARCHS."""
    name, cut = ARCHS[key]
    jcfg, tcfg = cut(jax_get_config(name)), cut(get_config(name))
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    _PENDING.append(jparams)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    scores = rng.random((jcfg.n_moe_layers, jcfg.moe_spec.num_experts))
    return {key: (jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams), toks, scores)}


# Engines of one config share the first one's compiled steps (the traced
# functions read only the config and the kernel backend from the engine).
_SHARED = {}


def _jax_engine(key, jcfg, jparams, monkeypatch, **kw):
    monkeypatch.setattr(jax_engine_mod, "quantize_linear", _memo_quantize_linear)
    eng = JaxEngine(jcfg, jparams, kernel_backend="ref", hw=PCIE5_H100,
                    quantized=True, impl="slab", **kw)
    names = ("_jit_cache", "_embed_fn", "_next_tok_fn", "_slab_set")
    shared = _SHARED.setdefault(key, {n: getattr(eng, n) for n in names})
    for n, v in shared.items():
        setattr(eng, n, v)
    return eng


def _record_routing(engine):
    """Log every (layer, routed ids) the cache manager is asked for."""
    log = []
    for layer, cache in enumerate(engine.cache.layers):
        def rec(req, _orig=cache.access_batch, _layer=layer):
            log.append((_layer, np.array(req)))
            return _orig(req)
        cache.access_batch = rec
    return log


PREFETCH = pytest.mark.parametrize("prefetch", [False, True], ids=["demand", "prefetch"])
CAP = pytest.mark.parametrize("cap", ["1", "2", "E"])
POLICY = pytest.mark.parametrize("policy", ["lfu", "gamma"])


def check_int4_engine_matches_jax_slab_engine(models, monkeypatch, arch, policy, cap,
                                              prefetch):
    jcfg, tcfg, jparams, tree, toks, scores = models[arch]
    C = jcfg.moe_spec.num_experts if cap == "E" else int(cap)
    je = _jax_engine(arch, jcfg, jparams, monkeypatch, capacity=C, policy=policy)
    te = OffloadedMoEEngine(tcfg, params_from_jax(tree, tcfg), capacity=C,
                            policy=policy, quantized=True,
                            quantized_experts=quantized_experts_from_jax(je.host_store),
                            hw=HW, device="cpu")
    assert te.expert_bytes == je.expert_bytes == je.expert_bytes_q
    jlog, tlog = _record_routing(je), _record_routing(te)
    if prefetch:
        je.prefetch(scores)
        te.prefetch(scores)
    jr = je.generate(toks, max_new_tokens=5)
    tr = te.generate(toks, max_new_tokens=5)

    assert len(jlog) == len(tlog)
    for (jl, jids), (tl, tids) in zip(jlog, tlog):
        assert jl == tl
        np.testing.assert_array_equal(tids, jids)
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
    assert tm.transfers + tm.prefetch_transfers > 0
    if prefetch:
        assert tm.prefetch_transfers > 0


def check_int4_engine_quantizes_itself_like_the_bridged_store(models):
    """Without ``quantized_experts`` the engine quantizes its experts
    (``quantize_linear(iters=4)`` on its device). Against the codes the
    JAX engine made: scales bit-exact, and codes within the tolerance of
    ``test_torch_quant.py`` (at most 1e-5 of them flipped, by one)."""
    jcfg, tcfg, jparams, tree, toks, _ = models["granite-smoke"]
    je = JaxEngine(jcfg, jparams, capacity=2, kernel_backend="ref", quantized=True)
    te = OffloadedMoEEngine(tcfg, params_from_jax(tree, tcfg), capacity=2,
                            quantized=True, device="cpu")
    assert te.quantize_s > 0 and te.expert_bytes == je.expert_bytes_q
    want = quantized_experts_from_jax(je.host_store)
    n_codes = n_diff = 0
    for got_l, want_l in zip(te.quantized_experts(), want):
        for k in ("wg", "wu", "wd"):
            g, w = got_l[k], want_l[k]
            assert torch.equal(g.scale, w.scale)
            d = [((g.packed >> s) & 15).int() - ((w.packed >> s) & 15).int()
                 for s in (0, 4)]
            n_codes += 2 * g.packed.numel()
            n_diff += sum(int((x != 0).sum()) for x in d)
            assert all(int(x.abs().max()) <= 1 for x in d)
    assert n_diff <= 1e-5 * n_codes
    assert te.generate(toks, max_new_tokens=3)["tokens"].shape == (2, 3)
