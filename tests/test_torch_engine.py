"""Port slab offload engine vs the JAX slab engine (``impl="slab"``,
``kernel_backend="ref"``) on the CPU, from the same bridged weights.

Per-layer routed expert ids are compared first, so that a top-k near
tie would show as itself; then greedy tokens, transfers, prefetch
transfers, hits, misses and evictions must be equal, and both Eq.-3
clocks equal under one HardwareProfile (they are computed from counts in
the same order, so exactly).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.offload_engine import PCIE5_H100  # noqa: E402
from repro.core.offload_engine import OffloadedMoEEngine as JaxEngine  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.offload_engine import HardwareProfile, OffloadedMoEEngine  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

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
}


@pytest.fixture(scope="module")
def models():
    out = {}
    for key, (name, cut) in ARCHS.items():
        jcfg, tcfg = cut(jax_get_config(name)), cut(get_config(name))
        jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
        rng = np.random.default_rng(7)
        toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
        scores = rng.random((jcfg.n_moe_layers, jcfg.moe_spec.num_experts))
        out[key] = (jcfg, tcfg, jparams, jax.tree.map(np.asarray, jparams), toks,
                    scores)
    return out


# The JAX engine keeps its jit cache per instance, so each new engine
# would compile every step again. Engines of one config share the first
# one's compiled steps here: the traced functions read only the config
# and the kernel backend from the engine, which are the same for all.
_SHARED = {}


def _jax_engine(key, jcfg, jparams, **kw):
    eng = JaxEngine(jcfg, jparams, kernel_backend="ref", hw=PCIE5_H100, **kw)
    names = ("_jit_cache", "_embed_fn", "_next_tok_fn", "_slab_scatter")
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


@pytest.mark.parametrize("prefetch", [False, True], ids=["demand", "prefetch"])
@pytest.mark.parametrize("cap", ["1", "2", "E"])
@pytest.mark.parametrize("policy", ["lru", "lfu", "gamma"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_engine_matches_jax_slab_engine(models, arch, policy, cap, prefetch):
    jcfg, tcfg, jparams, tree, toks, scores = models[arch]
    C = jcfg.moe_spec.num_experts if cap == "E" else int(cap)
    je = _jax_engine(arch, jcfg, jparams, capacity=C, policy=policy, impl="slab")
    te = OffloadedMoEEngine(tcfg, params_from_jax(tree, tcfg), capacity=C,
                            policy=policy, hw=HW, device="cpu")
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
    if prefetch:
        assert tm.prefetch_transfers > 0
