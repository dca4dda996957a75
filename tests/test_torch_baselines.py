"""The paper's comparison systems (``core/baselines.py``, Sec 4.2) in the
port against the JAX package on the CPU: every ``BASELINES`` entry but
``quant_cache`` (INT4: ``tests/test_torch_baselines_int4.py``) through
both packages' ``make_engine`` on ``olmoe-mini-smoke``, and the two
engine baselines (``stream_all``, ``cpu_execute``) also on
``deepseek-moe-16b-smoke`` (a dense first layer, shared experts). The
JAX engines run with ``kernel_backend="ref"`` in fp32, from the same
weights (JAX init, key 0, bridged).

Exact, as the ROADMAP's parity rules ask: greedy tokens, demand and
prefetch transfers and bytes, hits, misses, evictions, ``host_executed``
and both Eq.-3 clocks (``host_time`` included). The ``ProfilePrefetcher``
(numpy k-means) equals the reference's bit for bit. About 25 s alone on
an 8-core CPU, mostly the JAX engines' compiles (the engines of one
config share the first one's compiled steps).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import baselines as jb  # noqa: E402
from repro.core.offload_engine import PCIE5_H100  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core.offload_engine import HardwareProfile  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

HW = HardwareProfile(**{f.name: getattr(PCIE5_H100, f.name)
                        for f in dataclasses.fields(HardwareProfile)})
ARCHS = {"olmoe-smoke": "olmoe-mini-smoke", "deepseek-smoke": "deepseek-moe-16b-smoke"}
C = 2
NEW = 5


@pytest.fixture(scope="module")
def models():
    out = {}
    for key, name in ARCHS.items():
        jcfg, tcfg = jax_get_config(name), get_config(name)
        jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
        toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 10)).astype(np.int32)
        out[key] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                        tree=jax.tree.map(np.asarray, jparams), toks=toks)
    return out


_SHARED = {}


def _run_both(m, key, name):
    spec = jb.BASELINES[name]
    je = jb.make_engine(m["jcfg"], m["jparams"], spec, capacity=C, hw=PCIE5_H100)
    names = ("_jit_cache", "_embed_fn", "_next_tok_fn", "_slab_scatter", "_slab_set")
    for n, v in _SHARED.setdefault(key, {n: getattr(je, n) for n in names}).items():
        setattr(je, n, v)
    te = tb.make_engine(m["tcfg"], params_from_jax(m["tree"], m["tcfg"]),
                        tb.BASELINES[name], capacity=C, hw=HW, device="cpu")
    assert te.capacity == je.capacity
    jr = je.generate(m["toks"], max_new_tokens=NEW)
    tr = te.generate(m["toks"], max_new_tokens=NEW)
    np.testing.assert_array_equal(tr["tokens"].numpy(), np.asarray(jr["tokens"]))
    jm, tm = jr["metrics"], tr["metrics"]
    for f in ("transfers", "transfer_bytes", "prefetch_transfers", "prefetch_bytes",
              "host_executed", "host_time", "decode_tokens", "degraded_uses"):
        assert getattr(tm, f) == getattr(jm, f), f
    js, ts = jr["cache_stats"], tr["cache_stats"]
    assert (ts.hits, ts.misses, ts.evictions) == (js.hits, js.misses, js.evictions)
    assert tr["modeled_time_s"] == jr["modeled_time_s"]
    assert tr["modeled_time_overlapped_s"] == jr["modeled_time_overlapped_s"]
    return te, tr


@pytest.mark.parametrize("name", [n for n in jb.BASELINES if n != "quant_cache"])
def test_baseline_matches_reference(models, name):
    m = models["olmoe-smoke"]
    te, tr = _run_both(m, "olmoe-smoke", name)
    tm = tr["metrics"]
    if name == "stream_all":
        # N * K per MoE layer and step: the prompt's tokens, then B a step
        B, T = m["toks"].shape
        K = m["tcfg"].moe_spec.top_k
        assert tm.transfers == m["tcfg"].n_moe_layers * K * (B * T + B * (NEW - 1))
        assert tr["cache_stats"].hits + tr["cache_stats"].misses == 0
    if name in ("stream_all", "cpu_execute"):  # nothing persists on the device
        assert all(not s.residents for s in te._slabs)
    if name == "cpu_execute":
        assert tm.transfers == 0 and tm.host_executed > 0 and tm.host_time > 0
    else:
        assert tm.host_executed == 0 and tm.transfers > 0


def test_cpu_execute_books_static_lfu_misses(models):
    """Same policy and routing give the same misses: ``cpu_execute``
    host-executes exactly what ``static_lfu`` transfers, and computes the
    same tokens."""
    m = models["olmoe-smoke"]
    lfu = tb.make_engine(m["tcfg"], params_from_jax(m["tree"], m["tcfg"]),
                         tb.BASELINES["static_lfu"], capacity=C, hw=HW, device="cpu")
    cpu = tb.make_engine(m["tcfg"], params_from_jax(m["tree"], m["tcfg"]),
                         tb.BASELINES["cpu_execute"], capacity=C, hw=HW, device="cpu",
                         host_store=lfu.host_store)
    a = lfu.generate(m["toks"], max_new_tokens=NEW)
    b = cpu.generate(m["toks"], max_new_tokens=NEW)
    assert b["metrics"].host_executed == a["metrics"].transfers > 0
    assert torch.equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("name", ["stream_all", "cpu_execute"])
def test_engine_baseline_matches_reference_dense_and_shared(models, name):
    _run_both(models["deepseek-smoke"], "deepseek-smoke", name)


def test_make_engine_capacity_rule(models):
    """``min(E, max(1, int(C * capacity_mult)))``, as the reference."""
    m = models["olmoe-smoke"]
    E = m["tcfg"].moe_spec.num_experts
    params = params_from_jax(m["tree"], m["tcfg"])
    for cap, mult, want in ((1, 3.0, 3), (2, 3.0, E), (1, 0.1, 1)):
        spec = dataclasses.replace(tb.BASELINES["static_lfu"], capacity_mult=mult)
        assert tb.make_engine(m["tcfg"], params, spec, capacity=cap, hw=HW,
                              device="cpu").capacity == want


def test_baseline_table_matches_reference():
    assert list(tb.BASELINES) == list(jb.BASELINES)
    for name, spec in jb.BASELINES.items():
        assert dataclasses.asdict(tb.BASELINES[name]) == dataclasses.asdict(spec)


@pytest.mark.parametrize("n_clusters", [3, 8])
def test_profile_prefetcher_matches_reference(n_clusters):
    rng = np.random.default_rng(11)
    profiles = rng.dirichlet(np.ones(16), size=(20, 4))  # (N, L, E)
    partial = rng.dirichlet(np.ones(16), size=4)
    jp = jb.ProfilePrefetcher(n_clusters, seed=2).fit(profiles)
    tp = tb.ProfilePrefetcher(n_clusters, seed=2).fit(profiles)
    np.testing.assert_array_equal(tp.centroids, jp.centroids)
    np.testing.assert_array_equal(tp.predict_scores(partial), jp.predict_scores(partial))
    assert tp.predict_scores(partial).shape == (4, 16)
