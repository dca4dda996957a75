"""The port's per-expert engine (``OffloadedMoEEngine(impl="dict")``)
against the JAX dict engine (``impl="dict", kernel_backend="ref"``) on the
CPU, from the same bridged weights (granite-moe-1b-a400m-smoke, fp32).

The dict engine calls the cache manager token by token and fetches each
miss on its own, so it must reproduce the JAX dict engine's greedy tokens,
transfers and bytes, prefetch counts, hits, misses, evictions, both Eq.-3
clocks and every fault counter exactly; and, as the reference's own test
of its two engines (``tests/test_offload_slab.py``) holds, the port's slab
engine's tokens and counts. The JAX "auto" INT4 engine is not the
reference (ROADMAP, Queue 3): the INT4 dict engine is held against
"ref", on the JAX engine's own codes (``bridge.quantized_experts_from_jax``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.lora import init_lora as jax_init_lora  # noqa: E402
from repro.core.offload_engine import PCIE5_H100  # noqa: E402
from repro.core.offload_engine import OffloadedMoEEngine as JaxEngine  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch import faults, serving  # noqa: E402
from repro_torch.bridge import (little_bank_from_jax, lora_from_jax,  # noqa: E402
                                params_from_jax, quantized_experts_from_jax)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.offload_engine import HardwareProfile, OffloadedMoEEngine  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

HW = HardwareProfile(**{f.name: getattr(PCIE5_H100, f.name)
                        for f in dataclasses.fields(HardwareProfile)})
ARCH = "granite-moe-1b-a400m-smoke"
NEW = 5

_METRICS = ("transfers", "transfer_bytes", "prefetch_transfers", "prefetch_bytes",
            "host_executed", "fetch_failures", "fetch_retries", "fault_delay_s",
            "degraded_uses", "decode_tokens", "compute_flops")


@pytest.fixture(scope="module")
def m():
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    scores = rng.random((jcfg.n_moe_layers, jcfg.moe_spec.num_experts))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=params_from_jax(tree, tcfg),
                toks=toks, scores=scores)


def _engines(m, *, impl="dict", **kw):
    """The JAX dict engine ("ref") and the port's engine of ``impl`` on the
    same weights; a JAX little bank and INT4 codes cross over."""
    jkw = {k: v for k, v in kw.items() if k != "lora_tree"}
    tkw = dict(jkw)
    if "lora_tree" in kw:
        jkw["lora"] = kw["lora_tree"]
        tkw["lora"] = lora_from_jax(m["tcfg"], jax.tree.map(np.asarray, kw["lora_tree"]))
    if "fetch_policy" in kw:
        jkw["fetch_policy"] = jfaults.FetchPolicy(**dataclasses.asdict(kw["fetch_policy"]))
    je = JaxEngine(m["jcfg"], m["jparams"], kernel_backend="ref", hw=PCIE5_H100,
                   impl="dict", **jkw)
    if je.little is not None:
        tkw.pop("little_experts")
        tkw["little_bank"] = little_bank_from_jax(je.little)
    if kw.get("quantized"):
        tkw["quantized_experts"] = quantized_experts_from_jax(je.host_store)
    te = OffloadedMoEEngine(m["tcfg"], m["tparams"], hw=HW, device="cpu", impl=impl, **tkw)
    return je, te


def _assert_same(jr, tr, *, logits=None):
    np.testing.assert_array_equal(tr["tokens"].numpy(), np.asarray(jr["tokens"]))
    for f in _METRICS:
        assert getattr(tr["metrics"], f) == getattr(jr["metrics"], f), f
    js, ts = jr["cache_stats"], tr["cache_stats"]
    assert (ts.hits, ts.misses, ts.evictions) == (js.hits, js.misses, js.evictions)
    assert tr["modeled_time_s"] == jr["modeled_time_s"]
    assert tr["modeled_time_overlapped_s"] == jr["modeled_time_overlapped_s"]


@pytest.mark.parametrize("capacity", [1, 2, 4])
@pytest.mark.parametrize("policy", ["lru", "lfu", "gamma"])
def test_dict_engine_matches_jax_dict_and_port_slab(m, policy, capacity):
    je, te = _engines(m, capacity=capacity, policy=policy)
    jr = je.generate(m["toks"], max_new_tokens=NEW)
    tr = te.generate(m["toks"], max_new_tokens=NEW)
    _assert_same(jr, tr)
    assert te.audit() == [] and je.audit() == []
    assert all(len(r) <= capacity for r in te.resident)
    # the slab engine: the same tokens and accounting (its copies differ)
    sr = OffloadedMoEEngine(m["tcfg"], m["tparams"], capacity=capacity, policy=policy,
                            hw=HW, device="cpu").generate(m["toks"], max_new_tokens=NEW)
    _assert_same(jr, sr)
    torch.testing.assert_close(tr["prefill_logits"], sr["prefill_logits"],
                               rtol=1e-5, atol=1e-5)
    # one copy per demand transfer, none transient at these capacities
    assert sum(tr["expert_copies"].values()) >= tr["metrics"].transfers > 0


@pytest.mark.parametrize("prefetch", [False, True], ids=["demand", "prefetch"])
def test_dict_engine_int4_matches_jax(m, prefetch):
    je, te = _engines(m, capacity=2, policy="lfu", quantized=True)
    assert te.expert_bytes == je.expert_bytes_q
    if prefetch:
        je.prefetch(m["scores"])
        te.prefetch(m["scores"])
    jr = je.generate(m["toks"], max_new_tokens=NEW)
    tr = te.generate(m["toks"], max_new_tokens=NEW)
    _assert_same(jr, tr)
    if prefetch:
        assert tr["metrics"].prefetch_transfers > 0
    # on the CPU the residents are the codes dequantized once, in fp32
    w = next(iter(te.resident[0].values()))
    assert w["wg"].dtype == torch.float32 and w["wg"].shape == (
        m["tcfg"].d_model, m["tcfg"].moe_spec.d_ff)


def test_dict_engine_lora_matches_jax(m):
    lora = jax_init_lora(jax.random.key(5), m["jcfg"], m["jcfg"].melinoe)
    # b starts at zero; offset both factors so the low-rank term is live
    lora = jax.tree.map(lambda a: a + 0.01 * jnp.ones_like(a), lora)
    je, te = _engines(m, capacity=2, policy="gamma", lora_tree=lora, lora_scale=0.5)
    jr, tr = je.generate(m["toks"], NEW), te.generate(m["toks"], NEW)
    _assert_same(jr, tr)
    plain = OffloadedMoEEngine(m["tcfg"], m["tparams"], capacity=2, policy="gamma",
                               hw=HW, device="cpu", impl="dict").generate(m["toks"], 1)
    assert (tr["prefill_logits"] - plain["prefill_logits"]).abs().max().item() > 1e-3
    slab = OffloadedMoEEngine(m["tcfg"], m["tparams"], capacity=2, policy="gamma", hw=HW,
                              device="cpu",
                              lora=lora_from_jax(m["tcfg"], jax.tree.map(np.asarray, lora)),
                              lora_scale=0.5).generate(m["toks"], NEW)
    np.testing.assert_array_equal(slab["tokens"].numpy(), tr["tokens"].numpy())


@pytest.mark.parametrize("mode", ["stream_all", "cpu_execute"])
def test_dict_engine_baselines_match_jax(m, mode):
    je, te = _engines(m, capacity=2, policy="lfu", **{mode: True})
    jr, tr = je.generate(m["toks"], NEW), te.generate(m["toks"], NEW)
    _assert_same(jr, tr)
    if mode == "cpu_execute":
        assert tr["metrics"].host_executed > 0 and tr["metrics"].transfers == 0
        assert all(not r for r in te.resident)
    else:
        k = m["tcfg"].moe_spec.top_k
        n_assign = (m["toks"].size + 2 * (NEW - 1)) * k * m["tcfg"].n_moe_layers
        assert tr["metrics"].transfers == n_assign


# id -> (spec, engine options, quality)
FAULTS = {
    "little-degrade": ("fail=0.6,spike=0.1:2e-3,seed=5", dict(little_experts=True), 1.0),
    "naive-retry": ("fail=0.3,spike=0.2:1e-3,seed=5",
                    dict(fetch_policy=faults.NAIVE_POLICY), 1.0),
    "quality-dial": ("spike=0.1:1e-3,seed=3", dict(little_experts=True), 0.5),
    "storm": ("storm=0.5:0.5,seed=2", dict(fetch_policy=faults.NAIVE_POLICY), 1.0),
}


@pytest.mark.parametrize("case", list(FAULTS))
def test_dict_engine_under_faults_matches_jax(m, case):
    """A fault plan draws in call order: the token-sequential verdicts
    (quality roll, then fetch trial, per miss) must keep the reference's
    order for every counter to agree."""
    spec, kw, quality = FAULTS[case]
    je, te = _engines(m, capacity=2, policy="gamma", little_rank=2, **kw)
    runs = []
    for pkg, eng in ((jfaults, je), (faults, te)):
        plan = pkg.install_fault_plan(spec)
        try:
            eng.prefetch(m["scores"])
            res = eng.generate(m["toks"], NEW, quality=quality)
        finally:
            pkg.uninstall_fault_plan()
        runs.append((res, dict(plan.counters)))
    (jr, jc), (tr, tc) = runs
    assert tc == jc
    _assert_same(jr, tr)
    # a degraded expert leaves the modeled set but may stay physical: the
    # reference reports the same drift
    assert te.audit() == je.audit()
    assert all(sev == "drift" for sev, _ in te.audit())
    if case in ("little-degrade", "quality-dial"):
        assert tr["metrics"].degraded_uses > 0
    if case == "naive-retry":
        assert tr["metrics"].fetch_failures > 0
    if case == "storm":
        assert tc["storm"] > 0


def test_dict_engine_revive_resync_and_audit_match_jax(m):
    je, te = _engines(m, capacity=2, policy="gamma")
    jr, tr = je.generate(m["toks"], NEW), te.generate(m["toks"], NEW)
    _assert_same(jr, tr)
    state = te.cache_state()
    # a warm revival into fresh engines: the checkpointed residents copied back
    je2, te2 = _engines(m, capacity=2, policy="gamma")
    jv, tv = je2.revive(je.cache_state(), warm=True), te2.revive(state, warm=True)
    assert tv == jv and tv["loaded"] == sum(len(c["resident"]) for c in state) > 0
    assert [sorted(r) for r in te2.resident] == [sorted(r) for r in je2.resident]
    _assert_same(je2.generate(m["toks"], NEW), te2.generate(m["toks"], NEW))
    # drift: a physical resident the cache manager does not hold
    for eng, to_dev in ((je2, jnp.asarray), (te2, torch.as_tensor)):
        cached = eng.cache.layers[0].resident
        stale = next(e for e in range(m["tcfg"].moe_spec.num_experts) if e not in cached)
        eng.resident[0][stale] = {"wg": to_dev(np.zeros(1, np.float32))}
    assert te2.audit() == je2.audit() and te2.audit()[0][0] == "drift"
    assert te2.audit()[0][1].startswith("dict[L0]: physical residents outside the cache")
    assert te2.resync_slabs() == je2.resync_slabs() == 1
    assert te2.audit() == je2.audit() == []


def test_wave_server_and_bench_serve_dict(m, capsys):
    """``OffloadedWaveServer(engine_impl="dict")`` serves the JAX dict wave
    server's tokens and counts; ``bench_serve --engine-impl dict`` runs and
    gives the slab engine's tokens."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, m["tcfg"].vocab, 8).astype(np.int32) for _ in range(4)]

    def reqs(pkg):
        return pkg.RequestQueue([pkg.ServeRequest(rid=i, prompt=p, max_new_tokens=3 + i % 2)
                                 for i, p in enumerate(prompts)])

    jsrv = jserving.OffloadedWaveServer(m["jcfg"], m["jparams"], capacity=2, wave_size=2,
                                        hw=PCIE5_H100, engine_impl="dict")
    tsrv = serving.OffloadedWaveServer(m["tcfg"], m["tparams"], capacity=2, wave_size=2,
                                       hw=HW, engine_impl="dict", device="cpu")
    (jres, jmt), (tres, tmt) = jsrv.run(reqs(jserving)), tsrv.run(reqs(serving))
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
    assert (tmt.transfers, tmt.prefetch_transfers) == (jmt.transfers, jmt.prefetch_transfers)
    assert tmt.modeled_time == jmt.modeled_time

    from repro_torch.launch import bench_serve

    out = {}
    for impl in ("slab", "dict"):
        results, mt = bench_serve.main(
            ["--arch", ARCH, "--device", "cpu", "--dtype", "float32", "--offloaded",
             "--capacity", "2", "--n-requests", "3", "--slots", "2", "--prompt-len", "8",
             "--max-new", "4", "--arrival", "all_at_once", "--engine-impl", impl])
        capsys.readouterr()
        out[impl] = ([r.tokens.tolist() for r in results], mt.transfers)
    assert out["dict"] == out["slab"] and out["dict"][1] > 0
