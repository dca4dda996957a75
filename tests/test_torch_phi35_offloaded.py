"""Phi-3.5-MoE offloaded at its real expert ratio on the CPU:
phi35-moe-smoke at 16 experts, top-2, served at C = 4
(``tests/_torch_phi16.py``), the ratio of chip_smoke's phase 24.

* The port's slab engine against the JAX slab engine (``impl="slab"``,
  ``kernel_backend="ref"``) on the same bridged fp32 weights: routed ids
  per layer, tokens, transfers, prefetch transfers, hits, misses,
  evictions and both Eq.-3 clocks exactly equal, and the prefill logits
  within fp32 summation order (``TOL``, as ``tests/test_torch_models.py``
  holds the two packages' logits). A step's overflow group holds up to 12
  experts here; at 4 experts it held at most 2.
* The same in INT4 through ``tests/_torch_engine_int4.py``'s check (the
  JAX engine's codes bridged), its spillover asserted to run past 2
  experts a layer-step.
* Phase 24 (``chip_smoke.phi_phase``) on the CPU at this size, its two
  children run in this process (a spawned child resolves no test config):
  every row served at C = 4, the gates hold, and a row that breaks one is
  caught, the card's launch gates read from launches as the card counts
  them.

About 25 s alone on an 8-core CPU.
"""
import copy
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from _torch_engine_int4 import build, check_int4_engine_matches_jax_slab_engine  # noqa: E402
from _torch_phi16 import SMOKE, register_port, sixteen_experts  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.offload_engine import PCIE5_H100  # noqa: E402
from repro.core.offload_engine import OffloadedMoEEngine as JaxEngine  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.model import compute_logits as jax_compute_logits  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.offload_engine import HardwareProfile, OffloadedMoEEngine  # noqa: E402

pytestmark = pytest.mark.torch

HW = HardwareProfile(**{f.name: getattr(PCIE5_H100, f.name)
                        for f in dataclasses.fields(HardwareProfile)})
TOL = dict(rtol=1e-5, atol=1e-5)  # fp32, summation order
C = 4  # the config's cache capacity: E / 4
NEW = 5


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = sixteen_experts(jax_get_config(SMOKE)), sixteen_experts(get_config(SMOKE))
    assert jcfg.melinoe_cache_capacity() == tcfg.melinoe_cache_capacity() == C
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    scores = rng.random((jcfg.n_moe_layers, jcfg.moe_spec.num_experts))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=params_from_jax(jax.tree.map(np.asarray, jparams), tcfg),
                toks=toks, scores=scores, shared={})


def _record_routing(engine):
    log = []
    for layer, cache in enumerate(engine.cache.layers):
        def rec(req, _orig=cache.access_batch, _layer=layer):
            log.append((_layer, np.array(req)))
            return _orig(req)
        cache.access_batch = rec
    return log


def _jax_engine(m, policy):
    """The JAX slab engine, sharing the first one's compiled steps; its
    prefill's last hidden rows recorded for the logits."""
    eng = JaxEngine(m["jcfg"], m["jparams"], capacity=C, policy=policy, impl="slab",
                    kernel_backend="ref", hw=PCIE5_H100)
    names = ("_jit_cache", "_embed_fn", "_next_tok_fn", "_slab_scatter")
    for n, v in m["shared"].setdefault("jax", {n: getattr(eng, n) for n in names}).items():
        setattr(eng, n, v)
    xs = []

    def next_tok(p, x, _orig=eng._next_tok_fn):
        xs.append(x)
        return _orig(p, x)

    eng._next_tok_fn = next_tok
    return eng, xs


@pytest.mark.parametrize("prefetch", [False, True], ids=["demand", "prefetch"])
@pytest.mark.parametrize("policy", ["lru", "lfu", "gamma"])
def test_engine_at_c4_of_16_matches_the_jax_slab_engine(model, monkeypatch, policy, prefetch):
    m = model
    je, xs = _jax_engine(m, policy)
    te = OffloadedMoEEngine(m["tcfg"], m["tparams"], capacity=C, policy=policy, hw=HW,
                            device="cpu")
    overflow = []
    real = OffloadedMoEEngine._overflow_set

    def counted(self, moe_idx, eids_np, missing):
        overflow.append(len(missing))
        return real(self, moe_idx, eids_np, missing)

    monkeypatch.setattr(OffloadedMoEEngine, "_overflow_set", counted)
    jlog, tlog = _record_routing(je), _record_routing(te)
    if prefetch:
        je.prefetch(m["scores"])
        te.prefetch(m["scores"])
    jr = je.generate(m["toks"], max_new_tokens=NEW)
    tr = te.generate(m["toks"], max_new_tokens=NEW)

    assert len(jlog) == len(tlog) > 0
    for (jl, jids), (tl, tids) in zip(jlog, tlog):
        assert jl == tl
        np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tr["tokens"].numpy(), np.asarray(jr["tokens"]))
    jm, tm = jr["metrics"], tr["metrics"]
    assert (tm.transfers, tm.transfer_bytes) == (jm.transfers, jm.transfer_bytes)
    assert (tm.prefetch_transfers, tm.prefetch_bytes) == \
        (jm.prefetch_transfers, jm.prefetch_bytes)
    js, ts = jr["cache_stats"], tr["cache_stats"]
    assert (ts.hits, ts.misses, ts.evictions) == (js.hits, js.misses, js.evictions)
    assert tr["modeled_time_s"] == jr["modeled_time_s"]
    assert tr["modeled_time_overlapped_s"] == jr["modeled_time_overlapped_s"]
    want = np.asarray(jax_compute_logits(je.params_top, m["jcfg"], xs[0], je.rt)[:, -1])
    np.testing.assert_allclose(tr["prefill_logits"].numpy(), want, **TOL)
    # the prefill routes 64 tokens' top-2 over all 16 experts: past C = 4,
    # more than the 2 of a 4-expert smoke config overflow
    assert max(overflow) > 2 and te.capacity == C
    if prefetch:
        assert tm.prefetch_transfers > 0


@pytest.fixture(scope="module")
def models():
    return build("phi16-smoke")


@pytest.mark.parametrize("prefetch", [False, True], ids=["demand", "prefetch"])
def test_int4_engine_at_c4_of_16_matches_the_jax_slab_engine(models, monkeypatch, prefetch):
    spilled = []
    real = OffloadedMoEEngine._spill_load

    def counted(self, moe_idx, missing):
        spilled.append(len(missing))
        return real(self, moe_idx, missing)

    monkeypatch.setattr(OffloadedMoEEngine, "_spill_load", counted)
    check_int4_engine_matches_jax_slab_engine(models, monkeypatch, "phi16-smoke", "gamma",
                                              str(C), prefetch)
    assert max(spilled) > 2


# ---- phase 24 on the CPU


@pytest.fixture(scope="module")
def phase():
    """``chip_smoke.phi_phase`` on the 16-expert config, its children run
    in this process; returns the phase's report and the children's raw
    results (what the gates read)."""
    name = register_port()
    raw = {}

    def in_process(kind, layers, d, arch, device, fp32_layers, deadline, extras=True):
        assert kind in ("int4", "bf16") and not extras
        out = str(Path(d, f"{arch}-{kind}.pt"))
        cs._offload_child(0, kind, layers, out, arch, device, fp32_layers, extras=extras)
        res = torch.load(out, weights_only=False)
        res["spawn_s"] = 0.0
        raw[kind] = copy.deepcopy(res)
        return res

    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "_offload_spawn", in_process)
    try:
        rep = cs.phi_phase(arch=name, device="cpu", fp32_layers=2)
    finally:
        mp.undo()
    return dict(name=name, cfg=get_config(name), rep=rep, raw=raw)


def _gate(p, rows, device="cpu"):
    bad = []
    out, r = cs._offload_rows("phi", copy.deepcopy(rows), p["cfg"], device, 2, bad,
                              peak_gate=True)
    return out, r, bad


def test_phase_serves_both_stores_at_c4_of_16(phase):
    rep, raw = phase["rep"], phase["raw"]
    assert set(raw) == {"int4", "bf16"} and set(rep) >= {"int4", "bf16", "checks"}
    for kind in ("int4", "bf16"):
        row = rep[kind]
        assert row["capacity"] == C and row["layers"] == 2
        assert row["transfers"] > 0 and 0 < row["hit_rate"] < 1
        assert row["slab_bytes"] < row["host_store_bytes"]
        # the slabs hold a quarter of the store, as at full width
        assert row["slab_bytes"] * 4 == pytest.approx(row["host_store_bytes"], rel=0.01) \
            or kind == "int4"
        assert raw[kind]["rep"]["max_new"] == cs.OFFLOAD_NEW
    assert rep["checks"]["fp32_short_kernel_vs_plain"] <= cs.FP32_LOGITS_REL_TOL


def test_phase_gates_hold_and_catch_a_broken_row(phase):
    raw = phase["raw"]
    _, r, bad = _gate(phase, raw)
    assert bad == [] and r > 0
    broken = copy.deepcopy(raw)  # kernel logits farther from the plain run
    broken["bf16"]["rep"]["prefill_logits"] = broken["bf16"]["rep"]["prefill_logits"] * 1.5
    assert any("phi-bf16: prefill logits" in b for b in _gate(phase, broken)[2])
    broken = copy.deepcopy(raw)  # a second host copy of the store
    rep = broken["int4"]["rep"]
    rep["host_available_after_build"] = rep["host_available_before_build"] - (
        2 * rep["host_store_bytes"] + cs.MIXTRAL_RSS_MARGIN)
    assert any("MemAvailable drop" in b for b in _gate(phase, broken)[2])
    broken = copy.deepcopy(raw)  # past the peak-memory bound
    out, _, _ = _gate(phase, raw)
    broken["bf16"]["rep"]["max_memory_allocated"] = out["bf16"]["memory_bound_bytes"] + 1
    assert any("peak device memory" in b for b in _gate(phase, broken)[2])
    broken = copy.deepcopy(raw)  # served at another capacity
    broken["int4"]["rep"]["capacity"] = 2
    assert any("C = 2" in b for b in _gate(phase, broken)[2])


def _card_launches(rows, n, steps):
    """``rows`` with the launches a card counts on ``n`` layers and
    ``steps`` decode steps: flash_attn one "tc" a layer in the prefill;
    moe_gmm 6 "tc" a layer in the prefill (slab and overflow groups), 3 or
    6 "stream" a layer-step; int4_matmul 3 a spilled expert, "tc" then
    "stream"."""
    rows = copy.deepcopy(rows)
    for kind, r in rows.items():
        q = kind == "int4"
        pre = {"flash_attn": {"tc": n}, "moe_gmm": {"tc": (3 if q else 6) * n},
               "int4_matmul": {"tc": 3 * 5 * n} if q else {}, "ssd_scan": {}}
        dec = {"flash_attn": {}, "moe_gmm": {"stream": 3 * n * steps},
               "int4_matmul": {"stream": 3 * 2 * n * steps} if q else {}, "ssd_scan": {}}
        r["rep"]["route_launches"] = {"prefill": pre, "decode": dec}
        r["routes"] = {op: {k: pre[op].get(k, 0) + dec[op].get(k, 0)
                            for k in {*pre[op], *dec[op]}} for op in cs.FAST_ROUTES}
        r["launches"] = {op: sum(v.values()) for op, v in r["routes"].items()}
    return rows


def test_phase_launch_gates_read_the_cards_counts(phase):
    rows = _card_launches(phase["raw"], 2, cs.OFFLOAD_NEW - 1)
    assert _gate(phase, rows, "cuda")[2] == []
    broken = copy.deepcopy(rows)  # a decode product off its stream route
    broken["bf16"]["rep"]["route_launches"]["decode"]["moe_gmm"] = {"stream": 84, "tc": 3}
    assert _gate(phase, broken, "cuda")[2]
    broken = copy.deepcopy(rows)  # a layer's attention missing from the prefill
    for r in (broken["int4"]["rep"]["route_launches"]["prefill"]["flash_attn"],
              broken["int4"]["routes"]["flash_attn"]):
        r["tc"] = 1
    broken["int4"]["launches"]["flash_attn"] = 1
    assert _gate(phase, broken, "cuda")[2]
    broken = copy.deepcopy(rows)  # a spilled expert short of its three products
    broken["int4"]["rep"]["route_launches"]["decode"]["int4_matmul"] = {"stream": 83}
    assert _gate(phase, broken, "cuda")[2]
