"""chip_smoke's phase 23(e), the paper's comparison systems on one kept
store (``chip_smoke.mixtral_baselines``), on the CPU at smoke size:
mixtral-8x7b-smoke at Mixtral's expert ratios (8 experts, top-2, C = 2;
``tests/_torch_mixtral8.py``), bf16, 4 x (8 + 4) tokens.

* The store is drawn once, by ``serve.run(keep_store=True)``: the phase
  builds no second store, and re-draws the other weights from the seed
  with their experts on ``meta``.
* Each bf16 system on that store gives the tokens, prefill logits,
  counters and both Eq.-3 clocks of the same system that
  ``make_engine`` builds from the whole tree of the same seed, bit for
  bit; ``melinoe`` there prefetches the scores of ``serve.run(
  predictor=True, host_store=)``, which equal those of a trace of the
  whole tree.
* ``quant_cache`` on the INT4 store of ``serve.run(quantized=True,
  keep_store=True)`` equals ``quant_cache`` quantizing the whole tree's
  experts itself.
* The phase's gates (``chip_smoke._mixtral_baselines_rows``) hold, and a
  row that breaks one is caught.
* The INT4 slab dequantized a slot at a time (as Mixtral's slots are)
  gives the bits of one call over all slots.

About 10 s alone on an 8-core CPU.
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from _torch_mixtral8 import register_port  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import offload_engine  # noqa: E402
from repro_torch.core.baselines import BASELINES, make_engine  # noqa: E402
from repro_torch.core.offload_engine import HardwareProfile  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

B, T, NEW, N_TRAIN = 4, 8, 4, 4
KW = dict(capacity=2, policy="gamma", batch=B, prompt_len=T, seed=0, dtype=torch.bfloat16,
          device="cpu")
SAME = ("transfers", "host_executed", "hits", "misses", "evictions", "prefetch_transfers",
        "modeled_time_s", "modeled_time_overlapped_s", "modeled_tok_s",
        "modeled_overlapped_tok_s")


@pytest.fixture(scope="module")
def phase():
    """The phase's sequence: the bf16 store drawn by run(keep_store=True),
    Psi's scores from run(predictor=True, host_store=), the six bf16
    systems on the store; the INT4 store and quant_cache on it. Counts the
    stores built and the draws of the other weights inside the phase."""
    name = register_port()
    rep = serve.run(name, keep_store=True, max_new=NEW, **KW)
    store = rep["host_store"]
    psi = serve.run(name, predictor=True, host_store=store, n_train_prompts=N_TRAIN,
                    max_new=NEW, **KW)
    plain = serve.run(name, max_new=1, kernel_backend="ref", host_store=store, **KW)
    q = serve.run(name, quantized=True, keep_store=True, max_new=1, **KW)
    stores, draws = [], []
    real_store, real_init = offload_engine.HostExpertStore, model_mod.init_params

    def counted_store(*a, **k):
        stores.append(1)
        return real_store(*a, **k)

    def counted_init(*a, **k):
        draws.append(k)
        return real_init(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(offload_engine, "HostExpertStore", counted_store)
    mp.setattr(model_mod, "init_params", counted_init)
    try:
        kw = dict(arch=name, device="cpu", batch=B, prompt_len=T, new=NEW)
        got = cs.mixtral_baselines(store, cs.MIXTRAL_BF16_SYSTEMS,
                                   psi_scores=psi["predictor_scores"], **kw)
        got_q = cs.mixtral_baselines(q["host_store"], cs.MIXTRAL_INT4_SYSTEMS, **kw)
    finally:
        mp.undo()
    cfg = get_config(name)
    whole = init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                        device="cpu")
    return dict(name=name, cfg=cfg, rep=rep, psi=psi, plain=plain, got=got, got_q=got_q,
                whole=whole, stores=stores, draws=draws, int4_store=q["host_store"])


def test_one_store_and_the_other_weights_redrawn_with_meta_experts(phase):
    assert phase["stores"] == []  # every engine served a kept store
    assert len(phase["draws"]) == 2
    assert all(k["expert_device"] == "meta" and k.get("expert_sink") is None
               for k in phase["draws"])
    rows = {**phase["got"]["rows"], **phase["got_q"]["rows"]}
    assert list(rows) == [*cs.MIXTRAL_BF16_SYSTEMS, *cs.MIXTRAL_INT4_SYSTEMS]
    assert rows["quant_cache"]["capacity"] == 6 and rows["melinoe"]["capacity"] == 2


def _whole_tree_row(p, name, scores=None):
    eng = make_engine(p["cfg"], p["whole"], BASELINES[name], capacity=2, hw=HardwareProfile(),
                      device="cpu")
    if scores is not None:
        eng.prefetch(scores)
    return cs._serve_row(eng, serve.make_prompts(p["cfg"].vocab, B, T), torch.device("cpu"),
                         max_new=NEW)


@pytest.mark.parametrize("name", cs.MIXTRAL_BF16_SYSTEMS + cs.MIXTRAL_INT4_SYSTEMS)
def test_each_system_on_the_store_equals_it_from_the_whole_tree(phase, name):
    got = phase["got_q"] if BASELINES[name].quantized else phase["got"]
    scores = None
    if BASELINES[name].use_predictor:
        # the whole tree's trace gives the scores that the store's did
        train = serve.make_prompts(phase["cfg"].vocab, B + N_TRAIN, T)
        scores, _ = serve.train_psi(phase["cfg"], phase["whole"], train[B:], train[:B],
                                    device="cpu")
        np.testing.assert_array_equal(scores, phase["psi"]["predictor_scores"])
    res, want = _whole_tree_row(phase, name, scores)
    row = got["rows"][name]
    np.testing.assert_array_equal(got["tokens"][name], res["tokens"].numpy())
    assert torch.equal(got["logits"][name], res["prefill_logits"].float())
    assert {k: row[k] for k in SAME} == {k: want[k] for k in SAME}
    assert row["expert_copies"] == want["expert_copies"]


def _gate(p, bf16=None):
    bad = []
    out = cs._mixtral_baselines_rows(
        {"baselines": bf16 or p["got"], "plain_logits": p["plain"]["prefill_logits"]},
        {"baselines": p["got_q"]}, p["cfg"], "cpu", bad, roundoff=0.0)
    return out, bad


def test_the_phase_gates_hold_and_catch_a_broken_row(phase):
    out, bad = _gate(phase)
    assert bad == []
    want = phase["cfg"].n_moe_layers * 2 * (B * T + B * (NEW - 1))
    assert out["rows"]["stream_all"]["transfers"] == want
    assert out["tokens_equal"] and out["stream_all_logits_rel"] == 0.0
    assert set(out["fig3"]) == {"static_lru", "static_lfu", "stream_all", "profile_prefetch",
                                "cpu_execute", "quant_cache"}
    # the bf16 rows' tokens equal the served batch's first NEW tokens
    np.testing.assert_array_equal(phase["got"]["tokens"]["melinoe"], phase["rep"]["tokens"])
    for name, key, delta in (("stream_all", "transfers", 1), ("cpu_execute", "host_executed", 1),
                             ("profile_prefetch", "hits", 1)):
        broken = copy.deepcopy(phase["got"])
        broken["rows"][name][key] += delta
        assert _gate(phase, broken)[1], (name, key)
    broken = copy.deepcopy(phase["got"])
    broken["tokens"]["static_lru"][0, -1] += 1
    assert _gate(phase, broken)[1]


def test_quant_cache_dequantizes_its_slab_in_parts_to_the_same_bits(phase, monkeypatch):
    """The INT4 slab's slots dequantized one at a time (Mixtral's parts)
    give the bits of one call over every slot (OLMoE's), weight for weight
    and token for token."""
    got = phase["got_q"]
    params = init_params(phase["cfg"], generator=torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, device="cpu", expert_device="meta")

    def engine():
        return make_engine(phase["cfg"], params, BASELINES["quant_cache"], capacity=2,
                           hw=HardwareProfile(), device="cpu",
                           host_store=phase["int4_store"])

    whole = engine()
    whole.generate(serve.make_prompts(phase["cfg"].vocab, B, T), max_new_tokens=1)
    used = np.arange(whole._slabs[0].C)
    want = whole._dequant_slots(0, used, torch.bfloat16)
    monkeypatch.setattr(offload_engine, "_DEQUANT_PART_BYTES", 1)
    parts = whole._dequant_slots(0, used, torch.bfloat16)
    assert all(torch.equal(parts[k], want[k]) for k in want)
    res, row = cs._serve_row(engine(), serve.make_prompts(phase["cfg"].vocab, B, T),
                             torch.device("cpu"), max_new=NEW)
    np.testing.assert_array_equal(res["tokens"].numpy(), got["tokens"]["quant_cache"])
    assert torch.equal(res["prefill_logits"].float(), got["logits"]["quant_cache"])
    assert {k: row[k] for k in SAME} == {k: got["rows"]["quant_cache"][k] for k in SAME}
