"""The INT4 comparison systems against the JAX package on the CPU, on
``granite-moe-1b-a400m-smoke`` (``tests/_torch_engine_int4.py``'s
``build``): ``quant_cache`` (HQQ INT4 residents at three times the
capacity, paper Sec 3.2 / D.5) through both packages' ``make_engine``,
and the two engine baselines with INT4 experts (``stream_all`` and
``cpu_execute`` with ``quantized=True``: every expert runs through the
per-expert INT4 spillover, the slab stays empty).

The JAX engine quantizes its experts eagerly (HQQ, ``iters=4``); the
port computes on those codes, carried across by
``bridge.quantized_experts_from_jax`` (HQQ codes differ across XLA and
PyTorch for ``iters > 0``). Exact: greedy tokens, transfers and bytes,
hits, misses, evictions, ``host_executed`` and both Eq.-3 clocks. About
15 s alone on an 8-core CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_engine_int4 import HW, _memo_quantize_linear, build  # noqa: E402
import repro.core.offload_engine as jax_engine_mod  # noqa: E402
from repro.core import baselines as jb  # noqa: E402
from repro.core.offload_engine import PCIE5_H100  # noqa: E402
from repro_torch.bridge import params_from_jax, quantized_experts_from_jax  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def models():
    return build("granite-smoke")


_SHARED = {}


@pytest.mark.parametrize("name", ["quant_cache", "stream_all", "cpu_execute"])
def test_int4_baseline_matches_reference(models, monkeypatch, name):
    jcfg, tcfg, jparams, tree, toks, _ = models["granite-smoke"]
    monkeypatch.setattr(jax_engine_mod, "quantize_linear", _memo_quantize_linear)
    jspec = dataclasses.replace(jb.BASELINES[name], quantized=True)
    tspec = dataclasses.replace(tb.BASELINES[name], quantized=True)
    je = jb.make_engine(jcfg, jparams, jspec, capacity=1, hw=PCIE5_H100)
    names = ("_jit_cache", "_embed_fn", "_next_tok_fn", "_slab_set")
    for n, v in _SHARED.setdefault("granite", {n: getattr(je, n) for n in names}).items():
        setattr(je, n, v)
    te = tb.make_engine(tcfg, params_from_jax(tree, tcfg), tspec, capacity=1, hw=HW,
                        device="cpu",
                        quantized_experts=quantized_experts_from_jax(je.host_store))
    assert te.capacity == je.capacity == (3 if name == "quant_cache" else 1)
    assert te.expert_bytes == je.expert_bytes_q
    jr = je.generate(toks, max_new_tokens=5)
    tr = te.generate(toks, max_new_tokens=5)
    np.testing.assert_array_equal(tr["tokens"].numpy(), np.asarray(jr["tokens"]))
    jm, tm = jr["metrics"], tr["metrics"]
    for f in ("transfers", "transfer_bytes", "host_executed", "host_time",
              "decode_tokens"):
        assert getattr(tm, f) == getattr(jm, f), f
    js, ts = jr["cache_stats"], tr["cache_stats"]
    assert (ts.hits, ts.misses, ts.evictions) == (js.hits, js.misses, js.evictions)
    assert tr["modeled_time_s"] == jr["modeled_time_s"]
    assert tr["modeled_time_overlapped_s"] == jr["modeled_time_overlapped_s"]
    if name != "quant_cache":
        assert all(not s.residents for s in te._slabs)
    assert (tm.host_executed > 0) == (name == "cpu_execute")
