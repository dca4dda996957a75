"""The little-expert tier (``core/little_expert.py`` and the engine's
quality dial) against the JAX package on the CPU, on
``olmoe-mini-smoke`` (JAX init, key 0, bridged; the JAX engines with
``kernel_backend="ref"``, fp32).

* The bank's reconstructed weights (``expert_weights``), built by each
  package from the same experts, with and without a folded LoRA delta:
  per expert and projection ``||port - ref|| / ||ref||`` at most
  ``1e-5 + 64 eps32 s_1 / (s_8 - s_9)``. The reference's factors come from
  numpy's fp32 SVD, whose rank-8 subspace is accurate to about
  ``eps32 s_1 / (s_8 - s_9)`` (Davis-Kahan); the port's from an fp64
  eigendecomposition, far closer to exact. The gap term is computed from
  the weights, so a near-tie of s_8 and s_9 widens the bound where the
  reference itself is unstable, instead of a seed being picked to avoid
  one.
* INT4 left factors (``little_quantized``) on the reference's codes,
  carried by ``bridge.little_bank_from_jax`` (HQQ codes differ across XLA
  and PyTorch for ``iters > 0``): weights within 1e-6 relative (the rank-8
  product sums in another order), the same bytes.
* ``contrib`` against the reference's on the same (carried) factors:
  within 1e-5 relative. The port batches its products over the
  substituted experts; the reference loops, so the fp32 sum over experts
  runs in another order.
* ``_degrade_roll``: equal verdicts over a grid of (layer, expert, step,
  quality).
* The engine at quality 0.5 and 0.0, with LoRA, with INT4 factors, and
  under deadline pressure, on the carried bank: tokens, ``degraded_uses``,
  transfers, hits, misses, evictions, ``stopped_early`` and both Eq.-3
  clocks exactly equal.

About 20 s alone on an 8-core CPU.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_wave import lora_tree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.offload_engine import PCIE5_H100  # noqa: E402
from repro.core.offload_engine import OffloadedMoEEngine as JaxEngine  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import little_bank_from_jax, lora_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.little_expert import truncate  # noqa: E402
from repro_torch.core.lora import lora_scale  # noqa: E402
from repro_torch.core.offload_engine import HardwareProfile, OffloadedMoEEngine  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

HW = HardwareProfile(**{f.name: getattr(PCIE5_H100, f.name)
                        for f in dataclasses.fields(HardwareProfile)})
ARCH = "olmoe-mini-smoke"
C = 2
NEW = 6
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def m():
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 10)).astype(np.int32)
    jlora = lora_tree(jcfg, 1)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, toks=toks, jlora=jlora,
                tree=jax.tree.map(np.asarray, jparams), tlora=lora_from_jax(tcfg, jlora),
                sc=lora_scale(tcfg.melinoe))


_SHARED = {}


def engines(m, *, lora=False, **little_kw):
    """A JAX engine with its little bank, and the port's engine on the
    same weights serving that bank (carried across)."""
    # one scale for every engine: the JAX steps shared between engines keep
    # the scale of the engine that traced them
    jkw = dict(lora=jax.tree.map(jnp.asarray, m["jlora"])) if lora else {}
    je = JaxEngine(m["jcfg"], m["jparams"], capacity=C, policy="gamma", hw=PCIE5_H100,
                   kernel_backend="ref", little_experts=True, lora_scale=m["sc"], **little_kw,
                   **jkw)
    names = ("_jit_cache", "_embed_fn", "_next_tok_fn", "_slab_scatter", "_slab_set")
    for n, v in _SHARED.setdefault("olmoe", {n: getattr(je, n) for n in names}).items():
        setattr(je, n, v)
    tkw = dict(lora=m["tlora"], lora_scale=m["sc"]) if lora else {}
    te = OffloadedMoEEngine(m["tcfg"], params_from_jax(m["tree"], m["tcfg"]), capacity=C,
                            policy="gamma", hw=HW, device="cpu",
                            little_bank=little_bank_from_jax(je.little), **tkw)
    return je, te


def assert_same_run(jr, tr):
    np.testing.assert_array_equal(tr["tokens"].numpy(), np.asarray(jr["tokens"]))
    jm, tm = jr["metrics"], tr["metrics"]
    for f in ("transfers", "transfer_bytes", "degraded_uses", "decode_tokens"):
        assert getattr(tm, f) == getattr(jm, f), f
    js, ts = jr["cache_stats"], tr["cache_stats"]
    assert (ts.hits, ts.misses, ts.evictions) == (js.hits, js.misses, js.evictions)
    assert tr["modeled_time_s"] == jr["modeled_time_s"]
    assert tr["modeled_time_overlapped_s"] == jr["modeled_time_overlapped_s"]
    assert tr["stopped_early"] == jr["stopped_early"]


def test_truncate_is_the_svd_truncation():
    """Both Gram routes (taller and wider than the rank) give the rank-r
    SVD truncation (numpy fp64), with the singular values on the left."""
    rng = np.random.default_rng(0)
    for shape in ((3, 40, 24), (3, 24, 40)):
        w = rng.standard_normal(shape).astype(np.float32)
        u, s, vt = np.linalg.svd(w.astype(np.float64), full_matrices=False)
        want = (u[..., :5] * s[..., None, :5]) @ vt[..., :5, :]
        left, right = truncate(torch.from_numpy(w), 5)
        assert left.dtype == right.dtype == torch.float32
        assert left.shape == shape[:2] + (5,) and right.shape == (3, 5, shape[2])
        np.testing.assert_allclose((left @ right).double().numpy(), want, atol=1e-5)
        np.testing.assert_allclose(torch.linalg.norm(left, dim=1).numpy(), s[:, :5],
                                   rtol=1e-5)


def _gap_tol(w: np.ndarray, r: int) -> float:
    s = np.linalg.svd(w.astype(np.float64), compute_uv=False)
    return 1e-5 + 64 * EPS32 * s[0] / (s[r - 1] - s[r])


@pytest.mark.parametrize("lora", [False, True], ids=["base", "lora"])
def test_bank_weights_match_reference(m, lora):
    """Each package builds its own bank (the port's engine on its device,
    from its host store, LoRA folded in)."""
    je, _ = engines(m, lora=lora)
    tkw = dict(lora=m["tlora"], lora_scale=m["sc"]) if lora else {}
    te = OffloadedMoEEngine(m["tcfg"], params_from_jax(m["tree"], m["tcfg"]), capacity=C,
                            hw=HW, device="cpu", little_experts=True, **tkw)
    tb, jb = te.little, je.little
    assert tb.n_layers == jb.n_layers and tb.device_bytes == jb.device_bytes
    assert te.little_build_s > 0
    for layer in range(jb.n_layers):
        for e in range(m["jcfg"].moe_spec.num_experts):
            got, want = tb.expert_weights(layer, e), jb.expert_weights(layer, e)
            for k in ("wg", "wu", "wd"):
                w = np.asarray(je.host_arrays[layer][k][e], np.float32)
                ll = je.layers[je.moe_layer_ids[layer]]["lora"]
                if lora and k in ll:
                    w = w + m["sc"] * np.asarray(ll[k]["a"][e]) @ np.asarray(ll[k]["b"][e])
                want_k = np.asarray(want[k])
                rel = np.linalg.norm(got[k].numpy() - want_k) / np.linalg.norm(want_k)
                assert rel <= _gap_tol(w, 8), (layer, e, k, rel)


def test_quantized_bank_on_carried_codes(m):
    je, te = engines(m, little_quantized=True)
    tb, jb = te.little, je.little
    assert tb.quantized and tb.device_bytes == jb.device_bytes
    for layer in range(jb.n_layers):
        for e in range(m["jcfg"].moe_spec.num_experts):
            got, want = tb.expert_weights(layer, e), jb.expert_weights(layer, e)
            for k in ("wg", "wu", "wd"):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                           atol=1e-6 * float(np.abs(want[k]).max()))
    # the port's own INT4 bank: the same layout and bytes (codes of its own SVD)
    own = OffloadedMoEEngine(m["tcfg"], params_from_jax(m["tree"], m["tcfg"]), capacity=C,
                             hw=HW, device="cpu", little_experts=True, little_quantized=True,
                             quantized=True)
    assert own.little.quantized and own.little.device_bytes == jb.device_bytes


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int4"])
def test_contrib_matches_reference(m, quantized):
    je, te = engines(m, little_quantized=quantized)
    rng = np.random.default_rng(4)
    N, d, E = 7, m["jcfg"].d_model, m["jcfg"].moe_spec.num_experts
    h = rng.standard_normal((N, d)).astype(np.float32)
    eids = np.stack([rng.permutation(E)[:2] for _ in range(N)]).astype(np.int32)
    gates = rng.random((N, 2)).astype(np.float32)
    for layer, experts in ((0, [0, 2]), (1, list(range(E)))):
        want = np.asarray(je.little.contrib(layer, jnp.asarray(h), jnp.asarray(gates),
                                            jnp.asarray(eids), experts))
        got = te.little.contrib(layer, torch.from_numpy(h), torch.from_numpy(gates),
                                torch.from_numpy(eids), experts).numpy()
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    assert te.little.substitutions == je.little.substitutions == 2 + E


def test_degrade_roll_matches_reference():
    got, want = [], []
    for q in (0.0, 0.3, 0.5, 0.9, 1.0):
        for step in range(0, 40, 3):
            ns = SimpleNamespace(_step_quality=q, _gen_step=step)
            for layer in range(16):
                for e in range(64):
                    want.append(JaxEngine._degrade_roll(ns, layer, e))
                    got.append(OffloadedMoEEngine._degrade_roll(ns, layer, e))
    assert got == want
    assert 0.3 < np.mean(got) < 0.7  # both verdicts occur


@pytest.mark.parametrize("case", ["q0.5", "q0.0", "q0.5-lora", "q0.5-int4"])
def test_little_engine_matches_reference(m, case):
    je, te = engines(m, lora="lora" in case, little_quantized="int4" in case)
    q = float(case[1:4])
    for quality in (q, 1.0):  # the cache state of the first call carries over
        jr = je.generate(m["toks"], max_new_tokens=NEW, quality=quality)
        tr = te.generate(m["toks"], max_new_tokens=NEW, quality=quality)
        assert_same_run(jr, tr)
        if quality < 1.0:
            assert tr["metrics"].degraded_uses > 0
            assert te.little.substitutions == je.little.substitutions > 0
            # quality 0: every miss went to the little tier, none was charged
            assert (tr["metrics"].transfers == 0) == (q == 0.0)


def test_deadline_pressure_matches_reference(m):
    """A budget that the prefill and the first decode step take past
    ``pressure_frac`` of, and not whole: from the second decode step on
    every miss goes to the little tier, and no transfer is charged after
    that, so the call runs to its end inside the budget. A budget under
    the prefill's seconds stops after the prefill instead."""
    je, te = engines(m)
    exact = je.generate(m["toks"], max_new_tokens=NEW)
    spans = [exact["metrics"].serial_span(PCIE5_H100, k, k + 1) for k in range(2)]
    je, te = engines(m)
    budget = sum(spans) / 0.8  # past 0.75 of it after step 1, short of it all
    jr = je.generate(m["toks"], max_new_tokens=NEW, deadline_s=budget)
    tr = te.generate(m["toks"], max_new_tokens=NEW, deadline_s=budget)
    assert_same_run(jr, tr)
    tm = tr["metrics"]
    assert not tr["stopped_early"] and tr["tokens"].shape == (2, NEW)
    assert tm.degraded_uses > 0
    assert tm.step_tx[2:] and all(int(tx.sum()) == 0 for tx in tm.step_tx[2:])
    assert tm.serial_span(HW) < budget
    jr = je.generate(m["toks"], max_new_tokens=NEW, deadline_s=spans[0] / 2)
    tr = te.generate(m["toks"], max_new_tokens=NEW, deadline_s=spans[0] / 2)
    assert_same_run(jr, tr)
    assert tr["stopped_early"] and tr["tokens"].shape == (2, 1)
