"""The port's activation predictor Psi (``core/predictor.py``), its
routing traces (``inference.engine.routing_trace``), its scorer and the
``serve --predictor`` launcher against the JAX package's on the CPU.

Inputs come from numpy seeds; predictor weights and model weights cross
with the bridge (the JAX init draws from ``jax.random``). Tolerances:
the embedder's table is bit-equal (the same numpy draw); embeddings,
logits, scores, loss histories and router probabilities 1e-5 (fp32 on
both sides, sums in another order); predicted Top-C ids, greedy tokens,
transfer and prefetch counts exactly equal.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import predictor as jpred  # noqa: E402
from repro.inference.engine import routing_trace as jax_routing_trace  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.serving.request import ServeRequest as JaxServeRequest  # noqa: E402
from repro.serving.scorers import predictor_expert_scores as jax_scores  # noqa: E402
from repro.training.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from repro_torch.bridge import params_from_jax, predictor_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import predictor as tpred  # noqa: E402
from repro_torch.inference import routing_trace  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402
from repro_torch.serving import ServeRequest, predictor_expert_scores  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "granite-moe-1b-a400m-smoke"


def _jinit(L, E):
    return jax.tree.map(np.asarray, jpred.init_predictor(jax.random.key(1), L, E))


def test_embedder_table_is_bit_equal_and_pools_alike():
    j, t = jpred.PromptEmbedder(512), tpred.PromptEmbedder(512)
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    toks = np.random.default_rng(0).integers(0, 512, (3, 20)).astype(np.int32)
    np.testing.assert_allclose(t(toks).numpy(), np.asarray(j(jnp.asarray(toks))), **TOL)
    np.testing.assert_allclose(t(toks[0]).numpy(), np.asarray(j(jnp.asarray(toks[0]))),
                               **TOL)


def test_train_predictor_follows_the_reference_from_a_bridged_init():
    rng = np.random.default_rng(1)
    L, E, N = 3, 8, 40
    embs = (rng.standard_normal((N, 768)) * 0.05).astype(np.float32)
    t = rng.random((N, L, E)).astype(np.float32) ** 3
    targets = t / t.sum(-1, keepdims=True)
    init = _jinit(L, E)
    jp, jh = jpred.train_predictor(jax.tree.map(jnp.asarray, init), jnp.asarray(embs),
                                   jnp.asarray(targets), epochs=4, lr=0.05, seed=3)
    tp, th = tpred.train_predictor(predictor_from_jax(init), torch.from_numpy(embs),
                                   torch.from_numpy(targets), epochs=4, lr=0.05, seed=3)
    np.testing.assert_allclose(th, jh, **TOL)
    assert th[-1] < th[0]
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL)
    # the KL of a prediction against its own softmax target is zero
    e = torch.from_numpy(embs[:2])
    q = torch.softmax(tpred.predictor_logits(tp, e), -1)
    assert float(tpred.predictor_kl_loss(tp, e, q)) < 1e-6
    np.testing.assert_allclose(
        float(tpred.predictor_kl_loss(tp, e, torch.from_numpy(targets[:2]))),
        float(jpred.predictor_kl_loss(jp, jnp.asarray(embs[:2]), jnp.asarray(targets[:2]))),
        **TOL)
    # predictions: scores and Top-C ids
    np.testing.assert_allclose(tpred.predict_scores(tp, e[0]),
                               np.asarray(jpred.predict_scores(jp, jnp.asarray(embs[0]))),
                               **TOL)
    np.testing.assert_array_equal(tpred.predict_topc(tp, e[0], 3),
                                  jpred.predict_topc(jp, jnp.asarray(embs[0]), 3))


def test_build_targets_matches():
    rng = np.random.default_rng(2)
    probs = [rng.random((2, 3, 5, 8)).astype(np.float32),
             rng.random((1, 3, 5, 8)).astype(np.float32)]
    got = tpred.build_targets([torch.from_numpy(p) for p in probs])
    want = jpred.build_targets([jnp.asarray(p) for p in probs])
    assert got.shape == (3, 3, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)


def test_routing_trace_matches(model):
    jcfg, tcfg, jparams, tparams = model
    prompts = serve.make_prompts(tcfg.vocab, 3, 10)
    jt, jp = jax_routing_trace(jcfg, jparams, prompts, max_new=5)
    tt, tp = routing_trace(tcfg, tparams, prompts, max_new=5,
                           rt=Runtime(kernel_backend="ref", zero_drop=True))
    np.testing.assert_array_equal(tt, jt)
    assert tp.shape == (3, tcfg.n_moe_layers, 4, tcfg.moe_spec.num_experts)
    np.testing.assert_allclose(tp, jp, **TOL)


def test_predictor_scores_annotate_requests(model):
    jcfg, tcfg, _, _ = model
    init = _jinit(tcfg.n_moe_layers, tcfg.moe_spec.num_experts)
    prompts = serve.make_prompts(tcfg.vocab, 2, 12)
    treqs = [ServeRequest(rid=i, prompt=p) for i, p in enumerate(prompts)]
    jreqs = [JaxServeRequest(rid=i, prompt=p) for i, p in enumerate(prompts)]
    got = predictor_expert_scores(predictor_from_jax(init), tpred.PromptEmbedder(tcfg.vocab),
                                  treqs)
    want = jax_scores(jax.tree.map(jnp.asarray, init), jpred.PromptEmbedder(jcfg.vocab),
                      jreqs)
    for g, w, r in zip(got, want, treqs):
        assert g.shape == (tcfg.n_moe_layers, tcfg.moe_spec.num_experts)
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
        assert r.expert_scores is g
    assert predictor_expert_scores(predictor_from_jax(init), None, []) == []


def test_serve_predictor_matches_the_reference_launcher(model, tmp_path, capsys,
                                                        monkeypatch):
    """``serve --predictor`` on the same weights (a JAX checkpoint, read by
    both launchers) and the same predictor init: Psi's KL history, the
    transfers, prefetch transfers and hit rate are the reference's."""
    jcfg, tcfg, jparams, _ = model
    ckpt = tmp_path / "base.ckpt"
    jax_save_checkpoint(ckpt, jparams, step=0)
    kw = ["--arch", ARCH, "--ckpt", str(ckpt), "--capacity", "2", "--batch", "2",
          "--prompt-len", "12", "--max-new", "6", "--n-train-prompts", "8", "--predictor"]
    monkeypatch.setattr("sys.argv", ["serve", *kw])
    jserve.main()
    out = capsys.readouterr().out
    kl = [float(x) for x in re.search(r"predictor KL ([\d.]+) -> ([\d.]+)", out).groups()]
    transfers, prefetch = map(int, re.search(r"transfers=(\d+) .*prefetch=(\d+)",
                                             out).groups())
    hit = float(re.search(r"hit rate=([\d.]+)", out).group(1))

    init = predictor_from_jax(_jinit(tcfg.n_moe_layers, tcfg.moe_spec.num_experts))
    rep = serve.run(ARCH, ckpt=str(ckpt), capacity=2, batch=2, prompt_len=12, max_new=6,
                    n_train_prompts=8, predictor=True, predictor_init=init,
                    dtype="float32", device="cpu")
    assert [round(rep["predictor_kl"][i], 4) for i in (0, -1)] == kl
    assert rep["predictor_kl"][-1] < rep["predictor_kl"][0]
    assert (rep["transfers"], rep["prefetch_transfers"]) == (transfers, prefetch)
    assert prefetch > 0 and round(rep["hit_rate"], 3) == hit
    # the predictor moves residency, not the tokens
    plain = serve.run(ARCH, ckpt=str(ckpt), capacity=2, batch=2, prompt_len=12, max_new=6,
                      dtype="float32", device="cpu")
    np.testing.assert_array_equal(rep["tokens"], plain["tokens"])
    assert plain["prefetch_transfers"] == 0
    # the launcher's flags
    r2 = serve.main(["--arch", ARCH, "--device", "cpu", "--dtype", "float32", "--capacity",
                     "2", "--batch", "2", "--prompt-len", "8", "--max-new", "3",
                     "--n-train-prompts", "4", "--predictor"])
    assert "predictor KL" in capsys.readouterr().out and r2["prefetch_transfers"] > 0
