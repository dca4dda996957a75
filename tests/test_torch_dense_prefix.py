"""Prefix embeddings on the port against the JAX package on the CPU, at
smoke size: musicgen and internvl2 with a ``prefix_embed`` of their
smoke ``prefix_len`` (8) rows through ``apply_model`` and prefill +
decode; a train step on a musicgen prefix batch; the offloaded engine's
``generate`` with a prefix (tokens, cache counters and both Eq.-3 clocks
exact); and ``build_prefill_step`` / ``build_decode_step``.

Weights are JAX ``init_params`` trees (fp32) carried across by the
bridge; tokens and prefixes are drawn with numpy. Tolerances, fp32:
logits 1e-4 (many products deep, another summation order); the train
step's loss and gradient norm 1e-5 relative (as tests/test_torch_train.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_dense import (CPU, JAX_REF, TOL_LOGITS, assert_chains_match, bridge,  # noqa: E402
                          prompt, torch_chain)
from _torch_threads import one_thread  # noqa: E402,F401
from test_torch_engine import _record_routing  # noqa: E402
from repro.core.offload_engine import PCIE5_H100  # noqa: E402
from repro.core.offload_engine import OffloadedMoEEngine as JaxEngine  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import Runtime as JaxRuntime, apply_model as jax_apply_model  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.offload_engine import HardwareProfile, OffloadedMoEEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402

pytestmark = pytest.mark.torch

PREFIXED = ["musicgen-medium-smoke", "internvl2-76b-smoke"]


@pytest.fixture(scope="module")
def models():
    return {arch: bridge(arch) for arch in PREFIXED}


@pytest.mark.parametrize("arch", PREFIXED)
def test_apply_model_with_a_prefix_matches_jax(models, arch):
    """Logits at every position, the prefix's included; the prefix moves
    the tokens' logits."""
    jcfg, tcfg, tree, params = models[arch]
    toks, pe = prompt(jcfg, 2, 12, seed=5, prefix=True)
    P = jcfg.prefix_len
    assert P == 8
    jl, _ = jax_apply_model(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks),
                            JAX_REF, prefix_embed=jnp.asarray(pe))
    tl, _ = tmodel.apply_model(params, tcfg, torch.as_tensor(toks).long(), CPU,
                               prefix_embed=torch.as_tensor(pe))
    assert tl.shape == (2, P + 12, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_LOGITS)
    plain, _ = tmodel.apply_model(params, tcfg, torch.as_tensor(toks).long(), CPU)
    assert (tl[:, P:] - plain).abs().max().item() > 1e-3


@pytest.mark.parametrize("arch", PREFIXED)
def test_prefill_with_a_prefix_then_decode_matches_jax(models, arch):
    """A prefill of 8 prefix rows and 12 tokens into the default cache
    (``n_slots`` None: the prompt's length, as both packages size it)
    and then into one with room, then 8 greedy decode steps."""
    jcfg, tcfg, tree, params = models[arch]
    toks, pe = prompt(jcfg, 2, 12, seed=6, prefix=True)
    _, cache = tmodel.prefill(params, tcfg, torch.as_tensor(toks).long(), CPU,
                              prefix_embed=torch.as_tensor(pe))
    assert cache["pos"] == 20 and cache["g0"]["p0"].k.shape[2] == 20
    assert_chains_match(jcfg, tree, tcfg, params, toks, 8, prefix=pe, n_slots=20 + 8)


def test_train_step_on_a_prefix_batch_matches_jax(models):
    """``build_train_step`` on a musicgen batch with ``prefix_embed``: the
    loss shifts by ``prefix_len`` (the labels are the tokens' targets), as
    the JAX step's; its loss, nll and gradient norm within 1e-5."""
    jcfg, tcfg, tree, _ = models["musicgen-medium-smoke"]
    rng = np.random.default_rng(11)
    B, T = 2, 12
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32),
             "prefix_embed": rng.standard_normal((B, jcfg.prefix_len, jcfg.d_model)
                                                 ).astype(np.float32)}
    jparams = jax.tree.map(jnp.asarray, tree)
    jstep = jax.jit(jsteps.build_train_step(jcfg, JaxRuntime(kernel_backend="ref"),
                                            joptim.OptConfig(), melinoe=False))
    _, _, jm = jstep(jparams, joptim.init_opt_state(jparams),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(tree, tcfg)
    tstep = tsteps.build_train_step(tcfg, CPU, toptim.OptConfig(), melinoe=False)
    _, state, tm = tstep(params, toptim.init_opt_state(params), batch)
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert state["step"] == 1


def test_serve_launcher_draws_a_prefix_for_a_prefix_config():
    """``serve --arch musicgen-medium-smoke`` goes through ``run_full``
    with ``prefix_len`` rows from ``make_prefix(cfg, batch, seed)`` ahead
    of each prompt: its tokens are the greedy chain of ``prefill`` and
    ``decode_step`` on the same weights, prompts and prefix."""
    rep = serve.main(["--arch", "musicgen-medium-smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "10", "--max-new", "4", "--dtype", "float32"])
    cfg = get_config("musicgen-medium-smoke")
    assert rep["prefix_len"] == cfg.prefix_len == 8 and rep["tokens"].shape == (2, 4)
    kept = serve.run_full("musicgen-medium-smoke", batch=2, prompt_len=10, max_new=4,
                          dtype="float32", device="cpu", keep_params=True)
    prefix = serve.make_prefix(cfg, 2, seed=0)
    _, tokens, pos = torch_chain(cfg, kept["params"], serve.make_prompts(cfg.vocab, 2, 10),
                                 3, prefix=prefix, n_slots=8 + 10 + 4)
    np.testing.assert_array_equal(rep["tokens"][:, :3], tokens)
    assert pos == 8 + 10 + 3


def test_offloaded_engine_with_a_prefix_matches_jax():
    """``OffloadedMoEEngine.generate(tokens, n, prefix_embed)`` on
    olmoe-mini-smoke (E 4, C 2, gamma) against the JAX slab engine: the
    routed ids of every layer-step (the prefill's over prefix + tokens),
    greedy tokens, transfers, hits, misses, evictions and both Eq.-3
    clocks, exactly."""
    jcfg, tcfg, tree, params = bridge("olmoe-mini-smoke")
    B, T, P, C = 2, 12, 8, 2
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    pe = rng.standard_normal((B, P, jcfg.d_model)).astype(np.float32)
    hw = HardwareProfile(**{f.name: getattr(PCIE5_H100, f.name)
                            for f in dataclasses.fields(HardwareProfile)})
    je = JaxEngine(jcfg, jax.tree.map(jnp.asarray, tree), capacity=C, policy="gamma",
                   impl="slab", kernel_backend="ref", hw=PCIE5_H100)
    te = OffloadedMoEEngine(tcfg, params, capacity=C, policy="gamma", hw=hw, device="cpu")
    jlog, tlog = _record_routing(je), _record_routing(te)
    jr = je.generate(toks, 5, jnp.asarray(pe))
    tr = te.generate(toks, 5, pe)
    assert len(jlog) == len(tlog) and tlog[0][1].size == B * (P + T) * jcfg.moe_spec.top_k
    for (jl, jids), (tl, tids) in zip(jlog, tlog):
        assert jl == tl
        np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tr["tokens"].numpy(), np.asarray(jr["tokens"]))
    jm, tm = jr["metrics"], tr["metrics"]
    assert (tm.transfers, tm.transfer_bytes, tm.decode_tokens) == \
        (jm.transfers, jm.transfer_bytes, jm.decode_tokens)
    assert tm.step_flops == jm.step_flops
    js, ts = jr["cache_stats"], tr["cache_stats"]
    assert (ts.hits, ts.misses, ts.evictions) == (js.hits, js.misses, js.evictions)
    assert tr["modeled_time_s"] == jr["modeled_time_s"]
    assert tr["modeled_time_overlapped_s"] == jr["modeled_time_overlapped_s"]
    assert tm.transfers > 0 and ts.evictions > 0


@pytest.mark.parametrize("arch,with_prefix", [("internvl2-76b-smoke", True),
                                              ("musicgen-medium-smoke", False)])
def test_step_builders_match_jax(models, arch, with_prefix):
    """``build_prefill_step`` (a batch with or without ``prefix_embed``,
    ``n_slots`` room for the decode) then 4 greedy ``build_decode_step``
    calls, against the JAX builders: logits 1e-4, tokens identical."""
    jcfg, tcfg, tree, params = models[arch]
    toks, pe = prompt(jcfg, 2, 10, seed=8, prefix=with_prefix)
    P = jcfg.prefix_len if with_prefix else 0
    n_slots, G = P + 10 + 4, 4
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.as_tensor(toks).long()}
    if with_prefix:
        jbatch["prefix_embed"], tbatch["prefix_embed"] = jnp.asarray(pe), torch.as_tensor(pe)
    jparams = jax.tree.map(jnp.asarray, tree)
    jlg, jcache = jsteps.build_prefill_step(jcfg, JAX_REF, n_slots=n_slots)(jparams, jbatch)
    tlg, tcache = tsteps.build_prefill_step(tcfg, CPU, n_slots=n_slots)(params, tbatch)
    assert tcache["pos"] == P + 10
    jdec = jax.jit(jsteps.build_decode_step(jcfg, JAX_REF))
    tdec = tsteps.build_decode_step(tcfg, CPU)
    for _ in range(G):
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL_LOGITS)
        jtok = jnp.argmax(jlg[:, -1], -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tlg[:, -1], -1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlg, jcache = jdec(jparams, {"tokens": jtok, "cache": jcache})
        tlg, tcache = tdec(params, {"tokens": ttok, "cache": tcache})
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL_LOGITS)
    assert tcache["pos"] == n_slots
