"""Shared checks of the port's ``OffloadedWaveServer`` against the JAX
package's on the CPU
(``kernel_backend="ref"``), from the same bridged weights and LoRA tree.

One workload (all requests at time 0, one prompt length, budgets that
differ) is served under fcfs and expert-affinity, with and without a
LoRA tree whose ``b`` is nonzero. The affinity scores are the port's
oracle (``prefill_expert_scores``), handed to both servers, so that both
schedulers see the same numbers.
Per-request tokens and finish reasons, the transfer and hit counts, both
modeled clocks and every latency and TTFT must equal the reference's
(the clocks to 1e-12 relative: they are sums of the same counts); with
an SLO the same requests are deadline-retired and shed.

The test files ``tests/test_torch_wave*.py`` import the ``test_*``
functions below and define the ``wave_model`` fixture for their config
(one file per config keeps each file's JAX compile time apart).
"""
import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.offload_engine import PCIE5_H100  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.bridge import lora_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.lora import lora_scale  # noqa: E402
from repro_torch.core.offload_engine import HardwareProfile  # noqa: E402

HW = HardwareProfile(**{f.name: getattr(PCIE5_H100, f.name)
                        for f in dataclasses.fields(HardwareProfile)})


def _two_layers(cfg):
    return dataclasses.replace(cfg, layout=(dataclasses.replace(cfg.layout[0], repeats=2),))


# id -> (config, reduction, cache capacity C, wave size)
ARCHS = {
    "granite-smoke": ("granite-moe-1b-a400m-smoke", lambda c: c, 2, 2),
    "olmoe-mini-2l": ("olmoe-mini", _two_layers, 8, 3),
}
N_REQ, PROMPT = 6, 8
BUDGETS = (3, 6, 4, 5, 2, 6)


def lora_tree(cfg, seed: int):
    """A numpy LoRA tree of the JAX layout for ``cfg`` at the config's
    rank: ``a`` ~ N(0, 1/din) as the init draws it, ``b`` ~ N(0, 1/r) (the
    init's zeros would leave the term without effect)."""
    rng = np.random.default_rng(seed)
    r = cfg.melinoe.lora_rank
    tree = {}
    for gi, g in enumerate(cfg.layout):
        for pi, bname in enumerate(g.pattern):
            b = cfg.block_defs[bname]
            if b.moe is None:
                continue
            E, d, f = b.moe.num_experts, cfg.d_model, b.moe.d_ff
            tree.setdefault(f"g{gi}", {})[f"p{pi}"] = {
                t: {"a": (rng.standard_normal((g.repeats, E, din, r)) * din**-0.5
                          ).astype(np.float32),
                    "b": (rng.standard_normal((g.repeats, E, r, dout)) * r**-0.5
                          ).astype(np.float32)}
                for t, (din, dout) in (("wu", (d, f)), ("wd", (f, d)))}
    return tree


def build(key):
    """Both packages' configs, weights (JAX init, key 0, bridged), a LoRA
    tree, the prompts and the port's oracle scores with and without it."""
    name, cut, C, wave = ARCHS[key]
    jcfg, tcfg = cut(jax_get_config(name)), cut(get_config(name))
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    jlora = lora_tree(jcfg, 1)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jcfg.vocab, (N_REQ, PROMPT)).astype(np.int32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    tlora = lora_from_jax(tcfg, jlora)
    scores = {}  # the port's oracle, carried to both servers
    for lk, lt in (("nolora", None), ("lora", tlora)):
        reqs = [serving.ServeRequest(rid=i, prompt=p, max_new_tokens=1)
                for i, p in enumerate(prompts)]
        serving.prefill_expert_scores(tcfg, tparams, reqs, lora=lt,
                                      lora_scale=lora_scale(tcfg.melinoe))
        scores[lk] = [r.expert_scores for r in reqs]
    return dict(key=key, jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jlora=jlora, tlora=tlora, prompts=prompts, scores=scores, C=C, wave=wave)


_SHARED = {}


def _share_jits(key, eng):
    """Engines of one config share the first one's compiled steps (the
    traced functions read only the config and the backend)."""
    names = ("_jit_cache", "_embed_fn", "_next_tok_fn", "_slab_scatter")
    shared = _SHARED.setdefault(key, {n: getattr(eng, n) for n in names})
    for n, v in shared.items():
        setattr(eng, n, v)


def _requests(pkg, m, lk, slo=None):
    return [pkg.ServeRequest(rid=i, prompt=p, max_new_tokens=BUDGETS[i],
                             expert_scores=m["scores"][lk][i], slo=slo)
            for i, p in enumerate(m["prompts"])]


def _scheduler(pkg, policy, C):
    return (pkg.get_scheduler(policy) if policy == "fcfs"
            else pkg.get_scheduler(policy, top_c=C))


def serve_both(m, policy, lk, *, slo=None, overlap=False):
    sc = lora_scale(m["tcfg"].melinoe)
    jl = None if lk == "nolora" else jax.tree.map(jnp.asarray, m["jlora"])
    tl = None if lk == "nolora" else m["tlora"]
    jsrv = jserving.OffloadedWaveServer(
        m["jcfg"], m["jparams"], capacity=m["C"], policy="gamma",
        scheduler=_scheduler(jserving, policy, m["C"]), wave_size=m["wave"],
        hw=PCIE5_H100, lora=jl, lora_scale=sc, overlap=overlap)
    _share_jits(m["key"], jsrv.engine)
    jres, jmt = jsrv.run(jserving.RequestQueue(_requests(jserving, m, lk, slo)))
    tsrv = serving.OffloadedWaveServer(
        m["tcfg"], m["tparams"], capacity=m["C"], policy="gamma",
        scheduler=_scheduler(serving, policy, m["C"]), wave_size=m["wave"],
        hw=HW, lora=tl, lora_scale=sc, overlap=overlap, device="cpu")
    tres, tmt = tsrv.run(serving.RequestQueue(_requests(serving, m, lk, slo)))
    return jres, jmt, tres, tmt


def assert_same(jres, jmt, tres, tmt):
    assert [r.rid for r in tres] == [r.rid for r in jres]
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        assert t.finish_reason == j.finish_reason
        assert t.decode_steps == j.decode_steps
        for f in ("start_time", "finish_time"):
            np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-12, atol=0)
    for f in ("transfers", "transfer_bytes", "prefetch_transfers", "cache_hits",
              "cache_misses", "generated_tokens", "prefill_tokens", "decode_steps",
              "requests_shed", "requests_expired", "deadline_retired", "slo_attained",
              "degraded_requests", "requests_finished"):
        assert getattr(tmt, f) == getattr(jmt, f), f
    for f in ("modeled_time", "modeled_time_serial", "modeled_time_overlapped"):
        np.testing.assert_allclose(getattr(tmt, f), getattr(jmt, f), rtol=1e-12, atol=0)
    for f in ("latencies", "ttfts", "itls"):
        np.testing.assert_allclose(getattr(tmt, f), getattr(jmt, f), rtol=1e-12, atol=0)


@pytest.mark.parametrize("lk", ["nolora", "lora"])
@pytest.mark.parametrize("policy", ["fcfs", "expert-affinity"])
def test_wave_server_matches_reference(wave_model, policy, lk):
    m = wave_model
    jres, jmt, tres, tmt = serve_both(m, policy, lk)
    assert_same(jres, jmt, tres, tmt)
    assert tmt.transfers > 0 and tmt.prefetch_transfers > 0
    assert [len(r.tokens) for r in tres] == list(BUDGETS)


def test_wave_server_lora_moves_tokens_and_policies_agree(wave_model):
    """Scheduling changes when experts move, never what is computed:
    tokens are equal across policies (the invariant of
    tests/test_serving.py); the LoRA term changes them."""
    m = wave_model
    toks = {}
    for lk in ("nolora", "lora"):
        for policy in ("fcfs", "expert-affinity"):
            srv = serving.OffloadedWaveServer(
                m["tcfg"], m["tparams"], capacity=m["C"], policy="gamma",
                scheduler=_scheduler(serving, policy, m["C"]), wave_size=m["wave"],
                hw=HW, lora=None if lk == "nolora" else m["tlora"],
                lora_scale=lora_scale(m["tcfg"].melinoe), device="cpu")
            res, _ = srv.run(serving.RequestQueue(_requests(serving, m, lk)))
            toks[lk, policy] = [r.tokens.tolist() for r in res]
        assert toks[lk, "fcfs"] == toks[lk, "expert-affinity"]
    assert toks["nolora", "fcfs"] != toks["lora", "fcfs"]


@pytest.mark.parametrize("overlap", [False, True])
def test_wave_server_slo_retires_and_sheds_as_reference(wave_model, overlap):
    """With an SLO between the fastest and the slowest finish of the best
    effort run, some requests finish, some are cut mid-decode at the
    deadline, and some expire in the queue: the same ones as the
    reference, at the same times."""
    m = wave_model
    srv = serving.OffloadedWaveServer(  # the best-effort run picks the SLO
        m["tcfg"], m["tparams"], capacity=m["C"], policy="gamma",
        scheduler=_scheduler(serving, "fcfs", m["C"]), wave_size=m["wave"], hw=HW,
        lora=m["tlora"], lora_scale=lora_scale(m["tcfg"].melinoe), overlap=overlap,
        device="cpu")
    lat = sorted(srv.run(serving.RequestQueue(_requests(serving, m, "lora")))[1].latencies)
    slo = (lat[1] + lat[2]) / 2  # the third request is cut mid-decode
    jres, jmt, tres, tmt = serve_both(m, "fcfs", "lora", slo=slo, overlap=overlap)
    assert_same(jres, jmt, tres, tmt)
    reasons = {r.finish_reason for r in tres}
    assert {"deadline", "shed"} <= reasons, reasons


def test_wave_server_hooks_and_unported_knobs(wave_model):
    m = wave_model
    kw = dict(capacity=m["C"], wave_size=m["wave"], hw=HW, device="cpu")
    srv = serving.OffloadedWaveServer(m["tcfg"], m["tparams"], **kw)
    steps = []
    res, mt = srv.run(serving.RequestQueue(_requests(serving, m, "nolora")),
                      on_step=steps.append, should_drain=lambda: len(steps) >= 2)
    n = 2 * m["wave"]
    assert srv.drained and len(steps) == 2 and len(res) == n
    assert steps[-1]["finished"] == n and steps[-1]["in_flight"] == 0
    # the knobs of the operations stack work (their parity tests:
    # tests/test_torch_recovery.py, tests/test_torch_faults.py): a journaled,
    # checkpointed and audited serve of the remaining requests; the dict
    # engine serves the slab engine's tokens (tests/test_torch_engine_dict.py)
    from repro_torch.faults import FetchPolicy
    from repro_torch.recovery import RequestJournal, recover

    with tempfile.TemporaryDirectory() as d:
        jr = RequestJournal(d)
        srv = serving.OffloadedWaveServer(m["tcfg"], m["tparams"], **kw,
                                          fetch_policy=FetchPolicy(max_retries=1))
        res2, _ = srv.run(serving.RequestQueue(_requests(serving, m, "nolora")),
                          journal=jr, checkpoint_every=1, audit_every=1)
        jr.close()
        state = recover(d)
        assert state.kind == "wave" and not state.pending
        assert sorted(r.rid for r in state.results) == [r.rid for r in res2]
        assert len(state.engine["cache"]) == m["tcfg"].n_moe_layers
    for a, b in zip(res, res2):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    res3, _ = serving.OffloadedWaveServer(m["tcfg"], m["tparams"], **kw, engine_impl="dict"
                                          ).run(serving.RequestQueue(_requests(serving, m,
                                                                               "nolora")))
    for a, b in zip(res2, res3):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    # the little-expert tier is ported (tests/test_torch_little*.py)
    little = serving.OffloadedWaveServer(m["tcfg"], m["tparams"], little_experts=True,
                                         little_rank=2, **kw).engine.little
    assert little.rank == 2 and little.n_layers == m["tcfg"].n_moe_layers
    # max_backlog sheds the latest arrivals beyond the bound
    srv = serving.OffloadedWaveServer(m["tcfg"], m["tparams"], max_backlog=4, **kw)
    res, mt = srv.run(serving.RequestQueue(_requests(serving, m, "nolora")))
    assert mt.requests_shed == 2 and sum(r.finish_reason == "shed" for r in res) == 2
