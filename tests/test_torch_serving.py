"""The port's serving stack on the CPU: the continuous-batching server,
schedulers, queue, batch state, scorers, sampling and the ``bench_serve``
launcher — the checks of ``tests/test_serving.py`` against the port, and
the port against the JAX package's ``ContinuousBatchingServer``.

Weights are the JAX ``init_params`` tree of granite-moe-1b-a400m-smoke
(key 0, fp32), carried across by the bridge. Greedy tokens, finish
reasons and the server's counts must be identical to the reference's;
times are not compared (both clocks are host time). Sampled tokens are
the port's own (``jax.random`` cannot be reproduced): they are held to
determinism, to independence from the slot and the pool, and to a
chi-square test; the top-k / top-p masks are held to the reference's.
"""
import importlib
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.synthetic import ClusterLM as JaxClusterLM  # noqa: E402
from repro.data.synthetic import SyntheticConfig as JaxSyntheticConfig  # noqa: E402
from repro.inference import sampling as jsampling  # noqa: E402
from repro.inference.engine import Request as JaxRequest  # noqa: E402
from repro.inference.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.models import Runtime as JaxRuntime, init_params as jax_init_params  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import ClusterLM, SyntheticConfig  # noqa: E402
from repro_torch.inference import Request, ServingEngine  # noqa: E402
from repro_torch.inference import sampling  # noqa: E402
from repro_torch.launch import bench_serve  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BatchState,
    ContinuousBatchingServer,
    RequestQueue,
    ServeRequest,
    ServeResult,
    ServerMetrics,
    TrafficConfig,
    get_scheduler,
    predictor_expert_scores,
    prefill_expert_scores,
    serve_static,
    synthesize_workload,
)

pytestmark = pytest.mark.torch

ARCH = "granite-moe-1b-a400m-smoke"


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config(ARCH)
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.key(0), jcfg, jnp.float32))
    cfg = get_config(ARCH)
    return cfg, params_from_jax(tree, cfg), jcfg, jax.tree.map(jnp.asarray, tree)


def mk_requests(cfg, lens, budgets, *, seed=0, arrivals=None, temps=None, cls=ServeRequest):
    rng = np.random.default_rng(seed)
    return [
        cls(
            rid=i,
            prompt=rng.integers(0, cfg.vocab, lens[i]).astype(np.int32),
            max_new_tokens=budgets[i],
            arrival_time=0.0 if arrivals is None else arrivals[i],
            temperature=0.0 if temps is None else temps[i],
        )
        for i in range(len(lens))
    ]


# ---------------------------------------------------------------------------
# Continuous batching: correctness (tests/test_serving.py, on the port)
# ---------------------------------------------------------------------------


def test_continuous_matches_single_request_engine(setup):
    """In-flight batching must not change any request's tokens: each
    completion equals the request decoded alone through the static
    engine (mixed prompt lengths AND mixed budgets)."""
    cfg, params, _, _ = setup
    reqs = mk_requests(cfg, lens=[6, 11, 8, 14, 9], budgets=[7, 3, 9, 5, 6])
    srv = ContinuousBatchingServer(cfg, params, n_slots=2, max_len=32)
    results, mt = srv.run(RequestQueue(reqs))
    assert [r.rid for r in results] == [0, 1, 2, 3, 4]
    eng = ServingEngine(cfg, params, max_batch=1)
    for req, res in zip(reqs, results):
        ref = eng.generate_batch([Request(prompt=req.prompt,
                                          max_new_tokens=req.max_new_tokens)])[0]
        assert res.finish_reason == "length"
        np.testing.assert_array_equal(res.tokens, ref.tokens)
    assert mt.generated_tokens == sum(r.max_new_tokens for r in reqs)
    assert len(mt.latencies) == len(reqs)


def test_continuous_beats_static_on_mixed_budgets(setup):
    """Same tokens per request as padded static batching, in strictly
    fewer decode iterations."""
    cfg, params, _, _ = setup
    budgets = [3, 12, 5, 9, 4, 11, 6, 8]
    reqs = mk_requests(cfg, lens=[8] * len(budgets), budgets=budgets)
    srv = ContinuousBatchingServer(cfg, params, n_slots=4, max_len=24)
    cont, mt = srv.run(RequestQueue(reqs))
    stat, static_iters = serve_static(cfg, params, reqs, batch_size=4)
    for a, b in zip(cont, stat):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert mt.decode_steps < static_iters, (mt.decode_steps, static_iters)
    assert mt.occupancy > 0.5


def test_stop_token_retires_early_and_slot_is_reused(setup):
    """A stop token ends the request mid-budget (finish_reason 'stop') and
    the freed slot serves the queued requests."""
    cfg, params, _, _ = setup
    reqs = mk_requests(cfg, lens=[9, 9, 9], budgets=[10, 10, 10])
    eng = ServingEngine(cfg, params, max_batch=1)
    ref = eng.generate_batch([Request(prompt=reqs[0].prompt, max_new_tokens=10)])[0]
    reqs[0].stop_tokens = (int(ref.tokens[2]),)
    srv = ContinuousBatchingServer(cfg, params, n_slots=1, max_len=32)
    results, _ = srv.run(RequestQueue(reqs))
    assert results[0].finish_reason == "stop"
    np.testing.assert_array_equal(results[0].tokens, ref.tokens[: len(results[0].tokens)])
    assert len(results[0].tokens) <= 3
    assert [r.finish_reason for r in results[1:]] == ["length", "length"]
    assert all(len(r.tokens) == 10 for r in results[1:])


def test_arrivals_respected_and_latencies_recorded(setup):
    cfg, params, _, _ = setup
    reqs = mk_requests(cfg, lens=[8, 8, 8], budgets=[4, 4, 4], arrivals=[0.0, 100.0, 100.0])
    results, mt = ContinuousBatchingServer(cfg, params, n_slots=2, max_len=16).run(
        RequestQueue(reqs))
    assert len(results) == 3
    assert results[1].start_time >= 100.0 and results[2].start_time >= 100.0
    assert all(r.latency >= 0 for r in results)
    assert len(mt.ttfts) == 3 and mt.wall_time > 0


def test_generate_batch_honors_stop_tokens(setup):
    cfg, params, _, _ = setup
    p = np.random.default_rng(1).integers(0, cfg.vocab, 9).astype(np.int32)
    eng = ServingEngine(cfg, params, max_batch=1)
    full = eng.generate_batch([Request(prompt=p, max_new_tokens=8)])[0]
    assert full.finish_reason == "length"
    stopped = eng.generate_batch(
        [Request(prompt=p, max_new_tokens=8, stop_tokens=(int(full.tokens[3]),))])[0]
    assert stopped.finish_reason == "stop" and len(stopped.tokens) <= 4
    np.testing.assert_array_equal(stopped.tokens, full.tokens[: len(stopped.tokens)])


def test_unported_knobs_raise(setup, tmp_path):
    """What this test once found raising is ported now: the crash-safety
    knobs of ``run`` (journal, checkpoints, the watchdog, resume), the
    engine's ``fetch_policy`` and ``ServerMetrics.publish`` each work here
    (their parity tests: tests/test_torch_recovery.py,
    tests/test_torch_faults.py, tests/test_torch_obs.py). The engine's
    ``impl="dict"`` still raises."""
    from repro_torch.core.offload_engine import OffloadedMoEEngine
    from repro_torch.faults import FetchPolicy
    from repro_torch.obs import MetricsRegistry
    from repro_torch.recovery import RequestJournal, recover

    cfg, params, _, _ = setup
    srv = ContinuousBatchingServer(cfg, params, n_slots=1, max_len=16)
    ref, _ = srv.run(RequestQueue(mk_requests(cfg, [4, 5], [3, 2])))
    jr = RequestJournal(tmp_path)
    res, mt = srv.run(RequestQueue(mk_requests(cfg, [4, 5], [3, 2])), journal=jr,
                      checkpoint_every=1, audit_every=1)
    jr.close()
    for a, b in zip(ref, res):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    state = recover(tmp_path)
    assert state.kind == "continuous" and not state.pending
    assert sorted(r.rid for r in state.results) == [0, 1]
    again, mt2 = srv.run(state.build_queue(), state.metrics, resume=state)
    assert [r.rid for r in again] == [0, 1] and mt2.requests_finished == 2
    eng = OffloadedMoEEngine(cfg, params, capacity=2, device="cpu",
                             fetch_policy=FetchPolicy(max_retries=1))
    assert eng.fetch_policy.max_retries == 1
    with pytest.raises(NotImplementedError, match="dict engine"):
        OffloadedMoEEngine(cfg, params, capacity=2, device="cpu", impl="dict")
    reg = MetricsRegistry()
    mt.publish(reg)
    assert reg.snapshot()['serve_requests{policy="fcfs"}'] == 2.0
    # the predictor scorer is ported (tests/test_torch_predictor.py)
    assert predictor_expert_scores(None, None, []) == []


def test_on_step_and_should_drain(setup):
    """``on_step`` sees every decode step; ``should_drain`` stops admission,
    finishes what is in flight and leaves the rest queued."""
    cfg, params, _, _ = setup
    reqs = mk_requests(cfg, lens=[8] * 4, budgets=[3] * 4)
    seen = []
    srv = ContinuousBatchingServer(cfg, params, n_slots=2, max_len=16)
    q = RequestQueue(reqs)
    results, mt = srv.run(q, on_step=seen.append,
                          should_drain=lambda: bool(seen))
    assert srv.drained and len(results) == 2 and len(q) == 2
    assert [s["step"] for s in seen] == list(range(1, mt.decode_steps + 1))
    assert seen[-1]["finished"] == 2 and seen[-1]["generated"] == 6


# ---------------------------------------------------------------------------
# The port against the JAX ContinuousBatchingServer
# ---------------------------------------------------------------------------

POLICY_BUDGETS = [7, 3, 9, 5, 6, 4]


@pytest.mark.parametrize("policy", ["fcfs", "sjf", "expert-affinity"])
def test_server_matches_jax_server(setup, policy):
    """Arrivals all at once, one prompt length, mixed budgets and a stop
    token: per-request tokens and finish reasons, generated_tokens,
    prefill_tokens, requests_finished and the decode steps equal the JAX
    server's; expert-affinity orders on ``prefill_expert_scores`` (held
    to JAX's within 1e-5)."""
    cfg, params, jcfg, jparams = setup
    budgets = POLICY_BUDGETS
    reqs = mk_requests(cfg, lens=[8] * 6, budgets=budgets, seed=3)
    jreqs = mk_requests(cfg, lens=[8] * 6, budgets=budgets, seed=3,
                        cls=jserving.ServeRequest)
    stop = (int(ServingEngine(cfg, params, max_batch=1).generate_batch(
        [Request(reqs[2].prompt, budgets[2])])[0].tokens[4]),)
    reqs[2].stop_tokens = jreqs[2].stop_tokens = stop
    kw = {}
    if policy == "expert-affinity":
        kw = {"top_c": 2}
        ts = prefill_expert_scores(cfg, params, reqs)
        js = jserving.prefill_expert_scores(jcfg, jparams, jreqs,
                                            rt=JaxRuntime(zero_drop=True))
        for a, b in zip(ts, js):
            assert a.shape == b.shape == (cfg.n_moe_layers, cfg.moe_spec.num_experts)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    jsrv = jserving.ContinuousBatchingServer(jcfg, jparams, n_slots=2, max_len=20,
                                             scheduler=jserving.get_scheduler(policy, **kw))
    jres, jmt = jsrv.run(jserving.RequestQueue(jreqs))
    srv = ContinuousBatchingServer(cfg, params, n_slots=2, max_len=20,
                                   scheduler=get_scheduler(policy, **kw))
    res, mt = srv.run(RequestQueue(reqs))
    assert [r.rid for r in res] == [r.rid for r in jres]
    for a, b in zip(res, jres):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.finish_reason == b.finish_reason
    assert res[2].finish_reason == "stop"
    for k in ("generated_tokens", "prefill_tokens", "requests_finished", "decode_steps"):
        assert getattr(mt, k) == getattr(jmt, k), k
    if policy != "fcfs":  # the policy changed the admission order
        assert [r.start_time for r in res] != sorted(r.start_time for r in res)


def test_engine_greedy_tokens_and_router_probes_match_jax(setup):
    """``generate_batch`` with ``collect_probs``: greedy tokens equal the JAX
    engine's, router probes (L, max_new - 1, E) within 1e-5."""
    cfg, params, jcfg, jparams = setup
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (7, 10)]
    jout = JaxServingEngine(jcfg, jparams).generate_batch(
        [JaxRequest(p, 5) for p in prompts], collect_probs=True)
    tout = ServingEngine(cfg, params).generate_batch(
        [Request(p, 5) for p in prompts], collect_probs=True)
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        assert t.router_probs.shape == j.router_probs.shape == (
            cfg.n_moe_layers, 4, cfg.moe_spec.num_experts)
        np.testing.assert_allclose(t.router_probs, j.router_probs, rtol=1e-5, atol=1e-5)


def test_synthesize_workload_matches_jax():
    """One seed gives the JAX trace: prompts, budgets, arrivals, clusters."""
    for arrival in ("poisson", "bursty", "all_at_once"):
        kw = dict(n_requests=9, arrival=arrival, rate=2.0, burst_size=3,
                  prompt_len=(4, 12), max_new_tokens=(2, 6), seed=5)
        mine = synthesize_workload(ClusterLM(SyntheticConfig(vocab=512, seq_len=24,
                                                             seed=3)),
                                   TrafficConfig(**kw))
        ref = jserving.synthesize_workload(
            JaxClusterLM(JaxSyntheticConfig(vocab=512, seq_len=24, seed=3)),
            jserving.TrafficConfig(**kw))
        for a, b in zip(mine, ref, strict=True):
            np.testing.assert_array_equal(a.prompt, b.prompt)
            assert (a.rid, a.max_new_tokens, a.arrival_time, a.cluster) == (
                b.rid, b.max_new_tokens, b.arrival_time, b.cluster)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def test_per_request_temperature_sampling(setup):
    """A greedy row stays greedy while another samples at high temperature;
    one seed gives the same draws again, another seed others."""
    cfg, params, _, _ = setup
    p = np.random.default_rng(0).integers(0, cfg.vocab, 10).astype(np.int32)
    eng = ServingEngine(cfg, params, max_batch=2)
    greedy_ref = eng.generate_batch([Request(p, 8), Request(p, 8)])
    mixed = eng.generate_batch([Request(p, 8, 0.0), Request(p, 8, 2.0)], seed=3)
    np.testing.assert_array_equal(mixed[0].tokens, greedy_ref[0].tokens)
    assert not np.array_equal(mixed[1].tokens, greedy_ref[1].tokens)
    again = eng.generate_batch([Request(p, 8, 0.0), Request(p, 8, 2.0)], seed=3)
    np.testing.assert_array_equal(again[1].tokens, mixed[1].tokens)
    other = eng.generate_batch([Request(p, 8, 0.0), Request(p, 8, 2.0)], seed=4)
    assert not np.array_equal(other[1].tokens, mixed[1].tokens)


def test_sampled_tokens_do_not_depend_on_slot_or_pool(setup):
    """A request's draws are keyed by (seed, rid, step): the same tokens
    with 1 slot or 3, alone or beside other requests; greedy rows stay the
    engine's greedy tokens."""
    cfg, params, _, _ = setup

    def mk():
        return mk_requests(cfg, lens=[8, 8, 8, 8], budgets=[6, 6, 5, 6],
                           temps=[0.0, 1.5, 1.5, 0.8])

    runs = {}
    for n_slots in (1, 3):
        runs[n_slots], _ = ContinuousBatchingServer(cfg, params, n_slots=n_slots,
                                                    max_len=24, seed=5).run(RequestQueue(mk()))
    alone, _ = ContinuousBatchingServer(cfg, params, n_slots=3, max_len=24, seed=5).run(
        RequestQueue([mk()[1]]))
    for a, b in zip(runs[1], runs[3]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(alone[0].tokens, runs[3][1].tokens)
    ref = ServingEngine(cfg, params, max_batch=1).generate_batch(
        [Request(prompt=mk()[0].prompt, max_new_tokens=6)])[0]
    np.testing.assert_array_equal(runs[3][0].tokens, ref.tokens)
    other, _ = ContinuousBatchingServer(cfg, params, n_slots=3, max_len=24, seed=6).run(
        RequestQueue(mk()))
    assert any(not np.array_equal(a.tokens, b.tokens) for a, b in zip(other, runs[3]))


def test_sample_per_row_follows_softmax_over_temperature():
    """Chi-square of 4000 draws (one key each) against softmax(l / T) on 6
    tokens: below 20.5, the 0.1% point of chi-square with 5 degrees of
    freedom. Greedy rows take the argmax and draw nothing."""
    V, n, T = 6, 4000, 0.7
    logits = torch.tensor([1.0, 0.2, -0.5, 0.9, 0.0, -1.5])
    batch = logits.expand(n, 1, V).clone()
    gens = [sampling.row_generator(0, rid, 1) for rid in range(n)]
    toks = sampling.sample_per_row(batch, np.full(n, T), gens)
    assert toks.shape == (n, 1) and toks.dtype == torch.int64
    counts = np.bincount(toks[:, 0].numpy(), minlength=V)
    expect = n * torch.softmax(logits / T, -1).double().numpy()
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 20.5, (chi2, counts, expect)
    temps = np.where(np.arange(n) % 2 == 0, 0.0, T)
    mixed = sampling.sample_per_row(batch, temps, [None if t <= 0 else g
                                                   for t, g in zip(temps, gens)])
    assert (mixed[::2, 0] == 0).all()
    # a key gives the same draw again
    again = sampling.sample_per_row(batch[:50], np.full(50, T),
                                    [sampling.row_generator(0, rid, 1) for rid in range(50)])
    assert torch.equal(again, toks[:50])


@pytest.mark.parametrize("top_k,top_p", [(4, 0.0), (0, 0.7), (6, 0.5), (0, 1.0)])
def test_top_k_top_p_masks_match_jax(top_k, top_p):
    """The tokens ``sample`` can draw are those JAX's ``sample`` draws: the
    support of 2000 JAX draws (every kept token has mass above 2%) equals
    the port's unmasked set, row by row; the port's draws stay inside it."""
    V, T = 16, 0.8
    logits = np.random.default_rng(11).uniform(0.0, 1.0, (3, 1, V)).astype(np.float32)
    keys = jax.random.split(jax.random.key(0), 2000)
    draws = np.asarray(jax.vmap(lambda k: jsampling.sample(
        jnp.asarray(logits), k, temperature=T, top_k=top_k, top_p=top_p))(keys))
    masked = sampling.sample_masks(torch.from_numpy(logits), temperature=T, top_k=top_k,
                                   top_p=top_p)
    kept = (masked > sampling.NEG / 2).numpy()[:, 0]
    for b in range(3):
        assert set(np.flatnonzero(kept[b])) == set(np.unique(draws[:, b, 0])), b
    if top_k:  # top-p then cuts further
        assert (kept.sum(-1) == top_k).all() if not top_p else (kept.sum(-1) < top_k).all()
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        t = sampling.sample(torch.from_numpy(logits), gen, temperature=T, top_k=top_k,
                            top_p=top_p)[:, 0].numpy()
        assert kept[np.arange(3), t].all()


# ---------------------------------------------------------------------------
# BatchState, schedulers, queue (numpy copies)
# ---------------------------------------------------------------------------


def test_batch_state_slot_invariants():
    bs = BatchState(2, max_len=16)
    r0 = ServeRequest(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=3)
    r1 = ServeRequest(rid=1, prompt=np.zeros(4, np.int32), max_new_tokens=2)
    bs.occupy(0, r0, now=1.0)
    assert bs.free_slots() == [1] and bs.active_slots() == [0]
    with pytest.raises(AssertionError):  # double occupancy
        bs.occupy(0, r1, now=1.0)
    with pytest.raises(AssertionError):  # same rid twice
        bs.occupy(1, ServeRequest(rid=0, prompt=np.zeros(2, np.int32)), now=1.0)
    with pytest.raises(AssertionError):  # KV budget exceeded
        bs.occupy(1, ServeRequest(rid=9, prompt=np.zeros(10, np.int32),
                                  max_new_tokens=10), now=1.0)
    assert bs.append_token(0, 5) is None
    assert bs.append_token(0, 6) is None
    assert bs.append_token(0, 7) == "length"
    res = bs.retire(0, now=2.0, reason="length")
    assert res.rid == 0 and list(res.tokens) == [5, 6, 7]
    assert bs.free_slots() == [0, 1] and bs.audit() == []
    bs.occupy(1, ServeRequest(rid=2, prompt=np.zeros(2, np.int32), max_new_tokens=5,
                              stop_tokens=(42,)), now=3.0)
    assert bs.append_token(1, 42) == "stop"


def _scored(rid, arrival, experts, *, L=2, E=8, budget=8):
    scores = np.zeros((L, E))
    scores[:, list(experts)] = 1.0
    return ServeRequest(rid=rid, prompt=np.zeros(4, np.int32), max_new_tokens=budget,
                        arrival_time=arrival, expert_scores=scores)


def test_scheduler_ordering_deterministic():
    a = _scored(0, 0.0, {0, 1}, budget=20)
    b = _scored(1, 1.0, {4, 5}, budget=2)
    c = _scored(2, 2.0, {0, 1}, budget=10)
    d = _scored(3, 3.0, {4, 5}, budget=5)
    ready = [d, c, b, a]
    assert [r.rid for r in get_scheduler("fcfs").order(ready)] == [0, 1, 2, 3]
    assert [r.rid for r in get_scheduler("sjf").order(ready)] == [1, 3, 2, 0]
    aff = get_scheduler("expert-affinity", top_c=2)
    assert [r.rid for r in aff.order(ready)] == [0, 2, 1, 3]
    assert [r.rid for r in aff.order(ready, hot=[b])][0] == 1
    plain = [ServeRequest(rid=i, prompt=np.zeros(2, np.int32), arrival_time=float(-i))
             for i in range(3)]
    assert [r.rid for r in get_scheduler("expert-affinity").order(plain)] == [2, 1, 0]
    with pytest.raises(KeyError):
        get_scheduler("lottery")


def test_traffic_generator_shapes_and_arrivals():
    lm = ClusterLM(SyntheticConfig(vocab=512, n_clusters=4, seq_len=64, seed=0))
    for arrival in ("poisson", "bursty", "all_at_once"):
        tcfg = TrafficConfig(n_requests=12, arrival=arrival, rate=2.0, burst_size=3,
                             prompt_len=(4, 9), max_new_tokens=(2, 5), n_clusters=2, seed=1)
        reqs = synthesize_workload(lm, tcfg)
        times = [r.arrival_time for r in reqs]
        assert len(reqs) == 12 and times == sorted(times)
        assert all(4 <= r.prompt_len <= 9 and 2 <= r.max_new_tokens <= 5 for r in reqs)
        assert all(r.cluster in (0, 1) for r in reqs)
        if arrival == "bursty":
            assert len(set(times)) == 4
        if arrival == "all_at_once":
            assert set(times) == {0.0}
    with pytest.raises(ValueError, match="arrival"):
        synthesize_workload(lm, TrafficConfig(arrival="trickle"))


def test_request_queue_semantics():
    reqs = [ServeRequest(rid=i, prompt=np.zeros(2, np.int32), arrival_time=float(i))
            for i in range(3)]
    q = RequestQueue(reqs)
    assert len(q) == 3 and q.next_arrival() == 0.0
    assert [r.rid for r in q.ready(1.5)] == [0, 1] and q.backlog(1.5) == 2
    q.admit(reqs[0])
    assert [r.rid for r in q.ready(1.5)] == [1] and len(q) == 2
    with pytest.raises(KeyError):
        q.admit(reqs[0])
    assert q.audit() == []


def test_serve_request_identity_semantics():
    a = ServeRequest(rid=0, prompt=np.zeros(3, np.int32))
    b = ServeRequest(rid=0, prompt=np.zeros(3, np.int32))
    assert a != b and a == a and len({a, b}) == 2
    pool = [a, b]
    pool.remove(b)
    assert pool == [a]
    ra = ServeResult(rid=0, tokens=np.zeros(2, np.int32), finish_reason="stop")
    rb = ServeResult(rid=0, tokens=np.zeros(2, np.int32), finish_reason="stop")
    assert ra != rb and len({ra, rb}) == 2


def test_request_queue_out_of_order_push():
    q = RequestQueue()
    times = [3.0, 1.0, 2.0, 0.5, 2.0]
    for i, t in enumerate(times):
        assert q.push(ServeRequest(rid=i, prompt=np.zeros(2, np.int32), arrival_time=t))
    assert [r.rid for r in q.ready(10.0)] == [3, 1, 2, 4, 0]
    assert q.next_arrival() == 0.5
    assert [r.rid for r in q.ready(2.0)] == [3, 1, 2, 4]


def test_request_queue_bound_sheds_latest():
    reqs = [ServeRequest(rid=i, prompt=np.zeros(2, np.int32), arrival_time=float(i))
            for i in range(5)]
    q = RequestQueue(reqs, max_pending=2)
    assert len(q) == 5 and q.shed_count == 0
    assert q.enforce_bound(0.5) == []
    assert [r.rid for r in q.enforce_bound(2.5)] == [2]
    assert q.shed_count == 1 and len(q) == 4
    assert not q.push(ServeRequest(rid=9, prompt=np.zeros(2, np.int32), arrival_time=10.0))
    early = ServeRequest(rid=8, prompt=np.zeros(2, np.int32), arrival_time=-1.0)
    assert not q.push(early)
    assert early in q.ready(0.0)
    drained = q.drain_shed()
    assert len(drained) == 3 and q.shed == [] and q.shed_count == 3


def test_request_queue_drop_expired():
    reqs = [ServeRequest(rid=i, prompt=np.zeros(2, np.int32), arrival_time=0.0, slo=slo)
            for i, slo in enumerate([0.5, 2.0, None])]
    q = RequestQueue(reqs)
    assert [r.rid for r in q.drop_expired(1.0)] == [0]
    assert len(q) == 2 and q.shed_count == 1 and q.drop_expired(1.0) == []


def test_server_sheds_what_it_cannot_serve(setup):
    """Admission control in the server: a bounded queue sheds the latest
    arrivals, an expired SLO sheds while queued; shed requests come back as
    "shed" results and count in the metrics."""
    cfg, params, _, _ = setup
    reqs = mk_requests(cfg, lens=[8] * 4, budgets=[3] * 4)
    results, mt = ContinuousBatchingServer(cfg, params, n_slots=1, max_len=16).run(
        RequestQueue(reqs, max_pending=2))
    assert [r.finish_reason for r in results] == ["length", "length", "shed", "shed"]
    assert mt.requests_shed == 2 and mt.requests_finished == 2
    late = mk_requests(cfg, lens=[8] * 2, budgets=[3] * 2)
    late[1].slo = 1e-9  # expires while request 0 is served
    results, mt = ContinuousBatchingServer(cfg, params, n_slots=1, max_len=16).run(
        RequestQueue(late))
    assert [r.finish_reason for r in results] == ["length", "shed"]
    assert mt.requests_expired == 1 and mt.slo_attainment == 0.5


def test_profiling_shim_warns_and_reexports():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import repro_torch.serving.profiling as shim
    with pytest.warns(DeprecationWarning, match="scorers"):
        importlib.reload(shim)
    assert shim.prefill_expert_scores is prefill_expert_scores


# ---------------------------------------------------------------------------
# The bench_serve launcher
# ---------------------------------------------------------------------------


def test_bench_serve_on_cpu_prints_the_summary(capsys):
    results, mt = bench_serve.main([
        "--arch", ARCH, "--device", "cpu", "--dtype", "float32", "--n-requests", "5",
        "--slots", "2", "--prompt-len", "10", "--max-new", "6", "--arrival", "all_at_once",
        "--scheduler", "sjf"])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary == json.loads(json.dumps(mt.summary()))
    assert summary["requests"] == 5 and summary["policy"] == "sjf"
    assert summary["generated_tokens"] == sum(len(r.tokens) for r in results)
    assert summary["throughput_tok_s"] > 0 and 0 < summary["slot_occupancy"] <= 1
    assert all(3 <= len(r.tokens) <= 6 for r in results)


SMOKE = ["--arch", ARCH, "--device", "cpu", "--dtype", "float32", "--slots", "2",
         "--prompt-len", "8", "--max-new", "8"]
WORK = ["--n-requests", "4", "--arrival", "all_at_once"]
OFFLOADED = ["--offloaded", "--capacity", "2"]


@pytest.fixture(scope="module")
def uninterrupted():
    """The launcher's results without an operations flag, continuous and
    offloaded (one run each for every case below)."""
    return {off: bench_serve.main(SMOKE + (OFFLOADED if off else []) + WORK)[0]
            for off in (False, True)}


@pytest.mark.parametrize("flag", [["--cold-restore"], ["--faults", "crash_at=5"],
                                  ["--trace", "tr"], ["--journal", "jr"], ["--resume"],
                                  ["--audit-every", "2"], ["--checkpoint-every", "1"]])
def test_bench_serve_refuses_what_is_not_ported(flag, capsys, tmp_path, uninterrupted):
    """The launcher's operations flags, which it once refused, each work
    at smoke size on the CPU: a flag that needs a journal to recover runs
    after a crashed, journaled run of the same workload (offloaded for
    ``--cold-restore``), and the served tokens equal the uninterrupted
    run's."""
    off = OFFLOADED if flag[0] == "--cold-restore" else []
    work = SMOKE + off + WORK
    ref = uninterrupted[bool(off)]
    jdir = str(tmp_path / "jr")
    if flag[0] in ("--cold-restore", "--resume"):
        # offloaded: the first decode step of the second wave (a checkpoint
        # of the first wave's cache to revive from); continuous: step 3
        crash = sum(len(r.tokens) - 1 for r in ref[:2]) + 1 if off else 3
        assert bench_serve.main(work + ["--journal", jdir, "--checkpoint-every", "1",
                                        "--faults", f"crash_at={crash}"]) is None
        assert "CRASHED (injected)" in capsys.readouterr().out
        argv = SMOKE + off + ["--journal", jdir, "--resume"] + flag[1:]
        if flag[0] == "--cold-restore":
            argv += ["--cold-restore"]
    elif flag[0] == "--faults":
        assert bench_serve.main(work + flag) is None  # no journal: the run is lost
        assert "no journal configured" in capsys.readouterr().out
        return
    elif flag[0] == "--trace":
        argv = work + ["--trace", str(tmp_path / "tr")]
    elif flag[0] == "--journal":
        argv = work + ["--journal", jdir]
    else:  # --audit-every, --checkpoint-every: on a journaled run
        argv = work + ["--journal", jdir] + flag
    res, mt = bench_serve.main(argv)
    out = capsys.readouterr().out
    assert [r.rid for r in res] == [r.rid for r in ref]
    for a, b in zip(ref, res):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    if flag[0] == "--cold-restore":
        assert "cold revival: 0 experts" in out
    if flag[0] == "--trace":
        from repro_torch.obs import validate_chrome_trace

        assert validate_chrome_trace(json.load(open(tmp_path / "tr" / "trace.json"))) == []
        assert (tmp_path / "tr" / "metrics.prom").exists()
    if flag[0] in ("--journal", "--audit-every", "--checkpoint-every"):
        from repro_torch.recovery import recover

        assert sorted(r.rid for r in recover(jdir).results) == [0, 1, 2, 3]


def test_bench_serve_offloaded_little_quality(capsys):
    """``--offloaded --little --quality 0.5`` at smoke size: every request
    dials half its misses to the little tier, so the summary counts
    degraded requests; ``--little`` alone on the continuous path is an
    error."""
    results, mt = bench_serve.main([
        "--arch", ARCH, "--device", "cpu", "--dtype", "float32", "--offloaded",
        "--capacity", "1", "--n-requests", "4", "--slots", "2", "--prompt-len", "10",
        "--max-new", "6", "--arrival", "all_at_once", "--little", "--little-rank", "4",
        "--quality", "0.5"])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary == json.loads(json.dumps(mt.summary()))
    assert summary["degraded_requests"] > 0 and summary["transfers"] > 0
    assert summary["requests"] == len(results) == 4
    with pytest.raises(SystemExit) as e:
        bench_serve.main(["--arch", ARCH, "--device", "cpu", "--little"])
    assert e.value.code == 2 and "--offloaded" in capsys.readouterr().err
