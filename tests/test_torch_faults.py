"""The port's fault injection (``repro_torch.faults``) and the engine's and
servers' fault seams against the JAX package's on the CPU.

* ``parse_fault_spec``: the same ``FaultConfig`` for every key of the
  grammar; unknown keys and surplus values raise in both.
* ``FaultPlan``: the same draws, in the same call order, from
  ``np.random.default_rng(seed)``: fetch failures, spikes, storms and
  their victims, server stalls, crash, kill and hang points, burst
  compression, and the same counters.
* ``FetchPolicy``: backoff (with and without seeded jitter) and the retry
  budget equal to the reference's.
* The engine (``olmoe-mini-smoke``, C = 2, gamma, fp32) under fetch
  failures and spikes with the naive policy (no little bank: retried until
  success, tokens unchanged), with a little bank carried across (failed
  fetches degrade), under total failure, under eviction storms and with a
  faulted prefetch: tokens, transfers, hits, misses, evictions,
  ``fetch_failures``, ``fetch_retries``, ``fault_delay_s``,
  ``degraded_uses``, both Eq.-3 clocks and the plan's counters exactly
  equal; ``audit()`` clean after each.
* The wave server under chaos (failures, spikes, storms, stalls, an SLO
  and a backlog bound, a little bank): per-request tokens, finish
  reasons, degraded flags, every counter and the modeled latencies equal.

About 25 s alone on an 8-core CPU.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ops import (assert_same_results, build, clean_globals, jax_engine,  # noqa: E402,F401
                        port_engine, requests, wave_servers)
from repro import faults as jfaults  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro_torch import faults, serving  # noqa: E402
from repro_torch.faults import (NAIVE_POLICY, NULL_FAULT_PLAN, FaultConfig,  # noqa: E402
                                FaultPlan, FetchPolicy, InjectedCrash, get_fault_plan,
                                install_fault_plan, parse_fault_spec,
                                uninstall_fault_plan)
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("clean_globals")]

NEW = 4


@pytest.fixture(scope="module")
def m():
    return build()


# ---------------------------------------------------------------------------
# spec grammar, draws, policy
# ---------------------------------------------------------------------------

SPECS = ["fail=0.1,spike=0.05:2e-3,storm=0.02:0.5,step_delay=0.01:1e-3,burst=0.9,seed=7",
         "crash_at=3,seed=1", "crash=0.2,kill=0.1,kill_at=4,hang=0.5:2,hang_at=2:3",
         "burst=0.5:4", " fail=1.0 , ", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fault_spec_matches_reference(spec):
    cfg = parse_fault_spec(spec)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jfaults.parse_fault_spec(spec))
    assert cfg.any_active == bool(spec.strip(" ,"))


def test_parse_fault_spec_grammar():
    cfg = parse_fault_spec(SPECS[0])
    assert cfg.fetch_fail_rate == 0.1 and (cfg.spike_rate, cfg.spike_s) == (0.05, 2e-3)
    assert (cfg.storm_rate, cfg.storm_frac) == (0.02, 0.5)
    assert (cfg.step_delay_rate, cfg.step_delay_s) == (0.01, 1e-3)
    assert cfg.burst_compress == 0.9 and cfg.seed == 7
    assert isinstance(parse_fault_spec("burst=0.5:4").burst_window, int)
    for bad in ("no_such_knob=1", "fail=0.1:2"):
        with pytest.raises(ValueError):
            parse_fault_spec(bad)
        with pytest.raises(ValueError):
            jfaults.parse_fault_spec(bad)


def _script(plan, pkg):
    """One fixed sequence of every draw a plan offers."""
    out = []
    for i in range(40):
        out.append(("fail", plan.fetch_fails(i % 3)))
        out.append(("spike", plan.transfer_spike(i % 3)))
        if i % 4 == 0:
            frac = plan.eviction_storm()
            out.append(("storm", frac, plan.storm_victims({5, 1, 9, 3, 7}, frac or 0.4)))
        out.append(("delay", plan.step_delay()))
        try:
            plan.maybe_crash("x")
            out.append(("crash", False))
        except pkg.InjectedCrash:
            out.append(("crash", True))
        out.append(("kill", plan.maybe_kill()))
        out.append(("hang", plan.maybe_hang()))
    reqs = [SimpleNamespace(arrival_time=0.3 * i, rid=i) for i in range(9)]
    plan.compress_arrivals(reqs)
    out.append(("burst", [r.arrival_time for r in reqs]))
    return out, dict(plan.counters)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_plan_draws_match_reference(seed):
    spec = (f"fail=0.3,spike=0.25:1e-3,storm=0.5:0.4,step_delay=0.3:2e-3,burst=0.5:4,"
            f"crash=0.1,kill=0.05,hang=0.05:1,seed={seed}")
    ours = _script(FaultPlan(parse_fault_spec(spec)), faults)
    theirs = _script(jfaults.FaultPlan(jfaults.parse_fault_spec(spec)), jfaults)
    assert ours == theirs
    assert all(n > 0 for k, n in ours[1].items() if k in ("fetch_fail", "spike", "storm"))
    other = _script(FaultPlan(parse_fault_spec(spec.replace(f"seed={seed}",
                                                            f"seed={seed + 1}"))), faults)
    assert other[0] != ours[0]


def test_crash_at_and_rate_points():
    plan = FaultPlan(parse_fault_spec("crash_at=3,seed=1"))
    plan.maybe_crash()
    plan.maybe_crash()
    with pytest.raises(InjectedCrash, match=r"point 3 \(here\)"):
        plan.maybe_crash("here")
    assert plan.counters["crash"] == 1
    assert not FaultPlan(FaultConfig(kill_at=2)).maybe_kill()  # the first call


def test_install_env_and_null_plan(monkeypatch):
    assert get_fault_plan() is NULL_FAULT_PLAN and not get_fault_plan().enabled
    plan = install_fault_plan("fail=0.5,seed=1")
    assert get_fault_plan() is plan and plan.enabled
    assert get_fault_plan() is not jfaults.get_fault_plan()  # each package its own
    uninstall_fault_plan()
    assert get_fault_plan() is NULL_FAULT_PLAN
    monkeypatch.setenv("REPRO_FAULTS", "spike=1.0:1e-3,seed=2")
    env_plan = faults.fault_plan_from_env()
    assert get_fault_plan() is env_plan
    assert env_plan.transfer_spike() == pytest.approx(1e-3)
    p = NULL_FAULT_PLAN
    assert not p.fetch_fails() and p.transfer_spike() == 0.0 and p.step_delay() == 0.0
    assert p.eviction_storm() == 0.0 and p.storm_victims([1, 2, 3], 0.5) == []
    reqs = [serving.ServeRequest(rid=0, prompt=np.zeros(2, np.int32), arrival_time=1.0)]
    p.compress_arrivals(reqs)
    assert reqs[0].arrival_time == 1.0


def test_burst_compression_preserves_order():
    plan = FaultPlan(FaultConfig(burst_compress=0.5, burst_window=4))
    reqs = [serving.ServeRequest(rid=i, prompt=np.zeros(2, np.int32),
                                 arrival_time=float(i)) for i in range(8)]
    plan.compress_arrivals(reqs)
    times = [r.arrival_time for r in reqs]
    assert times == sorted(times)
    assert times[3] == pytest.approx(1.5) and times[7] == pytest.approx(5.5)


def test_fetch_policy_matches_reference():
    kws = [dict(), dict(max_retries=2, backoff_base_s=1e-4, backoff_mult=2.0,
                        backoff_cap_s=3e-4),
           dict(backoff_base_s=0.1, backoff_cap_s=1.0, jitter_frac=0.5, seed=3),
           dict(fetch_deadline_s=1e-3, max_retries=-1)]
    for kw in kws:
        ours, theirs = FetchPolicy(**kw), jfaults.FetchPolicy(**kw)
        for attempt in range(12):
            for salt in range(3):
                assert ours.backoff(attempt, salt) == theirs.backoff(attempt, salt)
            for spent in (0.0, 5e-4, 2e-3):
                assert ours.attempts_allowed(attempt, spent) == \
                    theirs.attempts_allowed(attempt, spent)
    assert dataclasses.asdict(NAIVE_POLICY) == dataclasses.asdict(jfaults.NAIVE_POLICY)
    assert NAIVE_POLICY.attempts_allowed(999, 1e9)
    assert not NAIVE_POLICY.attempts_allowed(NAIVE_POLICY.hard_cap, 0.0)
    jit = FetchPolicy(**kws[2])
    assert 0.05 < jit.backoff(0, salt=1) <= 0.1
    assert len({jit.backoff(3, salt=s) for s in range(8)}) > 1


# ---------------------------------------------------------------------------
# the engine's fault seams
# ---------------------------------------------------------------------------

_METRICS = ("transfers", "transfer_bytes", "prefetch_transfers", "prefetch_bytes",
            "fetch_failures", "fetch_retries", "fault_delay_s", "degraded_uses",
            "decode_tokens", "compute_flops")

# id -> (spec, engine options, little bank, prefetch first)
CASES = {
    "naive-retry": ("fail=0.3,spike=0.2:1e-3,seed=5", dict(fetch_policy=NAIVE_POLICY),
                    False, False),
    "little-degrade": ("fail=0.6,spike=0.1:2e-3,seed=5", {}, True, False),
    "total-failure": ("fail=1.0,seed=0", {}, True, False),
    "storm": ("storm=0.5:0.5,seed=2", dict(fetch_policy=NAIVE_POLICY), False, False),
    "prefetch": ("fail=0.7,spike=0.3:1e-3,storm=0.3:1.0,seed=9",
                 dict(fetch_policy=FetchPolicy(max_retries=1)), True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_reference_under_faults(m, case):
    spec, kw, little, prefetch = CASES[case]
    jkw = dict(kw)
    if "fetch_policy" in kw:  # the same policy, in the reference's type
        jkw["fetch_policy"] = jfaults.FetchPolicy(**dataclasses.asdict(kw["fetch_policy"]))
    je = jax_engine(m, little_experts=little, **jkw)
    te = port_engine(m, je, **kw)
    base = port_engine(m).generate(m.toks, NEW)
    scores = np.random.default_rng(1).random((m.tcfg.n_moe_layers,
                                              m.tcfg.moe_spec.num_experts))
    runs = []
    for pkg, eng in ((jfaults, je), (faults, te)):
        plan = pkg.install_fault_plan(spec)
        if prefetch:
            eng.prefetch(scores)
        res = eng.generate(m.toks, NEW)
        pkg.uninstall_fault_plan()
        runs.append((res, dict(plan.counters)))
    (jr, jc), (tr, tc) = runs
    np.testing.assert_array_equal(tr["tokens"].numpy(), np.asarray(jr["tokens"]))
    assert tc == jc
    for f in _METRICS:
        assert getattr(tr["metrics"], f) == getattr(jr["metrics"], f), f
    js, ts = jr["cache_stats"], tr["cache_stats"]
    assert (ts.hits, ts.misses, ts.evictions) == (js.hits, js.misses, js.evictions)
    assert tr["modeled_time_s"] == jr["modeled_time_s"]
    assert tr["modeled_time_overlapped_s"] == jr["modeled_time_overlapped_s"]
    assert te.audit() == [] and je.audit() == []
    tm, bm = tr["metrics"], base["metrics"]
    if case == "naive-retry":  # retried until success: the exact decode
        np.testing.assert_array_equal(tr["tokens"].numpy(), base["tokens"].numpy())
        assert tm.transfers == bm.transfers and tm.degraded_uses == 0
        assert tm.fetch_failures > 0 and tm.fetch_retries == tm.fetch_failures
        assert tr["modeled_time_s"] > base["modeled_time_s"]
    if case == "little-degrade":
        assert tm.degraded_uses > 0 and tm.transfers < bm.transfers
    if case == "total-failure":
        assert tm.transfers == 0 and tm.degraded_uses > 0 and tm.fault_delay_s > 0
    if case == "storm":  # still exact, but evicted experts are fetched again
        np.testing.assert_array_equal(tr["tokens"].numpy(), base["tokens"].numpy())
        assert tm.transfers > bm.transfers and tc["storm"] > 0
    if case == "prefetch":
        assert tm.prefetch_transfers < m.tcfg.n_moe_layers * 2  # some prefetch abandoned
    assert tm.modeled_time_overlapped(te.hw) <= tm.modeled_time(te.hw) + 1e-12


def test_faults_off_is_the_plain_engine(m):
    """With no plan installed and quality 1.0 the resilience hooks are
    skipped: a little-bank engine decodes the plain engine's tokens with
    the same transfers and no fault delay."""
    plain = port_engine(m).generate(m.toks, NEW)
    little = port_engine(m, jax_engine(m, little_experts=True)).generate(m.toks, NEW)
    np.testing.assert_array_equal(plain["tokens"].numpy(), little["tokens"].numpy())
    assert plain["metrics"].transfers == little["metrics"].transfers
    assert little["metrics"].degraded_uses == 0 and little["metrics"].fault_delay_s == 0.0


# ---------------------------------------------------------------------------
# the servers
# ---------------------------------------------------------------------------


def test_wave_server_chaos_matches_reference(m):
    spec = "fail=0.2,spike=0.1:2e-3,storm=0.2:0.5,step_delay=0.5:1e-3,seed=11"
    budgets = (3, 2, 3, 2, 3)
    arrivals = [0.0, 0.0, 1e-4, 2e-4, 2e-4]
    jsrv, tsrv = wave_servers(m, little=True, wave_size=2, max_backlog=3)
    out = []
    for pkg_f, pkg_s, srv in ((jfaults, jserving, jsrv), (faults, serving, tsrv)):
        plan = pkg_f.install_fault_plan(spec)
        res, mt = srv.run(pkg_s.RequestQueue(requests(pkg_s, budgets, slo=0.05,
                                                      arrivals=arrivals)))
        pkg_f.uninstall_fault_plan()
        out.append((res, mt, dict(plan.counters), srv.engine.metrics))
    (jres, jmt, jc, jem), (tres, tmt, tc, tem) = out
    assert_same_results(jres, tres)
    assert tc == jc and tc["step_delay"] > 0 and tc["fetch_fail"] > 0
    for f in ("transfers", "prefetch_transfers", "cache_hits", "cache_misses",
              "generated_tokens", "requests_finished", "requests_shed", "requests_expired",
              "deadline_retired", "slo_attained", "degraded_requests", "modeled_time",
              "modeled_time_serial", "modeled_time_overlapped"):
        assert getattr(tmt, f) == getattr(jmt, f), f
    assert list(tmt.latencies) == list(jmt.latencies)
    for f in ("fetch_failures", "fetch_retries", "fault_delay_s", "degraded_uses"):
        assert getattr(tem, f) == getattr(jem, f), f
    assert len(tres) == len(budgets) and tmt.requests_offered == len(budgets)
    assert tsrv.engine.audit() == []


def test_continuous_server_crash_point_and_stalls(m):
    """The continuous server's crash point raises between decode steps,
    and each injected stall lands on its virtual clock."""
    srv = serving.ContinuousBatchingServer(m.tcfg, m.tparams, n_slots=2, max_len=24)
    reqs = lambda: requests(serving, (5, 5))  # noqa: E731
    _, base = srv.run(serving.RequestQueue(reqs()))
    install_fault_plan("crash_at=2,seed=0")
    with pytest.raises(InjectedCrash, match="serve.decode"):
        srv.run(serving.RequestQueue(reqs()))
    plan = install_fault_plan("step_delay=1.0:0.25,seed=0")
    res, mt = srv.run(serving.RequestQueue(reqs()))
    assert plan.counters["step_delay"] == mt.decode_steps == base.decode_steps == 4
    # both arrive at 0 and finish together: the clock is the measured spans
    # plus the four stalls
    spans = sum(srv.span_s["serve.prefill"]) + sum(srv.span_s["serve.decode_step"])
    assert list(mt.latencies) == [pytest.approx(spans + 4 * 0.25, rel=1e-9)] * 2
