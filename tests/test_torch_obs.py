"""The port's observability stack (``repro_torch.obs``) against the JAX
package's (``repro.obs``) on the CPU: the checks of ``tests/test_obs.py`` on
the port's tracer, registry, exporters and ``validate``, and, on
``olmoe-mini-smoke`` engines of both packages on the same weights:

* ``reconcile`` of a traced run: the modeled columns (serial,
  overlapped, hidden, host time; per MoE layer the transfer counts,
  bytes, modeled fetch and compute seconds) exactly equal, and the
  ``cache.*`` instants (per layer and step: hits, misses, evictions)
  equal in order. The measured seconds are not compared: the JAX engine
  fuses layer l's grouped compute with layer l+1's attention and router
  in one call and charges it to ``moe.compute`` (``fused=True``), while
  the port runs the two as separate calls under ``moe.compute`` and
  ``moe.pre``, and times its overflow copies as ``moe.fetch``; so the
  port's split is finer, and its seconds are its own.
* tracing off: no buffer, and the engine's span fence never
  synchronizes a device;
* the published gauges of the engine, the cache, the wave server and
  the fault plan, after the same faulted serve, equal to the
  reference's (measured wall seconds aside).

About 15 s alone on an 8-core CPU.
"""
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ops import (build, clean_globals, jax_engine, port_engine,  # noqa: E402,F401
                        requests, wave_servers)
from repro import faults as jfaults  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.core.offload_engine import EngineMetrics as JaxEngineMetrics  # noqa: E402
from repro_torch import faults, serving  # noqa: E402
from repro_torch.core.offload_engine import EngineMetrics, HardwareProfile  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.obs import (NULL_TRACER, MetricsRegistry, Tracer, clock_span,  # noqa: E402
                             disable_tracing, enable_tracing, get_tracer, reconcile,
                             validate_chrome_trace)
from repro_torch.obs.reconcile import (COMPUTE_SPANS, FETCH_SPANS, OTHER,  # noqa: E402
                                       OVERHEAD_SPANS, STEP_SPANS)
from repro_torch.obs.validate import main as validate_main  # noqa: E402
from repro_torch.serving.metrics import ServerMetrics  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("clean_globals")]

NEW = 5


@pytest.fixture(scope="module")
def m():
    return build()


# ---------------------------------------------------------------------------
# trace.py
# ---------------------------------------------------------------------------


def test_span_nesting_and_timing():
    tr = Tracer()
    with tr.span("outer", layer=0):
        time.sleep(0.002)
        with tr.span("inner"):
            time.sleep(0.001)
    inner, outer = tr.spans()  # close order
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.depth == 1 and outer.depth == 0
    assert outer.dur >= inner.dur > 0
    assert outer.t0 <= inner.t0 and inner.t1 <= outer.t1 + 1e-9
    assert outer.args == {"layer": 0}


def test_instants_drain_and_buffer_bound():
    tr = Tracer()
    tr.instant("cache.access", layer=1, misses=2)
    with tr.span("s"):
        pass
    s, i = tr.drain()
    assert len(s) == 1 and len(i) == 1 and i[0].args["misses"] == 2
    assert tr.spans() == [] and tr.instants() == []
    small = Tracer(max_records=10)
    for _ in range(25):
        with small.span("x"):
            pass
    assert len(small.spans()) <= 10 and small.dropped > 0


def test_disabled_tracer_is_noop_and_roundtrip():
    assert get_tracer() is NULL_TRACER and NULL_TRACER.enabled is False
    ctx = NULL_TRACER.span("anything", layer=3)
    with ctx:
        pass
    assert NULL_TRACER.span("other") is ctx  # one shared no-op context
    assert NULL_TRACER.spans() == [] and NULL_TRACER.instants() == []
    tr = enable_tracing()
    assert get_tracer() is tr and tr.enabled
    with get_tracer().span("a"):
        pass
    assert len(tr.spans()) == 1
    disable_tracing()
    assert get_tracer() is NULL_TRACER


def test_clock_span_always_times():
    with clock_span("serve.decode_step") as cs:
        time.sleep(0.001)
    assert cs.dur > 0 and get_tracer().spans() == []
    tr = enable_tracing()
    with clock_span("serve.decode_step", active=2) as cs:
        time.sleep(0.001)
    (span,) = tr.spans()
    assert span.name == "serve.decode_step" and span.args == {"active": 2}
    assert abs(span.dur - cs.dur) < 5e-3


def test_chrome_trace_exporters_and_validate_cli(tmp_path, capsys):
    tr = Tracer()
    with tr.span("engine.decode_step", step=0):
        with tr.span("moe.compute", layer=1, experts=np.int64(4)):
            pass
    tr.instant("serve.retire", rid=np.int32(7))
    obj = json.loads(json.dumps(tr.to_chrome_trace(process_name="test")))
    assert validate_chrome_trace(obj) == []
    evs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in evs} == {"engine.decode_step", "moe.compute"}
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in evs)
    p = tmp_path / "trace.json"
    tr.export_chrome_trace(str(p), process_name="t")
    tr.export_jsonl(str(tmp_path / "trace.jsonl"))
    lines = [json.loads(x) for x in open(tmp_path / "trace.jsonl")]
    assert [x["kind"] for x in lines] == ["span", "span", "instant"]
    assert lines[1]["args"] == {"step": 0}
    (tmp_path / "bad.json").write_text('{"traceEvents": []}')
    assert validate_main([str(p)]) == 0
    assert validate_main([str(p), str(tmp_path / "bad.json")]) == 1
    assert validate_main([]) == 2
    out = capsys.readouterr().out
    assert "OK (5 events)" in out and "no span/instant events" in out


def test_validate_rejects_bad_traces():
    assert validate_chrome_trace({"traceEvents": []}) != []
    assert validate_chrome_trace({"nope": 1}) != []
    bad = {"traceEvents": [{"name": "x", "ph": "X", "ts": -1, "pid": 0, "tid": 0,
                            "dur": 1}]}
    assert any("ts" in e for e in validate_chrome_trace(bad))


def test_tracer_thread_safety():
    tr = Tracer()

    def work(n):
        for i in range(50):
            with tr.span("t", n=n, i=i):
                pass

    threads = [threading.Thread(target=work, args=(n,)) for n in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = tr.spans()
    assert len(spans) == 200 and all(s.depth == 0 for s in spans)


def test_torch_annotations_reach_the_profiler():
    """``torch_annotations=True`` opens a ``record_function`` range per
    span, so a span shows up by name in a ``torch.profiler`` capture (on
    the CPU too); without it the capture holds no such range."""
    for on in (True, False):
        tr = Tracer(torch_annotations=on)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tr.span("moe.fetch", layer=0):
                torch.ones(4).sum()
        names = {e.key for e in prof.key_averages()}
        assert ("moe.fetch" in names) is on
        assert [s.name for s in tr.spans()] == ["moe.fetch"]


# ---------------------------------------------------------------------------
# registry.py, against the reference's
# ---------------------------------------------------------------------------


def _fill(reg):
    c = reg.counter("tx_total", "number of transfers", layer=0)
    c.inc()
    c.inc(2)
    assert reg.counter("tx_total", layer=0) is c  # get-or-create
    reg.gauge("depth", policy="fcfs").set(3.5)
    h = reg.histogram("lat_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    reg.histogram("ttft_s").observe(2e-3)


def test_registry_matches_reference():
    reg, jreg = MetricsRegistry(), jobs.MetricsRegistry()
    _fill(reg)
    _fill(jreg)
    snap = reg.snapshot()
    assert snap == jreg.snapshot()
    assert reg.to_prometheus_text() == jreg.to_prometheus_text()
    assert reg.to_json(indent=2) == jreg.to_json(indent=2)
    assert snap['tx_total{layer="0"}'] == 3.0 and snap['lat_s_bucket{le="1.0"}'] == 2.0
    assert snap['lat_s_bucket{le="+Inf"}'] == 3.0 and snap["lat_s_sum"] == pytest.approx(5.55)
    text = reg.to_prometheus_text()
    assert "# HELP tx_total number of transfers" in text and "# TYPE lat_s histogram" in text
    before = reg.snapshot()
    reg.counter("tx_total", layer=0).inc(4)
    reg.gauge("g").set(2.0)
    d = MetricsRegistry.diff(reg.snapshot(), before)
    assert d['tx_total{layer="0"}'] == 4.0 and d["g"] == 2.0
    with pytest.raises(TypeError):
        reg.gauge("tx_total", layer=0)


def test_server_metrics_windows_and_publish_match_reference():
    pair = (ServerMetrics(policy="sjf", window=8), jserving.ServerMetrics(policy="sjf", window=8))
    for mt in pair:
        for i in range(20):
            mt.observe_finish(1.0 + i, ttft=0.1 * (i + 1), itl=0.01)
            mt.observe_queue_depth(i)
        mt.wall_time = 3.0
    s = pair[0].summary()
    assert s == pair[1].summary()
    assert s["requests"] == 20 and len(pair[0].latencies) == 8
    assert s["mean_queue_depth"] == pytest.approx(9.5) and s["itl_p50"] == pytest.approx(0.01)
    reg, jreg = MetricsRegistry(), jobs.MetricsRegistry()
    pair[0].publish(reg)
    pair[1].publish(jreg)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.snapshot()['serve_requests{policy="sjf"}'] == 20.0


def test_engine_metrics_per_layer_spans_and_publish():
    hw = HardwareProfile()
    for em in (EngineMetrics(), JaxEngineMetrics()):
        em.begin_step(2)
        em.add_flops(1e9)
        em.add_demand_transfers(0, 2, 2048)
        em.add_prefetch_transfers(1, 3, 3072)
        assert em.layer_tx == {0: 2} and em.layer_prefetch_tx == {1: 3}
        assert em.overlapped_span(hw, 0, 1) <= em.serial_span(hw, 0, 1) + 1e-12
        em.drop_step_records(hw)
        assert em.layer_tx == {0: 2}
    reg, jreg = MetricsRegistry(), jobs.MetricsRegistry()
    EngineMetrics(transfers=2, fetch_failures=3).publish(reg, impl="slab")
    JaxEngineMetrics(transfers=2, fetch_failures=3).publish(jreg, impl="slab")
    assert reg.snapshot() == jreg.snapshot()
    assert reg.snapshot()['engine_transfers{impl="slab"}'] == 2.0


def test_kernel_dispatch_counts(monkeypatch):
    """The reference counts ``kernel_dispatch_total`` once per selection in
    ``resolve()``; the port publishes its launch counters under the same
    name and labels (op, backend) plus the route, each equal to the
    launches since the last reset, and records a ``kernel.dispatch``
    instant per launch while tracing."""
    monkeypatch.setattr(dispatch, "LAUNCHES", {op: 0 for op in dispatch.OPS})
    monkeypatch.setattr(dispatch, "ROUTE_LAUNCHES", {op: {} for op in dispatch.OPS})
    launches = [("moe_gmm", "tc")] * 3 + [("moe_gmm", "stream")] * 5 + [("flash_attn", "tc")]
    tr = enable_tracing()
    for op, route in launches:
        dispatch.count_launch(op, route)
    disable_tracing()
    for op, route in launches[:2]:  # not traced: counted, no instant
        dispatch.count_launch(op, route)
    inst = [i.args for i in tr.instants() if i.name == "kernel.dispatch"]
    assert inst == [{"op": op, "backend": "hopper", "route": r} for op, r in launches]
    reg = MetricsRegistry()
    dispatch.publish(reg)
    dispatch.publish(reg)  # set, not added
    snap = {k: v for k, v in reg.snapshot().items() if k.startswith("kernel_dispatch_total")}
    assert snap == {'kernel_dispatch_total{backend="hopper",op="moe_gmm",route="tc"}': 5.0,
                    'kernel_dispatch_total{backend="hopper",op="moe_gmm",route="stream"}': 5.0,
                    'kernel_dispatch_total{backend="hopper",op="flash_attn",route="tc"}': 1.0}
    assert sum(snap.values()) == sum(dispatch.LAUNCHES.values())
    assert "# TYPE kernel_dispatch_total counter" in reg.to_prometheus_text()


# ---------------------------------------------------------------------------
# reconcile.py on both engines
# ---------------------------------------------------------------------------


def _cache_instants(tracer):
    return [(i.name, i.args["layer"], i.args["hits"], i.args["misses"], i.args["evictions"])
            for i in tracer.instants() if i.name.startswith("cache.")]


def test_reconcile_matches_reference_engine(m):
    je, te = jax_engine(m), port_engine(m)
    plain = port_engine(m).generate(m.toks, NEW)["tokens"].numpy()
    scores = np.random.default_rng(7).random((m.tcfg.n_moe_layers,
                                              m.tcfg.moe_spec.num_experts))
    jtr, ttr = jobs.enable_tracing(), enable_tracing()
    for e in (je, te):
        e.prefetch(scores)
    jr, tr_ = je.generate(m.toks, NEW), te.generate(m.toks, NEW)
    jobs.disable_tracing()
    disable_tracing()
    # tracing does not perturb the decode
    np.testing.assert_array_equal(tr_["tokens"].numpy(), np.asarray(jr["tokens"]))
    np.testing.assert_array_equal(tr_["tokens"].numpy(), plain)

    spans = ttr.spans()
    names = {s.name for s in spans}
    contract = FETCH_SPANS | COMPUTE_SPANS | OVERHEAD_SPANS | STEP_SPANS
    assert names <= contract  # no block of its own (attn_moe only), no fault, no little
    assert {"engine.prefill", "engine.decode_step", "engine.prefetch", "engine.embed",
            "engine.logits", "moe.pre", "moe.account", "moe.fetch", "moe.prefetch",
            "moe.compute"} <= names
    assert sum(s.name == "engine.decode_step" for s in spans) == NEW - 1
    for nm in ("moe.pre", "moe.account", "moe.fetch", "moe.compute"):
        assert sorted({s.args["layer"] for s in spans if s.name == nm}) == [0, 1]
    assert _cache_instants(ttr) == _cache_instants(jtr)

    trep = reconcile(spans, te.metrics, te.hw, tolerance=0.5)
    jrep = jobs.reconcile(jtr.spans(), je.metrics, je.hw, tolerance=0.5)
    for f in ("hw_name", "modeled_serial_s", "modeled_overlapped_s", "modeled_hidden_s",
              "host_time_s"):
        assert getattr(trep, f) == getattr(jrep, f), f
    rows = lambda rep: [(r.layer, r.transfers, r.transfer_bytes, r.modeled_fetch_s,  # noqa: E731
                         r.modeled_compute_s) for r in rep.layers if r.layer != OTHER]
    assert rows(trep) == rows(jrep)
    assert [r[1] for r in rows(trep)] == [
        te.metrics.layer_tx[i] + te.metrics.layer_prefetch_tx[i] for i in range(2)]
    # the invariants the reconciliation exists to check, on the port's spans
    assert trep.modeled_overlapped_s <= trep.modeled_serial_s + 1e-12
    assert trep.measured_serial_s > 0 and trep.unmodeled_s >= 0.0
    assert trep.ok, trep.format_table()
    assert all(r.measured_compute_s > 0 for r in trep.layers if r.layer != OTHER)
    json.dumps(trep.to_json())
    assert "Eq.3" in trep.format_table()


def test_tracing_off_leaves_no_buffer_and_no_sync(m, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(a))
    eng = port_engine(m)
    eng.generate(m.toks, 3)
    assert get_tracer() is NULL_TRACER
    assert get_tracer().spans() == [] and get_tracer().instants() == []
    # the span fence asks the engine's device and the tracer, nothing else:
    # on a CUDA device it synchronizes only while a tracer is enabled
    eng.device = torch.device("cuda")
    eng._obs_sync()
    assert calls == []
    enable_tracing()
    eng._obs_sync()
    assert len(calls) == 1


def test_published_gauges_equal_reference(m):
    """One faulted wave serve in each package (fetch failures retried,
    spikes, a storm, server stalls): the ``engine_*``, ``cache_*``,
    ``serve_*`` and ``fault_injected_total`` gauges agree, the measured
    wall seconds aside."""
    spec = "fail=0.2,spike=0.2:1e-3,storm=0.3:0.5,step_delay=0.5:2e-3,seed=4"
    budgets = (4, 3, 5, 2)
    jsrv, tsrv = wave_servers(m, wave_size=2)
    snaps = []
    for pkg_f, registry, pkg_s, srv in ((jfaults, jobs.MetricsRegistry, jserving, jsrv),
                                        (faults, MetricsRegistry, serving, tsrv)):
        plan = pkg_f.install_fault_plan(spec)
        res, mt = srv.run(pkg_s.RequestQueue(requests(pkg_s, budgets)))
        reg = registry()
        mt.publish(reg)
        srv.engine.metrics.publish(reg)
        srv.engine.cache.publish(reg)
        plan.publish(reg)
        pkg_f.uninstall_fault_plan()
        snaps.append({k: v for k, v in reg.snapshot().items() if "wall_time" not in k})
    assert snaps[0] == snaps[1]
    snap = snaps[1]
    assert snap['fault_injected_total{kind="fetch_fail"}'] > 0
    assert snap['fault_injected_total{kind="storm"}'] > 0
    assert snap["engine_fetch_failures"] > 0 and snap["engine_fault_delay_s"] > 0
    assert snap['serve_requests{policy="fcfs"}'] == len(budgets)
