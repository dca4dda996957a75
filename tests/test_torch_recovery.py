"""The port's crash-safe serving (``repro_torch.recovery``) against the JAX
package's on the CPU (``olmoe-mini-smoke``, fp32, greedy; the engines at
C = 2, gamma).

* Records: arrays through msgpack and JSON, the request record's folded
  watermark, both equal to the reference's records.
* Server checkpoints: for the same content, the port's bytes equal the
  reference's (the reference writes ``msgpack.packb(use_bin_type=True)``,
  the port its own ``msgpack_lite``), and each package loads the other's.
* The journal: replay, rotation with a torn tail, a crash inside the
  rotation, watermarks that already complete a request, an empty dir.
* Crash and restore through both servers, within a package and across
  the two: ``tests/test_torch_recovery_serve.py``.
* Warm and cold revival of one cache snapshot: loaded experts, bytes,
  modeled seconds and the demand transfers after it equal the JAX
  engine's; warm pays fewer demand transfers than cold.
* The watchdog: a green run publishes zeros, a conservation break raises,
  injected drift is healed by ``resync_slabs``, corrupted slab books are
  reported; ``audit()`` is clean after serving (fp and INT4 engines, the
  wave server).

About 15 s alone on an 8-core CPU.
"""
import json

import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ops import (build, clean_globals, jax_engine, port_engine,  # noqa: E402,F401
                        requests)
from repro import recovery as jrecovery  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.core.expert_cache import LayerExpertCache as JaxLayerCache  # noqa: E402
from repro.recovery.checkpoint import request_record as jax_request_record  # noqa: E402
from repro_torch import recovery, serving  # noqa: E402
from repro_torch.core.expert_cache import LayerExpertCache  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.recovery import (AuditError, RequestJournal, Watchdog,  # noqa: E402
                                  array_record, atomic_write_bytes,
                                  load_server_checkpoint, recover,
                                  save_server_checkpoint)
from repro_torch.recovery import msgpack_lite  # noqa: E402
from repro_torch.recovery.checkpoint import (record_array, record_request,  # noqa: E402
                                             request_record)
from repro_torch.serving import ServerMetrics  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("clean_globals")]

BUDGETS = (5, 4, 6, 3)


@pytest.fixture(scope="module")
def m():
    return build()


# ---------------------------------------------------------------------------
# records and checkpoints
# ---------------------------------------------------------------------------


def test_array_record_roundtrip_binary_and_b64():
    for arr in (np.arange(6, dtype=np.int32).reshape(2, 3), np.float64(3.5),
                np.zeros(0, np.int64),
                np.random.default_rng(0).normal(size=(3, 2)).astype(np.float32)):
        for binary in (True, False):
            rec = array_record(arr, binary=binary)
            assert rec == jrecovery.array_record(arr, binary=binary)
            rec = (msgpack_lite.unpackb(msgpack_lite.packb(rec)) if binary
                   else json.loads(json.dumps(rec)))
            out = record_array(rec)
            assert isinstance(out, np.ndarray) and out.dtype == np.asarray(arr).dtype
            assert out.shape == np.asarray(arr).shape
            np.testing.assert_array_equal(out, np.asarray(arr))
    assert record_array(None) is None


def test_atomic_write_replaces_and_leaves_no_tmp(tmp_path):
    p = tmp_path / "x.bin"
    atomic_write_bytes(p, b"first")
    atomic_write_bytes(p, b"second")
    assert p.read_bytes() == b"second" and list(tmp_path.iterdir()) == [p]


def _request(pkg):
    return pkg.ServeRequest(rid=7, prompt=np.arange(4, dtype=np.int32), max_new_tokens=10,
                            stop_tokens=(3,), arrival_time=1.5, slo=2.0, quality=0.5,
                            expert_scores=np.ones((2, 4), np.float32),
                            resumed=np.asarray([5, 6], np.int32))


def test_request_record_folds_resumed_watermark():
    req = _request(serving)
    rec = request_record(req, binary=False, emitted=[9])
    assert rec == jax_request_record(_request(jserving), binary=False, emitted=[9])
    assert rec["emitted"] == [5, 6, 9]  # absolute: resumed prefix + this incarnation
    back = record_request(json.loads(json.dumps(rec)))
    np.testing.assert_array_equal(back.prompt, req.prompt)
    np.testing.assert_array_equal(back.resumed, [5, 6, 9])
    assert back.n_resumed == 3 and back.slo == 2.0 and back.quality == 0.5
    np.testing.assert_array_equal(back.expert_scores, req.expert_scores)


def _checkpoint_content(pkg, cache_cls):
    cache = cache_cls(8, 3, "gamma", layer_id=0)
    cache.access_batch(np.asarray([[1, 2], [5, 2], [7, 1]]))
    mt = pkg.ServerMetrics(policy="sjf")
    mt.observe_finish(0.5, ttft=0.1, itl=0.02)
    mt.observe_step(2, 4, 3)
    mt.generated_tokens, mt.wall_time = 42, 1.75
    reqs = requests(pkg, (6, 7))
    res = pkg.ServeResult(rid=3, tokens=np.asarray([4, 5], np.int32), finish_reason="stop",
                          arrival_time=0.0, start_time=0.1, finish_time=0.4,
                          decode_steps=1, degraded=True)
    return dict(kind="wave", step=3, now=1.25, seed=9, policy="sjf", pending=[reqs[0]],
                inflight=[(reqs[1], [11, 12])], results=[res], metrics=mt,
                engine={"cache": [cache.state()],
                        "metrics": {"transfers": 5, "fault_delay_s": 2.5e-4,
                                    "layer_tx": {"0": 5}}})


def test_server_checkpoint_bytes_equal_reference_and_cross_load(tmp_path):
    ours, theirs = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    save_server_checkpoint(ours, **_checkpoint_content(serving, LayerExpertCache))
    jrecovery.save_server_checkpoint(theirs, **_checkpoint_content(jserving, JaxLayerCache))
    assert ours.read_bytes() == theirs.read_bytes()
    assert msgpack.unpackb(ours.read_bytes(), raw=False) == \
        msgpack_lite.unpackb(theirs.read_bytes())
    for ck in (load_server_checkpoint(theirs), jrecovery.load_server_checkpoint(ours)):
        assert (ck["kind"], ck["step"], ck["seed"]) == ("wave", 3, 9)
        assert ck["inflight"][0]["emitted"] == [11, 12] and ck["results"][0]["degraded"]
        layer = ck["engine"]["cache"][0]
        assert layer["resident"] == [1, 2, 7] and isinstance(layer["counts"], np.ndarray)
    ck = load_server_checkpoint(ours)
    mt = ServerMetrics.from_state(ck["metrics"])
    assert mt.generated_tokens == 42 and mt.requests_finished == 1 and list(mt.ttfts) == [0.1]
    cache = LayerExpertCache(8, 3, "gamma")
    cache.load_state(ck["engine"]["cache"][0])
    assert cache.resident == {1, 2, 7} and cache.misses == 4 and cache.audit() == []
    cache.load_state(ck["engine"]["cache"][0], resident=False)  # cold: scores only
    assert cache.resident == set() and cache.audit() == []


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------


def _journal_run(path, pkg, jmod):
    reqs = requests(pkg, (3, 8, 5))
    jr = jmod.RequestJournal(path)
    for r in reqs:
        jr.arrival(r)
        jr.arrival(r)  # idempotent per rid
    jr.admit(0, 0.1)
    jr.watermark({0: [7]}, 0.1)
    jr.watermark({0: [8], 1: [9]}, 0.2)
    jr.retire(pkg.ServeResult(rid=0, tokens=np.asarray([7, 8, 3], np.int32),
                              finish_reason="length", arrival_time=0.0, start_time=0.1,
                              finish_time=0.3), plen=8, attained=True, ttft=0.1, itl=0.05)
    jr.shed(reqs[2], expired=True, now=0.3)
    return reqs, jr


def test_journal_replay_matches_reference(tmp_path):
    _, jr = _journal_run(tmp_path / "port", serving, recovery)
    jr.close()
    _, jjr = _journal_run(tmp_path / "jax", jserving, jrecovery)
    jjr.close()
    assert (tmp_path / "port" / "journal.jsonl").read_bytes() == \
        (tmp_path / "jax" / "journal.jsonl").read_bytes()
    st = recover(tmp_path / "port")
    assert {r.rid for r in st.results} == {0, 2} and [r.rid for r in st.pending] == [1]
    np.testing.assert_array_equal(st.pending[0].resumed, [9])
    mt = st.metrics
    assert (mt.requests_finished, mt.requests_expired, mt.generated_tokens,
            mt.slo_attained) == (1, 1, 3, 1)
    assert st.seen_rids == {0, 1, 2} and st.offered_base == 2
    assert st.now == pytest.approx(0.3)
    jst = jrecovery.recover(tmp_path / "port")  # the reference reads the port's journal
    assert jst.metrics.to_state() == mt.to_state() and jst.seen_rids == st.seen_rids
    q = st.build_queue(None)
    assert len(q) == 1 and q.audit() == []


def test_journal_rotation_and_torn_tail(tmp_path):
    reqs, jr = _journal_run(tmp_path, serving, recovery)
    mt = ServerMetrics()
    mt.requests_finished, mt.requests_expired = 1, 1
    mt.generated_tokens, mt.slo_attained = 3, 1
    ck = jr.checkpoint_path(5)
    save_server_checkpoint(ck, kind="continuous", step=5, now=0.3, seed=0, policy="fcfs",
                           pending=[], inflight=[(reqs[1], [9])], results=[], metrics=mt)
    jr.rotate(ck, 5, 0.3)
    jr.watermark({1: [13]}, 0.4)  # lands in the fresh segment
    jr.close()
    assert (tmp_path / "journal-0000.jsonl").exists()
    with open(tmp_path / "journal.jsonl", "a") as f:  # a crash tears the last line
        f.write('{"ev": "wm", "toks": {"1": [99')
    for st in (recover(tmp_path), jrecovery.recover(tmp_path)):
        assert [r.rid for r in st.pending] == [1] and st.step == 5
        np.testing.assert_array_equal(st.pending[0].resumed, [9, 13])
        assert st.metrics.generated_tokens == 4
    # crash mid-rotation: the active segment renamed, none reopened
    (tmp_path / "journal.jsonl").rename(tmp_path / "journal-0001.jsonl")
    assert [r.rid for r in recover(tmp_path).pending] == [1]


def test_recover_completes_watermarked_request_and_empty_dirs(tmp_path):
    reqs = requests(serving, (2, 6))
    reqs[1].stop_tokens = (42,)
    jr = RequestJournal(tmp_path / "j")
    for r in reqs:
        jr.arrival(r)
    jr.watermark({0: [7, 8], 1: [5, 42, 6]}, 0.2)  # 0: its budget, 1: a stop token
    jr.close()
    st = recover(tmp_path / "j")
    assert st.pending == [] and st.metrics.requests_finished == 2
    by = {r.rid: r for r in st.results}
    assert by[0].finish_reason == "length" and by[1].finish_reason == "stop"
    np.testing.assert_array_equal(by[1].tokens, [5, 42])
    assert recover(tmp_path / "nothing") is None
    (tmp_path / "empty").mkdir()
    assert recover(tmp_path / "empty") is None


# ---------------------------------------------------------------------------
# warm / cold revival
# ---------------------------------------------------------------------------


def test_revival_counts_equal_reference(m):
    warmup = jax_engine(m)
    warmup.generate(m.toks, 6)
    snap = warmup.cache_state()
    toks = np.random.default_rng(11).integers(0, m.jcfg.vocab, (2, 10)).astype(np.int32)
    demand = {}
    for warm in (True, False):
        je, te = jax_engine(m), port_engine(m)
        jrev, trev = je.revive(snap, warm=warm), te.revive(snap, warm=warm)
        assert trev == jrev and (trev["loaded"] > 0) == warm
        assert te.metrics.prefetch_transfers == je.metrics.prefetch_transfers
        jr, tr = je.generate(toks, 6), te.generate(toks, 6)
        np.testing.assert_array_equal(tr["tokens"].numpy(), np.asarray(jr["tokens"]))
        assert tr["metrics"].transfers == jr["metrics"].transfers
        assert tr["modeled_time_s"] == jr["modeled_time_s"]
        assert te.audit() == [] and je.audit() == []
        demand[warm] = tr["metrics"].transfers
    assert demand[True] < demand[False]


# ---------------------------------------------------------------------------
# the watchdog and audit()
# ---------------------------------------------------------------------------


def test_watchdog_green_run_and_conservation():
    reg = MetricsRegistry()
    q = serving.RequestQueue(requests(serving, (3, 3)))
    mt = ServerMetrics()
    wd = Watchdog(queue=q, metrics=mt, registry=reg)
    assert wd.check(in_flight=0) == []
    snap = reg.snapshot()
    viol = {k: v for k, v in snap.items() if k.startswith("audit_violations_total")}
    assert len(viol) == 5 and all(v == 0 for v in viol.values())
    assert snap["audit_runs_total"] == 1
    mt.requests_finished += 1  # a finish the queue never admitted
    with pytest.raises(AuditError, match="conservation"):
        wd.check(in_flight=0)
    soft = Watchdog(queue=q, metrics=mt, registry=reg, strict=False)
    assert len(soft.check(in_flight=0)) == 1
    assert reg.snapshot()['audit_violations_total{component="conservation"}'] == 2


class _Drifting:
    """An engine whose books drift until ``resync_slabs`` heals them."""

    def __init__(self):
        self.drift = True

    def audit(self):
        return [("drift", "physical residents outside the cache budget")] if self.drift else []

    def resync_slabs(self):
        self.drift = False
        return 3


def test_watchdog_heals_drift_and_reports_corruption(m):
    reg = MetricsRegistry()
    eng = _Drifting()
    wd = Watchdog(engine=eng, registry=reg)
    assert wd.check() == [] and wd.healed_total == 3 and not eng.drift
    # the slab engine: a slot the cache never granted is dropped and healed
    # by resync_slabs, as in the reference
    je, te = jax_engine(m), port_engine(m)
    je.generate(m.toks, 4)
    te.generate(m.toks, 4)
    healed = []
    for e in (je, te):
        victim = min(e.cache.layers[0].resident)
        e._slabs[0].drop(victim)  # physically lost, still cached
        healed.append(e.resync_slabs())
        assert victim in e._slabs[0].residents and e.audit() == []
    assert healed[0] == healed[1] >= 1
    # corrupted books are hard violations: the watchdog raises
    te._slabs[1].free.append(te._slabs[1].free[0] if te._slabs[1].free else 0)
    assert any(sev == "hard" for sev, _ in te.audit())
    with pytest.raises(AuditError, match="engine"):
        Watchdog(engine=te, registry=reg).check()


def test_audit_clean_after_serving(m):
    for kw in ({}, {"quantized": True}):
        eng = port_engine(m, **kw)
        eng.generate(m.toks, 5)
        assert eng.audit() == []
        assert eng.resync_slabs() >= 0 and eng.audit() == []
    srv = serving.OffloadedWaveServer(m.tcfg, m.tparams, capacity=2, wave_size=2,
                                      device="cpu")
    res, mt = srv.run(serving.RequestQueue(requests(serving, BUDGETS)), audit_every=1)
    assert len(res) == 4 and srv.engine.audit() == []
