"""The port's fleet pieces in one process against the JAX package's:
heartbeat files read across the two packages, the worker-fault schedule
and restart backoff, the supervisor's worker directories and launch
command, the worker's inbox and results file, the CUDA default of the
worker and ``bench_fleet``, ``bench_serve --out-results``, and
``simulate_trace``. The tests that start worker processes are in
``tests/test_torch_fleet_proc.py``. A few seconds in all."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import fleet as jfleet  # noqa: E402
from repro.core import expert_cache as jcache  # noqa: E402
from repro.fleet import supervisor as jsupervisor  # noqa: E402
from repro.fleet import worker as jworker  # noqa: E402
from repro.serving import ServeRequest as JaxRequest  # noqa: E402
from repro.serving.metrics import ServerMetrics as JaxMetrics  # noqa: E402
from repro_torch import fleet  # noqa: E402
from repro_torch.core import expert_cache, simulate_trace  # noqa: E402
from repro_torch.fleet import supervisor, worker  # noqa: E402
from repro_torch.launch import bench_fleet, bench_serve  # noqa: E402
from repro_torch.recovery import RequestJournal, recover  # noqa: E402
from repro_torch.recovery.checkpoint import request_record  # noqa: E402
from repro_torch.serving import RequestQueue, ServeRequest  # noqa: E402
from repro_torch.serving.metrics import ServerMetrics  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

ARCH = "granite-moe-1b-a400m-smoke"


def _requests(pkg_request, n=4, vocab=512):
    rng = np.random.default_rng(0)
    return [pkg_request(rid=i, prompt=rng.integers(0, vocab, 5 + i).astype(np.int32),
                        max_new_tokens=3 + i, arrival_time=0.1 * i)
            for i in range(n)]


# ---------------------------------------------------------------------------
# heartbeat files
# ---------------------------------------------------------------------------


def test_heartbeat_files_are_read_across_the_packages(tmp_path):
    kw = dict(phase="serving", step=5, now=1.25, backlog=2, in_flight=1, finished=3,
              generated=17, metrics={"requests": 3, "throughput_tok_s": 9.5})
    fleet.HeartbeatWriter(tmp_path / "port" / fleet.HEARTBEAT_NAME).beat(**kw)
    jfleet.HeartbeatWriter(tmp_path / "jax" / jfleet.HEARTBEAT_NAME).beat(**kw)
    assert fleet.HEARTBEAT_NAME == jfleet.HEARTBEAT_NAME
    by_jax = jfleet.read_heartbeat(tmp_path / "port" / fleet.HEARTBEAT_NAME)
    by_port = fleet.read_heartbeat(tmp_path / "jax" / jfleet.HEARTBEAT_NAME)
    assert set(by_jax) == set(by_port)
    for hb in (by_jax, by_port):
        hb.pop("ts")
    assert by_jax == by_port


def test_heartbeat_atomic_throttled_and_pid_stamped(tmp_path):
    hb = fleet.HeartbeatWriter(tmp_path / fleet.HEARTBEAT_NAME)
    assert hb.beat(phase="init")
    got = fleet.read_heartbeat(tmp_path / fleet.HEARTBEAT_NAME)
    assert got["seq"] == 1 and got["phase"] == "init"
    assert got["pid"] == os.getpid()  # the incarnation guard
    # throttle: a beat younger than min_interval_s is suppressed...
    assert not hb.beat(phase="serving", step=3, min_interval_s=60.0)
    assert fleet.read_heartbeat(tmp_path / fleet.HEARTBEAT_NAME)["seq"] == 1
    # ...but a phase-change beat (interval 0) always publishes
    assert hb.beat(phase="drained", step=3, finished=2)
    got = fleet.read_heartbeat(tmp_path / fleet.HEARTBEAT_NAME)
    assert got["seq"] == 2 and got["step"] == 3 and got["finished"] == 2
    # atomic replace leaves no tmp litter
    assert sorted(p.name for p in tmp_path.iterdir()) == [fleet.HEARTBEAT_NAME]
    assert fleet.read_heartbeat(tmp_path / "missing.json") is None


# ---------------------------------------------------------------------------
# worker-fault schedule, restart backoff, supervisor defaults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "0:kill_at=6;2:hang_at=4:30,seed=1", None, "", " 1:kill=0.2,seed=5 ; ",
    "0:kill_at=4,seed=0", "0:frobnicate=1", "x:kill_at=1", "0:hang_at=3:120",
])
def test_parse_worker_fault_schedule_matches_the_reference(spec):
    def outcome(fn):
        try:
            return "ok", fn(spec)
        except Exception as e:  # the error is part of what must agree
            return type(e).__name__, str(e)

    assert outcome(fleet.parse_worker_fault_schedule) == \
        outcome(jfleet.parse_worker_fault_schedule)


def test_restart_backoff_and_defaults_match_the_reference():
    for salt in range(4):
        for k in range(7):
            assert supervisor.RESTART_BACKOFF.backoff(k, salt=salt) == \
                jsupervisor.RESTART_BACKOFF.backoff(k, salt=salt)
    assert supervisor.FAILOVER_BUCKETS == jsupervisor.FAILOVER_BUCKETS
    assert fleet.KILL_EXIT_CODE == jfleet.KILL_EXIT_CODE == 13
    port, ref = supervisor.FleetConfig(), jsupervisor.FleetConfig()
    assert {k: v for k, v in vars(port).items() if k not in ("dtype", "device", "ckpt")} \
        == vars(ref)
    assert (port.dtype, port.device, port.ckpt) == (None, "cuda", None)


def test_supervisor_writes_the_reference_worker_dirs_and_launches_the_port(
        tmp_path, monkeypatch):
    """``setup`` writes the reference's spec (plus dtype, device, ckpt)
    and the same trace records; the launch runs ``repro_torch.fleet.worker``
    without the journal and fault variables, with the kernel backend's."""
    kw = dict(n_workers=2, arch=ARCH, slots=2, worker_faults={1: "kill_at=2"})
    sup = fleet.FleetSupervisor(_requests(ServeRequest), fleet.FleetConfig(
        **kw, dtype="float32", device="cpu", ckpt="/w.ckpt"), tmp_path / "port")
    ref = jfleet.FleetSupervisor(_requests(JaxRequest), jfleet.FleetConfig(**kw),
                                 tmp_path / "jax")
    sup.setup()
    ref.setup()
    for i in range(2):
        p, j = (root / f"worker-{i}" for root in (tmp_path / "port", tmp_path / "jax"))
        spec, jspec = (json.loads((d / "spec.json").read_text()) for d in (p, j))
        assert spec.pop("dir") == str(p) and jspec.pop("dir") == str(j)
        assert spec == dict(jspec, dtype="float32", device="cpu", ckpt="/w.ckpt")
        assert json.loads((p / "trace.json").read_text()) == \
            json.loads((j / "trace.json").read_text())
        assert (p / "inbox").is_dir()

    seen = {}

    class FakePopen:
        pid = 4321

        def __init__(self, cmd, env, stdout, stderr):
            seen.update(cmd=cmd, env=env)

    monkeypatch.setattr(supervisor.subprocess, "Popen", FakePopen)
    monkeypatch.setenv("REPRO_JOURNAL", str(tmp_path / "leak"))
    monkeypatch.setenv("REPRO_FAULTS", "crash_at=1")
    monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "hopper")
    sup._launch(sup.workers[1], clean=False)
    sup.workers[1].log_fh.close()
    assert seen["cmd"][1:] == ["-m", "repro_torch.fleet.worker",
                               str(tmp_path / "port" / "worker-1" / "spec.json")]
    env = seen["env"]
    assert "REPRO_JOURNAL" not in env and "REPRO_FAULTS" not in env
    assert env["REPRO_TORCH_KERNEL_BACKEND"] == "hopper"
    assert env["PYTHONPATH"].split(os.pathsep)[0].endswith("src")
    assert sup.events[-1]["event"] == "launch" and sup.events[-1]["clean"] is False


# ---------------------------------------------------------------------------
# worker pieces
# ---------------------------------------------------------------------------


def test_poll_inbox_journals_then_consumes_and_dedupes(tmp_path):
    reqs = _requests(ServeRequest, n=3)
    (tmp_path / "inbox").mkdir()
    (tmp_path / "inbox" / "reassign-0001.json").write_text(
        json.dumps([request_record(r) for r in reqs]))
    jr = RequestJournal(tmp_path / "journal")
    queue, enqueued = RequestQueue([]), {1}  # rid 1 already here
    assert worker.poll_inbox(tmp_path, enqueued, queue, jr) == 2
    jr.close()
    assert not list((tmp_path / "inbox").iterdir())
    assert enqueued == {0, 1, 2} and len(queue) == 2
    st = recover(tmp_path / "journal")
    assert st is not None and st.seen_rids == {0, 2}
    assert sorted(r.rid for r in st.pending) == [0, 2]
    assert worker.poll_inbox(tmp_path / "nowhere", enqueued, queue, jr) == 0


def test_write_results_payload_is_the_reference_s(tmp_path):
    from repro.serving import ServeResult as JaxResult
    from repro_torch.serving import ServeResult

    def payload(mod, result, metrics, name):
        res = {3: result(rid=3, tokens=np.array([5, 6], np.int32), finish_reason="length"),
               1: result(rid=1, tokens=np.array([7], np.int32), finish_reason="stop")}
        mod.write_results(tmp_path / name, res, metrics(), drained=True)
        assert not (tmp_path / (name + ".tmp")).exists()
        got = json.loads((tmp_path / name).read_text())
        assert got.pop("pid") == os.getpid()
        return got

    port = payload(worker, ServeResult, ServerMetrics, "port.json")
    ref = payload(jworker, JaxResult, JaxMetrics, "jax.json")
    assert port.pop("summary").keys() == ref.pop("summary").keys()
    assert port == ref and [r["rid"] for r in port["results"]] == [1, 3]


def test_worker_launch_lines_are_read_back(tmp_path):
    log = tmp_path / "worker.log"
    rep = worker.launch_report(torch.device("cpu"))
    assert rep["launches"].keys() == rep["route_launches"].keys()
    log.write_text("noise\n" + worker.LAUNCH_LINE + json.dumps(rep) + "\nmore\n")
    assert worker.worker_launches(log) == [rep]


def test_worker_and_bench_fleet_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    wdir = tmp_path / "worker-0"
    wdir.mkdir()
    (wdir / "trace.json").write_text(json.dumps(
        [request_record(r) for r in _requests(ServeRequest, n=1)]))
    (wdir / "spec.json").write_text(json.dumps({"dir": str(wdir), "arch": ARCH}))
    with pytest.raises(RuntimeError, match="CUDA"):
        worker.main([str(wdir / "spec.json")])
    # the assignment was journaled before the build failed
    assert [r.rid for r in recover(wdir / "journal").pending] == [0]
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_fleet.main(["--dir", str(tmp_path / "fleet")])
    assert not (tmp_path / "fleet").exists()  # nothing launched


# ---------------------------------------------------------------------------
# bench_serve --out-results
# ---------------------------------------------------------------------------


def test_bench_serve_out_results_payload_is_the_reference_s(tmp_path, capsys):
    out = tmp_path / "res.json"
    results, mt = bench_serve.main([
        "--arch", ARCH, "--device", "cpu", "--dtype", "float32", "--n-requests", "3",
        "--slots", "2", "--prompt-len", "6", "--max-new", "4", "--arrival",
        "all_at_once", "--out-results", str(out)])
    assert f"results: {out}" in capsys.readouterr().out
    got = json.loads(out.read_text())
    assert set(got) == {"results", "summary"}
    assert got["summary"].keys() == JaxMetrics().summary().keys()
    assert got["summary"] == json.loads(json.dumps(mt.summary()))
    assert got["results"] == [{"rid": r.rid, "tokens": [int(t) for t in r.tokens],
                               "finish_reason": r.finish_reason} for r in results]
    assert len(results) == 3


def test_bench_serve_restores_the_sigterm_handler():
    import signal

    before = signal.getsignal(signal.SIGTERM)
    bench_serve.main(["--arch", ARCH, "--device", "cpu", "--dtype", "float32",
                      "--n-requests", "1", "--slots", "1", "--prompt-len", "4",
                      "--max-new", "2"])
    assert signal.getsignal(signal.SIGTERM) is before


# ---------------------------------------------------------------------------
# simulate_trace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["lfu", "gamma", "lru"])
@pytest.mark.parametrize("prefetch", [False, True])
def test_simulate_trace_matches_the_reference(policy, prefetch):
    rng = np.random.default_rng(7)
    T, L, K, E = 40, 3, 4, 12
    routing = rng.integers(0, E, (T, L, K))
    scores = rng.random((L, E)) if prefetch else None
    for C in (2, 5):
        got = simulate_trace(routing, capacity=C, policy=policy, gamma=0.8,
                             prefetch=scores)
        want = jcache.simulate_trace(routing, capacity=C, policy=policy, gamma=0.8,
                                     prefetch=scores)
        assert (got.hits, got.misses, got.evictions) == \
            (want.hits, want.misses, want.evictions)
        assert got.transfers == want.transfers and got.hit_rate == want.hit_rate


def test_prefetch_reduces_misses():
    E, C, K, L, T = 16, 4, 4, 3, 40
    rng = np.random.default_rng(1)
    # routing concentrated on experts 0..5
    routing = rng.choice(6, (T, L, K))
    cold = simulate_trace(routing, capacity=C, policy="lfu")
    scores = np.zeros((L, E))
    scores[:, :6] = 1.0  # oracle prefetch
    warm = simulate_trace(routing, capacity=C, policy="lfu", prefetch=scores)
    assert warm.transfers <= cold.transfers
    assert expert_cache.simulate_trace is simulate_trace


def test_transfers_monotone_in_capacity():
    rng = np.random.default_rng(2)
    routing = rng.choice(16, (50, 4, 4))
    prev = None
    for C in (2, 4, 8, 16):
        st_ = simulate_trace(routing, capacity=C, policy="lfu")
        if prev is not None:
            assert st_.transfers <= prev
        prev = st_.transfers
    assert prev == 16 * 4  # full cache: each (layer, expert) transfers once

