"""SIGTERM drains and the wave-mode fleet of the port on the CPU, with real
processes (``granite-moe-1b-a400m-smoke``, fp32, ``device="cpu"``):
``bench_fleet`` drained once every worker has journaled exits 0 with
every request finished or checkpointed; ``bench_serve`` drained mid-serve
and resumed gives an uninterrupted run's tokens; ``bench_fleet
--offloaded`` gives one wave server's tokens. The weights are the port's
own (a params-only checkpoint of its ``init_params``); the kill and hang
restarts against the JAX server are in ``tests/test_torch_fleet_proc.py``.
Every wait has its own limit (at most 90 s); about 35 s alone on an
8-core CPU."""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import faults, serving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import bench_fleet, bench_serve  # noqa: E402
from repro_torch.launch.serve import load_params  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.recovery import recover  # noqa: E402
from repro_torch.training import save_checkpoint  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = [pytest.mark.torch, pytest.mark.fleet]

ARCH = "granite-moe-1b-a400m-smoke"
SRC = str(Path(__file__).resolve().parents[1] / "src")
WAIT_S = 90.0


@pytest.fixture(autouse=True)
def _no_leaked_plan_one_thread(monkeypatch):
    """No fault plan leaks in or out; torch runs on one thread, here
    (``one_thread``) and in the child processes (they copy this
    environment): at this size that is several times faster than sharing
    every core with the other test workers, and both sides of each
    comparison sum in one order."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    faults.uninstall_fault_plan()
    yield
    faults.uninstall_fault_plan()


def subproc_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("REPRO_FAULTS", None)
    env.pop("REPRO_JOURNAL", None)
    return env


def wait_for(pred, what, proc):
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        if pred():
            return
        if proc.poll() is not None:
            raise AssertionError(f"exited ({proc.returncode}) before {what}")
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_bench_fleet_sigterm_drains_exit_zero(tmp_path):
    """SIGTERM to the launcher once every worker has journaled: each worker
    stops admission, finishes in-flight, checkpoints and exits 0; the
    launcher exits 0 with every request finished or checkpointed."""
    out = tmp_path / "report.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.bench_fleet", "--arch", ARCH,
         "--device", "cpu", "--dtype", "float32", "--workers", "2", "--n-requests", "10",
         "--prompt-len", "8", "--max-new", "10", "--dir", str(tmp_path / "fleet"),
         "--out", str(out)],
        env=subproc_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        def every_worker_journaled():
            logs = [tmp_path / "fleet" / f"worker-{i}" / "journal" / "journal.jsonl"
                    for i in range(2)]
            return all(p.exists() and p.stat().st_size > 0 for p in logs)
        wait_for(every_worker_journaled, "every worker's journal", proc)
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=WAIT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, stdout
    report = json.loads(out.read_text())
    assert report["drained"]
    assert report["unaccounted"] == []
    assert report["finished"] + len(report["pending_checkpointed"]) == report["n_requests"]
    for w in report["workers"]:
        assert w["exit_code"] == 0, (w, stdout)


def test_bench_serve_sigterm_drains_then_resumes(tmp_path):
    """SIGTERM mid-serve: exit 0, the ``DRAINED`` banner, the journal holds
    the rest; ``--resume`` (in this process, as the uninterrupted run)
    finishes it with the uninterrupted run's tokens. The payload's keys are
    held against the reference's in ``tests/test_torch_fleet.py``. The
    SIGTERM goes out at the journal's first event (the arrivals), so the
    serve must outlast the time this process takes to see it and signal:
    48 requests take about 1 s of serving on one CPU thread (8 took about
    0.12 s, and a signal later than that reached the launcher in its
    interpreter teardown, which ends a process with -15)."""
    common = ["--arch", ARCH, "--device", "cpu", "--dtype", "float32", "--n-requests",
              "48", "--slots", "2", "--arrival", "all_at_once", "--prompt-len", "10",
              "--max-new", "10", "--seed", "0"]
    ref_path = tmp_path / "ref.json"
    bench_serve.main(common + ["--out-results", str(ref_path)])
    want = {r["rid"]: r["tokens"] for r in json.loads(ref_path.read_text())["results"]}

    cmd = [sys.executable, "-m", "repro_torch.launch.bench_serve"] + common
    jdir = tmp_path / "journal"
    proc = subprocess.Popen(
        cmd + ["--journal", str(jdir), "--checkpoint-every", "2", "--out-results",
               str(tmp_path / "drained.json")],
        env=subproc_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        wait_for(lambda: '"ev"' in ((jdir / "journal.jsonl").read_text()
                                    if (jdir / "journal.jsonl").exists() else ""),
                 "journal activity", proc)
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=WAIT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, stdout
    assert "DRAINED on SIGTERM" in stdout
    got = {r["rid"]: r["tokens"]
           for r in json.loads((tmp_path / "drained.json").read_text())["results"]}
    state = recover(jdir)
    assert state is not None
    if state.pending:  # SIGTERM landed mid-serve, not after the fact
        bench_serve.main(common + ["--journal", str(jdir), "--resume", "--out-results",
                                   str(tmp_path / "resumed.json")])
        for r in json.loads((tmp_path / "resumed.json").read_text())["results"]:
            got[r["rid"]] = r["tokens"]
    assert got == want


def test_wave_fleet_matches_one_wave_server(tmp_path):
    """``bench_fleet --offloaded --ckpt`` (its launcher in this process):
    the oracle scores computed in the launcher ride in the trace; two wave
    workers give the tokens of one ``OffloadedWaveServer`` over every
    request."""
    cfg = get_config(ARCH)
    ckpt = tmp_path / "port.ckpt"
    save_checkpoint(ckpt, init_params(cfg, generator=torch.Generator().manual_seed(5),
                                      dtype=torch.float32, device="cpu"))
    out = tmp_path / "report.json"
    argv = ["--arch", ARCH, "--device", "cpu", "--dtype", "float32", "--workers", "2",
            "--n-requests", "6", "--prompt-len", "10", "--max-new", "6", "--offloaded",
            "--ckpt", str(ckpt)]
    assert bench_fleet.main(argv + ["--dir", str(tmp_path / "fleet"), "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["finished"] == 6 and report["unaccounted"] == []
    assert [json.loads((tmp_path / "fleet" / f"worker-{i}" / "spec.json").read_text())
            ["mode"] for i in range(2)] == ["wave", "wave"]

    params, _ = load_params(cfg, str(ckpt), dtype=torch.float32, device="cpu")
    requests = bench_fleet.build_workload(bench_fleet._parser().parse_args(argv), cfg)
    serving.prefill_expert_scores(cfg, params, requests)
    srv = serving.OffloadedWaveServer(cfg, params, capacity=cfg.melinoe_cache_capacity(),
                                      wave_size=2, device="cpu")
    res, _ = srv.run(serving.RequestQueue(requests))
    assert {int(rid): r["tokens"] for rid, r in report["results"].items()} == \
        {r.rid: [int(t) for t in r.tokens] for r in res}
