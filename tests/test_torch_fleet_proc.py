"""The port's fleet with real worker processes on the CPU, against the JAX
package (``granite-moe-1b-a400m-smoke``, fp32, greedy, ``device="cpu"``).

The weights are the JAX ``init_params(jax.random.key(0))``, saved with
the JAX ``save_checkpoint`` and handed to the port's workers as ``ckpt``,
so the fleet's tokens are held against the JAX ``ContinuousBatchingServer``
itself. A killed worker restarts from its journal (and the JAX ``collect``
reads the port's journals to the same report); a hung one is booked as
``hang``. The drains and the wave-mode fleet are in
``tests/test_torch_fleet_drain.py`` (a file of its own, so that
``--dist loadfile`` can give it another worker). The fleet's wait has a
limit of 90 s; about 40 s alone on an 8-core CPU."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro import fleet as jfleet  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.training.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from repro_torch import faults, fleet, serving  # noqa: E402
from repro_torch.fleet.worker import worker_launches  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = [pytest.mark.torch, pytest.mark.fleet]

ARCH = "granite-moe-1b-a400m-smoke"
WAIT_S = 90.0
# one prompt length: each new length is a new compilation of the JAX prefill
LENS, BUDGETS = [8] * 6, [8, 5, 10, 6, 7, 9]


@pytest.fixture(autouse=True)
def _no_leaked_plan_one_thread_children(monkeypatch):
    """No fault plan leaks in or out; the worker processes (they copy this
    environment) run torch on one thread each, which at this size is
    faster than sharing every core with the other test workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for pkg in (faults, jfaults):
        pkg.uninstall_fault_plan()
    yield
    for pkg in (faults, jfaults):
        pkg.uninstall_fault_plan()


def mk_requests(pkg, vocab):
    rng = np.random.default_rng(0)
    return [pkg.ServeRequest(rid=i, prompt=rng.integers(0, vocab, LENS[i]).astype(np.int32),
                             max_new_tokens=BUDGETS[i]) for i in range(len(LENS))]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX weights as a checkpoint, and the JAX server's tokens."""
    jcfg = jax_get_config(ARCH)
    params = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    ckpt = tmp_path_factory.mktemp("ckpt") / "jax.ckpt"
    jax_save_checkpoint(ckpt, params, metadata={"arch": ARCH})
    res, _ = jserving.ContinuousBatchingServer(jcfg, params, n_slots=2, max_len=32).run(
        jserving.RequestQueue(mk_requests(jserving, jcfg.vocab)))
    return SimpleNamespace(ckpt=str(ckpt), vocab=jcfg.vocab,
                           tokens={r.rid: [int(t) for t in r.tokens] for r in res})


def run_fleet(ref, root, **kw):
    cfg = fleet.FleetConfig(n_workers=2, arch=ARCH, slots=2, checkpoint_every=2,
                            heartbeat_s=0.0, device="cpu", dtype="float32",
                            ckpt=ref.ckpt, **kw)
    sup = fleet.FleetSupervisor(mk_requests(serving, ref.vocab), cfg, root)
    return sup, sup.run(max_wall_s=WAIT_S)


def tokens_of(report):
    return {int(rid): r["tokens"] for rid, r in report["results"].items()}


def test_fleet_kill_and_hang_restart_with_the_jax_server_s_tokens(ref, tmp_path):
    """Worker 0 is killed mid-step (``os._exit``: the journal is current
    through the last step), worker 1 hangs with its process alive, which
    only heartbeat staleness catches. The kill is booked as ``crash``, the
    hang (SIGKILLed at the deadline) as ``hang``; both restart from their
    journals and the fleet finishes with the JAX server's tokens. The JAX
    supervisor's ``collect`` over the port's worker directories gives the
    port's report."""
    sup, report = run_fleet(ref, tmp_path, hang_deadline_s=2.0,
                            worker_faults={0: "kill_at=4,seed=0", 1: "hang_at=3:120"})
    assert report["restarts"] == {"crash": 1.0, "hang": 1.0}
    by_worker = {i: [e["event"] for e in report["events"] if e["worker"] == i]
                 for i in range(2)}
    assert "crash" in by_worker[0] and "hang_detected" not in by_worker[0]
    assert "hang_detected" in by_worker[1] and "crash" not in by_worker[1]
    for i in range(2):  # two incarnations each, both seen past start-up
        assert by_worker[i].count("launch") == by_worker[i].count("ready") == 2
    assert report["unaccounted"] == [] and not report["pending_checkpointed"]
    assert report["finished"] == len(LENS)
    assert tokens_of(report) == ref.tokens
    assert report["failover_s"]["count"] == 2
    assert [w["exit_code"] for w in report["workers"]] == [0, 0]
    prom = sup.prometheus_text().replace(".0", "")
    assert 'worker_restarts_total{reason="crash"} 1' in prom
    assert 'worker_restarts_total{reason="hang"} 1' in prom
    assert "fleet_failover_s_bucket" in prom
    for i in range(2):
        log = tmp_path / f"worker-{i}" / "worker.log"
        # only the restarted incarnation finished and wrote its launch line
        lines = worker_launches(log)
        assert len(lines) == 1 and lines[0]["device"] == "cpu"
        # ``python -m`` found no earlier copy of the worker module
        assert "found in sys.modules" not in log.read_text()

    jsup = jfleet.FleetSupervisor(mk_requests(jserving, ref.vocab),
                                  jfleet.FleetConfig(n_workers=2, arch=ARCH), tmp_path)
    jsup.setup()
    jrep = jsup.collect()
    for k in ("finished", "pending_checkpointed", "unaccounted", "results"):
        assert jrep[k] == report[k], k
