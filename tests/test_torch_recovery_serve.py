"""Crash and restore through both servers of the port against the JAX
package's on the CPU (``olmoe-mini-smoke``, fp32, greedy; the wave
server's engine at C = 2, gamma; its checks of records, journal,
checkpoints, revival and the watchdog are in
``tests/test_torch_recovery.py``).

A crash is injected mid-serve (the continuous server's fourth decode
step, after a checkpoint at step 2, so the journal has a tail; the wave
server's second decode step of its second wave, after a checkpoint per
wave), the journal is recovered and the run finished, by the same
package and across the two in both directions: a journal written by the
JAX server up to the crash is recovered by the port's ``recover`` and
finished by the port's server, and the other way round. The wave server
revives the checkpointed cache warm. The finished tokens and finish
reasons equal an uninterrupted JAX run's (the continuous server
re-prefills ``prompt + watermark``; in fp32 that is the arithmetic of the
uninterrupted decode), and generated tokens are conserved.

About 30 s alone on an 8-core CPU (mostly the JAX servers' compiles).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_ops import build, clean_globals, requests, share_jits  # noqa: E402,F401
from repro import faults as jfaults  # noqa: E402
from repro import recovery as jrecovery  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro_torch import faults, recovery, serving  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.usefixtures("clean_globals")]

BUDGETS = (5, 4, 6, 3)


@pytest.fixture(scope="module")
def m():
    return build()


PKGS = {"jax": (jserving, jfaults, jrecovery), "port": (serving, faults, recovery)}


@pytest.fixture(scope="module")
def continuous(m):
    """One continuous server per package, reused by every run (``run``
    starts from a fresh slot state; building a JAX server compiles its
    steps), and the uninterrupted JAX run."""
    srv = {"jax": jserving.ContinuousBatchingServer(m.jcfg, m.jparams, n_slots=2, max_len=24),
           "port": serving.ContinuousBatchingServer(m.tcfg, m.tparams, n_slots=2, max_len=24)}
    ref, _ = srv["jax"].run(jserving.RequestQueue(requests(jserving, BUDGETS)))
    return srv, ref


def _wave_server(m, name):
    if name == "jax":
        return share_jits_of(jserving.OffloadedWaveServer(
            m.jcfg, m.jparams, capacity=2, policy="gamma", wave_size=2))
    return serving.OffloadedWaveServer(m.tcfg, m.tparams, capacity=2, policy="gamma",
                                       wave_size=2, device="cpu")


_WAVE_REF = []


def wave_reference(m):
    """The uninterrupted JAX wave run (once per module)."""
    if not _WAVE_REF:
        _WAVE_REF.append(_wave_server(m, "jax").run(
            jserving.RequestQueue(requests(jserving, BUDGETS)))[0])
    return _WAVE_REF[0]


def share_jits_of(srv):
    share_jits(srv.engine)
    return srv


@pytest.mark.parametrize("kind", ["continuous", "wave"])
@pytest.mark.parametrize("writer,finisher", [("port", "port"), ("jax", "port"),
                                             ("port", "jax")])
def test_crash_restore_token_identical(m, continuous, tmp_path, kind, writer, finisher):
    wsrv, wfaults, wrec = PKGS[writer]
    _, _, frec = PKGS[finisher]
    if kind == "continuous":
        server = lambda name: continuous[0][name]  # noqa: E731
        ref = continuous[1]
    else:
        server = lambda name: _wave_server(m, name)  # noqa: E731
        ref = wave_reference(m)
    # continuous: the fourth decode step (a checkpoint at step 2, a journal
    # tail after it); wave: the second decode step of the second wave
    crash = 4 if kind == "continuous" else BUDGETS[0] + BUDGETS[1]
    jr = wrec.RequestJournal(tmp_path)
    wfaults.install_fault_plan(f"crash_at={crash},seed=0")
    with pytest.raises(wfaults.InjectedCrash):
        server(writer).run(wsrv.RequestQueue(requests(wsrv, BUDGETS)), journal=jr,
                           checkpoint_every=2 if kind == "continuous" else 1)
    jr.close()
    wfaults.uninstall_fault_plan()

    state = frec.recover(tmp_path)
    assert state.kind == kind and state.pending
    srv = server(finisher)
    if kind == "wave":
        srv.engine.metrics.load_state(state.engine["metrics"])
        rev = srv.engine.revive(state.engine["cache"], warm=True)
        assert rev["loaded"] == sum(len(st["resident"]) for st in state.engine["cache"]) > 0
    jr2 = frec.RequestJournal(tmp_path, seen=state.seen_rids)
    res, mt = srv.run(state.build_queue(None), state.metrics, journal=jr2,
                      checkpoint_every=2, audit_every=1, resume=state)
    jr2.close()
    assert [r.rid for r in res] == [0, 1, 2, 3]
    for a, b in zip(ref, res):
        np.testing.assert_array_equal(np.asarray(b.tokens), np.asarray(a.tokens))
        assert a.finish_reason == b.finish_reason
    assert mt.generated_tokens == sum(len(r.tokens) for r in ref)
    if kind == "wave":
        assert srv.engine.audit() == []
