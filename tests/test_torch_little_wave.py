"""``OffloadedWaveServer`` with the little-expert tier against the JAX
server on the CPU, on ``granite-moe-1b-a400m-smoke`` (``_torch_wave``'s
model, fcfs waves): requests at quality 0.5, and exact requests under an
SLO whose deadline pressure sends the late misses to the little tier.
The port's engine serves the JAX server's bank, carried across by
``bridge.little_bank_from_jax``. Per request tokens, finish reasons and
times, and the server's transfers, hits, misses, degraded requests and
Eq.-3 clocks equal the reference's (``_torch_wave.assert_same``). About
15 s alone on an 8-core CPU.
"""
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_wave import (BUDGETS, HW, _scheduler, _share_jits, assert_same,  # noqa: E402
                         build)
from repro import serving as jserving  # noqa: E402
from repro.core.offload_engine import PCIE5_H100  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.bridge import little_bank_from_jax  # noqa: E402
from repro_torch.core.lora import lora_scale  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def wave_model():
    return build("granite-smoke")


def _requests(pkg, m, quality, slo):
    return [pkg.ServeRequest(rid=i, prompt=p, max_new_tokens=BUDGETS[i],
                             expert_scores=m["scores"]["lora"][i], slo=slo,
                             quality=quality)
            for i, p in enumerate(m["prompts"])]


def _serve(m, quality, slo):
    sc = lora_scale(m["tcfg"].melinoe)
    kw = dict(capacity=m["C"], policy="gamma", wave_size=m["wave"], lora_scale=sc,
              little_experts=True, little_rank=4)
    jsrv = jserving.OffloadedWaveServer(
        m["jcfg"], m["jparams"], scheduler=_scheduler(jserving, "fcfs", m["C"]),
        hw=PCIE5_H100, lora=jax.tree.map(jnp.asarray, m["jlora"]), **kw)
    _share_jits(m["key"], jsrv.engine)
    jres, jmt = jsrv.run(jserving.RequestQueue(_requests(jserving, m, quality, slo)))
    tsrv = serving.OffloadedWaveServer(
        m["tcfg"], m["tparams"], scheduler=_scheduler(serving, "fcfs", m["C"]), hw=HW,
        lora=m["tlora"], device="cpu", little_bank=little_bank_from_jax(jsrv.engine.little),
        **kw)
    tres, tmt = tsrv.run(serving.RequestQueue(_requests(serving, m, quality, slo)))
    return jres, jmt, tres, tmt


def test_wave_server_quality_dial_matches_reference(wave_model):
    jres, jmt, tres, tmt = _serve(wave_model, 0.5, None)
    assert_same(jres, jmt, tres, tmt)
    assert tmt.degraded_requests > 0 and tmt.transfers > 0


def test_wave_server_deadline_pressure_matches_reference(wave_model):
    """An SLO just under the slowest best-effort latency: the slowest
    request meets deadline pressure in its last steps (its misses go to
    the little tier, uncharged) and finishes inside its SLO, as in the
    reference."""
    m = wave_model
    best = serving.OffloadedWaveServer(
        m["tcfg"], m["tparams"], capacity=m["C"], policy="gamma", wave_size=m["wave"],
        scheduler=_scheduler(serving, "fcfs", m["C"]), hw=HW, lora=m["tlora"],
        lora_scale=lora_scale(m["tcfg"].melinoe), device="cpu")
    lat = sorted(best.run(serving.RequestQueue(_requests(serving, m, 1.0, None)))[1].latencies)
    jres, jmt, tres, tmt = _serve(m, 1.0, 0.95 * lat[-1])
    assert_same(jres, jmt, tres, tmt)
    assert tmt.degraded_requests > 0
    assert {r.finish_reason for r in tres} == {"length"}
