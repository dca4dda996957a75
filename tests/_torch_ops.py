"""Shared set-up of the operations-stack tests (``tests/test_torch_obs.py``,
``tests/test_torch_faults.py``, ``tests/test_torch_recovery.py``).

``olmoe-mini-smoke`` (2 MoE layers of 4 experts, top-2) from the JAX init
(key 0, fp32), bridged into the port; a cache of C = 2 experts per layer
under the gamma policy, so every step misses. The JAX engines run the
plain backend (``kernel_backend="ref"``) and share one set of compiled
steps. Each package keeps its own module-global tracer, fault plan and
metrics registry: :func:`clean_globals` disables, uninstalls and clears
all six before and after a test, so no test leaves a plan installed for
the next file on its worker.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.offload_engine import PCIE5_H100  # noqa: E402
from repro.core.offload_engine import OffloadedMoEEngine as JaxEngine  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch import faults, obs, serving  # noqa: E402
from repro_torch.bridge import little_bank_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.offload_engine import HardwareProfile, OffloadedMoEEngine  # noqa: E402

HW = HardwareProfile(**{f.name: getattr(PCIE5_H100, f.name)
                        for f in dataclasses.fields(HardwareProfile)})
ARCH = "olmoe-mini-smoke"
C = 2


def build():
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 10)).astype(np.int32)
    return SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                           tparams=params_from_jax(tree, tcfg), toks=toks)


_SHARED = {}


def share_jits(eng):
    """JAX engines of one config share the first one's compiled steps (the
    traced functions read only the config and the backend)."""
    names = ("_jit_cache", "_embed_fn", "_next_tok_fn", "_slab_scatter", "_slab_set")
    for n, v in _SHARED.setdefault(ARCH, {n: getattr(eng, n) for n in names}).items():
        setattr(eng, n, v)
    return eng


def jax_engine(m, **kw):
    return share_jits(JaxEngine(m.jcfg, m.jparams, capacity=C, policy="gamma",
                                hw=PCIE5_H100, kernel_backend="ref", **kw))


def port_engine(m, je=None, **kw):
    """The port's engine on the same weights; ``je`` (a JAX engine with a
    little bank) hands its bank across."""
    if je is not None and je.little is not None:
        kw["little_bank"] = little_bank_from_jax(je.little)
    return OffloadedMoEEngine(m.tcfg, m.tparams, capacity=C, policy="gamma", hw=HW,
                              device="cpu", **kw)


def wave_servers(m, *, little=False, **kw):
    """A JAX ``OffloadedWaveServer`` (shared compiled steps) and the port's
    on the same weights (and, with ``little``, the JAX server's bank)."""
    jsrv = jserving.OffloadedWaveServer(m.jcfg, m.jparams, capacity=C, policy="gamma",
                                        hw=PCIE5_H100, little_experts=little, **kw)
    share_jits(jsrv.engine)
    if little:
        kw["little_bank"] = little_bank_from_jax(jsrv.engine.little)
    tsrv = serving.OffloadedWaveServer(m.tcfg, m.tparams, capacity=C, policy="gamma",
                                       hw=HW, device="cpu", **kw)
    return jsrv, tsrv


def requests(pkg, budgets, *, seed=0, slo=None, arrivals=None):
    """``pkg.ServeRequest`` s of 8 prompt tokens (one length: each new length
    is a new compilation of the JAX prefill) with these budgets."""
    rng = np.random.default_rng(seed)
    vocab = get_config(ARCH).vocab
    return [pkg.ServeRequest(rid=i, prompt=rng.integers(0, vocab, 8).astype(np.int32),
                             max_new_tokens=b, slo=slo,
                             arrival_time=0.0 if arrivals is None else arrivals[i])
            for i, b in enumerate(budgets)]


def reset_globals():
    for pkg_obs, pkg_faults in ((jobs, jfaults), (obs, faults)):
        pkg_obs.disable_tracing()
        pkg_faults.uninstall_fault_plan()
        pkg_obs.REGISTRY.clear()


@pytest.fixture
def clean_globals():
    reset_globals()
    yield
    reset_globals()


def assert_same_results(jres, tres):
    assert [r.rid for r in tres] == [r.rid for r in jres]
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        assert (t.finish_reason, t.decode_steps, t.degraded) == (
            j.finish_reason, j.decode_steps, j.degraded)
