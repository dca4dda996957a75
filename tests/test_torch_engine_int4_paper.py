"""The port's INT4 offload engine (``quantized=True``) vs the JAX slab
engine with ``quantized=True, kernel_backend="ref"`` on the CPU, on the
smoke configs of the paper's two backbones whose experts do not fit one
card, Mixtral-8x7B and Phi-3.5-MoE: routed ids, tokens, transfers,
prefetch counts and both Eq.-3 clocks exactly equal on the same INT4
codes (the checks live in ``tests/_torch_engine_int4.py``)."""
import pytest

pytest.importorskip("torch")
from _torch_engine_int4 import (CAP, POLICY, PREFETCH, build,  # noqa: E402
                                check_int4_engine_matches_jax_slab_engine)
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

PAPER = ("mixtral-smoke", "phi35-smoke")


@pytest.fixture(scope="module")
def models():
    return {k: v for key in PAPER for k, v in build(key).items()}


@PREFETCH
@CAP
@POLICY
@pytest.mark.parametrize("arch", PAPER)
def test_int4_engine_matches_jax_slab_engine(models, monkeypatch, arch, policy, cap,
                                             prefetch):
    check_int4_engine_matches_jax_slab_engine(models, monkeypatch, arch, policy, cap,
                                              prefetch)
