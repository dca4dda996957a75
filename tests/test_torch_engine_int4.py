"""The port's INT4 offload engine (``quantized=True``) vs the JAX slab
engine with ``quantized=True, kernel_backend="ref"`` on the CPU, on
granite-moe-1b-a400m-smoke: routed ids, tokens, transfers, prefetch
counts and both Eq.-3 clocks exactly equal on the same INT4 codes, and
the engine's own quantization against the JAX engine's codes (the
checks and their tolerances live in ``tests/_torch_engine_int4.py``;
olmoe-mini is in ``tests/test_torch_engine_int4_olmoe.py``)."""
import pytest

pytest.importorskip("torch")
from _torch_engine_int4 import (CAP, POLICY, PREFETCH, build,  # noqa: E402
                                check_int4_engine_matches_jax_slab_engine,
                                check_int4_engine_quantizes_itself_like_the_bridged_store)
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def models():
    return build("granite-smoke")


@PREFETCH
@CAP
@POLICY
@pytest.mark.parametrize("arch", ["granite-smoke"])
def test_int4_engine_matches_jax_slab_engine(models, monkeypatch, arch, policy, cap,
                                             prefetch):
    check_int4_engine_matches_jax_slab_engine(models, monkeypatch, arch, policy, cap,
                                              prefetch)


def test_int4_engine_quantizes_itself_like_the_bridged_store(models):
    check_int4_engine_quantizes_itself_like_the_bridged_store(models)
