"""The port's INT4 offload engine (``quantized=True``) vs the JAX slab
engine with ``quantized=True, kernel_backend="ref"`` on the CPU, on
olmoe-mini cut to 2 layers, under the lfu policy: routed ids, tokens,
transfers, prefetch counts and both Eq.-3 clocks exactly equal on the
same INT4 codes (the checks live in ``tests/_torch_engine_int4.py``;
gamma is in ``tests/test_torch_engine_int4_olmoe_gamma.py``, granite
smoke in ``tests/test_torch_engine_int4.py``: one file per config and
policy keeps each file's JAX quantization and compile time on its own
worker)."""
import pytest

pytest.importorskip("torch")
from _torch_engine_int4 import (CAP, PREFETCH, build,  # noqa: E402
                                check_int4_engine_matches_jax_slab_engine)
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def models():
    return build("olmoe-mini-2l")


@PREFETCH
@CAP
@pytest.mark.parametrize("policy", ["lfu"])
@pytest.mark.parametrize("arch", ["olmoe-mini-2l"])
def test_int4_engine_matches_jax_slab_engine(models, monkeypatch, arch, policy, cap,
                                             prefetch):
    check_int4_engine_matches_jax_slab_engine(models, monkeypatch, arch, policy, cap,
                                              prefetch)
