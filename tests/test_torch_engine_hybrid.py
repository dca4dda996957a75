"""The port's offload engine against the JAX slab engine on hand-built
hybrids (``hand_built`` in ``tests/test_torch_engine_blocks.py``, whose
checks run here): ``mamba`` + ``attn_moe`` and ``shared_attn`` +
``attn_moe``, fp experts with and without LoRA."""
import pytest

pytest.importorskip("torch")
from test_torch_engine_blocks import build, run_case  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

KEYS = ["mamba+moe", "shared_attn+moe"]


@pytest.fixture(scope="module")
def hybrids():
    return build(KEYS)


@pytest.mark.parametrize("variant", ["fp", "fp+lora"])
@pytest.mark.parametrize("key", KEYS)
def test_engine_hybrid_matches_jax(hybrids, key, variant):
    run_case(hybrids[key], key, variant)
