"""The port's ``OffloadedWaveServer`` against the JAX package's on the CPU:
granite-moe-1b-a400m-smoke (C = 2 of 4 experts, waves of 2), under fcfs
and expert-affinity, with and without LoRA, and its hooks and refusals
(the checks live in ``tests/_torch_wave.py``)."""
import pytest

pytest.importorskip("torch")
from _torch_wave import (build, test_wave_server_hooks_and_unported_knobs,  # noqa: E402,F401
                         test_wave_server_lora_moves_tokens_and_policies_agree,
                         test_wave_server_matches_reference)
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def wave_model():
    return build("granite-smoke")
