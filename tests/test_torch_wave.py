"""The port's ``OffloadedWaveServer`` against the JAX package's on the CPU:
olmoe-mini cut to 2 layers (C = 8 of 32 experts, waves of 3), under fcfs
and expert-affinity, with and without LoRA, and under an SLO (the checks
live in ``tests/_torch_wave.py``)."""
import pytest

pytest.importorskip("torch")
from _torch_wave import (build, test_wave_server_lora_moves_tokens_and_policies_agree,  # noqa: E402,F401
                         test_wave_server_matches_reference,
                         test_wave_server_slo_retires_and_sheds_as_reference)
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def wave_model():
    return build("olmoe-mini-2l")
