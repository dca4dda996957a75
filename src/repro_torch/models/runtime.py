"""Runtime context threaded through model code (counterpart of
``repro/models/runtime.py``, single device: mesh and sharding wait)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import dispatch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for (explicitly or
    by default) and is missing: there is no quiet CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on "
                           "the CPU")
    return dev


@dataclass(frozen=True)
class Runtime:
    kernel_backend: str = "auto"  # "ref" | "hopper" | "auto", optionally per
    # op ("auto,flash_attn=ref"); REPRO_TORCH_KERNEL_BACKEND overrides it
    device: torch.device = torch.device("cpu")
    zero_drop: bool = False  # MoE capacity large enough for zero token drops

    def kernel_choice(self, op: str) -> bool:
        """True when ``op`` launches its Hopper kernel on this device."""
        return dispatch.use_kernel(op, self.kernel_backend, self.device)
