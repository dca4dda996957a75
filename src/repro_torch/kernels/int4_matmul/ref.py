"""Plain PyTorch version of the INT4 dequant matmul (counterpart of
``repro/kernels/int4_matmul/ref.py``)."""
from __future__ import annotations

import torch


def dequant_ref(packed: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                group: int) -> torch.Tensor:
    """packed (..., K//2, N) uint8 -> W (..., K, N) fp32; the low nibble
    is the even K row. scale/zero (..., K//group, N) fp32."""
    *lead, K2, N = packed.shape
    q = torch.stack((packed & 0x0F, packed >> 4), dim=-2).reshape(*lead, 2 * K2, N)
    q = q.float().unflatten(-2, (2 * K2 // group, group))
    return ((q - zero.unsqueeze(-2)) * scale.unsqueeze(-2)).flatten(-3, -2)


def int4_matmul_ref(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, group: int) -> torch.Tensor:
    """x (M, K) @ dequant -> (M, N): fp32 products, output in ``x.dtype``."""
    w = dequant_ref(packed, scale, zero, group)
    return (x.float() @ w).to(x.dtype)
