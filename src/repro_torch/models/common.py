"""Shared layer primitives: RMSNorm, RoPE, softcap, SiLU, init helpers
(counterpart of ``repro/models/common.py``)."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

# The reference's ``REPRO_OPT`` switches of the sharded path, read from
# ``REPRO_TORCH_OPT`` (the same names) or set with :func:`set_opt_flags`:
# ``moe_dispatch_shard`` (``moe.apply_moe_sharded``) and
# ``loss_token_shard`` (``model.compute_logits``).
OPT_FLAGS = {name: name in os.environ.get("REPRO_TORCH_OPT", "")
             for name in ("moe_dispatch_shard", "loss_token_shard")}


def set_opt_flags(**kw) -> None:
    """Set ``REPRO_TORCH_OPT`` switches by name; an unknown name raises."""
    for k, v in kw.items():
        if k not in OPT_FLAGS:
            raise KeyError(k)
        OPT_FLAGS[k] = bool(v)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def cdtype(cfg_dtype) -> torch.dtype:
    """Config dtype string (``"bfloat16"``) or torch dtype -> torch dtype."""
    if isinstance(cfg_dtype, torch.dtype):
        return cfg_dtype
    return _DTYPES[str(cfg_dtype)]


# ---------------------------------------------------------------------------
# Init helpers (truncated normal, as the JAX package; the random bits differ)
# ---------------------------------------------------------------------------


def _trunc_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)


def dense_init(in_dim: int, out_dim: int, dtype, *, generator, device,
               lead=()) -> torch.Tensor:
    """Truncated-normal fan-in init (stddev 1/sqrt(in_dim)), shape
    ``(*lead, in_dim, out_dim)``."""
    w = _trunc_normal((*lead, in_dim, out_dim), generator, device) * in_dim**-0.5
    return w.to(dtype)


def embed_init(vocab: int, dim: int, dtype, *, generator, device) -> torch.Tensor:
    return _trunc_normal((vocab, dim), generator, device).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rms_norm_init(dim: int, dtype, *, device, lead=()) -> torch.Tensor:
    return torch.zeros((*lead, dim), dtype=dtype, device=device)  # (1 + w)


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style ``(1 + w)`` RMSNorm, computed in fp32."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + w.float())).to(dt)


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved pairs; angles in fp32)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, head_dim); positions broadcastable to (..., T)."""
    head_dim = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(head_dim, theta), device=x.device)
    ang = positions[..., :, None, None].float() * freqs  # (..., T, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
