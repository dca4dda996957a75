"""Dispatching wrapper for causal flash attention: the Hopper kernel
(``csrc/flash_attn.cu``) for a CUDA tensor, the plain version for a CPU
tensor. The kernel streams K/V through shared memory, so the TPU
kernel's VMEM envelope (``repro/kernels/flash_attn/ops.py::supported``)
has no counterpart here."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build, dispatch
from .ref import attention_ref

_DTYPES = {torch.float32: "flash_attn_fwd_f32",
           torch.bfloat16: "flash_attn_fwd_bf16"}
HEAD_DIMS = (16, 32, 64, 112, 128)
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def flash(q, k, v, *, softcap: Optional[float] = None,
          window: Optional[int] = None, backend: Optional[str] = None):
    """Causal GQA attention. q (B,T,Hkv,G,hd); k/v (B,S,Hkv,hd)."""
    if not dispatch.use_kernel("flash_attn", backend, q.device):
        return attention_ref(q, k, v, softcap=softcap, window=window)
    return flash_hopper(q, k, v, softcap=softcap, window=window)


def flash_hopper(q, k, v, *, softcap: Optional[float] = None,
                 window: Optional[int] = None):
    """Launch the Hopper kernel (raises on what it does not take)."""
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash: want q (B,T,Hkv,G,hd), k/v (B,S,Hkv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, Hkv, G, hd = q.shape
    S = k.shape[1]
    if k.shape[0] != B or k.shape[2:] != (Hkv, hd):
        raise ValueError(f"flash: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash: head_dim {hd} not in {HEAD_DIMS}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash: the kernel takes CUDA tensors on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window <= 0:
        raise ValueError(f"flash: window {window} must be positive")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.entry(_DTYPES[q.dtype], _ARGS)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, T, S, Hkv, G, hd, hd**-0.5,
                    float(softcap) if softcap is not None else 0.0,
                    int(window) if window is not None else 0, stream),
                 "flash_attn")
    dispatch.count_launch("flash_attn")
    return out
