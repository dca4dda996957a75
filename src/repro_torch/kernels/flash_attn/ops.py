"""Dispatching wrapper for causal flash attention: a Hopper kernel for a
CUDA tensor, the plain version for a CPU tensor. Two kernels, chosen by
:func:`route`:

  tc  — bf16 with 16-byte aligned pointers: QK^T and PV on tensor cores
        (``csrc/flash_attn_tc.cu``);
  fma — everything else (fp32): the CUDA-core kernel (``csrc/flash_attn.cu``).

Both stream K/V through shared memory, so the TPU kernel's VMEM envelope
(``repro/kernels/flash_attn/ops.py::supported``) has no counterpart
here."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build, dispatch
from .ref import attention_ref

ROUTES = ("tc", "fma")
_ENTRIES = {("fma", torch.float32): "flash_attn_fwd_f32",
            ("fma", torch.bfloat16): "flash_attn_fwd_bf16",
            ("tc", torch.bfloat16): "flash_attn_fwd_bf16_tc"}
HEAD_DIMS = (16, 32, 64, 112, 128, 160)
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def route(hd: int, dtype: torch.dtype, ptrs=(), force: Optional[str] = None) -> str:
    """The kernel for head dim ``hd`` in ``dtype`` with data pointers
    ``ptrs``: bf16 with 16-byte aligned pointers (every head dim here is a
    multiple of 8, so every row is aligned too) runs on tensor cores,
    "tc"; anything else on the CUDA-core kernel, "fma". ``force`` names a
    route to take instead (to time one against another); it raises where
    that route cannot take the call, as do a head dim or dtype no kernel
    takes."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash: head_dim {hd} not in {HEAD_DIMS}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash: dtype {dtype} (want fp32 or bf16)")
    which = "tc" if dtype == torch.bfloat16 and all(p % 16 == 0 for p in ptrs) else "fma"
    if force is None:
        return which
    if force not in ROUTES:
        raise ValueError(f"flash: route {force!r} not in {ROUTES}")
    if force == "tc" and which != "tc":
        raise ValueError(f"flash: route 'tc' does not take {dtype} at pointers "
                         f"{[hex(p) for p in ptrs]}")
    return force


def flash(q, k, v, *, softcap: Optional[float] = None,
          window: Optional[int] = None, backend: Optional[str] = None):
    """Causal GQA attention. q (B,T,Hkv,G,hd); k/v (B,S,Hkv,hd)."""
    if not dispatch.use_kernel("flash_attn", backend, q.device):
        return attention_ref(q, k, v, softcap=softcap, window=window)
    return flash_hopper(q, k, v, softcap=softcap, window=window)


def operations(B: int, T: int, Hkv: int, G: int, hd: int,
               window: Optional[int] = None) -> float:
    """The kernel's operation count, its bound's: QKᵀ and PV, 4 hd per
    causal (query, key) pair inside the window."""
    w = T if window is None else min(window, T)
    # sum over query t of min(t + 1, w): a triangle, then full windows
    pairs = w * (w + 1) // 2 + (T - w) * w
    return 4.0 * hd * pairs * B * Hkv * G


def flash_hopper(q, k, v, *, softcap: Optional[float] = None,
                 window: Optional[int] = None, force_route: Optional[str] = None):
    """Launch the Hopper kernel that :func:`route` picks, or
    ``force_route`` (to time one route against another; a route that
    cannot take the inputs raises). Fake tensors take the shape function
    (``dispatch``): the output, no launch."""
    dispatch.refuse_grad("flash_attn", q, k, v)
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash: want q (B,T,Hkv,G,hd), k/v (B,S,Hkv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, Hkv, G, hd = q.shape
    S = k.shape[1]
    if k.shape[0] != B or k.shape[2:] != (Hkv, hd):
        raise ValueError(f"flash: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if not (dispatch.on_card(q) and k.device == q.device and v.device == q.device):
        raise ValueError("flash: the kernel takes CUDA tensors on one device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window <= 0:
        raise ValueError(f"flash: window {window} must be positive")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    fake = dispatch.is_fake(q)
    which = route(hd, q.dtype, () if fake else (q.data_ptr(), k.data_ptr(), v.data_ptr()),
                  force_route)
    out = torch.empty_like(q)
    if fake:  # the shape function: the output, no launch
        dispatch.count_fake("flash_attn", which, operations(B, T, Hkv, G, hd, window),
                            (2 * q.numel() + 2 * k.numel()) * q.element_size())
        return out
    if out.numel() == 0:
        return out
    fn = _build.entry(_ENTRIES[which, q.dtype], _ARGS)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, T, S, Hkv, G, hd, hd**-0.5,
                    float(softcap) if softcap is not None else 0.0,
                    int(window) if window is not None else 0, stream),
                 f"flash_attn ({which})")
    dispatch.count_launch("flash_attn", which)
    return out
