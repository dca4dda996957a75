"""Dispatching wrapper for the grouped expert matmul: the Hopper kernel
(``csrc/gmm.cu``) for a CUDA tensor, the plain version for a CPU tensor
(see ``kernels/dispatch.py``)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build, dispatch
from .ref import gmm_ref

_DTYPES = {torch.float32: "moe_gmm_f32", torch.bfloat16: "moe_gmm_bf16"}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def gmm(a: torch.Tensor, b: torch.Tensor,
        group_sizes: Optional[torch.Tensor] = None, *,
        backend: Optional[str] = None) -> torch.Tensor:
    """a (E, M, K) @ b (E, K, N) -> (E, M, N).

    ``group_sizes`` (E,): valid rows per group; rows past the count must
    already be zero in ``a`` (slot-dispatch buffers guarantee it). The
    kernel then skips every M-tile past the count without reading the
    group's weights; the plain version needs no such skip."""
    if not dispatch.use_kernel("moe_gmm", backend, a.device):
        return gmm_ref(a, b)
    return gmm_hopper(a, b, group_sizes)


def gmm_hopper(a: torch.Tensor, b: torch.Tensor,
               group_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the Hopper kernel (raises on what it does not take)."""
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"gmm: want a (E,M,K), b (E,K,N); got {a.shape}, {b.shape}")
    E, M, K = a.shape
    if b.shape[:2] != (E, K):
        raise ValueError(f"gmm: shape mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("gmm: the kernel takes CUDA tensors on one device")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"gmm: dtypes {a.dtype}, {b.dtype} (want fp32 or bf16, equal)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gmm: the kernel takes contiguous a and b")
    N = b.shape[2]
    sizes_ptr = None
    if group_sizes is not None:
        group_sizes = group_sizes.to(device=a.device, dtype=torch.int32).contiguous()
        if group_sizes.shape != (E,):
            raise ValueError(f"gmm: group_sizes {tuple(group_sizes.shape)} != ({E},)")
        sizes_ptr = group_sizes.data_ptr()
    out = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    fn = _build.entry(_DTYPES[a.dtype], _ARGS)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), sizes_ptr,
                    E, M, K, N, stream), "moe_gmm")
    dispatch.count_launch("moe_gmm")
    return out
