"""Dispatching wrapper and weight preparation for the INT4 dequant
matmul: the Hopper kernel (``csrc/int4_matmul.cu``) for a CUDA tensor,
the plain version for a CPU tensor (see ``kernels/dispatch.py``)."""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import _build, dispatch
from .ref import int4_matmul_ref

_DTYPES = {torch.float32: "int4_matmul_f32", torch.bfloat16: "int4_matmul_bf16"}
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


class MatmulQWeight(NamedTuple):
    packed: torch.Tensor  # (K//2, N) uint8, low nibble = even K row
    scale: torch.Tensor  # (K//group, N) f32
    zero: torch.Tensor  # (K//group, N) f32
    group: int


def quantize_matmul_weight(w: torch.Tensor, group: int = 64) -> MatmulQWeight:
    """w (K, N) -> per-(group-of-K, column) affine int4 codes (min/max
    init; the HQQ refinement lives in ``core.quant``)."""
    K, N = w.shape
    if K % group or K % 2:
        raise ValueError(f"quantize_matmul_weight: K={K} vs group {group}")
    wg = w.float().reshape(K // group, group, N)
    wmin = wg.amin(1)
    wmax = wg.amax(1)
    scale = torch.clamp((wmax - wmin) / 15.0, min=1e-8)  # (K//group, N)
    zero = -wmin / scale
    q = torch.clamp(torch.round(wg / scale[:, None] + zero[:, None]), 0, 15)
    q = q.to(torch.uint8).reshape(K, N)
    packed = q[0::2] | (q[1::2] << 4)
    return MatmulQWeight(packed, scale, zero, group)


def _check_group(K: int, group: int) -> int:
    group = int(group)
    if group <= 0 or group % 2 or K % group:
        raise ValueError(f"int4_matmul: K={K} must be a multiple of an even "
                         f"group, got group={group}")
    return group


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                zero: torch.Tensor, *, group: int = 64,
                backend: Optional[str] = None) -> torch.Tensor:
    """y = x @ dequant(packed, scale, zero). x (M, K) or (..., K); the
    leading dims are flattened and restored."""
    lead, K = x.shape[:-1], x.shape[-1]
    group = _check_group(K, group)
    x2 = x.reshape(-1, K)
    if dispatch.use_kernel("int4_matmul", backend, x.device):
        out = int4_matmul_hopper(x2, packed, scale, zero, group)
    else:
        out = int4_matmul_ref(x2, packed, scale, zero, group)
    return out.reshape(*lead, out.shape[-1])


def int4_matmul_hopper(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                       zero: torch.Tensor, group: int) -> torch.Tensor:
    """Launch the Hopper kernel on x (M, K) (raises on what it does not
    take)."""
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"int4_matmul: want x (M,K), packed (K//2,N); got "
                         f"{tuple(x.shape)}, {tuple(packed.shape)}")
    M, K = x.shape
    group = _check_group(K, group)
    N = packed.shape[1]
    if packed.shape[0] != K // 2 or scale.shape != (K // group, N) \
            or zero.shape != scale.shape:
        raise ValueError(f"int4_matmul: packed {tuple(packed.shape)}, scale "
                         f"{tuple(scale.shape)}, zero {tuple(zero.shape)} do not "
                         f"fit K={K}, group={group}")
    if not (x.is_cuda and all(t.device == x.device for t in (packed, scale, zero))):
        raise ValueError("int4_matmul: the kernel takes CUDA tensors on one device")
    if x.dtype not in _DTYPES or packed.dtype != torch.uint8 \
            or scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise TypeError(f"int4_matmul: dtypes x {x.dtype}, packed {packed.dtype}, "
                        f"scale {scale.dtype}, zero {zero.dtype} (want x fp32 or "
                        "bf16, packed uint8, scale/zero fp32)")
    if not all(t.is_contiguous() for t in (x, packed, scale, zero)):
        raise ValueError("int4_matmul: the kernel takes contiguous tensors")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.entry(_DTYPES[x.dtype], _ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                    zero.data_ptr(), out.data_ptr(), M, K, N, group, stream),
                 "int4_matmul")
    dispatch.count_launch("int4_matmul")
    return out
