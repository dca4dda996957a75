"""Dispatching wrapper and weight preparation for the INT4 dequant
matmul: a Hopper kernel for a CUDA tensor, the plain version for a CPU
tensor (see ``kernels/dispatch.py``). Three kernels, chosen by
:func:`route`:

  stream — bf16 x, M <= 16 (decode): split-K weight stream, dequantized
           in registers, fp32 CUDA-core sums, ordered split reduction
           (``csrc/int4_matmul_tc.cu``);
  tc     — bf16 x, M > 16 (prefill): tensor-core tiles on the codes
           themselves (turned into bf16 once a block), the group affine
           on the fp32 sums, K split where the tiles alone leave the card
           short of warps (``csrc/int4_matmul_tc.cu``);
  fma    — everything else (fp32 x, N not a multiple of 8, groups not a
           multiple of 32 or above 128, misaligned pointers): the
           CUDA-core kernel (``csrc/int4_matmul.cu``)."""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import _build, dispatch
from .ref import int4_matmul_ref

ROUTES = ("stream", "tc", "fma")
_ENTRIES = {("fma", torch.float32): "int4_matmul_f32",
            ("fma", torch.bfloat16): "int4_matmul_bf16",
            ("tc", torch.bfloat16): "int4_matmul_bf16_tc",
            ("stream", torch.bfloat16): "int4_matmul_bf16_stream"}
STREAM_MAX_M = 16  # the decode rows
TC_GROUP = 32  # the tensor-core routes' K step: groups are whole steps
TC_MAX_GROUP = 128
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_FAST_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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


def route(M: int, K: int, N: int, group: int, dtype: torch.dtype, ptrs=(),
          force: Optional[str] = None) -> str:
    """The kernel for x (M, K) in ``dtype`` times an INT4 weight (K, N) in
    groups of ``group`` K rows, with data pointers ``ptrs``: bf16 with
    16-byte aligned pointers, N a multiple of 8 and a group that is a
    whole number of 32-row K steps (up to 128) runs "stream" up to
    ``STREAM_MAX_M`` rows and "tc" above; anything else the CUDA-core
    kernel, "fma". ``force`` names a route to take instead (to time one
    against another); it raises where that route cannot take the call, as
    does a dtype no kernel takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int4_matmul: dtype {dtype} (want fp32 or bf16)")
    fast = dtype == torch.bfloat16 and N % 8 == 0 and group % TC_GROUP == 0 \
        and group <= TC_MAX_GROUP and K % group == 0 and all(p % 16 == 0 for p in ptrs)
    if force is None:
        if not fast:
            return "fma"
        return "stream" if M <= STREAM_MAX_M else "tc"
    if force not in ROUTES:
        raise ValueError(f"int4_matmul: route {force!r} not in {ROUTES}")
    if force != "fma" and not (fast and (force == "tc" or M <= STREAM_MAX_M)):
        raise ValueError(f"int4_matmul: route {force!r} does not take {dtype} M={M} "
                         f"K={K} N={N} group={group} at pointers "
                         f"{[hex(p) for p in ptrs]}")
    return force


def splits(which: str, M: int, K: int, N: int, group: int) -> int:
    """K splits of a fast route (the kernel library's choice): "stream"
    splits K into whole groups, "tc" into whole 64-row stages."""
    if which == "stream":
        gps = _build.entry("int4_stream_split_groups", [ctypes.c_int] * 3)(K, N, group)
        return -(-K // (gps * group))
    return _build.entry("int4_tc_splits", [ctypes.c_int] * 3)(M, K, N)


# the kernel library's split constants (csrc/int4_matmul_tc.cu), for the
# shape function, which cannot ask the library: "stream" SBN, TARGET_BLOCKS,
# SMAX_KS; "tc" TBM, TBN, TK, TC_TARGET_BLOCKS
_SBN, _TARGET_BLOCKS, _SMAX_KS = 64, 264, 512
_TBM, _TBN, _TK, _TC_TARGET_BLOCKS = 64, 64, 64, 256


def fake_splits(which: str, M: int, K: int, N: int, group: int) -> int:
    """:func:`splits` computed in Python, as ``int4_stream_split_groups``
    and ``int4_tc_splits`` compute it (chip_smoke holds the two equal on
    the card)."""
    if which == "stream":
        groups, tiles = K // group, -(-N // _SBN)
        gps = max(1, -(-groups // -(-_TARGET_BLOCKS // tiles)))
        if gps * group > _SMAX_KS:
            gps = _SMAX_KS // group
        return -(-K // (gps * group))
    blocks = -(-N // _TBN) * -(-M // _TBM)
    nk = -(-K // _TK)
    n = min(max(_TC_TARGET_BLOCKS // max(blocks, 1), 1), 4, nk)
    sps = -(-nk // n)
    return -(-nk // sps)


def operations(M: int, K: int, N: int) -> float:
    """The kernel's operation count, its bound's: 2 K N per row of x."""
    return 2.0 * M * K * N


def int4_matmul_hopper(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                       zero: torch.Tensor, group: int, *,
                       force_route: Optional[str] = None) -> torch.Tensor:
    """Launch the Hopper kernel that :func:`route` picks on x (M, K), or
    ``force_route`` (to time one route against another; a route that
    cannot take the inputs raises, as does anything no kernel takes).
    Fake tensors take the shape function (``dispatch``): the output and the
    split-K workspace, no launch."""
    dispatch.refuse_grad("int4_matmul", x, scale, zero)
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
    if not dispatch.on_one_cuda_device(x, packed, scale, zero):
        raise ValueError("int4_matmul: the kernel takes CUDA tensors on one device")
    if x.dtype not in (torch.float32, torch.bfloat16) or packed.dtype != torch.uint8 \
            or scale.dtype != torch.float32 or zero.dtype != torch.float32:
        raise TypeError(f"int4_matmul: dtypes x {x.dtype}, packed {packed.dtype}, "
                        f"scale {scale.dtype}, zero {zero.dtype} (want x fp32 or "
                        "bf16, packed uint8, scale/zero fp32)")
    if not all(t.is_contiguous() for t in (x, packed, scale, zero)):
        raise ValueError("int4_matmul: the kernel takes contiguous tensors")
    fake = dispatch.is_fake(x)
    ptrs = () if fake else (x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                            zero.data_ptr())
    which = route(M, K, N, group, x.dtype, ptrs, force_route)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if fake:  # the shape function: the output and the split-K workspace, no launch
        n = fake_splits(which, M, K, N, group) if which != "fma" else 1
        if n > 1:
            torch.empty((n, M, N), dtype=torch.float32, device=x.device)
        dispatch.count_fake("int4_matmul", which, operations(M, K, N), sum(
            t.numel() * t.element_size() for t in (x, packed, scale, zero, out)))
        return out
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if which != "fma":  # split-K: an fp32 workspace for the ordered reduction
        n = splits(which, M, K, N, group)
        ws = (torch.empty((n, M, N), dtype=torch.float32, device=x.device)
              if n > 1 else None)
        rc = _build.entry(_ENTRIES[which, x.dtype], _FAST_ARGS)(
            *ptrs, out.data_ptr(), ws.data_ptr() if ws is not None else None,
            M, K, N, group, stream)
    else:
        rc = _build.entry(_ENTRIES[which, x.dtype], _ARGS)(
            *ptrs, out.data_ptr(), M, K, N, group, stream)
    _build.check(rc, f"int4_matmul ({which})")
    dispatch.count_launch("int4_matmul", which)
    return out
