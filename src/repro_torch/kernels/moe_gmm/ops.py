"""Dispatching wrapper for the grouped expert matmul: a Hopper kernel for
a CUDA tensor, the plain version for a CPU tensor (see
``kernels/dispatch.py``). Three kernels, chosen by :func:`route`:

  stream — bf16, M <= 16 (decode): split-K weight stream on tensor cores
           (``csrc/gmm_tc.cu``);
  tc     — bf16, M > 16 (prefill): 128 x 128 tensor-core tiles
           (``csrc/gmm_tc.cu``);
  fma    — everything else (fp32, unaligned widths or pointers): the
           CUDA-core kernel (``csrc/gmm.cu``).

Under grad, :class:`GmmFn` carries the kernel's gradient: its backward
launches the same kernels for ``dA = dY Bᵀ`` (with the group sizes) and
``dB = Aᵀ dY``, each only where autograd asks for it."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build, dispatch
from .ref import gmm_ref

ROUTES = ("stream", "tc", "fma")
_ENTRIES = {("fma", torch.float32): "moe_gmm_f32", ("fma", torch.bfloat16): "moe_gmm_bf16",
            ("tc", torch.bfloat16): "moe_gmm_bf16_tc",
            ("stream", torch.bfloat16): "moe_gmm_bf16_stream"}
STREAM_MAX_M = 16  # the decode rows, padded to one m16 tile
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def gmm(a: torch.Tensor, b: torch.Tensor,
        group_sizes: Optional[torch.Tensor] = None, *,
        backend: Optional[str] = None) -> torch.Tensor:
    """a (E, M, K) @ b (E, K, N) -> (E, M, N).

    ``group_sizes`` (E,): valid rows per group; rows past the count must
    already be zero in ``a`` (slot-dispatch buffers guarantee it). The
    kernel then skips every M-tile past the count without reading the
    group's weights; the plain version needs no such skip. Under grad
    mode, with an input that requires grad, the kernel runs through
    :class:`GmmFn`; otherwise it saves nothing for a backward."""
    if not dispatch.use_kernel("moe_gmm", backend, a.device):
        return gmm_ref(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return GmmFn.apply(a, b, group_sizes)
    return gmm_hopper(a, b, group_sizes)


class GmmFn(torch.autograd.Function):
    """``gmm_hopper`` with a gradient, by the same Hopper kernels:

      dA = gmm_hopper(dY, Bᵀ, group_sizes)  (E, M, K)
      dB = gmm_hopper(Aᵀ, dY)               (E, K, N), no group sizes

    each launched only where ``ctx.needs_input_grad`` asks. Rows of dA
    past a group's count come out zero: they belong to dispatch slots that
    no token owns, whose gradient the dispatch discards. dB needs no group
    sizes: the rows of A past the count are zero. The transposes are
    contiguous copies (one of B per dA, one of A per dB). Each backward
    launch also counts in ``dispatch.GRAD_LAUNCHES["moe_gmm"]`` by
    product. The plain version under autograd is ``gmm_ref``."""

    @staticmethod
    def forward(ctx, a, b, group_sizes):
        need_a, need_b = ctx.needs_input_grad[:2]
        ctx.save_for_backward(a if need_b else None, b if need_a else None, group_sizes)
        return gmm_hopper(a, b, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        a, b, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        da = db = None
        real = not dispatch.is_fake(dy)
        if ctx.needs_input_grad[0]:
            da = gmm_hopper(dy, b.transpose(1, 2).contiguous(), group_sizes)
            if real:
                dispatch.count_grad("moe_gmm", "dA")
        if ctx.needs_input_grad[1]:
            db = gmm_hopper(a.transpose(1, 2).contiguous(), dy)
            if real:
                dispatch.count_grad("moe_gmm", "dB")
        return da, db, None


def route(M: int, K: int, N: int, dtype: torch.dtype, ptrs=(),
          force: Optional[str] = None) -> str:
    """The kernel for a (E, M, K) @ b (E, K, N) in ``dtype`` whose data
    pointers are ``ptrs``: bf16 with 16-byte aligned pointers and rows (K
    and N multiples of 8) runs on tensor cores, "stream" up to
    ``STREAM_MAX_M`` rows and "tc" above; anything else on the CUDA-core
    kernel, "fma". ``force`` names a route to take instead (to time one
    against another); it raises where that route cannot take the call,
    as does a dtype no kernel takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gmm: dtype {dtype} (want fp32 or bf16)")
    tensor_cores = dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 \
        and all(p % 16 == 0 for p in ptrs)
    if force is None:
        if not tensor_cores:
            return "fma"
        return "stream" if M <= STREAM_MAX_M else "tc"
    if force not in ROUTES:
        raise ValueError(f"gmm: route {force!r} not in {ROUTES}")
    if force != "fma" and not (tensor_cores and (force == "tc" or M <= STREAM_MAX_M)):
        raise ValueError(f"gmm: route {force!r} does not take {dtype} M={M} K={K} "
                         f"N={N} at pointers {[hex(p) for p in ptrs]}")
    return force


def operations(E: int, M: int, K: int, N: int, rows: Optional[int] = None) -> float:
    """The kernel's operation count, its bound's: 2 K N per row it
    multiplies, ``rows`` of the E x M (the group sizes' sum; all of them
    where the sizes are not known)."""
    return 2.0 * (E * M if rows is None else rows) * K * N


def gmm_hopper(a: torch.Tensor, b: torch.Tensor,
               group_sizes: Optional[torch.Tensor] = None, *,
               force_route: Optional[str] = None) -> torch.Tensor:
    """Launch the Hopper kernel that :func:`route` picks, or
    ``force_route`` (to time one route against another; a route that
    cannot take the inputs raises). The output has no gradient: under
    grad, with an input that requires it, this raises (:func:`gmm` takes
    :class:`GmmFn` there). Fake tensors take the shape function
    (``dispatch``): the output and the group sizes' int32 copy, no
    launch."""
    dispatch.refuse_grad("moe_gmm", a, b)
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"gmm: want a (E,M,K), b (E,K,N); got {a.shape}, {b.shape}")
    E, M, K = a.shape
    if b.shape[:2] != (E, K):
        raise ValueError(f"gmm: shape mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (dispatch.on_card(a) and b.device == a.device):
        raise ValueError("gmm: the kernel takes CUDA tensors on one device")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise TypeError(f"gmm: dtypes {a.dtype}, {b.dtype} (want fp32 or bf16, equal)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gmm: the kernel takes contiguous a and b")
    N = b.shape[2]
    fake = dispatch.is_fake(a)
    which = route(M, K, N, a.dtype, () if fake else (a.data_ptr(), b.data_ptr()), force_route)
    sizes_ptr = None
    if group_sizes is not None:
        group_sizes = group_sizes.to(device=a.device, dtype=torch.int32).contiguous()
        if group_sizes.shape != (E,):
            raise ValueError(f"gmm: group_sizes {tuple(group_sizes.shape)} != ({E},)")
        sizes_ptr = None if fake else group_sizes.data_ptr()
    out = torch.empty((E, M, N), dtype=a.dtype, device=a.device)
    if fake:  # the shape function: every row counts (a fake tensor's sizes have no values)
        dispatch.count_fake("moe_gmm", which, operations(E, M, K, N),
                            (a.numel() + b.numel() + out.numel()) * a.element_size())
        return out
    if out.numel() == 0:
        return out
    fn = _build.entry(_ENTRIES[which, a.dtype], _ARGS)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), sizes_ptr,
                    E, M, K, N, stream), f"moe_gmm ({which})")
    dispatch.count_launch("moe_gmm", which)
    return out
