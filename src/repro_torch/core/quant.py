"""HQQ-style INT4 group quantization (paper Sec 3.2: resident experts are
kept in HQQ INT4 to raise effective cache capacity). Counterpart of
``repro/core/quant.py``, with the same names.

Weights are quantized per *group* along the last axis (``group``
consecutive elements share a scale and zero-point). The HQQ-lite solver
runs a few proximal iterations on the zero-point under an l_p (p < 1)
sparsity prior on the reconstruction residual. It runs on whatever
device its input lies on.

Packed storage: two int4 codes per uint8 along the grouped axis.

The dequant matmul (:func:`qmatmul`) goes through ``kernels/int4_matmul``:
quantize the *transposed* weight with :func:`quantize_linear` so the
groups lie along the contraction axis, then :func:`matmul_layout`
repacks the identical codes into the kernel's (K//2, N) storage.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels import dispatch
from ..kernels.int4_matmul.ops import MatmulQWeight, int4_matmul


class QTensor(NamedTuple):
    packed: torch.Tensor  # uint8 (..., K//2) two nibbles per byte
    scale: torch.Tensor  # f32 (..., K//group, 1)
    zero: torch.Tensor  # f32 (..., K//group, 1)
    shape: tuple  # original shape
    group: int


def _shrink_lp(x: torch.Tensor, beta: torch.Tensor, p: float) -> torch.Tensor:
    """Proximal operator of the l_p norm (HQQ eq. 4): soft-threshold with
    |x|^(p-1) reweighting."""
    return torch.sign(x) * torch.clamp(x.abs() - x.abs() ** (p - 1.0) / beta, min=0.0)


def quantize(w: torch.Tensor, *, group: int = 64, iters: int = 10, p: float = 0.7,
             beta: float = 10.0) -> QTensor:
    """Quantize along the LAST axis to int4 codes in [0, 15]. ``w`` may
    carry leading batch axes (each group is independent)."""
    orig_shape = tuple(w.shape)
    K = orig_shape[-1]
    if K % group or group % 2:
        raise ValueError(f"quantize: K={K}, group={group}")
    wg = w.float().reshape(*orig_shape[:-1], K // group, group)
    wmin = wg.amin(-1, keepdim=True)
    wmax = wg.amax(-1, keepdim=True)
    scale = torch.clamp((wmax - wmin) / 15.0, min=1e-8)
    zero = -wmin / scale
    beta_t = torch.tensor(beta, dtype=torch.float32, device=w.device)
    for _ in range(iters):
        q = torch.clamp(torch.round(wg / scale + zero), 0, 15)
        e = wg - (q - zero) * scale
        e_s = _shrink_lp(e, beta_t, p)
        zero = torch.mean(q - (wg - e_s) / scale, dim=-1, keepdim=True)
        beta_t = beta_t * 1.01
    q = torch.clamp(torch.round(wg / scale + zero), 0, 15).to(torch.uint8)
    q = q.reshape(*orig_shape[:-1], K)
    packed = q[..., 0::2] | (q[..., 1::2] << 4)
    return QTensor(packed=packed,
                   scale=scale.reshape(*orig_shape[:-1], K // group, 1),
                   zero=zero.reshape(*orig_shape[:-1], K // group, 1),
                   shape=orig_shape, group=group)


def unpack_codes(qt: QTensor) -> torch.Tensor:
    q = torch.stack((qt.packed & 0x0F, qt.packed >> 4), dim=-1)
    return q.reshape(*qt.shape[:-1], qt.shape[-1])


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    q = unpack_codes(qt).float()
    K = qt.shape[-1]
    qg = q.reshape(*qt.shape[:-1], K // qt.group, qt.group)
    w = (qg - qt.zero) * qt.scale
    return w.reshape(qt.shape).to(dtype)


def quant_bytes(qt: QTensor) -> int:
    return int(qt.packed.numel() + 4 * qt.scale.numel() + 4 * qt.zero.numel())


# ---------------------------------------------------------------------------
# Fused dequant matmul (kernels/int4_matmul wiring)
# ---------------------------------------------------------------------------


def quantize_linear(w: torch.Tensor, *, group: int = 64, **hqq_kw) -> QTensor:
    """Quantize a matmul weight w (K, N) for ``y = x @ dequant(w)``: the
    HQQ codes of ``w.T`` (N, K), so the groups run along the contraction
    axis K. A leading batch axis (E, K, N) quantizes E weights at once."""
    if w.dim() not in (2, 3):
        raise ValueError(f"quantize_linear: want (K, N) or (E, K, N), got "
                         f"{tuple(w.shape)}")
    return quantize(w.transpose(-1, -2), group=group, **hqq_kw)


def dequantize_linear(ql: QTensor, dtype=torch.float32) -> torch.Tensor:
    """QTensor from :func:`quantize_linear` -> the original-layout (K, N)."""
    return dequantize(ql, dtype).transpose(-1, -2)


def matmul_layout(ql: QTensor) -> MatmulQWeight:
    """Repack a :func:`quantize_linear` QTensor (codes of w.T, (..., N, K))
    into the kernel storage: packed (..., K//2, N), scale/zero
    (..., K//group, N). Bit-exact: the same int4 codes, transposed and
    repacked."""
    # shape/group may arrive as 0-d arrays (a numpy round trip of a
    # QTensor); force them back to Python ints
    *lead, N, K = (int(s) for s in ql.shape)
    group = int(ql.group)
    q = unpack_codes(ql).transpose(-1, -2)  # (..., K, N) int4 codes
    packed = (q[..., 0::2, :] | (q[..., 1::2, :] << 4)).contiguous()
    scale = ql.scale.reshape(*lead, N, K // group).transpose(-1, -2)
    zero = ql.zero.reshape(*lead, N, K // group).transpose(-1, -2)
    return MatmulQWeight(packed, scale.float().contiguous(),
                         zero.float().contiguous(), group)


def qmatmul(x: torch.Tensor, ql, *, backend: Optional[str] = None) -> torch.Tensor:
    """y = x @ dequant(ql). ``ql``: a QTensor from :func:`quantize_linear`
    or a prepacked ``MatmulQWeight`` (:func:`matmul_layout` once per
    weight, not per call).

    Under the plain backend a QTensor multiplies by its dequantized
    weight, as the JAX "ref" path does; otherwise, and always for a
    ``MatmulQWeight``, the call goes to :func:`int4_matmul`, which
    launches the kernel on a CUDA tensor."""
    if isinstance(ql, QTensor):
        if not dispatch.use_kernel("int4_matmul", backend, x.device):
            return x @ dequantize_linear(ql, torch.float32).to(x.dtype)
        ql = matmul_layout(ql)
    return int4_matmul(x, ql.packed, ql.scale, ql.zero, group=ql.group,
                       backend=backend)


def quant_error(w: torch.Tensor, qt: QTensor) -> float:
    return float((w.float() - dequantize(qt, torch.float32)).abs().mean())
