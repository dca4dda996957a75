"""Always-resident "little" experts: low-rank distillates of every
offloaded expert (MoBiLE-style big/little tier; counterpart of
``repro/core/little_expert.py``).

When the big expert is unavailable (the request is under deadline
pressure, or its quality dial sends the miss to the little tier), the
engine substitutes a rank-``r`` truncation of the *effective* expert
weights (base projection + the layer's folded LoRA delta, so a
fine-tuned model degrades toward its fine-tuned behavior, not the base
model's). One little bank per MoE layer lives on the device
permanently; at rank 8 it is ~``r * (d + f) / (d * f)`` of a full
expert per projection, small enough that the bank never competes with
the resident slab for capacity.

The truncation is the reference's (``left = U_r S_r``, ``right =
V_r^T`` of the SVD, fp32 factors), computed on the bank's device from
an fp64 symmetric eigendecomposition of the smaller Gram matrix of each
weight: ``W^T W`` gives ``V_r`` and ``left = W V_r``; where ``W`` is
wider than tall, ``W W^T`` gives ``U_r`` and ``right = U_r^T W / s``.
(A batched SVD of the full matrices, as the reference runs on the host
with numpy, costs minutes per layer at OLMoE's width on the card; the
Gram route is the same truncation up to the signs of the singular
vectors, which cancel in ``left @ right``.)

Optionally the left factors (the large ones, ``(din, r)``) are stored
HQQ-INT4 (``quantized=True``: the codes of ``left^T``, groups of
``quant_group`` along ``din``, kept in the matmul layout) and
dequantized per use by the plain ``dequant_ref``; the small ``(r, dout)``
right factors stay fp32.

The combine matches the reference's: gate-massed fp32 accumulation per
substituted expert, so a degraded step differs from the exact step only
by the low-rank weight approximation. The reference loops over the
substituted experts; here their factors are gathered and the products
batched over them, so the fp32 sum over experts runs in another order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from ..kernels.int4_matmul.ops import MatmulQWeight
from ..kernels.int4_matmul.ref import dequant_ref
from ..models.common import silu
from ..models.runtime import resolve_device
from .quant import matmul_layout, quantize_linear

_PROJS = ("wg", "wu", "wd")


def truncate(w: torch.Tensor, rank: int):
    """Rank-``rank`` truncation of the SVD of each (din, dout) matrix of
    ``w`` (E, din, dout): (left (E, din, r) = U_r S_r, right (E, r, dout)
    = V_r^T), fp32, from an fp64 eigendecomposition of the smaller Gram
    matrix (singular values in descending order)."""
    w64 = w.double()
    din, dout = w.shape[-2:]
    r = min(rank, din, dout)
    if dout <= din:
        _, v = torch.linalg.eigh(w64.transpose(-1, -2) @ w64)
        vr = v[..., -r:].flip(-1)  # (E, dout, r), eigenvalues ascending
        return (w64 @ vr).float(), vr.transpose(-1, -2).float()
    lam, u = torch.linalg.eigh(w64 @ w64.transpose(-1, -2))
    ur = u[..., -r:].flip(-1)  # (E, din, r)
    s = lam[..., -r:].flip(-1).clamp_min(0).sqrt()
    # where s == 0 the left column is 0 and the right row is immaterial
    right = (ur.transpose(-1, -2) @ w64) / torch.where(s > 0, s, 1.0)[..., None]
    return (ur * s[..., None, :]).float(), right.float()


class LittleExpertBank:
    """Per-MoE-layer stacked low-rank factors for every expert.

    ``expert_weights``: per MoE layer ``{wg/wu/wd: (E, din, dout)}`` of the
    experts' weights (any device and floating type; the engine's host
    store). ``lora``: optional per-layer LoRA trees (``{"wu": {"a", "b"},
    ...}`` with leaves ``(E, din, r)`` / ``(E, r, dout)``) folded into the
    distillate at build time. The build runs on ``device``."""

    def __init__(self, expert_weights: List[Dict[str, torch.Tensor]], *,
                 rank: int = 8, lora: Optional[List] = None,
                 lora_scale: float = 1.0, quantized: bool = False,
                 quant_group: int = 32, device=None):
        self.device = resolve_device(device)
        factors = []
        for moe_idx, arrs in enumerate(expert_weights):
            ll = lora[moe_idx] if lora is not None else None
            layer = {}
            for k in _PROJS:
                w = arrs[k].to(self.device, torch.float32)  # (E, din, dout)
                if ll is not None and k in ll:
                    a = ll[k]["a"].to(self.device, torch.float32)
                    b = ll[k]["b"].to(self.device, torch.float32)
                    w = w + lora_scale * torch.bmm(a, b)
                left, right = truncate(w, rank)
                del w
                if quantized:
                    # groups along the contraction axis din (which must be a
                    # multiple of quant_group, as on the INT4 resident path)
                    left = matmul_layout(quantize_linear(left, group=quant_group,
                                                         iters=4))
                layer[k] = (left, right)
            factors.append(layer)
        self._init_factors(factors, rank, quantized)

    @classmethod
    def from_factors(cls, factors: List[Dict[str, tuple]], *, rank: int,
                     quantized: bool, device=None) -> "LittleExpertBank":
        """A bank of given factors: per layer ``{k: (left, right)}``, left
        ``(E, din, r)`` fp32 or, ``quantized``, a ``MatmulQWeight`` of
        ``(E, ...)`` leaves (``bridge.little_bank_from_jax``)."""
        bank = cls.__new__(cls)
        bank.device = resolve_device(device)
        dev = bank.device
        moved = [{k: (MatmulQWeight(left.packed.to(dev), left.scale.to(dev),
                                    left.zero.to(dev), left.group) if quantized
                      else left.to(dev, torch.float32), right.to(dev, torch.float32))
                  for k, (left, right) in layer.items()} for layer in factors]
        bank._init_factors(moved, rank, quantized)
        return bank

    def _init_factors(self, factors, rank: int, quantized: bool) -> None:
        self.rank = rank
        self.quantized = quantized
        self.n_layers = len(factors)
        self.substitutions = 0  # expert-substitution events served
        # per layer: {proj: (left (E, din, r) | MatmulQWeight, right (E, r, dout))}
        self.factors = factors
        self.device_bytes = 0
        for layer in factors:
            for left, right in layer.values():
                parts = (left.packed, left.scale, left.zero) if quantized else (left,)
                self.device_bytes += sum(t.nbytes for t in parts) + right.nbytes

    def bytes_per_layer(self) -> int:
        return self.device_bytes // max(self.n_layers, 1)

    def _left(self, moe_idx: int, k: str, idx: torch.Tensor) -> torch.Tensor:
        """The left factors (n, din, r) fp32 of the experts ``idx``."""
        left = self.factors[moe_idx][k][0]
        if self.quantized:
            return dequant_ref(left.packed[idx], left.scale[idx], left.zero[idx],
                               left.group)
        return left[idx]

    def expert_weights(self, moe_idx: int, e: int) -> Dict[str, torch.Tensor]:
        """Reconstructed (din, dout) low-rank weights of one expert: the
        test/debug view of what a substitution computes with."""
        idx = torch.tensor([e], device=self.device)
        return {k: (self._left(moe_idx, k, idx) @ self.factors[moe_idx][k][1][idx])[0]
                for k in _PROJS}

    def contrib(self, moe_idx: int, h2f, gates, eids, expert_ids: Sequence[int], *,
                lora=None, lora_scale=1.0) -> torch.Tensor:
        """Gate-massed fp32 contribution (N, d) of the little experts for
        ``expert_ids``: the degraded-mode replacement for the big
        experts' grouped compute. ``lora`` is accepted for signature
        parity with the reference but ignored: the bank already folded
        the LoRA delta at build time."""
        del lora, lora_scale
        idx = torch.as_tensor(list(expert_ids), dtype=torch.long, device=self.device)
        facs = self.factors[moe_idx]
        h = h2f.float()

        def proj(x, k):  # (.., N, din) -> (n, N, dout) through the rank-r pair
            return (x @ self._left(moe_idx, k, idx)) @ facs[k][1][idx]

        h_act = silu(proj(h, "wg")) * proj(h, "wu")
        ye = proj(h_act, "wd")  # (n, N, d)
        # gate mass per (token, expert): an expert appears at most once in a
        # token's top-k, so this is the reference's where(eids == e, gates, 0).sum(-1)
        E = facs["wd"][1].shape[0]
        mass = torch.zeros((h.shape[0], E), dtype=torch.float32, device=h.device)
        mass.scatter_add_(1, eids.long(), gates.float())
        self.substitutions += len(expert_ids)
        return torch.einsum("nNd,Nn->Nd", ye, mass[:, idx])
