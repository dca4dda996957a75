"""Plain PyTorch version of causal GQA attention (counterpart of
``repro/kernels/flash_attn/ref.py::attention_ref``): materialized scores,
softcap and sliding window."""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(q, k, v, *, softcap: Optional[float] = None,
                  window: Optional[int] = None):
    """q (B,T,Hkv,G,hd); k/v (B,S,Hkv,hd) -> (B,T,Hkv,G,hd)."""
    B, T, Hkv, G, hd = q.shape
    S = k.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * hd**-0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(T, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = kp <= qp
    if window is not None:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.to(q.dtype)
