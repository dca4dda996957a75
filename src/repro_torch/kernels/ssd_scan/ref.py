"""Plain PyTorch versions of the Mamba2 SSD scan: the sequential
recurrence (counterpart of ``repro/kernels/ssd_scan/ref.py::ssd_scan_ref``),
the exact linear-time definition that the chunked kernel must reproduce,
and the chunked dual form (counterpart of
``repro/models/mamba2.py::ssd_chunked``), the model's plain path."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_scan_ref(x, dt, A, Bm, Cm, init=None, *, D=None):
    """Sequential scan. x (B,T,H,P); dt (B,T,H); A (H,);
    Bm/Cm (B,T,N) shared across heads or (B,T,G,N) per group (head h
    uses group h // (H//G)); ``init`` (B,H,P,N) optional state; ``D``
    (H,) optional skip, added in fp32 before y is cast (the kernel's
    fused epilogue; the JAX oracle has no such argument).

    s_t = exp(dt_t A) s_{t-1} + dt_t * x_t B_t^T ;  y_t = s_t C_t (+ D x_t)
    Returns (y (B,T,H,P) in x's dtype, final state (B,H,P,N) fp32)."""
    B, T, H, P = x.shape
    if Bm.dim() == 3:  # shared across heads
        Bm, Cm = Bm[:, :, None], Cm[:, :, None]
    G, N = Bm.shape[-2:]
    hpg = H // G
    Bf = Bm.float().repeat_interleave(hpg, dim=2)  # (B,T,H,N)
    Cf = Cm.float().repeat_interleave(hpg, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    s = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if init is None else init.float())
    ys = []
    for t in range(T):
        dec = torch.exp(dtf[:, t] * Af[None])  # (B,H)
        xdt = xf[:, t] * dtf[:, t, :, None]  # (B,H,P)
        s = s * dec[..., None, None] + xdt[..., :, None] * Bf[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", s, Cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((B, 0, H, P), dtype=torch.float32, device=x.device))
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    return y.to(x.dtype), s


def _segsum(ca):
    """ca (..., cl) cumulative dA within chunk -> decay matrix (..., cl, cl):
    M[i, j] = exp(ca_i - ca_j) for i >= j else 0."""
    diff = ca[..., :, None] - ca[..., None, :]
    cl = ca.shape[-1]
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=ca.device))
    return torch.where(mask, torch.exp(diff), torch.zeros((), device=ca.device))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan, the algorithm of the kernel in plain torch.

    x (B,T,H,P); dt (B,T,H) post-softplus; A (H,) negative;
    Bm/Cm (B,T,N) shared or (B,T,G,N) per group. T is padded to a multiple
    of the chunk with zeros (dt = 0: padded rows add nothing and do not
    decay the state). Returns (y (B,T,H,P) fp32, final_state (B,H,P,N))."""
    if Bm.dim() == 3:  # shared across heads
        Bm, Cm = Bm[:, :, None], Cm[:, :, None]
    Bsz, T, H, Pd = x.shape
    G, N = Bm.shape[-2:]
    hpg = H // G
    cl = min(chunk, T)
    nc = -(-T // cl)
    pad = nc * cl - T
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Tp = nc * cl

    xc = x.reshape(Bsz, nc, cl, H, Pd).float()
    dtc = dt.reshape(Bsz, nc, cl, H).float()
    Bc = Bm.reshape(Bsz, nc, cl, G, N).float()
    Cc = Cm.reshape(Bsz, nc, cl, G, N).float()

    dA = dtc * A[None, None, None, :]  # (B,nc,cl,H)
    ca = torch.cumsum(dA, dim=2)

    # intra-chunk (dual/quadratic) term
    Lmat = _segsum(ca.transpose(2, 3))  # (B,nc,H,cl,cl)
    cb = torch.einsum("bnigs,bnjgs->bngij", Cc, Bc)  # (B,nc,G,cl,cl)
    cb = cb.repeat_interleave(hpg, dim=2)  # (B,nc,H,cl,cl)
    scores = cb * Lmat * dtc.transpose(2, 3)[:, :, :, None, :]
    y_diag = torch.einsum("bnhij,bnjhp->bnihp", scores, xc)

    # per-chunk outgoing state
    decay_out = torch.exp(ca[:, :, -1:, :] - ca)  # (B,nc,cl,H)
    Bh = Bc.repeat_interleave(hpg, dim=3)  # (B,nc,cl,H,N)
    s_loc = torch.einsum("bnchs,bnchp->bnhps", Bh * (decay_out * dtc)[..., None], xc)

    # inter-chunk recurrence
    chunk_decay = torch.exp(ca[:, :, -1, :])  # (B,nc,H)
    s = (torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    s_prev = []
    for c in range(nc):
        s_prev.append(s)  # state entering chunk c
        s = s * chunk_decay[:, c, :, None, None] + s_loc[:, c]
    s_prev = torch.stack(s_prev, dim=1)  # (B,nc,H,P,N)

    # inter-chunk contribution
    Ch = Cc.repeat_interleave(hpg, dim=3)  # (B,nc,cl,H,N)
    y_off = torch.einsum("bnchs,bnhps->bnchp", Ch, s_prev) * torch.exp(ca)[..., None]

    y = (y_diag + y_off).reshape(Bsz, Tp, H, Pd)
    return y[:, :T], s
