"""Dispatching wrapper for the Mamba2 SSD chunked scan: a Hopper kernel for
a CUDA tensor, the plain chunked form (``ref.ssd_chunked``) for a CPU
tensor (see ``kernels/dispatch.py``). Two kernels, chosen by :func:`route`:

  tc  — bf16 with 16-byte aligned pointers: chunk-parallel, on tensor
        cores, in two launches (each chunk's own state, then the state pass
        across chunks by the last block of each (b, h); each chunk's output;
        ``csrc/ssd_scan_tc.cu``);
  fma — everything else (fp32): one block per (b, h) walking the chunks
        on CUDA cores (``csrc/ssd_scan.cu``).

A call is one op launch in ``dispatch.LAUNCHES`` whatever the number of
kernels it starts. Unlike the JAX wrapper, which halves the chunk until
it divides T, the kernels mask the T tail."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build, dispatch
from .ref import ssd_chunked

ROUTES = ("tc", "fma")
_ENTRIES = {("fma", torch.float32): "ssd_scan_f32", ("fma", torch.bfloat16): "ssd_scan_bf16",
            ("tc", torch.bfloat16): "ssd_scan_bf16_tc"}
# (head_dim P, d_state N) pairs the kernel is instantiated for: the smoke
# configs, zamba2-7b and mamba2-130m
SHAPES = ((32, 16), (64, 64), (64, 128))
MAX_CHUNK = 128
_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_TC_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def route(dtype: torch.dtype, ptrs=(), force: Optional[str] = None) -> str:
    """The kernel for inputs x/Bm/Cm in ``dtype`` with data pointers
    ``ptrs``: bf16 with 16-byte aligned pointers (every (P, N) of
    ``SHAPES`` gives 16-byte rows) runs chunk-parallel on tensor cores,
    "tc"; anything else the CUDA-core kernel, "fma". ``force`` names a
    route to take instead; it raises where that route cannot take the
    call, as does a dtype no kernel takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd: dtype {dtype} (want fp32 or bf16)")
    which = "tc" if dtype == torch.bfloat16 and all(p % 16 == 0 for p in ptrs) else "fma"
    if force is None:
        return which
    if force not in ROUTES:
        raise ValueError(f"ssd: route {force!r} not in {ROUTES}")
    if force == "tc" and which != "tc":
        raise ValueError(f"ssd: route 'tc' does not take {dtype} at pointers "
                         f"{[hex(p) for p in ptrs]}")
    return force


def ssd(x, dt, A, Bm, Cm, *, init=None, D=None, chunk: int = 128,
        backend: Optional[str] = None):
    """x (B,T,H,P), dt (B,T,H), A (H,), Bm/Cm (B,T,N) shared or (B,T,G,N)
    per group, ``init`` (B,H,P,N) optional initial state, ``D`` (H,)
    optional skip (y += D x in fp32 before y is rounded)
    -> (y in x's dtype, final state fp32)."""
    if not dispatch.use_kernel("ssd_scan", backend, x.device):
        y, fin = ssd_chunked(x, dt, A, Bm, Cm, chunk, init)
        if D is not None:
            y = y + D.float()[None, None, :, None] * x.float()
        return y.to(x.dtype), fin
    return ssd_hopper(x, dt, A, Bm, Cm, init, D=D, chunk=chunk)


def operations(B: int, T: int, H: int, P: int, N: int, G: int, chunk: int) -> float:
    """The kernel's operation count, its bound's: the chunked algorithm, C Bᵀ
    once per group and P-wide products with each chunk's causal half, and
    the state's two (P, N) products per row."""
    rows = [min(chunk, T - c) for c in range(0, T, chunk)]
    tri = sum(r * (r + 1) // 2 for r in rows)
    return 2.0 * (B * G * tri * N + B * H * tri * P + 2 * B * H * T * P * N)


def ssd_hopper(x, dt, A, Bm, Cm, init=None, *, D=None, chunk: int = 128,
               force_route: Optional[str] = None):
    """Launch the Hopper kernel that :func:`route` picks, or
    ``force_route`` (to time one route against another; a route that
    cannot take the inputs raises, as does anything no kernel takes). The
    chunk is min(chunk, T) rows; the last chunk's tail is masked. Fake
    tensors take the shape function (``dispatch``): the outputs and, on
    "tc", the state workspace, no launch."""
    dispatch.refuse_grad("ssd_scan", x, dt, A, Bm, Cm, init, D)
    if Bm.dim() == 3:  # shared across heads == one group
        Bm, Cm = Bm.unsqueeze(2), Cm.unsqueeze(2)
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd: want x (B,T,H,P), Bm/Cm (B,T,G,N); got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}")
    B, T, H, P = x.shape
    G, N = Bm.shape[-2:]
    if Bm.shape[:2] != (B, T) or Cm.shape != Bm.shape or dt.shape != (B, T, H) \
            or A.shape != (H,) or H % G:
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, Bm {tuple(Bm.shape)}, "
                         f"Cm {tuple(Cm.shape)} do not fit")
    if init is not None and init.shape != (B, H, P, N):
        raise ValueError(f"ssd: init {tuple(init.shape)}, want {(B, H, P, N)}")
    if D is not None and D.shape != (H,):
        raise ValueError(f"ssd: D {tuple(D.shape)}, want {(H,)}")
    if (P, N) not in SHAPES:
        raise ValueError(f"ssd: (head_dim, d_state) {(P, N)} not in {SHAPES}")
    if chunk < 1:
        raise ValueError(f"ssd: chunk {chunk} must be positive")
    L = min(chunk, T)
    if L > MAX_CHUNK:
        raise ValueError(f"ssd: chunk {L} above {MAX_CHUNK}")
    fp32 = [dt, A] + [t for t in (init, D) if t is not None]
    tensors = [x, Bm, Cm] + fp32
    if not dispatch.on_one_cuda_device(*tensors):
        raise ValueError("ssd: the kernel takes CUDA tensors on one device")
    if x.dtype not in (torch.float32, torch.bfloat16) or Bm.dtype != x.dtype or Cm.dtype != x.dtype \
            or any(t.dtype != torch.float32 for t in fp32):
        raise TypeError(f"ssd: dtypes x {x.dtype}, Bm {Bm.dtype}, Cm {Cm.dtype}, "
                        f"dt/A/init/D {[t.dtype for t in fp32]} (want x/Bm/Cm fp32 "
                        "or bf16, dt/A/init/D fp32)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd: the kernel takes contiguous tensors")
    fake = dispatch.is_fake(x)
    which = route(x.dtype, () if fake else [t.data_ptr() for t in tensors], force_route)
    y = torch.empty_like(x)
    fin = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if fake:  # the shape function: outputs and workspace, no launch
        if which == "tc":  # alive together, as during the launch
            nc = -(-T // L)
            ws = (torch.empty((B, nc, H, P, N), dtype=torch.float32, device=x.device),
                  torch.empty((B, nc, H), dtype=torch.float32, device=x.device),
                  torch.empty((B, H), dtype=torch.int32, device=x.device))
            del ws
        dispatch.count_fake("ssd_scan", which, operations(B, T, H, P, N, G, L),
                            sum(t.numel() * t.element_size() for t in tensors + [y, fin]))
        return y, fin
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            init.data_ptr() if init is not None else None,
            D.data_ptr() if D is not None else None, y.data_ptr(), fin.data_ptr()]
    if which == "tc":  # each chunk's state, then the state entering it; decays;
        # the count of each (b, h)'s chunk blocks done
        nc = -(-T // L)
        st = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=x.device)
        dec = torch.empty((B, nc, H), dtype=torch.float32, device=x.device)
        arrived = torch.zeros((B, H), dtype=torch.int32, device=x.device)
        rc = _build.entry(_ENTRIES[which, x.dtype], _TC_ARGS)(
            *ptrs, st.data_ptr(), dec.data_ptr(), arrived.data_ptr(), B, T, H, G, P, N, L,
            stream)
    else:
        rc = _build.entry(_ENTRIES[which, x.dtype], _ARGS)(
            *ptrs, B, T, H, G, P, N, L, stream)
    _build.check(rc, f"ssd_scan ({which})")
    dispatch.count_launch("ssd_scan", which)
    return y, fin
