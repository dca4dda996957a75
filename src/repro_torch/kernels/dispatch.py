"""Per-op kernel-backend resolution for the port.

Every op resolves a spec string ``"ref" | "hopper" | "auto"``, optionally
per op (``"auto,flash_attn=ref"``). The environment variable
``REPRO_TORCH_KERNEL_BACKEND`` merges over the caller's spec per key.

Resolution against the tensor the op is given:

  * ``auto``   -> the Hopper kernel for a CUDA tensor, the plain PyTorch
                  version for a CPU tensor;
  * ``hopper`` -> the same, except that a CPU tensor raises;
  * ``ref``    -> the plain version on any device (on a CUDA tensor only
                  as an explicit request, e.g. to compare with the kernel).

Each wrapper counts its kernel launches in :data:`LAUNCHES`, one per
launch and nowhere else, so a run can show that its path went through
the kernels. Every op has more than one kernel (bf16 tensor-core or
streaming routes beside the CUDA-core one, "fma"), and each launch also
counts under its route in :data:`ROUTE_LAUNCHES`, so a shape that leaves
the fast route does so visibly. A call that starts several kernels
(``ssd_scan`` "tc", ``int4_matmul`` "stream" with its split reduction)
counts once. Launches made by a backward pass (``moe_gmm``'s
``GmmFn``) count there like any other, and again, by the product they
compute, in :data:`GRAD_LAUNCHES`.

A kernel wrapper never returns a tensor that drops a gradient: under
grad mode, with an input that requires grad, it either has a backward
(``moe_gmm``) or raises (:func:`refuse_grad`).

Observability (the reference's ``kernel_dispatch_total`` tap): while a
tracer is enabled every launch also records a ``kernel.dispatch``
instant, and :func:`publish` puts the launch counts on a metrics
registry as ``kernel_dispatch_total{op, backend="hopper", route}``. The
reference counts its selections once per compilation, inside
``resolve()``; the port selects per eager call, so its counter follows
the launches, read at publish time: no registry work on the launch path.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..obs.trace import get_tracer

# Every kernel family of the repo; unknown names are an error.
OPS = ("flash_attn", "int4_matmul", "moe_gmm", "ssd_scan")

BACKENDS = ("ref", "hopper", "auto")

ENV_VAR = "REPRO_TORCH_KERNEL_BACKEND"

# kernel launches per op, and per op and route, since the last
# reset_launches()
LAUNCHES = {op: 0 for op in OPS}
ROUTE_LAUNCHES: dict = {op: {} for op in OPS}
# launches of a backward pass per op and product ("dA", "dB"), a breakdown
# of LAUNCHES
GRAD_LAUNCHES: dict = {op: {} for op in OPS}


def count_launch(op: str, route: Optional[str] = None) -> None:
    LAUNCHES[op] += 1
    if route is not None:
        ROUTE_LAUNCHES[op][route] = ROUTE_LAUNCHES[op].get(route, 0) + 1
    tr = get_tracer()
    if tr.enabled:
        tr.instant("kernel.dispatch", op=op, backend="hopper", route=route)


def publish(registry=None) -> None:
    """Launch counts per op and route since the last
    :func:`reset_launches` as ``kernel_dispatch_total`` counters (the
    global registry by default); each counter is set to its count."""
    if registry is None:
        from ..obs.registry import REGISTRY as registry
    for op, routes in ROUTE_LAUNCHES.items():
        for route, n in routes.items():
            registry.counter("kernel_dispatch_total", "Hopper kernel launches by op and route",
                             op=op, backend="hopper", route=route).value = float(n)


def count_grad(op: str, product: str) -> None:
    GRAD_LAUNCHES[op][product] = GRAD_LAUNCHES[op].get(product, 0) + 1


def refuse_grad(op: str, *tensors) -> None:
    """Raise where a kernel without a backward would be launched on an
    input that requires grad under grad mode: its output would carry no
    ``grad_fn`` and every gradient through it would be lost without an
    error. Run such an op through its plain version (``op=ref`` in the
    backend spec) or under ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op}: the Hopper kernel has no backward, and an input requires grad; "
            f"name the plain version in the backend spec (e.g. 'auto,{op}=ref') or "
            f"run under torch.no_grad()")


def on_one_cuda_device(*tensors) -> bool:
    """True when every tensor lies on one CUDA device (what a kernel
    wrapper asks before it launches)."""
    dev = tensors[0].device
    return dev.type == "cuda" and all(t.device == dev for t in tensors)


def route_snapshot() -> dict:
    """{op: {route: launches}} as they stand (a copy)."""
    return {op: dict(r) for op, r in ROUTE_LAUNCHES.items()}


def route_delta(before: dict, after: dict) -> dict:
    """Launches per op and route between two :func:`route_snapshot` s
    (routes that did not launch left out)."""
    return {op: {r: n - before[op].get(r, 0) for r, n in after[op].items()
                 if n != before[op].get(r, 0)} for op in after}


def reset_launches() -> None:
    for op in LAUNCHES:
        LAUNCHES[op] = 0
        ROUTE_LAUNCHES[op].clear()
        GRAD_LAUNCHES[op].clear()


def parse_spec(spec: Optional[str]) -> dict:
    """``"auto"`` / ``"ref,moe_gmm=hopper"`` -> {"*": ..., op: ...}.

    A bare backend name sets the global default ("*"); ``op=backend``
    entries override per op. Unknown ops/backends raise."""
    out: dict = {}
    if not spec:
        return out
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            op, _, backend = part.partition("=")
            op, backend = op.strip(), backend.strip()
            if op not in OPS:
                raise ValueError(f"unknown kernel op {op!r} (known: {OPS})")
        else:
            op, backend = "*", part
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown kernel backend {backend!r} (known: {BACKENDS})")
        out[op] = backend
    return out


def op_backend(op: str, spec: Optional[str]) -> str:
    """The configured backend for ``op`` under ``spec`` after the env
    override (env entries win per key; default "auto")."""
    if op not in OPS:
        raise ValueError(f"unknown kernel op {op!r} (known: {OPS})")
    table = parse_spec(spec)
    env = os.environ.get(ENV_VAR)
    if env:
        table.update(parse_spec(env))
    return table.get(op, table.get("*", "auto"))


def use_kernel(op: str, spec: Optional[str], device) -> bool:
    """True when ``op`` must launch its Hopper kernel for a tensor on
    ``device``; False for the plain version. ``hopper`` on a CPU tensor
    raises — there is no quiet fallback."""
    backend = op_backend(op, spec)
    if backend == "ref":
        return False
    on_cuda = getattr(device, "type", device) == "cuda"
    if backend == "hopper" and not on_cuda:
        raise RuntimeError(
            f"{op}: backend 'hopper' needs a CUDA tensor, got one on {device}")
    return on_cuda
