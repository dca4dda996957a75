"""Runtime context threaded through model code (counterpart of
``repro/models/runtime.py``).

With ``mesh=None`` everything is plain local torch on one device (the
offload engine, the smoke tests). With a mesh of more than one device the
model runs on DTensors: parameters placed by ``distributed.sharding``
(``distribute_params``), inputs sharded over the data axes, ``constrain``
a ``redistribute`` to the reference's spec, and the MoE layer expert
parallel over the ``"model"`` axis (``moe.apply_moe_sharded``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (``launch/mesh.py``)
or an :class:`AbstractMesh`, names and sizes only, on which the specs of
any mesh size can be computed without its processes. A spec is a tuple of
entries, one per tensor dim: ``None``, an axis name, or a tuple of axis
names (the reference's ``PartitionSpec``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..kernels import dispatch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for (explicitly or
    by default) and is missing: there is no quiet CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on "
                           "the CPU")
    return dev


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes without devices or processes (the
    reference's ``jax.sharding.AbstractMesh``), read like a
    ``DeviceMesh``: ``mesh_dim_names``, ``shape``, ``size()``."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def is_distributed(t) -> bool:
    """True for a DTensor (the sharded model path's tensors)."""
    if not isinstance(t, torch.Tensor) or type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def on_rows(fn, *ts):
    """``fn(*ts)`` -> scalars, each a mean over equal parts of the batch
    (dim 0), computed on DTensor inputs rank by rank: each rank takes its
    own rows (the inputs sharded over dim 0 as the first is, replicated on
    every other mesh dim, so an input split along another dim is gathered
    whole), ``fn`` on the local tensors, and each scalar placed back as the
    mean of the ranks' means (a per-row vector of the local mean, sharded
    as the rows, averaged). ``None`` inputs pass through. It is for the
    batch's small per-row losses, the MELINOE layer losses on the (B, T, E)
    router outputs (``core.losses.melinoe_layer_losses``), rather than
    DTensor's strategies for their scans, slices and gathers, which differ
    by torch release. The next-token NLL on the vocab-split logits keeps
    its split instead (``core.losses.nll_loss_on_mesh``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    first = next(t for t in ts if t is not None)
    mesh = first.device_mesh
    rows = tuple(p if p == Shard(0) else Replicate() for p in first.placements)
    loc = [None if t is None else t.redistribute(mesh, rows).to_local() for t in ts]
    n = loc[0].shape[0]
    outs = fn(*loc)
    single = not isinstance(outs, tuple)
    placed = tuple(DTensor.from_local(o.reshape(1).repeat(n), mesh, rows, run_check=False).mean()
                   for o in ((outs,) if single else outs))
    return placed[0] if single else placed


@dataclass(frozen=True)
class Runtime:
    kernel_backend: str = "auto"  # "ref" | "hopper" | "auto", optionally per
    # op ("auto,flash_attn=ref"); REPRO_TORCH_KERNEL_BACKEND overrides it
    device: torch.device = torch.device("cpu")
    zero_drop: bool = False  # MoE capacity large enough for zero token drops
    mesh: Optional[Any] = None  # DeviceMesh or AbstractMesh; None: one device
    profile: str = "tp"  # "tp" (TP/FSDP hybrid) | "pure_fsdp" (no tensor
    # parallelism; batch and weights sharded over every mesh axis)

    @property
    def backend(self) -> str:
        """The spec model code on this runtime's tensors hands to a kernel
        wrapper: ``kernel_backend`` on one device; "ref" on a sharded mesh,
        whose tensors are DTensors and a kernel takes one device's (the
        reference's rule). The environment's spec still wins, so a kernel
        asked for there fails loudly on a DTensor rather than go plain.
        Code that runs on one rank's local tensors (the expert-parallel
        body, attention shard by shard) takes :meth:`local`'s."""
        return "ref" if self.sharded else self.kernel_backend

    def kernel_choice(self, op: str) -> bool:
        """True when ``op`` launches its Hopper kernel on this device."""
        return dispatch.use_kernel(op, self.backend, self.device)

    def local(self) -> "Runtime":
        """This runtime on one rank's plain tensors: no mesh, so the kernels
        are chosen as on one device."""
        return Runtime(kernel_backend=self.kernel_backend, device=self.device,
                       zero_drop=self.zero_drop)

    # -- the mesh ----------------------------------------------------------
    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names) if self.mesh is not None else ()

    @property
    def sharded(self) -> bool:
        return self.mesh is not None and self.mesh.size() > 1

    @property
    def data_axes(self) -> Tuple[str, ...]:
        if self.mesh is None:
            return ()
        axes = ("pod", "data", "model") if self.profile == "pure_fsdp" else ("pod", "data")
        return tuple(a for a in axes if a in self.axis_names)

    @property
    def model_axis(self) -> Optional[str]:
        if self.mesh is None or "model" not in self.axis_names:
            return None
        if self.profile == "pure_fsdp":
            return None  # no tensor parallelism; experts stay data-local
        return "model"

    def axis_size(self, names) -> int:
        if self.mesh is None:
            return 1
        if isinstance(names, str):
            names = (names,)
        sizes = dict(zip(self.axis_names, self.mesh.shape))
        n = 1
        for a in names:
            n *= sizes[a]
        return n

    # -- sharding helpers ----------------------------------------------------
    def prune_spec(self, shape, spec) -> tuple:
        """Drop mesh axes that do not evenly divide the corresponding dim
        (``()`` without a mesh): one entry per dim of ``shape``."""
        if self.mesh is None:
            return ()
        spec = tuple(spec)
        out = []
        for dim, entry in zip(shape, spec + (None,) * (len(shape) - len(spec))):
            if entry is None:
                out.append(None)
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            kept, prod = [], 1
            for a in axes:
                if dim % (prod * self.axis_size(a)) == 0:
                    kept.append(a)
                    prod *= self.axis_size(a)
            out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
        return tuple(out)

    def constrain(self, x, *spec_entries):
        """The reference's ``with_sharding_constraint``: ``x`` (a DTensor)
        redistributed to the pruned spec; ``x`` as it is unsharded."""
        if not self.sharded:
            return x
        from ..distributed.sharding import placements

        if not is_distributed(x):
            raise TypeError("Runtime.constrain on a sharded mesh needs a DTensor")
        return x.redistribute(self.mesh, placements(self.prune_spec(x.shape, spec_entries),
                                                    self.mesh))

    def batch_spec_entry(self):
        return self.data_axes if self.data_axes else None

    def dist(self):
        """The context of model code on a sharded mesh: plain tensors that
        meet DTensors (positions, masks, buffers made inside a function)
        count as replicated; a null context otherwise."""
        if not self.sharded:
            return contextlib.nullcontext()
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication

        # torch's context sets the switch off on exit, nested or not: enter
        # it only at the outermost level (a train step's backward runs
        # after its forward's inner contexts have closed)
        if DTensor._op_dispatcher._allow_implicit_replication:
            return contextlib.nullcontext()
        return implicit_replication()
