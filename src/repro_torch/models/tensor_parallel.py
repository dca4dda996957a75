"""Tensor parallelism over a mesh's "model" axis on local tensors: the
c10d collectives inside autograd Functions that carry their transposes,
and the re-lay of a split dim from one layout to another in one
all_to_all. Model code that splits its work over "model" itself, rather
than through DTensor's strategies (``mamba2.apply_mamba_sharded``,
``mlp.apply_mlp_sharded``), takes its weights and activations in through
:func:`enter_weight` and ``redistribute(...).to_local``, computes on its
rank's part, and places its result back with ``DTensor.from_local``.

A collective inside autograd must run on every rank in the backward too:
every result here depends on what its rank sent and received, even where
that is nothing, so that every rank's backward runs the transpose.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch


class AllToAllV(torch.autograd.Function):
    """``all_to_all_single`` of dim-0 blocks of ``send[j]`` rows to rank j
    (``recv[i]`` rows from rank i, in rank order) over ``group``; its
    gradient the reverse exchange."""

    @staticmethod
    def forward(ctx, x, send, recv, group):
        import torch.distributed as dist

        ctx.sizes, ctx.group = (send, recv), group
        out = x.new_empty((sum(recv), *x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), output_split_sizes=list(recv),
                               input_split_sizes=list(send), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        send, recv = ctx.sizes
        return AllToAllV.apply(grad, recv, send, ctx.group), None, None, None


class AllReduce(torch.autograd.Function):
    """The sum over ``group``. Its gradient: where every rank then uses the
    sum alike (a layer's output, replicated over "model"), each rank's
    share is the output's gradient as it is; where each rank uses it for its
    own part (the Mamba norm's sum of squares, for its own channels), the
    gradients of all the parts, summed again."""

    @staticmethod
    def forward(ctx, x, group, parts: bool):
        import torch.distributed as dist

        ctx.group, ctx.parts = group, parts
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        if ctx.parts:
            grad = grad.clone()
            dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


def block_of(n: int, ms: int, m: int) -> tuple:
    """Model rank m's block [lo, hi) of n (heads, channels) over ms ranks:
    contiguous blocks, the first n % ms ranks one more."""
    q, r = divmod(n, ms)
    lo = m * q + min(m, r)
    return lo, lo + q + (m < r)


def stored(n: int, sharded: bool, ms: int) -> tuple:
    """Each model rank's ranges of a dim of n kept split evenly over "model"
    (``sharded``) or whole."""
    c = n // ms
    return tuple(((r * c, (r + 1) * c),) if sharded else ((0, n),) for r in range(ms))


def _offset(ranges, g: int) -> int:
    """Where global index g lies in the concatenation of ``ranges``."""
    off = 0
    for lo, hi in ranges:
        if lo <= g < hi:
            return off + g - lo
        off += hi - lo
    raise ValueError(f"index {g} not in {ranges}")


@functools.lru_cache(maxsize=None)
def _pieces(have: tuple, want: tuple) -> tuple:
    """For every rank j, ``want[j]`` cut into pieces (start, stop, source):
    j itself where it holds the indices, else the lowest rank that does."""
    cuts = sorted({b for rs in have + want for r in rs for b in r})

    def source(j, g):
        for s in (j, *range(len(have))):
            if any(lo <= g < hi for lo, hi in have[s]):
                return s
        raise ValueError(f"no rank holds index {g} (holds {have}; wanted {want})")

    out = []
    for j, rs in enumerate(want):
        pieces = []
        for lo, hi in rs:
            for a, b in zip(cuts, cuts[1:]):
                a, b = max(a, lo), min(b, hi)
                if a >= b:
                    continue
                s = source(j, a)
                if (pieces and pieces[-1][2] == s and pieces[-1][1] == a
                        and _offset(have[s], a) == _offset(have[s], a - 1) + 1):
                    pieces[-1] = (pieces[-1][0], b, s)
                else:
                    pieces.append((a, b, s))
        out.append(tuple(pieces))
    return tuple(out)


def relay(t, dim: int, have: tuple, want: tuple, me: int, group):
    """This rank's ``t``, which holds along ``dim`` the global indices
    ``have[me]`` (ranges, in order), re-laid to hold ``want[me]``: each part
    from this rank where it holds it, else from the lowest rank that does,
    in one all_to_all over ``group`` when any rank needs another's part.
    Every rank's result then depends on what it sent and received, even
    where that is nothing, so that every rank's backward runs the
    exchange's transpose."""
    pieces = _pieces(have, want)
    ms = len(have)
    t0 = t.movedim(dim, 0)

    def take(src, ranges_of, lo, hi):
        return src.narrow(0, _offset(ranges_of, lo), hi - lo)

    blocks, out = {}, []
    if any(s != j for j in range(ms) for _, _, s in pieces[j]):
        send = [[(a, b) for a, b, s in pieces[j] if s == me] if j != me else []
                for j in range(ms)]
        recv = [sum(b - a for a, b, s in pieces[me] if s == i) if i != me else 0
                for i in range(ms)]
        buf = torch.cat([t0.narrow(0, 0, 0)] + [take(t0, have[me], a, b)
                                                for ps in send for a, b in ps])
        got = AllToAllV.apply(buf, tuple(sum(b - a for a, b in ps) for ps in send),
                               tuple(recv), group)
        start = 0
        for i in range(ms):
            blocks[i] = (got.narrow(0, start, recv[i]),
                         tuple((a, b) for a, b, s in pieces[me] if s == i))
            start += recv[i]
        out.append(got.narrow(0, 0, 0))
    out = [take(t0, have[me], a, b) if s == me else take(*blocks[s], a, b)
           for a, b, s in pieces[me]] + out
    out = out[0] if len(out) == 1 else torch.cat(out)
    return out.movedim(0, dim)


class Split(NamedTuple):
    """How a mesh splits a layer: ``md`` the mesh dim of "model" whose
    ranks split its work (None: no split), ``ms`` its size (1 without),
    ``me`` this rank's index on it, ``group`` its process group, and
    ``rows`` the placements of a rank's batch rows (dim 0 kept split where
    the input splits it, outside ``md``; replicated elsewhere)."""
    mesh: object
    md: Optional[int]
    ms: int
    me: int
    group: object
    rows: tuple


def split_of(x, rt, what: str) -> Split:
    """The :class:`Split` of ``rt``'s mesh for ``what`` (a layer's name, for
    the error) on the DTensor ``x``."""
    from torch.distributed.tensor import Replicate, Shard

    if rt is None or not rt.sharded:
        raise ValueError(f"{what} on a DTensor needs the mesh's Runtime (rt)")
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    md = names.index(rt.model_axis) if rt.model_axis is not None else None
    ms = mesh.shape[md] if md is not None else 1
    if ms == 1:
        md = None
    rows = tuple(Shard(0) if p == Shard(0) and i != md else Replicate()
                 for i, p in enumerate(x.placements))
    if md is None:
        return Split(mesh, None, 1, 0, None, rows)
    return Split(mesh, md, ms, mesh.get_local_rank(md), mesh.get_group(md), rows)


def enter_weight(t, ch: int, sp: Split, what: str):
    """A weight DTensor -> (this rank's local tensor, the ranges of its
    dim ``ch`` that each model rank holds). It stays split over "model"
    where it is split along ``ch``, and is gathered over every other mesh
    dim (a data-axis split of FSDP: none without it, so no collective).
    Its gradient: split as kept; a partial sum over the dims whose ranks
    split the batch rows, and over "model", whose ranks each use their own
    part of a whole weight. A split over "model" along another dim raises
    (``what`` names the layer)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    ch %= t.ndim
    pl, grad = [], []
    for i, p in enumerate(t.placements):
        if i == sp.md and p.is_shard():
            if p != Shard(ch):
                raise NotImplementedError(
                    f"{what} on a mesh: a weight split over 'model' along dim {p.dim}, "
                    f"not dim {ch} (distributed/sharding.py's rules)")
            pl.append(p)
            grad.append(p)
            continue
        pl.append(Replicate())
        grad.append(Partial() if i == sp.md or sp.rows[i] == Shard(0) else Replicate())
    loc = t.redistribute(sp.mesh, tuple(pl)).to_local(grad_placements=tuple(grad))
    n = t.shape[ch]
    return loc, stored(n, sp.md is not None and pl[sp.md] == Shard(ch), sp.ms)


