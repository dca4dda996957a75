"""Gated (SwiGLU) dense MLP (counterpart of ``repro/models/mlp.py``).

On a mesh, :func:`apply_mlp_sharded` splits d_ff over the "model" axis on
local tensors: each model rank computes its block of d_ff columns for its
own batch rows, ``silu(x @ wg[:, blk]) * (x @ wu[:, blk]) @ wd[blk]``, and
the partial outputs are summed over "model" (one all_reduce, its transpose
the identity). The weights stay in ``distributed/sharding.py``'s
placements, which split zamba2's shared ``wg`` and ``wu`` along d_model,
as the reference's rule order does. The body moves whichever is smaller:
with more rows than d / ms (train, prefill) it re-lays those weights to
its d_ff blocks (one all_to_all each, d x d_ff / ms elements a rank);
with fewer (decode) each rank multiplies its own d_model slice of x by
its rows of the weight and the partial products go to their d_ff blocks'
ranks and are summed there (one all_to_all each, rows x d_ff elements).
"""
from __future__ import annotations

from . import tensor_parallel as tp
from .common import dense_init, silu

MLP = "the shared MLP"  # its name in the errors of tp


def init_mlp(d_model: int, d_ff: int, dtype, *, generator, device, lead=()):
    kw = dict(generator=generator, device=device, lead=lead)
    return {
        "wg": dense_init(d_model, d_ff, dtype, **kw),
        "wu": dense_init(d_model, d_ff, dtype, **kw),
        "wd": dense_init(d_ff, d_model, dtype, **kw),
    }


def apply_mlp(params, x):
    h = silu(x @ params["wg"]) * (x @ params["wu"])
    return h @ params["wd"]


def _relaid(loc, n: int, want: tuple, sp: tp.Split):
    """This rank's rows (d / ms, every column) of a (d, n) weight that
    "model" splits along d -> its columns ``want[me]``, every row: rank i
    sends rank j its rows of j's columns, in one all_to_all. Along the
    transposed weight's dim 0, global index i x n + c is rank i's row block
    of column c."""
    ms = sp.ms
    got = tp.relay(loc.t(), 0, tuple(((i * n, (i + 1) * n),) for i in range(ms)),
                   tuple(tuple((i * n + a, i * n + b) for i in range(ms) for a, b in rs)
                         for rs in want), sp.me, sp.group)
    w_me = got.shape[0] // ms
    return got.reshape(ms, w_me, -1).transpose(0, 1).reshape(w_me, -1).t()


def _partial(x, loc, lo: int, n: int, want: tuple, sp: tp.Split):
    """``x @ w[:, want[me]]`` where this rank holds rows [lo, lo + d / ms)
    of the (d, n) weight w (``loc``): its slice of x (rows, d) by them, a
    product partial over "model", whose column blocks go to their ranks
    and are summed on arrival."""
    part = (x[..., lo:lo + loc.shape[0]] @ loc).reshape(-1, n).t()  # (n, rows)
    send = tuple(b - a for ((a, b),) in want)
    got = tp.AllToAllV.apply(part, send, (send[sp.me],) * sp.ms, sp.group)
    return got.reshape(sp.ms, send[sp.me], -1).sum(0).t().reshape(*x.shape[:-1], -1)


def apply_mlp_sharded(params, x_in, rt):
    """The MLP on a DTensor x_in (B, T, d), d_ff split over ``rt``'s "model"
    axis (the module's docstring): model rank m computes d_ff block
    ``tp.block_of(d_ff, ms, m)`` on its batch rows, ``wg`` and ``wu`` split
    along d re-laid as weights or, with fewer rows than d / ms, their
    partial products as activations. Returns y as x_in's batch rows,
    replicated over "model". A weight split over "model" along another dim
    than the rules split it (``wg``/``wu`` along d_ff, ``wd`` along d)
    raises; a split over the data axes (FSDP) is gathered, as the Mamba
    mixer's is."""
    from torch.distributed.tensor import DTensor, Partial

    sp = tp.split_of(x_in, rt, MLP)
    n = params["wd"].shape[0]
    want = tuple((tp.block_of(n, sp.ms, m),) for m in range(sp.ms))
    x_pl = tuple(Partial() if i == sp.md else p for i, p in enumerate(sp.rows))
    x = x_in.redistribute(sp.mesh, sp.rows).to_local(grad_placements=x_pl)
    rows = x.numel() // x.shape[-1]
    lo, hi = want[sp.me][0]

    def up(w):  # x @ w[:, lo:hi]
        loc, have = tp.enter_weight(w, 0, sp, MLP)
        if have[0] == have[-1]:  # whole on every model rank
            return x @ loc[:, lo:hi]
        if rows * sp.ms < w.shape[0]:  # fewer rows than d / ms: move the products
            return _partial(x, loc, have[sp.me][0][0], w.shape[1], want, sp)
        return x @ _relaid(loc, w.shape[1], want, sp)

    wd, have = tp.enter_weight(params["wd"], 0, sp, MLP)
    wd = tp.relay(wd, 0, have, want, sp.me, sp.group)
    y = (silu(up(params["wg"])) * up(params["wu"])) @ wd
    if sp.group is not None:
        y = tp.AllReduce.apply(y, sp.group, False)
    return DTensor.from_local(y, sp.mesh, sp.rows, run_check=False)
