"""Path-based parameter sharding rules (counterpart of
``repro/distributed/sharding.py``), and their placement on a
``DeviceMesh`` as DTensors.

Tensor parallel ("model" axis): attention heads, MLP hidden, experts,
vocab. Optional FSDP: additionally shard a large unsharded weight dim
over the data axes (enabled automatically when the per-device TP-only
weight footprint would exceed ``FSDP_THRESHOLD_BYTES``).

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dim, ``None``, an axis name, or a tuple of axis names. All specs
are pruned for divisibility against the mesh (``Runtime.prune_spec``),
so the same rules serve every (arch x mesh) combination; on an
``AbstractMesh`` they are computed for any mesh size without its
processes. :func:`placements` turns a spec into DTensor placements, one
per mesh dim; :func:`distribute_params` places a whole parameter tree.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..configs.base import ModelConfig

FSDP_THRESHOLD_BYTES = 11e9  # the reference's: ~11 GB of 16 GB v5e HBM left for weights


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict, paths "/"-joined as the
    reference's ``_path_str``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


# rules: (suffix match, spec for the TRAILING dims of the leaf)
_RULES: Tuple[Tuple[str, Tuple], ...] = (
    ("embed", (("model",), None)),
    ("lm_head", (None, ("model",))),
    # attention
    ("mixer/wq", (None, ("model",))),
    ("mixer/wk", (None, ("model",))),
    ("mixer/wv", (None, ("model",))),
    ("mixer/wo", (("model",), None)),
    # mamba2
    ("mixer/in_proj", (None, ("model",))),
    ("mixer/conv_w", (None, ("model",))),
    ("mixer/conv_b", (("model",),)),
    ("mixer/out_proj", (("model",), None)),
    ("mixer/norm_w", (("model",),)),
    # MoE experts: shard the expert dim (expert parallelism)
    ("ffn/router", (None, None)),
    ("ffn/wg", (("model",), None, None)),
    ("ffn/wu", (("model",), None, None)),
    ("ffn/wd", (("model",), None, None)),
    # dense / shared-expert MLP
    ("ffn/shared/wg", (None, ("model",))),
    ("ffn/shared/wu", (None, ("model",))),
    ("ffn/shared/wd", (("model",), None)),
    ("shared/ffn/wg", (None, ("model",))),
    ("shared/ffn/wu", (None, ("model",))),
    ("shared/ffn/wd", (("model",), None)),
    # LoRA adapters: expert dim over "model" (match the base experts)
    ("/a", (("model",), None, None)),
    ("/b", (("model",), None, None)),
)

_DENSE_FFN = (
    ("ffn/wg", (None, ("model",))),
    ("ffn/wu", (None, ("model",))),
    ("ffn/wd", (("model",), None)),
)


def leaf_spec(path_str: str, leaf, *, fsdp: bool, data_axes: Tuple[str, ...],
              profile: str = "tp") -> tuple:
    """The unpruned spec of one leaf (the reference's rules, word for
    word); ``leaf`` needs only its number of dims."""
    ndim = len(leaf.shape)
    if profile == "pure_fsdp":
        # no TP rules: shard the first trailing weight dim over ALL axes
        if ndim < 1:
            return ()
        entries = [None] * ndim
        start = 1 if ndim >= 3 else 0  # skip the scan-repeat dim
        entries[start] = tuple(data_axes) if len(data_axes) > 1 else (
            data_axes[0] if data_axes else None)
        return tuple(entries)
    rules = _RULES
    # dense-MLP wg/wu/wd (3D incl. repeat dim) vs MoE expert stacks (4D)
    if "/ffn/w" in path_str and "shared" not in path_str and ndim <= 3:
        rules = _DENSE_FFN + _RULES
    trailing: Optional[Tuple] = None
    for suffix, spec in rules:
        if path_str.endswith(suffix) or (suffix + "/") in path_str or suffix in path_str:
            trailing = spec
            break
    if trailing is None:
        return ()
    # left-pad with None for leading (repeat/expert) dims
    entries = [None] * (ndim - len(trailing)) + [
        (t[0] if isinstance(t, tuple) and t else t) for t in trailing]
    entries = entries[:ndim]
    if fsdp and data_axes and ndim >= 2:
        # shard the first unsharded *trailing weight* dim over the data axes
        for i in range(ndim - len(trailing), ndim):
            if entries[i] is None:
                entries[i] = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
                break
    return tuple(entries)


def needs_fsdp(cfg: ModelConfig, rt) -> bool:
    if not rt.sharded:
        return False
    ms = rt.axis_size("model")
    bytes_tp = cfg.param_counts()["total"] * 2 / ms  # bf16
    return bytes_tp > FSDP_THRESHOLD_BYTES


def param_pspecs(params_or_shapes, cfg: ModelConfig, rt, *, fsdp: Optional[bool] = None):
    """Spec tree for the parameter tree (divisibility-pruned); leaves are
    anything with a ``shape`` (tensors, ``meta`` tensors of
    ``models.model.param_shapes``)."""
    if fsdp is None:
        fsdp = needs_fsdp(cfg, rt)
    data_axes = rt.data_axes

    def per_leaf(path, leaf):
        spec = leaf_spec(path, leaf, fsdp=fsdp, data_axes=data_axes, profile=rt.profile)
        return rt.prune_spec(leaf.shape, spec)

    return _map_with_path(per_leaf, params_or_shapes)


def placements(spec: tuple, mesh) -> tuple:
    """A spec -> DTensor placements, one per mesh dim: ``Shard(d)`` on every
    mesh dim that tensor dim ``d``'s entry names, ``Replicate()`` on the
    rest. A DTensor split over several mesh dims splits in mesh-dim order,
    as a ``PartitionSpec`` entry splits in its tuple's order; the rules
    always name axes in mesh order, which is asserted, not assumed."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} names mesh axes out of the mesh's "
                             f"order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]} shards two dims of {spec}")
            out[i] = Shard(d)
    return tuple(out)


def param_shardings(params_or_shapes, cfg: ModelConfig, rt, *, fsdp: Optional[bool] = None):
    """Placement tree for the parameter tree on ``rt.mesh`` (the
    reference's ``NamedSharding`` tree)."""
    specs = param_pspecs(params_or_shapes, cfg, rt, fsdp=fsdp)
    return _map_with_path(lambda _, s: placements(s, rt.mesh), specs)


def _place(t, pl: tuple, mesh):
    """A tensor every rank holds whole -> a DTensor of placements ``pl``,
    each rank keeping its own shard (no communication)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def distribute(t, spec: tuple, mesh):
    """A tensor every rank holds whole -> a DTensor of ``spec`` on ``mesh``."""
    return _place(t, placements(spec, mesh), mesh)


def distribute_params(params, cfg: ModelConfig, rt, *, fsdp: Optional[bool] = None):
    """A whole parameter (or LoRA) tree, the same on every rank (the
    bridge's, or ``init_params`` from one seed), placed on ``rt.mesh`` as
    :func:`param_shardings` gives."""
    pls = param_shardings(params, cfg, rt, fsdp=fsdp)

    def walk(t, p):
        if isinstance(t, dict):
            return {k: walk(v, p[k]) for k, v in t.items()}
        return _place(t, p, rt.mesh)

    return walk(params, pls)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def batch_pspecs(batch, rt):
    """Shard the leading (batch) dim of every input leaf over data axes."""
    entry = rt.batch_spec_entry()

    def per_leaf(_, leaf):
        if len(leaf.shape) == 0:
            return ()
        return rt.prune_spec(leaf.shape, (entry,))

    return _map_with_path(per_leaf, batch)


def cache_pspecs(cache, rt):
    """KV/SSM cache: batch over data axes, kv-heads / inner-dim over model
    (the cache of ``models.model.init_cache`` / ``prefill``: stacked
    ``KVCache`` / ``MambaState`` leaves; ``pos`` gets ``()``)."""
    from ..models.attention import KVCache
    from ..models.mamba2 import MambaState

    entry = rt.batch_spec_entry()
    ms = rt.axis_size("model")
    fsdp = rt.profile == "pure_fsdp"

    def handle(node):
        if isinstance(node, KVCache):
            if fsdp:
                kv = rt.prune_spec(node.k.shape, (None, entry, None, None, None))
            # prefer kv-head sharding; fall back to the sequence (slot) dim
            # when the arch has fewer kv heads than model shards
            elif node.k.shape[3] % ms == 0:
                kv = rt.prune_spec(node.k.shape, (None, entry, None, "model", None))
            else:
                kv = rt.prune_spec(node.k.shape, (None, entry, "model", None, None))
            sp = rt.prune_spec(node.slot_pos.shape, (None, entry, None))
            return KVCache(k=kv, v=kv, slot_pos=sp)
        if isinstance(node, MambaState):
            if fsdp:
                return MambaState(conv=rt.prune_spec(node.conv.shape, (None, entry)),
                                  ssm=rt.prune_spec(node.ssm.shape, (None, entry)))
            return MambaState(
                conv=rt.prune_spec(node.conv.shape, (None, entry, None, "model")),
                ssm=rt.prune_spec(node.ssm.shape, (None, entry, "model", None, None)))
        if isinstance(node, dict):
            return {k: handle(v) for k, v in node.items()}
        return ()  # scalars (pos)

    return handle(cache)
