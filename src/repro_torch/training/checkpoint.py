"""Msgpack + raw-array checkpoints (counterpart of
``repro/training/checkpoint.py``), readable and writable by both
packages.

A checkpoint is one msgpack map ``{"step", "metadata", "treedef",
"leaves"}``: the leaves in the reference's ``tree_flatten`` order (dict
keys sorted, tuple and list items in order, ``None`` holding no leaf),
each an ``array_record``, and ``treedef`` the reference's string for the
tree's structure. A file the JAX package writes loads here bit for bit,
and the file written here for the same tree is the same bytes.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, List, Tuple

from ..recovery.msgpack_lite import StreamReader, packb
from ..recovery.serial import array_record, atomic_write_bytes, read_array_record


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


def tree_leaves(tree) -> List[Any]:
    """Leaves in the reference's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def treedef_str(tree) -> str:
    """The reference's ``str(treedef)`` of ``tree``."""
    def walk(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # keep the like-tree's key order
        if isinstance(t, (list, tuple)):
            vals = [build(v) for v in t]
            return type(t)(vals) if isinstance(t, list) else tuple(vals)
        return next(it)

    return build(like)


def save_checkpoint(path, tree, *, step: int = 0, metadata: dict | None = None) -> None:
    """Write ``tree`` (dicts, tuples and lists of tensors or arrays)."""
    payload = {
        "step": step,
        "metadata": metadata or {},
        "treedef": treedef_str(tree),
        "leaves": [array_record(l, binary=True) for l in tree_leaves(tree)],
    }
    atomic_write_bytes(Path(path), packb(payload))


def load_checkpoint(path, like_tree, *, slices=None) -> Tuple[Any, int, dict]:
    """Restore into the structure of ``like_tree`` (any leaves with a
    ``.shape``: tensors, or tensors on the ``meta`` device). Returns
    (tree of CPU tensors, step, metadata).

    The file is read front to back, each leaf's bytes straight into its
    tensor (``read_array_record``): host memory holds the tree once, and
    neither the file nor a copy of any field. ``slices``: {leaf index (in
    the flatten order): fn}; such a leaf is read one index of its leading
    dim at a time, ``fn(j, t)`` called with each (a stacked expert leaf,
    one repeat's ``(E, i, o)`` matrix a call), and the like-tree's leaf
    stands in its place in the tree returned. A leaf count or shape that
    differs from the like-tree's, or a file that ends early, raises
    ``ValueError``."""
    like = tree_leaves(like_tree)
    slices = slices or {}
    payload, leaves = {}, None
    with open(path, "rb") as f:
        r = StreamReader(f)
        for _ in range(r.head("map")):
            key = r.read()
            if key != "leaves":
                payload[key] = r.read()
                continue
            n = r.head("arr")
            if n != len(like):
                raise ValueError(f"leaf count mismatch: {n} vs {len(like)}")
            leaves = []
            for i, l in enumerate(like):
                t = read_array_record(r, l.shape, slices.get(i))
                leaves.append(l if i in slices else t)
        if not r.at_end():
            raise ValueError(f"{path}: extra data after the checkpoint")
    if leaves is None:
        raise ValueError(f"{path}: a checkpoint without leaves")
    return _unflatten(like_tree, leaves), payload["step"], payload["metadata"]
