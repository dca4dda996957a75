"""The dry run's inputs and placements against the JAX package, in one
process: ``repro_torch.launch.specs`` (``input_specs``,
``decode_window_override``), ``launch.mesh.make_production_mesh`` and the
placement trees of ``launch.steps`` (``ns_tree``, ``train_shardings``,
``decode_shardings``).

Every registered config x every ``SHAPES`` entry: each stand-in's shape
and dtype equals the JAX ``ShapeDtypeStruct`` (the reference's int32
tokens against the port's int64), the cache tree mapped leaf by leaf.
The placement trees equal the JAX ``NamedSharding`` trees on both
production meshes (the JAX side on ``jax.sharding.AbstractMesh``; its
``Runtime.sharded`` asks a mesh for devices, which an abstract mesh has
not, so the test reads the size from the axis sizes instead)."""
import math

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import ASSIGNED, SHAPES, get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import specs, steps  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else str(k)))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _flat_jax(tree, leaf=lambda x: False):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                     for p in path): x for path, x in leaves}


def test_shapes_are_the_references():
    assert {k: (s.seq_len, s.global_batch, s.mode) for k, s in SHAPES.items()} == \
        {k: (s.seq_len, s.global_batch, s.mode) for k, s in JAX_SHAPES.items()}
    for name in SHAPES:
        assert specs.get_shape(name) == SHAPES[name]


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_and_window_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in SHAPES.items():
        jshape = JAX_SHAPES[name]
        wo = specs.decode_window_override(cfg, shape)
        assert wo == jspecs.decode_window_override(jcfg, jshape), (arch, name)
        ours = _flat(specs.input_specs(cfg, shape))
        theirs = _flat_jax(jspecs.input_specs(jcfg, jshape))
        assert ours.keys() == theirs.keys(), (arch, name)
        for k, t in ours.items():
            j = theirs[k]
            if not isinstance(t, torch.Tensor):  # the cache's "pos": an int, a JAX scalar
                assert k == "cache/pos" and t == 0 and j.shape == () \
                    and str(j.dtype) == "int32", (arch, name, k)
                continue
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(j.shape), (arch, name, k)
            want = "int64" if str(j.dtype) == "int32" and k in ("tokens", "labels") \
                else str(j.dtype)
            assert str(t.dtype).replace("torch.", "") == want, (arch, name, k)


def test_long_context_policy_and_bounded_ring():
    assert specs.decode_window_override(get_config("mamba2-130m"), SHAPES["long_500k"]) is None
    assert specs.decode_window_override(get_config("command-r-plus-104b"),
                                        SHAPES["long_500k"]) == 8192
    assert specs.decode_window_override(get_config("command-r-plus-104b"),
                                        SHAPES["decode_32k"]) is None
    cfg = get_config("qwen3-4b")
    kv = [t for t in _flat(specs.input_specs(cfg, SHAPES["long_500k"])["cache"]).values()
          if isinstance(t, torch.Tensor) and t.dim() == 5]
    assert kv and all(t.shape[2] == cfg.long_context_window for t in kv)
    # stand-ins on another device, in another dtype
    sp = specs.input_specs(get_config("musicgen-medium-smoke"), SHAPES["train_4k"],
                           dtype=torch.float32, device="cpu")
    assert sp["tokens"].device.type == "cpu" and sp["prefix_embed"].dtype == torch.float32


def _jax_rt(monkeypatch, key):
    shape, names = PRODUCTION[key]
    monkeypatch.setattr(JaxRuntime, "sharded", property(
        lambda self: self.mesh is not None and math.prod(self.mesh.axis_sizes) > 1))
    return JaxRuntime(mesh=JaxAbstractMesh(shape, names))


def _as_placements(jtree, mesh):
    """A JAX NamedSharding tree -> {path: the port's placements of its spec}."""
    flat = _flat_jax(jtree, lambda x: isinstance(x, NamedSharding))
    return {k: sharding.placements(tuple(ns.spec), mesh) for k, ns in flat.items()}


@pytest.mark.parametrize("arch", list(ASSIGNED) + ["olmoe"])
def test_placement_trees_match_jax(arch, monkeypatch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for key, (shape, names) in PRODUCTION.items():
        rt = Runtime(mesh=AbstractMesh(shape, names))
        jrt = _jax_rt(monkeypatch, key)
        tr = SHAPES["train_4k"]
        ps, os_, bs = steps.train_shardings(cfg, rt, specs.input_specs(cfg, tr))
        jps, jos, jbs = jsteps.train_shardings(jcfg, jrt, jspecs.input_specs(jcfg, tr))
        assert _flat(ps) == _as_placements(jps, rt.mesh), (arch, key)
        assert _flat(os_) == _as_placements(jos, rt.mesh), (arch, key)
        assert _flat(bs) == _as_placements(jbs, rt.mesh), (arch, key)
        dec = SHAPES["decode_32k"]
        ps, bs = steps.decode_shardings(cfg, rt, specs.input_specs(cfg, dec))
        jps, jbs = jsteps.decode_shardings(jcfg, jrt, jspecs.input_specs(jcfg, dec))
        assert _flat(ps) == _as_placements(jps, rt.mesh), (arch, key)
        assert _flat(bs) == _as_placements(jbs, rt.mesh), (arch, key)
        # every placement is the spec tree's, through ns_tree
        pspec = sharding.param_pspecs(steps.param_shapes(cfg), cfg, rt)
        assert _flat(steps.ns_tree(rt, pspec)) == {
            k: sharding.placements(s, rt.mesh) for k, s in _flat(pspec).items()}


def test_production_mesh_needs_its_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="256"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True, device_type="cpu")
