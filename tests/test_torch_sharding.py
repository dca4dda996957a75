"""The port's sharding rules (``repro_torch.distributed.sharding``) and the
mesh half of its ``Runtime`` against the JAX package, in one process.

Specs are computed on abstract meshes (names and sizes, no processes):
the reference's (2, 4) debug mesh, its single-pod (16, 16) and multi-pod
(2, 16, 16) production meshes, under both profiles and with FSDP on and
off. For every registered config the port's spec of every parameter must
equal the JAX ``param_pspecs`` leaf for leaf (a ``PartitionSpec`` read as
a tuple), and so must the batch and cache specs; ``param_shapes`` must
give the JAX shapes and dtypes. The JAX side runs on
``jax.sharding.AbstractMesh``, with ``fsdp`` given (its ``needs_fsdp``
asks the mesh for devices).
"""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models.model import init_cache as jax_init_cache  # noqa: E402
from repro.models.model import param_shapes as jax_param_shapes  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models.common import set_opt_flags  # noqa: E402
from repro_torch.models.model import init_cache, param_shapes  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

MESHES = {"debug-2x4": ((2, 4), ("data", "model")),
          "pod-16x16": ((16, 16), ("data", "model")),
          "multipod-2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PROFILES = ("tp", "pure_fsdp")


def _runtimes(mesh_key, profile):
    shape, names = MESHES[mesh_key]
    return (Runtime(mesh=AbstractMesh(shape, names), profile=profile),
            JaxRuntime(mesh=JaxAbstractMesh(shape, names), profile=profile))


def _flat_jax(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec) or x is None)[0]
    out = {}
    for path, leaf in leaves:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                       for p in path)
        out[key] = tuple(leaf) if isinstance(leaf, PartitionSpec) else leaf
    return out


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


_SHAPES = {}


def _shapes(arch):
    if arch not in _SHAPES:
        _SHAPES[arch] = (param_shapes(get_config(arch)),
                         jax_param_shapes(jax_get_config(arch)))
    return _SHAPES[arch]


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_jax(arch):
    ours_shapes, jax_shapes = _shapes(arch)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    n = 0
    for mesh_key in MESHES:
        for profile in PROFILES:
            rt, jrt = _runtimes(mesh_key, profile)
            for fsdp in (False, True):
                ours = _flat(sharding.param_pspecs(ours_shapes, cfg, rt, fsdp=fsdp))
                theirs = _flat_jax(jsharding.param_pspecs(jax_shapes, jcfg, jrt, fsdp=fsdp))
                assert ours == theirs, (mesh_key, profile, fsdp)
                n += len(ours)
                # the placements of every spec on that mesh
                pl = _flat(sharding.param_shardings(ours_shapes, cfg, rt, fsdp=fsdp))
                assert pl == {k: sharding.placements(v, rt.mesh) for k, v in ours.items()}
    assert n > 0


@pytest.mark.parametrize("arch", list_archs())
def test_param_shapes_match_jax(arch):
    ours, theirs = _flat(_shapes(arch)[0]), _flat_jax(_shapes(arch)[1])
    assert ours.keys() == theirs.keys()
    for k, t in ours.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(theirs[k].shape), k
        assert str(t.dtype).replace("torch.", "") == str(theirs[k].dtype), k


@pytest.mark.parametrize("arch", ["olmoe", "zamba2-7b", "gemma2-27b", "mixtral-8x7b",
                                  "granite-moe-1b-a400m-smoke"])
def test_batch_and_cache_specs_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for mesh_key in MESHES:
        for profile in PROFILES:
            rt, jrt = _runtimes(mesh_key, profile)
            for B in (2, 16, 32, 64):
                batch = {"tokens": torch.empty((B, 8), device="meta"),
                         "labels": torch.empty((B, 8), device="meta")}
                jbatch = {k: jax.ShapeDtypeStruct((B, 8), jnp.int32) for k in batch}
                assert _flat(sharding.batch_pspecs(batch, rt)) == \
                    _flat_jax(jsharding.batch_pspecs(jbatch, jrt)), (mesh_key, profile, B)
            B, slots = 32, 64
            ours = sharding.cache_pspecs(init_cache(cfg, B, slots, device="meta"), rt)
            jcache = jax.eval_shape(lambda: jax_init_cache(jcfg, B, slots))
            theirs = _flat_jax(jsharding.cache_pspecs(jcache, jrt))
            assert _flat(ours) == theirs, (mesh_key, profile)


def test_prune_spec_needs_fsdp_and_placements():
    rt, jrt = _runtimes("multipod-2x16x16", "tp")
    for shape, spec in (((48, 1024), (None, "model")), ((64, 8), (("pod", "data"), None)),
                        ((2, 48), (("pod", "data", "model"),)), ((96,), ("model",)),
                        ((4, 4, 4), (("data", "model"), "pod"))):
        assert rt.prune_spec(shape, spec) == tuple(jrt.prune_spec(shape, PartitionSpec(*spec)))
    assert Runtime().prune_spec((4, 4), ("model",)) == ()
    for arch in list_archs():
        for size in (1, 4, 16):
            stub = SimpleNamespace(sharded=True, axis_size=lambda _, n=size: n)
            assert sharding.needs_fsdp(get_config(arch), stub) == \
                jsharding.needs_fsdp(jax_get_config(arch), stub), (arch, size)
    assert not sharding.needs_fsdp(get_config("olmoe"), Runtime())
    from torch.distributed.tensor import Replicate, Shard

    assert sharding.placements((("pod", "data"), None, "model"), rt.mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, None), rt.mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sharding.placements((("data", "pod"),), rt.mesh)
    with pytest.raises(ValueError, match="two dims"):
        sharding.placements(("model", "model"), rt.mesh)


def test_runtime_mesh_half_and_sharded_means_plain(monkeypatch):
    rt, jrt = _runtimes("multipod-2x16x16", "tp")
    frt, fjrt = _runtimes("multipod-2x16x16", "pure_fsdp")
    for ours, theirs in ((rt, jrt), (frt, fjrt)):
        assert ours.sharded and ours.data_axes == theirs.data_axes
        assert ours.model_axis == theirs.model_axis
        assert ours.batch_spec_entry() == theirs.batch_spec_entry()
        assert ours.axis_size(("pod", "model")) == theirs.axis_size(("pod", "model")) == 32
    one = Runtime(mesh=AbstractMesh((1, 1), ("data", "model")))
    assert not one.sharded and Runtime().data_axes == () and Runtime().model_axis is None
    # sharded means plain for code on DTensors; the local tensors of one
    # rank take the runtime's own spec, and the environment's spec wins
    # on both (a kernel asked for there is not quietly dropped)
    hopper = Runtime(kernel_backend="hopper", device=torch.device("cuda"), mesh=rt.mesh)
    assert hopper.backend == "ref" and not hopper.kernel_choice("moe_gmm")
    assert hopper.local().backend == "hopper" and hopper.local().mesh is None
    assert hopper.local().kernel_choice("moe_gmm")
    monkeypatch.setenv(dispatch.ENV_VAR, "hopper")
    assert hopper.kernel_choice("moe_gmm")
    with pytest.raises(KeyError):
        set_opt_flags(decode_no_f32_cache=True)  # no counterpart on CUDA (ROADMAP)
    x = torch.zeros(2, 2)
    assert Runtime().constrain(x, "data") is x
    with pytest.raises(TypeError, match="DTensor"):
        rt.constrain(x, "data")
