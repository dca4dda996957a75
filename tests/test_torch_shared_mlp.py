"""The shared block's MLP split over the "model" axis
(``models/mlp.py::apply_mlp_sharded``), which ``blocks._ffn`` takes for a
``shared_attn`` block on a mesh: zamba2's shared ``wg`` and ``wu`` are split
along d_model by the reference's rule order, and the body re-lays them to
d_ff blocks as weights.

* On gloo meshes of processes on the CPU (``tests/_torch_dist_worker.py::
  run_mlp``): (2, 2) and (1, 2, 2), whose model axis splits every weight
  evenly, and (1, 3), where it divides neither d_ff (so the blocks are
  uneven and ``wd`` stays whole) nor, at one width, d_model (``wg`` and
  ``wu`` whole). Each case places the weights by the sharding rules
  (``rules``) or with FSDP's data-axis split on top (``fsdp``), at a rank's rows below d /
  model (the split weights' partial products move) and above it (the
  weights move), and holds y and the gradients of x and of each weight,
  for a random output gradient, within 1e-5 of their largest element
  against one device's ``apply_mlp``, the port's and the JAX package's.
* Structure, under the dry run's ``Ledger`` on fake tensors: at
  zamba2-7b's width on fake meshes with "model" 16 under two batch axes
  ((2, 2, 16): the weights move; (2, 16, 16): the products), the shared
  block's FFN, forward and backward (the output gradient placed as the
  output, or that of ``y.sum()``), runs 9 products, none of which holds
  or makes a whole 3584 x 14,336 weight, and their FLOPs are 9 x one
  product's on the rank's rows divided by 16. The plain ``apply_mlp`` on
  these DTensors, through DTensor's strategies, makes whole weight
  gradients in the backward there, and under ``y.sum()`` counts 3 x the
  forward.
* A weight split over "model" along another dim than the rules split it
  raises.
"""
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.mlp import apply_mlp as jax_apply_mlp  # noqa: E402
from repro_torch.models.mlp import apply_mlp  # noqa: E402
import _torch_dist_worker as worker  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = [pytest.mark.torch, pytest.mark.fleet]

MESHES = ((2, 2), (1, 3), (1, 2, 2))  # ("pod",) "data", "model"
WIDTHS = ((96, 256), (128, 384))  # (d_model, d_ff)
PLACEMENTS = ("rules", "fsdp")
# sequence lengths: a rank's rows B / data x T below d / model on every mesh
# (the split weights' partial products move) and above it (the weights move)
LENGTHS = (6, 48)
CASES = tuple(f"{how}-{d}x{f}-T{T}" for how in PLACEMENTS for d, f in WIDTHS for T in LENGTHS)
B = 4
SPAWN_LIMIT_S = 300
TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs():
    rng = np.random.default_rng(0)
    cases = {}
    def draw(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape), dtype=torch.float32)

    for how in PLACEMENTS:
        for d, f in WIDTHS:
            for T in LENGTHS:
                cases[f"{how}-{d}x{f}-T{T}"] = {
                    "placement": how,
                    "weights": {"wg": draw(d, f, scale=d**-0.5),
                                "wu": draw(d, f, scale=d**-0.5), "wd": draw(f, d, scale=f**-0.5)},
                    "x": draw(B, T, d), "dy": draw(B, T, d)}
    return cases


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def single(inputs):
    """One device's y and gradients (the port's ``apply_mlp`` under
    autograd) and the JAX package's y and vector-Jacobian product."""
    out = {}
    for name, c in inputs.items():
        w = {k: t.clone().requires_grad_() for k, t in c["weights"].items()}
        x = c["x"].clone().requires_grad_()
        y = apply_mlp(w, x)
        grads = torch.autograd.grad(y, [x, *w.values()], c["dy"])
        jw = {k: jnp.asarray(t.numpy()) for k, t in c["weights"].items()}
        jy, vjp = jax.vjp(lambda x_, w_: jax_apply_mlp(w_, x_), jnp.asarray(c["x"].numpy()), jw)
        jx, jgw = vjp(jnp.asarray(c["dy"].numpy()))
        out[name] = {
            "port": (y.detach(), dict(zip(["x", *w], grads))),
            "jax": (torch.tensor(np.asarray(jy)),
                    {"x": torch.tensor(np.asarray(jx)),
                     **{k: torch.tensor(np.asarray(v)) for k, v in jgw.items()}})}
    return out


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: "x".join(map(str, m)))
def sharded(request, inputs, tmp_path_factory):
    mesh = request.param
    world = int(np.prod(mesh))
    root = tmp_path_factory.mktemp("shared_mlp")
    torch.save({"mesh": mesh, "mlp_cases": inputs}, root / "inputs.pt")
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        worker.run_mlp, args=(world, _free_port(), str(root)), nprocs=world, join=False,
        start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > SPAWN_LIMIT_S:
                raise TimeoutError(f"the {world} gloo workers took over {SPAWN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    return {"mesh": mesh, "res": torch.load(root / "results.pt", weights_only=False)}


def _close(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("case", CASES)
def test_shared_mlp_body_matches_one_device(sharded, single, case):
    got = sharded["res"][case]
    for name, (y, grads) in single[case].items():
        assert _close(got["y"], y) <= TOL, (name, sharded["mesh"], got["placements"])
        assert got["grads"].keys() == grads.keys()
        for k, g in grads.items():
            assert _close(got["grads"][k], g) <= TOL, (name, k, sharded["mesh"],
                                                        got["placements"])


def _fake(shape, pl, mesh, grad=True, dtype=torch.bfloat16):
    """A fake DTensor of global ``shape`` and placements ``pl`` on ``mesh``,
    on the dry run's card device (inside ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import dryrun

    loc = list(shape)
    for size, p in zip(mesh.shape, pl):
        if p.is_shard():
            loc[p.dim] //= size
    t = torch.empty(loc, dtype=dtype, device=dryrun.card_device()).requires_grad_(grad)
    return DTensor.from_local(t, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _fake_ffn(mesh_shape, grad: str):
    """The shared block's FFN (``blocks._ffn``) of zamba2-7b on a fake mesh
    of ``mesh_shape`` ("pod", "data", "model"), bf16 fake tensors of rows
    ``B_FAKE`` x ``T_FAKE`` placed as the train step places them, forward
    and backward under a ``Ledger`` that keeps each ``mm``'s operand
    shapes. Returns (the shapes, the output's placements, (d, d_ff,
    model, a rank's rows))."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import leaf_spec, placements
    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import blocks
    from repro_torch.models.runtime import Runtime

    class Shapes(dryrun.Ledger):
        def __init__(self, device_type):
            super().__init__(device_type)
            self.mm = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = func._overloadpacket.__name__
            if out is not NotImplemented and not self.hidden and name in ("mm", "addmm"):
                self.mm.append(tuple(t.shape for t in args[-2:]))
            return out

    cfg = get_config("zamba2-7b")
    b = cfg.block_defs["shared_attn"]
    d, f = cfg.d_model, b.d_ff
    dev = dryrun.card_device()
    pod, data, model = mesh_shape

    with dryrun.fake_group(pod * data * model):
        mesh = make_debug_mesh(data, model, pod, device_type=dev.type)
        rt = Runtime(mesh=mesh, device=dev)
        led = Shapes(dev.type)
        with dispatch.card_stand_in(), FakeTensorMode():
            params = {}
            for k, shape in (("wg", (d, f)), ("wu", (d, f)), ("wd", (f, d))):
                spec = leaf_spec(f"shared/ffn/{k}", torch.empty(shape, device="meta"),
                                 fsdp=False, data_axes=rt.data_axes)
                params[k] = _fake(shape, placements(rt.prune_spec(shape, spec), mesh), mesh)
            rows = placements((rt.data_axes, None, None), mesh)
            x = _fake((B_FAKE, T_FAKE, d), rows, mesh)
            with dryrun._dtensor_metadata_hidden(led), led, rt.dist():
                y = blocks._ffn({"ffn": params}, b, x, rt, {}, False, None, 1.0)
                if grad == "sum":
                    torch.autograd.grad(y.sum(), [x, *params.values()])
                else:
                    torch.autograd.grad(y, [x, *params.values()],
                                        _fake(tuple(y.shape), y.placements, mesh, grad=False))
    return led.mm, tuple(y.placements), (d, f, model, B_FAKE // (pod * data) * T_FAKE)


B_FAKE, T_FAKE = 512, 8


@pytest.mark.parametrize("grad", ["as_output", "sum"])
@pytest.mark.parametrize("mesh", [(2, 2, 16), (2, 16, 16)], ids=lambda m: "x".join(map(str, m)))
def test_shared_ffn_products_are_split_on_a_3d_mesh(mesh, grad):
    shapes, y_pl, (d, f, model, rows) = _fake_ffn(mesh, grad)
    whole = {(d, f), (f, d)}
    for a, b in shapes:
        assert not {a, b, (a[0], b[1])} & whole, (a, b)  # operands and result
    assert len(shapes) == 9, shapes  # 3 products forward, 6 backward
    flops = sum(2 * a[0] * a[1] * b[1] for a, b in shapes)
    assert flops == 9 * 2 * rows * d * f // model, (flops, shapes)
    assert not any(p.is_partial() for p in y_pl), y_pl


@pytest.mark.parametrize("wrong", ["wg", "wd"])
def test_a_weight_split_along_another_dim_raises(wrong):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.mlp import apply_mlp_sharded
    from repro_torch.models.runtime import Runtime

    with dryrun.fake_group(4):
        mesh = make_debug_mesh(2, 2, device_type=dryrun.card_device().type)
        rt = Runtime(mesh=mesh, device=dryrun.card_device())
        with dispatch.card_stand_in(), FakeTensorMode():
            # the rules split wg and wu along d (dim 0) and wd along d_ff (dim 0)
            params = {k: _fake(shape, (Replicate(), Shard(int(k == wrong))), mesh)
                      for k, shape in (("wg", (8, 16)), ("wu", (8, 16)), ("wd", (16, 8)))}
            x = _fake((4, 3, 8), (Shard(0), Replicate()), mesh)
            with rt.dist(), pytest.raises(NotImplementedError, match="shared MLP"):
                apply_mlp_sharded(params, x, rt)
