"""The train step's next-token NLL on a mesh
(``core.losses.nll_loss_on_mesh``, which ``launch/steps.py::_shift_loss``
takes on DTensor logits): where the logits are split along the vocab over
"model", each rank works on its own block, as XLA partitions the JAX
package's ``nll_loss`` over that split, and gathers none of it.

* Values (``tests/_torch_dist_worker.py::run_vocab_loss``, gloo meshes of
  processes on the CPU): on (2, 2), (1, 3) and (1, 2, 2), with
  ``prefix_len`` 0 and 8, a vocab of 96 (which every "model" axis here
  divides) and 97 (which none does), the logits placed as
  ``compute_logits`` places them (the split pruned where it does not
  divide, so the vocab arrives whole) or split along the vocab whatever
  its size (torch.chunk's uneven blocks): the loss and the logits'
  gradient within 1e-6 of their largest element against one device's
  ``nll_loss``, the port's and the JAX package's, on the same numpy
  logits (fp32).
* Collectives: the JAX package's ``value_and_grad`` of ``nll_loss``,
  lowered on 4 CPU devices ((2, 2), Auto axes, in a subprocess) with the
  logits split (rows over "data", vocab over "model"), holds no
  all-gather in its HLO; the port's ``_shift_loss`` on such logits on a
  fake (2, 2) mesh, forward and backward under the dry run's ``Ledger``,
  makes no ``all_gather`` either, and each of its all-reduces is at most
  a rank's rows x T floats.
* No whole-vocab block: in the dry run of a smoke MoE config's train step
  on a fake (2, 4) mesh, no tensor made under ``_shift_loss``, in the
  forward or in the backward up to the logits' gradient, is larger than a
  rank's rows x T x V / 4 fp32 (gathering the logits made rows x T x V).
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.losses import nll_loss as jax_nll_loss  # noqa: E402
from repro_torch.core.losses import next_token_shift, nll_loss  # noqa: E402
import _torch_dist_worker as worker  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = [pytest.mark.torch, pytest.mark.fleet]

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((2, 2), (1, 3), (1, 2, 2))  # ("pod",) "data", "model"
B, T = 4, 16
VOCABS = (96, 97)  # 96 divides every "model" axis here, 97 none
PREFIX = (0, 8)
CASES = tuple(f"{how}-V{V}-P{P}" for how, Vs in (("rules", VOCABS), ("forced", (97,)))
              for V in Vs for P in PREFIX)
SPAWN_LIMIT_S = 300
TOL = 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs():
    rng = np.random.default_rng(0)
    cases = {}
    for name in CASES:
        how, v, p = name.split("-")
        V, P = int(v[1:]), int(p[1:])
        cases[name] = {
            "placement": how, "prefix_len": P,
            "logits": torch.as_tensor(2.0 * rng.standard_normal((B, P + T, V)),
                                      dtype=torch.float32),
            "labels": torch.as_tensor(rng.integers(0, V, (B, T)))}
    return cases


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def single(inputs):
    """One device's loss and logits' gradient: the port's ``nll_loss``
    under autograd and the JAX package's ``value_and_grad``."""
    out = {}
    for name, c in inputs.items():
        lg = c["logits"].clone().requires_grad_()
        start, tgt = next_token_shift(c["labels"], c["prefix_len"])
        n = tgt.shape[1]
        loss = nll_loss(lg[:, start:start + n], tgt)
        (grad,) = torch.autograd.grad(loss, [lg])
        jt = jnp.asarray(tgt.numpy())
        jl, jg = jax.value_and_grad(lambda x: jax_nll_loss(x[:, start:start + n], jt))(
            jnp.asarray(c["logits"].numpy()))
        out[name] = {"port": (loss.detach(), grad),
                     "jax": (torch.tensor(np.asarray(jl)), torch.tensor(np.asarray(jg)))}
    return out


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: "x".join(map(str, m)))
def sharded(request, inputs, tmp_path_factory):
    mesh = request.param
    world = int(np.prod(mesh))
    root = tmp_path_factory.mktemp("vocab_loss")
    torch.save({"mesh": mesh, "loss_cases": inputs}, root / "inputs.pt")
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        worker.run_vocab_loss, args=(world, _free_port(), str(root)), nprocs=world,
        join=False, start_method="spawn")
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
def test_loss_on_a_mesh_matches_one_device(sharded, single, case):
    got = sharded["res"][case]
    for name, (loss, grad) in single[case].items():
        assert _close(got["loss"], loss) <= TOL, (name, sharded["mesh"], got["placements"])
        assert _close(got["grad"], grad) <= TOL, (name, sharded["mesh"], got["placements"])


# -- collectives ---------------------------------------------------------------

FB, FT, FV = 8, 256, 8192  # the logits of the lowering and the fake mesh

_JAX_LOWER = r"""
import json, re, sys
sys.path[:0] = [sys.argv[1] + "/src"]
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.core.losses import nll_loss

B, T, V = map(int, sys.argv[2:5])
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
fn = jax.value_and_grad(lambda lg, tg: nll_loss(lg[:, :-1], tg[:, 1:]))
comp = jax.jit(fn, in_shardings=(NamedSharding(mesh, P("data", None, "model")),
                                 NamedSharding(mesh, P("data", None)))).lower(
    jax.ShapeDtypeStruct((B, T, V), jnp.float32),
    jax.ShapeDtypeStruct((B, T), jnp.int32)).compile()
hlo = comp.as_text()
kinds = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
print(json.dumps({k: re.findall(r"= (\S+|\([^)]*\)) " + k + r"(?:-start)?\(", hlo)
                  for k in kinds}))
"""


def _fake_loss_collectives():
    """The port's ``_shift_loss`` on fake fp32 logits (FB, FT, FV), rows
    over "data" and vocab over "model" on a fake (2, 2) mesh, forward and
    backward: every collective's (kind, bytes) in call order."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import dispatch
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.runtime import Runtime

    class Calls(dryrun.Ledger):
        def __init__(self, device_type):
            super().__init__(device_type)
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = dict(self.coll_bytes), dict(self.coll_count)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            for kind, n in self.coll_count.items():
                if n != before[1].get(kind, 0):
                    self.calls.append((kind, self.coll_bytes[kind] - before[0].get(kind, 0.0)))
            return out

    dev = dryrun.card_device()
    with dryrun.fake_group(4):
        mesh = make_debug_mesh(2, 2, device_type=dev.type)
        rt = Runtime(mesh=mesh, device=dev)
        led = Calls(dev.type)
        with dispatch.card_stand_in(), FakeTensorMode():
            lg = torch.empty((FB // 2, FT, FV // 2), device=dev).requires_grad_()
            logits = DTensor.from_local(lg, mesh, (Shard(0), Shard(2)), run_check=False,
                                        shape=torch.Size((FB, FT, FV)),
                                        stride=(FT * FV, FV, 1))
            labels = DTensor.from_local(
                torch.empty((FB // 2, FT), dtype=torch.long, device=dev), mesh,
                (Shard(0), Replicate()), run_check=False, shape=torch.Size((FB, FT)),
                stride=(FT, 1))
            with dryrun._dtensor_metadata_hidden(led), led, rt.dist():
                loss = steps._shift_loss(logits, None, labels, 0)
                torch.autograd.grad(loss, [logits])
    return led.calls


def test_no_gather_of_the_logits_as_in_the_jax_lowering():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_LOWER, str(ROOT), str(FB), str(FT),
                             str(FV)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        ours = _fake_loss_collectives()
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    theirs = json.loads(out.strip().splitlines()[-1])
    assert not theirs["all-gather"] and theirs["all-reduce"], theirs
    print(f"JAX lowering's collectives: {theirs}; the port's: {ours}")
    rows = FB // 2  # a rank's rows
    assert ours and not [k for k, _ in ours if k != "all-reduce"], ours
    assert max(n for _, n in ours) <= rows * FT * 4, ours
    # the row max, the sum of exp, the target logit: (rows, T - 1) floats each
    assert [n for _, n in ours].count(rows * (FT - 1) * 4) == 3, ours


# -- no whole-vocab block ------------------------------------------------------

SMOKE = "olmoe-smoke"
MESH = (2, 4)  # "data", "model"
GB, GT = 8, 32  # the train step's batch and length


def test_no_whole_vocab_block_under_the_loss(monkeypatch):
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.runtime import Runtime

    made, on = [], [False]

    class Made(dryrun.Ledger):
        def track(self, t):
            loc = dryrun._local(t)
            if on[0] and loc.device.type == self.device_type and (
                    id(loc.untyped_storage()) not in self._live):
                made.append((loc.untyped_storage().nbytes(), tuple(loc.shape)))
            super().track(t)

    shift_loss, grads = steps._shift_loss, steps._grads

    def loss(logits, *a):
        on[0] = True
        try:
            out = shift_loss(logits, *a)
        finally:
            on[0] = False
        logits.register_hook(lambda g: on.__setitem__(0, False))  # the loss's backward ends
        return out

    def backward(*a):
        on[0] = True
        try:
            return grads(*a)
        finally:
            on[0] = False

    monkeypatch.setattr(dryrun, "Ledger", Made)
    monkeypatch.setattr(steps, "_shift_loss", loss)
    monkeypatch.setattr(steps, "_grads", backward)
    cfg = get_config(SMOKE)
    data, model = MESH
    with dryrun.fake_group(data * model):
        mesh = make_debug_mesh(data, model, device_type=dryrun.card_device().type)
        rec = dryrun.dry_run(cfg, ShapeSpec("train", GT, GB, "train"), Runtime(mesh=mesh))
    assert cfg.vocab % model == 0
    block = GB // data * GT * cfg.vocab // model * 4  # a rank's rows x T x V / model, fp32
    assert made, "nothing was made under the loss"
    assert max(n for n, _ in made) <= block, (block, sorted(made)[-3:])
    assert rec["memory_analysis"]["peak_bytes"] > 0
