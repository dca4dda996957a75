"""The sharded Mamba mixer on the CPU (``models/mamba2.py::apply_mamba_sharded``):
zamba2-7b-smoke, whose Mamba2 blocks run head-parallel over the "model"
axis with their weights and state kept in ``distributed/sharding.py``'s
placements, on gloo meshes of processes (``tests/_torch_dist_worker.py::
run_model``), against the single-device path on the same weights (fp32),
the port's and the JAX package's, as ``tests/test_torch_distributed.py``
holds its sharded path (the JAX package's own sharded step is not a
reference on this tree: ROADMAP, Queue 3). Two meshes: (2, 2) ("data",
"model"), 4 processes; and (1, 3), 3 processes, whose model axis divides
neither the config's 8 heads nor its 256 ``d_inner`` rows (so ``norm_w``,
``out_proj`` and the ``ssm`` state stay whole, and the heads split 3, 3, 2)
while it divides its 552 ``in_proj`` columns and 288 conv channels (split
across the head blocks). The weights are the JAX package's
``init_params`` at seed 0, bridged into the port:

* the MELINOE train step's loss within 1e-5 relative, each leaf's
  gradient at the initial weights within 1e-5 of its largest element and
  grad_norm within 1e-5 relative (the limits of
  ``tests/test_torch_distributed.py``);
* a prefill and 4 greedy decode steps: the same tokens, prefill logits
  within 1e-4 relative (Frobenius).

The spawn runs once per mesh (a module fixture), with a time limit. A
last test runs the sharded steps once on fake tensors under the dry run's
``Ledger`` (``launch/dryrun.py``) and holds that the mixer gathers no
weight whole: its all-gather bytes a device stay below one layer's
``in_proj`` (they are none), while it does exchange (all_to_all,
all_reduce).
"""
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.steps import build_train_step as jax_build_train_step  # noqa: E402
from repro.launch.steps import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.models import Runtime as JaxRuntime  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.training.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro.training.optim import init_opt_state as jax_init_opt_state  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import build_decode_step, build_prefill_step, build_train_step  # noqa: E402,E501
from repro_torch.models.runtime import Runtime  # noqa: E402
from repro_torch.training.optim import OptConfig  # noqa: E402
import _torch_dist_worker as worker  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = [pytest.mark.torch, pytest.mark.fleet]

ARCH = "zamba2-7b-smoke"
MESHES = ((2, 2), (1, 3))  # ("data", "model")
SPAWN_LIMIT_S = 300
LOSS_TOL, GRAD_TOL, LOGITS_TOL = 1e-5, 1e-5, 1e-4
CPU = Runtime(kernel_backend="ref", device=torch.device("cpu"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: np.asarray(tree)}


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    rng = np.random.default_rng(0)
    inputs = {"cfg": cfg, "params": params_from_jax(jax.tree.map(np.asarray, jparams), cfg),
              "train_tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16))),
              "serve_tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (4, 12)))}
    return {"jcfg": jcfg, "cfg": cfg, "jparams": jparams, "inputs": inputs}


@pytest.fixture(scope="module")
def single(weights):
    """The single-device references, the port's and the JAX package's,
    computed once for both meshes."""
    return {"train": _single_train(weights), "serve": _serve_one(weights, worker.DECODE_STEPS)}


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def case(request, weights, tmp_path_factory):
    mesh = request.param
    world = mesh[0] * mesh[1]
    root = tmp_path_factory.mktemp("dist_mamba")
    inputs = {**weights["inputs"], "mesh": mesh}
    torch.save(inputs, root / "inputs.pt")
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        worker.run_model, args=(world, _free_port(), str(root)), nprocs=world, join=False,
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
    return {**weights, "mesh": mesh, "res": torch.load(root / "results.pt", weights_only=False)}


def _single_train(case):
    """(loss, gradients at the initial weights, grad_norm) of the
    single-device train step, the port's and the JAX package's."""
    inp = case["inputs"]
    batch = {"tokens": inp["train_tokens"], "labels": inp["train_tokens"]}
    step = build_train_step(case["cfg"], CPU, OptConfig(**worker.TRAIN_OPT), melinoe=True)
    loss, _, grads = step.loss_and_grads(worker._full(inp["params"]), batch)
    grads = _flat(worker._full(grads))
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jloss = jax_make_loss_fn(case["jcfg"], JaxRuntime(), melinoe=True)
    jgrads = jax.grad(lambda p: jloss(p, jbatch)[0])(case["jparams"])
    jstep = jax.jit(jax_build_train_step(case["jcfg"], JaxRuntime(),
                                         JaxOptConfig(**worker.TRAIN_OPT), melinoe=True))
    _, _, jm = jstep(case["jparams"], jax_init_opt_state(case["jparams"]), jbatch)
    return {"port": (loss.item(), grads, norm),
            "jax": (float(jm["loss"]), _flat(jax.tree.map(np.asarray, jgrads)),
                    float(jm["grad_norm"]))}


def _serve_one(case, steps):
    """The worker's serve on one device, the port's and the JAX package's:
    (prefill logits of the last position, greedy tokens)."""
    cfg, params, toks = case["cfg"], case["inputs"]["params"], case["inputs"]["serve_tokens"]
    with torch.no_grad():
        logits, cache = build_prefill_step(cfg, CPU, n_slots=toks.shape[1] + steps)(
            params, {"tokens": toks})
        out, first = [logits.argmax(-1)], logits
        decode = build_decode_step(cfg, CPU)
        for _ in range(steps):
            logits, cache = decode(params, {"tokens": out[-1], "cache": cache})
            out.append(logits.argmax(-1))
    jrt = JaxRuntime(zero_drop=True)
    jl, jc = jax_prefill(case["jparams"], case["jcfg"], jnp.asarray(toks.numpy()), jrt,
                         n_slots=toks.shape[1] + steps)
    jfirst, jt = jl, [jnp.argmax(jl, -1)]
    for _ in range(steps):
        jl, jc, _ = jax_decode_step(case["jparams"], case["jcfg"], jt[-1], jc, jrt)
        jt.append(jnp.argmax(jl, -1))
    return {"port": (first[:, 0], torch.cat(out, 1)),
            "jax": (torch.tensor(np.asarray(jfirst[:, 0], np.float32)),
                    torch.tensor(np.asarray(jnp.concatenate(jt, 1))))}


def test_sharded_mamba_train_gradients_match_one_device(case, single):
    got = case["res"]["train_tp"]
    have = _flat(got["grads"])
    assert any("mixer/in_proj" in k for k in have)  # the Mamba mixer's weights are in it
    for name, (loss, want, norm) in single["train"].items():
        assert abs(got["loss"] - loss) <= LOSS_TOL * abs(loss), (name, got["loss"], loss)
        assert want.keys() == have.keys(), name
        assert abs(got["grad_norm"] - norm) <= GRAD_TOL * norm, (name, got["grad_norm"], norm)
        for k, w in want.items():
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(have[k] - w).max()) <= GRAD_TOL * scale, (name, k)


def test_sharded_mamba_serve_matches_one_device(case, single):
    got = case["res"]["serve_tp"]
    for name, (first, tokens) in single["serve"].items():
        assert torch.equal(got["tokens"], tokens), name
        rel = (got["prefill_logits"] - first).norm() / first.norm()
        assert rel <= LOGITS_TOL, (name, float(rel))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mixer_gathers_no_weight_whole(mode, mesh):
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import blocks

    cfg = get_config(ARCH)
    spec = cfg.block_defs["mamba"].ssm
    di, nh = spec.d_inner(cfg.d_model), spec.n_heads(cfg.d_model)
    in_proj = cfg.d_model * (2 * di + 2 * spec.n_groups * spec.d_state + nh) * 4  # fp32
    seen = {}
    with dryrun.fake_group(mesh[0] * mesh[1]):
        rt = Runtime(mesh=make_debug_mesh(*mesh, device_type=dryrun.card_device().type))
        with dryrun.tally(blocks, ("apply_mamba_full", "apply_mamba_decode"), seen):
            rec = dryrun.dry_run(cfg, ShapeSpec(mode, 64, 4, mode), rt)
    n_mamba = sum(g.repeats * g.pattern.count("mamba") for g in cfg.layout)
    assert seen["calls"] >= n_mamba  # every Mamba block (twice a block under remat)
    assert seen["coll_bytes"].get("all-gather", 0.0) < in_proj, dict(seen["coll_bytes"])
    assert seen["coll_bytes"].get("all-to-all", 0.0) > 0 and \
        seen["coll_bytes"].get("all-reduce", 0.0) > 0, dict(seen["coll_bytes"])
    assert rec["collectives"]["total_bytes"] >= sum(seen["coll_bytes"].values())
