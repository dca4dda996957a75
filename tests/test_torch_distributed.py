"""Expert parallelism and the sharded model path of the port on the CPU:
one spawn of 4 processes over gloo, a (2, 2) ("data", "model") mesh
(``tests/_torch_dist_worker.py``), every sharded result held against the
single-device path, the port's and the JAX package's, on the same inputs.
(The JAX package's own sharded train step is not a reference on this
tree: ROADMAP, Queue 3.)

* ``apply_moe_sharded`` (E 8, top-2, zero_drop; with LoRA; under
  ``moe_dispatch_shard``) against ``apply_moe_local`` of both packages:
  2e-5 (measured 0; the JAX test allows its sharded layer 2e-4).
* a sharded MELINOE train step of granite-moe-1b-a400m-smoke (8 x 16
  tokens, AdamW at lr 1e-3), under the "tp" profile, ``pure_fsdp``,
  ``loss_token_shard`` and ``moe_dispatch_shard``, against the
  single-device step of either package: the loss within 1e-5; each
  leaf's gradient at the initial weights within 1e-5 of its largest
  element, and grad_norm within 1e-5 relative (measured at most 1.3e-6
  and 6.4e-8; a gradient of half the batch reads 1.43, and the expert
  gradients of an exchange whose transpose left out the 1/rep scale and
  the data-axis sum read 1.34); the updated parameters, 99% of elements
  within 1e-6 (measured 1.9e-9; that wrong gradient read 2.0e-3, the
  size of an update left out: AdamW's first step moves an element by
  about lr x the sign of its gradient, so the tail, where a near-zero
  gradient summed in another order flips its sign, is left to the
  gradient check). The JAX sharded test's own limits, 5e-3 and 5e-2, are
  the loosest allowed.
* a sharded prefill and 4 greedy decode steps (8 x 12 tokens): the
  single-device greedy tokens, prefill logits within 1e-4.

The spawn runs once per module (a fixture), with a time limit.
"""
import copy
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import MoESpec as JaxMoESpec  # noqa: E402
from repro.launch.steps import build_train_step as jax_build_train_step  # noqa: E402
from repro.launch.steps import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.models import Runtime as JaxRuntime  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.moe import apply_moe_local as jax_apply_moe_local  # noqa: E402
from repro.training.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro.training.optim import init_opt_state as jax_init_opt_state  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoESpec  # noqa: E402
from repro_torch.launch.steps import build_decode_step, build_prefill_step, build_train_step  # noqa: E402
from repro_torch.models.moe import apply_moe_local  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402
from repro_torch.training.optim import OptConfig, init_opt_state  # noqa: E402
import _torch_dist_worker as worker  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = [pytest.mark.torch, pytest.mark.fleet]

ARCH = "granite-moe-1b-a400m-smoke"
WORLD = 4
SPAWN_LIMIT_S = 300
MOE_TOL = 2e-5
# against either package's single-device step: the loss; each leaf's
# gradient, relative to its largest element, and grad_norm; the updated
# parameters, all but the UPDATE_QUANTILE tail within UPDATE_TOL (AdamW's
# first step moves an element by about lr x the sign of its gradient, so
# a near-zero gradient summed in another order can move it by up to 2 lr;
# an update left out moves nearly every element by lr)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-5
UPDATE_QUANTILE, UPDATE_TOL = 0.99, 1e-6
LOGITS_TOL = 1e-4
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
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    E, d, f, r = 8, 16, 32, 4
    moe_np = {"router": rng.standard_normal((d, E)) / 4,
              "wg": rng.standard_normal((E, d, f)) / 4, "wu": rng.standard_normal((E, d, f)) / 4,
              "wd": rng.standard_normal((E, f, d)) / 6}
    lora_np = {k: {"a": rng.standard_normal((E, din, r)) / 4,
                   "b": rng.standard_normal((E, r, dout)) / 4}
               for k, (din, dout) in (("wu", (d, f)), ("wd", (f, d)))}
    as_t = lambda t: {k: as_t(v) if isinstance(v, dict) else  # noqa: E731
                      torch.tensor(v, dtype=torch.float32) for k, v in t.items()}
    inputs = {
        "cfg": cfg, "params": params_from_jax(tree, cfg),
        "train_tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (8, 16))),
        "serve_tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (8, 12))),
        "moe_spec": MoESpec(num_experts=E, top_k=2, d_ff=f), "moe_params": as_t(moe_np),
        "moe_lora": as_t(lora_np),
        "moe_x": torch.tensor(rng.standard_normal((32, d)), dtype=torch.float32)}
    torch.save(inputs, root / "inputs.pt")
    t0 = time.perf_counter()
    ctx = torch.multiprocessing.start_processes(
        worker.run, args=(WORLD, _free_port(), str(root)), nprocs=WORLD, join=False,
        start_method="spawn")
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() - t0 > SPAWN_LIMIT_S:
                raise TimeoutError(f"the {WORLD} gloo workers took over {SPAWN_LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    res = torch.load(root / "results.pt", weights_only=False)
    return {"jcfg": jcfg, "cfg": cfg, "jparams": jparams, "inputs": inputs,
            "moe_np": moe_np, "lora_np": lora_np, "res": res,
            "spawn_s": time.perf_counter() - t0}


@pytest.mark.parametrize("key", ["moe", "moe_lora", "moe_dispatch_shard"])
def test_moe_sharded_matches_local(case, key):
    inp = case["inputs"]
    lora = inp["moe_lora"] if key == "moe_lora" else None
    rt = Runtime(kernel_backend="ref", device=torch.device("cpu"), zero_drop=True)
    ours, _ = apply_moe_local(inp["moe_params"], inp["moe_x"], inp["moe_spec"], rt, lora=lora,
                              lora_scale=0.5)
    jlora = None if lora is None else jax.tree.map(jnp.asarray, case["lora_np"])
    jspec = JaxMoESpec(num_experts=8, top_k=2, d_ff=32)
    theirs, _ = jax_apply_moe_local(jax.tree.map(jnp.asarray, case["moe_np"]),
                                    jnp.asarray(inp["moe_x"].numpy()), jspec,
                                    JaxRuntime(zero_drop=True), jlora, 0.5)
    y = case["res"][key]["y"]
    assert y.shape == (32, 16)
    np.testing.assert_allclose(y.numpy(), ours.numpy(), rtol=0, atol=MOE_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(theirs, np.float32), rtol=0, atol=MOE_TOL)
    from torch.distributed.tensor import Replicate, Shard

    # tokens over the data axis, and under moe_dispatch_shard the model axis too
    assert case["res"][key]["placements"] == (
        (Shard(0), Shard(0)) if key == "moe_dispatch_shard" else (Shard(0), Replicate()))


_SINGLE = {}


def _grad_rel(got: dict, want: dict) -> float:
    """The worst leaf's max |got - want| / max |want|."""
    assert got.keys() == want.keys()
    return max(float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
               for k in want)


def _single_train(case):
    """The single-device train step, the port's and the JAX package's:
    (loss, gradients at the initial weights, grad_norm, parameters after
    the step); and the port's gradients of half the batch, which any
    gradient limit must reject."""
    if not _SINGLE:
        inp = case["inputs"]
        params = copy.deepcopy(inp["params"])
        batch = {"tokens": inp["train_tokens"].numpy(), "labels": inp["train_tokens"].numpy()}
        step = build_train_step(case["cfg"], CPU, OptConfig(**worker.TRAIN_OPT), melinoe=True)
        grads = _flat(worker._full(step.loss_and_grads(params, batch)[2]))
        half = {k: v[:4] for k, v in batch.items()}
        half_grads = _flat(worker._full(step.loss_and_grads(params, half)[2]))
        params, _, m = step(params, init_opt_state(params), batch)
        jbatch = jax.tree.map(jnp.asarray, batch)
        jloss = jax_make_loss_fn(case["jcfg"], JaxRuntime(), melinoe=True)
        jgrads = jax.grad(lambda p: jloss(p, jbatch)[0])(case["jparams"])
        jstep = jax.jit(jax_build_train_step(case["jcfg"], JaxRuntime(),
                                             JaxOptConfig(**worker.TRAIN_OPT), melinoe=True))
        jp, _, jm = jstep(case["jparams"], jax_init_opt_state(case["jparams"]), jbatch)
        _SINGLE.update(
            port=(m["loss"].item(), grads, m["grad_norm"].item(), _flat(params)),
            jax=(float(jm["loss"]), _flat(jax.tree.map(np.asarray, jgrads)),
                 float(jm["grad_norm"]), _flat(jax.tree.map(np.asarray, jp))),
            half_rel=_grad_rel(half_grads, grads))
    return _SINGLE


def test_gradient_limit_rejects_half_batch(case):
    """GRAD_TOL is far below what a gradient of half the batch reads."""
    single = _single_train(case)
    assert single["half_rel"] > 100 * GRAD_TOL, single["half_rel"]


@pytest.mark.parametrize("key", ["train_tp", "train_pure_fsdp", "train_loss_token_shard",
                                 "train_moe_dispatch_shard"])
def test_train_step_sharded_matches_single_device(case, key):
    single = _single_train(case)
    got = case["res"][key]
    grads, params = _flat(got["grads"]), _flat(got["params"])
    for name in ("port", "jax"):
        loss, want_grads, grad_norm, want_params = single[name]
        assert abs(got["loss"] - loss) <= LOSS_TOL, (name, got["loss"], loss)
        rel = _grad_rel(grads, want_grads)
        assert rel <= GRAD_TOL, (name, rel)
        assert abs(got["grad_norm"] - grad_norm) <= GRAD_TOL * grad_norm, (name, got["grad_norm"])
        assert params.keys() == want_params.keys()
        moved = np.concatenate([np.abs(params[k] - want_params[k]).ravel() for k in params])
        assert np.quantile(moved, UPDATE_QUANTILE) <= UPDATE_TOL, (
            name, np.quantile(moved, UPDATE_QUANTILE))


@pytest.mark.parametrize("key", ["serve_tp", "serve_pure_fsdp"])
def test_prefill_decode_sharded_match_single_device(case, key):
    inp, cfg = case["inputs"], case["cfg"]
    toks = inp["serve_tokens"]
    n = worker.DECODE_STEPS
    with torch.no_grad():
        logits, cache = build_prefill_step(cfg, CPU, n_slots=toks.shape[1] + n)(
            inp["params"], {"tokens": toks})
        first = logits[:, 0]
        out = [logits.argmax(-1)]
        for _ in range(n):
            logits, cache = build_decode_step(cfg, CPU)(
                inp["params"], {"tokens": out[-1], "cache": cache})
            out.append(logits.argmax(-1))
    want = torch.cat(out, 1)
    jrt = JaxRuntime(zero_drop=True)
    jl, jc = jax_prefill(case["jparams"], case["jcfg"], jnp.asarray(toks.numpy()), jrt,
                         n_slots=toks.shape[1] + n)
    jt = [jnp.argmax(jl, -1)]
    for _ in range(n):
        jl, jc, _ = jax_decode_step(case["jparams"], case["jcfg"], jt[-1], jc, jrt)
        jt.append(jnp.argmax(jl, -1))
    got = case["res"][key]
    np.testing.assert_array_equal(got["tokens"].numpy(), want.numpy())
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(jnp.concatenate(jt, 1)))
    np.testing.assert_allclose(got["prefill_logits"].numpy(), first.numpy(), rtol=0,
                               atol=LOGITS_TOL)
