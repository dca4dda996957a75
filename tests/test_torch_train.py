"""The port's MELINOE fine-tuning and training steps against the JAX
package's on the CPU, on ``tests/util.py::melinoe_test_config`` (granite
smoke, 8 experts top-2, C = 2) and its port twin, from the same bridged
fp32 weights (JAX ``init_params``, key 0) and a LoRA tree drawn from a
numpy seed (``a`` ~ N(0, 1/din), ``b`` ~ N(0, 1/r) nonzero, so that every
adapter has a gradient at step 0; the JAX ``init_lora`` draw depends on
``PYTHONHASHSEED``).

Tolerances (fp32 on both sides, the sums in another order):

* losses and metrics: 1e-5 relative;
* step-0 gradients: ||port - ref|| / ||ref|| <= 1e-4 per leaf;
* parameters after 3 fine-tune steps (lr 3e-3) and after one train step,
  per leaf: ||port - ref|| <= 1e-3 x ||ref - start||, and max |port -
  ref| <= 0.25 x lr. Adam moves each weight by about lr a step whatever
  the gradient's size; where a gradient is near Adam's eps (1e-8) a
  difference in its last bits moves that weight's update by a part of lr,
  and later steps carry it. Over 12 numpy draws of the adapters the worst
  weight ended 0.105 x lr from the reference and the worst leaf 3.7e-4 of
  its update in norm;
* ``remat=True`` against ``remat=False``: 1e-6 (the same operations,
  recomputed).

The trainable mask must equal the reference's leaf for leaf; frozen
leaves are not copied and stay untouched.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import lora as jlora_mod  # noqa: E402
from repro.core.losses import combine as jcombine  # noqa: E402
from repro.data.synthetic import ClusterLM, SyntheticConfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
from repro_torch.bridge import lora_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoESpec  # noqa: E402
from repro_torch.core import lora as tlora_mod  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training import trainer as ttrainer  # noqa: E402
from repro_torch.training.checkpoint import load_checkpoint  # noqa: E402
from util import melinoe_test_config  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

CPU = Runtime(kernel_backend="ref", device=torch.device("cpu"))
LR = 3e-3


def port_melinoe_test_config(arch="granite-moe-1b-a400m", *, num_experts=8, top_k=2):
    """``tests/util.py::melinoe_test_config`` on the port's config classes."""
    cfg = get_config(arch + "-smoke")
    bd = dict(cfg.block_defs)
    for name, b in bd.items():
        if b.moe is not None:
            bd[name] = dataclasses.replace(b, moe=MoESpec(
                num_experts=num_experts, top_k=top_k, d_ff=b.moe.d_ff,
                num_shared=b.moe.num_shared, shared_d_ff=b.moe.shared_d_ff,
                capacity_factor=2.0))
    mel = dataclasses.replace(cfg.melinoe, cache_capacity=num_experts // 4)
    return dataclasses.replace(cfg, block_defs=bd, melinoe=mel,
                               name=cfg.name + f"-e{num_experts}")


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _params_close(got, want, start, path):
    d = _np(got) - want
    assert np.linalg.norm(d) <= 1e-3 * np.linalg.norm(want - _np(start)), path
    assert np.abs(d).max() <= 0.25 * LR, path


def _np(t):
    if isinstance(t, list):
        t = torch.stack(t)
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = melinoe_test_config(), port_melinoe_test_config()
    jparams = jmodel.init_params(jax.random.key(0), jcfg, jnp.float32)
    shapes = jax.eval_shape(lambda: jlora_mod.init_lora(jax.random.key(1), jcfg,
                                                        jcfg.melinoe))
    rng = np.random.default_rng(3)
    jl = {g: {p: {t: {"a": (rng.standard_normal(ab["a"].shape)
                            / np.sqrt(ab["a"].shape[-2])).astype(np.float32),
                      "b": (rng.standard_normal(ab["b"].shape)
                            * jcfg.melinoe.lora_rank**-0.5).astype(np.float32)}
                      for t, ab in pt.items()} for p, pt in gt.items()}
          for g, gt in shapes.items()}
    jl = jax.tree.map(jnp.asarray, jl)
    lm = ClusterLM(SyntheticConfig(vocab=jcfg.vocab, seq_len=16, seed=0))
    it = lm.batches(2, seed=1)
    batches = [{k: v for k, v in next(it).items()} for _ in range(3)]
    tree = jax.tree.map(np.asarray, jparams)
    ltree = jax.tree.map(np.asarray, jl)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, jlora=jl, tree=tree, ltree=ltree,
                batches=batches)


def _tparams(s):
    return params_from_jax(s["tree"], s["tcfg"]), lora_from_jax(s["tcfg"], s["ltree"])


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items() if k != "cluster"}


@pytest.fixture(scope="module")
def jax_finetune(setup):
    """The reference's step-0 loss, metrics and gradients, and its
    trajectory over 3 ``build_finetune_step`` steps."""
    jcfg = setup["jcfg"]
    spec = jcfg.melinoe
    rt = JaxRuntime()
    base = jlora_mod.extract_base_routers(setup["jparams"], jcfg)

    def loss_fn(trainable, batch):
        params, lora = trainable
        mel = jmodel.MelinoeRun(spec=spec, cache_capacity=jcfg.melinoe_cache_capacity(),
                                base_routers=base)
        logits, aux = jmodel.apply_model(params, jcfg, batch["tokens"], rt, melinoe=mel,
                                         lora=lora, lora_scale=jlora_mod.lora_scale(spec))
        nll = jsteps._shift_loss(logits, batch["tokens"], batch["labels"], 0)
        total = jcombine(nll, aux["cs_loss"], aux["rm_loss"], spec)
        return total, {"nll": nll, "cs_loss": aux["cs_loss"], "rm_loss": aux["rm_loss"],
                       "loss": total, "logits": logits}

    b0 = _jbatch(setup["batches"][0])
    (_, m0), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        (setup["jparams"], setup["jlora"]), b0)
    mask = jlora_mod.melinoe_trainable_mask(setup["jparams"])
    opt = joptim.OptConfig(peak_lr=LR, total_steps=3, min_lr_frac=0.1)
    step = jax.jit(jsteps.build_finetune_step(jcfg, rt, opt, mask))
    params, lora = setup["jparams"], setup["jlora"]
    state = joptim.init_opt_state((params, lora))
    hist = []
    for b in setup["batches"]:
        params, lora, state, m = step(params, lora, state, _jbatch(b), base)
        hist.append({k: float(v) for k, v in m.items()})
    return dict(m0=m0, grads=jax.tree.map(np.asarray, grads), mask=mask, hist=hist,
                params=jax.tree.map(np.asarray, params), lora=jax.tree.map(np.asarray, lora))


def _port_finetune_step(s, mask):
    opt = toptim.OptConfig(peak_lr=LR, total_steps=3, min_lr_frac=0.1)
    return tsteps.build_finetune_step(s["tcfg"], CPU, opt, mask), opt


def test_apply_model_melinoe_losses_match(setup, jax_finetune):
    s = setup
    tparams, tlora = _tparams(s)
    mel = tmodel.MelinoeRun(spec=s["tcfg"].melinoe,
                            cache_capacity=s["tcfg"].melinoe_cache_capacity(),
                            base_routers=tlora_mod.extract_base_routers(tparams, s["tcfg"]))
    toks = torch.as_tensor(s["batches"][0]["tokens"], dtype=torch.long)
    with torch.no_grad():
        logits, aux = tmodel.apply_model(tparams, s["tcfg"], toks, CPU, melinoe=mel,
                                         lora=tlora,
                                         lora_scale=tlora_mod.lora_scale(s["tcfg"].melinoe))
    m0 = jax_finetune["m0"]
    np.testing.assert_allclose(logits.numpy(), np.asarray(m0["logits"]), rtol=1e-5,
                               atol=1e-5)
    for k in ("cs_loss", "rm_loss"):
        np.testing.assert_allclose(float(aux[k]), float(m0[k]), rtol=1e-5)
    assert float(aux["cs_loss"]) > 0 and float(aux["rm_loss"]) > 0
    # without melinoe there are no loss entries, and collect_probs alone
    # gives the probes only
    _, aux2 = tmodel.apply_model(tparams, s["tcfg"], toks, CPU, collect_probs=True)
    assert set(aux2) == {"probs"}


def test_trainable_mask_matches_reference():
    for arch in ("granite-moe-1b-a400m-smoke", "deepseek-moe-16b-smoke"):
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        jp = jmodel.init_params(jax.random.key(0), jcfg, jnp.float32)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
        jm = _flat(jlora_mod.melinoe_trainable_mask(jp))
        tm = _flat(tlora_mod.melinoe_trainable_mask(tp))
        assert tm == jm
        assert any(tm.values()) and not all(tm.values())
    # deepseek's dense first layer keeps its MLP wg frozen
    assert tm["/groups/g0/p0/ffn/wg"] is False
    assert tm["/groups/g0/p1/ffn/wg"] is True and tm["/groups/g0/p1/ffn/router"] is True
    # apply_mask zeroes (or scales) the frozen leaves, as the reference's
    for fv in (0.0, 0.5):
        got = _flat(tlora_mod.apply_mask(tp, tlora_mod.melinoe_trainable_mask(tp), fv))
        want = _flat(jlora_mod.apply_mask(jp, jlora_mod.melinoe_trainable_mask(jp), fv))
        for path, t in got.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[path]))


def test_finetune_step0_gradients_match(setup, jax_finetune):
    s = setup
    tparams, tlora = _tparams(s)
    mask = tlora_mod.melinoe_trainable_mask(tparams)
    step, _ = _port_finetune_step(s, mask)
    base = tlora_mod.extract_base_routers(tparams, s["tcfg"])
    loss, metrics, (gp, gl) = step.loss_and_grads(tparams, tlora, s["batches"][0], base)
    m0 = jax_finetune["m0"]
    for k in ("loss", "nll", "cs_loss", "rm_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(m0[k]), rtol=1e-5)
    jgp, jgl = jax_finetune["grads"]
    n = 0
    for tg_tree, jg_tree in ((gp, jgp), (gl, jgl)):
        tflat, jflat = _flat(tg_tree), _flat(jg_tree)
        for path, tg in tflat.items():
            if tg is None:  # frozen: the reference's gradient is masked away
                continue
            ref = jflat[path]
            rel = np.linalg.norm(_np(tg) - ref) / max(np.linalg.norm(ref), 1e-30)
            assert rel <= 1e-4, (path, rel)
            assert np.linalg.norm(ref) > 0, path
            n += 1
    # router + wg per MoE position, and a, b of wu and wd
    assert n == 2 * 2 + 4 * 2


def test_finetune_three_steps_track_reference(setup, jax_finetune):
    s = setup
    tparams, tlora = _tparams(s)
    before = {k: v.clone() for k, v in _flat(tparams).items()}
    mask = tlora_mod.melinoe_trainable_mask(tparams)
    step, _ = _port_finetune_step(s, mask)
    base = tlora_mod.extract_base_routers(tparams, s["tcfg"])
    state = toptim.init_opt_state((tparams, tlora), (mask, True))
    for i, b in enumerate(s["batches"]):
        tparams, tlora, state, m = step(tparams, tlora, state, b, base)
        for k in ("loss", "nll", "cs_loss", "rm_loss"):
            np.testing.assert_allclose(float(m[k]), jax_finetune["hist"][i][k], rtol=1e-5)
    assert state["step"] == 3
    jflat = _flat(jax_finetune["params"])
    fmask = _flat(mask)
    for path, t in _flat(tparams).items():
        if fmask[path]:
            _params_close(t, jflat[path], before[path], path)
        else:
            assert torch.equal(t, before[path]), path  # frozen: untouched
    jlf = _flat(jax_finetune["lora"])
    lstart = _flat(lora_from_jax(s["tcfg"], s["ltree"]))
    for path, t in _flat(tlora).items():
        _params_close(t, jlf[path], lstart[path], path)
    # moments exist for the trainable leaves only
    assert len(state["mu"]) == sum(fmask.values()) + len(jlf)


def test_train_step_matches_reference(setup):
    s = setup
    opt_j = joptim.OptConfig(peak_lr=LR, total_steps=4, weight_decay=0.01)
    jstep = jax.jit(jsteps.build_train_step(s["jcfg"], JaxRuntime(), opt_j))
    jp, _, jm = jstep(s["jparams"], joptim.init_opt_state(s["jparams"]),
                      _jbatch(s["batches"][0]))
    tparams, _ = _tparams(s)
    start = {k: v.clone() for k, v in _flat(tparams).items()}
    opt_t = toptim.OptConfig(peak_lr=LR, total_steps=4, weight_decay=0.01)
    tstep = tsteps.build_train_step(s["tcfg"], CPU, opt_t)
    tparams, state, tm = tstep(tparams, toptim.init_opt_state(tparams), s["batches"][0])
    for k in ("loss", "nll", "cs_loss", "rm_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    jflat = _flat(jax.tree.map(np.asarray, jp))
    for path, t in _flat(tparams).items():
        _params_close(t, jflat[path], start[path], path)
    assert state["step"] == 1


def test_remat_gradients_equal_plain(setup):
    s = setup
    tparams, tlora = _tparams(s)
    cfg = s["tcfg"]
    mel = tmodel.MelinoeRun(spec=cfg.melinoe, cache_capacity=cfg.melinoe_cache_capacity(),
                            base_routers=tlora_mod.extract_base_routers(tparams, cfg))
    toks = torch.as_tensor(s["batches"][0]["tokens"], dtype=torch.long)
    out = []
    for remat in (False, True):
        p, lo = _tparams(s)
        leaves = [p["groups"]["g0"]["p0"]["ffn"]["router"], p["groups"]["g0"]["p0"]["ffn"]["wg"],
                  p["embed"], lo["g0"]["p0"]["wu"]["a"], lo["g0"]["p0"]["wd"]["b"]]
        for t in leaves:
            t.requires_grad_()
        logits, aux = tmodel.apply_model(p, cfg, toks, CPU, melinoe=mel, lora=lo,
                                         lora_scale=tlora_mod.lora_scale(cfg.melinoe),
                                         remat=remat)
        loss = logits.logsumexp(-1).mean() + aux["cs_loss"] + aux["rm_loss"]
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=1e-6)
    for a, b in zip(out[1][1], out[0][1]):
        assert b.abs().sum() > 0
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_melinoe_finetune_leaves_the_base_and_frozen_leaves_alone(setup):
    s = setup
    tparams, _ = _tparams(s)
    snap = {k: v.clone() for k, v in _flat(tparams).items()}
    res = ttrainer.melinoe_finetune(s["tcfg"], tparams, iter(s["batches"]), steps=2,
                                    rt=CPU, log_every=1, verbose=False)
    mask = _flat(tlora_mod.melinoe_trainable_mask(tparams))
    base, out = _flat(tparams), _flat(res.params)
    for path, t in base.items():
        assert torch.equal(t, snap[path]), path  # the base is left as it is
        if mask[path]:
            assert out[path] is not t and not torch.equal(out[path], t), path
        else:
            assert out[path] is t, path  # shared, not copied
    assert len(res.history) == 2 and np.isfinite(res.last("loss"))
    # the adapters start with b = 0 and move
    assert all(b.abs().sum() > 0 for p, b in _flat(res.lora).items() if p.endswith("/b"))


def test_eval_nll_matches_reference(setup):
    s = setup
    tparams, tlora = _tparams(s)
    sc = jlora_mod.lora_scale(s["jcfg"].melinoe)
    want = jtrainer.eval_nll(s["jcfg"], s["jparams"], s["batches"][:2], lora=s["jlora"],
                             scale=sc)
    got = ttrainer.eval_nll(s["tcfg"], tparams, s["batches"][:2], rt=CPU, lora=tlora,
                            scale=sc)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_launch_train_on_cpu_writes_reference_checkpoints(tmp_path, capsys):
    arch = "granite-moe-1b-a400m-smoke"
    out = ttrain.main(["--arch", arch, "--steps", "2", "--ft-steps", "2", "--batch", "2",
                       "--seq", "16", "--mode", "both", "--device", "cpu", "--out",
                       str(tmp_path)])
    assert "done" in capsys.readouterr().out
    assert (tmp_path / f"{arch}_base_history.json").exists()
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    like = jax.eval_shape(lambda: jmodel.init_params(jax.random.key(0), jcfg, jnp.float32))
    jtree, step, meta = jckpt.load_checkpoint(out["base"], like)
    assert step == 2 and meta["stage"] == "pretrain"
    tlike = tmodel.init_params(tcfg, generator=torch.Generator(), dtype=torch.float32,
                               device="meta")
    ttree, _, _ = load_checkpoint(out["base"], tlike)
    jf = _flat(jax.tree.map(np.asarray, jtree))
    for path, t in _flat(ttree).items():
        np.testing.assert_array_equal(t.numpy(), jf[path])
    lora_like = tlora_mod.init_lora(tcfg, tcfg.melinoe, generator=torch.Generator(),
                                    device="meta")
    (fp, fl), fstep, fmeta = load_checkpoint(out["melinoe"], (tlike, lora_like))
    assert fstep == 2 and fmeta["stage"] == "melinoe"
    assert all(torch.isfinite(t).all() for t in _flat(fl).values())
    with pytest.raises(AssertionError, match="requires --mode both"):
        ttrain.main(["--arch", arch, "--mode", "finetune", "--device", "cpu", "--out",
                     str(tmp_path / "ft")])
