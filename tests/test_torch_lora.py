"""LoRA adapters on the port's full-model path against the JAX package on
the CPU: ``apply_model``, ``prefill`` + ``decode_step``, ``ServingEngine``
and ``ContinuousBatchingServer`` with a bridged LoRA tree (``b``
nonzero), and ``merge_lora`` (the deployment form) against serving the
adapters; plus the port's own ``init_lora``.

Weights are the JAX ``init_params`` tree (key 0, fp32) through the
bridge. fp32 logits within 1e-4 (another summation order, many products
deep); greedy tokens identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_wave import lora_tree  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.lora import init_lora as jax_init_lora  # noqa: E402
from repro.inference.engine import Request as JaxRequest  # noqa: E402
from repro.inference.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.models import Runtime as JaxRuntime, init_params as jax_init_params  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.training.trainer import merge_lora as jax_merge_lora  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.bridge import lora_from_jax, params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.lora import LORA_TARGETS, init_lora, lora_scale  # noqa: E402
from repro_torch.inference import Request, ServingEngine  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402
from repro_torch.training import merge_lora  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-4, atol=1e-4)
JRT = JaxRuntime(kernel_backend="ref", zero_drop=True)
CPU = Runtime(device=torch.device("cpu"), zero_drop=True)
# granite: two MoE layers; deepseek: a dense layer, then MoE with shared experts
ARCHS = ["granite-moe-1b-a400m-smoke", "deepseek-moe-16b-smoke"]


@pytest.fixture(scope="module", params=ARCHS)
def m(request):
    arch = request.param
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jparams = jax_init_params(jax.random.key(0), jcfg, jnp.float32)
    nlora = lora_tree(jcfg, 4)
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=params_from_jax(jax.tree.map(np.asarray, jparams), tcfg),
                jlora=jax.tree.map(jnp.asarray, nlora), tlora=lora_from_jax(tcfg, nlora),
                sc=lora_scale(tcfg.melinoe),
                toks=np.random.default_rng(2).integers(0, jcfg.vocab, (2, 9)).astype(np.int32))


def test_apply_model_and_decode_with_lora_match_jax(m):
    sc, toks, jcfg = m["sc"], m["toks"], m["jcfg"]
    # the reference's functions, jitted once (eager JAX dispatches op by op)
    j_apply = jax.jit(lambda p, t, l: jmodel.apply_model(p, jcfg, t, JRT, lora=l,
                                                         lora_scale=sc)[0])
    j_prefill = jax.jit(lambda p, t, l: jmodel.prefill(p, jcfg, t, JRT, n_slots=18, lora=l,
                                                       lora_scale=sc))
    j_decode = jax.jit(lambda p, t, c, l: jmodel.decode_step(p, jcfg, t, c, JRT, lora=l,
                                                             lora_scale=sc)[:2])
    jl = j_apply(m["jparams"], jnp.asarray(toks), m["jlora"])
    tl, _ = tmodel.apply_model(m["tparams"], m["tcfg"], torch.as_tensor(toks).long(), CPU,
                               lora=m["tlora"], lora_scale=sc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    plain, _ = tmodel.apply_model(m["tparams"], m["tcfg"], torch.as_tensor(toks).long(), CPU)
    assert not np.allclose(plain.numpy(), tl.numpy(), atol=1e-2)  # the term acts

    # prefill + 8 greedy decode steps, both sides feeding their own tokens
    jlog, jc = j_prefill(m["jparams"], jnp.asarray(toks), m["jlora"])
    tlog, tc = tmodel.prefill(m["tparams"], m["tcfg"], torch.as_tensor(toks).long(), CPU,
                              n_slots=18, lora=m["tlora"], lora_scale=sc)
    for _ in range(9):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        jt, tt = jnp.argmax(jlog, -1), torch.argmax(tlog, -1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jlog, jc = j_decode(m["jparams"], jt, jc, m["jlora"])
        tlog, tc, _ = tmodel.decode_step(m["tparams"], m["tcfg"], tt, tc, CPU,
                                         lora=m["tlora"], lora_scale=sc)


def test_serving_engine_and_continuous_server_with_lora_match_jax(m):
    sc = m["sc"]
    prompts = [p for p in np.random.default_rng(3).integers(0, m["jcfg"].vocab, (3, 7))
               .astype(np.int32)]
    budgets = [4, 6, 3]
    jeng = JaxServingEngine(m["jcfg"], m["jparams"], rt=JRT, lora=m["jlora"], lora_scale=sc)
    jout = jeng.generate_batch([JaxRequest(p, n) for p, n in zip(prompts, budgets)])
    teng = ServingEngine(m["tcfg"], m["tparams"], lora=m["tlora"], lora_scale=sc)
    tout = teng.generate_batch([Request(p, n) for p, n in zip(prompts, budgets)])
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))

    def reqs(pkg):
        return [pkg.ServeRequest(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, budgets))]

    jsrv = jserving.ContinuousBatchingServer(m["jcfg"], m["jparams"], n_slots=2, max_len=16,
                                             rt=JRT, lora=m["jlora"], lora_scale=sc)
    jres, _ = jsrv.run(jserving.RequestQueue(reqs(jserving)))
    tsrv = serving.ContinuousBatchingServer(m["tcfg"], m["tparams"], n_slots=2, max_len=16,
                                            lora=m["tlora"], lora_scale=sc)
    tres, _ = tsrv.run(serving.RequestQueue(reqs(serving)))
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))


def test_merge_lora_serves_like_the_adapters(m):
    """The merged weights without LoRA give the logits of the base weights
    with it (1e-4), and merge as the reference merges them."""
    merged = merge_lora(m["tcfg"], m["tparams"], m["tlora"], m["sc"])
    toks = torch.as_tensor(m["toks"]).long()
    a, _ = tmodel.apply_model(merged, m["tcfg"], toks, CPU)
    b, _ = tmodel.apply_model(m["tparams"], m["tcfg"], toks, CPU, lora=m["tlora"],
                              lora_scale=m["sc"])
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    jmerged = jax_merge_lora(m["jcfg"], m["jparams"], m["jlora"], m["sc"])
    for (path, jleaf) in jax.tree_util.tree_leaves_with_path(jmerged):
        node = merged
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(jleaf), rtol=1e-6, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    # the input tree is left as it is
    g = next(iter(m["tlora"]))
    p = next(iter(m["tlora"][g]))
    assert not torch.equal(merged["groups"][g][p]["ffn"]["wu"],
                           m["tparams"]["groups"][g][p]["ffn"]["wu"])


def test_init_lora_layout_and_determinism():
    cfg = get_config("deepseek-moe-16b-smoke")
    spec = cfg.melinoe
    a = init_lora(cfg, spec, generator=torch.Generator().manual_seed(0))
    b = init_lora(cfg, spec, generator=torch.Generator().manual_seed(0))
    jtree = jax.eval_shape(lambda: jax_init_lora(
        jax.random.key(0), jax_get_config("deepseek-moe-16b-smoke"), spec))
    assert set(a) == set(jtree) and all(set(a[g]) == set(jtree[g]) for g in a)
    for g in a:
        for p in a[g]:
            for t in LORA_TARGETS:
                for k in ("a", "b"):
                    assert tuple(a[g][p][t][k].shape) == jtree[g][p][t][k].shape
                    assert torch.equal(a[g][p][t][k], b[g][p][t][k])
                assert not a[g][p][t]["b"].any() and a[g][p][t]["a"].std() > 0
    assert lora_scale(spec) == spec.lora_alpha / spec.lora_rank
    bad = {g: {p: {t: {"a": np.zeros((1, 1, 1, 1), np.float32), "b": v["b"].numpy()}
                   for t, v in pt.items()} for p, pt in gt.items()} for g, gt in a.items()}
    with pytest.raises(ValueError, match="do not fit"):
        lora_from_jax(cfg, bad)
