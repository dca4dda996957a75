"""The port's MoE layer on the full-model path — dispatch, the grouped
expert FFN, ``apply_moe_local``, ``attn_moe`` blocks in ``apply_model``
and ``prefill``/``decode_step`` with router probes — against the JAX
package on the CPU, at smoke size.

Weights are JAX ``init_params`` / ``init_moe`` trees carried across by
the bridge; inputs are drawn with numpy. The JAX side runs its plain path
(``Runtime(kernel_backend="ref")``), and once the Pallas ``gmm`` in
interpret mode (``"ref,moe_gmm=pallas"``). Tolerances, fp32: dispatch
(expert ids, slots, gates, drops) exact; one MoE layer 1e-5 (summation
order); logits 1e-4 (many products deep).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import MoESpec as JaxMoESpec  # noqa: E402
from repro.models import Runtime as JaxRuntime, apply_model as jax_apply_model  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_params as jax_init_params, prefill as jax_prefill  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoESpec  # noqa: E402
from repro_torch.models import model as tmodel, moe as tmoe  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["olmoe-mini-smoke", "granite-moe-1b-a400m-smoke", "deepseek-moe-16b-smoke"]


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _routes(seed, N, E, K):
    """JAX router probabilities and top-k for one seed, as numpy."""
    logits = np.random.default_rng(seed).standard_normal((N, E)).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gates, eids = jmoe.top_k_route(probs, K)
    return np.asarray(probs), np.asarray(gates), np.asarray(eids)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("K,cap", [(1, 2), (2, 3), (4, 5), (2, 16)])
def test_make_dispatch_matches_jax(seed, K, cap):
    """Slots, sentinel, zeroed gates and which assignments drop are the
    reference's, bit for bit (cap 16 keeps everything)."""
    E, N = 8, 16
    probs, gates, eids = _routes(seed, N, E, K)
    tg, te = tmoe.top_k_route(_t(probs), K)
    np.testing.assert_array_equal(te.numpy(), eids)
    np.testing.assert_array_equal(tg.numpy(), gates)
    jd = jmoe.make_dispatch(jnp.asarray(gates), jnp.asarray(eids),
                            JaxMoESpec(num_experts=E, top_k=K, d_ff=8), cap)
    td = tmoe.make_dispatch(_t(gates), _t(eids), MoESpec(num_experts=E, top_k=K, d_ff=8),
                            cap)
    assert td.cap == cap and td.eids.dtype == torch.int32 and td.pos.dtype == torch.int32
    for name in ("eids", "pos", "gates"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)), err_msg=name)
    dropped = td.eids.numpy() == E
    assert dropped.any() == (cap < 16 and np.bincount(eids.ravel(), minlength=E).max() > cap)
    # kept counts per expert are the group sizes, and fill slots 0 .. n-1
    sizes = tmoe.group_sizes(td, E).numpy()
    np.testing.assert_array_equal(sizes, np.minimum(np.bincount(eids.ravel(), minlength=E),
                                                    cap))
    for e in range(E):
        assert sorted(td.pos.numpy()[td.eids.numpy() == e]) == list(range(sizes[e]))


def test_capacity_drop_loses_lowest_priority():
    """Tokens are dispatched in order; overflow drops the later tokens
    (the rule of tests/test_moe.py::test_capacity_drop_loses_lowest_priority)."""
    d = tmoe.make_dispatch(torch.ones((4, 1)), torch.zeros((4, 1), dtype=torch.int32),
                           MoESpec(num_experts=2, top_k=1, d_ff=4), cap=2)
    assert (d.eids[:, 0] < 2).tolist() == [True, True, False, False]
    assert d.gates[:, 0].tolist() == [1.0, 1.0, 0.0, 0.0]


def _moe_params(shared: bool, d=64, E=8, K=2, f=32, capacity_factor=1.0):
    jspec = JaxMoESpec(num_experts=E, top_k=K, d_ff=f, shared_d_ff=48 if shared else 0,
                       capacity_factor=capacity_factor)
    tspec = MoESpec(num_experts=E, top_k=K, d_ff=f, shared_d_ff=48 if shared else 0,
                    capacity_factor=capacity_factor)
    jp = jmoe.init_moe(jax.random.key(3), d, jspec, jnp.float32)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    return jspec, tspec, jp, tp


@pytest.mark.parametrize("shared,zero_drop,jax_backend", [
    (False, False, "ref"),
    (True, False, "ref"),
    (False, True, "ref"),
    (True, True, "ref"),
    (False, False, "ref,moe_gmm=pallas"),  # the Pallas gmm, interpret mode
])
def test_apply_moe_local_matches_jax(shared, zero_drop, jax_backend):
    """One MoE layer: capacity 6 for 24 tokens x top-2 over 8 experts drops
    assignments (or none under zero_drop); the shared expert adds on."""
    jspec, tspec, jp, tp = _moe_params(shared)
    x = np.random.default_rng(4).standard_normal((24, 64)).astype(np.float32)
    jy, jprobs = jmoe.apply_moe_local(jp, jnp.asarray(x), jspec,
                                      JaxRuntime(kernel_backend=jax_backend,
                                                 zero_drop=zero_drop))
    ty, tprobs = tmoe.apply_moe_local(tp, _t(x), tspec, Runtime(zero_drop=zero_drop))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    cap = tmoe._capacity(tspec, 24, zero_drop)
    assert cap == (24 if zero_drop else 6)
    gates, eids = tmoe.top_k_route(tprobs, 2)
    drops = (tmoe.make_dispatch(gates, eids, tspec, cap).eids == 8).sum().item()
    assert (drops > 0) == (not zero_drop), drops


def test_expert_ffn_with_group_sizes_equals_the_dense_product():
    """What lets the kernel skip rows: ``dispatch_tokens`` leaves every row
    at or past an expert's kept count zero, the FFN maps zero rows to
    zero, and ``combine_tokens`` reads no such row. So cutting the output
    to the group sizes (what the kernel computes) changes nothing, and the
    result equals the JAX dense product on the same buffer."""
    jspec, tspec, jp, tp = _moe_params(False)
    x = _t(np.random.default_rng(5).standard_normal((24, 64)).astype(np.float32))
    probs = tmoe.router_probs(tp, x, tspec)
    gates, eids = tmoe.top_k_route(probs, 2)
    d = tmoe.make_dispatch(gates, eids, tspec, 6)
    sizes = tmoe.group_sizes(d, 8)
    buf = tmoe.dispatch_tokens(d, x, 8)
    past = torch.arange(6)[None, :] >= sizes[:, None]  # (E, cap) rows past the count
    assert past.any() and not buf[past].any()
    rt = Runtime()
    dense = tmoe.expert_ffn(tp, buf, rt)
    ragged = tmoe.expert_ffn(tp, buf, rt, sizes=sizes)
    assert torch.equal(dense, ragged) and not dense[past].any()
    cut = torch.where(past[..., None], torch.zeros(()), dense)
    assert torch.equal(tmoe.combine_tokens(d, cut), tmoe.combine_tokens(d, dense))
    jout = jmoe.expert_ffn(jp, jnp.asarray(buf.numpy()), JaxRuntime(kernel_backend="ref"))
    np.testing.assert_allclose(ragged.numpy(), np.asarray(jout), **TOL)


def test_moe_lora_waits_for_its_slice():
    """MoE LoRA has landed: an adapter merges ``w + scale * a @ b`` into its
    expert weights, so ``b`` = 0 changes nothing and a nonzero ``b`` gives
    the layer of the merged weights (the JAX parity: test_torch_lora.py)."""
    _, tspec, _, tp = _moe_params(False)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, tp["wg"].shape[1]), generator=g)
    E, d, f = tp["wu"].shape
    a = torch.randn((E, d, 3), generator=g) * d**-0.5
    zero = {"wu": {"a": a, "b": torch.zeros((E, 3, f))}}
    y, _ = tmoe.apply_moe(tp, x, tspec, Runtime())
    assert torch.equal(tmoe.apply_moe(tp, x, tspec, Runtime(), lora=zero, lora_scale=2.0)[0], y)
    b = torch.randn((E, 3, f), generator=g)
    y_lora, _ = tmoe.apply_moe(tp, x, tspec, Runtime(), lora={"wu": {"a": a, "b": b}},
                               lora_scale=2.0)
    merged = dict(tp, wu=tp["wu"] + 2.0 * a @ b)
    torch.testing.assert_close(y_lora, tmoe.apply_moe(merged, x, tspec, Runtime())[0],
                               rtol=1e-5, atol=1e-5)
    assert not torch.allclose(y_lora, y, atol=1e-3)


def _with_capacity(cfg, factor):
    """The config with every MoE block at capacity factor ``factor``."""
    defs = {k: dataclasses.replace(b, moe=dataclasses.replace(b.moe, capacity_factor=factor))
            if b.moe is not None else b for k, b in cfg.block_defs.items()}
    return dataclasses.replace(cfg, block_defs=defs)


@pytest.fixture(scope="module", params=ARCHS + ["granite-drops"])
def bridged(request):
    """(jax cfg, port cfg, numpy tree, port params). "granite-drops" is
    granite-moe-1b-a400m-smoke at capacity factor 0.5: cap N/4 against a
    mean load of N/2, so the prefill drops assignments."""
    arch = request.param
    base = "granite-moe-1b-a400m-smoke" if arch == "granite-drops" else arch
    jcfg, tcfg = jax_get_config(base), get_config(base)
    if arch == "granite-drops":
        jcfg, tcfg = _with_capacity(jcfg, 0.5), _with_capacity(tcfg, 0.5)
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.key(0), jcfg, jnp.float32))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg)


def test_apply_model_logits_and_probes_match_jax(bridged):
    """Logits within 1e-4, router probes (one (R, B, T, E) per MoE position)
    within 1e-5; capacity drops as the reference takes them."""
    jcfg, tcfg, tree, params = bridged
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    jl, jaux = jax_apply_model(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks),
                               JaxRuntime(kernel_backend="ref"), collect_probs=True)
    tl, taux = tmodel.apply_model(params, tcfg, torch.as_tensor(toks).long(),
                                  Runtime(), collect_probs=True)
    assert tl.dtype == torch.float32 and tl.shape == (2, 12, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_LOGITS)
    assert len(taux["probs"]) == len(jaux["probs"]) == tcfg.n_moe_layers
    for tp, jp in zip(taux["probs"], jaux["probs"]):
        assert tuple(tp.shape) == tuple(jp.shape) == (1, 2, 12, tcfg.moe_spec.num_experts)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    if tcfg.moe_spec.capacity_factor == 0.5:  # the drops really happen
        spec = tcfg.moe_spec
        cap = tmoe._capacity(spec, 24, False)
        gates, eids = tmoe.top_k_route(taux["probs"][0][0].reshape(24, -1), spec.top_k)
        assert (tmoe.make_dispatch(gates, eids, spec, cap).eids == spec.num_experts).any()


CHAIN = (2, 10, 8)  # B, prompt T, decode steps G


@pytest.fixture(scope="module")
def jax_chain(bridged):
    """The JAX prefill and 8 jitted decode steps: prompt, last-position
    logits of each step and the decode probes."""
    jcfg, _, tree, _ = bridged
    B, T, G = CHAIN
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (B, T + G)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jrt = JaxRuntime(kernel_backend="ref")
    jl, cache = jax_prefill(jparams, jcfg, jnp.asarray(toks[:, :T]), jrt, n_slots=T + G)
    dec = jax.jit(lambda p, t, c: jax_decode_step(p, jcfg, t, c, jrt, collect_probs=True))
    logits, probs = [np.asarray(jl)], []
    for i in range(G):
        jl, cache, aux = dec(jparams, jnp.asarray(toks[:, T + i: T + i + 1]), cache)
        logits.append(np.asarray(jl))
        probs.append([np.asarray(a) for a in aux["probs"]])
    return toks, logits, probs


@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_then_decode_matches_jax(bridged, jax_chain, per_row):
    """A prefill and 8 ``decode_step`` s against the JAX chain (decode at
    zero_drop, as both force it): logits 1e-4, decode probes 1e-5; the
    position as an int or as a (B,) tensor."""
    _, tcfg, _, params = bridged
    toks, jlogits, jprobs = jax_chain
    B, T, G = CHAIN
    tl, tcache = tmodel.prefill(params, tcfg, torch.as_tensor(toks[:, :T]).long(),
                                Runtime(), n_slots=T + G)
    np.testing.assert_allclose(tl.numpy(), jlogits[0], **TOL_LOGITS)
    if per_row:
        tcache["pos"] = torch.full((B,), T, dtype=torch.long)
    for i in range(G):
        step = torch.as_tensor(toks[:, T + i: T + i + 1]).long()
        tl, tcache, taux = tmodel.decode_step(params, tcfg, step, tcache, Runtime(),
                                              collect_probs=True)
        np.testing.assert_allclose(tl.numpy(), jlogits[i + 1], **TOL_LOGITS)
        for tp, jp in zip(taux["probs"], jprobs[i], strict=True):
            assert tuple(tp.shape) == jp.shape == (1, B, 1, tcfg.moe_spec.num_experts)
            np.testing.assert_allclose(tp.numpy(), jp, **TOL)
    want = T + G
    assert (tcache["pos"].tolist() == [want] * B) if per_row else tcache["pos"] == want
