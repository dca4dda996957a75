"""Port model pieces (repro_torch.models, bridge) against the JAX package.

Inputs are drawn with numpy from a seed and fed to both; the JAX side
runs its plain path (``Runtime(kernel_backend="ref")``). Tolerances are
fp32 with another summation order (1e-5), and 1e-4 where a value passes
through several products (attention, logits). The bridge is bit-exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import AttnSpec as JaxAttnSpec, MoESpec as JaxMoESpec  # noqa: E402
from repro.models import Runtime as JaxRuntime, init_params as jax_init_params  # noqa: E402
from repro.models import attention as jatt, common as jcommon, moe as jmoe  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import AttnSpec, MoESpec  # noqa: E402
from repro_torch.models import attention as tatt, common as tcommon, moe as tmoe  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-5, atol=1e-5)  # fp32, summation order
TOL_DEEP = dict(rtol=1e-4, atol=1e-4)  # several fp32 products deep

SPECS = {  # (jax spec, port spec): GQA + qk-norm, and softcap + window
    "gqa_qknorm": dict(n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True),
    "softcap_window": dict(n_heads=4, n_kv_heads=4, head_dim=16,
                           attn_softcap=30.0, window=6),
}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _attn_params(rng, d, spec):
    p = {"wq": rng.standard_normal((d, spec["n_heads"] * spec["head_dim"])),
         "wk": rng.standard_normal((d, spec["n_kv_heads"] * spec["head_dim"])),
         "wv": rng.standard_normal((d, spec["n_kv_heads"] * spec["head_dim"])),
         "wo": rng.standard_normal((spec["n_heads"] * spec["head_dim"], d))}
    p = {k: (v * d**-0.5).astype(np.float32) for k, v in p.items()}
    if spec.get("qk_norm"):
        p["q_norm"] = (0.1 * rng.standard_normal(spec["head_dim"])).astype(np.float32)
        p["k_norm"] = (0.1 * rng.standard_normal(spec["head_dim"])).astype(np.float32)
    return p


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal(16)).astype(np.float32)
    np.testing.assert_allclose(tcommon.rms_norm(_t(w), _t(x)).numpy(),
                               _np(jcommon.rms_norm(jnp.asarray(w), jnp.asarray(x))),
                               **TOL)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    np.testing.assert_allclose(
        tcommon.apply_rope(_t(x), _t(pos), 10_000.0).numpy(),
        _np(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)), **TOL)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_attend_full_matches_jax_ref(name):
    rng = np.random.default_rng(1)
    d, B, T = 32, 2, 11
    p = _attn_params(rng, d, SPECS[name])
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    jspec, tspec = JaxAttnSpec(**SPECS[name]), AttnSpec(**SPECS[name])
    jo, (jk, jv) = jatt.attend_full(jax.tree.map(jnp.asarray, p), jspec,
                                    jnp.asarray(x), jnp.asarray(pos), jspec.window,
                                    return_kv=True, rt=JaxRuntime(kernel_backend="ref"))
    to, (tk, tv) = tatt.attend_full({k: _t(v) for k, v in p.items()}, tspec, _t(x),
                                    _t(pos), tspec.window, return_kv=True,
                                    rt=Runtime(device=torch.device("cpu")))
    np.testing.assert_allclose(to.numpy(), _np(jo), **TOL_DEEP)
    np.testing.assert_allclose(tk.numpy(), _np(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), **TOL)


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_cache_then_decode_ring(name, per_row):
    """cache_from_prefill + decode_attend through a ring that wraps
    (W < T + steps), with a scalar pos or a (B,) pos per row."""
    rng = np.random.default_rng(2)
    d, B, T, W, steps = 32, 2, 9, 7, 5
    p = _attn_params(rng, d, SPECS[name])
    jspec, tspec = JaxAttnSpec(**SPECS[name]), AttnSpec(**SPECS[name])
    kv = [rng.standard_normal((B, T, jspec.n_kv_heads, jspec.head_dim)).astype(np.float32)
          for _ in range(2)]
    jc = jatt.cache_from_prefill(jnp.asarray(kv[0]), jnp.asarray(kv[1]), jspec, W)
    tc = tatt.cache_from_prefill(_t(kv[0]), _t(kv[1]), tspec, W)
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(b.numpy(), _np(a))
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: _t(v) for k, v in p.items()}
    for s in range(steps):
        x = rng.standard_normal((B, 1, d)).astype(np.float32)
        pos = np.array([T + s, T + s - 3], np.int32) if per_row else np.int32(T + s)
        jo, jc = jatt.decode_attend(jp, jspec, jnp.asarray(x), jc, jnp.asarray(pos),
                                    jspec.window)
        to, tc = tatt.decode_attend(tp, tspec, _t(x), tc, _t(pos), tspec.window)
        np.testing.assert_allclose(to.numpy(), _np(jo), **TOL_DEEP)
        np.testing.assert_array_equal(tc.slot_pos.numpy(), _np(jc.slot_pos))
        np.testing.assert_allclose(tc.k.numpy(), _np(jc.k), **TOL)


def test_router_topk_dispatch_combine():
    rng = np.random.default_rng(3)
    N, d, E, K, cap = 13, 16, 6, 2, 3  # cap < N*K/E: some assignments drop
    x = rng.standard_normal((N, d)).astype(np.float32)
    router = (rng.standard_normal((d, E)) * d**-0.5).astype(np.float32)
    jspec, tspec = JaxMoESpec(E, K, 8), MoESpec(E, K, 8)
    jprobs = jmoe.router_probs({"router": jnp.asarray(router)}, jnp.asarray(x), jspec)
    tprobs = tmoe.router_probs({"router": _t(router)}, _t(x), tspec)
    np.testing.assert_allclose(tprobs.numpy(), _np(jprobs), **TOL)
    jg, je = jmoe.top_k_route(jprobs, K)
    tg, te = tmoe.top_k_route(tprobs, K)
    np.testing.assert_array_equal(te.numpy(), _np(je))  # routed ids first
    np.testing.assert_allclose(tg.numpy(), _np(jg), **TOL)
    jd = jmoe.make_dispatch(jg, je, jspec, cap)
    assert (np.asarray(jd.eids) == E).any()  # the drop sentinel is exercised
    td = tmoe.Dispatch(_t(jd.eids), _t(jd.pos), _t(jd.gates), cap)
    jbuf = jmoe.dispatch_tokens(jd, jnp.asarray(x), E)
    tbuf = tmoe.dispatch_tokens(td, _t(x), E)
    np.testing.assert_array_equal(tbuf.numpy(), _np(jbuf))
    out_buf = rng.standard_normal(tbuf.shape).astype(np.float32)
    np.testing.assert_allclose(tmoe.combine_tokens(td, _t(out_buf)).numpy(),
                               _np(jmoe.combine_tokens(jd, jnp.asarray(out_buf))), **TOL)


@pytest.fixture(scope="module")
def granite():
    jcfg = jax_get_config("granite-moe-1b-a400m-smoke")
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.key(0), jcfg, jnp.float32))
    return jcfg, get_config("granite-moe-1b-a400m-smoke"), tree


def test_bridge_round_trip_is_bit_exact(granite):
    jcfg, tcfg, tree = granite
    back = params_to_numpy(params_from_jax(tree, tcfg))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_bridge_bf16_leaves_cross_exactly():
    jcfg = jax_get_config("granite-moe-1b-a400m-smoke")
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.key(1), jcfg))  # bf16
    tcfg = get_config("granite-moe-1b-a400m-smoke")
    params = params_from_jax(tree, tcfg)
    assert params["embed"].dtype == torch.bfloat16
    assert params["groups"]["g0"]["p0"]["ffn"]["router"].dtype == torch.float32
    back = params_to_numpy(params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a, np.float32))


def test_embed_and_logits(granite):
    jcfg, tcfg, tree = granite
    params = params_from_jax(tree, tcfg)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 5)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    jx = jmodel.embed_tokens(jp, jcfg, jnp.asarray(toks))
    tx = tmodel.embed_tokens(params, tcfg, _t(toks).long())
    np.testing.assert_array_equal(tx.numpy(), _np(jx))
    jl = jmodel.compute_logits(jp, jcfg, jx, JaxRuntime())
    tl = tmodel.compute_logits(params, tcfg, tx)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL_DEEP)


def test_init_params_has_the_jax_tree_layout(granite):
    jcfg, tcfg, tree = granite
    gen = torch.Generator().manual_seed(0)
    mine = params_to_numpy(tmodel.init_params(tcfg, generator=gen, dtype=torch.float32,
                                              device="cpu"))
    a = jax.tree_util.tree_leaves_with_path(tree)
    b = jax.tree_util.tree_leaves_with_path(mine)
    assert [(p, x.shape, x.dtype) for p, x in a] == [(p, x.shape, x.dtype) for p, x in b]
    # experts kept on another device keep the same layout
    host = tmodel.init_params(tcfg, generator=gen,
                              dtype=torch.float32, device="cpu", expert_device="cpu")
    assert host["groups"]["g0"]["p0"]["ffn"]["wd"].shape == \
        mine["groups"]["g0"]["p0"]["ffn"]["wd"].shape
