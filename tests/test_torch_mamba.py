"""The port's Mamba2 SSD pieces (repro_torch.kernels.ssd_scan,
repro_torch.models.mamba2) against the JAX package on the CPU.

Inputs are drawn with numpy from a seed and fed to both. Tolerances, in
fp32: the same algorithm on both sides differs only in summation order
(1e-5); the chunked form against the sequential recurrence computes
each decay as exp(sum) instead of a product of exps, so the two differ
by a few ulp per step and more through the state (rtol 1e-3, atol 5e-4,
as ``tests/test_kernels.py::test_ssd_vs_sequential_ref`` states).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SSMSpec as JaxSSMSpec  # noqa: E402
from repro.kernels.ssd_scan import ssd as jax_ssd, ssd_scan_ref as jax_ssd_ref  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro_torch.configs.base import SSMSpec  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd, ssd_chunked, ssd_hopper, ssd_scan_ref  # noqa: E402
from repro_torch.models import mamba2 as tmamba  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-5, atol=1e-5)  # same algorithm, summation order
TOL_FORM = dict(rtol=1e-3, atol=5e-4)  # chunked vs sequential form


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _ssd_inputs(seed, B, T, H, P, N, G, with_init):
    """G=None: the shared (B,T,N) form of B/C."""
    rng = np.random.default_rng(seed)
    gshape = (B, T, N) if G is None else (B, T, G, N)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = (-np.exp(0.3 * rng.standard_normal(H))).astype(np.float32)
    Bm = (0.5 * rng.standard_normal(gshape)).astype(np.float32)
    Cm = (0.5 * rng.standard_normal(gshape)).astype(np.float32)
    init = (0.5 * rng.standard_normal((B, H, P, N))).astype(np.float32) \
        if with_init else None
    return x, dt, A, Bm, Cm, init


SSD_CASES = {  # B, T, H, P, N, G, chunk, init
    "shared_bc": (2, 64, 3, 16, 8, None, 16, False),
    "tail_groups_init": (1, 100, 4, 8, 8, 2, 32, True),
    "tail_short": (2, 37, 2, 8, 4, 1, 16, True),
    "one_chunk_groups": (2, 24, 4, 8, 4, 2, 32, False),
}


@pytest.mark.parametrize("name", sorted(SSD_CASES))
def test_ssd_matches_jax_oracles_and_pallas_interpret(name):
    B, T, H, P, N, G, chunk, with_init = SSD_CASES[name]
    x, dt, A, Bm, Cm, init = _ssd_inputs(1, B, T, H, P, N, G, with_init)
    jin = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    jinit = jnp.asarray(init) if init is not None else None
    tin = [_t(a) for a in (x, dt, A, Bm, Cm)]
    tinit = _t(init) if init is not None else None

    # sequential recurrence, both packages
    jy, jfin = jax_ssd_ref(*jin, jinit)
    ty, tfin = ssd_scan_ref(*tin, tinit)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(tfin.numpy(), _np(jfin), **TOL)

    # chunked oracle, both packages (per-group layout)
    g = 1 if G is None else G
    spec, jspec = SSMSpec(N, head_dim=P, chunk=chunk, n_groups=g), \
        JaxSSMSpec(N, head_dim=P, chunk=chunk, n_groups=g)
    jb, jc = (jin[3], jin[4]) if G is not None else (jin[3][:, :, None], jin[4][:, :, None])
    tb, tc = (tin[3], tin[4]) if G is not None else (tin[3][:, :, None], tin[4][:, :, None])
    jcy, jcfin = jmamba.ssd_chunked(jin[0], jin[1], jin[2], jb, jc, jspec, jinit)
    tcy, tcfin = tmamba.ssd_chunked(tin[0], tin[1], tin[2], tb, tc, spec, tinit)
    np.testing.assert_allclose(tcy.numpy(), _np(jcy), **TOL)
    np.testing.assert_allclose(tcfin.numpy(), _np(jcfin), **TOL)
    # the dispatcher takes the plain chunked form for a CPU tensor, in
    # either layout of B/C
    n0 = dispatch.LAUNCHES["ssd_scan"]
    dy, dfin = ssd(*tin, init=tinit, chunk=chunk)
    assert dispatch.LAUNCHES["ssd_scan"] == n0
    np.testing.assert_array_equal(dy.numpy(), tcy.numpy())
    np.testing.assert_array_equal(dfin.numpy(), tcfin.numpy())

    # the Pallas kernel in interpret mode (it shrinks the chunk to a divisor
    # of T; the port's chunked forms pad the tail instead)
    py, pfin = jax_ssd(*jin, init=jinit, chunk=chunk, interpret=True)
    for ours in (ty, tcy):
        np.testing.assert_allclose(ours.numpy(), _np(py), **TOL_FORM)
    for ours in (tfin, tcfin):
        np.testing.assert_allclose(ours.numpy(), _np(pfin), **TOL_FORM)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_ref_fused_skip(dtype):
    """``ssd_scan_ref``'s ``D``: y + D x, added in fp32 before the one cast
    to x's dtype (the kernel's fused epilogue), against the JAX oracle plus
    the skip."""
    x, dt, A, Bm, Cm, init = _ssd_inputs(4, 2, 33, 4, 8, 4, 2, True)
    D = (1.0 + 0.1 * np.random.default_rng(5).standard_normal(4)).astype(np.float32)
    jy, jfin = jax_ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, init)))
    want = np.asarray(jy) + D[None, None, :, None] * x
    ty, tfin = ssd_scan_ref(_t(x).to(dtype), _t(dt), _t(A), _t(Bm).to(dtype),
                            _t(Cm).to(dtype), _t(init), D=_t(D))
    assert ty.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(ty.numpy(), want, **TOL)
        np.testing.assert_allclose(tfin.numpy(), _np(jfin), **TOL)
    else:  # one rounding of the fp32 sum, on the bf16-rounded inputs
        xr = _t(x).to(dtype).float()
        ys, _ = ssd_scan_ref(xr, _t(dt), _t(A), _t(Bm).to(dtype).float(),
                             _t(Cm).to(dtype).float(), _t(init))
        expect = (ys + _t(D)[None, None, :, None] * xr).to(dtype)
        np.testing.assert_array_equal(ty.float().numpy(), expect.float().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_dispatch_plain_adds_skip_then_rounds_once(dtype):
    """``ssd`` on a CPU tensor: the chunked form plus D x in fp32, one cast
    to x's dtype (what the kernel's epilogue computes); the fp32 state."""
    x, dt, A, Bm, Cm, init = _ssd_inputs(6, 2, 45, 4, 8, 4, 2, True)
    D = (1.0 + 0.1 * np.random.default_rng(8).standard_normal(4)).astype(np.float32)
    xt, bt, ct = _t(x).to(dtype), _t(Bm).to(dtype), _t(Cm).to(dtype)
    ty, tfin = ssd(xt, _t(dt), _t(A), bt, ct, init=_t(init), D=_t(D), chunk=16)
    assert ty.dtype == dtype and tfin.dtype == torch.float32
    yc, fc = ssd_chunked(xt, _t(dt), _t(A), bt, ct, 16, _t(init))
    expect = (yc + _t(D)[None, None, :, None] * xt.float()).to(dtype)
    np.testing.assert_array_equal(ty.float().numpy(), expect.float().numpy())
    np.testing.assert_array_equal(tfin.numpy(), fc.numpy())
    if dtype == torch.float32:  # and the JAX oracle plus the skip
        jy, _ = jax_ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, init)))
        want = np.asarray(jy) + D[None, None, :, None] * x
        np.testing.assert_allclose(ty.numpy(), want, **TOL_FORM)


def test_ssd_state_isolation_across_batch():
    """A zero input row gives zero output and a zero final state."""
    B, T, H, P, N = 2, 40, 2, 8, 4
    rng = np.random.default_rng(7)
    x = np.zeros((B, T, H, P), np.float32)
    x[0] = 3 * rng.standard_normal((T, H, P))
    dt = np.full((B, T, H), np.log1p(np.e), np.float32)
    Bm = np.full((B, T, N), 0.3, np.float32)
    spec = SSMSpec(N, head_dim=P, chunk=16)
    y, fin = tmamba.ssd_chunked(_t(x), _t(dt), -torch.ones(H), _t(Bm)[:, :, None],
                                _t(Bm)[:, :, None], spec)
    assert float(y[1].abs().max()) == 0.0 and float(fin[1].abs().max()) == 0.0
    assert float(y[0].abs().max()) > 0.0


def test_ssd_hopper_raises_on_cpu_tensors():
    x, dt, A, Bm, Cm, _ = _ssd_inputs(2, 1, 8, 2, 32, 16, 1, False)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_hopper(*(_t(a) for a in (x, dt, A, Bm, Cm)), chunk=8)
    with pytest.raises(RuntimeError, match="hopper"):
        ssd(*(_t(a) for a in (x, dt, A, Bm, Cm)), backend="hopper")


def _mamba_params(rng, d, spec):
    """A mamba mixer's weights (JAX layout), numpy fp32, drawn from rng."""
    di, nh = spec.d_inner(d), spec.n_heads(d)
    cd = di + 2 * spec.n_groups * spec.d_state
    proj_out = 2 * di + 2 * spec.n_groups * spec.d_state + nh
    p = {"in_proj": rng.standard_normal((d, proj_out)) * d**-0.5,
         "conv_w": 0.3 * rng.standard_normal((spec.d_conv, cd)),
         "conv_b": 0.1 * rng.standard_normal(cd),
         "A_log": np.log(np.linspace(1.0, 16.0, nh)),
         "D": 1.0 + 0.1 * rng.standard_normal(nh),
         "dt_bias": np.log(np.expm1(np.full(nh, 0.05))) + 0.3 * rng.standard_normal(nh),
         "norm_w": 0.1 * rng.standard_normal(di),
         "out_proj": rng.standard_normal((di, d)) * di**-0.5}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("n_groups", [1, 2])
def test_apply_mamba_full_then_decode_matches_jax(n_groups):
    """apply_mamba_full with return_state on a prompt with a T tail, then
    decode steps chained on its state, against the JAX functions; and a
    second prefill carried on the first one's state."""
    rng = np.random.default_rng(3)
    d, B, T, steps = 32, 2, 21, 4
    kw = dict(d_state=8, head_dim=16, chunk=8, n_groups=n_groups)
    spec, jspec = SSMSpec(**kw), JaxSSMSpec(**kw)
    p = _mamba_params(rng, d, spec)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: _t(v) for k, v in p.items()}
    x = rng.standard_normal((B, T + steps + T, d)).astype(np.float32)
    rt = Runtime(device=torch.device("cpu"))

    jy, jst = jmamba.apply_mamba_full(jp, jnp.asarray(x[:, :T]), jspec,
                                      return_state=True)
    ty, tst = tmamba.apply_mamba_full(tp, _t(x[:, :T]), spec, return_state=True, rt=rt)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(tst.ssm.numpy(), _np(jst.ssm), **TOL)
    np.testing.assert_array_equal(tst.conv.numpy(), _np(jst.conv))
    for s in range(T, T + steps):
        jy, jst = jmamba.apply_mamba_decode(jp, jnp.asarray(x[:, s:s + 1]), jst, jspec)
        ty, tst = tmamba.apply_mamba_decode(tp, _t(x[:, s:s + 1]), tst, spec)
        np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
        np.testing.assert_allclose(tst.ssm.numpy(), _np(jst.ssm), **TOL)
        np.testing.assert_allclose(tst.conv.numpy(), _np(jst.conv), **TOL)
    # a second chunked call carried on the decoded state
    rest = x[:, T + steps:]
    jy, jst = jmamba.apply_mamba_full(jp, jnp.asarray(rest), jspec, init_state=jst,
                                      return_state=True)
    ty, tst = tmamba.apply_mamba_full(tp, _t(rest), spec, init_state=tst,
                                      return_state=True, rt=rt)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(tst.ssm.numpy(), _np(jst.ssm), **TOL)


def test_init_mamba_layout_and_fp32_leaves():
    spec = SSMSpec(d_state=16, head_dim=32, chunk=32)
    jp = jmamba.init_mamba(jax.random.key(0), 128, JaxSSMSpec(16, head_dim=32, chunk=32),
                           jnp.bfloat16)
    tp = tmamba.init_mamba(128, spec, torch.bfloat16,
                           generator=torch.Generator().manual_seed(0), device="cpu")
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert str(tp[k].dtype).replace("torch.", "") == str(v.dtype), k
    for k in ("A_log", "D", "dt_bias"):  # deterministic leaves equal the JAX init
        np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]), rtol=1e-6)
