"""Port INT4 quantization (``repro_torch.core.quant``) and the INT4 dequant
matmul (``repro_torch.kernels.int4_matmul``) against the JAX package on
the CPU, from the same numpy inputs.

Tolerances:
  * ``quantize(iters=0)``, ``quantize_matmul_weight``, ``matmul_layout``,
    ``dequantize_linear`` and the bridge: bit-exact (the same elementwise
    fp32 operations in the same order).
  * ``quantize(iters=4)``: scales bit-exact (min/max only). The HQQ
    zero-point update takes a ``mean`` over each group, which XLA and
    PyTorch sum in different orders; a last-bit difference can flip a
    code sitting on a rounding tie. At most 1e-5 of the codes may differ,
    each by exactly 1 (measured: 2 of 2,097,152 at (2048, 1024), group
    64). Zero-points agree to fp32 rounding (1e-6 relative + 4e-6) in all
    but 1e-3 of the groups; a group where an iteration's code flipped
    has its mean moved by 1/group, so every zero-point is within 2/group.
  * matmuls: fp32 with another summation order, 1e-5 relative + 1e-5
    absolute on O(1) outputs; bf16 outputs may differ by one ulp
    (2^-7 relative, 1.6e-2 absolute).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro.kernels.int4_matmul import int4_matmul as jax_int4_matmul  # noqa: E402
from repro.kernels.int4_matmul import quantize_matmul_weight as jax_qmw  # noqa: E402
from repro.kernels.int4_matmul.ref import dequant_ref as jax_dequant_ref  # noqa: E402
from repro.kernels.int4_matmul.ref import int4_matmul_ref as jax_int4_ref  # noqa: E402
from repro_torch.bridge import qtensor_from_jax, qtensor_to_numpy  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.int4_matmul import (MatmulQWeight, dequant_ref,  # noqa: E402
                                             int4_matmul, int4_matmul_ref,
                                             quantize_matmul_weight)
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2**-7, atol=1.6e-2)}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)


def _w(shape, seed=0, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,group", [((64, 256), 32), ((3, 128, 96), 32),
                                         ((1024, 2048), 64), ((16, 256), 16)])
def test_quantize_iters0_bit_exact(shape, group):
    w = _w(shape, seed=1, scale=0.3)
    a = jq.quantize(jnp.asarray(w), group=group, iters=0)
    b = tq.quantize(torch.from_numpy(w), group=group, iters=0)
    for leaf in ("packed", "scale", "zero"):
        np.testing.assert_array_equal(_np(getattr(b, leaf)), _np(getattr(a, leaf)))
    assert b.shape == tuple(a.shape) and b.group == a.group
    np.testing.assert_array_equal(_np(tq.dequantize(b, torch.float32)),
                                  _np(jq.dequantize(a, jnp.float32)))
    assert tq.quant_bytes(b) == jq.quant_bytes(a)


@pytest.mark.parametrize("shape,group,seed", [((1024, 2048), 64, 0), ((2048, 1024), 64, 1),
                                              ((2048, 1024), 32, 2)])
def test_quantize_hqq_iters_within_tolerance(shape, group, seed):
    w = _w(shape, seed=seed)
    a = jq.quantize(jnp.asarray(w), group=group, iters=4)
    b = tq.quantize(torch.from_numpy(w), group=group, iters=4)
    np.testing.assert_array_equal(_np(b.scale), _np(a.scale))
    ca = _np(jq.unpack_codes(a)).astype(np.int32)
    cb = _np(tq.unpack_codes(b)).astype(np.int32)
    diff = cb - ca
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 1e-5 * diff.size
    za, zb = _np(a.zero)[..., 0], _np(b.zero)[..., 0]
    off = np.abs(zb - za) > 1e-6 * np.abs(za) + 4e-6
    assert off.mean() <= 1e-3
    assert np.abs(zb - za).max() <= 2.0 / group


def test_quantize_matmul_weight_bit_exact():
    w = _w((256, 96), seed=2, scale=0.1)
    a = jax_qmw(jnp.asarray(w), 32)
    b = quantize_matmul_weight(torch.from_numpy(w), 32)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(_np(y), _np(x))
    assert b.group == 32 and b.packed.shape == (128, 96) and b.packed.dtype == torch.uint8
    np.testing.assert_array_equal(
        _np(dequant_ref(b.packed, b.scale, b.zero, 32)),
        _np(jax_dequant_ref(a.packed, a.scale, a.zero, 32)))


@pytest.fixture(scope="module")
def carried():
    """A JAX quantize_linear QTensor (HQQ iters=4), its numpy copy with
    0-d shape/group leaves (as in the JAX engine's host store), and the
    port's QTensor made from it."""
    w = _w((192, 64), seed=3)
    ql = jq.quantize_linear(jnp.asarray(w), group=32, iters=4)
    as_np = jax.tree.map(np.asarray, ql, is_leaf=lambda x: isinstance(x, jax.Array))
    return w, ql, as_np, qtensor_from_jax(as_np)


def test_bridge_qtensor_round_trip_bit_exact(carried):
    _, ql, as_np, qt = carried
    assert qt.shape == (64, 192) and qt.group == 32 and isinstance(qt.group, int)
    back = qtensor_to_numpy(qt)
    for x, y in zip(back[:3], as_np[:3]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert back[3] == tuple(ql.shape) and back[4] == ql.group


def test_matmul_layout_and_dequantize_linear_bit_exact(carried):
    _, ql, as_np, qt = carried
    jm = jq.matmul_layout(ql)
    tm = tq.matmul_layout(qt)
    for x, y in zip(jm[:3], tm[:3]):
        np.testing.assert_array_equal(_np(y), _np(x))
    assert tm.group == 32 and tm.packed.shape == (96, 64)
    np.testing.assert_array_equal(_np(tq.dequantize_linear(qt, torch.float32)),
                                  _np(jq.dequantize_linear(ql, jnp.float32)))
    # the same codes through both layouts dequantize to the same weight
    np.testing.assert_array_equal(_np(dequant_ref(tm.packed, tm.scale, tm.zero, 32)),
                                  _np(tq.dequantize_linear(qt, torch.float32)))


def test_matmul_layout_batched_equals_per_weight():
    w = _w((3, 64, 96), seed=4)
    qt = tq.quantize_linear(torch.from_numpy(w), group=32, iters=2)
    mq = tq.matmul_layout(qt)
    for e in range(3):
        one = tq.matmul_layout(tq.quantize_linear(torch.from_numpy(w[e]), group=32,
                                                  iters=2))
        for x, y in zip(mq[:3], one[:3]):
            assert torch.equal(x[e], y)


# ---------------------------------------------------------------------------
# INT4 dequant matmul: plain version vs the JAX oracle and Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N,group,bm,bn,bk", [  # test_kernels.py's shapes
    (64, 128, 96, 32, 32, 32, 64),
    (256, 512, 256, 64, 128, 128, 512),
    (8, 256, 128, 64, 8, 128, 128),
    (128, 1024, 64, 128, 64, 64, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_plain_matches_jax_ref_and_pallas(M, K, N, group, bm, bn, bk, dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jw = jax_qmw(jnp.asarray(w), group)
    jx = jnp.asarray(x).astype(jdt)
    ref = jax_int4_ref(jx, jw.packed, jw.scale, jw.zero, group)
    pallas = jax_int4_matmul(jx, jw.packed, jw.scale, jw.zero, group=group, bm=bm,
                             bn=bn, bk=bk, interpret=True)
    tw = MatmulQWeight(*(torch.tensor(_np(a)) for a in jw[:3]), group)
    tx = torch.from_numpy(x).to(tdt)
    n0 = dispatch.LAUNCHES["int4_matmul"]
    out = int4_matmul(tx, tw.packed, tw.scale, tw.zero, group=group)
    assert dispatch.LAUNCHES["int4_matmul"] == n0  # the plain version ran
    assert out.dtype == tdt and out.shape == (M, N)
    got = out.float()
    torch.testing.assert_close(got, torch.tensor(_np(ref.astype(jnp.float32))),
                               **TOL[tdt])
    torch.testing.assert_close(got, torch.tensor(_np(pallas.astype(jnp.float32))),
                               **TOL[tdt])


def test_qmatmul_matches_jax(carried):
    w, ql, _, qt = carried
    x = np.random.default_rng(6).standard_normal((2, 5, 192)).astype(np.float32)
    want = _np(jq.qmatmul(jnp.asarray(x), ql, backend="ref"))
    got = tq.qmatmul(torch.from_numpy(x), qt)  # QTensor, plain path
    assert got.shape == (2, 5, 64)
    torch.testing.assert_close(got, torch.tensor(want), **TOL[torch.float32])
    got_mq = tq.qmatmul(torch.from_numpy(x), tq.matmul_layout(qt))  # -> int4_matmul
    want_mq = _np(jq.qmatmul(jnp.asarray(x), jq.matmul_layout(ql), backend="ref"))
    torch.testing.assert_close(got_mq, torch.tensor(want_mq), **TOL[torch.float32])
    # the quantization error is small next to the weight (it is HQQ INT4)
    assert tq.quant_error(torch.from_numpy(w.T.copy()), qt) == pytest.approx(
        jq.quant_error(jnp.asarray(w.T), ql), rel=1e-6)


def test_int4_matmul_wrapper_rules():
    w = quantize_matmul_weight(torch.from_numpy(_w((64, 16))), 32)
    x = torch.ones(3, 4, 64)
    out = int4_matmul(x, *w[:3], group=32)  # leading dims flattened and restored
    assert out.shape == (3, 4, 16)
    torch.testing.assert_close(out.reshape(12, 16),
                               int4_matmul_ref(x.reshape(12, 64), *w[:3], 32))
    with pytest.raises(ValueError, match="group"):
        int4_matmul(x, *w[:3], group=48)  # K % group
    with pytest.raises(ValueError, match="group"):
        int4_matmul(x, *w[:3], group=3)  # odd group
    with pytest.raises(RuntimeError, match="hopper"):
        int4_matmul(x, *w[:3], group=32, backend="hopper")
    with pytest.raises(RuntimeError, match="hopper"):
        tq.qmatmul(x, w, backend="hopper")
