"""The reference's blockwise attention in the port
(``models/attention.py::flash_attention``, ``blockwise_attention``), the
plain path ``attend_full`` takes wherever the ``flash_attn`` kernel does
not run (the CPU, the "ref" backend, every train step).

* Against the JAX package's ``flash_attention`` on the same numpy inputs
  from a seed: ``tests/test_attention.py``'s cases (T 11-300, bq and bk
  not dividing T, softcap, a window larger than T, the banded path), the
  banded path at q_offset 0, q_offset > 0 with S != T off the band, and
  bf16 inputs. fp32 outputs within 1e-5 of the largest element, the
  gradients of q, k and v (``jax.vjp`` against ``torch.autograd`` for one
  random output gradient) within 1e-5 of their largest element. bf16
  outputs within one bf16 ulp (2^-7 relative) of each element; bf16
  gradients no farther from float64 than the reference's, up to 2^-8 (the
  reference sums its tiles' parts in bf16).
* The banded path at q_offset > 0, against a plain masked softmax in
  float64 (values and gradients, 1e-5): the reference's band ends at
  ``(idx + 1) * bq - q_offset`` there and drops keys (ROADMAP, reference
  caveats), so it is not the oracle.
* ``attend_full`` takes it: equal to ``attend_full`` of the JAX package;
  and under the dry run's fake-tensor ``Ledger``, the peak of its forward
  and backward at T = 2048 stays below half of the same layer's through
  ``attention_ref``, which materializes the (B, Hkv, G, T, S) scores.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AttnSpec as JaxAttnSpec  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro_torch.configs.base import AttnSpec  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = 1e-5
BF16_REL = 2.0**-8  # bf16's unit roundoff
BF16_ULP = 2.0**-7  # one bf16 ulp of x is at most this times |x|
HQ, HD, B = 4, 16, 2

# (T, S, q_offset, window, softcap, Hkv, bq, bk)
JAX_CASES = {
    # tests/test_attention.py's cases
    "T11": (11, 11, 0, None, None, 2, 512, 1024),
    "T64-window16-banded": (64, 64, 0, 16, None, 2, 16, 16),
    "T200-window32-cap50-banded": (200, 200, 0, 32, 50.0, 1, 37, 53),
    "T300-cap30": (300, 300, 0, None, 30.0, 4, 64, 128),
    "T128-window200": (128, 128, 0, 200, None, 2, 32, 32),
    # the banded path, bq and bk unequal, softcap
    "T96-window8-cap20-banded": (96, 96, 0, 8, 20.0, 2, 8, 24),
    # q_offset > 0 with S != T, off the band
    "T40-S100-offset60": (40, 100, 60, None, None, 2, 16, 32),
    "T24-S80-offset56-window60": (24, 80, 56, 60, 30.0, 1, 24, 16),
}
# the banded path at q_offset > 0: held against a masked softmax
BANDED_OFFSET_CASES = {
    "T8-S16-offset8-window3": (8, 16, 8, 3, None, 2, 2, 1024),
    "T48-S120-offset72-window20": (48, 120, 72, 20, 50.0, 2, 16, 16),
}


def _inputs(T, S, Hkv, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, HQ, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, HD)).astype(np.float32)
    do = rng.standard_normal((B, T, HQ, HD)).astype(np.float32)
    return q, k, v, do


def _torch_run(q, k, v, do, spec, dtype=torch.float32, **kw):
    qt, kt, vt = (torch.tensor(a, dtype=dtype, requires_grad=True) for a in (q, k, v))
    o = attention.flash_attention(qt, kt, vt, spec, **kw)
    grads = torch.autograd.grad(o, [qt, kt, vt], torch.tensor(do, dtype=dtype))
    return o.detach().float(), [g.float() for g in grads]


def _jax_run(q, k, v, do, spec, dtype=jnp.float32, **kw):
    qj, kj, vj = (jnp.asarray(a, dtype) for a in (q, k, v))
    o, vjp = jax.vjp(lambda a, b, c: jax_attention.flash_attention(a, b, c, spec, **kw),
                     qj, kj, vj)
    grads = vjp(jnp.asarray(do, dtype))
    f32 = lambda a: torch.tensor(np.asarray(a.astype(jnp.float32)))  # noqa: E731
    return f32(o), [f32(g) for g in grads]


def _masked_softmax(q, k, v, do, Hkv, q_offset, window, cap):
    """Plain causal attention in float64 with q row t at q_offset + t, and
    its gradients (torch autograd)."""
    T, S = q.shape[1], k.shape[1]
    qt, kt, vt = (torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (q, k, v))
    qg = qt.reshape(B, T, Hkv, HQ // Hkv, HD)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kt) * HD**-0.5
    if cap is not None:
        s = torch.tanh(s / cap) * cap
    qp = q_offset + torch.arange(T)[:, None]
    kp = torch.arange(S)[None, :]
    mask = kp <= qp
    if window is not None:
        mask &= kp > qp - window
    p = torch.softmax(torch.where(mask, s, torch.tensor(-1e30, dtype=s.dtype)), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vt).reshape(B, T, HQ, HD)
    grads = torch.autograd.grad(o, [qt, kt, vt], torch.tensor(do, dtype=torch.float64))
    return o.detach().float(), [g.float() for g in grads]


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _specs(Hkv, cap):
    return (AttnSpec(n_heads=HQ, n_kv_heads=Hkv, head_dim=HD, attn_softcap=cap),
            JaxAttnSpec(n_heads=HQ, n_kv_heads=Hkv, head_dim=HD, attn_softcap=cap))


@pytest.mark.parametrize("case", JAX_CASES)
def test_blockwise_matches_jax_flash_attention(case):
    T, S, off, window, cap, Hkv, bq, bk = JAX_CASES[case]
    spec, jspec = _specs(Hkv, cap)
    q, k, v, do = _inputs(T, S, Hkv)
    kw = dict(q_offset=off, window=window, bq=bq, bk=bk)
    o, grads = _torch_run(q, k, v, do, spec, **kw)
    jo, jgrads = _jax_run(q, k, v, do, jspec, **kw)
    assert o.shape == (B, T, HQ, HD)
    assert _rel(o, jo) <= TOL, _rel(o, jo)
    for name, g, jg in zip("qkv", grads, jgrads):
        assert _rel(g, jg) <= TOL, (name, _rel(g, jg))


@pytest.mark.parametrize("case", ["T64-window16-banded", "T300-cap30", "T40-S100-offset60"])
def test_blockwise_bf16_matches_jax(case):
    T, S, off, window, cap, Hkv, bq, bk = JAX_CASES[case]
    spec, jspec = _specs(Hkv, cap)
    q, k, v, do = (np.asarray(torch.tensor(a).bfloat16().float()) for a in _inputs(T, S, Hkv))
    kw = dict(q_offset=off, window=window, bq=bq, bk=bk)
    o, grads = _torch_run(q, k, v, do, spec, dtype=torch.bfloat16, **kw)
    jo, jgrads = _jax_run(q, k, v, do, jspec, dtype=jnp.bfloat16, **kw)
    # the output: both sum in fp32, then round once to bf16: one ulp apart
    bad = (o - jo).abs() > BF16_ULP * jo.abs() + 1e-6 * jo.abs().max()
    assert not bad.any(), (float((o - jo).abs().max()), int(bad.sum()))
    # the gradients: the reference rounds each tile's part to bf16 and sums
    # in bf16, the port rounds once; each is held against float64 on the
    # same bf16 inputs, the port no farther than the reference, up to one
    # rounding
    _, exact = _masked_softmax(q, k, v, do, Hkv, off, window, cap)
    for name, g, jg, e in zip("qkv", grads, jgrads, exact):
        assert _rel(g, e) <= _rel(jg, e) + BF16_REL, (name, _rel(g, e), _rel(jg, e))


@pytest.mark.parametrize("case", BANDED_OFFSET_CASES)
def test_banded_path_with_q_offset_matches_masked_softmax(case):
    T, S, off, window, cap, Hkv, bq, bk = BANDED_OFFSET_CASES[case]
    assert window is not None and S > window + min(bq, T) and off > 0  # the banded path
    spec, _ = _specs(Hkv, cap)
    q, k, v, do = _inputs(T, S, Hkv)
    o, grads = _torch_run(q, k, v, do, spec, q_offset=off, window=window, bq=bq, bk=bk)
    ro, rgrads = _masked_softmax(q, k, v, do, Hkv, off, window, cap)
    assert _rel(o, ro) <= TOL, _rel(o, ro)
    for name, g, rg in zip("qkv", grads, rgrads):
        assert _rel(g, rg) <= TOL, (name, _rel(g, rg))


def test_attend_full_takes_the_blockwise_path_and_matches_jax():
    from repro.models.attention import attend_full as jax_attend_full
    from repro.models.attention import init_attn as jax_init_attn

    jspec = JaxAttnSpec(n_heads=HQ, n_kv_heads=2, head_dim=HD, window=24, attn_softcap=40.0)
    spec = AttnSpec(n_heads=HQ, n_kv_heads=2, head_dim=HD, window=24, attn_softcap=40.0)
    T, d = 1100, 32  # 3 q chunks of 512, the banded path (1100 > 24 + 512)
    jp = jax_init_attn(jax.random.key(0), d, jspec, jnp.float32)
    x = np.random.default_rng(1).standard_normal((1, T, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (1, T))
    want = np.asarray(jax_attend_full(jp, jspec, jnp.asarray(x), jnp.asarray(pos), 24))
    p = {k: torch.tensor(np.asarray(a)) for k, a in jp.items()}
    calls = []
    raw = attention.blockwise_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return raw(*a, **kw)

    attention.blockwise_attention = counted
    try:
        got = attention.attend_full(p, spec, torch.tensor(x), torch.tensor(pos), 24,
                                    rt=Runtime(kernel_backend="ref"))
    finally:
        attention.blockwise_attention = raw
    assert calls == [(1, T, 2, 2, HD)]
    assert _rel(got, torch.tensor(want)) <= TOL


def _peak(fn, *shapes):
    """The most bytes alive at once, counted by the dry run's Ledger on
    fake CPU tensors, over ``fn`` of fake fp32 tensors of ``shapes`` (each
    requiring grad) and its backward to all of them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import Ledger

    led = Ledger("cpu")
    with FakeTensorMode():
        args = [torch.empty(s, requires_grad=True) for s in shapes]
        for a in args:
            led.track(a)
        with led:
            out = fn(*args)
            torch.autograd.grad(out, args, torch.empty(out.shape))
    return led.peak


def test_attend_full_peak_is_below_half_of_the_materialized_scores():
    from repro_torch.kernels.flash_attn.ref import attention_ref

    T, d, Hkv = 2048, 64, 2
    spec = AttnSpec(n_heads=HQ, n_kv_heads=Hkv, head_dim=HD)
    names = ("wq", "wk", "wv", "wo")
    shapes = [(1, T, d), (d, spec.q_dim), (d, spec.kv_dim), (d, spec.kv_dim), (spec.q_dim, d)]

    def layer(x, *w):
        return attention.attend_full(dict(zip(names, w)), spec, x, torch.arange(T)[None], None,
                                     rt=Runtime(kernel_backend="ref"))

    def layer_ref(x, *w):
        q, k, v = attention._project_qkv(dict(zip(names, w)), spec, x, torch.arange(T)[None])
        o = attention_ref(q.reshape(1, T, Hkv, HQ // Hkv, HD), k, v)
        return o.reshape(1, T, spec.q_dim) @ w[3]

    blockwise, materialized = _peak(layer, *shapes), _peak(layer_ref, *shapes)
    scores = 1 * HQ * T * T * 4  # one (B, Hkv, G, T, S) fp32 tensor
    assert materialized > 2 * scores  # the oracle does hold its scores
    assert blockwise < materialized / 2, (blockwise, materialized)
