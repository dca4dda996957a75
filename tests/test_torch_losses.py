"""The port's MELINOE losses against the JAX package's on the CPU: the
cache-simulation loss (``core/cache_sim.py``: request estimators, the
sequential ``scan`` and the log-depth ``assoc`` evaluation, values and
gradients), its hard counterparts, the rank-matching loss
(``core/rank_match.py``) and the per-layer combination
(``core/losses.py``).

Inputs come from a numpy seed. Tolerance: 1e-5 (relative and absolute)
on every fp32 value and gradient: both sides compute the same fp32
operations, in another order only where a sum or a scan is split
differently (the doubling scan against XLA's associative scan, a
token-chunked sum). Miss counts, inversion counts and replayed cache
misses are integers and must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MelinoeSpec as JaxMelinoeSpec  # noqa: E402
from repro.core import cache_sim as jcs  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import rank_match as jrm  # noqa: E402
from repro_torch.configs.base import MelinoeSpec  # noqa: E402
from repro_torch.core import cache_sim as tcs  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.core import rank_match as trm  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-5, atol=1e-5)


def _probs(seed, B, T, E, conc=2.0):
    logits = np.random.default_rng(seed).standard_normal((B, T, E)) * conc
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("mode", ["soft", "hard", "hard_st"])
def test_topk_request_matches(mode):
    p = _probs(0, 2, 5, 16)
    _close(tcs.topk_request(torch.from_numpy(p), 4, mode),
           jcs.topk_request(jnp.asarray(p), 4, mode))


@pytest.mark.parametrize("T", [1, 7, 64])
def test_soft_cache_states_scan_and_assoc_match(T):
    r = np.array(jcs.topk_request(jnp.asarray(_probs(1, 1, T, 16)[0]), 4, "soft"))
    jc, jf = jcs.soft_cache_states(jnp.asarray(r), 0.9, 4, 4)
    tc, tf = tcs.soft_cache_states(torch.from_numpy(r), 0.9, 4, 4)
    _close(tc, jc)
    _close(tf, jf)
    jc, jf = jcs.soft_cache_states_assoc(jnp.asarray(r), 0.9, 4)
    tc2, tf2 = tcs.soft_cache_states_assoc(torch.from_numpy(r), 0.9, 4)
    _close(tc2, jc)
    _close(tf2, jf)
    # the two evaluations agree with each other, batched too
    rb = torch.from_numpy(np.stack([r, r[::-1].copy()]))
    cb, fb = tcs.soft_cache_states_assoc(rb, 0.9, 4)
    cs, fs = tcs.soft_cache_states(rb, 0.9, 4, 4)
    torch.testing.assert_close(cb, cs, **TOL)
    torch.testing.assert_close(fb, fs, **TOL)
    torch.testing.assert_close(cb.sum(-1), torch.full(cb.shape[:-1], 4.0), **TOL)


def test_assoc_is_finite_far_past_fp32_closed_form_range():
    """T = 2000: a closed form in gamma**-t would overflow fp32 (0.9**-t
    passes 3.4e38 near t = 840); the doubling scan stays finite and equal
    to the sequential recursion."""
    r = tcs.topk_request(torch.from_numpy(_probs(2, 1, 2000, 8)), 2, "soft")
    ca, _ = tcs.soft_cache_states_assoc(r, 0.9, 2)
    cs, _ = tcs.soft_cache_states(r, 0.9, 2, 2)
    assert torch.isfinite(ca).all()
    torch.testing.assert_close(ca, cs, **TOL)


@pytest.mark.parametrize("T", [1, 7, 300])
@pytest.mark.parametrize("impl", ["scan", "assoc"])
@pytest.mark.parametrize("mode", ["soft", "hard_st"])
def test_cache_sim_loss_values_and_grads_match(mode, impl, T):
    p = _probs(3, 2, T, 16)
    kw = dict(top_k=4, gamma=0.9, cache_capacity=4, request_mode=mode, impl=impl)
    jv, jg = jax.value_and_grad(lambda x: jcs.cache_sim_loss(x, **kw))(jnp.asarray(p))
    tp = torch.from_numpy(p).requires_grad_()
    tv = tcs.cache_sim_loss(tp, **kw)
    (tg,) = torch.autograd.grad(tv, tp)
    _close(tv, jv)
    _close(tg, jg)


def test_hard_cache_misses_and_replay_match():
    p = _probs(4, 1, 64, 16)[0]
    r = np.array(jcs.topk_request(jnp.asarray(p), 4, "hard"))
    jm = float(jcs.hard_cache_misses(jnp.asarray(r), 0.9, 4))
    tm = float(tcs.hard_cache_misses(torch.from_numpy(r), 0.9, 4))
    assert tm == jm and tm > 0
    ids = np.argsort(-p, axis=-1, kind="stable")[:, :4]
    for policy in ("lru", "lfu", "gamma"):
        assert tcs.replay_trace_misses(ids, 4, policy) == \
            jcs.replay_trace_misses(ids, 4, policy)


def test_rank_match_and_inversions_match():
    pb, pf = _probs(5, 2, 37, 16), _probs(6, 2, 37, 16)
    np.testing.assert_array_equal(
        trm.inversion_count(torch.from_numpy(pb), torch.from_numpy(pf)).numpy(),
        np.asarray(jrm.inversion_count(jnp.asarray(pb), jnp.asarray(pf))))
    _close(trm.rank_match_token(torch.from_numpy(pb), torch.from_numpy(pf), 0.1),
           jrm.rank_match_token(jnp.asarray(pb), jnp.asarray(pf), 0.1))
    # T = 37 in chunks of 16: the padded tokens contribute nothing
    f = lambda x: jrm.rank_match_loss(jnp.asarray(pb), x, rho=0.1, token_chunk=16)  # noqa: E731
    jv, jg = jax.value_and_grad(f)(jnp.asarray(pf))
    tp = torch.from_numpy(pf).requires_grad_()
    tv = trm.rank_match_loss(torch.from_numpy(pb), tp, rho=0.1, token_chunk=16)
    (tg,) = torch.autograd.grad(tv, tp)
    _close(tv, jv)
    _close(tg, jg)


def test_rank_match_hinge_gradient_at_a_tie_is_half():
    """``torch.maximum`` splits the gradient at a tie as ``jnp.maximum``
    does (0.5 each); ``clamp(min=0)`` would pass all of it."""
    pb = np.array([[[0.6, 0.4]]], np.float32)
    pf = np.array([[[0.55, 0.45]]], np.float32)  # rho - diff = 0 for the (0, 1) pair
    jg = jax.grad(lambda x: jrm.rank_match_loss(jnp.asarray(pb), x, rho=0.1))(
        jnp.asarray(pf))
    tp = torch.from_numpy(pf).requires_grad_()
    (tg,) = torch.autograd.grad(trm.rank_match_loss(torch.from_numpy(pb), tp, rho=0.1), tp)
    _close(tg, jg)


@pytest.mark.parametrize("mode", ["soft", "hard_st"])
def test_melinoe_layer_losses_and_nll_match(mode):
    rng = np.random.default_rng(7)
    B, T, d, E = 2, 9, 12, 8
    probs = _probs(8, B, T, E)
    h = rng.standard_normal((B, T, d)).astype(np.float32)
    router = (rng.standard_normal((d, E)) * 0.3).astype(np.float32)
    jspec = JaxMelinoeSpec(request_mode=mode, rm_token_chunk=4)
    tspec = MelinoeSpec(request_mode=mode, rm_token_chunk=4)

    def jf(x):
        cs, rm = jlosses.melinoe_layer_losses(probs=x, moe_h=jnp.asarray(h),
                                              base_router=jnp.asarray(router), spec=jspec,
                                              cache_capacity=2, top_k=2)
        return jlosses.combine(jnp.float32(1.5), cs, rm, jspec), (cs, rm)

    (jv, (jcs_, jrm_)), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(probs))
    tp = torch.from_numpy(probs).requires_grad_()
    cs, rm = tlosses.melinoe_layer_losses(probs=tp, moe_h=torch.from_numpy(h),
                                          base_router=torch.from_numpy(router), spec=tspec,
                                          cache_capacity=2, top_k=2)
    tv = tlosses.combine(torch.tensor(1.5), cs, rm, tspec)
    (tg,) = torch.autograd.grad(tv, tp)
    _close(cs, jcs_)
    _close(rm, jrm_)
    _close(tv, jv)
    _close(tg, jg)
    assert float(rm.detach()) > 0
    # without a base router the rank term is zero
    _, rm0 = tlosses.melinoe_layer_losses(probs=tp, moe_h=None, base_router=None,
                                          spec=tspec, cache_capacity=2, top_k=2)
    assert float(rm0) == 0.0
    logits = rng.standard_normal((B, T, 11)).astype(np.float32)
    tgt = rng.integers(0, 11, (B, T))
    mask = (rng.random((B, T)) > 0.3).astype(np.float32)
    _close(tlosses.nll_loss(torch.from_numpy(logits), torch.from_numpy(tgt)),
           jlosses.nll_loss(jnp.asarray(logits), jnp.asarray(tgt, jnp.int32)))
    _close(tlosses.nll_loss(torch.from_numpy(logits), torch.from_numpy(tgt),
                            torch.from_numpy(mask)),
           jlosses.nll_loss(jnp.asarray(logits), jnp.asarray(tgt, jnp.int32),
                            jnp.asarray(mask)))
