"""Shared set-up of ``tests/test_torch_dense.py`` and
``tests/test_torch_dense_prefix.py``: JAX ``init_params`` trees carried
across by the bridge, and a greedy prefill + decode chain on each side.

The JAX side runs its plain path (``Runtime(kernel_backend="ref")``,
decode jitted); the port runs on the CPU. Greedy tokens are each side's
own argmax, so a chain that drifts shows as other tokens as well as
other logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import Runtime as JaxRuntime  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402

# fp32 on both sides; the logits are many products deep and the sums run
# in another order
TOL_LOGITS = dict(rtol=1e-4, atol=1e-4)
CPU = Runtime(device=torch.device("cpu"))
JAX_REF = JaxRuntime(kernel_backend="ref")


def bridge(arch: str, cut=lambda cfg: cfg):
    """(jax cfg, port cfg, numpy tree, port params) of ``arch``, ``cut``
    applied alike to both packages' configs; weights from key 0 in fp32."""
    jcfg, tcfg = cut(jax_get_config(arch)), cut(get_config(arch))
    tree = jax.tree.map(np.asarray, jax_init_params(jax.random.key(0), jcfg, jnp.float32))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg)


def prompt(cfg, B: int, T: int, seed: int, prefix: bool = False):
    """(tokens (B, T) int32, prefix (B, cfg.prefix_len, d) fp32 or None)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    pe = (rng.standard_normal((B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
          if prefix else None)
    return toks, pe


def jax_chain(jcfg, tree, toks, G: int, prefix=None, n_slots=None, window_override=None):
    """The JAX prefill, then G greedy decode steps: (logits (B, 1 + G, V),
    tokens (B, G))."""
    jp = jax.tree.map(jnp.asarray, tree)
    lg, cache = jax_prefill(jp, jcfg, jnp.asarray(toks), JAX_REF,
                            prefix_embed=None if prefix is None else jnp.asarray(prefix),
                            n_slots=n_slots, window_override=window_override)
    dec = jax.jit(lambda p, t, c: jax_decode_step(p, jcfg, t, c, JAX_REF,
                                                  window_override=window_override))
    logits, tokens = [np.asarray(lg)], []
    for _ in range(G):
        tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok))
        lg, cache, _ = dec(jp, tok, cache)
        logits.append(np.asarray(lg))
    return np.concatenate(logits, 1), np.concatenate(tokens, 1)


def torch_chain(tcfg, params, toks, G: int, prefix=None, n_slots=None,
                window_override=None):
    """The port's ``prefill`` and G greedy ``decode_step`` s, as
    :func:`jax_chain`; also the final cache position."""
    lg, cache = tmodel.prefill(params, tcfg, torch.as_tensor(toks).long(), CPU,
                               prefix_embed=None if prefix is None else torch.as_tensor(prefix),
                               n_slots=n_slots, window_override=window_override)
    logits, tokens = [lg], []
    for _ in range(G):
        tok = torch.argmax(lg[:, -1], -1)[:, None]
        tokens.append(tok)
        lg, cache, _ = tmodel.decode_step(params, tcfg, tok, cache, CPU,
                                          window_override=window_override)
        logits.append(lg)
    return torch.cat(logits, 1).numpy(), torch.cat(tokens, 1).numpy(), cache["pos"]


def assert_chains_match(jcfg, tree, tcfg, params, toks, G: int, **kw):
    """Prefill + G decode steps on both sides: every step's logits within
    TOL_LOGITS, the greedy tokens identical, the cache position prefix +
    prompt + G."""
    jl, jt = jax_chain(jcfg, tree, toks, G, **kw)
    tl, tt, pos = torch_chain(tcfg, params, toks, G, **kw)
    assert tl.shape == jl.shape == (toks.shape[0], 1 + G, jcfg.vocab)
    np.testing.assert_allclose(tl, jl, **TOL_LOGITS)
    np.testing.assert_array_equal(tt, jt)
    P = 0 if kw.get("prefix") is None else kw["prefix"].shape[1]
    assert pos == P + toks.shape[1] + G
