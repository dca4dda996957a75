"""The dense configs and the paper's two MoE backbones whole on the
port's full-model path — ``apply_model``, ``prefill`` and ``decode_step``
— against the JAX package on the CPU, at smoke size: gemma2 (local and
global attention, softcaps, tied and scaled embeddings), qwen3 (qk-norm),
stablelm (head dim 160 at full width), command-r-plus, musicgen and
internvl2 without their prefix (with it: tests/test_torch_dense_prefix.py),
mixtral and phi35 (top-2 MoE). gemma2 also past its sliding window.

Weights are JAX ``init_params`` trees (fp32) carried across by the
bridge; tokens are drawn with numpy. Tolerance, fp32: logits 1e-4 (many
products deep, another summation order); greedy tokens identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_dense import (CPU, JAX_REF, TOL_LOGITS, assert_chains_match, bridge,  # noqa: E402
                          prompt)
from _torch_threads import one_thread  # noqa: E402,F401
from repro.models import apply_model as jax_apply_model  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

pytestmark = pytest.mark.torch

ARCHS = ["gemma2-27b-smoke", "qwen3-4b-smoke", "stablelm-12b-smoke",
         "command-r-plus-104b-smoke", "musicgen-medium-smoke", "internvl2-76b-smoke",
         "mixtral-8x7b-smoke", "phi35-moe-smoke"]


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    return bridge(request.param)


def test_apply_model_logits_match_jax(bridged):
    jcfg, tcfg, tree, params = bridged
    toks, _ = prompt(jcfg, 2, 20, seed=5)
    jl, _ = jax_apply_model(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks),
                            JAX_REF)
    tl, _ = tmodel.apply_model(params, tcfg, torch.as_tensor(toks).long(), CPU)
    assert tl.dtype == torch.float32 and tl.shape == (2, 20, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_LOGITS)


def test_prefill_then_decode_matches_jax(bridged):
    """A prefill of 12 tokens and 8 greedy decode steps."""
    jcfg, tcfg, tree, params = bridged
    toks, _ = prompt(jcfg, 2, 12, seed=6)
    assert_chains_match(jcfg, tree, tcfg, params, toks, 8, n_slots=12 + 8)


def _local_window(w):
    def cut(cfg):
        local = cfg.block_defs["local"]
        defs = dict(cfg.block_defs, local=dataclasses.replace(
            local, attn=dataclasses.replace(local.attn, window=w)))
        return dataclasses.replace(cfg, block_defs=defs)
    return cut


@pytest.mark.parametrize("case", ["local-window-16", "override-16-ring-24"])
def test_gemma2_past_its_window_matches_jax(case):
    """A 40-token gemma2 prompt past a window of 16, then 8 decode steps:
    the local layers' window cut to 16 in both configs (the global layers
    see every key; the cache holds all 48 positions), or
    ``window_override=16`` on every layer with a 24-slot cache, so that
    the ring wraps in the prefill and again in decode."""
    if case == "local-window-16":
        jcfg, tcfg, tree, params = bridge("gemma2-27b-smoke", _local_window(16))
        kw = dict(n_slots=48)
    else:
        jcfg, tcfg, tree, params = bridge("gemma2-27b-smoke")
        kw = dict(n_slots=24, window_override=16)
    toks, _ = prompt(jcfg, 2, 40, seed=7)
    assert_chains_match(jcfg, tree, tcfg, params, toks, 8, **kw)
