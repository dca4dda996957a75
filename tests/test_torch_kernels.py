"""Port kernels (repro_torch.kernels) against the JAX package's oracles.

On the CPU every wrapper takes its plain PyTorch version; the same
numpy inputs go through the JAX reference (and, for the grouped matmul,
the Pallas kernel in interpret mode) and through the port. Tolerances
are fp32 with another summation order: 1e-5 relative plus 1e-5 absolute
on O(1) outputs. The Hopper kernels themselves are tested on the card in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.moe_gmm import gmm as jax_gmm, gmm_ref as jax_gmm_ref  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attn import flash  # noqa: E402
from repro_torch.kernels.moe_gmm import gmm  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-5, atol=1e-5)  # fp32, summation order


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Selection tests must not see an exported backend override."""
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)


def _ragged(E, M, K, N, sizes, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((E, M, K)).astype(np.float32)
    a *= (np.arange(M)[None, :] < np.asarray(sizes)[:, None])[..., None]
    b = (rng.standard_normal((E, K, N)) * K**-0.5).astype(np.float32)
    return a, b


# ---------------------------------------------------------------------------
# grouped expert matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "E,M,K,N,sizes",
    [
        (4, 64, 128, 96, (0, 17, 64, 3)),
        (8, 33, 256, 128, (33, 0, 0, 5, 12, 33, 1, 0)),
        (2, 7, 64, 32, (0, 0)),
        (3, 16, 96, 64, (16, 16, 16)),
    ],
)
def test_gmm_plain_matches_jax_ref_and_pallas(E, M, K, N, sizes):
    a, b = _ragged(E, M, K, N, sizes)
    gs = np.asarray(sizes, np.int32)
    ref = np.asarray(jax_gmm_ref(jnp.asarray(a), jnp.asarray(b)))
    pallas = np.asarray(jax_gmm(jnp.asarray(a), jnp.asarray(b), backend="pallas",
                                interpret=True, group_sizes=jnp.asarray(gs)))
    out = gmm(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(gs)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)
    for e, s in enumerate(sizes):  # zero tails stay exactly zero
        assert not out[e, s:].any()


def test_gmm_bf16_output_dtype():
    a, b = _ragged(2, 5, 32, 16, (5, 2))
    out = gmm(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == (2, 5, 16)


# ---------------------------------------------------------------------------
# flash attention (held against attention_ref, not the Pallas kernel,
# which disagrees with its own oracle on this tree: ROADMAP Queue 3)
# ---------------------------------------------------------------------------

FLASH_CASES = [  # the cases of tests/test_kernels.py::test_flash_attn_vs_ref
    (2, 64, 2, 2, 16, None, None),
    (1, 128, 1, 4, 32, 50.0, None),
    (2, 96, 2, 1, 16, None, 32),
    (1, 64, 2, 2, 16, 30.0, 24),
]


@pytest.mark.parametrize("B,T,Hkv,G,hd,cap,win", FLASH_CASES)
def test_flash_plain_matches_jax_attention_ref(B, T, Hkv, G, hd, cap, win):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, T, Hkv, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    ref = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       softcap=cap, window=win))
    out = flash(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                softcap=cap, window=win).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version and never count a launch
# ---------------------------------------------------------------------------


def test_cpu_tensors_never_count_a_launch():
    dispatch.reset_launches()
    a, b = _ragged(2, 4, 32, 16, (4, 1))
    gmm(torch.from_numpy(a), torch.from_numpy(b), backend="auto")
    q = torch.zeros(1, 8, 1, 1, 16)
    k = torch.zeros(1, 8, 1, 16)
    flash(q, k, k, backend="auto")
    assert dispatch.LAUNCHES["moe_gmm"] == 0
    assert dispatch.LAUNCHES["flash_attn"] == 0


def test_hopper_on_cpu_tensor_raises(monkeypatch):
    a, b = _ragged(2, 4, 32, 16, (4, 1))
    with pytest.raises(RuntimeError, match="hopper"):
        gmm(torch.from_numpy(a), torch.from_numpy(b), backend="hopper")
    q = torch.zeros(1, 8, 1, 1, 16)
    k = torch.zeros(1, 8, 1, 16)
    with pytest.raises(RuntimeError, match="hopper"):
        flash(q, k, k, backend="hopper")
    monkeypatch.setenv(dispatch.ENV_VAR, "moe_gmm=hopper")
    with pytest.raises(RuntimeError, match="hopper"):
        gmm(torch.from_numpy(a), torch.from_numpy(b))


def test_dispatch_spec_and_env_merge(monkeypatch):
    assert dispatch.op_backend("moe_gmm", None) == "auto"
    assert dispatch.op_backend("moe_gmm", "ref,flash_attn=hopper") == "ref"
    assert dispatch.op_backend("flash_attn", "ref,flash_attn=hopper") == "hopper"
    for bad in ("pallas", "moe_gmm=cuda", "nope=ref"):
        with pytest.raises(ValueError):
            dispatch.parse_spec(bad)
    monkeypatch.setenv(dispatch.ENV_VAR, "flash_attn=ref")
    assert dispatch.op_backend("flash_attn", "hopper") == "ref"  # env wins per op
    assert dispatch.op_backend("moe_gmm", "hopper") == "hopper"  # rest kept
    assert not dispatch.use_kernel("moe_gmm", "ref", "cuda")  # ref is plain anywhere
    assert not dispatch.use_kernel("moe_gmm", "auto", torch.device("cpu"))
