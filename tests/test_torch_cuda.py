"""The port's Hopper kernels on the card, against their plain PyTorch
versions. Every test here needs an NVIDIA GPU and skips without one; the
module imports neither JAX nor the JAX package, so it runs where the
card is:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's ``conftest.py`` imports JAX.)

Tolerances: fp32 — both sides accumulate in fp32, only the summation
order differs (1e-4 on O(1) values); bf16 — the output is rounded to
bf16, so the two may differ by one ulp (2^-7 relative, 1.6e-2 absolute).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attn import attention_ref, flash  # noqa: E402
from repro_torch.kernels.int4_matmul import (int4_matmul, int4_matmul_ref,  # noqa: E402
                                             quantize_matmul_weight)
from repro_torch.kernels.moe_gmm import gmm, gmm_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.cuda]

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2**-7, atol=1.6e-2)}


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Hopper kernels have no CPU mode)")
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    return torch.device("cuda")


def _ragged(E, M, K, N, sizes, dtype, device):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((E, M, K)).astype(np.float32)
    a *= (np.arange(M)[None, :] < np.asarray(sizes)[:, None])[..., None]
    b = (rng.standard_normal((E, K, N)) * K**-0.5).astype(np.float32)
    return (torch.from_numpy(a).to(device, dtype), torch.from_numpy(b).to(device, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,K,N,sizes", [
    (8, 33, 256, 128, (33, 0, 0, 5, 12, 33, 1, 0)),  # ragged M, K, N tails
    (4, 4, 2048, 1024, (4, 1, 0, 3)),  # decode shape, small-M tile
    (3, 100, 70, 50, (100, 37, 0)),  # nothing divides the tiles
])
def test_gmm_kernel_matches_plain(cuda, dtype, E, M, K, N, sizes):
    a, b = _ragged(E, M, K, N, sizes, dtype, cuda)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    n0 = dispatch.LAUNCHES["moe_gmm"]
    out = gmm(a, b, gs)
    dense = gmm(a, b)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["moe_gmm"] == n0 + 2
    ref = gmm_ref(a, b)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(dense.float(), ref.float(), **TOL[dtype])
    for e, s in enumerate(sizes):  # zero tails stay exactly zero
        assert not out[e, s:].any()


def test_gmm_kernel_rejects_what_it_does_not_take(cuda):
    a, b = _ragged(2, 4, 32, 16, (4, 4), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        gmm(a.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(TypeError):
        gmm(a, b.double())
    with pytest.raises(RuntimeError, match="hopper"):
        gmm(a.cpu(), b.cpu(), backend="hopper")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,Hkv,G,hd,cap,win", [
    (2, 64, 2, 2, 16, None, None),
    (1, 128, 1, 4, 32, 50.0, None),
    (2, 96, 2, 1, 16, None, 32),
    (1, 64, 2, 2, 16, 30.0, 24),
    (4, 100, 16, 1, 128, None, None),  # olmoe heads, ragged T
    (2, 77, 8, 2, 64, None, None),
])
def test_flash_kernel_matches_plain(cuda, dtype, B, T, Hkv, G, hd, cap, win):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, T, Hkv, G, hd, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, T, Hkv, hd, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, T, Hkv, hd, device=cuda, generator=g).to(dtype)
    n0 = dispatch.LAUNCHES["flash_attn"]
    out = flash(q, k, v, softcap=cap, window=win)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["flash_attn"] == n0 + 1
    ref = attention_ref(q, k, v, softcap=cap, window=win)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def _int4_inputs(M, K, N, group, dtype, device):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.05).astype(np.float32))
    q = quantize_matmul_weight(w, group)
    return x.to(device, dtype), [t.to(device) for t in q[:3]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,group", [
    (1, 2048, 1024, 32),  # decode shapes, small-M tile
    (4, 1024, 2048, 32),
    (5, 192, 50, 64),  # N tail, K a multiple of the group but not of the slice
    (17, 2048, 1000, 32),  # just past the small-M tile, N tail
    (130, 320, 96, 64),  # M tail on the large tile
    (512, 1024, 2048, 32),  # prefill shape
    (3, 96, 40, 2),  # smallest group
])
def test_int4_kernel_matches_plain(cuda, dtype, M, K, N, group):
    x, (p, s, z) = _int4_inputs(M, K, N, group, dtype, cuda)
    n0 = dispatch.LAUNCHES["int4_matmul"]
    out = int4_matmul(x, p, s, z, group=group)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["int4_matmul"] == n0 + 1
    assert out.dtype == dtype and out.shape == (M, N)
    ref = int4_matmul_ref(x, p, s, z, group)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def test_int4_kernel_rejects_what_it_does_not_take(cuda):
    x, (p, s, z) = _int4_inputs(4, 64, 16, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="group"):
        int4_matmul(x, p, s, z, group=48)  # K % group
    with pytest.raises(ValueError, match="group"):
        int4_matmul(x, p, s, z, group=5)  # odd group
    with pytest.raises(ValueError, match="fit"):
        int4_matmul(x[:, :32], p, s, z, group=32)  # packed rows != K/2
    with pytest.raises(TypeError):
        int4_matmul(x.double(), p, s, z, group=32)
    with pytest.raises(TypeError):
        int4_matmul(x, p, s.half(), z, group=32)
    with pytest.raises(ValueError, match="contiguous"):
        int4_matmul(x, p.t().contiguous().t(), s, z, group=32)
    with pytest.raises(RuntimeError, match="hopper"):
        int4_matmul(x.cpu(), p.cpu(), s.cpu(), z.cpu(), group=32, backend="hopper")


def test_quantized_serve_through_kernels_matches_plain(cuda):
    """The INT4 slice end to end at a small size in fp32, on one set of
    codes: the kernel run and the plain run give the same tokens."""
    kw = dict(capacity=4, batch=2, prompt_len=16, max_new=6, dtype="float32",
              device="cuda", seed=0, quantized=True)
    dispatch.reset_launches()
    hop = serve.run("olmoe-mini", keep_store=True, **kw)
    assert all(dispatch.LAUNCHES[op] > 0
               for op in ("int4_matmul", "moe_gmm", "flash_attn")), dispatch.LAUNCHES
    ref = serve.run("olmoe-mini", kernel_backend="ref",
                    quantized_experts=hop["quantized_experts"], **kw)
    np.testing.assert_array_equal(hop["tokens"], ref["tokens"])
    torch.testing.assert_close(hop["prefill_logits"], ref["prefill_logits"],
                               rtol=1e-3, atol=1e-3)
    assert (hop["transfers"], hop["hits"]) == (ref["transfers"], ref["hits"])


def test_serve_through_kernels_matches_plain(cuda):
    """The slice end to end at a small size in fp32: the kernel run and
    the plain run give the same tokens and close prefill logits."""
    kw = dict(capacity=4, batch=2, prompt_len=16, max_new=6, dtype="float32",
              device="cuda", seed=0)
    dispatch.reset_launches()
    hop = serve.run("olmoe-mini", **kw)
    assert dispatch.LAUNCHES["moe_gmm"] > 0 and dispatch.LAUNCHES["flash_attn"] > 0
    ref = serve.run("olmoe-mini", kernel_backend="ref", **kw)
    np.testing.assert_array_equal(hop["tokens"], ref["tokens"])
    torch.testing.assert_close(hop["prefill_logits"], ref["prefill_logits"],
                               rtol=1e-3, atol=1e-3)
    assert (hop["transfers"], hop["hits"]) == (ref["transfers"], ref["hits"])
