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

from repro_torch.configs.base import SSMSpec  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attn import attention_ref, flash, flash_hopper  # noqa: E402
from repro_torch.kernels.int4_matmul import (int4_matmul, int4_matmul_hopper,  # noqa: E402
                                             int4_matmul_ref, quantize_matmul_weight)
from repro_torch.kernels.moe_gmm import gmm, gmm_hopper, gmm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd, ssd_hopper, ssd_scan_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.mamba2 import ssd_chunked  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.cuda]

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2**-7, atol=1.6e-2)}
# ssd_scan against the sequential recurrence: the chunked form computes
# each decay as exp(sum) instead of a product of exps, a few ulp per step
# (the tolerance of tests/test_kernels.py::test_ssd_vs_sequential_ref);
# the final state is fp32 at any input type
TOL_SSD = {torch.float32: dict(rtol=1e-3, atol=5e-4), torch.bfloat16: TOL[torch.bfloat16]}


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


@pytest.mark.parametrize("K,N", [(2048, 1024), (1024, 2048),
                                 (1032, 520)])  # aligned, not a tile multiple
@pytest.mark.parametrize("M", [1, 4, 16, 17, 64, 100, 512])
def test_gmm_tensor_core_routes_match_plain(cuda, M, K, N):
    """bf16 takes the decode route ("stream") up to 16 rows and the
    prefill route ("tc") above; groups empty, full and ending inside a
    tile; zero tails exact; repeated runs give equal bits."""
    sizes = (0, M, (3 * M) // 5 + 1, 1)
    a, b = _ragged(4, M, K, N, sizes, torch.bfloat16, cuda)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    want = "stream" if M <= 16 else "tc"
    n0 = dispatch.ROUTE_LAUNCHES["moe_gmm"].get(want, 0)
    out = gmm(a, b, gs)
    dense = gmm(a, b)
    again = gmm(a, b, gs)
    torch.cuda.synchronize()
    assert dispatch.ROUTE_LAUNCHES["moe_gmm"][want] == n0 + 3
    ref = gmm_ref(a, b)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(dense.float(), ref.float(), **TOL[torch.bfloat16])
    assert torch.equal(out, again)
    for e, s in enumerate(sizes):  # zero tails stay exactly zero
        assert not out[e, s:].any()


def test_gmm_cuda_core_route_takes_the_rest(cuda):
    """fp32, unaligned widths and misaligned pointers stay on the CUDA-core
    kernel; a forced route that cannot take its inputs raises."""
    fma0 = dispatch.ROUTE_LAUNCHES["moe_gmm"].get("fma", 0)
    a, b = _ragged(3, 100, 70, 50, (100, 37, 0), torch.bfloat16, cuda)
    gmm(a, b)
    a32, b32 = _ragged(2, 4, 64, 32, (4, 2), torch.float32, cuda)
    gmm(a32, b32)
    a, b = _ragged(2, 4, 64, 32, (4, 2), torch.bfloat16, cuda)
    flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda)
    shifted = flat[1:].view(a.shape)  # 2 bytes past a 16-byte boundary
    shifted.copy_(a)
    out = gmm(shifted, b)
    torch.cuda.synchronize()
    assert dispatch.ROUTE_LAUNCHES["moe_gmm"]["fma"] == fma0 + 3
    torch.testing.assert_close(out.float(), gmm_ref(a, b).float(), **TOL[torch.bfloat16])
    forced = gmm_hopper(a, b, force_route="fma")
    torch.testing.assert_close(forced.float(), gmm_ref(a, b).float(), **TOL[torch.bfloat16])
    with pytest.raises(ValueError, match="route"):
        gmm_hopper(shifted, b, force_route="stream")
    with pytest.raises(ValueError, match="route"):
        gmm_hopper(a32, b32, force_route="tc")


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
    (2, 100, 4, 2, 112, None, None),  # zamba2-7b's head dim, ragged T
    (2, 90, 2, 4, 160, None, None),  # stablelm-12b's head dim, ragged T
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


@pytest.mark.parametrize("B,T,Hkv,G,hd,cap,win", [
    (2, 100, 4, 1, 64, None, None),  # T not a multiple of the 64-row tile
    (2, 77, 2, 2, 112, None, None),
    (1, 130, 2, 4, 128, None, None),
    (2, 200, 2, 2, 128, 50.0, None),  # softcap
    (2, 150, 4, 1, 112, None, 48),  # window inside the walk
    (1, 300, 2, 4, 64, 30.0, 100),  # both
    (4, 512, 4, 1, 112, None, None),  # zamba2-7b's prefill length
    # enough row blocks for the kernel's many-block configuration
    (4, 512, 32, 1, 112, None, None),  # zamba2-7b's prefill, full width
    (4, 300, 32, 1, 128, None, None),
    (2, 600, 16, 4, 64, 30.0, 200),
    (2, 130, 2, 4, 160, None, None),  # stablelm-12b's head dim, ragged T
    (4, 512, 8, 4, 160, None, None),  # stablelm-12b's prefill, full width
    (2, 200, 2, 2, 160, 50.0, 64),  # softcap and window at hd 160
])
def test_flash_tensor_core_route_matches_plain(cuda, B, T, Hkv, G, hd, cap, win):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(*shape, device=cuda, generator=g).to(torch.bfloat16)
               for shape in ((B, T, Hkv, G, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)))
    n0 = dispatch.ROUTE_LAUNCHES["flash_attn"].get("tc", 0)
    out = flash(q, k, v, softcap=cap, window=win)
    torch.cuda.synchronize()
    assert dispatch.ROUTE_LAUNCHES["flash_attn"]["tc"] == n0 + 1
    ref = attention_ref(q, k, v, softcap=cap, window=win)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])


def test_flash_cuda_core_route_takes_the_rest(cuda):
    """fp32 and misaligned bf16 stay on the CUDA-core kernel; forcing the
    tensor-core route on them raises."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(1, 40, 2, 2, 64, device=cuda, generator=g)
    k = torch.randn(1, 40, 2, 64, device=cuda, generator=g)
    v = torch.randn(1, 40, 2, 64, device=cuda, generator=g)
    fma0 = dispatch.ROUTE_LAUNCHES["flash_attn"].get("fma", 0)
    flash(q, k, v)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    flat = torch.empty(qb.numel() + 1, dtype=qb.dtype, device=cuda)
    shifted = flat[1:].view(qb.shape)  # 2 bytes past a 16-byte boundary
    shifted.copy_(qb)
    out = flash(shifted, kb, vb)
    torch.cuda.synchronize()
    assert dispatch.ROUTE_LAUNCHES["flash_attn"]["fma"] == fma0 + 2
    torch.testing.assert_close(out.float(), attention_ref(qb, kb, vb).float(),
                               **TOL[torch.bfloat16])
    with pytest.raises(ValueError, match="route"):
        flash_hopper(q, k, v, force_route="tc")
    with pytest.raises(ValueError, match="route"):
        flash_hopper(shifted, kb, vb, force_route="tc")


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


def _ssd_inputs(B, T, H, P, N, G, with_init, dtype, device):
    """Model-like inputs: dt = softplus(N(-4.6, 0.5)) (about 0.01, the
    init's dt_bias) and A = -(1..16), so the state carries across chunks;
    D about 1 (the skip)."""
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(B, T, H, P, generator=g, device=device).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, T, H, generator=g, device=device) * 0.5 - 4.6)
    A = -torch.linspace(1.0, 16.0, H, device=device)
    Bm = torch.randn(B, T, G, N, generator=g, device=device).to(dtype)
    Cm = torch.randn(B, T, G, N, generator=g, device=device).to(dtype)
    init = (torch.randn(B, H, P, N, generator=g, device=device) * 0.5
            if with_init else None)
    D = 1.0 + 0.1 * torch.randn(H, generator=g, device=device)
    return x, dt, A, Bm, Cm, init, D


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,P,N,G,chunk,with_init,with_d", [
    (2, 70, 8, 32, 16, 1, 32, True, True),  # smoke shapes, ragged T
    (2, 300, 16, 64, 64, 1, 128, False, False),  # zamba2-7b's P, N; ragged T
    (1, 260, 8, 64, 128, 1, 128, True, True),  # mamba2-130m's P, N
    (2, 130, 8, 64, 64, 2, 128, True, False),  # two groups
    (1, 20, 4, 64, 64, 4, 128, False, True),  # T below the chunk, 4 groups
    (4, 512, 112, 64, 64, 1, 128, False, True),  # zamba2-7b serve shape
])
def test_ssd_kernel_matches_plain(cuda, dtype, B, T, H, P, N, G, chunk, with_init,
                                  with_d):
    x, dt, A, Bm, Cm, init, D = _ssd_inputs(B, T, H, P, N, G, with_init, dtype, cuda)
    D = D if with_d else None
    n0 = dispatch.LAUNCHES["ssd_scan"]
    y, fin = ssd(x, dt, A, Bm, Cm, init=init, D=D, chunk=chunk)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["ssd_scan"] == n0 + 1
    assert y.dtype == dtype and y.shape == x.shape and fin.dtype == torch.float32
    yr, fr = ssd_scan_ref(x, dt, A, Bm, Cm, init, D=D)
    torch.testing.assert_close(y.float(), yr.float(), **TOL_SSD[dtype])
    torch.testing.assert_close(fin, fr, **TOL_SSD[torch.float32])
    if dtype == torch.float32:  # the same chunked algorithm, summation order only
        spec = SSMSpec(N, head_dim=P, chunk=chunk, n_groups=G)
        yc, fc = ssd_chunked(x, dt, A, Bm, Cm, spec, init)
        if D is not None:
            yc = yc + D[None, None, :, None] * x
        torch.testing.assert_close(y, yc, **TOL[dtype])
        torch.testing.assert_close(fin, fc, **TOL[dtype])


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, A, Bm, Cm, _, D = _ssd_inputs(1, 16, 4, 64, 64, 1, False, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ssd(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm)
    with pytest.raises(TypeError):
        ssd(x, dt.bfloat16(), A, Bm, Cm)
    with pytest.raises(TypeError):
        ssd(x.bfloat16(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="d_state"):
        ssd(x[..., :48].contiguous(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="chunk"):
        ssd(x, dt, A, Bm, Cm, chunk=0)
    with pytest.raises(ValueError, match="D"):
        ssd(x, dt, A, Bm, Cm, D=D[:2])
    with pytest.raises(TypeError):
        ssd(x, dt, A, Bm, Cm, D=D.bfloat16())
    with pytest.raises(RuntimeError, match="hopper"):
        ssd(x.cpu(), dt.cpu(), A.cpu(), Bm.cpu(), Cm.cpu(), backend="hopper")


@pytest.mark.parametrize("arch,per_prefill", [
    ("zamba2-7b-smoke", {"ssd_scan": 1, "flash_attn": 1}),
    ("mamba2-130m-smoke", {"ssd_scan": 2, "flash_attn": 0}),
])
def test_full_path_serve_through_kernels_matches_plain(cuda, arch, per_prefill):
    """The SSM/hybrid slice end to end at smoke size in fp32: the kernel
    run and the plain run give the same tokens and close prefill logits;
    decode launches no kernel."""
    kw = dict(batch=2, prompt_len=150, max_new=6, dtype="float32", device="cuda",
              seed=0)
    hop = serve.run_full(arch, **kw)
    for op, n in per_prefill.items():
        assert hop["launches"]["prefill"][op] == n, hop["launches"]
    assert not any(hop["launches"]["decode"].values()), hop["launches"]
    ref = serve.run_full(arch, kernel_backend="ref", **kw)
    assert not any(ref["launches"]["prefill"].values())
    np.testing.assert_array_equal(hop["tokens"], ref["tokens"])
    torch.testing.assert_close(hop["prefill_logits"], ref["prefill_logits"],
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("K,N,group", [(2048, 1024, 32), (1024, 2048, 32),
                                       (2048, 1000, 32),  # ragged N: a tile's tail
                                       (2048, 1024, 64), (1024, 1000, 64)])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 512])
def test_int4_fast_routes_match_plain(cuda, M, K, N, group):
    """bf16 takes the split-K weight stream ("stream") up to 16 rows and
    the tensor-core tiles ("tc") above, within the bf16 tolerance of the
    plain version; repeated runs give equal bits (the splits meet in a
    fixed order); the forced CUDA-core route agrees too."""
    x, (p, s, z) = _int4_inputs(M, K, N, group, torch.bfloat16, cuda)
    want = "stream" if M <= 16 else "tc"
    n0 = dispatch.ROUTE_LAUNCHES["int4_matmul"].get(want, 0)
    out = int4_matmul(x, p, s, z, group=group)
    again = int4_matmul(x, p, s, z, group=group)
    torch.cuda.synchronize()
    assert dispatch.ROUTE_LAUNCHES["int4_matmul"][want] == n0 + 2
    ref = int4_matmul_ref(x, p, s, z, group)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[torch.bfloat16])
    assert torch.equal(out, again)
    fma = int4_matmul_hopper(x, p, s, z, group, force_route="fma")
    torch.testing.assert_close(fma.float(), ref.float(), **TOL[torch.bfloat16])


def test_int4_cuda_core_route_takes_the_rest(cuda):
    """fp32, N not a multiple of 8, small groups and misaligned pointers
    stay on the CUDA-core kernel; forcing a fast route on them raises."""
    fma0 = dispatch.ROUTE_LAUNCHES["int4_matmul"].get("fma", 0)
    x32, (p, s, z) = _int4_inputs(4, 256, 64, 32, torch.float32, cuda)
    int4_matmul(x32, p, s, z, group=32)
    xb, (pb, sb, zb) = _int4_inputs(4, 192, 50, 64, torch.bfloat16, cuda)
    int4_matmul(xb, pb, sb, zb, group=64)
    xg, (pg, sg, zg) = _int4_inputs(3, 96, 40, 2, torch.bfloat16, cuda)
    int4_matmul(xg, pg, sg, zg, group=2)
    x = x32.bfloat16()
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    shifted = flat[1:].view(x.shape)  # 2 bytes past a 16-byte boundary
    shifted.copy_(x)
    out = int4_matmul(shifted, p, s, z, group=32)
    torch.cuda.synchronize()
    assert dispatch.ROUTE_LAUNCHES["int4_matmul"]["fma"] == fma0 + 4
    torch.testing.assert_close(out.float(), int4_matmul_ref(x, p, s, z, 32).float(),
                               **TOL[torch.bfloat16])
    with pytest.raises(ValueError, match="route"):
        int4_matmul_hopper(shifted, p, s, z, 32, force_route="stream")
    with pytest.raises(ValueError, match="route"):
        int4_matmul_hopper(x32, p, s, z, 32, force_route="tc")


@pytest.mark.parametrize("B,T,H,P,N,G,chunk,with_init", [
    (4, 512, 112, 64, 64, 1, 128, False),  # zamba2-7b's prefill
    (4, 512, 24, 64, 128, 1, 128, True),  # mamba2-130m's, with a carried-in state
    (2, 300, 16, 64, 64, 2, 128, True),  # T tail, two groups
    (2, 260, 8, 64, 128, 4, 128, False),  # T tail, four groups
    (1, 20, 4, 64, 64, 1, 128, True),  # T below the chunk (and below 32)
    (2, 70, 8, 32, 16, 1, 32, True),  # smoke shapes, ragged T
    (2, 200, 8, 64, 64, 1, 64, False),  # a smaller chunk
])
def test_ssd_tensor_core_route_matches_plain(cuda, B, T, H, P, N, G, chunk, with_init):
    """bf16 takes the chunk-parallel tensor-core route: y within the bf16
    tolerance of the sequential recurrence, the final state within the
    fp32 one; repeated runs give equal bits; the forced CUDA-core route
    agrees too; one op launch per call."""
    x, dt, A, Bm, Cm, init, D = _ssd_inputs(B, T, H, P, N, G, with_init,
                                            torch.bfloat16, cuda)
    n0 = dispatch.LAUNCHES["ssd_scan"]
    t0 = dispatch.ROUTE_LAUNCHES["ssd_scan"].get("tc", 0)
    y, fin = ssd(x, dt, A, Bm, Cm, init=init, D=D, chunk=chunk)
    y2, fin2 = ssd(x, dt, A, Bm, Cm, init=init, D=D, chunk=chunk)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["ssd_scan"] == n0 + 2
    assert dispatch.ROUTE_LAUNCHES["ssd_scan"]["tc"] == t0 + 2
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    yr, fr = ssd_scan_ref(x, dt, A, Bm, Cm, init, D=D)
    torch.testing.assert_close(y.float(), yr.float(), **TOL_SSD[torch.bfloat16])
    torch.testing.assert_close(fin, fr, **TOL_SSD[torch.float32])
    assert torch.equal(y, y2) and torch.equal(fin, fin2)
    yf, ff = ssd_hopper(x, dt, A, Bm, Cm, init, D=D, chunk=chunk, force_route="fma")
    torch.testing.assert_close(yf.float(), yr.float(), **TOL_SSD[torch.bfloat16])
    torch.testing.assert_close(ff, fr, **TOL_SSD[torch.float32])


def test_ssd_cuda_core_route_takes_the_rest(cuda):
    """fp32 and misaligned bf16 stay on the CUDA-core kernel; forcing the
    tensor-core route on them raises."""
    x, dt, A, Bm, Cm, init, D = _ssd_inputs(1, 40, 4, 64, 64, 1, True, torch.float32, cuda)
    fma0 = dispatch.ROUTE_LAUNCHES["ssd_scan"].get("fma", 0)
    ssd(x, dt, A, Bm, Cm, init=init, D=D)
    xb, Bb, Cb = x.bfloat16(), Bm.bfloat16(), Cm.bfloat16()
    flat = torch.empty(xb.numel() + 8, dtype=xb.dtype, device=cuda)
    shifted = flat[1:1 + xb.numel()].view(xb.shape)  # 2 bytes past a 16-byte boundary
    shifted.copy_(xb)
    y, _ = ssd(shifted, dt, A, Bb, Cb, init=init, D=D)
    torch.cuda.synchronize()
    assert dispatch.ROUTE_LAUNCHES["ssd_scan"]["fma"] == fma0 + 2
    yr, _ = ssd_scan_ref(xb, dt, A, Bb, Cb, init, D=D)
    torch.testing.assert_close(y.float(), yr.float(), **TOL_SSD[torch.bfloat16])
    with pytest.raises(ValueError, match="route"):
        ssd_hopper(x, dt, A, Bm, Cm, init, D=D, force_route="tc")
    with pytest.raises(ValueError, match="route"):
        ssd_hopper(shifted, dt, A, Bb, Cb, init, D=D, force_route="tc")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [4, 13, 100, 128])
def test_expert_ffn_kernel_matches_plain_at_olmoe_width(cuda, dtype, M):
    """The full-model MoE layer's expert FFN at OLMoE's widths (E = 64,
    d 2048, d_ff 1024), on a real dispatch: M tokens routed top-8 with
    zero_drop (cap = M: the decode pool's 4 rows, the prefill's 128, and
    two counts that are no multiple of 16), ``group_sizes`` from the
    dispatch. Three gmm launches on the bf16 route the shape picks."""
    from repro_torch.configs.base import MoESpec
    from repro_torch.models import moe
    from repro_torch.models.runtime import Runtime

    spec = MoESpec(num_experts=64, top_k=8, d_ff=1024)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {n: (torch.randn(64, i, o, generator=gen, device=cuda) * i**-0.5).to(dtype)
              for n, (i, o) in (("wg", (2048, 1024)), ("wu", (2048, 1024)),
                                ("wd", (1024, 2048)))}
    x = torch.randn(M, 2048, generator=gen, device=cuda).to(dtype)
    gates, eids = moe.top_k_route(torch.softmax(torch.randn(M, 64, generator=gen,
                                                            device=cuda), -1), 8)
    d = moe.make_dispatch(gates, eids, spec, M)
    sizes = moe.group_sizes(d, 64)
    assert int(sizes.sum()) == 8 * M
    buf = moe.dispatch_tokens(d, x, 64)
    before = dispatch.route_snapshot()
    out = moe.expert_ffn(params, buf, Runtime(device=cuda), sizes=sizes)
    routes = dispatch.route_delta(before, dispatch.route_snapshot())["moe_gmm"]
    want = "fma" if dtype == torch.float32 else ("stream" if M <= 16 else "tc")
    assert routes == {want: 3}, routes
    ref = moe.expert_ffn(params, buf, Runtime(kernel_backend="ref", device=cuda))
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    past = torch.arange(M, device=cuda)[None, :] >= sizes[:, None]
    assert not out[past].any()
    torch.testing.assert_close(moe.combine_tokens(d, out).float(),
                               moe.combine_tokens(d, ref).float(), **TOL[dtype])


def test_continuous_server_on_the_card_matches_the_cpu(cuda):
    """The continuous-batching server on olmoe-mini in fp32 (2 slots, 5
    requests of mixed budgets): the same tokens and finish reasons on the
    card (moe_gmm and flash_attn kernels) as on the CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import ContinuousBatchingServer, RequestQueue, ServeRequest

    cfg = get_config("olmoe-mini")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    on_card = _tree_to(params, cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (20, 12, 17, 9, 20)]
    budgets = (6, 3, 8, 5, 4)

    def serve(p):
        reqs = [ServeRequest(rid=i, prompt=q, max_new_tokens=m)
                for i, (q, m) in enumerate(zip(prompts, budgets))]
        srv = ContinuousBatchingServer(cfg, p, n_slots=2, max_len=32)
        dispatch.reset_launches()  # after the constructor's warm-up
        return srv.run(RequestQueue(reqs))

    cpu, _ = serve(params)
    card, mt = serve(on_card)
    # one flash per layer per prefill; three gmm per layer per prefill and step
    assert dispatch.LAUNCHES["flash_attn"] == 8 * 5
    assert dispatch.LAUNCHES["moe_gmm"] == 3 * 8 * (5 + mt.decode_steps)
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.finish_reason == b.finish_reason
    assert mt.generated_tokens == sum(budgets)


def _lora_nonzero(cfg, seed):
    """The port's LoRA init with ``b`` drawn N(0, 1/r), so the term acts."""
    from repro_torch.core.lora import init_lora

    g = torch.Generator().manual_seed(seed)
    lora = init_lora(cfg, cfg.melinoe, generator=g)
    for gt in lora.values():
        for pt in gt.values():
            for ab in pt.values():
                ab["b"] = torch.randn(ab["b"].shape, generator=g) * cfg.melinoe.lora_rank**-0.5
    return lora


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_engine_lora_term_on_the_card_matches_the_cpu(cuda, dtype):
    """The offload engine with LoRA on olmoe-mini-smoke (C = 2 of 4
    experts: slab and overflow groups, batch 2 and batch 1): the card's
    prefill logits against the CPU's plain run on the same weights, 1e-4
    in fp32 (tokens equal) and 2e-2 relative in bf16 (both bf16: only the
    order of sums differs); the term moves them."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import lora_scale
    from repro_torch.core.offload_engine import OffloadedMoEEngine
    from repro_torch.models.model import init_params

    cfg = get_config("olmoe-mini-smoke")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    lora = _lora_nonzero(cfg, 1)
    sc = lora_scale(cfg.melinoe)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))

    def gen(device, p, l, B):
        eng = OffloadedMoEEngine(cfg, p, capacity=2, policy="gamma", lora=l, lora_scale=sc,
                                 device=device)
        return eng.generate(toks[:B], max_new_tokens=6)

    for B in (2, 1):
        cpu = gen("cpu", _tree_cast(params, "cpu", dtype), _tree_cast(lora, "cpu", dtype), B)
        card = gen(cuda, _tree_cast(params, cuda, dtype), _tree_cast(lora, cuda, dtype), B)
        ref, got = cpu["prefill_logits"].float(), card["prefill_logits"].float().cpu()
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
            np.testing.assert_array_equal(card["tokens"].cpu().numpy(), cpu["tokens"].numpy())
        else:
            assert ((got - ref).norm() / ref.norm()).item() < 2e-2
        plain = gen("cpu", _tree_cast(params, "cpu", dtype), None, B)["prefill_logits"]
        assert ((plain.float() - ref).norm() / ref.norm()).item() > 0.1


def test_wave_server_on_the_card_tokens_equal_across_policies(cuda):
    """The offloaded wave server on olmoe-mini in fp32 with LoRA (C = 8,
    waves of 3, oracle scores): fcfs and expert-affinity give each request
    the same tokens, which are the CPU's; the card launches one flash per
    layer per prefill and three gmm per layer per step, plus three per
    overflowing layer."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import lora_scale
    from repro_torch.models.model import init_params
    from repro_torch.serving import (OffloadedWaveServer, RequestQueue, ServeRequest,
                                     get_scheduler, prefill_expert_scores)

    cfg = get_config("olmoe-mini")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    lora = _lora_nonzero(cfg, 2)
    sc = lora_scale(cfg.melinoe)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 16).astype(np.int32) for _ in range(6)]
    budgets = (5, 3, 6, 4, 2, 5)
    reqs0 = [ServeRequest(rid=i, prompt=q, max_new_tokens=1) for i, q in enumerate(prompts)]
    scores = prefill_expert_scores(cfg, params, reqs0, lora=lora, lora_scale=sc)

    def serve(device, p, l, policy):
        reqs = [ServeRequest(rid=i, prompt=q, max_new_tokens=m, expert_scores=s)
                for i, (q, m, s) in enumerate(zip(prompts, budgets, scores))]
        sched = (get_scheduler(policy) if policy == "fcfs"
                 else get_scheduler(policy, top_c=8))
        srv = OffloadedWaveServer(cfg, p, capacity=8, policy="gamma", scheduler=sched,
                                  wave_size=3, lora=l, lora_scale=sc, device=device)
        dispatch.reset_launches()
        res, mt = srv.run(RequestQueue(reqs))
        return [r.tokens.tolist() for r in res], mt, dict(dispatch.LAUNCHES)

    p_card, l_card = _tree_to(params, cuda), _tree_to(lora, cuda)
    out = {pol: serve(cuda, p_card, l_card, pol) for pol in ("fcfs", "expert-affinity")}
    assert out["fcfs"][0] == out["expert-affinity"][0]
    assert out["fcfs"][0] == serve("cpu", params, lora, "fcfs")[0]
    for toks, mt, launches in out.values():
        assert launches["flash_attn"] == 8 * 6
        steps = mt.generated_tokens - 6
        assert launches["moe_gmm"] >= 3 * 8 * (6 + steps) and launches["moe_gmm"] % 3 == 0
        assert mt.prefetch_transfers > 0


def _tree_cast(tree, device, dtype):
    """fp32 leaves to ``dtype`` except the router (fp32, as the init keeps it)."""
    if isinstance(tree, dict):
        return {k: (v.to(device) if k == "router" else _tree_cast(v, device, dtype))
                for k, v in tree.items()}
    return tree.to(device, dtype)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,K,N", [
    (8, 160, 2048, 1024),  # the fine-tune's wg/wu product (cap 160 at B 8 x T 128)
    (8, 160, 1024, 2048),  # its wd product
    (4, 37, 256, 128),  # a capacity that is not a multiple of 8: dB leaves "tc"
])
def test_gmm_backward_matches_plain_autograd(cuda, dtype, E, M, K, N):
    """``GmmFn``'s dA and dB against ``gmm_ref`` under autograd on the same
    ragged inputs and upstream gradient (zero past each group's count, as
    the dispatch gives it); one dA and one dB launch, each counted."""
    sizes = [M, 0, M // 3, 1] + [M // 2] * (E - 4)
    a, b = _ragged(E, M, K, N, sizes, dtype, cuda)
    rng = np.random.default_rng(1)
    dy = torch.from_numpy(rng.standard_normal((E, M, N)).astype(np.float32))
    dy = (dy * (torch.arange(M)[None, :, None] < torch.tensor(sizes)[:, None, None])
          ).to(cuda, dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    grads = []
    for backend in ("hopper", "ref"):
        aa, bb = a.clone().requires_grad_(), b.clone().requires_grad_()
        dispatch.reset_launches()
        y = gmm(aa, bb, gs, backend=backend)
        y.backward(dy)
        grads.append((y.detach(), aa.grad, bb.grad, dict(dispatch.GRAD_LAUNCHES["moe_gmm"]),
                      dict(dispatch.ROUTE_LAUNCHES["moe_gmm"])))
    (y, da, db, by_product, routes), (yr, dar, dbr, none, _) = grads
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), yr.float(), **tol)
    torch.testing.assert_close(da.float(), dar.float(), **tol)
    # dB sums over the M rows: bf16 rounds its output once, as gmm_ref does
    torch.testing.assert_close(db.float(), dbr.float(), **tol)
    assert by_product == {"dA": 1, "dB": 1} and not none
    fast = dtype == torch.bfloat16 and M % 8 == 0
    assert sum(routes.values()) == 3 and (set(routes) == {"tc"} if fast else "fma" in routes)
    # only the gradient that is asked for is launched
    dispatch.reset_launches()
    gmm(a, b.clone().requires_grad_(), gs).sum().backward()
    assert dispatch.GRAD_LAUNCHES["moe_gmm"] == {"dB": 1}


def test_kernels_without_a_backward_refuse_grad(cuda):
    """Under grad, a kernel wrapper either has a backward (``moe_gmm``,
    through ``gmm``) or raises: ``flash_attn``, ``ssd_scan`` and
    ``int4_matmul`` have none, and ``gmm_hopper`` called directly has
    none either. Without grad they run."""
    q = torch.randn(1, 16, 2, 1, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 16, 2, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        flash(q, k, k)
    with torch.no_grad():
        assert flash(q, k, k).shape == q.shape
    x = torch.randn(1, 16, 2, 8, device=cuda, requires_grad=True)
    dt = torch.full((1, 16, 2), 0.01, device=cuda)
    A, Bm = -torch.ones(2, device=cuda), torch.randn(1, 16, 8, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd(x, dt, A, Bm, Bm)
    w = torch.randn(64, 32, device=cuda) * 0.1
    packed, scale, zero, _ = quantize_matmul_weight(w, 32)
    xi = torch.randn(4, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        int4_matmul(xi, packed, scale, zero, group=32)
    a = torch.randn(2, 4, 64, device=cuda, requires_grad=True)
    b = torch.randn(2, 64, 32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        gmm_hopper(a, b)
    assert gmm(a, b).grad_fn is not None  # through GmmFn


def test_finetune_step_through_kernels_matches_plain(cuda):
    """One MELINOE fine-tune step's loss and gradients on olmoe-mini in
    fp32 (router, expert wg, LoRA a and b): moe_gmm forward and backward
    on the card (the trainer's spec, flash_attn plain) against every op
    plain, ||delta|| / ||ref|| <= 1e-4 per leaf; 3 forward gmm per MoE
    layer, and backward dB 3 per layer, dA 3 per layer but 1 in the
    first (its dispatch buffer needs no gradient: embedding and attention
    are frozen)."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import extract_base_routers, melinoe_trainable_mask
    from repro_torch.data.synthetic import ClusterLM, SyntheticConfig
    from repro_torch.launch.steps import build_finetune_step
    from repro_torch.models.model import init_params
    from repro_torch.models.runtime import Runtime
    from repro_torch.training import TRAIN_KERNEL_BACKEND, OptConfig

    cfg = get_config("olmoe-mini")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    params = _tree_to(params, cuda)
    lora = _tree_to(_lora_nonzero(cfg, 2), cuda)
    mask = melinoe_trainable_mask(params)
    base = extract_base_routers(params, cfg)
    batch = next(ClusterLM(SyntheticConfig(vocab=cfg.vocab, seq_len=32, seed=0)).batches(4))
    out = {}
    for spec in (TRAIN_KERNEL_BACKEND, "ref"):
        step = build_finetune_step(cfg, Runtime(kernel_backend=spec, device=cuda),
                                   OptConfig(), mask)
        dispatch.reset_launches()
        loss, _, grads = step.loss_and_grads(params, lora, batch, base)
        out[spec] = (loss.item(), grads, dict(dispatch.LAUNCHES),
                     dict(dispatch.GRAD_LAUNCHES["moe_gmm"]))
    (loss, grads, launches, by_product), (loss_r, grads_r, launches_r, _) = out.values()
    L = cfg.n_moe_layers
    assert launches["moe_gmm"] == 3 * L + 6 * L - 2 and launches["flash_attn"] == 0
    assert by_product == {"dA": 3 * L - 2, "dB": 3 * L}
    assert not any(launches_r.values())
    assert abs(loss - loss_r) <= 1e-5 * abs(loss_r)

    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif t is not None:
            yield torch.stack(t) if isinstance(t, list) else t

    n = 0
    for g, r in zip(leaves(dict(enumerate(grads))), leaves(dict(enumerate(grads_r)))):
        assert ((g - r).norm() / r.norm()).item() <= 1e-4
        n += 1
    assert n == 2 + 4  # router and wg of the one stacked group, LoRA a/b of wu and wd
