"""Route choice of the port's two-kernel ops, on the CPU: which Hopper
kernel ``moe_gmm`` and ``flash_attn`` send a call to is a plain Python
function of shape, dtype and pointers (``ops.route``), tested here
without a card. The kernels themselves are held against their plain
versions in ``tests/test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

BF16, F32 = torch.bfloat16, torch.float32
ALIGNED = (0x7F0000000000, 0x7F0000100000)


@pytest.mark.parametrize("M,K,N,want", [
    (4, 2048, 1024, "stream"),  # olmoe decode: gate/up, slab and overflow groups
    (4, 1024, 2048, "stream"),  # olmoe decode: down
    (1, 2048, 1024, "stream"),
    (16, 2048, 1024, "stream"),  # the last row count of the decode route
    (17, 2048, 1024, "tc"),
    (512, 2048, 1024, "tc"),  # olmoe prefill: gate/up
    (512, 1024, 2048, "tc"),  # olmoe prefill: down
    (100, 1032, 520, "tc"),  # aligned widths that are not tile multiples
])
def test_gmm_main_path_bf16_takes_tensor_cores(M, K, N, want):
    assert gmm_ops.route(M, K, N, BF16, ALIGNED) == want


@pytest.mark.parametrize("M,K,N,dtype,ptrs", [
    (4, 2048, 1024, F32, ALIGNED),  # fp32: TF32 would break its tolerance
    (512, 2048, 1024, F32, ALIGNED),
    (100, 70, 50, BF16, ALIGNED),  # rows not 16-byte multiples
    (4, 2048, 1020, BF16, ALIGNED),  # N % 8
    (512, 2044, 1024, BF16, ALIGNED),  # K % 8
    (4, 2048, 1024, BF16, (ALIGNED[0] + 2, ALIGNED[1])),  # misaligned a
    (512, 2048, 1024, BF16, (ALIGNED[0], ALIGNED[1] + 8)),  # misaligned b
])
def test_gmm_rest_takes_the_cuda_core_kernel(M, K, N, dtype, ptrs):
    assert gmm_ops.route(M, K, N, dtype, ptrs) == "fma"


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_gmm_route_rejects_unknown_dtypes(dtype):
    with pytest.raises(TypeError):
        gmm_ops.route(4, 64, 64, dtype, ALIGNED)


@pytest.mark.parametrize("hd", flash_ops.HEAD_DIMS)
def test_flash_bf16_takes_tensor_cores(hd):
    assert flash_ops.route(hd, BF16, ALIGNED + (ALIGNED[1] + 4096,)) == "tc"


@pytest.mark.parametrize("hd,dtype,ptrs", [
    (128, F32, ALIGNED),  # olmoe's head dim in fp32
    (112, F32, ALIGNED),  # zamba2's
    (128, BF16, (ALIGNED[0] + 2, ALIGNED[1])),  # misaligned q
    (112, BF16, (ALIGNED[0], ALIGNED[1] + 8)),  # misaligned k
])
def test_flash_rest_takes_the_cuda_core_kernel(hd, dtype, ptrs):
    assert flash_ops.route(hd, dtype, ptrs) == "fma"


@pytest.mark.parametrize("hd", [8, 48, 96, 80, 256])
def test_flash_route_rejects_unknown_head_dims(hd):
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.route(hd, BF16, ALIGNED)


@pytest.mark.parametrize("arch", list_archs())
def test_every_config_head_dim_takes_tensor_cores(arch):
    """Every attention head dim of every config, and of its smoke variant,
    is one that both flash kernels take, on tensor cores in bf16: a head
    dim outside HEAD_DIMS raises on the card."""
    for cfg in (get_config(arch), get_config(arch + "-smoke")):
        for b in cfg.block_defs.values():
            if b.attn is not None:
                assert b.attn.head_dim in flash_ops.HEAD_DIMS, (cfg.name, b.attn.head_dim)
                assert flash_ops.route(b.attn.head_dim, BF16) == "tc"


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_flash_route_rejects_unknown_dtypes(dtype):
    with pytest.raises(TypeError):
        flash_ops.route(128, dtype, ALIGNED)


def test_route_launch_counts_reset_with_the_op_counts():
    dispatch.reset_launches()
    dispatch.count_launch("moe_gmm", "stream")
    dispatch.count_launch("moe_gmm", "stream")
    dispatch.count_launch("moe_gmm", "tc")
    dispatch.count_launch("int4_matmul")
    assert dispatch.LAUNCHES["moe_gmm"] == 3 and dispatch.LAUNCHES["int4_matmul"] == 1
    assert dispatch.ROUTE_LAUNCHES["moe_gmm"] == {"stream": 2, "tc": 1}
    assert dispatch.ROUTE_LAUNCHES["int4_matmul"] == {}
    dispatch.reset_launches()
    assert not any(dispatch.LAUNCHES.values())
    assert not any(dispatch.ROUTE_LAUNCHES.values())


def test_cpu_tensors_never_count_a_route():
    dispatch.reset_launches()
    a = torch.randn(2, 4, 16).to(BF16)
    b = torch.randn(2, 16, 8).to(BF16)
    gmm_ops.gmm(a, b, torch.tensor([4, 2], dtype=torch.int32))
    q = torch.randn(1, 8, 2, 1, 16).to(BF16)
    kv = torch.randn(1, 8, 2, 16).to(BF16)
    flash_ops.flash(q, kv, kv)
    assert not any(dispatch.LAUNCHES.values())
    assert not any(dispatch.ROUTE_LAUNCHES.values())


@pytest.mark.parametrize("M,K,N,dtype,force,ok", [
    (512, 2048, 1024, BF16, "fma", True),  # the CUDA-core kernel takes anything
    (4, 2048, 1024, F32, "fma", True),
    (4, 2048, 1024, BF16, "tc", True),  # tiles take any M
    (512, 2048, 1024, BF16, "stream", False),  # past the decode rows
    (4, 2048, 1024, F32, "stream", False),
    (512, 2048, 1024, F32, "tc", False),
    (100, 70, 50, BF16, "tc", False),
    (4, 2048, 1024, BF16, "wgmma", False),  # no such route
])
def test_gmm_forced_route(M, K, N, dtype, force, ok):
    if ok:
        assert gmm_ops.route(M, K, N, dtype, ALIGNED, force) == force
    else:
        with pytest.raises(ValueError, match="route"):
            gmm_ops.route(M, K, N, dtype, ALIGNED, force)


@pytest.mark.parametrize("dtype,ptrs,force,ok", [
    (BF16, ALIGNED, "fma", True),
    (F32, ALIGNED, "fma", True),
    (BF16, ALIGNED, "tc", True),
    (F32, ALIGNED, "tc", False),
    (BF16, (ALIGNED[0] + 2, ALIGNED[1]), "tc", False),
    (BF16, ALIGNED, "wgmma", False),
])
def test_flash_forced_route(dtype, ptrs, force, ok):
    if ok:
        assert flash_ops.route(128, dtype, ptrs, force) == force
    else:
        with pytest.raises(ValueError, match="route"):
            flash_ops.route(128, dtype, ptrs, force)
