"""Route choice and launch bookkeeping of ``int4_matmul`` and ``ssd_scan``,
on the CPU: which Hopper kernel a call goes to is a plain Python function
of shape, dtype, group and pointers (``ops.route``), and what a wrapper
counts and allocates for it is plain Python too. Here the kernel library
is replaced by a recorder, so no card is needed; the kernels themselves
are held against their plain versions in ``tests/test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, dispatch  # noqa: E402
from repro_torch.kernels.int4_matmul import ops as int4_ops  # noqa: E402
from repro_torch.kernels.int4_matmul import quantize_matmul_weight  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.torch

BF16, F32 = torch.bfloat16, torch.float32
ALIGNED = (0x7F0000000000, 0x7F0000100000, 0x7F0000200000, 0x7F0000300000)


@pytest.mark.parametrize("M,K,N,group,want", [
    (4, 2048, 1024, 32, "stream"),  # olmoe INT4 spillover, decode: gate/up
    (4, 1024, 2048, 32, "stream"),  # decode: down
    (1, 2048, 1024, 64, "stream"),
    (16, 2048, 1024, 32, "stream"),  # the last row count of the decode route
    (17, 2048, 1024, 32, "tc"),
    (512, 2048, 1024, 32, "tc"),  # prefill: gate/up
    (512, 1024, 2048, 32, "tc"),  # prefill: down
    (100, 2048, 1000, 64, "tc"),  # N a multiple of 8, not of a tile
    (7, 384, 1000, 128, "stream"),
])
def test_int4_bf16_takes_the_fast_routes(M, K, N, group, want):
    assert int4_ops.route(M, K, N, group, BF16, ALIGNED) == want


@pytest.mark.parametrize("M,K,N,group,dtype,ptrs", [
    (4, 2048, 1024, 32, F32, ALIGNED),  # fp32: the CUDA-core kernel
    (512, 2048, 1024, 32, F32, ALIGNED),
    (5, 192, 50, 64, BF16, ALIGNED),  # N % 8
    (4, 2048, 1020, 32, BF16, ALIGNED),
    (3, 96, 40, 2, BF16, ALIGNED),  # group below one 32-row K step
    (4, 2048, 1024, 16, BF16, ALIGNED),
    (4, 2048, 1024, 48, BF16, ALIGNED),  # not a whole number of steps
    (4, 2048, 1024, 256, BF16, ALIGNED),  # above the largest group
    (4, 2048, 1024, 32, BF16, (ALIGNED[0] + 2,) + ALIGNED[1:]),  # misaligned x
    (512, 2048, 1024, 32, BF16, ALIGNED[:1] + (ALIGNED[1] + 8,) + ALIGNED[2:]),  # codes
    (4, 2048, 1024, 32, BF16, ALIGNED[:2] + (ALIGNED[2] + 4,) + ALIGNED[3:]),  # scale
])
def test_int4_rest_takes_the_cuda_core_kernel(M, K, N, group, dtype, ptrs):
    assert int4_ops.route(M, K, N, group, dtype, ptrs) == "fma"


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_int4_route_rejects_unknown_dtypes(dtype):
    with pytest.raises(TypeError):
        int4_ops.route(4, 64, 64, 32, dtype, ALIGNED)


@pytest.mark.parametrize("M,N,group,dtype,force,ok", [
    (512, 1024, 32, BF16, "fma", True),  # the CUDA-core kernel takes anything
    (4, 1024, 32, F32, "fma", True),
    (4, 1024, 32, BF16, "tc", True),  # tiles take any M
    (512, 1024, 32, BF16, "stream", False),  # past the decode rows
    (4, 1024, 32, F32, "stream", False),
    (512, 1024, 32, F32, "tc", False),
    (4, 1020, 32, BF16, "stream", False),
    (512, 1024, 2, BF16, "tc", False),
    (4, 1024, 32, BF16, "wgmma", False),  # no such route
])
def test_int4_forced_route(M, N, group, dtype, force, ok):
    if ok:
        assert int4_ops.route(M, 2048, N, group, dtype, ALIGNED, force) == force
    else:
        with pytest.raises(ValueError, match="route"):
            int4_ops.route(M, 2048, N, group, dtype, ALIGNED, force)


def test_ssd_bf16_takes_tensor_cores():
    assert ssd_ops.route(BF16, ALIGNED) == "tc"


@pytest.mark.parametrize("dtype,ptrs", [
    (F32, ALIGNED),  # fp32: TF32 would break its tolerance
    (BF16, (ALIGNED[0] + 2,) + ALIGNED[1:]),  # misaligned x
    (BF16, ALIGNED[:3] + (ALIGNED[3] + 8,)),  # misaligned Cm
])
def test_ssd_rest_takes_the_cuda_core_kernel(dtype, ptrs):
    assert ssd_ops.route(dtype, ptrs) == "fma"


@pytest.mark.parametrize("dtype,ptrs,force,ok", [
    (BF16, ALIGNED, "fma", True),
    (F32, ALIGNED, "fma", True),
    (BF16, ALIGNED, "tc", True),
    (F32, ALIGNED, "tc", False),
    (BF16, (ALIGNED[0] + 2,) + ALIGNED[1:], "tc", False),
    (BF16, ALIGNED, "stream", False),  # no such route for ssd
])
def test_ssd_forced_route(dtype, ptrs, force, ok):
    if ok:
        assert ssd_ops.route(dtype, ptrs, force) == force
    else:
        with pytest.raises(ValueError, match="route"):
            ssd_ops.route(dtype, ptrs, force)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_ssd_route_rejects_unknown_dtypes(dtype):
    with pytest.raises(TypeError):
        ssd_ops.route(dtype, ALIGNED)


class _Library:
    """Stands in for the kernel library: records each C call and returns 0
    (a launch's cudaError_t), or the split sizes it is given."""

    SIZES = {"int4_stream_split_groups": 4, "int4_tc_splits": 2}

    def __init__(self):
        self.calls = []

    def entry(self, name, argtypes):
        def fn(*args):
            assert len(args) == len(argtypes), (name, args)
            self.calls.append((name, args))
            return self.SIZES.get(name, 0)
        return fn


def _launches(lib):
    return [c for c in lib.calls if c[0] not in _Library.SIZES]


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors pass the wrappers' device check and every launch goes to
    a recorder instead of the card."""
    lib = _Library()
    monkeypatch.setattr(_build, "entry", lib.entry)
    monkeypatch.setattr(dispatch, "on_one_cuda_device", lambda *ts: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    dispatch.reset_launches()
    yield lib
    dispatch.reset_launches()


def _ssd_inputs(B, T, H, P, N, G, dtype, with_init):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, T, H, P, generator=g).to(dtype)
    dt = torch.rand(B, T, H, generator=g) * 0.02
    A = -torch.linspace(1.0, 16.0, H)
    Bm = torch.randn(B, T, G, N, generator=g).to(dtype)
    Cm = torch.randn(B, T, G, N, generator=g).to(dtype)
    init = torch.randn(B, H, P, N, generator=g) if with_init else None
    return x, dt, A, Bm, Cm, init


@pytest.mark.parametrize("T,chunk", [(512, 128), (300, 128), (20, 128), (70, 32)])
def test_ssd_call_counts_one_op_launch(fake_card, T, chunk):
    """The "tc" route starts two kernels in one C call: the op counts one
    launch, under its route, and the wrapper passes the per-chunk state
    workspace (B, nc, H, P, N), the decays (B, nc, H) and a zeroed (B, H)
    arrival count for it."""
    B, H, P, N = 2, 8, 64, 64
    x, dt, A, Bm, Cm, init = _ssd_inputs(B, T, H, P, N, 1, BF16, True)
    y, fin = ssd_ops.ssd_hopper(x, dt, A, Bm, Cm, init, chunk=chunk)
    assert dispatch.LAUNCHES["ssd_scan"] == 1
    assert dispatch.ROUTE_LAUNCHES["ssd_scan"] == {"tc": 1}
    ((name, args),) = fake_card.calls
    assert name == "ssd_scan_bf16_tc"
    assert all(isinstance(a, int) for a in args[9:12])  # st, dec, arrived
    assert args[12:19] == (B, T, H, 1, P, N, min(chunk, T))
    assert y.shape == x.shape and y.dtype == BF16 and fin.shape == (B, H, P, N)
    ssd_ops.ssd_hopper(x.float(), dt, A, Bm.float(), Cm.float(), init, chunk=chunk)
    assert dispatch.LAUNCHES["ssd_scan"] == 2
    assert dispatch.ROUTE_LAUNCHES["ssd_scan"] == {"tc": 1, "fma": 1}
    assert fake_card.calls[-1][0] == "ssd_scan_f32"


def test_ssd_forced_fma_counts_under_fma(fake_card):
    x, dt, A, Bm, Cm, _ = _ssd_inputs(1, 64, 4, 32, 16, 2, BF16, False)
    ssd_ops.ssd_hopper(x, dt, A, Bm, Cm, chunk=32, force_route="fma")
    assert dispatch.ROUTE_LAUNCHES["ssd_scan"] == {"fma": 1}
    assert fake_card.calls[-1][0] == "ssd_scan_bf16"
    with pytest.raises(ValueError, match="route"):
        ssd_ops.ssd_hopper(x.float(), dt, A, Bm.float(), Cm.float(), chunk=32,
                           force_route="tc")
    assert dispatch.LAUNCHES["ssd_scan"] == 1


@pytest.mark.parametrize("M,want", [(4, "stream"), (16, "stream"), (17, "tc"),
                                    (512, "tc")])
def test_int4_call_counts_one_op_launch(fake_card, M, want):
    """One call, one op launch under its route; both fast routes get an
    fp32 workspace of (splits, M, N) for their ordered split reduction."""
    K, N, group = 2048, 1024, 32
    x = torch.randn(M, K).to(BF16)
    p, s, z, _ = quantize_matmul_weight(torch.randn(K, N) * 0.05, group)
    out = int4_ops.int4_matmul_hopper(x, p, s, z, group)
    assert out.shape == (M, N) and out.dtype == BF16
    assert dispatch.LAUNCHES["int4_matmul"] == 1
    assert dispatch.ROUTE_LAUNCHES["int4_matmul"] == {want: 1}
    ((name, args),) = _launches(fake_card)
    assert name == f"int4_matmul_bf16_{want}"
    assert args[5] is not None and args[6:10] == (M, K, N, group)
    # 2048 rows in splits of 4 groups of 32: 16 splits; "tc" as the library says
    assert int4_ops.splits(want, M, K, N, group) == (16 if want == "stream" else 2)


def test_int4_fp32_and_forced_fma_count_under_fma(fake_card):
    K, N, group = 256, 64, 32
    p, s, z, _ = quantize_matmul_weight(torch.randn(K, N) * 0.05, group)
    int4_ops.int4_matmul_hopper(torch.randn(4, K), p, s, z, group)
    int4_ops.int4_matmul_hopper(torch.randn(4, K).to(BF16), p, s, z, group,
                                force_route="fma")
    assert dispatch.ROUTE_LAUNCHES["int4_matmul"] == {"fma": 2}
    assert [c[0] for c in fake_card.calls] == ["int4_matmul_f32", "int4_matmul_bf16"]
    with pytest.raises(ValueError, match="route"):
        int4_ops.int4_matmul_hopper(torch.randn(32, K).to(BF16), p, s, z, group,
                                    force_route="stream")
    assert dispatch.LAUNCHES["int4_matmul"] == 2


def test_int4_one_split_needs_no_workspace(fake_card):
    """A K of one split (here 4 groups of 32) passes no workspace: the
    stream kernel writes the output itself."""
    K, N, group = 128, 64, 32
    p, s, z, _ = quantize_matmul_weight(torch.randn(K, N) * 0.05, group)
    int4_ops.int4_matmul_hopper(torch.randn(4, K).to(BF16), p, s, z, group)
    (name, args), = _launches(fake_card)
    assert name == "int4_matmul_bf16_stream" and args[5] is None
