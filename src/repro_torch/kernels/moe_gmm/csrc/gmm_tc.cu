// Grouped (per-expert) matmul, bf16 on tensor cores, Hopper (sm_90a): the
// "tc" (prefill) and "stream" (decode) routes of ops.gmm.
//
// Replaces, for bf16, the Pallas TPU kernel src/repro/kernels/moe_gmm/
// kernel.py::gmm (dense _kernel and ragged _kernel_ragged); fp32 and
// unaligned widths stay on the CUDA-core kernel of gmm.cu. Same function:
// y[e] = a[e] @ b[e], fp32 accumulation, bf16 output; with group_sizes,
// rows at or past group_sizes[e] come out exactly zero, and a group or
// M-tile with no valid row returns before it reads one byte of b[e].
// Both routes take a (E, M, K), b (E, K, N), out (E, M, N) contiguous and
// 16-byte aligned, with K and N multiples of 8 (ops.route checks; the
// entry points refuse anything else), so every copy is a 16-byte cp.async
// that is either wholly inside or wholly past a tail and then zero-filled.
// Products are mma.sync.m16n8k16 (bf16 in, fp32 accumulation) on operands
// read with ldmatrix from shared-memory rows padded by 8 elements, an odd
// number of 16-byte units, so ldmatrix is free of bank conflicts.
//
// "stream", M <= 16 (every decode call of the offloaded serve): a weight
// stream. The bound is the bytes of b of the active groups (4 MB a group at
// olmoe widths, 3.35 TB/s); the FLOPs are nothing. A block of 8 warps owns
// (group, 64-column strip of N) and splits K among its warps, k-steps of 16
// rows dealt round-robin so the block reads 128 consecutive rows of b at a
// time; each warp streams its steps through its own 4-stage cp.async ring
// (a 16x16 slice of a beside each 16x64 slice of b; 6 KB in flight a warp,
// about 100 KB an SM at two blocks), waiting with __syncwarp only. At the
// decode shapes that is more than the memory needs: a 2-stage ring reads
// within 3% of it (tools/kernel_ab.py). The decode rows are padded to m16
// with zero-filled copies. The eight partial sums are reduced in shared
// memory in warp order, a fixed order, so repeated runs give equal bits
// (no atomics).
//
// "tc", M > 16 (the prefill calls): the FLOPs bound (2 M K N a group).
// Output tiles of 128 x 128 on 8 warps (each 64 x 32), K-steps of 64
// through a 3-stage cp.async ring (105 KB of shared memory, two blocks an
// SM), fp32 accumulators in registers, bf16 epilogue. M, N and K tails
// are zero-filled copies and masked stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- "tc": tensor-core tiles for prefill ----
constexpr int TBM = 128, TBN = 128, TBK = 64, TSTAGES = 3, TTHREADS = 256;
constexpr int TALD = TBK + 8;   // a tile row stride, elements
constexpr int TBLD = TBN + 8;   // b tile row stride
constexpr int TSTAGE = TBM * TALD + TBK * TBLD;  // elements per stage
constexpr int TSMEM = TSTAGES * TSTAGE * 2;

// ---- "stream": split-K weight stream for decode ----
constexpr int SBN = 64, SWARPS = 8, SSTAGES = 4, STHREADS = 32 * SWARPS;
constexpr int SALD = 16 + 8;    // a slice row stride
constexpr int SBLD = SBN + 8;   // b slice row stride
constexpr int SSTAGE = 16 * SALD + 16 * SBLD;  // elements per warp stage
constexpr int SSMEM = SWARPS * SSTAGES * SSTAGE * 2;
static_assert(SWARPS * 16 * SBN * 4 <= SSMEM, "the reduction reuses the rings");

__device__ __forceinline__ int valid_rows(const int* sizes, int e, int M) {
  return sizes != nullptr ? min(M, max(sizes[e], 0)) : M;
}

// out[e][m0:m1, n0:n1] = 0 (N a multiple of 8; n0, n1 too).
__device__ __forceinline__ void zero_tile(bf16* oe, int m0, int m1, int n0, int n1, int M,
                                          int N) {
  const int cw = (n1 - n0) / 8;
  for (int i = threadIdx.x; i < (m1 - m0) * cw; i += blockDim.x) {
    const int r = m0 + i / cw, c = n0 + (i % cw) * 8;
    if (r < M && c < N) *reinterpret_cast<uint4*>(oe + (size_t)r * N + c) = make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(TTHREADS)
gmm_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, bf16* __restrict__ out,
              const int* __restrict__ sizes, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.z, m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int rows = valid_rows(sizes, e, M);
  const bf16* ae = a + (size_t)e * M * K;
  const bf16* be = b + (size_t)e * K * N;
  bf16* oe = out + (size_t)e * M * N;
  if (m0 >= rows) {  // empty tile: zeros, and no byte of b[e] is read
    zero_tile(oe, m0, m0 + TBM, n0, n0 + TBN, M, N);
    return;
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  auto load = [&](int stage, int kt) {
    bf16* as = smem + stage * TSTAGE;
    bf16* bs = as + TBM * TALD;
    const int k0 = kt * TBK;
#pragma unroll
    for (int i = tid; i < TBM * (TBK / 8); i += TTHREADS) {
      const int rr = i / (TBK / 8), c = i % (TBK / 8);
      const int r = m0 + rr, kc = k0 + c * 8;
      const bool ok = r < rows && kc < K;
      tc::cp_async16(as + rr * TALD + c * 8, ae + (ok ? (size_t)r * K + kc : 0), ok);
    }
#pragma unroll
    for (int i = tid; i < TBK * (TBN / 8); i += TTHREADS) {
      const int kk = i / (TBN / 8), c = i % (TBN / 8);
      const int kr = k0 + kk, nc = n0 + c * 8;
      const bool ok = kr < K && nc < N;
      tc::cp_async16(bs + kk * TBLD + c * 8, be + (ok ? (size_t)kr * N + nc : 0), ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][j][u] = 0.f;

  const int nk = (K + TBK - 1) / TBK;
#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < nk) load(s, s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<TSTAGES - 2>();  // step kt has landed
    __syncthreads();                    // and step kt - 1 is consumed
    const int nxt = kt + TSTAGES - 1;
    if (nxt < nk) load(nxt % TSTAGES, nxt);
    tc::cp_async_commit();
    const bf16* as = smem + (kt % TSTAGES) * TSTAGE;
    const bf16* bs = as + TBM * TALD;
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        tc::ldsm_x4(af[mt], as + (wm + mt * 16 + lane % 16) * TALD + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        tc::ldsm_x4_t(r, bs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * TBLD + wn +
                             np * 16 + (lane / 16) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) tc::mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = m0 + wm + mt * 16 + lane / 4 + 8 * u;
      if (r >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = n0 + wn + nt * 8 + 2 * (lane % 4);
        if (c < N)
          *reinterpret_cast<__nv_bfloat162*>(oe + (size_t)r * N + c) =
              __floats2bfloat162_rn(acc[mt][nt][2 * u], acc[mt][nt][2 * u + 1]);
      }
    }
}

__global__ void __launch_bounds__(STHREADS)
gmm_stream_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                  bf16* __restrict__ out, const int* __restrict__ sizes, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int e = blockIdx.y, n0 = blockIdx.x * SBN;
  const int rows = valid_rows(sizes, e, M);
  const bf16* ae = a + (size_t)e * M * K;
  const bf16* be = b + (size_t)e * K * N;
  bf16* oe = out + (size_t)e * M * N;
  if (rows == 0) {  // empty group: zeros, and no byte of b[e] is read
    zero_tile(oe, 0, M, n0, n0 + SBN, M, N);
    return;
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* ring = smem + warp * SSTAGES * SSTAGE;
  const int nk16 = (K + 15) / 16;
  const int steps = nk16 > warp ? (nk16 - warp + SWARPS - 1) / SWARPS : 0;

  auto load = [&](int stage, int step) {
    bf16* as = ring + stage * SSTAGE;
    bf16* bs = as + 16 * SALD;
    const int k0 = (warp + step * SWARPS) * 16;
    {  // a: 16 rows x 2 chunks, one per lane; rows past the count are zeros
      const int rr = lane / 2, kc = k0 + (lane % 2) * 8;
      const bool ok = rr < rows && kc < K;
      tc::cp_async16(as + rr * SALD + (lane % 2) * 8, ae + (ok ? (size_t)rr * K + kc : 0), ok);
    }
#pragma unroll
    for (int i = lane; i < 16 * (SBN / 8); i += 32) {  // b: 16 rows x 8 chunks
      const int kk = i / (SBN / 8), c = i % (SBN / 8);
      const int kr = k0 + kk, nc = n0 + c * 8;
      const bool ok = kr < K && nc < N;
      tc::cp_async16(bs + kk * SBLD + c * 8, be + (ok ? (size_t)kr * N + nc : 0), ok);
    }
  };

  float acc[SBN / 8][4];
#pragma unroll
  for (int n = 0; n < SBN / 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[n][u] = 0.f;

#pragma unroll
  for (int s = 0; s < SSTAGES - 1; ++s) {
    if (s < steps) load(s, s);
    tc::cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    tc::cp_async_wait<SSTAGES - 2>();  // step i has landed (this lane's copies)
    __syncwarp();                       // every lane's, and step i - 1 is consumed
    const int nxt = i + SSTAGES - 1;
    if (nxt < steps) load(nxt % SSTAGES, nxt);
    tc::cp_async_commit();
    const bf16* as = ring + (i % SSTAGES) * SSTAGE;
    const bf16* bs = as + 16 * SALD;
    uint32_t af[4];
    tc::ldsm_x4(af, as + (lane % 16) * SALD + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < SBN / 16; ++np) {
      uint32_t r[4];
      tc::ldsm_x4_t(r, bs + (((lane / 8) % 2) * 8 + lane % 8) * SBLD + np * 16 + (lane / 16) * 8);
      tc::mma_bf16(acc[2 * np], af, r[0], r[1]);
      tc::mma_bf16(acc[2 * np + 1], af, r[2], r[3]);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // every ring is drained: reuse it for the reduction

  float* red = reinterpret_cast<float*>(smem_raw);  // [SWARPS][16][SBN]
#pragma unroll
  for (int n = 0; n < SBN / 8; ++n)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      red[(warp * 16 + lane / 4 + 8 * (u / 2)) * SBN + n * 8 + 2 * (lane % 4) + u % 2] =
          acc[n][u];
  __syncthreads();
  for (int i = tid; i < M * SBN; i += STHREADS) {
    const int r = i / SBN, col = i % SBN, c = n0 + col;
    if (c >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < SWARPS; ++w) s += red[(w * 16 + r) * SBN + col];  // fixed order
    oe[(size_t)r * N + c] = __float2bfloat16(s);
  }
}

bool takes(const void* a, const void* b, const void* out, int K, int N) {
  return K % 8 == 0 && N % 8 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
}

}  // namespace

// a (E, M, K), b (E, K, N), out (E, M, N): bf16, contiguous, 16-byte
// aligned, K and N multiples of 8; sizes (E,) int32 on the device or null
// (dense). Returns cudaGetLastError().
extern "C" int moe_gmm_bf16_tc(const void* a, const void* b, void* out, const int* sizes,
                               int E, int M, int K, int N, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  if (!takes(a, b, out, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;  // the attribute is set once
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(gmm_tc_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, TSMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, E);
  gmm_tc_kernel<<<grid, TTHREADS, TSMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(out), sizes,
      M, K, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int moe_gmm_bf16_stream(const void* a, const void* b, void* out, const int* sizes,
                                   int E, int M, int K, int N, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  if (M > 16 || !takes(a, b, out, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready = false;  // the attribute is set once
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(gmm_stream_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SSMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  dim3 grid((N + SBN - 1) / SBN, E);
  gmm_stream_kernel<<<grid, STHREADS, SSMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(out), sizes,
      M, K, N);
  return static_cast<int>(cudaGetLastError());
}
