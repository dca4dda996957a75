// Fused INT4-dequant matmul y = x @ ((q - zero) * scale) for bf16 x, Hopper
// (sm_90a): the "stream" (decode) and "tc" (prefill) routes of ops.int4_matmul.
//
// Replaces, for bf16 x, the Pallas TPU kernel src/repro/kernels/int4_matmul/
// kernel.py::int4_matmul; fp32 x, odd widths and small groups stay on the
// CUDA-core kernel of int4_matmul.cu. Same storage: packed (K/2, N) uint8
// with the low nibble the even K row, scale/zero (K/group, N) fp32; fp32
// accumulation, bf16 output. Both routes take x (M, K) bf16, out (M, N)
// bf16, N a multiple of 8, group a multiple of 32 up to 128 and K a multiple
// of group, every pointer 16-byte aligned (ops.route checks; the entry
// points refuse anything else). So every copy is a cp.async of 16 bytes
// (x, scale, zero) or 8 bytes (8 columns of packed codes) that lies wholly
// inside the matrix or wholly past its N or M edge, where it is zero-filled
// (code 0, scale 0, zero 0: a weight of 0). A 32-row K step lies inside one
// quantization group.
//
// "stream", M <= 16 (the decode calls of the INT4 spillover: x(4, 2048) .
// w(2048, 1024) and x(4, 1024) . w(1024, 2048)): a pure weight stream, bound
// by the bytes of the codes, scale and zero (0.75 K N bytes at group 32,
// 1.57 MB at olmoe widths: 0.47 us at 3.35 TB/s). The old kernel walked all
// of K in each of N/32 blocks (32 on 132 SMs). Here K is split across blocks
// too: a block owns 64 columns and a split of whole groups, chosen so that
// the grid has about two blocks per SM (16 x 16 = 256 blocks at 2048 x 1024,
// 32 x 8 at 1024 x 2048). The block copies its split's x rows once, then
// streams 32-row steps of codes and the step's scale/zero row through a
// 4-stage cp.async ring. Each thread dequantizes one packed row of 4 columns
// a step in registers ((q - zero) * scale in fp32, as the plain version) and
// accumulates every x row in fp32 on CUDA cores: at M <= 16 compute is not
// the limit and the sum takes no rounding the plain version does not. The
// block's partial sums meet in shared memory in warp order, and the splits
// in a second small launch in split order through an fp32 workspace, so
// repeated runs give equal bits (no atomics) and the route runs inside a
// CUDA graph.
//
// "tc", M > 16 (the prefill calls, x(512, K)): bound by the 2 M K N
// operations. Output tiles of 64 x 64 on 8 warps (each 16 x 32),
// mma.sync.m16n8k16 with fp32 accumulation, A (x) and B by ldmatrix. A
// stage holds two 32-row K steps of x, codes and a scale/zero row per step
// (4-slot cp.async ring); one iteration ahead of its use, the block turns a
// stage's codes into a bf16 B tile in shared memory, each code once. By
// default (EXACT) the tile holds the codes themselves, which bf16 holds
// exactly, so the MMAs over a step give sum x q in fp32, and the step's
// epilogue applies the group's affine to the fp32 fragments: acc += scale
// (sum x q - zero sum x), sum x from one more MMA against ones. This keeps
// the plain version's arithmetic up to the order of fp32 sums. The other
// design (EXACT false, for tools/kernel_ab.py) rounds each weight (q - zero)
// * scale to bf16 in the tile, one rounding the plain version does not make
// and no epilogue: 12% faster at the serve shapes on an H100. K is split
// across blocks too where the output tiles alone would leave the card short
// of warps (TC_TARGET_BLOCKS: 2 splits at x(512, 2048) . w(2048, 1024)),
// the splits added in order as for "stream". What limits the route is not
// the tensor cores: converting the codes in each warp's registers instead
// of once a block read the same, a ring of 3 stages 2% slower.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int KSTEP = 32;  // K rows a step: one group at most

// ---- "stream": split-K weight stream for decode ----
constexpr int SBN = 64, SSTAGES = 4, STHREADS = 256, SMAX_KS = 512;
constexpr int TARGET_BLOCKS = 264;  // about two blocks per SM
constexpr int SSTAGE = (KSTEP / 2) * SBN + 2 * SBN * 4;  // bytes: codes, scale, zero

template <int MB>
struct StreamSmem {
  static constexpr int XLD = SMAX_KS + 8;
  static constexpr int LOAD = MB * XLD * 2 + SSTAGES * SSTAGE;
  static constexpr int RED = (STHREADS / 32) * MB * SBN * 4;
  static constexpr int BYTES = LOAD > RED ? LOAD : RED;
};

// One block: columns n0..n0+63, K rows k0..k0+ks of the split blockIdx.y (the
// last split may be shorter). ws: the (splits, M, N) fp32 partial sums, or
// null (one split: out directly).
template <int MB>
__global__ void __launch_bounds__(STHREADS)
int4_stream_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
                   const float* __restrict__ scale, const float* __restrict__ zero,
                   bf16* __restrict__ out, float* __restrict__ ws, int M, int K, int N,
                   int group, int ks) {
  using S = StreamSmem<MB>;
  __shared__ __align__(16) unsigned char smem[S::BYTES];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [MB][XLD]: the split's x rows
  unsigned char* ring = smem + MB * S::XLD * 2;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * SBN, k0 = blockIdx.y * ks;
  const int kb = min(ks, K - k0);  // the last split may be shorter
  const int nst = kb / KSTEP;

  for (int i = tid; i < MB * (kb / 8); i += STHREADS) {  // x: 16-byte chunks
    const int m = i / (kb / 8), c = (i % (kb / 8)) * 8;
    const bool ok = m < M;
    tc::cp_async16(xs + m * S::XLD + c, x + (ok ? (size_t)m * K + k0 + c : 0), ok);
  }
  tc::cp_async_commit();

  auto load = [&](int slot, int st) {
    unsigned char* ps = ring + slot * SSTAGE;
    float* ss = reinterpret_cast<float*>(ps + (KSTEP / 2) * SBN);
    float* zs = ss + SBN;
    const int kr = k0 + st * KSTEP;
    if (tid < (KSTEP / 2) * (SBN / 8)) {  // codes: 16 packed rows x 8 chunks of 8
      const int pr = tid / (SBN / 8), c = (tid % (SBN / 8)) * 8;
      const bool ok = n0 + c < N;
      tc::cp_async8(ps + pr * SBN + c,
                    packed + (ok ? (size_t)(kr / 2 + pr) * N + n0 + c : 0), ok);
    } else if (tid < (KSTEP / 2) * (SBN / 8) + 2 * (SBN / 4)) {  // scale, zero rows
      const int i = tid - (KSTEP / 2) * (SBN / 8);
      const int c = (i % (SBN / 4)) * 4;
      const bool ok = n0 + c < N;
      const size_t off = ok ? (size_t)(kr / group) * N + n0 + c : 0;
      if (i < SBN / 4) tc::cp_async16(ss + c, scale + off, ok);
      else tc::cp_async16(zs + c, zero + off, ok);
    }
  };

  // thread: 4 columns (cc) of one packed row (kp) of every step
  const int cc = (tid % 16) * 4, kp = tid / 16;
  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

#pragma unroll
  for (int s = 0; s < SSTAGES - 1; ++s) {
    if (s < nst) load(s, s);
    tc::cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    tc::cp_async_wait<SSTAGES - 2>();  // x and step st have landed (this thread's)
    __syncthreads();                    // everyone's, and step st - 1 is consumed
    const int nxt = st + SSTAGES - 1;
    if (nxt < nst) load(nxt % SSTAGES, nxt);
    tc::cp_async_commit();
    const unsigned char* ps = ring + (st % SSTAGES) * SSTAGE;
    const float* ss = reinterpret_cast<const float*>(ps + (KSTEP / 2) * SBN);
    const float* zs = ss + SBN;
    const uint32_t pk = *reinterpret_cast<const uint32_t*>(ps + kp * SBN + cc);
    const float4 s4 = *reinterpret_cast<const float4*>(ss + cc);
    const float4 z4 = *reinterpret_cast<const float4*>(zs + cc);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, zv[4] = {z4.x, z4.y, z4.z, z4.w};
    float w0[4], w1[4];  // K rows 2 kp (low nibbles) and 2 kp + 1
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t byte = (pk >> (8 * c)) & 0xFFu;
      w0[c] = (static_cast<float>(byte & 0xFu) - zv[c]) * sv[c];
      w1[c] = (static_cast<float>(byte >> 4) - zv[c]) * sv[c];
    }
    const int kk = st * KSTEP + 2 * kp;
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xs + m * S::XLD + kk));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[m][c] = fmaf(xv.x, w0[c], acc[m][c]);
        acc[m][c] = fmaf(xv.y, w1[c], acc[m][c]);
      }
    }
  }
  tc::cp_async_wait<0>();

  // lanes l and l + 16 hold the same columns: fold them, then the 8 warps
  // in warp order through shared memory (the ring is drained: reuse it)
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] += __shfl_down_sync(0xffffffffu, acc[m][c], 16);
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [8 warps][MB][SBN]
  if (lane < 16) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
      *reinterpret_cast<float4*>(red + (warp * MB + m) * SBN + cc) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  for (int i = tid; i < M * SBN; i += STHREADS) {
    const int m = i / SBN, col = i % SBN, c = n0 + col;
    if (c >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < STHREADS / 32; ++w) s += red[(w * MB + m) * SBN + col];
    if (ws != nullptr) ws[((size_t)blockIdx.y * M + m) * N + c] = s;
    else out[(size_t)m * N + c] = __float2bfloat16(s);
  }
}

// out = bf16(sum over splits of ws), the splits added in order.
__global__ void int4_split_reduce(const float* __restrict__ ws, bf16* __restrict__ out,
                                  int MN, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += ws[(size_t)k * MN + i];
  out[i] = __float2bfloat16(s);
}

// ---- "tc": tensor-core tiles for prefill ----
constexpr int TBM = 64, TBN = 64, TSTAGES = 4, TTHREADS = 256;
// K splits of the "tc" route: as many as bring the grid to about this many
// blocks (one 8-warp block an SM holds too few warps to hide the latency
// of a step's chain of loads and MMAs), at most 4, partial sums reduced in
// split order as for "stream"
constexpr int TC_TARGET_BLOCKS = 256;
constexpr int TK = 2 * KSTEP;    // K rows a stage: two steps, each inside one group
constexpr int TXLD = TK + 8;     // x row stride, elements: ldmatrix free of bank conflicts
constexpr int TCLD = TBN + 8;    // B tile row stride, elements
// a ring slot: x [TBM][TXLD] bf16, codes [TK/2][TBN] bytes, scale and zero
// [2 steps][TBN] fp32; then two B tiles [TK][TCLD] bf16
constexpr int TSLOT = TBM * TXLD * 2 + (TK / 2) * TBN + 2 * 2 * TBN * 4;
constexpr int TBTILE = TK * TCLD * 2;
constexpr int TSMEM = TSTAGES * TSLOT + 2 * TBTILE;
constexpr uint32_t BF16_ONES = 0x3F803F80u;

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// One stage's codes into a bf16 B tile [TK][TCLD]: each thread takes 32-bit
// words of packed bytes (4 columns x K rows 2i, 2i+1). EXACT: the codes
// themselves, which bf16 holds exactly (0x4300 | q is the bf16 of 128 + q,
// less 128); else (q - zero) * scale rounded to bf16.
template <bool EXACT>
__device__ __forceinline__ void codes_to_tile(const unsigned char* ps, const float* ss,
                                              const float* zs, bf16* bt) {
  const __nv_bfloat162 k128 = __floats2bfloat162_rn(128.f, 128.f);
#pragma unroll
  for (int k = 0; k < (TK / 2) * (TBN / 4) / TTHREADS; ++k) {
    const int i = threadIdx.x + k * TTHREADS;
    const int pr = i / (TBN / 4), c = (i % (TBN / 4)) * 4;
    const uint32_t w = *reinterpret_cast<const uint32_t*>(ps + pr * TBN + c);
    const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
    uint32_t r[4];  // rows 2 pr (lo), 2 pr + 1 (hi); columns c, c+1 | c+2, c+3
    if constexpr (EXACT) {
      const uint32_t v[4] = {prmt(lo, 0x43434343u, 0x4140), prmt(lo, 0x43434343u, 0x4342),
                             prmt(hi, 0x43434343u, 0x4140), prmt(hi, 0x43434343u, 0x4342)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v[j]), k128);
        r[j] = *reinterpret_cast<uint32_t*>(&d);
      }
    } else {
      const int h = (2 * pr) / KSTEP;  // the step, and its scale/zero row
      const float4 s4 = *reinterpret_cast<const float4*>(ss + h * TBN + c);
      const float4 z4 = *reinterpret_cast<const float4*>(zs + h * TBN + c);
      auto wq = [](uint32_t q, float sv, float zv) { return (static_cast<float>(q) - zv) * sv; };
      r[0] = tc::pack_bf16(wq(lo & 0xF, s4.x, z4.x), wq((lo >> 8) & 0xF, s4.y, z4.y));
      r[1] = tc::pack_bf16(wq((lo >> 16) & 0xF, s4.z, z4.z), wq(lo >> 24, s4.w, z4.w));
      r[2] = tc::pack_bf16(wq(hi & 0xF, s4.x, z4.x), wq((hi >> 8) & 0xF, s4.y, z4.y));
      r[3] = tc::pack_bf16(wq((hi >> 16) & 0xF, s4.z, z4.z), wq(hi >> 24, s4.w, z4.w));
    }
    *reinterpret_cast<uint2*>(bt + (2 * pr) * TCLD + c) = make_uint2(r[0], r[1]);
    *reinterpret_cast<uint2*>(bt + (2 * pr + 1) * TCLD + c) = make_uint2(r[2], r[3]);
  }
}

template <bool EXACT>
__global__ void __launch_bounds__(TTHREADS)
int4_tc_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
               const float* __restrict__ scale, const float* __restrict__ zero,
               bf16* __restrict__ out, float* __restrict__ ws, int M, int K, int N,
               int group, int steps_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int wm = (warp / 2) * 16, wn = (warp % 2) * 32;
  bf16* btile = reinterpret_cast<bf16*>(smem + TSTAGES * TSLOT);  // [2][TK][TCLD]

  auto slot_x = [&](int slot) { return reinterpret_cast<bf16*>(smem + slot * TSLOT); };
  auto slot_p = [&](int slot) { return smem + slot * TSLOT + TBM * TXLD * 2; };
  auto slot_s = [&](int slot) {
    return reinterpret_cast<float*>(slot_p(slot) + (TK / 2) * TBN);
  };
  // a stage past K (K is a multiple of 32, not always of 64) is zero-filled
  auto load = [&](int slot, int st) {
    bf16* xs = slot_x(slot);
    unsigned char* ps = slot_p(slot);
    float* ss = slot_s(slot);
    float* zs = ss + 2 * TBN;
    const int k0 = st * TK;
#pragma unroll
    for (int i = tid; i < TBM * (TK / 8); i += TTHREADS) {  // x: 64 rows x 8 chunks
      const int r = i / (TK / 8), c = (i % (TK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + c < K;
      tc::cp_async16(xs + r * TXLD + c, x + (ok ? (size_t)(m0 + r) * K + k0 + c : 0), ok);
    }
    {  // codes: 32 packed rows x 8 chunks of 8, one a thread
      const int pr = tid / (TBN / 8), c = (tid % (TBN / 8)) * 8;
      const bool ok = n0 + c < N && k0 + 2 * pr < K;
      tc::cp_async8(ps + pr * TBN + c,
                    packed + (ok ? (size_t)(k0 / 2 + pr) * N + n0 + c : 0), ok);
    }
    if (tid < 2 * 2 * (TBN / 4)) {  // scale, zero: a row for each step
      const int which = tid / (2 * (TBN / 4)), h = (tid / (TBN / 4)) % 2;
      const int c = (tid % (TBN / 4)) * 4, kr = k0 + h * KSTEP;
      const bool ok = n0 + c < N && kr < K;
      const size_t off = ok ? (size_t)(kr / group) * N + n0 + c : 0;
      tc::cp_async16((which ? zs : ss) + h * TBN + c, (which ? zero : scale) + off, ok);
    }
  };
  auto convert = [&](int slot, int buf) {
    const float* ss = slot_s(slot);
    codes_to_tile<EXACT>(slot_p(slot), ss, ss + 2 * TBN, btile + buf * TK * TCLD);
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[j][u] = 0.f;

  // this block's stages: split blockIdx.z of the K walk. Stage st: loaded
  // three iterations ahead, its codes turned into B tile st % 2 one ahead.
  const int s0 = blockIdx.z * steps_per_split;
  const int nk = min((K + TK - 1) / TK - s0, steps_per_split);
#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < nk) load(s, s0 + s);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<TSTAGES - 2>();  // stage 0 has landed
  __syncthreads();
  convert(0, 0);
  for (int st = 0; st < nk; ++st) {
    tc::cp_async_wait<TSTAGES - 3>();  // stage st + 1 has landed (this thread's)
    __syncthreads();  // everyone's; B tile st is written; stage st - 1 is consumed
    const int nxt = st + TSTAGES - 1;
    if (nxt < nk) load(nxt % TSTAGES, s0 + nxt);
    tc::cp_async_commit();
    if (st + 1 < nk) convert((st + 1) % TSTAGES, (st + 1) % 2);
    const bf16* xs = slot_x(st % TSTAGES);
    const bf16* bt = btile + (st % 2) * TK * TCLD;
    const float* ss = slot_s(st % TSTAGES);
    const float* zs = ss + 2 * TBN;

    // EXACT: per step h, sum x q and sum x per row, two independent chains
    float part[2][4][4], xsum[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int u = 0; u < 4; ++u) part[h][j][u] = 0.f;
        xsum[h][j] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const int h = kk / 2;
      uint32_t af[4];
      tc::ldsm_x4(af, xs + (wm + lane % 16) * TXLD + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        tc::ldsm_x4_t(r, bt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * TCLD + wn +
                             np * 16 + (lane / 16) * 8);
        if constexpr (EXACT) {
          tc::mma_bf16(part[h][2 * np], af, r[0], r[1]);
          tc::mma_bf16(part[h][2 * np + 1], af, r[2], r[3]);
        } else {
          tc::mma_bf16(acc[2 * np], af, r[0], r[1]);
          tc::mma_bf16(acc[2 * np + 1], af, r[2], r[3]);
        }
      }
      // sum x per row: [0] row l/4, [2] row l/4 + 8 (every column alike)
      if constexpr (EXACT) tc::mma_bf16(xsum[h], af, BF16_ONES, BF16_ONES);
    }
    if constexpr (EXACT) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = h * TBN + wn + 8 * j + 2 * (lane % 4);
          const float2 s2 = *reinterpret_cast<const float2*>(ss + c);
          const float2 z2 = *reinterpret_cast<const float2*>(zs + c);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            acc[j][2 * u] = fmaf(s2.x, fmaf(-z2.x, xsum[h][2 * u], part[h][j][2 * u]),
                                 acc[j][2 * u]);
            acc[j][2 * u + 1] = fmaf(s2.y, fmaf(-z2.y, xsum[h][2 * u], part[h][j][2 * u + 1]),
                                     acc[j][2 * u + 1]);
          }
        }
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = m0 + wm + lane / 4 + 8 * u;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + wn + 8 * j + 2 * (lane % 4);
      if (c >= N) continue;
      if (ws != nullptr)  // one split's partial sums
        *reinterpret_cast<float2*>(ws + ((size_t)blockIdx.z * M + r) * N + c) =
            make_float2(acc[j][2 * u], acc[j][2 * u + 1]);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * N + c) =
            __floats2bfloat162_rn(acc[j][2 * u], acc[j][2 * u + 1]);
    }
  }
}

bool takes(const void* x, const void* p, const void* s, const void* z, const void* out,
           int K, int N, int group) {
  return N % 8 == 0 && group % KSTEP == 0 && group <= 128 && K % group == 0 &&
         ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(p) |
           reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(z) |
           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
}

template <int MB>
void launch_stream(dim3 grid, cudaStream_t st, const void* x, const void* p, const void* s,
                   const void* z, void* out, float* ws, int M, int K, int N, int group,
                   int ks) {
  int4_stream_kernel<MB><<<grid, STHREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(p),
      static_cast<const float*>(s), static_cast<const float*>(z), static_cast<bf16*>(out),
      ws, M, K, N, group, ks);
}

}  // namespace

// The K split of the "stream" route for (K, N, group): groups per split,
// chosen for about TARGET_BLOCKS blocks, at most SMAX_KS rows a split. The
// wrapper calls it to size the (splits, M, N) fp32 workspace.
extern "C" int int4_stream_split_groups(int K, int N, int group) {
  const int groups = K / group, tiles = (N + SBN - 1) / SBN;
  const int want = (TARGET_BLOCKS + tiles - 1) / tiles;  // splits
  int gps = (groups + want - 1) / want;
  gps = gps < 1 ? 1 : gps;
  return gps * group > SMAX_KS ? SMAX_KS / group : gps;
}

// x (M, K) bf16, packed (K/2, N) uint8, scale/zero (K/group, N) fp32, out
// (M, N) bf16, all contiguous on the device; ws: (splits, M, N) fp32
// scratch (splits from int4_stream_split_groups), unused with one split.
// M <= 16. Returns cudaGetLastError().
extern "C" int int4_matmul_bf16_stream(const void* x, const void* packed, const void* scale,
                                       const void* zero, void* out, void* ws, int M, int K,
                                       int N, int group, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (M > 16 || !takes(x, packed, scale, zero, out, K, N, group))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ks = int4_stream_split_groups(K, N, group) * group;
  const int splits = (K + ks - 1) / ks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = splits > 1 ? static_cast<float*>(ws) : nullptr;
  if (splits > 1 && w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + SBN - 1) / SBN, splits);
  if (M <= 4) launch_stream<4>(grid, st, x, packed, scale, zero, out, w, M, K, N, group, ks);
  else if (M <= 8) launch_stream<8>(grid, st, x, packed, scale, zero, out, w, M, K, N, group, ks);
  else launch_stream<16>(grid, st, x, packed, scale, zero, out, w, M, K, N, group, ks);
  if (splits > 1) {
    const int mn = M * N;
    int4_split_reduce<<<(mn + 255) / 256, 256, 0, st>>>(w, static_cast<bf16*>(out), mn,
                                                        splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// The K splits of the "tc" route for (M, K, N); the wrapper sizes the
// (splits, M, N) fp32 workspace with it.
extern "C" int int4_tc_splits(int M, int K, int N) {
  const int blocks = ((N + TBN - 1) / TBN) * ((M + TBM - 1) / TBM);
  const int nk = (K + TK - 1) / TK;
  int splits = TC_TARGET_BLOCKS / (blocks > 0 ? blocks : 1);
  splits = splits < 1 ? 1 : (splits > 4 ? 4 : splits);
  splits = splits > nk ? nk : splits;
  const int sps = (nk + splits - 1) / splits;
  return (nk + sps - 1) / sps;  // no empty split
}

// The same arguments as the "stream" entry, any M; ws holds
// int4_tc_splits partial sums (unused with one split).
extern "C" int int4_matmul_bf16_tc(const void* x, const void* packed, const void* scale,
                                   const void* zero, void* out, void* ws, int M, int K,
                                   int N, int group, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (!takes(x, packed, scale, zero, out, K, N, group))
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = int4_tc_splits(M, K, N);
  const int nk = (K + TK - 1) / TK, sps = (nk + splits - 1) / splits;
  float* w = splits > 1 ? static_cast<float*>(ws) : nullptr;
  if (splits > 1 && w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool ready = false;  // the attribute is set once
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(int4_tc_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, TSMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, splits);
  int4_tc_kernel<true><<<grid, TTHREADS, TSMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<const float*>(zero),
      static_cast<bf16*>(out), w, M, K, N, group, sps);
  if (splits > 1) {
    const int mn = M * N;
    int4_split_reduce<<<(mn + 255) / 256, 256, 0, st>>>(w, static_cast<bf16*>(out), mn,
                                                        splits);
  }
  return static_cast<int>(cudaGetLastError());
}
