// Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060) for bf16
// x/B/C, chunk-parallel on tensor cores, Hopper (sm_90a): the "tc" route of
// ops.ssd.
//
// Replaces, for bf16, the Pallas TPU kernel src/repro/kernels/ssd_scan/
// kernel.py::ssd_scan (_kernel); fp32 stays on the CUDA-core kernel of
// ssd_scan.cu ("fma"). Same function and arguments: x (B, T, H, P) and Bm/Cm
// (B, T, G, N) bf16 (head h reads group h / (H / G)), dt (B, T, H) fp32, A
// (H,), init (B, H, P, N) fp32 or null, D (H,) fp32 or null (y += D[h] x
// before y is rounded, once); y (B, T, H, P) bf16, final state fp32.
//
// What bounds it on this card: the bytes of x and y (0.02 ms at zamba2-7b's
// B4 T512 H112 P64); about 4 MFLOP per (b, h, chunk). The old kernel gave
// one block to each (b, h) and walked the chunks in order on CUDA cores (448
// blocks for zamba2, 96 for mamba2-130m). Here the walk is split into the
// three steps of Mamba2's own chunked implementation, so that every (b, h,
// chunk) is a block of its own, in two launches:
//
//   (a) ssd_chunk_state: for each (b, h, chunk), ca = cumsum(dt A) over the
//       chunk, the chunk's own state sum_j exp(ca_last - ca_j) dt_j x_j B_j^T
//       (P x N, fp32) and its decay exp(ca_last), into a workspace;
//   (b) state_pass, run by the last of a (b, h)'s chunk blocks to finish
//       (an integer arrival count): the state across the chunks in order,
//       in fp32, from init; the state entering each chunk overwrites that
//       chunk's own state in the workspace, the last is the final state.
//       As a launch of its own it read and wrote the 29 MB workspace of
//       zamba2's prefill from device memory in 42 us on an H100
//       (tools/kernel_profile.py); here it reads it from L2 right after it
//       was written;
//   (c) ssd_chunk_out: for each (b, h, chunk), y_i = sum_{j <= i} (C_i . B_j)
//       exp(ca_i - ca_j) dt_j x_j + exp(ca_i) C_i . state_in + D x_i, all in
//       fp32 registers, rounded to bf16 once (the state term skipped for a
//       first chunk without init).
//
// The products run as mma.sync.m16n8k16 with fp32 accumulation. C B^T takes
// the bf16 model inputs as they are. Where one operand is fp32 (the decayed
// scores, the entering state, x scaled by its decay weight), it goes in as a
// pair of bf16, hi + lo (SPLIT, two MMAs; about 16 significant bits, so the
// products keep the plain version's fp32 arithmetic up to the order of
// sums); with SPLIT false (for tools/kernel_ab.py) as hi alone, one more
// rounding. The T tail is masked as before: rows past T are staged as x = B
// = C = 0 with dt = 0, so they add nothing and do not decay the state; a
// chunk's rows are padded to a multiple of 32 the same way. Blocks are 4
// warps in (a), 8 in (c), where warp w owns the 16-row tile w (OUT_WARPS 4:
// the tiles w and 7 - w, even causal work on half the warps, which
// tools/kernel_ab.py measured 8% slower at mamba2-130m's shape and 3% at
// zamba2-7b's on an H100). Shared rows are padded by 8 elements (an odd
// number of 16-byte units) so ldmatrix is free of bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;  // 4 warps: ssd_chunk_state
constexpr int OUT_WARPS = 8;  // ssd_chunk_out: 8 (a row tile each) or 4 (two)
constexpr int OUT_THREADS = 32 * OUT_WARPS;
constexpr int MAX_CHUNK = 128;
constexpr bool SPLIT = true;  // fp32 operands as bf16 hi + lo

__host__ __device__ constexpr int pad32(int L) { return (L + 31) / 32 * 32; }

// Rows 0..LP-1 of the chunk's dt (0 past L or T) into dts, then, by warp
// 0, ca = inclusive cumsum(dt * a) over them (per-lane runs, then a warp
// scan). The caller syncs before and after.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dts,
                                             float* __restrict__ ca, float a, int LP) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 32) return;
  const int per = LP / 32;  // 1..4
  float loc[MAX_CHUNK / 32];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < MAX_CHUNK / 32; ++e) {
    if (e < per) run += dts[lane * per + e] * a;
    loc[e] = run;
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  const float base = inc - run;
#pragma unroll
  for (int e = 0; e < MAX_CHUNK / 32; ++e)
    if (e < per) ca[lane * per + e] = base + loc[e];
}

// cp.async rows 0..LP-1 of a (B, T, S, W) bf16 tensor at (b, t0, s) into
// dst [LP][W + 8]; rows past L or T are zero-filled.
template <int W, int NTHR>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int b,
                                           int t0, int s, int S, int T_, int L, int LP) {
  constexpr int LD = W + 8, CH = W / 8;
  for (int i = threadIdx.x; i < LP * CH; i += NTHR) {
    const int j = i / CH, c = (i % CH) * 8, t = t0 + j;
    const bool ok = j < L && t < T_;
    tc::cp_async16(dst + j * LD + c, src + (ok ? (((size_t)b * T_ + t) * S + s) * W + c : 0),
                   ok);
  }
}

// ---- (b) the state across chunks, in order, by one block of (b, h) ----
// st (B, nc, H, P*N): each chunk's own state in, the state entering it out
// (chunk 0's only with an init: without one it is 0, and ssd_chunk_out
// does not read it). Reads bypass L1: other blocks wrote them. A thread
// owns PN / (4 THREADS) float4 columns; U of them, over four chunks, are
// loaded at once, so the one block keeps enough bytes in flight.
template <int PN>
__device__ __forceinline__ void state_pass(float* st, const float* dec,
                                           const float* __restrict__ init,
                                           float* __restrict__ fin, int b, int h, int nc,
                                           int H) {
  constexpr int IT = PN / (4 * THREADS), U = IT < 4 ? IT : 4;
  static_assert(IT >= 1 && IT % U == 0, "unsupported P * N");
  const size_t bh = (size_t)b * H + h;
  for (int it = 0; it < IT; it += U) {
    float4 s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = ((it + u) * THREADS + threadIdx.x) * 4;
      s[u] = init ? __ldg(reinterpret_cast<const float4*>(init + bh * PN + e))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int c0 = 0; c0 < nc; c0 += 4) {
      float4 loc[4][U];
      float d[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + k < nc) {
          const size_t row = ((size_t)b * nc + c0 + k) * H + h;
          d[k] = __ldcg(dec + row);
#pragma unroll
          for (int u = 0; u < U; ++u)
            loc[k][u] = __ldcg(reinterpret_cast<const float4*>(
                st + row * PN + ((it + u) * THREADS + threadIdx.x) * 4));
        }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + k < nc) {
          const size_t row = ((size_t)b * nc + c0 + k) * H + h;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (c0 + k > 0 || init != nullptr)
              *reinterpret_cast<float4*>(st + row * PN +
                                         ((it + u) * THREADS + threadIdx.x) * 4) = s[u];
            const float4 l = loc[k][u];
            s[u] = make_float4(d[k] * s[u].x + l.x, d[k] * s[u].y + l.y,
                               d[k] * s[u].z + l.z, d[k] * s[u].w + l.w);
          }
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      *reinterpret_cast<float4*>(fin + bh * PN + ((it + u) * THREADS + threadIdx.x) * 4) = s[u];
  }
}

// ---- (a) each chunk's own state, then (b) ----
template <int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state(const bf16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const bf16* __restrict__ Bm,
                const float* __restrict__ init, float* st, float* dec,
                float* __restrict__ fin, int* __restrict__ arrived, int T_, int H, int G,
                int L) {
  constexpr int XLD = P + 8, BLD = N + 8;
  constexpr int PT = P / 16;                                  // p tiles
  constexpr int WN = (4 / PT) < (N / 16) ? (4 / PT) : (N / 16);  // warps along N
  constexpr int NT = N / 8 / WN;                              // n8 tiles a warp
  static_assert(PT * WN <= 4 && NT % 2 == 0, "unsupported (P, N)");
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (H / G), t0 = c * L, LP = pad32(L);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xh = reinterpret_cast<bf16*>(smem);  // [128][XLD]: hi of x_j w_j
  bf16* xl = xh + MAX_CHUNK * XLD;           // [128][XLD]: lo
  bf16* bs = xl + MAX_CHUNK * XLD;           // [128][BLD]: B
  float* ca = reinterpret_cast<float*>(bs + MAX_CHUNK * BLD);  // [128]
  float* ws = ca + MAX_CHUNK;                                  // [128]: dt, then w

  stage_rows<N, THREADS>(bs, Bm, b, t0, g, G, T_, L, LP);
  tc::cp_async_commit();
  // the chunk's x rows, all loads in flight at once (8 bf16 a load)
  constexpr int XIT = MAX_CHUNK * (P / 8) / THREADS;
  uint4 raw[XIT];
#pragma unroll
  for (int k = 0; k < XIT; ++k) {
    const int i = tid + k * THREADS, j = i / (P / 8), t = t0 + j;
    raw[k] = make_uint4(0, 0, 0, 0);
    if (j < L && t < T_)
      raw[k] = __ldg(reinterpret_cast<const uint4*>(
          x + (((size_t)b * T_ + t) * H + h) * P + (i % (P / 8)) * 8));
  }
  for (int j = tid; j < LP; j += THREADS)
    ws[j] = (j < L && t0 + j < T_) ? dt[((size_t)b * T_ + t0 + j) * H + h] : 0.f;
  __syncthreads();
  chunk_cumsum(ws, ca, A[h], LP);
  __syncthreads();
  const float ca_last = ca[LP - 1];  // = ca[L - 1]: padded rows add 0
  if (tid == 0) dec[((size_t)b * nc + c) * H + h] = expf(ca_last);
  for (int j = tid; j < LP; j += THREADS) ws[j] = expf(ca_last - ca[j]) * ws[j];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < XIT; ++k) {  // x_j w_j as hi + lo
    const int i = tid + k * THREADS, j = i / (P / 8), p = (i % (P / 8)) * 8;
    if (j >= LP) continue;
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw[k]);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(v[e]);
      float h0, l0, h1, l1;
      tc::split_bf16(f.x * ws[j], h0, l0);
      tc::split_bf16(f.y * ws[j], h1, l1);
      hi[e] = tc::pack_bf16(h0, h1);
      lo[e] = tc::pack_bf16(l0, l1);
    }
    *reinterpret_cast<uint4*>(xh + j * XLD + p) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(xl + j * XLD + p) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  if (warp < PT * WN) {
    const int m0 = (warp % PT) * 16, n0 = (warp / PT) * NT * 8;
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[n][u] = 0.f;
    // A (p, j) = (x w)[j][p], stored j-major: ldmatrix .trans; B (j, n) = B[j][n]
    const int q = lane / 8, r = lane % 8;
    for (int kk = 0; kk < LP / 16; ++kk) {
      const int arow = (kk * 16 + (q / 2) * 8 + r) * XLD + m0 + (q % 2) * 8;
      uint32_t ah[4], al[4];
      tc::ldsm_x4_t(ah, xh + arow);
      if constexpr (SPLIT) tc::ldsm_x4_t(al, xl + arow);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        tc::ldsm_x4_t(bf, bs + (kk * 16 + (q % 2) * 8 + r) * BLD + n0 + np * 16 + (q / 2) * 8);
        tc::mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
        tc::mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
        if constexpr (SPLIT) {
          tc::mma_bf16(acc[2 * np], al, bf[0], bf[1]);
          tc::mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
        }
      }
    }
    float* out = st + (((size_t)b * nc + c) * H + h) * P * N;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        *reinterpret_cast<float2*>(out + (m0 + lane / 4 + 8 * u) * N + n0 + n * 8 +
                                   2 * (lane % 4)) =
            make_float2(acc[n][2 * u], acc[n][2 * u + 1]);
  }

  // (b) The last of the (b, h)'s chunk blocks to finish passes the state
  // across its chunks (threadFenceReduction: each block fences its writes,
  // then counts itself in). The order of the pass is fixed, whichever
  // block runs it; the counter is left at 0 for the next call.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrived + (size_t)b * H + h, 1) == nc - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) arrived[(size_t)b * H + h] = 0;
  state_pass<P * N>(st, dec, init, fin, b, h, nc, H);
}

// ---- (c) each chunk's output ----
template <int P, int N>
__global__ void __launch_bounds__(OUT_THREADS)
ssd_chunk_out(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const float* __restrict__ st,
              const float* __restrict__ D, bf16* __restrict__ y, bool has_init, int T_,
              int H, int G, int L) {
  constexpr int XLD = P + 8, BLD = N + 8;
  constexpr int PT8 = P / 8;  // n8 tiles of y
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, g = h / (H / G), t0 = c * L, LP = pad32(L);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool carried = c > 0 || has_init;  // else the entering state is 0

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* cs = reinterpret_cast<bf16*>(smem);  // [128][BLD]: C
  bf16* bs = cs + MAX_CHUNK * BLD;           // [128][BLD]: B
  bf16* xs = bs + MAX_CHUNK * BLD;           // [128][XLD]: x
  bf16* sh = xs + MAX_CHUNK * XLD;           // [P][BLD]: hi of the entering state
  bf16* sl = sh + P * BLD;                   // [P][BLD]: lo
  float* ca = reinterpret_cast<float*>(sl + P * BLD);  // [128]
  float* dts = ca + MAX_CHUNK;                          // [128]

  stage_rows<N, OUT_THREADS>(cs, Cm, b, t0, g, G, T_, L, LP);
  stage_rows<N, OUT_THREADS>(bs, Bm, b, t0, g, G, T_, L, LP);
  stage_rows<P, OUT_THREADS>(xs, x, b, t0, h, H, T_, L, LP);
  tc::cp_async_commit();
  for (int j = tid; j < LP; j += OUT_THREADS)
    dts[j] = (j < L && t0 + j < T_) ? dt[((size_t)b * T_ + t0 + j) * H + h] : 0.f;
  const float* s_in = st + (((size_t)b * nc + c) * H + h) * P * N;
  for (int i = tid; carried && i < P * N / 4; i += OUT_THREADS) {
    const int p = (i * 4) / N, n = (i * 4) % N;
    const float4 v = *reinterpret_cast<const float4*>(s_in + i * 4);
    float hv[4], lv[4];
    tc::split_bf16(v.x, hv[0], lv[0]);
    tc::split_bf16(v.y, hv[1], lv[1]);
    tc::split_bf16(v.z, hv[2], lv[2]);
    tc::split_bf16(v.w, hv[3], lv[3]);
    *reinterpret_cast<uint2*>(sh + p * BLD + n) =
        make_uint2(tc::pack_bf16(hv[0], hv[1]), tc::pack_bf16(hv[2], hv[3]));
    *reinterpret_cast<uint2*>(sl + p * BLD + n) =
        make_uint2(tc::pack_bf16(lv[0], lv[1]), tc::pack_bf16(lv[2], lv[3]));
  }
  __syncthreads();
  chunk_cumsum(dts, ca, A[h], LP);
  tc::cp_async_wait<0>();
  __syncthreads();

  const float skip = D ? D[h] : 0.f;
  const int q = lane / 8, r = lane % 8;
  const int RT = LP / 16;
#pragma unroll 1
  for (int pass = 0; pass < 8 / OUT_WARPS; ++pass) {
    const int rt = pass == 0 ? warp : 7 - warp;  // 4 warps: tiles w and 7 - w, even work
    if (rt >= RT) continue;
    const int i0 = rt * 16;
    const int ia = i0 + lane / 4, ib = ia + 8;  // this lane's two rows
    const float ca_a = ca[ia], ca_b = ca[ib];
    float yacc[PT8][4];
#pragma unroll
    for (int n = 0; n < PT8; ++n)
#pragma unroll
      for (int u = 0; u < 4; ++u) yacc[n][u] = 0.f;

    // carried state: C_i . state_in (p), then times exp(ca_i)
    if (carried) {
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t af[4];
        tc::ldsm_x4(af, cs + (i0 + lane % 16) * BLD + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          const int off = (np * 16 + (lane / 16) * 8 + r) * BLD + kk * 16 + (q % 2) * 8;
          uint32_t bf[4];
          tc::ldsm_x4(bf, sh + off);
          tc::mma_bf16(yacc[2 * np], af, bf[0], bf[1]);
          tc::mma_bf16(yacc[2 * np + 1], af, bf[2], bf[3]);
          if constexpr (SPLIT) {
            tc::ldsm_x4(bf, sl + off);
            tc::mma_bf16(yacc[2 * np], af, bf[0], bf[1]);
            tc::mma_bf16(yacc[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      }
    }
    const float ea = expf(ca_a), eb = expf(ca_b);
#pragma unroll
    for (int n = 0; n < PT8; ++n) {
      yacc[n][0] *= ea;
      yacc[n][1] *= ea;
      yacc[n][2] *= eb;
      yacc[n][3] *= eb;
    }

    // dual term, 32 keys at a time up to the tile's diagonal
    for (int j0 = 0; j0 <= i0 + 15; j0 += 32) {
      float s[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[n][u] = 0.f;
      const bool second = j0 + 16 <= i0 + 15;  // keys j0+16.. reach the tile
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t af[4];
        tc::ldsm_x4(af, cs + (i0 + lane % 16) * BLD + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          if (np == 1 && !second) continue;
          uint32_t bf[4];
          tc::ldsm_x4(bf, bs + (j0 + np * 16 + (lane / 16) * 8 + r) * BLD + kk * 16 +
                              (q % 2) * 8);
          tc::mma_bf16(s[2 * np], af, bf[0], bf[1]);
          tc::mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
        }
      }
      // scores (C_i . B_j) exp(ca_i - ca_j) dt_j for j <= i, in fp32
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + n * 8 + 2 * (lane % 4) + e;
          const float caj = ca[j], dtj = dts[j];
          s[n][e] = j <= ia ? s[n][e] * __expf(ca_a - caj) * dtj : 0.f;
          s[n][2 + e] = j <= ib ? s[n][2 + e] * __expf(ca_b - caj) * dtj : 0.f;
        }
      // y += scores . x, the scores as A fragments (hi, then lo)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        if (kh == 1 && !second) continue;
        float hv[8], lv[8];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          tc::split_bf16(s[2 * kh][u], hv[u], lv[u]);
          tc::split_bf16(s[2 * kh + 1][u], hv[4 + u], lv[4 + u]);
        }
        const uint32_t ph[4] = {tc::pack_bf16(hv[0], hv[1]), tc::pack_bf16(hv[2], hv[3]),
                                tc::pack_bf16(hv[4], hv[5]), tc::pack_bf16(hv[6], hv[7])};
        const uint32_t pl[4] = {tc::pack_bf16(lv[0], lv[1]), tc::pack_bf16(lv[2], lv[3]),
                                tc::pack_bf16(lv[4], lv[5]), tc::pack_bf16(lv[6], lv[7])};
#pragma unroll
        for (int np = 0; np < P / 16; ++np) {
          uint32_t bf[4];
          tc::ldsm_x4_t(bf, xs + (j0 + kh * 16 + (q % 2) * 8 + r) * XLD + np * 16 +
                                (q / 2) * 8);
          tc::mma_bf16(yacc[2 * np], ph, bf[0], bf[1]);
          tc::mma_bf16(yacc[2 * np + 1], ph, bf[2], bf[3]);
          if constexpr (SPLIT) {
            tc::mma_bf16(yacc[2 * np], pl, bf[0], bf[1]);
            tc::mma_bf16(yacc[2 * np + 1], pl, bf[2], bf[3]);
          }
        }
      }
    }

    // + D x, rounded once
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = u == 0 ? ia : ib, t = t0 + i;
      if (i >= L || t >= T_) continue;
      bf16* yrow = y + (((size_t)b * T_ + t) * H + h) * P;
#pragma unroll
      for (int n = 0; n < PT8; ++n) {
        const int p = n * 8 + 2 * (lane % 4);
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + i * XLD + p));
        *reinterpret_cast<__nv_bfloat162*>(yrow + p) = __floats2bfloat162_rn(
            yacc[n][2 * u] + skip * xv.x, yacc[n][2 * u + 1] + skip * xv.y);
      }
    }
  }
}

template <int P, int N>
int launch_pn(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
              const void* init, const void* D, void* y, void* fin, void* st, void* dec,
              void* arrived, int B, int T_, int H, int G, int L, cudaStream_t s) {
  constexpr size_t XB = (size_t)MAX_CHUNK * (P + 8) * 2, BB = (size_t)MAX_CHUNK * (N + 8) * 2;
  constexpr size_t SA = 2 * XB + BB + 2 * MAX_CHUNK * 4;
  constexpr size_t SC = 2 * BB + XB + 2 * (size_t)P * (N + 8) * 2 + 2 * MAX_CHUNK * 4;
  static bool ready = false;  // the attributes are set once
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_state<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SA);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_out<P, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SC);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const int nc = (T_ + L - 1) / L;
  const dim3 grid(nc, H, B);
  ssd_chunk_state<P, N><<<grid, THREADS, SA, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const float*>(init), static_cast<float*>(st), static_cast<float*>(dec),
      static_cast<float*>(fin), static_cast<int*>(arrived), T_, H, G, L);
  ssd_chunk_out<P, N><<<grid, OUT_THREADS, SC, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const float*>(st),
      static_cast<const float*>(D), static_cast<bf16*>(y), init != nullptr, T_, H, G, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As ssd_scan_bf16 (ssd_scan.cu), plus two fp32 workspaces, st (B, nc, H,
// P, N) and dec (B, nc, H), nc = ceil(T / chunk), and arrived (B, H) int32,
// zero on entry (and left so). Every pointer 16-byte aligned. Two launches
// on the stream. Returns cudaGetLastError().
extern "C" int ssd_scan_bf16_tc(const void* x, const void* dt, const void* A, const void* Bm,
                                const void* Cm, const void* init, const void* D, void* y,
                                void* fin, void* st, void* dec, void* arrived, int B, int T,
                                int H, int G, int P, int N, int chunk, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G || chunk <= 0 || chunk > MAX_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_CASE(PP, NN)                                                                 \
  if (P == PP && N == NN)                                                                \
    return launch_pn<PP, NN>(x, dt, A, Bm, Cm, init, D, y, fin, st, dec, arrived, B, T, H, \
                             G, chunk, s);
  SSD_CASE(32, 16)   // the smoke configs
  SSD_CASE(64, 64)   // zamba2-7b
  SSD_CASE(64, 128)  // mamba2-130m
#undef SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
