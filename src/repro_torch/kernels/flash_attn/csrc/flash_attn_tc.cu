// Causal GQA flash attention (forward), bf16 on tensor cores, Hopper (sm_90a).
//
// Replaces, for bf16, the Pallas TPU kernel
// src/repro/kernels/flash_attn/kernel.py::flash_attention_fwd (_kernel); the
// fp32 route stays on the CUDA-core kernel of flash_attn.cu. Same function:
// online softmax with fp32 running max m, sum l and accumulator, masked
// scores set to -1e30, optional tanh score softcap and sliding window, and
// only the causally visible K/V tiles are visited.
//
// Layouts: q (B, T, Hkv, G, hd), k/v (B, S, Hkv, hd), out like q, all
// contiguous, 16-byte aligned (ops.route checks). Query rows are
// flattened as in the TPU kernel, r = t * G + g, so the G query heads that
// share a kv head share its K/V tiles. A block owns (16 * RG flattened
// rows, kv head, batch): RG row groups of 16 rows, each served by KSPLIT
// warps that take BKV / KSPLIT keys of every K/V tile and merge their
// (m, l, acc) at the end in a fixed order. The q-tile index is the grid's
// slowest dimension, walked backwards, so the longest causal walks start
// first. launch_hd picks one of two configurations by the number of
// blocks (see there).
//
// What bounds it on this card: at the serve shapes (T 128 to 512) the
// QK^T and PV products, 4 * hd operations per visible (query, key) pair;
// mma.sync reaches about half of the 989 TFLOP/s that wgmma does. The
// bytes of q, k, v and out come second. The design, FA2-style:
//   * both products run on tensor cores (mma.sync.m16n8k16, bf16 in, fp32
//     accumulation) on operands read with ldmatrix; each warp owns 16
//     query rows, whose Q tile stays in shared memory (as registers it
//     would cost 4 * hd / 8 of them a thread and, measured, a block an SM);
//     hd = 16 * (k-steps of QK^T) = 8 * (n8 tiles of PV): hd 112 is 7
//     k-steps and 14 n-tiles, hd 160 (stablelm-12b) 10 and 20, whose 80
//     fp32 accumulators a thread are a quarter more than hd 128's;
//   * K/V tiles come through a two-stage cp.async ring (16-byte copies,
//     zero-filled past S), the next tile in flight while the current one
//     is multiplied; the walk runs from the window's lower bound to the
//     block's causal frontier, and a warp skips the 16-key groups that lie
//     wholly above its rows' diagonal;
//   * shared-memory rows are padded by 8 elements (stride an odd number of
//     16-byte units: 240 B at hd 112, 272 B at hd 128, 336 B at hd 160),
//     so ldmatrix is free of bank conflicts; the dynamic shared memory,
//     (16 * RG + 2 * STAGES * BKV) * (hd + 8) * 2 bytes, is above the 48 KB
//     default in both configurations (hd 160: 63 KB and 94.5 KB), so
//     launch_cfg opts each kernel in to its size;
//   * the softmax runs on the fp32 accumulator fragments in registers (a
//     row's max and sum reduced over the 4 lanes that hold it), in base 2
//     with log2(e) folded into the score; only tiles that cross the
//     diagonal, S or the window are masked;
//   * P enters the PV product rounded to bf16 (the TPU kernel keeps it in
//     fp32); l sums the unrounded fp32 p. A split of P into a bf16 pair
//     hi + lo through two PV products was tried and not kept: it brought
//     zamba2-7b's bf16 prefill logits no nearer the plain run's and took
//     longer.
// Ragged T and S are masked: rows past T*G are zero-filled and not
// stored, keys past S are zero-filled and scored -1e30.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int PAD = 8;     // bf16 elements added to each shared-memory row
constexpr int STAGES = 2;  // K/V tiles in the ring
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// A block holds RG row groups of 16 flattened query rows.
template <int HD, int RG, int BKV>
constexpr int smem_bytes() {
  return (16 * RG + 2 * STAGES * BKV) * (HD + PAD) * 2;  // Q, then K and V in each stage
}

// The A fragment (16 rows x 16 keys) of P, in bf16, from two n8 score tiles.
__device__ __forceinline__ void p_fragment(const float (&s0)[4], const float (&s1)[4],
                                           uint32_t (&pa)[4]) {
  pa[0] = tc::pack_bf16(s0[0], s0[1]);  // row l/4, keys 0-7
  pa[1] = tc::pack_bf16(s0[2], s0[3]);  // row l/4 + 8, keys 0-7
  pa[2] = tc::pack_bf16(s1[0], s1[1]);  // row l/4, keys 8-15
  pa[3] = tc::pack_bf16(s1[2], s1[3]);  // row l/4 + 8, keys 8-15
}

// RG row groups of 16 query rows per block; BKV keys per K/V tile; KSPLIT
// warps share each row group, each taking BKV / KSPLIT keys of every tile.
template <int HD, int RG, int BKV, int KSPLIT>
__global__ void __launch_bounds__(32 * RG * KSPLIT)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int Tq, int S, int Hkv,
                int G, float scale, float softcap, int window) {
  constexpr int BQ = 16 * RG;   // flattened query rows per block
  constexpr int LD = HD + PAD;  // shared-memory row stride, elements
  constexpr int CH = HD / 8;    // 16-byte chunks per row
  constexpr int KS = HD / 16;   // k-steps of QK^T
  constexpr int NT = HD / 8;    // n8 tiles of the output
  constexpr int KW = BKV / KSPLIT;  // keys per warp per tile
  constexpr int ST = KW / 8;    // n8 tiles of a warp's scores
  constexpr int THREADS = 32 * RG * KSPLIT;
  static_assert(KW % 16 == 0, "a warp takes whole k16 steps of PV");
  static_assert((KSPLIT / 2) * RG * 16 * (HD + 2) * 4 <= 2 * STAGES * BKV * LD * 2,
                "the merge reuses the K/V ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;             // [STAGES][BKV][LD]
  bf16* Vs = Ks + STAGES * BKV * LD;   // [STAGES][BKV][LD]

  // the q-tile index runs slowest and backwards: the longest causal walks
  // are scheduled first, the shortest fill the last wave
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp % RG;  // row group: rows rg*16 .. rg*16 + 15 of the block
  const int kh = warp / RG;  // key part: keys kh*KW .. kh*KW + KW - 1 of each tile
  const int R = Tq * G;
  const int r_first = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int r_last = min(R - 1, r_first + BQ - 1);
  // visible key range of the whole block (block-uniform loop bounds)
  const int kv_end = min(S, r_last / G + 1);
  int kv_begin = window > 0 ? max(0, r_first / G - window + 1) : 0;
  kv_begin = (kv_begin / BKV) * BKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  for (int i = tid; i < BQ * CH; i += THREADS) {
    const int row = i / CH, c = i % CH, r = r_first + row;
    const bool ok = r < R;
    const int t = ok ? r / G : 0, g = ok ? r % G : 0;
    tc::cp_async16(Qs + row * LD + c * 8,
                   q + ((((size_t)b * Tq + t) * Hkv + h) * G + g) * HD + c * 8, ok);
  }
  auto load_kv = [&](int stage, int j0) {
    bf16* ks = Ks + stage * BKV * LD;
    bf16* vs = Vs + stage * BKV * LD;
    for (int i = tid; i < BKV * CH; i += THREADS) {
      const int row = i / CH, c = i % CH, s = j0 + row;
      const bool ok = s < S;
      const size_t off = (((size_t)b * S + (ok ? s : 0)) * Hkv + h) * HD + c * 8;
      tc::cp_async16(ks + row * LD + c * 8, k + off, ok);
      tc::cp_async16(vs + row * LD + c * 8, v + off, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {  // group 0 holds Q too
    if (st < n_tiles) load_kv(st, kv_begin + st * BKV);
    tc::cp_async_commit();
  }

  // this lane's two rows: r0 and r0 + 8 (padding rows see every key)
  const int r0 = r_first + rg * 16 + lane / 4;
  int t_row[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) t_row[u] = r0 + 8 * u < R ? (r0 + 8 * u) / G : Tq - 1;
  // the row group's last real query position: key groups past it are
  // masked for all of its rows (padding rows' outputs are never stored)
  const int t_wmax = r_first + rg * 16 < R ? min(R - 1, r_first + rg * 16 + 15) / G : -1;

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = kv_begin + it * BKV;
    const int k0 = j0 + kh * KW;  // this warp's first key
    tc::cp_async_wait<STAGES - 2>();  // this tile (and Q) has landed
    __syncthreads();                   // and the previous stage is consumed
    if (it + STAGES - 1 < n_tiles)
      load_kv((it + STAGES - 1) % STAGES, j0 + (STAGES - 1) * BKV);
    tc::cp_async_commit();
    const bf16* ks = Ks + (it % STAGES) * BKV * LD + kh * KW * LD;
    const bf16* vs = Vs + (it % STAGES) * BKV * LD + kh * KW * LD;

    // S = Q K^T: 16 rows x KW keys per warp
    float s[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      tc::ldsm_x4(qa, Qs + (rg * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        if (k0 + np * 16 > t_wmax) continue;  // wholly above this row group's diagonal
        uint32_t kf[4];
        tc::ldsm_x4(kf, ks + (np * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                            ((lane / 8) % 2) * 8);
        tc::mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        tc::mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    // scale, softcap, mask (base-2 domain; only a tile that crosses the
    // block's diagonal, S or the window needs the mask), online softmax
    const bool edge = window > 0 || j0 + BKV - 1 > r_first / G || j0 + BKV > S;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e / 2;
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x *= LOG2E;
        if (edge) {
          const int col = k0 + n * 8 + 2 * (lane % 4) + (e % 2);
          if (!(col < S && col <= t_row[u] && (window <= 0 || col > t_row[u] - window)))
            x = NEG;
        }
        s[n][e] = x;
        mx[u] = fmaxf(mx[u], x);
      }
    float corr[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      const float m_new = fmaxf(m[u], mx[u]);
      corr[u] = exp2f(m[u] - m_new);
      m[u] = m_new;
      l[u] *= corr[u];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < ST; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e / 2]);
        s[n][e] = p;
        l[e / 2] += p;
      }

    // O += P V: 16 keys per k-step, two n8 tiles of hd per ldmatrix
#pragma unroll
    for (int kk = 0; kk < KW / 16; ++kk) {
      if (k0 + kk * 16 > t_wmax) continue;  // p is 0 there for every real row
      uint32_t pa[4];
      p_fragment(s[2 * kk], s[2 * kk + 1], pa);
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t vf[4];
        tc::ldsm_x4_t(vf, vs + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + dp * 16 +
                              (lane / 16) * 8);
        tc::mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        tc::mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
  }
  // merge the key parts of each row group, a tree in a fixed order: at
  // each step parts [half, 2 half) leave (m, l, acc) in the drained K/V
  // ring and parts [0, half) fold in part + half
  float* red = reinterpret_cast<float*>(Ks);  // [half][RG][16][HD + 2]
#pragma unroll
  for (int half = KSPLIT / 2; half >= 1; half /= 2) {
    tc::cp_async_wait<0>();
    __syncthreads();
    if (kh >= half && kh < 2 * half) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float* row = red + (((kh - half) * RG + rg) * 16 + lane / 4 + 8 * u) * (HD + 2);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          row[n * 8 + 2 * (lane % 4)] = acc[n][2 * u];
          row[n * 8 + 2 * (lane % 4) + 1] = acc[n][2 * u + 1];
        }
        if (lane % 4 == 0) {
          row[HD] = m[u];
          row[HD + 1] = l[u];
        }
      }
    }
    __syncthreads();
    if (kh < half) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* row = red + ((kh * RG + rg) * 16 + lane / 4 + 8 * u) * (HD + 2);
        const float m2 = row[HD], l2 = row[HD + 1];
        const float m_new = fmaxf(m[u], m2);
        const float c1 = exp2f(m[u] - m_new), c2 = exp2f(m2 - m_new);
        m[u] = m_new;
        l[u] = l[u] * c1 + l2 * c2;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][2 * u] = acc[n][2 * u] * c1 + row[n * 8 + 2 * (lane % 4)] * c2;
          acc[n][2 * u + 1] = acc[n][2 * u + 1] * c1 + row[n * 8 + 2 * (lane % 4) + 1] * c2;
        }
      }
    }
  }
  if (kh > 0) return;

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = r0 + 8 * u;
    if (r >= R) continue;
    const float inv = 1.f / fmaxf(l[u], 1e-30f);
    bf16* dst = o + ((((size_t)b * Tq + r / G) * Hkv + h) * G + r % G) * HD + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * u] * inv, acc[n][2 * u + 1] * inv);
  }
}

template <int HD, int RG, int BKV, int KSPLIT>
int launch_cfg(const void* q, const void* k, const void* v, void* o, int B, int Tq, int S,
               int Hkv, int G, float scale, float softcap, int window, cudaStream_t s) {
  constexpr int smem = smem_bytes<HD, RG, BKV>();
  auto kern = flash_tc_kernel<HD, RG, BKV, KSPLIT>;
  static bool ready = false;  // the attribute is set once per kernel
  if (!ready) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  dim3 grid(Hkv, B, (Tq * G + 16 * RG - 1) / (16 * RG));
  kern<<<grid, 32 * RG * KSPLIT, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Tq, S, Hkv, G, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int Tq, int S,
              int Hkv, int G, float scale, float softcap, int window, cudaStream_t s) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // Many blocks (zamba2's 4 x 512-token prefill: 1024 of 64 rows): 4 warps
  // of 16 rows, 32-key tiles, four 46 KB blocks an SM. Few (olmoe's
  // 4 x 128: 128 of 64 rows, one an SM): blocks of 32 rows whose two warps
  // per row group split each 64-key tile, so the longest causal walk is
  // cut in half and spread over twice the SMs.
  const long blocks = (long)((Tq * G + 63) / 64) * Hkv * B;
  if (blocks >= 4L * sms)
    return launch_cfg<HD, 4, 32, 1>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);
  return launch_cfg<HD, 2, 64, 2>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);
}

int launch(const void* q, const void* k, const void* v, void* o, int B, int Tq, int S,
           int Hkv, int G, int hd, float scale, float softcap, int window, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_hd<16>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);
    case 32: return launch_hd<32>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);
    case 64: return launch_hd<64>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);
    case 112: return launch_hd<112>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);
    case 128: return launch_hd<128>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);
    case 160: return launch_hd<160>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, T, Hkv, G, hd), k/v (B, S, Hkv, hd), o like q: bf16, contiguous,
// 16-byte aligned. softcap <= 0: none; window <= 0: none. Returns
// cudaGetLastError().
extern "C" int flash_attn_fwd_bf16_tc(const void* q, const void* k, const void* v, void* o,
                                      int B, int Tq, int S, int Hkv, int G, int hd,
                                      float scale, float softcap, int window, void* stream) {
  if (B <= 0 || Tq <= 0 || Hkv <= 0 || G <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch(q, k, v, o, B, Tq, S, Hkv, G, hd, scale, softcap, window,
                static_cast<cudaStream_t>(stream));
}
