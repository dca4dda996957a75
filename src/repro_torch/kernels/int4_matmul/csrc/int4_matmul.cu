// Fused INT4-dequant matmul y = x @ ((q - zero) * scale), Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/int4_matmul/kernel.py
// ::int4_matmul. Storage (ops.quantize_matmul_weight, core.quant
// .matmul_layout): packed (K/2, N) uint8, two 4-bit codes per byte along
// K with the low nibble the even K row; scale and zero (K/group, N) fp32,
// one affine per group of K rows and column. fp32 accumulation, output
// in x's type (fp32 or bf16).
//
// What bounds it on this card: on the serving path x has few rows (the
// batch in decode, at most a prompt in prefill), so the call is bound by
// the weight bytes it must read -- packed K*N/2 plus 8*K*N/group of scale
// and zero, 1.57 MB at K*N = 2048*1024 and group 32, against 3.35 TB/s --
// and, in prefill, by the fp32 FLOPs of the CUDA cores. The weight never
// exists in fp32 in device memory: each block stages one K-slice of the
// packed bytes and the scale/zero rows that slice touches in shared
// memory, and so reads every weight byte once per M-tile (once in all for
// decode). The block's threads then dequantize the slice together, each
// element once, in registers, into an fp32 tile in shared memory that
// every row of the M-tile reads for its FMAs (dequantizing right before
// each FMA instead would repeat the work for each of the 16 thread rows).
//
// Tiling: a block owns a BM x BN output tile (16 x 16 threads, each a
// TM x TN patch) and walks K in slices of BK rows. A slice touches at
// most BK/group + 1 group rows; a per-slice table maps each K row to its
// staged group row, so any even group that divides K works. Tails in M,
// N and K are masked; tiles are not shrunk to divisors. Decode uses a
// small-M tile (BM = 16) with BN = 32, so that each packed row read is a
// whole 32-byte sector and twice as many blocks share the card. This
// version is plain CUDA-core FMA with synchronous staging; split-K for
// decode, cp.async / TMA pipelining and tensor-core tiles come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                   const float* __restrict__ scale, const float* __restrict__ zero,
                   T* __restrict__ out, int M, int K, int N, int group) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int GR = BK / 2 + 1;  // most group rows a slice can touch (group >= 2)
  __shared__ float xs[BK][BM + 1];  // transposed, padded against bank conflicts
  __shared__ float ws[BK][BN];  // the slice's dequantized weight
  __shared__ uint8_t ps[BK / 2][BN];
  __shared__ float ss[GR][BN];
  __shared__ float zs[GR][BN];
  __shared__ int grow[BK];  // K row of the slice -> staged group row

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kn = min(BK, K - k0);  // even: K and k0 are
    const int g0 = k0 / group;
    const int ng = (k0 + kn - 1) / group - g0 + 1;
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int mm = i / BK, kk = i % BK;
      const int r = m0 + mm;
      xs[kk][mm] = (r < M && kk < kn) ? to_f(x[(size_t)r * K + k0 + kk]) : 0.f;
    }
    for (int i = threadIdx.x; i < (BK / 2) * BN; i += THREADS) {
      const int pr = i / BN, nn = i % BN;
      const int c = n0 + nn;
      ps[pr][nn] = (2 * pr < kn && c < N) ? packed[(size_t)(k0 / 2 + pr) * N + c] : 0;
    }
    for (int i = threadIdx.x; i < ng * BN; i += THREADS) {
      const int gr = i / BN, nn = i % BN;
      const int c = n0 + nn;
      const bool ok = c < N;
      ss[gr][nn] = ok ? scale[(size_t)(g0 + gr) * N + c] : 0.f;
      zs[gr][nn] = ok ? zero[(size_t)(g0 + gr) * N + c] : 0.f;
    }
    for (int kk = threadIdx.x; kk < BK; kk += THREADS)
      grow[kk] = kk < kn ? (k0 + kk) / group - g0 : 0;
    __syncthreads();

    // rows past kn hold code 0 with group row 0: finite, and their x is 0
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int kk = i / BN, nn = i % BN;
      const int g = grow[kk];
      const float q = static_cast<float>((ps[kk >> 1][nn] >> ((kk & 1) * 4)) & 0x0F);
      ws[kk][nn] = (q - zs[g][nn]) * ss[g][nn];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float wv[TN], av[TM];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N) out[(size_t)r * N + c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* packed, const void* scale, const void* zero,
           void* out, int M, int K, int N, int group, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (group < 2 || group % 2 != 0 || K % group != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* tx = static_cast<const T*>(x);
  const uint8_t* tp = static_cast<const uint8_t*>(packed);
  const float* ts = static_cast<const float*>(scale);
  const float* tz = static_cast<const float*>(zero);
  T* to = static_cast<T*>(out);
  if (M <= 16) {
    constexpr int BM = 16, BN = 32, BK = 128;
    dim3 grid((N + BN - 1) / BN, 1);
    int4_matmul_kernel<T, BM, BN, BK><<<grid, THREADS, 0, s>>>(tx, tp, ts, tz, to, M,
                                                               K, N, group);
  } else {
    constexpr int BM = 64, BN = 64, BK = 32;
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    int4_matmul_kernel<T, BM, BN, BK><<<grid, THREADS, 0, s>>>(tx, tp, ts, tz, to, M,
                                                               K, N, group);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), packed (K/2, N) uint8, scale/zero (K/group, N) fp32, out (M, N),
// all contiguous on the device. Returns cudaGetLastError().
extern "C" int int4_matmul_f32(const void* x, const void* packed, const void* scale,
                               const void* zero, void* out, int M, int K, int N,
                               int group, void* stream) {
  return launch<float>(x, packed, scale, zero, out, M, K, N, group, stream);
}

extern "C" int int4_matmul_bf16(const void* x, const void* packed, const void* scale,
                                const void* zero, void* out, int M, int K, int N,
                                int group, void* stream) {
  return launch<__nv_bfloat16>(x, packed, scale, zero, out, M, K, N, group, stream);
}
