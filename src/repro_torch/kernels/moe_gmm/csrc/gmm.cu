// Grouped (per-expert) matmul, CUDA-core route ("fma"), Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm/kernel.py::gmm
// (dense _kernel and ragged _kernel_ragged) for what the tensor-core
// routes of gmm_tc.cu do not take: fp32 (TF32 would break its 1e-4
// tolerance), and bf16 whose K or N is not a multiple of 8 or whose
// pointers are not 16-byte aligned (ops.route decides). y[e] = a[e] @
// b[e], fp32 accumulation, output in the input type. With group_sizes,
// rows at or past group_sizes[e] of a[e] are zero by contract and come
// out zero.
//
// What bounds it on this card: in decode (a few rows per group) the
// weight bytes of b; in a large prefill the FLOPs, here at the CUDA cores'
// 67 TFLOP/s fp32 rate. What the design does: a block whose M-tile starts
// at or past group_sizes[e] writes zeros and returns before it reads one
// byte of b[e], so an empty cache slot costs no weight traffic; tails in
// M, N and K are masked instead of shrinking tiles to divisors. It is
// plain fp32 FMA over shared-memory tiles (16x16 threads, each owning a
// TM x 4 patch of the output), a small-M tile (BM = 16) for decode,
// synchronous scalar staging: about 4 KB in flight a block, far below what
// hides HBM latency. The bf16 serve path does not run it (chip_smoke
// asserts so); it is kept for fp32 and as the "before" that chip_smoke
// times beside the tensor-core routes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;  // 16 x 16

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int BM>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
           const int* __restrict__ group_sizes, int M, int K, int N) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  int rows = M;
  if (group_sizes != nullptr) rows = min(M, max(group_sizes[e], 0));
  const T* ae = a + (size_t)e * M * K;
  const T* be = b + (size_t)e * K * N;
  T* oe = out + (size_t)e * M * N;

  if (m0 >= rows) {  // empty tile: zeros, and no byte of b[e] is read
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int r = m0 + i / BN, c = n0 + i % BN;
      if (r < M && c < N) oe[(size_t)r * N + c] = from_f<T>(0.f);
    }
    return;
  }

  __shared__ float As[BK][BM + 1];  // transposed, padded against bank conflicts
  __shared__ float Bs[BK][BN];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int mm = i / BK, kk = i % BK;
      const int r = m0 + mm, c = k0 + kk;
      As[kk][mm] = (r < rows && c < K) ? to_f(ae[(size_t)r * K + c]) : 0.f;
    }
#pragma unroll
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int kk = i / BN, nn = i % BN;
      const int r = k0 + kk, c = n0 + nn;
      Bs[kk][nn] = (r < K && c < N) ? to_f(be[(size_t)r * N + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N) oe[(size_t)r * N + c] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, const int* sizes, int E, int M,
           int K, int N, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* to = static_cast<T*>(out);
  if (M <= 16) {
    dim3 grid((N + BN - 1) / BN, (M + 15) / 16, E);
    gmm_kernel<T, 16><<<grid, THREADS, 0, s>>>(ta, tb, to, sizes, M, K, N);
  } else {
    dim3 grid((N + BN - 1) / BN, (M + 63) / 64, E);
    gmm_kernel<T, 64><<<grid, THREADS, 0, s>>>(ta, tb, to, sizes, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (E, M, K), b (E, K, N), out (E, M, N), all contiguous; sizes (E,)
// int32 on the device or null (dense variant). Returns cudaGetLastError().
extern "C" int moe_gmm_f32(const void* a, const void* b, void* out, const int* sizes,
                           int E, int M, int K, int N, void* stream) {
  return launch<float>(a, b, out, sizes, E, M, K, N, stream);
}

extern "C" int moe_gmm_bf16(const void* a, const void* b, void* out, const int* sizes,
                            int E, int M, int K, int N, void* stream) {
  return launch<__nv_bfloat16>(a, b, out, sizes, E, M, K, N, stream);
}
