// Causal GQA flash attention (forward), CUDA-core route ("fma"), Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attn/kernel.py::flash_attention_fwd (_kernel)
// for what the tensor-core route of flash_attn_tc.cu does not take: fp32
// (TF32 would break its 1e-4 tolerance and the fp32 logits checks) and
// bf16 at pointers that are not 16-byte aligned (ops.route decides).
// Online softmax with fp32 running max m, sum l and accumulator, masked
// scores set to -1e30, optional tanh score softcap and sliding window,
// and only the causally visible KV tiles are visited.
//
// Layouts as in the reference: q (B, T, Hkv, G, hd), k/v (B, S, Hkv, hd),
// out like q. One block per (q-tile of 32 flattened rows, kv head, batch);
// row = t * G + g as in the TPU kernel, so the G query heads that share a
// kv head share its K/V tiles. Unlike the TPU kernel, which keeps one kv
// head's whole K/V resident in VMEM (hence its ops.supported() envelope),
// this kernel streams K/V through shared memory 32 keys at a time, from
// the window's lower bound up to the block's causal frontier, so any
// sequence length fits. Ragged T and S are masked.
//
// What bounds it on this card: the QK^T and PV FLOPs, here at the CUDA
// cores' fp32 rate: 4 threads per query row, each owning hd/4 of the
// dimensions, the partial dot products summed with two warp shuffles; K/V
// staged by scalar loads; Ks and Vs are static shared memory, 2 * BKV * hd
// * 4 bytes: 40 KB at hd 160, the largest head dim, under the 48 KB a
// block may hold statically. The bf16 serve paths do not run it (chip_smoke
// asserts so); it is kept for fp32 and as the "before" that chip_smoke
// times beside the tensor-core route.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;     // flattened query rows per block
constexpr int BKV = 32;    // keys per shared-memory tile
constexpr int LANES = 4;   // threads per query row
constexpr int THREADS = BQ * LANES;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Tq, int S, int Hkv,
                 int G, float scale, float softcap, int window) {
  constexpr int NV = HD / (4 * LANES);  // float4 chunks per thread
  const int b = blockIdx.z, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int sub = tid % LANES;
  const int R = Tq * G;
  const int r = blockIdx.x * BQ + tid / LANES;
  const bool active = r < R;
  const int t = active ? r / G : Tq - 1;  // this row's query position
  const int g = active ? r % G : 0;

  __shared__ float4 Ks[BKV][HD / 4];
  __shared__ float4 Vs[BKV][HD / 4];

  // this thread's slice of the row: float4 chunks c = i * LANES + sub
  float qv[NV][4];
  const size_t qoff = ((((size_t)b * Tq + t) * Hkv + h) * G + g) * HD;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) qv[i][u] = to_f(q[qoff + (i * LANES + sub) * 4 + u]);

  float m = NEG, l = 0.f;
  float acc[NV][4];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;

  // visible key range of the whole block (block-uniform loop bounds)
  const int r_first = blockIdx.x * BQ;
  const int r_last = min(R - 1, r_first + BQ - 1);
  const int kv_end = min(S, r_last / G + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, r_first / G - window + 1);
  kv_begin = (kv_begin / BKV) * BKV;

  float* ks = reinterpret_cast<float*>(Ks);
  float* vs = reinterpret_cast<float*>(Vs);
  for (int j0 = kv_begin; j0 < kv_end; j0 += BKV) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BKV * HD; idx += THREADS) {
      const int jj = idx / HD, d = idx % HD;
      const int s = j0 + jj;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        const size_t off = (((size_t)b * S + s) * Hkv + h) * HD + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[idx] = kx;
      vs[idx] = vx;
    }
    __syncthreads();

    float sc[BKV];
    float tile_max = NEG;
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 kk = Ks[jj][i * LANES + sub];
        part = fmaf(qv[i][0], kk.x, part);
        part = fmaf(qv[i][1], kk.y, part);
        part = fmaf(qv[i][2], kk.z, part);
        part = fmaf(qv[i][3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      float s = part * scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const int kp = j0 + jj;
      const bool vis = kp < S && kp <= t && (window <= 0 || kp > t - window);
      sc[jj] = vis ? s : NEG;
      tile_max = fmaxf(tile_max, sc[jj]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] *= corr;
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      const float p = expf(sc[jj] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vv = Vs[jj][i * LANES + sub];
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
    m = m_new;
  }

  if (!active) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      o[qoff + (i * LANES + sub) * 4 + u] = from_f<T>(acc[i][u] * inv);
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int Tq,
              int S, int Hkv, int G, float scale, float softcap, int window,
              cudaStream_t s) {
  dim3 grid((Tq * G + BQ - 1) / BQ, Hkv, B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Tq, S, Hkv, G, scale, softcap, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Tq, int S,
           int Hkv, int G, int hd, float scale, float softcap, int window,
           void* stream) {
  if (B <= 0 || Tq <= 0 || Hkv <= 0 || G <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<T, 16>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);
    case 32: return launch_hd<T, 32>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);
    case 64: return launch_hd<T, 64>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);
    case 112: return launch_hd<T, 112>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);  // zamba2-7b
    case 128: return launch_hd<T, 128>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);
    case 160: return launch_hd<T, 160>(q, k, v, o, B, Tq, S, Hkv, G, scale, softcap, window, s);  // stablelm-12b
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, T, Hkv, G, hd), k/v (B, S, Hkv, hd), o like q, all contiguous.
// softcap <= 0: none; window <= 0: none. Returns cudaGetLastError().
extern "C" int flash_attn_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                  int B, int Tq, int S, int Hkv, int G, int hd,
                                  float scale, float softcap, int window, void* stream) {
  return launch<float>(q, k, v, o, B, Tq, S, Hkv, G, hd, scale, softcap, window, stream);
}

extern "C" int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                   int B, int Tq, int S, int Hkv, int G, int hd,
                                   float scale, float softcap, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, Tq, S, Hkv, G, hd, scale, softcap, window,
                               stream);
}
