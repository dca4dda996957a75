// Mamba2 SSD chunked scan (state-space duality, arXiv:2405.21060), Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py::ssd_scan
// (_kernel). Inputs: x (B, T, H, P) and Bm/Cm (B, T, G, N) in the model
// type (fp32 or bf16; head h reads group h / (H / G)), dt (B, T, H) fp32
// after softplus, A (H,) fp32 negative, init (B, H, P, N) fp32 or null
// (zeros). Outputs: y (B, T, H, P) in x's type and the final state
// (B, H, P, N) fp32. Every sum is fp32. D (H,) fp32, optional (null:
// none), fuses Mamba2's skip term into the output, y += D[h] x, before y
// is rounded to its type: the model's plain path rounds y once, after
// that add, and a second rounding here would move a bf16 model's logits
// (mamba2.py::apply_mamba_full).
//
// Each chunk of L rows (L = min(chunk, T)) does what the TPU kernel does:
//   ca = cumsum(dt * A);
//   y_i = sum_{j <= i} (C_i . B_j) exp(ca_i - ca_j) dt_j x_j      (dual term)
//       + exp(ca_i) C_i . state                                  (carried state)
//   state <- exp(ca_last) state + sum_j exp(ca_last - ca_j) dt_j x_j B_j^T.
//
// The TPU grid is (B, H, chunks) with the (P, N) state in VMEM across a
// sequential chunk axis. Blocks here run in no order, so one block owns
// one (b, h) and walks the chunks itself, with the state in shared memory
// the whole time. The T tail is masked, not shrunk to a divisor: rows
// past T are staged as x = B = C = 0 and dt = 0, so they add nothing and
// do not decay the state, exactly as ssd_chunked pads.
//
// Shared memory, in fp32: x [L][P], B transposed [N][L+1], the state
// [P][N+1] and, per tile of TI = 32 rows, C [TI][N] and the scores
// [TI][L]. Staging all of C and the (L x L) scores as well would take
// 256 KB at mamba2-130m's L 128, P 64, N 128; tiling the rows keeps it
// at 162 KB (106 KB at zamba2's N 64, two blocks per SM), above 48 KB
// only as dynamic shared memory. The odd row pitches (L+1, N+1) keep the
// strided reads of B and the state free of bank conflicts.
//
// What bounds it on this card: at the serve shapes the ideal is the
// bytes of x and y (0.02 ms at zamba2's B4 T512 H112 P64, bf16); the
// products are about 4 MFLOP per (b, h, chunk). This first version runs
// all four products as CUDA-core fp32 FMAs from shared memory, each
// thread holding a register tile (4 x 4 scores, 4 x P/32 outputs, P/8 x
// N/32 state entries), with synchronous staging. B x H blocks (96 for
// mamba2-130m, 448 for zamba2-7b) share 132 SMs. Tensor-core tiles
// (wgmma), TMA staging and splitting a (b, h) across blocks come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int TI = 32;  // chunk rows per score tile
constexpr int MAX_CHUNK = 128;
constexpr int QL = MAX_CHUNK / 32;  // column groups of 32 in a chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_floats(int L, int P, int N) {
  return (size_t)L * P + (size_t)N * (L + 1) + (size_t)TI * N + (size_t)TI * L +
         (size_t)P * (N + 1) + 2 * (size_t)L;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                const float* __restrict__ D, T* __restrict__ y, float* __restrict__ fin,
                int T_, int H, int G, int L) {
  static_assert(P % 32 == 0 && N % 16 == 0 && N <= 128, "unsupported (P, N)");
  constexpr int NP = N + 1;  // state row pitch
  constexpr int RM = TI / WARPS;  // tile rows per thread
  constexpr int QP = P / 32;  // output columns per thread
  constexpr int RP = P / WARPS;  // state rows per thread
  constexpr int QN = (N + 31) / 32;  // state columns per thread

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int LP = L + 1;  // B^T row pitch

  extern __shared__ float smem[];
  float* xs = smem;  // [L][P]: x, then x * w before the state update
  float* bt = xs + L * P;  // [N][L+1]: B transposed
  float* cs = bt + N * LP;  // [TI][N]: C rows of one tile
  float* sc = cs + TI * N;  // [TI][L]: scores of one tile
  float* st = sc + TI * L;  // [P][N+1]: the carried state
  float* ca = st + P * NP;  // [L]: cumsum(dt * A)
  float* ws = ca + L;  // [L]: dt, then exp(ca_last - ca) * dt

  const float a = A[h];
  const float skip = D ? D[h] : 0.f;
  const size_t state_off = ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS)
    st[(i / N) * NP + i % N] = init ? init[state_off + i] : 0.f;

  const int n_chunks = (T_ + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    __syncthreads();  // the last chunk's readers are done; the state is written
    for (int i = tid; i < L * P; i += THREADS) {
      const int t = t0 + i / P;
      xs[i] = t < T_ ? to_f(x[(((size_t)b * T_ + t) * H + h) * P + i % P]) : 0.f;
    }
    for (int i = tid; i < L * N; i += THREADS) {
      const int j = i / N, n = i % N, t = t0 + j;
      bt[n * LP + j] = t < T_ ? to_f(Bm[(((size_t)b * T_ + t) * G + g) * N + n]) : 0.f;
    }
    for (int j = tid; j < L; j += THREADS) {
      const int t = t0 + j;
      ws[j] = t < T_ ? dt[((size_t)b * T_ + t) * H + h] : 0.f;
    }
    __syncthreads();

    if (warp == 0) {  // inclusive cumsum of dt * A: per-lane runs, then a warp scan
      const int per = (L + 31) / 32;
      float loc[QL];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < QL; ++e) {
        const int j = lane * per + e;
        if (e < per && j < L) run += ws[j] * a;
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
      for (int e = 0; e < QL; ++e) {
        const int j = lane * per + e;
        if (e < per && j < L) ca[j] = base + loc[e];
      }
    }
    __syncthreads();
    const float ca_last = ca[L - 1];

    for (int i0 = 0; i0 < L; i0 += TI) {
      for (int i = tid; i < TI * N; i += THREADS) {
        const int j = i0 + i / N, t = t0 + j;
        cs[i] = (j < L && t < T_)
                    ? to_f(Cm[(((size_t)b * T_ + t) * G + g) * N + i % N]) : 0.f;
      }
      __syncthreads();
      const int jend = min(L, i0 + TI);  // keys visible to some row of the tile
      const int nq = (jend + 31) / 32;

      {  // scores: rows warp + 8 r, keys lane + 32 q
        float acc[RM][QL];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < QL; ++q) acc[r][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[RM];
#pragma unroll
          for (int r = 0; r < RM; ++r) cv[r] = cs[(warp + WARPS * r) * N + n];
#pragma unroll
          for (int q = 0; q < QL; ++q) {
            if (q < nq) {
              const int j = lane + 32 * q;
              const float bv = j < jend ? bt[n * LP + j] : 0.f;
#pragma unroll
              for (int r = 0; r < RM; ++r) acc[r][q] = fmaf(cv[r], bv, acc[r][q]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const int ii = warp + WARPS * r, i = i0 + ii;
#pragma unroll
          for (int q = 0; q < QL; ++q) {
            const int j = lane + 32 * q;
            if (q < nq && j < jend)
              sc[ii * L + j] = (i < L && j <= i)
                                   ? acc[r][q] * expf(ca[i] - ca[j]) * ws[j] : 0.f;
          }
        }
      }
      __syncthreads();

      {  // y: rows warp + 8 r, columns lane + 32 q
        float dg[RM][QP], of[RM][QP];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int q = 0; q < QP; ++q) dg[r][q] = of[r][q] = 0.f;
        for (int j = 0; j < jend; ++j) {
          float xv[QP];
#pragma unroll
          for (int q = 0; q < QP; ++q) xv[q] = xs[j * P + lane + 32 * q];
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const float s = sc[(warp + WARPS * r) * L + j];
#pragma unroll
            for (int q = 0; q < QP; ++q) dg[r][q] = fmaf(s, xv[q], dg[r][q]);
          }
        }
        for (int n = 0; n < N; ++n) {
          float sv[QP];
#pragma unroll
          for (int q = 0; q < QP; ++q) sv[q] = st[(lane + 32 * q) * NP + n];
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const float cv = cs[(warp + WARPS * r) * N + n];
#pragma unroll
            for (int q = 0; q < QP; ++q) of[r][q] = fmaf(cv, sv[q], of[r][q]);
          }
        }
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const int i = i0 + warp + WARPS * r, t = t0 + i;
          if (i < L && t < T_) {
            const float e = expf(ca[i]);
            T* yrow = y + (((size_t)b * T_ + t) * H + h) * P;
#pragma unroll
            for (int q = 0; q < QP; ++q) {
              const int p = lane + 32 * q;
              yrow[p] = from_f<T>(dg[r][q] + e * of[r][q] + skip * xs[i * P + p]);
            }
          }
        }
      }
      __syncthreads();  // cs and sc are rewritten by the next tile
    }

    // state <- exp(ca_last) state + (x * w)^T B, w_j = exp(ca_last - ca_j) dt_j
    for (int j = tid; j < L; j += THREADS) ws[j] = expf(ca_last - ca[j]) * ws[j];
    __syncthreads();
    for (int i = tid; i < L * P; i += THREADS) xs[i] *= ws[i / P];
    __syncthreads();
    {  // rows p = warp + 8 r, columns n = lane + 32 q
      float acc[RP][QN];
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int q = 0; q < QN; ++q) acc[r][q] = 0.f;
      for (int j = 0; j < L; ++j) {
        float bv[QN];
#pragma unroll
        for (int q = 0; q < QN; ++q) {
          const int n = lane + 32 * q;
          bv[q] = n < N ? bt[n * LP + j] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float xv = xs[j * P + warp + WARPS * r];
#pragma unroll
          for (int q = 0; q < QN; ++q) acc[r][q] = fmaf(xv, bv[q], acc[r][q]);
        }
      }
      const float dec = expf(ca_last);
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int q = 0; q < QN; ++q) {
          const int n = lane + 32 * q;
          if (n < N) {
            float* s = st + (warp + WARPS * r) * NP + n;
            *s = dec * *s + acc[r][q];
          }
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) fin[state_off + i] = st[(i / N) * NP + i % N];
}

template <typename T, int P, int N>
int launch_pn(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, const void* init, const void* D, void* y, void* fin, int B,
              int T_, int H, int G, int L, cudaStream_t s) {
  const size_t bytes = smem_floats(L, P, N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T, P, N><<<dim3(H, B), THREADS, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(init), static_cast<const float*>(D), static_cast<T*>(y),
      static_cast<float*>(fin), T_, H, G, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* init, const void* D, void* y, void* fin, int B, int T_, int H, int G,
           int P, int N, int L, void* stream) {
  if (B <= 0 || T_ <= 0 || H <= 0 || G <= 0 || H % G || L <= 0 || L > MAX_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_CASE(PP, NN)                                                              \
  if (P == PP && N == NN)                                                             \
    return launch_pn<T, PP, NN>(x, dt, A, Bm, Cm, init, D, y, fin, B, T_, H, G, L, s);
  SSD_CASE(32, 16)   // the smoke configs
  SSD_CASE(64, 64)   // zamba2-7b
  SSD_CASE(64, 128)  // mamba2-130m
#undef SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (B, T, H, P), Bm/Cm (B, T, G, N), y like x, in fp32 or bf16; dt (B, T, H),
// A (H,), init (B, H, P, N) or null, D (H,) or null, fin (B, H, P, N) in
// fp32; all contiguous. chunk: rows per chunk (1..128). Returns
// cudaGetLastError().
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* init, const void* D, void* y,
                            void* fin, int B, int T, int H, int G, int P, int N, int chunk,
                            void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, init, D, y, fin, B, T, H, G, P, N, chunk, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* init, const void* D, void* y,
                             void* fin, int B, int T, int H, int G, int P, int N, int chunk,
                             void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init, D, y, fin, B, T, H, G, P, N, chunk,
                               stream);
}
