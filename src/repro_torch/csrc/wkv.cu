// Chunked RWKV6 ("Finch") wkv recurrence, optionally from a given state.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_scan.py:_wkv_kernel
// (wkv_pallas), which computes the function of the reference's
// models/recurrent.py:wkv_chunked from zero state. Given a state it is
// wkv_chunked itself; either way it also writes the final state, which the
// TPU kernel kept in VMEM scratch.
//
// What it computes, for one (batch, head), r/k/v/lw (S, hd) f32, u (hd),
// over chunks of T rows in order, S[i][j] with i over key channels and j
// over value channels, L the inclusive cumulative log-decay of the chunk
// per channel and Lx = L - lw:
//   y[t]   = (r[t] e^{Lx[t]}) S + sum_{s < t} A[t][s] v[s] + (sum_i r u k)[t] v[t]
//   A[t][s] = sum_i r[t][i] k[s][i] e^{min(Lx[t][i] - L[s][i], 0)}
//   S     <- diag(e^{L[T-1]}) S + (k e^{L[T-1] - L})^T v
// Every exponent is <= 0 (the cumulative sums of negative log-decays only
// fall), so nothing overflows, as on the TPU. The cumulative sum runs in
// another order than the plain version's, so results agree to a tolerance
// (2e-4, the reference's own contract for wkv_pallas), not bit for bit.
//
// What bounds it on an H100: at the serving prefill (B=1, S=256, H=64,
// hd=64) it reads 16.8 MB and writes 5.2 MB (~6.6 us at 3.35 TB/s) and
// does ~0.4 GFLOP of float32 work (~6.3 us at 67 TFLOP/s): both bounds
// are a few microseconds, and what holds this design back is the chunk loop
// within a block. Design, a simple one: one block per (batch, head) walks
// the chunks in order (the loop takes the place of the TPU's sequential
// grid axis); the hd x hd state stays in shared memory across chunks; each
// chunk's four (T, hd) tiles are staged in shared memory with rows padded
// to hd + 1 floats, so the pair loop's threads (one pair each, consecutive
// s) read distinct banks; one thread per channel takes the prefix sum. The
// pair weights A carry the bonus term on their diagonal, so y is one pass
// over S and one over A. A split over chunks (chunk-local states in
// parallel, then a scan) is what would fill more than B * H SMs.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;

template <int T, int HD>
constexpr size_t smem_floats() {
  // R, K, V, L, LX tiles (T, HD + 1); A (T, T + 1); state (HD, HD); u and
  // e^{L_T} (HD each)
  return 5 * T * (HD + 1) + T * (T + 1) + HD * HD + 2 * HD;
}

template <int T, int HD>
__global__ void __launch_bounds__(THREADS)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ lw,
           const float* __restrict__ u, const float* __restrict__ s0,
           float* __restrict__ y, float* __restrict__ s_out, int S, int H) {
  constexpr int P = HD + 1;   // padded row stride of the (T, HD) tiles
  constexpr int AP = T + 1;
  extern __shared__ float smem[];
  float* R = smem;            // r, then r e^{Lx}
  float* K = R + T * P;       // k, then k e^{L_T - L}
  float* V = K + T * P;
  float* L = V + T * P;       // log-decay, then its inclusive cumsum
  float* LX = L + T * P;      // exclusive cumsum L - lw
  float* A = LX + T * P;      // pair weights, the bonus on the diagonal
  float* St = A + T * AP;     // the state S[i][j], row i = key channel
  float* U = St + HD * HD;
  float* EW = U + HD;         // e^{L_T}: the chunk's decay of the state rows

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long row = (long long)H * HD;  // stride of one time step
  const long long base = (long long)b * S * row + (long long)h * HD;
  const long long sbase = (long long)bh * HD * HD;

  for (int idx = tid; idx < HD * HD; idx += THREADS)
    St[idx] = s0 != nullptr ? s0[sbase + idx] : 0.0f;
  for (int i = tid; i < HD; i += THREADS) U[i] = u[h * HD + i];

  for (int c0 = 0; c0 < S; c0 += T) {
    __syncthreads();  // the last chunk's state update is done with K and V
    for (int idx = tid; idx < T * HD; idx += THREADS) {
      const int t = idx / HD, i = idx % HD;
      const long long g = base + (long long)(c0 + t) * row + i;
      R[t * P + i] = r[g];
      K[t * P + i] = k[g];
      V[t * P + i] = v[g];
      L[t * P + i] = lw[g];
    }
    __syncthreads();
    for (int i = tid; i < HD; i += THREADS) {
      float acc = 0.0f;
      for (int t = 0; t < T; ++t) {
        const float w = L[t * P + i];
        acc += w;
        L[t * P + i] = acc;
        LX[t * P + i] = acc - w;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < T * T; idx += THREADS) {
      const int t = idx / T, s = idx % T;
      const float* rt = R + t * P;
      const float* ks = K + s * P;
      float a = 0.0f;
      if (s < t) {
        const float* lxt = LX + t * P;
        const float* ls = L + s * P;
#pragma unroll 8
        for (int i = 0; i < HD; ++i)
          a = fmaf(rt[i] * ks[i], expf(fminf(lxt[i] - ls[i], 0.0f)), a);
      } else if (s == t) {
#pragma unroll 8
        for (int i = 0; i < HD; ++i) a = fmaf(rt[i] * U[i], ks[i], a);
      }
      A[t * AP + s] = a;
    }
    __syncthreads();
    for (int idx = tid; idx < T * HD; idx += THREADS) {
      const int t = idx / HD, i = idx % HD;
      R[t * P + i] *= expf(LX[t * P + i]);
      K[t * P + i] *= expf(L[(T - 1) * P + i] - L[t * P + i]);
    }
    for (int i = tid; i < HD; i += THREADS) EW[i] = expf(L[(T - 1) * P + i]);
    __syncthreads();
    for (int idx = tid; idx < T * HD; idx += THREADS) {
      const int t = idx / HD, j = idx % HD;
      float acc = 0.0f;
#pragma unroll 8
      for (int i = 0; i < HD; ++i) acc = fmaf(R[t * P + i], St[i * HD + j], acc);
      for (int s = 0; s <= t; ++s) acc = fmaf(A[t * AP + s], V[s * P + j], acc);
      y[base + (long long)(c0 + t) * row + j] = acc;
    }
    __syncthreads();  // every y has read the state before it moves on
    for (int idx = tid; idx < HD * HD; idx += THREADS) {
      const int i = idx / HD, j = idx % HD;
      float acc = EW[i] * St[idx];
#pragma unroll 8
      for (int t = 0; t < T; ++t) acc = fmaf(K[t * P + i], V[t * P + j], acc);
      St[idx] = acc;
    }
  }
  for (int idx = tid; idx < HD * HD; idx += THREADS)
    s_out[sbase + idx] = St[idx];  // each thread wrote these entries itself
}

template <int T, int HD>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, float* y, float* s_out, int B,
           int S, int H, cudaStream_t stream) {
  const size_t bytes = smem_floats<T, HD>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      wkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  wkv_kernel<T, HD><<<B * H, THREADS, bytes, stream>>>(r, k, v, lw, u, s0, y,
                                                       s_out, S, H);
  return (int)cudaGetLastError();
}

template <int T>
int launch_hd(const float* r, const float* k, const float* v, const float* lw,
              const float* u, const float* s0, float* y, float* s_out, int B,
              int S, int H, int hd, cudaStream_t st) {
  switch (hd) {
    case 8: return launch<T, 8>(r, k, v, lw, u, s0, y, s_out, B, S, H, st);
    case 16: return launch<T, 16>(r, k, v, lw, u, s0, y, s_out, B, S, H, st);
    case 32: return launch<T, 32>(r, k, v, lw, u, s0, y, s_out, B, S, H, st);
    case 64: return launch<T, 64>(r, k, v, lw, u, s0, y, s_out, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, lw, y: (B, S, H, hd) f32; u: (H, hd); s0 (or null for zero
// state), s_out: (B, H, hd, hd). S % chunk == 0, chunk in {16, 32}, hd in
// {8, 16, 32, 64}; the wrapper checks all of it. Returns the cudaError_t.
extern "C" int wkv(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, const void* s0, void* y,
                   void* s_out, int B, int S, int H, int hd, int chunk,
                   void* stream) {
  const float *rf = (const float*)r, *kf = (const float*)k,
              *vf = (const float*)v, *lf = (const float*)lw,
              *uf = (const float*)u, *sf = (const float*)s0;
  float *yf = (float*)y, *of = (float*)s_out;
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk == 16)
    return launch_hd<16>(rf, kf, vf, lf, uf, sf, yf, of, B, S, H, hd, st);
  if (chunk == 32)
    return launch_hd<32>(rf, kf, vf, lf, uf, sf, yf, of, B, S, H, hd, st);
  return (int)cudaErrorInvalidValue;
}
