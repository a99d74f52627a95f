// Flash-attention forward: online-softmax GQA self-attention that returns
// the output and the per-row logsumexp for the recompute backward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_fa_kernel
// (flash_fwd_pallas).
//
// What it computes, per query row (b, s, kv head h, group row g), with q
// pre-scaled by hd^-0.5 (the caller does it):
//   logit[t] = q . k[b, t, h] + (valid(s, t) ? 0 : -1e30)
//   valid    = (!causal || t <= s) && (window <= 0 || s - t < window)
//   out      = sum_t p[t] v[b, t, h] / max(l, 1e-30),  lse = m + log(max(l, 1e-30))
// with m the running row maximum, p = exp(logit - m) and l = sum p, updated
// tile by tile (the online softmax); a row's first tile may be masked for
// it, which the rescale exp(-1e30 - m) = 0 of the next tile erases exactly,
// as in the TPU kernel.
//
// What bounds it on an H100: 4 * hd float operations per attended (q, k)
// pair against 4 * hd bytes per row of q, k, v and out, so at S = 2048 the
// operations over the float32 rate bound it (no TF32: the 2e-5 contract
// would not hold).
//
// Design (simple and right first; tensor cores, TMA and a pipelined ring
// come later): one block of 256 threads per (b*KV*G row group, 64-row q
// tile). The q tile stays in shared memory; a loop over 64-row kv tiles
// takes the place of the TPU's sequential grid axis and skips tiles that
// lie wholly under the causal or window mask. Per tile, K lands in shared
// memory and each thread computes a 4x4 block of logits (rows ty+16i,
// columns tx+16j) in f32 FMA; the row max and sum reduce over the 16 lanes
// that share the rows with shuffles; (m, l) and the thread's 4 x hd/16
// slice of the output accumulator stay in registers; p goes to shared
// memory, V replaces K in the same buffer, and the thread accumulates
// p @ V for its rows. Pitches of hd+4 (q), hd+2 (k/v) and 65 (p) keep the
// shared-memory reads free of bank conflicts. 84 KB of shared memory at
// hd = 128 lets two blocks share an SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;   // q rows per block
constexpr int BKV = 64;  // kv rows per loop step
constexpr int PP = BKV + 1;
constexpr float NEG_INF = -1e30f;

template <int HD>
constexpr int smem_bytes() {
  return (BQ * (HD + 4) + BKV * (HD + 2) + BQ * PP) * 4;
}

// rows of 16 lanes (tx = 0..15) share one set of q rows
__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
__device__ __forceinline__ void load_kv_tile(float* dst,
                                             const float* __restrict__ src,
                                             size_t row_stride, int t0) {
  constexpr int KP = HD + 2;
  for (int idx = threadIdx.x; idx < BKV * HD / 4; idx += THREADS) {
    const int r = idx / (HD / 4);
    const int c = (idx % (HD / 4)) * 4;
    const float4 x =
        *reinterpret_cast<const float4*>(src + (size_t)(t0 + r) * row_stride + c);
    float2* d = reinterpret_cast<float2*>(dst + r * KP + c);  // KP even
    d[0] = make_float2(x.x, x.y);
    d[1] = make_float2(x.z, x.w);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int KV, int G, int causal,
                 int window) {
  constexpr int QP = HD + 4;
  constexpr int KP = HD + 2;
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // BQ x QP
  float* kvs = qs + BQ * QP;    // BKV x KP, K then V
  float* ps = kvs + BKV * KP;   // BQ x PP

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int row = blockIdx.y;               // ((b * KV + h) * G + g)
  const int g = row % G;
  const int h = (row / G) % KV;
  const int b = row / (G * KV);
  const size_t q_stride = (size_t)KV * G * HD;   // between sequence rows
  const size_t kv_stride = (size_t)KV * HD;
  const float* qb = q + (((size_t)b * S * KV + h) * G + g) * HD;
  float* ob = out + (((size_t)b * S * KV + h) * G + g) * HD;
  const float* kb = k + ((size_t)b * S * KV + h) * HD;
  const float* vb = v + ((size_t)b * S * KV + h) * HD;

  for (int idx = tid; idx < BQ * HD / 4; idx += THREADS) {
    const int r = idx / (HD / 4);
    const int c = (idx % (HD / 4)) * 4;
    *reinterpret_cast<float4*>(qs + r * QP + c) =
        *reinterpret_cast<const float4*>(qb + (size_t)(q0 + r) * q_stride + c);
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int n_kv = S / BKV;
  int kt_hi = n_kv - 1;
  if (causal) kt_hi = min(kt_hi, (q0 + BQ - 1) / BKV);
  int kt_lo = 0;
  if (window > 0) {  // the first kv position any row of the tile attends
    const int first = q0 - window + 1;
    kt_lo = first > 0 ? first / BKV : 0;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's p @ V is done with kvs
    load_kv_tile<HD>(kvs, kb, kv_stride, k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = kvs[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = (!causal || kpos <= qpos) &&
                           (window <= 0 || qpos - kpos < window);
        s[i][j] += valid ? 0.0f : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
      rs = row_sum16(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading K; p is written
    load_kv_tile<HD>(kvs, vb, kv_stride, k0);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * PP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = kvs[j * KP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const float lf = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[(size_t)r * q_stride + tx + 16 * c] = acc[i][c] / lf;
    if (tx == 0) lse[(size_t)row * S + r] = m[i] + logf(lf);
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out,
           float* lse, int B, int S, int KV, int G, int causal, int window,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(S / BQ, B * KV * G);
  flash_fwd_kernel<HD><<<grid, THREADS, bytes, stream>>>(q, k, v, out, lse, S,
                                                         KV, G, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, S, KV, G, hd) f32; k, v: (B, S, KV, hd) f32; lse: (B, KV, G, S)
// f32. S % 64 == 0, hd in {32, 64, 128}, 16-byte aligned rows; window <= 0
// means none. Returns cudaErrorInvalidValue for a shape it does not take.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int S, int KV, int G,
                         int hd, int causal, int window, void* stream) {
  auto qf = static_cast<const float*>(q);
  auto kf = static_cast<const float*>(k);
  auto vf = static_cast<const float*>(v);
  auto of = static_cast<float*>(out);
  auto lf = static_cast<float*>(lse);
  auto st = static_cast<cudaStream_t>(stream);
  if (S % BQ != 0 || S % BKV != 0 || B * KV * G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 32:
      return launch<32>(qf, kf, vf, of, lf, B, S, KV, G, causal, window, st);
    case 64:
      return launch<64>(qf, kf, vf, of, lf, B, S, KV, G, causal, window, st);
    case 128:
      return launch<128>(qf, kf, vf, of, lf, B, S, KV, G, causal, window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
