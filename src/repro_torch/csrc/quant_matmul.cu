// Int8 x int8 -> int32 matmul with a per-tensor scale epilogue, and the same
// product with nib4-packed int4 weights.
//
// Replaces the TPU kernels src/repro/kernels/quant_matmul.py:_qmm_kernel
// (quant_matmul) and src/repro/kernels/quant_matmul.py:_qmm_w4_kernel
// (quant_matmul_w4).
//
// What bounds it on an H100: on the serving path M is the slot count (4) at
// decode, so a call streams the K x N weight codes once and does 2*M*K*N
// integer operations -- a weight-streaming GEMV bounded by bytes over the
// 3.35 TB/s of device memory. At prefill M is the prompt length (128-256)
// and the operations grow with M while the weight bytes stay the same.
//
// Design (simple and right first; wgmma/TMA pipelining is later work): one
// block of 256 threads owns a BM x BN output tile and walks K in BK-deep
// steps. Each step loads the x tile (rows are K-contiguous) and the w tile
// (rows are N-contiguous; for int4 the nib4 bytes unpack on the way in) into
// shared memory, storing w transposed so that four consecutive k of one
// column form one 32-bit word. Each thread accumulates its outputs with
// __dp4a (four int8 MACs per instruction) in int32. Integer sums are exact in
// any order, so the result equals the plain version bit for bit. The scales
// are read from device memory (the host never waits for them) and the
// epilogue writes float(acc) * (s_x * s_w), the plain version's op order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;
constexpr int BN = 64;
constexpr int BK = 128;
constexpr int THREADS = 256;
constexpr int WT_PITCH = BK + 4;  // 33 words: column reads hit distinct banks

template <bool W4>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ sx, const float* __restrict__ sw,
           float* __restrict__ out, int M, int N, int K, int x_vec,
           int w_vec) {
  __shared__ __align__(16) int8_t xs[BM][BK];
  __shared__ __align__(16) int8_t wt[BN][WT_PITCH];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tx = tid % BN;        // output column within the tile
  const int ty = tid / BN;        // first of this thread's four rows
  int acc[BM * BN / THREADS] = {0, 0, 0, 0};

  for (int k0 = 0; k0 < K; k0 += BK) {
    // ---- x tile: BM rows x BK bytes, 8 bytes per thread
    {
      const int r = tid / (BK / 8);
      const int c = (tid % (BK / 8)) * 8;
      const int m = m0 + r;
      const int k = k0 + c;
      int8_t* dst = &xs[r][c];
      if (m < M && x_vec && k + 8 <= K) {
        *reinterpret_cast<int2*>(dst) =
            *reinterpret_cast<const int2*>(x + (size_t)m * K + k);
      } else {
        for (int j = 0; j < 8; ++j)
          dst[j] = (m < M && k + j < K) ? x[(size_t)m * K + k + j] : 0;
      }
    }
    // ---- w tile: BK rows of k x BN columns, stored transposed in wt[n][k]
    if (!W4) {
      for (int it = 0; it < (BK * BN) / (16 * THREADS); ++it) {
        const int idx = tid + it * THREADS;
        const int r = idx / (BN / 16);
        const int c = (idx % (BN / 16)) * 16;
        const int k = k0 + r;
        const int n = n0 + c;
        __align__(16) int8_t b[16];
        if (k < K && w_vec && n + 16 <= N) {
          *reinterpret_cast<int4*>(b) =
              *reinterpret_cast<const int4*>(w + (size_t)k * N + n);
        } else {
          for (int j = 0; j < 16; ++j)
            b[j] = (k < K && n + j < N)
                       ? static_cast<int8_t>(w[(size_t)k * N + n + j])
                       : 0;
        }
        for (int j = 0; j < 16; ++j) wt[c + j][r] = b[j];
      }
    } else {
      // nib4: packed row k2 holds k = 2*k2 (low nibble) and 2*k2 + 1 (high
      // nibble), offset-binary q + 8; rows past K read as 0x88 (two zeros)
      const int r2 = tid / (BN / 16);
      const int c = (tid % (BN / 16)) * 16;
      const int k2 = k0 / 2 + r2;
      const int n = n0 + c;
      const int K2 = K / 2;
      __align__(16) uint8_t b[16];
      if (k2 < K2 && w_vec && n + 16 <= N) {
        *reinterpret_cast<int4*>(b) =
            *reinterpret_cast<const int4*>(w + (size_t)k2 * N + n);
      } else {
        for (int j = 0; j < 16; ++j)
          b[j] = (k2 < K2 && n + j < N) ? w[(size_t)k2 * N + n + j] : 0x88;
      }
      for (int j = 0; j < 16; ++j) {
        wt[c + j][2 * r2] = static_cast<int8_t>((b[j] & 0xF) - 8);
        wt[c + j][2 * r2 + 1] = static_cast<int8_t>((b[j] >> 4) - 8);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int k4 = 0; k4 < BK; k4 += 4) {
      const int wv = *reinterpret_cast<const int*>(&wt[tx][k4]);
#pragma unroll
      for (int i = 0; i < BM * BN / THREADS; ++i) {
        const int xv = *reinterpret_cast<const int*>(&xs[ty + i * (THREADS / BN)][k4]);
        acc[i] = __dp4a(xv, wv, acc[i]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
  const float scale = __fmul_rn(sx[0], sw[0]);
#pragma unroll
  for (int i = 0; i < BM * BN / THREADS; ++i) {
    const int m = m0 + ty + i * (THREADS / BN);
    if (m < M) out[(size_t)m * N + n] = __fmul_rn(__int2float_rn(acc[i]), scale);
  }
}

template <bool W4>
int launch(const int8_t* x, const uint8_t* w, const float* sx, const float* sw,
           float* out, int M, int N, int K, void* stream) {
  const int x_vec = (reinterpret_cast<uintptr_t>(x) % 8 == 0) && (K % 8 == 0);
  const int w_vec = (reinterpret_cast<uintptr_t>(w) % 16 == 0) && (N % 16 == 0);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<W4><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, sx, sw, out, M, N, K, x_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) int8, w (K, N) int8, scalar f32 scales on the device -> out (M, N)
extern "C" int qmm_int8(const void* x, const void* w, const void* sx,
                        const void* sw, void* out, int M, int N, int K,
                        void* stream) {
  return launch<false>(static_cast<const int8_t*>(x),
                       static_cast<const uint8_t*>(w),
                       static_cast<const float*>(sx),
                       static_cast<const float*>(sw), static_cast<float*>(out),
                       M, N, K, stream);
}

// x (M, K) int8, w (K/2, N) uint8 nib4 bytes (K even) -> out (M, N) f32
extern "C" int qmm_w4(const void* x, const void* w, const void* sx,
                      const void* sw, void* out, int M, int N, int K,
                      void* stream) {
  return launch<true>(static_cast<const int8_t*>(x),
                      static_cast<const uint8_t*>(w),
                      static_cast<const float*>(sx),
                      static_cast<const float*>(sw), static_cast<float*>(out),
                      M, N, K, stream);
}
