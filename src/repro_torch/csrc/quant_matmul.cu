// Int8 x int8 -> int32 matmul with a per-tensor scale epilogue, and the same
// product with nib4-packed int4 weights.
//
// Replaces the TPU kernels src/repro/kernels/quant_matmul.py:_qmm_kernel
// (quant_matmul) and src/repro/kernels/quant_matmul.py:_qmm_w4_kernel
// (quant_matmul_w4).
//
// What it computes: out[m, n] = float(sum_k x[m, k] * w[k, n]) * (s_x * s_w)
// with x (M, K) int8 K-contiguous, w (K, N) int8 N-contiguous (the layout
// pack_linear writes), the sum exact in int32 and the epilogue
// __fmul_rn(__int2float_rn(acc), __fmul_rn(s_x, s_w)), the plain version's
// op order. Integer sums are exact in any order, so every route and every
// split below equals the plain version bit for bit. The scales are read on
// the device: the host never waits for them.
//
// What bounds it on an H100: at decode M is the slot count (4), so a call
// streams the K x N weight codes once for 2 * M * K * N integer operations
// -- a weight-streaming GEMV bounded by bytes over the 3.35 TB/s of device
// memory (3.1 MB in 0.94 us at K=1024, N=3072; 58.7 MB in 17.5 us at
// RWKV6-7B's K=4096, N=14336). Covering the ~1 us of memory latency at that
// rate takes ~24 KB in flight on each of the 132 SMs. At prefill M is the
// chunk length (128-256) and the weights are still read once, so bytes bound
// it as long as the int8 rate keeps up (1979 TOP/s).
//
// Design, two routes (the wrapper picks one by M; each call is one launch):
//
// qmm_int8_splitk (M <= 16): a split-K GEMV on the CUDA cores (dp4a).
// - Row instances MR in {1, 2, 3, 4, 8, 16}: M rounds up to the next one, so
//   no dp4a runs on a zero row below M = 4 (the old 16-row tile ran 3/4 of
//   its dp4a on zeros at M = 4).
// - A block owns 64 output columns and a K slab of `ks` rows (a multiple of
//   32, ops.qmm_split_k): grid (ceil(N / 64), ceil(K / ks)). The rule makes
//   the grid at least two waves of 132 SMs at every Qwen3-0.6B and RWKV6-7B
//   projection shape (the old grid was 16-48 blocks, each walking all of K).
// - Each thread owns one cell per 32-row step: 4 rows x C bytes (C = 16, 8,
//   4 for MR <= 4, 8, 16, so that its MR x C int32 sums stay in registers).
//   Cells stream through an 8-stage cp.async ring in shared memory that
//   only the copying thread reads back, so no barrier guards it: 7 steps
//   (14 KB a block) are in flight while one is computed. The x slab comes
//   along in the first copy group.
// - A 4 x 4 byte block (four k of four columns) turns into four words of
//   four k of one column with 8 __byte_perm, in registers; dp4a takes each
//   against the word of four k of each x row. No byte-wise shared stores.
// - The block's eight row groups meet in shared memory; then, with one
//   split, the block writes the epilogue. With several, each block adds its
//   int32 sums into a workspace with atomicAdd, fences, and takes a ticket
//   per column tile; the last block of the tile reads the sums back with
//   atomicExch(.., 0) -- which also re-zeroes them -- writes the epilogue
//   and resets the ticket. Same launch: no second kernel, no memset, no host
//   sync. The workspace and tickets are zeroed once per device and stream
//   (ops._tickets, shared with the attention kernels' tickets) and every
//   launch leaves them zero.
//
// qmm_int8_mma (M > 16): int8 tensor cores, mma.sync m16n8k32 s8.s8.s32.
// - Block tile 64 x 64 (four warps of 32 x 32), K in 64-byte steps through a
//   3-stage cp.async ring of the x tile (K-contiguous rows) and the raw w
//   tile (N-contiguous rows), 16-byte copies.
// - The B fragment wants four k of one column per register. A thread reads
//   one word (four columns) from each of four k rows and transposes the
//   4 x 4 bytes with __byte_perm; the four words feed four n8 tiles, the
//   mma columns of tile j being the warp's columns 4g + j. The A fragment
//   is four 32-bit reads of x rows padded to 80 bytes (no bank conflict);
//   the B reads keep a 2-way conflict, since rows must stay 16-byte aligned
//   for cp.async.
// - Int32 sums are exact, so the route equals the plain version bit for bit.
//
// Operands the vector copies cannot take (a pointer off its alignment, N or
// K off the copy width) go through byte loads on the same code path, slow
// but exact.
//
// qmm_w4 (int4 weights) keeps the first port's design: one block of 256
// threads per 16 x 64 output tile walks K in 128-deep steps, unpacking the
// nib4 bytes into a transposed shared tile and accumulating with dp4a.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------
// One asynchronous copy of `BYTES` (16, 8 or 4) from device to shared memory,
// of which the first `src_bytes` come from `src` and the rest are zero.
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four words r0..r3, each four bytes of one k row (byte j = column j), into
// four words c0..c3, each the four k rows of one column (byte i = row i).
__device__ __forceinline__ void transpose4x4(int r0, int r1, int r2, int r3,
                                             int* c) {
  const unsigned t0 = __byte_perm(r0, r1, 0x5140);  // a0 b0 a1 b1
  const unsigned t1 = __byte_perm(r0, r1, 0x7362);  // a2 b2 a3 b3
  const unsigned t2 = __byte_perm(r2, r3, 0x5140);  // c0 d0 c1 d1
  const unsigned t3 = __byte_perm(r2, r3, 0x7362);  // c2 d2 c3 d3
  c[0] = static_cast<int>(__byte_perm(t0, t2, 0x5410));  // a0 b0 c0 d0
  c[1] = static_cast<int>(__byte_perm(t0, t2, 0x7632));  // a1 b1 c1 d1
  c[2] = static_cast<int>(__byte_perm(t1, t3, 0x5410));
  c[3] = static_cast<int>(__byte_perm(t1, t3, 0x7632));
}

__device__ __forceinline__ float epilogue(int acc, float scale) {
  return __fmul_rn(__int2float_rn(acc), scale);
}

// ---------------------------------------------------------------------------
// qmm_int8_splitk: M <= 16
// ---------------------------------------------------------------------------
constexpr int SK_BN = 64;      // output columns per block
constexpr int SK_STEP = 32;    // k rows per block step (eight groups of 4)
constexpr int SK_STAGES = 8;   // cp.async ring depth, in steps

template <int MR>
struct SplitK {
  static constexpr int C = MR <= 4 ? 16 : (MR <= 8 ? 8 : 4);  // bytes/row
  static constexpr int TN = SK_BN / C;           // threads along N
  static constexpr int THREADS = TN * (SK_STEP / 4);
  static constexpr int KS_MAX = MR <= 4 ? 4096 : 16384 / MR;  // slab rows
  static constexpr int RING = THREADS * SK_STAGES * 4 * C;    // 16 KB
  static constexpr int RED = (SK_STEP / 4) * MR * SK_BN * 4;
  static constexpr int BUF = RING > RED ? RING : RED;
  static constexpr int SMEM = BUF + MR * KS_MAX;
};

template <int C>
__device__ __forceinline__ void load_words(const int8_t* p, int* r) {
  if (C == 16) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else if (C == 8) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    r[0] = v.x; r[1] = v.y;
  } else {
    r[0] = *reinterpret_cast<const int*>(p);
  }
}

template <int MR>
__global__ void __launch_bounds__(SplitK<MR>::THREADS)
qmm_splitk_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  float* __restrict__ out, int* __restrict__ tickets,
                  int* __restrict__ ws, int M, int N, int K, int ks,
                  int w_vec, int x_vec) {
  using P = SplitK<MR>;
  constexpr int C = P::C, TN = P::TN, THREADS = P::THREADS, CW = C / 4;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* ring = smem;                 // [stage][row 0..3][thread] x C bytes
  int8_t* xs = smem + P::BUF;          // [MR][KS_MAX] bytes, the x slab
  __shared__ int last_s;

  const int tid = threadIdx.x;
  const int tn = tid % TN;
  const int tk = tid / TN;             // row group 0..7 of a block step
  const int n0 = blockIdx.x * SK_BN;
  const int n = n0 + tn * C;
  const int k_begin = blockIdx.y * ks;
  const int k_end = min(K, k_begin + ks);
  const int steps = (k_end - k_begin + SK_STEP - 1) / SK_STEP;

  auto issue = [&](int s) {            // this thread's cell of step s
    int8_t* dst = ring + (size_t)((s % SK_STAGES) * 4 * THREADS + tid) * C;
    const int k = k_begin + s * SK_STEP + tk * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int8_t* d = dst + (size_t)i * THREADS * C;
      const bool row_ok = k + i < k_end;
      if (w_vec) {
        const bool ok = row_ok && n < N;
        cp_async_zfill<C>(d, ok ? w + (size_t)(k + i) * N + n : w,
                          ok ? C : 0);
      } else {
#pragma unroll
        for (int j = 0; j < C; ++j)
          d[j] = (row_ok && n + j < N) ? w[(size_t)(k + i) * N + n + j] : 0;
      }
    }
  };

  // prologue: the first ring stages, with the x slab in the first group
  issue(0);
  {
    const int span = steps * SK_STEP;  // slab rows, zero past k_end
    if (x_vec) {
      for (int idx = tid; idx < MR * span / 16; idx += THREADS) {
        const int m = idx / (span / 16);
        const int c = (idx % (span / 16)) * 16;
        const int k = k_begin + c;
        const bool ok = m < M && k < k_end;
        cp_async_zfill<16>(xs + m * P::KS_MAX + c,
                           ok ? x + (size_t)m * K + k : x,
                           ok ? min(16, k_end - k) : 0);
      }
    } else {
      for (int idx = tid; idx < MR * span; idx += THREADS) {
        const int m = idx / span, c = idx % span, k = k_begin + c;
        xs[m * P::KS_MAX + c] = (m < M && k < k_end) ? x[(size_t)m * K + k] : 0;
      }
    }
  }
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < SK_STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  cp_async_wait<SK_STAGES - 2>();      // the x slab has landed for everyone
  __syncthreads();

  int acc[MR][C];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[m][c] = 0;

  const int* xw = reinterpret_cast<const int*>(xs);
  for (int s = 0; s < steps; ++s) {
    if (s + SK_STAGES - 1 < steps) issue(s + SK_STAGES - 1);
    cp_async_commit();
    cp_async_wait<SK_STAGES - 1>();    // this thread's cell of step s
    const int8_t* src = ring + (size_t)((s % SK_STAGES) * 4 * THREADS + tid) * C;
    int r[4][CW];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_words<C>(src + (size_t)i * THREADS * C, r[i]);
    int xv[MR];
    const int kw = (s * SK_STEP + tk * 4) / 4;
#pragma unroll
    for (int m = 0; m < MR; ++m) xv[m] = xw[m * (P::KS_MAX / 4) + kw];
#pragma unroll
    for (int cw = 0; cw < CW; ++cw) {
      int col[4];
      transpose4x4(r[0][cw], r[1][cw], r[2][cw], r[3][cw], col);
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[m][cw * 4 + j] = __dp4a(xv[m], col[j], acc[m][cw * 4 + j]);
    }
  }
  cp_async_wait<0>();                  // (only empty groups remain)
  __syncthreads();                     // the ring is free: reuse it

  // the eight row groups meet: red[tk][m][col]
  int* red = reinterpret_cast<int*>(ring);
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c)
      red[(tk * MR + m) * SK_BN + tn * C + c] = acc[m][c];
  __syncthreads();

  const float scale = __fmul_rn(sx[0], sw[0]);
  const int n_split = gridDim.y;
  for (int idx = tid; idx < MR * SK_BN; idx += THREADS) {
    int sum = 0;
#pragma unroll
    for (int t = 0; t < SK_STEP / 4; ++t) sum += red[t * MR * SK_BN + idx];
    const int m = idx / SK_BN, nn = n0 + idx % SK_BN;
    if (m < M && nn < N) {
      if (n_split == 1)
        out[(size_t)m * N + nn] = epilogue(sum, scale);
      else
        atomicAdd(ws + (size_t)m * N + nn, sum);
    }
  }
  if (n_split == 1) return;

  // the last split of this column tile to finish writes the epilogue
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(tickets + blockIdx.x, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int idx = tid; idx < MR * SK_BN; idx += THREADS) {
    const int m = idx / SK_BN, nn = n0 + idx % SK_BN;
    if (m < M && nn < N)
      out[(size_t)m * N + nn] = epilogue(atomicExch(ws + (size_t)m * N + nn, 0),
                                         scale);
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
}

template <int MR>
int launch_splitk(const int8_t* x, const int8_t* w, const float* sx,
                  const float* sw, float* out, int* tickets, int* ws, int M,
                  int N, int K, int ks, cudaStream_t stream) {
  using P = SplitK<MR>;
  if (ks <= 0 || ks % SK_STEP || ks > P::KS_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;        // per instance, per process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_splitk_kernel<MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int w_vec = (reinterpret_cast<uintptr_t>(w) % P::C == 0) &&
                    (N % P::C == 0);
  const int x_vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (K % 16 == 0);
  dim3 grid((N + SK_BN - 1) / SK_BN, (K + ks - 1) / ks);
  qmm_splitk_kernel<MR><<<grid, P::THREADS, P::SMEM, stream>>>(
      x, w, sx, sw, out, tickets, ws, M, N, K, ks, w_vec, x_vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// qmm_int8_mma: M > 16
// ---------------------------------------------------------------------------
constexpr int MM_BM = 64, MM_BN = 64, MM_BK = 64;
constexpr int MM_THREADS = 128;
constexpr int MM_STAGES = 3;
constexpr int MM_PITCH = MM_BK + 16;   // x rows: 20 words, no bank conflict
constexpr int MM_WPITCH = MM_BN + 16;  // w rows

__device__ __forceinline__ void mma_s8(int* d, const int* a, const int* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(MM_THREADS)
qmm_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ sx, const float* __restrict__ sw,
               float* __restrict__ out, int M, int N, int K, int vec) {
  __shared__ __align__(16) int8_t xs[MM_STAGES][MM_BM][MM_PITCH];
  __shared__ __align__(16) int8_t wsm[MM_STAGES][MM_BK][MM_WPITCH];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = (warp / 2) * 32;      // the warp's 32 x 32 sub-tile
  const int wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * MM_BM;
  const int n0 = blockIdx.x * MM_BN;
  const int n_steps = (K + MM_BK - 1) / MM_BK;

  auto issue = [&](int s) {
    const int st = s % MM_STAGES;
    const int k0 = s * MM_BK;
    // 64 rows x 64 bytes of x and of w: four 16-byte chunks per row
    for (int idx = tid; idx < MM_BM * (MM_BK / 16); idx += MM_THREADS) {
      const int r = idx / (MM_BK / 16), c = (idx % (MM_BK / 16)) * 16;
      const int m = m0 + r, k = k0 + c;
      int8_t* d = &xs[st][r][c];
      if (vec) {
        const bool ok = m < M && k < K;
        cp_async_zfill<16>(d, ok ? x + (size_t)m * K + k : x, ok ? 16 : 0);
      } else {
        for (int j = 0; j < 16; ++j)
          d[j] = (m < M && k + j < K) ? x[(size_t)m * K + k + j] : 0;
      }
    }
    for (int idx = tid; idx < MM_BK * (MM_BN / 16); idx += MM_THREADS) {
      const int r = idx / (MM_BN / 16), c = (idx % (MM_BN / 16)) * 16;
      const int k = k0 + r, nn = n0 + c;
      int8_t* d = &wsm[st][r][c];
      if (vec) {
        const bool ok = k < K && nn < N;
        cp_async_zfill<16>(d, ok ? w + (size_t)k * N + nn : w, ok ? 16 : 0);
      } else {
        for (int j = 0; j < 16; ++j)
          d[j] = (k < K && nn + j < N) ? w[(size_t)k * N + nn + j] : 0;
      }
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

#pragma unroll
  for (int s = 0; s < MM_STAGES - 1; ++s) {
    if (s < n_steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<MM_STAGES - 2>();
    __syncthreads();                   // step s landed; step s - 1 is read
    if (s + MM_STAGES - 1 < n_steps) issue(s + MM_STAGES - 1);
    cp_async_commit();
    const int st = s % MM_STAGES;
#pragma unroll
    for (int kk = 0; kk < MM_BK; kk += 32) {
      int a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = *reinterpret_cast<const int*>(&xs[st][r][kk + tig * 4]);
        a[i][1] = *reinterpret_cast<const int*>(&xs[st][r + 8][kk + tig * 4]);
        a[i][2] = *reinterpret_cast<const int*>(&xs[st][r][kk + 16 + tig * 4]);
        a[i][3] = *reinterpret_cast<const int*>(&xs[st][r + 8][kk + 16 + tig * 4]);
      }
      // b[j] = {k tig*4.., k 16 + tig*4..} of column wn + 4g + j
      int b[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int rw[4], col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rw[i] = *reinterpret_cast<const int*>(
              &wsm[st][kk + h * 16 + tig * 4 + i][wn + 4 * g]);
        transpose4x4(rw[0], rw[1], rw[2], rw[3], col);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j][h] = col[j];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // d0, d1: row g, mma columns 2 tig, 2 tig + 1 -> warp columns 8 tig + j
  // and 8 tig + 4 + j of n8 tile j; d2, d3 the same at row g + 8
  const float scale = __fmul_rn(sx[0], sw[0]);
  const bool vec_out = (N % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int nn = n0 + wn + 8 * tig + 4 * q;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = epilogue(acc[i][j][half * 2 + q], scale);
        float* o = out + (size_t)m * N + nn;
        if (vec_out && nn + 4 <= N) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (nn + j < N) o[j] = v[j];
        }
      }
    }
}

// ---------------------------------------------------------------------------
// qmm_w4: nib4-packed int4 weights (the first port's kernel, unchanged)
// ---------------------------------------------------------------------------
constexpr int BM = 16;
constexpr int BN = 64;
constexpr int BK = 128;
constexpr int THREADS = 256;
constexpr int WT_PITCH = BK + 4;  // 33 words: column reads hit distinct banks

__global__ void __launch_bounds__(THREADS)
qmm_w4_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
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
    // ---- w tile: nib4: packed row k2 holds k = 2*k2 (low nibble) and
    // 2*k2 + 1 (high nibble), offset-binary q + 8; rows past K read as 0x88
    // (two zeros); stored transposed in wt[n][k]
    {
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

}  // namespace

// x (M, K) int8, w (K, N) int8, scalar f32 scales on the device -> out (M, N)
// f32, for M <= 16. `ks` rows per split (a multiple of 32, at most the
// instance's slab: ops.qmm_split_k); `tickets` holds ceil(N / 64) and `ws`
// M * N zeroed int32 that the launch leaves zero (unused with one split).
extern "C" int qmm_int8_splitk(const void* x, const void* w, const void* sx,
                               const void* sw, void* out, void* tickets,
                               void* ws, int M, int N, int K, int ks,
                               void* stream) {
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto sxp = static_cast<const float*>(sx);
  auto swp = static_cast<const float*>(sw);
  auto op = static_cast<float*>(out);
  auto tp = static_cast<int*>(tickets);
  auto wsp = static_cast<int*>(ws);
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (M <= 4 ? M : (M <= 8 ? 8 : (M <= 16 ? 16 : 0))) {
    case 1: return launch_splitk<1>(xp, wp, sxp, swp, op, tp, wsp, M, N, K, ks, st);
    case 2: return launch_splitk<2>(xp, wp, sxp, swp, op, tp, wsp, M, N, K, ks, st);
    case 3: return launch_splitk<3>(xp, wp, sxp, swp, op, tp, wsp, M, N, K, ks, st);
    case 4: return launch_splitk<4>(xp, wp, sxp, swp, op, tp, wsp, M, N, K, ks, st);
    case 8: return launch_splitk<8>(xp, wp, sxp, swp, op, tp, wsp, M, N, K, ks, st);
    case 16: return launch_splitk<16>(xp, wp, sxp, swp, op, tp, wsp, M, N, K, ks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same function through int8 tensor cores, for M > 16.
extern "C" int qmm_int8_mma(const void* x, const void* w, const void* sx,
                            const void* sw, void* out, int M, int N, int K,
                            void* stream) {
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (K % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(w) % 16 == 0) && (N % 16 == 0);
  dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  qmm_mma_kernel<<<grid, MM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<float*>(out), M, N, K, vec);
  return static_cast<int>(cudaGetLastError());
}

// x (M, K) int8, w (K/2, N) uint8 nib4 bytes (K even) -> out (M, N) f32
extern "C" int qmm_w4(const void* x, const void* w, const void* sx,
                      const void* sw, void* out, int M, int N, int K,
                      void* stream) {
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const uint8_t*>(w);
  const int x_vec = (reinterpret_cast<uintptr_t>(xp) % 8 == 0) && (K % 8 == 0);
  const int w_vec = (reinterpret_cast<uintptr_t>(wp) % 16 == 0) && (N % 16 == 0);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_w4_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      xp, wp, static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<float*>(out), M, N, K, x_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

// Registers, static + dynamic shared memory and resident blocks per SM of
// each instance, from the runtime: route 0 = split-K (mr = instance rows),
// 1 = mma, 2 = w4. Writes four ints to `info`: registers, shared bytes, blocks per SM,
// local (spill) bytes per thread.
extern "C" int qmm_occupancy(int route, int mr, void* info) {
  int* o = static_cast<int*>(info);
  const void* fn = nullptr;
  int threads = 0, dyn = 0;
  switch (route * 100 + mr) {
#define SK_CASE(R)                                                    \
  case R:                                                             \
    fn = reinterpret_cast<const void*>(qmm_splitk_kernel<R>);         \
    threads = SplitK<R>::THREADS;                                     \
    dyn = SplitK<R>::SMEM;                                            \
    break;
    SK_CASE(1) SK_CASE(2) SK_CASE(3) SK_CASE(4) SK_CASE(8) SK_CASE(16)
#undef SK_CASE
    default:
      if (route == 1) {
        fn = reinterpret_cast<const void*>(qmm_mma_kernel);
        threads = MM_THREADS;
      } else if (route == 2) {
        fn = reinterpret_cast<const void*>(qmm_w4_kernel);
        threads = THREADS;
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
  }
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dyn) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, dyn);
  if (e != cudaSuccess) return static_cast<int>(e);
  o[0] = a.numRegs;
  o[1] = static_cast<int>(a.sharedSizeBytes) + dyn;
  o[2] = blocks;
  o[3] = static_cast<int>(a.localSizeBytes);
  return 0;
}
