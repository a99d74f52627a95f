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
// op order. The int4 entry points take w nib4-packed: (K/2, N) bytes, packed
// row k2 holding k = 2 k2 in its low nibble and 2 k2 + 1 in its high one,
// offset-binary (q + 8), K even. Integer sums are exact in any order, so
// every route and every split below equals the plain version bit for bit.
// The scales are read on the device: the host never waits for them.
//
// What bounds it on an H100: at decode M is the slot count (4), so a call
// streams the weight bytes once for 2 * M * K * N integer operations -- a
// weight-streaming GEMV bounded by bytes over the 3.35 TB/s of device memory
// (int8: 3.1 MB in 0.94 us at K=1024, N=3072; 58.7 MB in 17.5 us at
// RWKV6-7B's K=4096, N=14336; nib4 half of that). Covering the ~1 us of
// memory latency at that rate takes ~24 KB in flight on each of the 132 SMs.
// At prefill M is the chunk length (128-256) and the weights are still read
// once, so bytes bound it as long as the int8 rate keeps up (1979 TOP/s).
//
// Design, two routes for each weight format (the wrapper picks one by M;
// each call is one launch). The weight format is a template parameter of
// both kernel bodies; each format has its own __global__ name so that a
// profile tells them apart (qmm_splitk_kernel / qmm_w4_splitk_kernel,
// qmm_mma_kernel / qmm_w4_mma_kernel).
//
// Split-K (M <= 16): a split-K GEMV on the CUDA cores (dp4a).
// - Row instances MR in {1, 2, 3, 4, 8, 16}: M rounds up to the next one, so
//   no dp4a runs on a zero row below M = 4.
// - A block owns 64 output columns and a K slab of `ks` rows (a multiple of
//   32, ops.qmm_split_k, the same rule for both formats): grid (ceil(N / 64),
//   ceil(K / ks)). The rule makes the grid at least two waves of 132 SMs at
//   every Qwen3-0.6B and RWKV6-7B projection shape.
// - Each thread owns one cell per 32-row step: 4 k rows x C columns (C = 16,
//   8, 4 for MR <= 4, 8, 16, so that its MR x C int32 sums stay in
//   registers). An int8 cell is 4 byte rows; a nib4 cell is the 2 packed
//   byte rows that hold the same 4 k rows. Cells stream through a cp.async
//   ring in shared memory that only the copying thread reads back, so no
//   barrier guards it: 8 stages of int8 cells or 16 of nib4 cells, the same
//   16 KB a block (14-15 KB in flight). The x slab comes along in the first
//   copy group.
// - int8: a 4 x 4 byte block (four k of four columns) turns into four words
//   of four k of one column with 8 __byte_perm, in registers.
// - nib4: two packed words (one per packed row, four columns each) turn
//   into four such words with 6 __byte_perm and 4 masks (nib4_cols), also
//   in registers. The codes stay offset-binary (0..15, non-negative as
//   signed bytes), and the offset comes off exactly at the end: the block
//   sums each x row of its slab once, while the ring's first copies are in
//   flight (8 or more lanes a row, dp4a against 0x01010101 over the slab in
//   shared memory, then one shuffle chain), and subtracts 8 * sum_k x[m, k]
//   from every column's sum. (Summing in the loop instead,
//   one dp4a a row and step, was measurably slower at the RWKV6-7B shapes.)
// - dp4a takes each column word against the word of four k of each x row.
//   Rows past K hold zero x, so they add nothing whatever the zero-filled
//   weight bytes decode to.
// - The block's eight row groups meet in shared memory; then, with one
//   split, the block writes the epilogue. With several, each block adds its
//   int32 sums into a workspace with atomicAdd, fences, and takes a ticket
//   per column tile; the last block of the tile reads the sums back with
//   atomicExch(.., 0) -- which also re-zeroes them -- writes the epilogue
//   and resets the ticket. Same launch: no second kernel, no memset, no host
//   sync. The workspace and tickets are zeroed once per device and stream
//   (ops._tickets, shared with the attention and wkv kernels' tickets) and
//   every launch leaves them zero.
//
// Tensor cores (M > 16): mma.sync m16n8k32 s8.s8.s32.
// - Block tile 64 x 64 (four warps of 32 x 32), through a 3-stage cp.async
//   ring of the x tile (K-contiguous rows) and the raw weight tile (64 byte
//   rows of 64 columns, N-contiguous), 16-byte copies. A step is 64 k for
//   int8 and 128 k for nib4 (its 64 packed rows), so both formats move the
//   same weight bytes a step and nib4 takes half the steps.
// - The B fragment wants four k of one column per register. int8: a thread
//   reads one word (four columns) from each of four k rows and transposes
//   the 4 x 4 bytes with __byte_perm. nib4: it reads one word from each of
//   the two packed rows of those four k and unpacks them with nib4_cols
//   (offset removed in the epilogue: each thread sums its A-fragment words
//   with dp4a, and four lanes add their sums). The four words feed four n8
//   tiles, the mma columns of tile j being the warp's columns 4g + j. The A
//   fragment is four 32-bit reads of x rows padded by 16 bytes (no bank
//   conflict).
//
// Operands the vector copies cannot take (a pointer off its alignment, N or
// K off the copy width) go through byte loads on the same code path, slow
// but exact.
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

// Two nib4 words p0, p1 (packed rows r and r + 1; byte j = column j) into
// four words c0..c3, each the k rows 2r, 2r + 1, 2r + 2, 2r + 3 of column j
// as offset-binary codes 0..15 (byte i = k row 2r + i).
__device__ __forceinline__ void nib4_cols(int p0, int p1, int* c) {
  constexpr unsigned LO = 0x0F0F0F0Fu;
  const unsigned a = __byte_perm(p0, p1, 0x5140);  // p0c0 p1c0 p0c1 p1c1
  const unsigned b = __byte_perm(p0, p1, 0x7362);  // p0c2 p1c2 p0c3 p1c3
  const unsigned alo = a & LO, ahi = (a >> 4) & LO;
  const unsigned blo = b & LO, bhi = (b >> 4) & LO;
  c[0] = static_cast<int>(__byte_perm(alo, ahi, 0x5140));  // lo hi lo hi
  c[1] = static_cast<int>(__byte_perm(alo, ahi, 0x7362));
  c[2] = static_cast<int>(__byte_perm(blo, bhi, 0x5140));
  c[3] = static_cast<int>(__byte_perm(blo, bhi, 0x7362));
}

__device__ __forceinline__ float epilogue(int acc, float scale) {
  return __fmul_rn(__int2float_rn(acc), scale);
}

constexpr int ONES = 0x01010101;  // dp4a against it sums four x bytes

// ---------------------------------------------------------------------------
// split-K: M <= 16
// ---------------------------------------------------------------------------
constexpr int SK_BN = 64;      // output columns per block
constexpr int SK_STEP = 32;    // k rows per block step (eight groups of 4)

template <int MR, bool W4>
struct SplitK {
  static constexpr int C = MR <= 4 ? 16 : (MR <= 8 ? 8 : 4);  // columns
  static constexpr int TN = SK_BN / C;           // threads along N
  static constexpr int THREADS = TN * (SK_STEP / 4);
  static constexpr int ROWS = W4 ? 2 : 4;        // weight byte rows a cell
  static constexpr int STAGES = W4 ? 16 : 8;     // ring depth, in steps
  static constexpr int KS_MAX = MR <= 4 ? 4096 : 16384 / MR;  // slab rows
  static constexpr int RING = THREADS * STAGES * ROWS * C;    // 16 KB
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

template <int MR, bool W4>
__device__ __forceinline__ void splitk_body(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ sx, const float* __restrict__ sw,
    float* __restrict__ out, int* __restrict__ tickets, int* __restrict__ ws,
    int M, int N, int K, int ks, int w_vec, int x_vec) {
  using P = SplitK<MR, W4>;
  constexpr int C = P::C, TN = P::TN, THREADS = P::THREADS, CW = C / 4;
  constexpr int ROWS = P::ROWS, STAGES = P::STAGES;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* ring = smem;                 // [stage][row][thread] x C bytes
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
    int8_t* dst = ring + (size_t)((s % STAGES) * ROWS * THREADS + tid) * C;
    const int k = k_begin + s * SK_STEP + tk * 4;   // the cell's first k row
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      int8_t* d = dst + (size_t)i * THREADS * C;
      // byte row i of the cell: k row k + i, or packed row k / 2 + i
      const bool row_ok = (W4 ? k + 2 * i : k + i) < k_end;
      const size_t row = W4 ? (size_t)(k / 2 + i) : (size_t)(k + i);
      if (w_vec) {
        const bool ok = row_ok && n < N;
        cp_async_zfill<C>(d, ok ? w + row * N + n : w, ok ? C : 0);
      } else {
#pragma unroll
        for (int j = 0; j < C; ++j)
          d[j] = (row_ok && n + j < N) ? w[row * N + n + j] : 0;
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
  for (int s = 1; s < STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();         // the x slab has landed for everyone
  __syncthreads();

  const int* xw = reinterpret_cast<const int*>(xs);
  // nib4: sum_k x[m, k] over the slab, once, for the offset (while the
  // ring's first copies are in flight): G lanes a row, one shuffle chain
  __shared__ int xsum_s[MR];
  if constexpr (W4) {
    constexpr int G = MR == 1 ? 32 : (MR == 2 ? 16 : 8);
    const int m = tid / G, words = steps * SK_STEP / 4;
    int part = 0;
    if (m < MR)
      for (int w = tid % G; w < words; w += G)
        part = __dp4a(xw[m * (P::KS_MAX / 4) + w], ONES, part);
#pragma unroll
    for (int d = G / 2; d > 0; d /= 2) part += __shfl_xor_sync(0xffffffffu, part, d);
    if (m < MR && tid % G == 0) xsum_s[m] = part;
  }

  int acc[MR][C];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[m][c] = 0;

  for (int s = 0; s < steps; ++s) {
    if (s + STAGES - 1 < steps) issue(s + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();       // this thread's cell of step s
    const int8_t* src = ring + (size_t)((s % STAGES) * ROWS * THREADS + tid) * C;
    int r[ROWS][CW];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      load_words<C>(src + (size_t)i * THREADS * C, r[i]);
    int xv[MR];
    const int kw = (s * SK_STEP + tk * 4) / 4;
#pragma unroll
    for (int m = 0; m < MR; ++m) xv[m] = xw[m * (P::KS_MAX / 4) + kw];
#pragma unroll
    for (int cw = 0; cw < CW; ++cw) {
      int col[4];
      if constexpr (W4)
        nib4_cols(r[0][cw], r[1][cw], col);
      else
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
    if constexpr (W4) sum -= 8 * xsum_s[m];
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

#define SPLITK_PARAMS                                                        \
  const int8_t *__restrict__ x, const int8_t *__restrict__ w,                \
      const float *__restrict__ sx, const float *__restrict__ sw,            \
      float *__restrict__ out, int *__restrict__ tickets,                    \
      int *__restrict__ ws, int M, int N, int K, int ks, int w_vec, int x_vec
#define SPLITK_ARGS x, w, sx, sw, out, tickets, ws, M, N, K, ks, w_vec, x_vec

template <int MR>
__global__ void __launch_bounds__(SplitK<MR, false>::THREADS)
qmm_splitk_kernel(SPLITK_PARAMS) {
  splitk_body<MR, false>(SPLITK_ARGS);
}

template <int MR>
__global__ void __launch_bounds__(SplitK<MR, true>::THREADS)
qmm_w4_splitk_kernel(SPLITK_PARAMS) {
  splitk_body<MR, true>(SPLITK_ARGS);
}

template <int MR, bool W4>
constexpr auto splitk_kernel() {
  if constexpr (W4)
    return qmm_w4_splitk_kernel<MR>;
  else
    return qmm_splitk_kernel<MR>;
}

template <int MR, bool W4>
int launch_splitk(const int8_t* x, const int8_t* w, const float* sx,
                  const float* sw, float* out, int* tickets, int* ws, int M,
                  int N, int K, int ks, cudaStream_t stream) {
  using P = SplitK<MR, W4>;
  if (ks <= 0 || ks % SK_STEP || ks > P::KS_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = splitk_kernel<MR, W4>();
  static bool attr_set = false;        // per instance, per process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int w_vec = (reinterpret_cast<uintptr_t>(w) % P::C == 0) &&
                    (N % P::C == 0);
  const int x_vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (K % 16 == 0);
  dim3 grid((N + SK_BN - 1) / SK_BN, (K + ks - 1) / ks);
  kern<<<grid, P::THREADS, P::SMEM, stream>>>(x, w, sx, sw, out, tickets, ws,
                                              M, N, K, ks, w_vec, x_vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool W4>
int splitk_entry(const void* x, const void* w, const void* sx, const void* sw,
                 void* out, void* tickets, void* ws, int M, int N, int K,
                 int ks, void* stream) {
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(w);
  auto sxp = static_cast<const float*>(sx);
  auto swp = static_cast<const float*>(sw);
  auto op = static_cast<float*>(out);
  auto tp = static_cast<int*>(tickets);
  auto wsp = static_cast<int*>(ws);
  auto st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || (W4 && K % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (M <= 4 ? M : (M <= 8 ? 8 : (M <= 16 ? 16 : 0))) {
#define SK_LAUNCH(R) \
    case R: return launch_splitk<R, W4>(xp, wp, sxp, swp, op, tp, wsp, M, N, K, ks, st);
    SK_LAUNCH(1) SK_LAUNCH(2) SK_LAUNCH(3) SK_LAUNCH(4) SK_LAUNCH(8)
    SK_LAUNCH(16)
#undef SK_LAUNCH
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// tensor cores: M > 16
// ---------------------------------------------------------------------------
constexpr int MM_BM = 64, MM_BN = 64;
constexpr int MM_WROWS = 64;           // weight byte rows per step
constexpr int MM_THREADS = 128;
constexpr int MM_STAGES = 3;
constexpr int MM_WPITCH = MM_BN + 16;  // weight rows

template <bool W4>
struct Mma {
  static constexpr int BK = W4 ? 2 * MM_WROWS : MM_WROWS;  // k per step
  static constexpr int PITCH = BK + 16;  // x rows: 20 or 36 words, no conflict
};

__device__ __forceinline__ void mma_s8(int* d, const int* a, const int* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool W4>
__device__ __forceinline__ void mma_body(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ sx, const float* __restrict__ sw,
    float* __restrict__ out, int M, int N, int K, int vec) {
  constexpr int BK = Mma<W4>::BK, PITCH = Mma<W4>::PITCH;
  __shared__ __align__(16) int8_t xs[MM_STAGES][MM_BM][PITCH];
  __shared__ __align__(16) int8_t wsm[MM_STAGES][MM_WROWS][MM_WPITCH];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = (warp / 2) * 32;      // the warp's 32 x 32 sub-tile
  const int wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * MM_BM;
  const int n0 = blockIdx.x * MM_BN;
  const int n_steps = (K + BK - 1) / BK;
  const int w_rows = W4 ? K / 2 : K;   // weight byte rows

  auto issue = [&](int s) {
    const int st = s % MM_STAGES;
    const int k0 = s * BK;
    // 64 rows x BK bytes of x, 64 byte rows x 64 bytes of w: 16-byte chunks
    for (int idx = tid; idx < MM_BM * (BK / 16); idx += MM_THREADS) {
      const int r = idx / (BK / 16), c = (idx % (BK / 16)) * 16;
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
    for (int idx = tid; idx < MM_WROWS * (MM_BN / 16); idx += MM_THREADS) {
      const int r = idx / (MM_BN / 16), c = (idx % (MM_BN / 16)) * 16;
      const int kr = s * MM_WROWS + r, nn = n0 + c;
      int8_t* d = &wsm[st][r][c];
      if (vec) {
        const bool ok = kr < w_rows && nn < N;
        cp_async_zfill<16>(d, ok ? w + (size_t)kr * N + nn : w, ok ? 16 : 0);
      } else {
        for (int j = 0; j < 16; ++j)
          d[j] = (kr < w_rows && nn + j < N) ? w[(size_t)kr * N + nn + j] : 0;
      }
    }
  };

  int acc[2][4][4];
  int rs[2][2] = {{0, 0}, {0, 0}};     // nib4: x row sums, rows g and g + 8
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
    for (int kk = 0; kk < BK; kk += 32) {
      int a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = *reinterpret_cast<const int*>(&xs[st][r][kk + tig * 4]);
        a[i][1] = *reinterpret_cast<const int*>(&xs[st][r + 8][kk + tig * 4]);
        a[i][2] = *reinterpret_cast<const int*>(&xs[st][r][kk + 16 + tig * 4]);
        a[i][3] = *reinterpret_cast<const int*>(&xs[st][r + 8][kk + 16 + tig * 4]);
        if constexpr (W4) {
          rs[i][0] = __dp4a(a[i][2], ONES, __dp4a(a[i][0], ONES, rs[i][0]));
          rs[i][1] = __dp4a(a[i][3], ONES, __dp4a(a[i][1], ONES, rs[i][1]));
        }
      }
      // b[j] = {k tig*4.., k 16 + tig*4..} of column wn + 4g + j
      int b[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int col[4];
        const int k4 = kk + h * 16 + tig * 4;
        if constexpr (W4) {
          const int pr = k4 / 2;       // the packed rows of k4 .. k4 + 3
          nib4_cols(*reinterpret_cast<const int*>(&wsm[st][pr][wn + 4 * g]),
                    *reinterpret_cast<const int*>(&wsm[st][pr + 1][wn + 4 * g]),
                    col);
        } else {
          int rw[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            rw[i] = *reinterpret_cast<const int*>(&wsm[st][k4 + i][wn + 4 * g]);
          transpose4x4(rw[0], rw[1], rw[2], rw[3], col);
        }
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

  if constexpr (W4) {                  // the four lanes of a row add theirs
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int v = rs[i][half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        rs[i][half] = v;
      }
  }
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
      const int off = W4 ? 8 * rs[i][half] : 0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int nn = n0 + wn + 8 * tig + 4 * q;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = epilogue(acc[i][j][half * 2 + q] - off, scale);
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

#define MMA_PARAMS                                                    \
  const int8_t *__restrict__ x, const int8_t *__restrict__ w,         \
      const float *__restrict__ sx, const float *__restrict__ sw,     \
      float *__restrict__ out, int M, int N, int K, int vec

__global__ void __launch_bounds__(MM_THREADS) qmm_mma_kernel(MMA_PARAMS) {
  mma_body<false>(x, w, sx, sw, out, M, N, K, vec);
}

__global__ void __launch_bounds__(MM_THREADS) qmm_w4_mma_kernel(MMA_PARAMS) {
  mma_body<true>(x, w, sx, sw, out, M, N, K, vec);
}

template <bool W4>
int mma_entry(const void* x, const void* w, const void* sx, const void* sw,
              void* out, int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (W4 && K % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (K % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(w) % 16 == 0) && (N % 16 == 0);
  dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto kern = W4 ? qmm_w4_mma_kernel : qmm_mma_kernel;
  kern<<<grid, MM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<float*>(out), M, N, K, vec);
  return static_cast<int>(cudaGetLastError());
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
  return splitk_entry<false>(x, w, sx, sw, out, tickets, ws, M, N, K, ks,
                             stream);
}

// The same function through int8 tensor cores, for M > 16.
extern "C" int qmm_int8_mma(const void* x, const void* w, const void* sx,
                            const void* sw, void* out, int M, int N, int K,
                            void* stream) {
  return mma_entry<false>(x, w, sx, sw, out, M, N, K, stream);
}

// The two routes with w (K/2, N) uint8 nib4 bytes (K even), same arguments.
extern "C" int qmm_w4_splitk(const void* x, const void* w, const void* sx,
                             const void* sw, void* out, void* tickets,
                             void* ws, int M, int N, int K, int ks,
                             void* stream) {
  return splitk_entry<true>(x, w, sx, sw, out, tickets, ws, M, N, K, ks,
                            stream);
}

extern "C" int qmm_w4_mma(const void* x, const void* w, const void* sx,
                          const void* sw, void* out, int M, int N, int K,
                          void* stream) {
  return mma_entry<true>(x, w, sx, sw, out, M, N, K, stream);
}

// Registers, static + dynamic shared memory and resident blocks per SM of
// each instance, from the runtime: route 0 = int8 split-K (mr = instance
// rows), 1 = int8 mma, 2 = nib4 split-K (mr), 3 = nib4 mma. Writes four ints
// to `info`: registers, shared bytes, blocks per SM, local (spill) bytes per
// thread.
extern "C" int qmm_occupancy(int route, int mr, void* info) {
  int* o = static_cast<int*>(info);
  const void* fn = nullptr;
  int threads = 0, dyn = 0;
  switch (route * 100 + mr) {
#define SK_CASE(R)                                                    \
  case R:                                                             \
    fn = reinterpret_cast<const void*>(qmm_splitk_kernel<R>);         \
    threads = SplitK<R, false>::THREADS;                              \
    dyn = SplitK<R, false>::SMEM;                                     \
    break;                                                            \
  case 200 + R:                                                       \
    fn = reinterpret_cast<const void*>(qmm_w4_splitk_kernel<R>);      \
    threads = SplitK<R, true>::THREADS;                               \
    dyn = SplitK<R, true>::SMEM;                                      \
    break;
    SK_CASE(1) SK_CASE(2) SK_CASE(3) SK_CASE(4) SK_CASE(8) SK_CASE(16)
#undef SK_CASE
    default:
      if (route == 1 || route == 3) {
        fn = reinterpret_cast<const void*>(route == 1 ? qmm_mma_kernel
                                                      : qmm_w4_mma_kernel);
        threads = MM_THREADS;
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
