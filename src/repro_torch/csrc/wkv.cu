// Chunked RWKV6 ("Finch") wkv recurrence, optionally from a given state.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_scan.py:_wkv_kernel
// (wkv_pallas), which computes the function of the reference's
// models/recurrent.py:wkv_chunked from zero state. Given a state it is
// wkv_chunked itself; either way it also writes the final state, which the
// TPU kernel kept in VMEM scratch.
//
// What it computes, for one (batch, head), r/k/v/lw (S, hd) f32, u (hd),
// over chunks of T rows, S[i][j] with i over key channels and j over value
// channels, L the inclusive cumulative log-decay of the chunk per channel
// and Lx = L - lw (the exclusive one):
//   y[t]   = (r[t] e^{Lx[t]}) S + sum_{s < t} A[t][s] v[s] + (sum_i r u k)[t] v[t]
//   A[t][s] = sum_i r[t][i] k[s][i] e^{min(Lx[t][i] - L[s][i], 0)}
//   S     <- diag(e^{L[T-1]}) S + (k e^{L[T-1] - L})^T v
// Every exponent is <= 0 (the cumulative sums of negative log-decays only
// fall), so nothing overflows at any decay: at log w = -8, L reaches -256
// within a chunk of 32, and e^{Lx_t - L_s} is taken per pair, never as
// e^{Lx_t} e^{-L_s}. The sums run in another order than the plain
// version's, so results agree to a tolerance (2e-4, the reference's own
// contract for wkv_pallas), not bit for bit.
//
// What bounds it on an H100: at the serving prefill (B=1, S=256, H=64,
// hd=64) it reads 16.8 MB and writes 5.2 MB (~6.6 us at 3.35 TB/s) and
// does ~0.4 GFLOP of float32 work (~6.3 us at 67 TFLOP/s). What holds a
// block-per-(batch, head) design back is the chunk loop: B * H blocks (64
// of the 132 SMs at the serving prefill), each walking its chunks in order.
//
// Design: chunk-parallel, one launch, a block per (batch, head, chunk):
// B * H * S / T blocks (512 at the serving prefill, 4096 at S = 2048).
// (a) The chunk on its own, in parallel. A block copies its chunk's r, k, v
//     and log-decay tiles into shared memory with cp.async (all in flight
//     at once), rows padded to hd + 4 floats (16-byte rows, distinct banks
//     for eight rows); warp shuffles take the cumulative sums in log2
//     units, 32 / T channels a warp, interleaved. Pair weights A[t][s] by
//     2 x 2 blocks, one task a thread: within a sub-chunk of 8 rows (and on
//     the diagonal, with the bonus) one ex2 a pair and channel, a block's
//     channels split four ways and summed by shuffles; across sub-chunks
//     the exponent factors about the row b before t's sub-chunk,
//     e^{Lx_t - L_s} = e^{Lx_t - L_b} e^{L_b - L_s} -- both exponents <= 0,
//     so no decay overflows -- and the weights are dot products of r and
//     k scaled once per row (2.3x fewer ex2 at T = 32). Then y_local = A v
//     (2 rows x 4 columns a thread) and the state increment dS =
//     (k e^{L_T - L})^T v (4 x 4 entries a thread) stay in registers.
// (b) The carry, chained block to block. Blocks take their (chunk, head)
//     in the order they start, chunk-major, from an atomic counter, so the
//     block of chunk c - 1 of a head has always started before the block of
//     chunk c and no wait can deadlock. Block c waits until its head's
//     progress count reaches c (one thread polls with an acquire load),
//     copies S_{c-1} from the head's two-slot ring in a scratch
//     (ops._WKV_STATES, 2 hd x hd a head, L2-resident), writes S_c =
//     diag(e^{L_T}) S_{c-1} + dS into the other slot (the last chunk into
//     the final state), fences and releases progress c + 1 -- the chain's
//     link is one 16 KB read and one 16 KB write -- and only then adds
//     q S_{c-1} (q = r e^{Lx}) to its y_local and writes y once. The given
//     state enters at chunk 0 only. Chunk-major order lets link c follow
//     the blocks of chunk c as they finish, so the chain rides on phase (a)
//     instead of trailing it. The last block of the launch zeroes the
//     counters (ops._tickets, shared with the matmul and attention kernels).
// One launch rather than two: a second launch for the inter-chunk term
// would re-read every chunk's state and q from device memory. Handing all
// of a head's chunks to its last block instead (a ticket) made the carry
// and the inter-chunk term one block's serial walk over every chunk, which
// took most of the kernel's time from S = 256 up.
// The exponentials are ex2.approx of log2-scaled decays (relative error
// ~2^-22), far inside the tolerance. ref.wkv_chunkpar_ref mirrors this
// decomposition in plain PyTorch for the CPU tests.
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int T, int HD>
struct Wkv {
  static constexpr int P = HD + 4;  // padded row stride of the (., HD) tiles
  static constexpr int SUB = 8;     // rows of a sub-chunk
  static constexpr int NSUB = T / SUB;
  // k scaled to the end of each sub-chunk but the last: 8 + 16 + 24 rows
  static constexpr int KH_ROWS = SUB * NSUB * (NSUB - 1) / 2;
  // R, K, V (T rows), the log-decays (T + 1 rows: row 0 zero, row t + 1
  // the inclusive sum at t), the scaled k (KH_ROWS), A (T x T), u (HD);
  // then q = r e^{Lx} (T rows) and e^{L_T} (HD), which outlive the rest:
  // the incoming state S_{c-1} (HD x HD) takes the front once A v and dS
  // are done
  static constexpr int TILES = (4 * T + 1 + KH_ROWS) * P + T * T + HD;
  static constexpr int FLOATS = TILES + T * P + HD;
  static_assert(HD * HD <= TILES, "the incoming state fits the dead tiles");
  // channel splits of the pair tasks (quarters within a sub-chunk, halves
  // across sub-chunks), one task a thread
  static constexpr int CQ = HD / 4 < 4 ? HD / 4 : 4;
  static constexpr int CX = 2;
  static constexpr int INTRA = NSUB * 10 * CQ;      // 10 2x2 blocks a sub-chunk
  static constexpr int CROSS = 16 * NSUB * (NSUB - 1) / 2 * CX;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void axpy4(float a, float4 x, float4& acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// sum over four channels of r k e^{min(x - l, 0)}: one strict pair
__device__ __forceinline__ float pair4(float4 r, float4 k, float4 x, float4 l,
                                       float acc) {
  acc = fmaf(r.x * k.x, ex2(fminf(x.x - l.x, 0.0f)), acc);
  acc = fmaf(r.y * k.y, ex2(fminf(x.y - l.y, 0.0f)), acc);
  acc = fmaf(r.z * k.z, ex2(fminf(x.z - l.z, 0.0f)), acc);
  acc = fmaf(r.w * k.w, ex2(fminf(x.w - l.w, 0.0f)), acc);
  return acc;
}

// sum over four channels of r u k: the bonus on the diagonal
__device__ __forceinline__ float bonus4(float4 r, float4 u, float4 k,
                                        float acc) {
  acc = fmaf(r.x * u.x, k.x, acc);
  acc = fmaf(r.y * u.y, k.y, acc);
  acc = fmaf(r.z * u.z, k.z, acc);
  acc = fmaf(r.w * u.w, k.w, acc);
  return acc;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
  return acc;
}

__device__ __forceinline__ float4 scale4(float4 a, float4 x, float4 l) {
  return make_float4(a.x * ex2(fminf(x.x - l.x, 0.0f)),
                     a.y * ex2(fminf(x.y - l.y, 0.0f)),
                     a.z * ex2(fminf(x.z - l.z, 0.0f)),
                     a.w * ex2(fminf(x.w - l.w, 0.0f)));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
wkv_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ s_out,
                 float* __restrict__ states, int* __restrict__ tickets,
                 int B, int S, int H) {
  using W = Wkv<T, HD>;
  constexpr int P = W::P, HD4 = HD / 4, SUB = W::SUB;
  static_assert(W::INTRA <= THREADS && W::CROSS <= THREADS,
                "one pair task a thread");
  extern __shared__ __align__(16) float smem[];
  float* R = smem;                 // r, then r scaled (rows past SUB)
  float* Kt = R + T * P;           // k, then k e^{L_T - L}
  float* V = Kt + T * P;
  float* Lb = V + T * P;           // row 0 zero, row t + 1: L_t (log2 units)
  float* KH = Lb + (T + 1) * P;    // k scaled to each sub-chunk end
  float* A = KH + W::KH_ROWS * P;  // pair weights, the bonus on the diagonal
  float* U = A + T * T;
  float* Q = smem + W::TILES;      // q = r e^{Lx}
  float* E = Q + T * P;            // e^{L_T}
  float* Sin = smem;               // S_{c-1}, over the dead tiles
  __shared__ int id_s, last_s;

  // tickets: [0] the next block id, [1] blocks done, [2 + bh] the chunks of
  // head bh whose state is out
  const int tid = threadIdx.x;
  if (tid == 0) id_s = atomicAdd(tickets, 1);
  __syncthreads();
  const int BH = B * H, n = S / T;
  const int c = id_s / BH, bh = id_s % BH;   // chunk-major, in start order
  const int b = bh / H, h = bh % H;
  const size_t row = (size_t)H * HD;           // stride of one time step
  const size_t base = ((size_t)b * S + (size_t)c * T) * row + (size_t)h * HD;
  int* progress = tickets + 2 + bh;

  // ---- (a) the chunk on its own
  for (int idx = tid; idx < T * HD4; idx += THREADS) {  // all in flight
    const int t = idx / HD4, i = (idx % HD4) * 4;
    const size_t g = base + t * row + i;
    cp_async16(R + t * P + i, r + g);
    cp_async16(Kt + t * P + i, k + g);
    cp_async16(V + t * P + i, v + g);
    cp_async16(Lb + (t + 1) * P + i, lw + g);    // raw; scaled in the scan
  }
  cp_async_commit();
  for (int i = tid; i < HD; i += THREADS) {
    Lb[i] = 0.0f;
    U[i] = u[h * HD + i];
  }
  cp_async_wait<0>();
  __syncthreads();

  {  // inclusive cumulative sums of lw log2(e) down each channel, 32 / T
     // channels a warp at once
    constexpr int CPW = 32 / T, WARPS = THREADS / 32;
    constexpr int ROUNDS = (HD + WARPS * CPW - 1) / (WARPS * CPW);
    const int lane = tid % 32, warp = tid / 32, t = lane % T;
    float x[ROUNDS];
#pragma unroll
    for (int q = 0; q < ROUNDS; ++q) {
      const int i = (q * WARPS + warp) * CPW + lane / T;
      x[q] = i < HD ? Lb[(t + 1) * P + i] * LOG2E : 0.0f;
    }
#pragma unroll
    for (int d = 1; d < T; d *= 2) {
#pragma unroll
      for (int q = 0; q < ROUNDS; ++q) {
        const float o = __shfl_up_sync(0xffffffffu, x[q], d, T);
        if (t >= d) x[q] += o;
      }
    }
#pragma unroll
    for (int q = 0; q < ROUNDS; ++q) {
      const int i = (q * WARPS + warp) * CPW + lane / T;
      if (i < HD) Lb[(t + 1) * P + i] = x[q];
    }
  }
  __syncthreads();

  // Pair weights A[t][s], s <= t, by 2 x 2 blocks. Lx_t = L_{t-1} is row t
  // of Lb, L_s row s + 1. Within a sub-chunk of 8 rows (and on the
  // diagonal, with the bonus) one ex2 a pair and channel, a block's
  // channels split in CQ parts. Across sub-chunks the exponent factors
  // about the row b = 8 tau - 1 before t's sub-chunk tau:
  // e^{Lx_t - L_s} = e^{Lx_t - L_b} e^{L_b - L_s}, both exponents <= 0 (so
  // no overflow at any decay), and the weights are dot products of r and k
  // scaled once per row.
  {
    const int task = tid / W::CQ, part = tid % W::CQ;
    const bool live = tid < W::INTRA;
    const int sub = task / 10, lb = task % 10;
    const int tl = lb < 1 ? 0 : (lb < 3 ? 1 : (lb < 6 ? 2 : 3));
    const int sl = lb - tl * (tl + 1) / 2;
    const int t0 = sub * SUB + 2 * tl, s0_ = sub * SUB + 2 * sl;
    float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;
    if (live) {
      const float *r0 = R + t0 * P, *r1 = r0 + P;
      const float *x0 = Lb + t0 * P, *x1 = x0 + P;
      const float *k0 = Kt + s0_ * P, *k1 = k0 + P;
      const float *l0 = Lb + (s0_ + 1) * P, *l1 = l0 + P;
      constexpr int SPAN = HD / W::CQ;
      for (int i = part * SPAN; i < (part + 1) * SPAN; i += 4) {
        const float4 R0 = ld4(r0 + i), R1 = ld4(r1 + i);
        const float4 K0 = ld4(k0 + i), K1 = ld4(k1 + i);
        const float4 X1 = ld4(x1 + i), L0 = ld4(l0 + i);
        if (sl < tl) {
          const float4 X0 = ld4(x0 + i), L1 = ld4(l1 + i);
          a00 = pair4(R0, K0, X0, L0, a00);
          a01 = pair4(R0, K1, X0, L1, a01);
          a10 = pair4(R1, K0, X1, L0, a10);
          a11 = pair4(R1, K1, X1, L1, a11);
        } else {   // the diagonal block: (t0 + 1, t0) a pair, (t, t) bonus
          const float4 Ui = ld4(U + i);
          a00 = bonus4(R0, Ui, K0, a00);
          a10 = pair4(R1, K0, X1, L0, a10);
          a11 = bonus4(R1, Ui, K1, a11);
        }
      }
    }
#pragma unroll
    for (int d = 1; d < W::CQ; d *= 2) {    // the parts of one block add up
      a00 += __shfl_xor_sync(0xffffffffu, a00, d);
      a01 += __shfl_xor_sync(0xffffffffu, a01, d);
      a10 += __shfl_xor_sync(0xffffffffu, a10, d);
      a11 += __shfl_xor_sync(0xffffffffu, a11, d);
    }
    if (live && part == 0) {
      A[t0 * T + s0_] = a00;
      A[t0 * T + s0_ + 1] = a01;   // zero on a diagonal block (s > t)
      A[(t0 + 1) * T + s0_] = a10;
      A[(t0 + 1) * T + s0_ + 1] = a11;
    }
  }
  // q = r e^{Lx} and e^{L_T} for the carry
  for (int idx = tid; idx < T * HD4; idx += THREADS) {
    const int t = idx / HD4, i = (idx % HD4) * 4;
    const float4 rr = ld4(R + t * P + i), xx = ld4(Lb + t * P + i);
    st4(Q + t * P + i, make_float4(rr.x * ex2(xx.x), rr.y * ex2(xx.y),
                                   rr.z * ex2(xx.z), rr.w * ex2(xx.w)));
  }
  for (int i = tid; i < HD; i += THREADS) E[i] = ex2(Lb[T * P + i]);
  __syncthreads();

  // r scaled to its sub-chunk start (rows past the first sub-chunk), in
  // place; k scaled to the end of each earlier sub-chunk
  for (int idx = tid; idx < (T - SUB + W::KH_ROWS) * HD4; idx += THREADS) {
    const int rr = idx / HD4, i = (idx % HD4) * 4;
    if (rr < T - SUB) {
      const int t = SUB + rr, bl = (t / SUB) * SUB;  // Lb row of L_b
      st4(R + t * P + i, scale4(ld4(R + t * P + i), ld4(Lb + t * P + i),
                                ld4(Lb + bl * P + i)));
    } else {
      int s = rr - (T - SUB), tau = 1;
      while (s >= SUB * tau) s -= SUB * tau++;     // tile tau: rows 0..8 tau - 1
      const int off = SUB * tau * (tau - 1) / 2;
      st4(KH + (off + s) * P + i,
          scale4(ld4(Kt + s * P + i), ld4(Lb + SUB * tau * P + i),
                 ld4(Lb + (s + 1) * P + i)));
    }
  }
  __syncthreads();

  // cross-sub-chunk pairs: dot products, a block's channels in CX halves;
  // k e^{L_T - L} in place
  {
    const int task = tid / W::CX, part = tid % W::CX;
    const bool live = tid < W::CROSS;
    int blk = task, tau = 1;
    while (blk >= 16 * tau) blk -= 16 * tau++;
    const int t0 = SUB * tau + 2 * (blk / (4 * tau)), s0_ = 2 * (blk % (4 * tau));
    float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;
    if (live) {
      const float *r0 = R + t0 * P, *r1 = r0 + P;
      const float* k0 = KH + (SUB * tau * (tau - 1) / 2 + s0_) * P;
      const float* k1 = k0 + P;
      constexpr int SPAN = HD / W::CX;
#pragma unroll 4
      for (int i = part * SPAN; i < (part + 1) * SPAN; i += 4) {
        const float4 R0 = ld4(r0 + i), R1 = ld4(r1 + i);
        const float4 K0 = ld4(k0 + i), K1 = ld4(k1 + i);
        a00 = dot4(R0, K0, a00);
        a01 = dot4(R0, K1, a01);
        a10 = dot4(R1, K0, a10);
        a11 = dot4(R1, K1, a11);
      }
    }
#pragma unroll
    for (int d = 1; d < W::CX; d *= 2) {
      a00 += __shfl_xor_sync(0xffffffffu, a00, d);
      a01 += __shfl_xor_sync(0xffffffffu, a01, d);
      a10 += __shfl_xor_sync(0xffffffffu, a10, d);
      a11 += __shfl_xor_sync(0xffffffffu, a11, d);
    }
    if (live && part == 0) {
      A[t0 * T + s0_] = a00;
      A[t0 * T + s0_ + 1] = a01;
      A[(t0 + 1) * T + s0_] = a10;
      A[(t0 + 1) * T + s0_ + 1] = a11;
    }
  }
  for (int idx = tid; idx < T * HD4; idx += THREADS) {
    const int t = idx / HD4, i = (idx % HD4) * 4;
    const float4 kk = ld4(Kt + t * P + i), lT = ld4(Lb + T * P + i);
    const float4 lt = ld4(Lb + (t + 1) * P + i);
    st4(Kt + t * P + i, make_float4(kk.x * ex2(lT.x - lt.x),
                                    kk.y * ex2(lT.y - lt.y),
                                    kk.z * ex2(lT.z - lt.z),
                                    kk.w * ex2(lT.w - lt.w)));
  }
  __syncthreads();

  // y_local = A v (rows t, t + 1 by 4 columns a thread) and dS = (k
  // e^{L_T - L})^T v (4 x 4 entries a thread), both kept in registers
  constexpr int YI = (T / 2 * HD4 + THREADS - 1) / THREADS;
  float4 y0[YI], y1[YI];
#pragma unroll
  for (int q = 0; q < YI; ++q) {
    const int idx = tid + q * THREADS;
    y0[q] = y1[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (idx < T / 2 * HD4) {
      const int t = (idx / HD4) * 2, j = (idx % HD4) * 4;
#pragma unroll 4
      for (int s = 0; s <= t; ++s) {
        const float4 vv = ld4(V + s * P + j);
        axpy4(A[t * T + s], vv, y0[q]);
        axpy4(A[(t + 1) * T + s], vv, y1[q]);
      }
      axpy4(A[(t + 1) * T + t + 1], ld4(V + (t + 1) * P + j), y1[q]);
    }
  }
  constexpr int DI = (HD4 * HD4 + THREADS - 1) / THREADS;
  float4 ds[DI][4];
#pragma unroll
  for (int q = 0; q < DI; ++q) {
    const int idx = tid + q * THREADS;
#pragma unroll
    for (int a = 0; a < 4; ++a) ds[q][a] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (idx < HD4 * HD4) {
      const int i = (idx / HD4) * 4, j = (idx % HD4) * 4;
#pragma unroll 4
      for (int t = 0; t < T; ++t) {
        const float4 kk = ld4(Kt + t * P + i), vv = ld4(V + t * P + j);
        axpy4(kk.x, vv, ds[q][0]);
        axpy4(kk.y, vv, ds[q][1]);
        axpy4(kk.z, vv, ds[q][2]);
        axpy4(kk.w, vv, ds[q][3]);
      }
    }
  }
  __syncthreads();                 // the tiles are dead: S_{c-1} goes there

  // ---- (b) the carry: S_{c-1} from the block of chunk c - 1 of this head
  // (which started before this one), or the given state at c = 0
  if (c == 0) {
    for (int e = tid; e < HD * HD4; e += THREADS)
      st4(Sin + e * 4, s0 != nullptr ? ld4(s0 + (size_t)bh * HD * HD + e * 4)
                                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  } else {
    if (tid == 0) {
      while (ld_acquire(progress) < c) __nanosleep(100);
    }
    __syncthreads();
    const float* src = states + ((size_t)bh * 2 + ((c - 1) & 1)) * HD * HD;
    for (int e = tid; e < HD * HD4; e += THREADS)
      cp_async16(Sin + e * 4, src + e * 4);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  // S_c = diag(e^{L_T}) S_{c-1} + dS out first (the next chunk waits on
  // it): to slot c & 1 of the head's two, whose S_{c-2} chunk c - 1 has
  // read; the last chunk's to s_out
  float* dst = c == n - 1 ? s_out + (size_t)bh * HD * HD
                          : states + ((size_t)bh * 2 + (c & 1)) * HD * HD;
#pragma unroll
  for (int q = 0; q < DI; ++q) {
    const int idx = tid + q * THREADS;
    if (idx < HD4 * HD4) {
      const int i = (idx / HD4) * 4, j = (idx % HD4) * 4;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float d = E[i + a];
        const float4 sv = ld4(Sin + (i + a) * HD + j);
        st4(dst + (i + a) * HD + j,
            make_float4(fmaf(d, sv.x, ds[q][a].x), fmaf(d, sv.y, ds[q][a].y),
                        fmaf(d, sv.z, ds[q][a].z), fmaf(d, sv.w, ds[q][a].w)));
      }
    }
  }
  if (c < n - 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(progress, c + 1);
  }
  // y = y_local + q S_{c-1} (nothing to add at c = 0 from zero state)
  const bool carry_in = c > 0 || s0 != nullptr;
#pragma unroll
  for (int q = 0; q < YI; ++q) {
    const int idx = tid + q * THREADS;
    if (idx < T / 2 * HD4) {
      const int t = (idx / HD4) * 2, j = (idx % HD4) * 4;
      if (carry_in) {
#pragma unroll 4
        for (int i = 0; i < HD; i += 4) {
          const float4 q0 = ld4(Q + t * P + i), q1 = ld4(Q + (t + 1) * P + i);
          const float4 s_0 = ld4(Sin + i * HD + j), s_1 = ld4(Sin + (i + 1) * HD + j);
          const float4 s_2 = ld4(Sin + (i + 2) * HD + j), s_3 = ld4(Sin + (i + 3) * HD + j);
          axpy4(q0.x, s_0, y0[q]); axpy4(q0.y, s_1, y0[q]);
          axpy4(q0.z, s_2, y0[q]); axpy4(q0.w, s_3, y0[q]);
          axpy4(q1.x, s_0, y1[q]); axpy4(q1.y, s_1, y1[q]);
          axpy4(q1.z, s_2, y1[q]); axpy4(q1.w, s_3, y1[q]);
        }
      }
      st4(y + base + t * row + j, y0[q]);
      st4(y + base + (t + 1) * row + j, y1[q]);
    }
  }

  // the last block of the launch leaves the tickets zero
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(tickets + 1, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (last_s) {
    for (int i = tid; i < BH; i += THREADS) tickets[2 + i] = 0;
    if (tid == 0) tickets[0] = tickets[1] = 0;
  }
}

template <int T, int HD>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, float* y, float* s_out,
           float* states, int* tickets, int B, int S, int H,
           cudaStream_t stream) {
  constexpr int bytes = Wkv<T, HD>::FLOATS * sizeof(float);
  static bool attr_set = false;    // per instance, per process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv_chunk_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const long long blocks = (long long)B * H * (S / T);
  if (blocks < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  wkv_chunk_kernel<T, HD><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      r, k, v, lw, u, s0, y, s_out, states, tickets, B, S, H);
  return (int)cudaGetLastError();
}

template <int T>
int launch_hd(const float* r, const float* k, const float* v, const float* lw,
              const float* u, const float* s0, float* y, float* s_out,
              float* states, int* tickets, int B, int S, int H, int hd,
              cudaStream_t st) {
  switch (hd) {
#define WKV_HD(D) \
    case D: return launch<T, D>(r, k, v, lw, u, s0, y, s_out, states, tickets, B, S, H, st);
    WKV_HD(8) WKV_HD(16) WKV_HD(32) WKV_HD(64)
#undef WKV_HD
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int T, int HD>
const void* kernel_of() {
  return reinterpret_cast<const void*>(wkv_chunk_kernel<T, HD>);
}

}  // namespace

// r, k, v, lw, y: (B, S, H, hd) f32; u: (H, hd); s0 (or null for zero
// state), s_out: (B, H, hd, hd); all 16-byte aligned. `states` holds
// B * H * 2 * hd * hd floats (any contents), `tickets` B * H + 2 zeroed ints
// that the launch leaves zero. S % chunk == 0, chunk in {16, 32}, hd in
// {8, 16, 32, 64}; the wrapper checks all of it. Returns the cudaError_t.
extern "C" int wkv(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, const void* s0, void* y,
                   void* s_out, void* states, void* tickets, int B, int S,
                   int H, int hd, int chunk, void* stream) {
  const float *rf = (const float*)r, *kf = (const float*)k,
              *vf = (const float*)v, *lf = (const float*)lw,
              *uf = (const float*)u, *sf = (const float*)s0;
  float *yf = (float*)y, *of = (float*)s_out, *scr = (float*)states;
  int* tk = (int*)tickets;
  cudaStream_t st = (cudaStream_t)stream;
  if (chunk == 16)
    return launch_hd<16>(rf, kf, vf, lf, uf, sf, yf, of, scr, tk, B, S, H, hd, st);
  if (chunk == 32)
    return launch_hd<32>(rf, kf, vf, lf, uf, sf, yf, of, scr, tk, B, S, H, hd, st);
  return (int)cudaErrorInvalidValue;
}

// Registers, shared bytes (static + dynamic), resident blocks per SM and
// local (spill) bytes per thread of the instance (chunk, hd), into `info`.
extern "C" int wkv_occupancy(int chunk, int hd, void* info) {
  int* o = static_cast<int*>(info);
  const void* fn = nullptr;
  size_t dyn = 0;
#define WKV_CASE(T, D)                                  \
  if (chunk == T && hd == D) {                          \
    fn = kernel_of<T, D>();                             \
    dyn = Wkv<T, D>::FLOATS * sizeof(float);            \
  }
  WKV_CASE(16, 8) WKV_CASE(16, 16) WKV_CASE(16, 32) WKV_CASE(16, 64)
  WKV_CASE(32, 8) WKV_CASE(32, 16) WKV_CASE(32, 32) WKV_CASE(32, 64)
#undef WKV_CASE
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dyn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, dyn);
  if (e != cudaSuccess) return (int)e;
  o[0] = a.numRegs;
  o[1] = (int)(a.sharedSizeBytes + dyn);
  o[2] = blocks;
  o[3] = (int)a.localSizeBytes;
  return 0;
}
