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
// operations over the float32 rate bound it: full float32 FFMA on the CUDA
// cores (TF32 would need a parity contract of its own; the rtol 2e-5
// contract holds only in float32). The first port of this kernel reached
// 30% of that bound: its inner loops read one shared word per 2 (QK) or
// 2.7 (PV) FMAs, and an SM issues about one warp-wide shared load per
// clock against four warp-wide FFMAs; K and V were copied synchronously
// into one buffer; and each of the G query heads of a GQA group read the
// same K/V tiles again.
//
// Design:
// - One block per (b, kv head, pair of query heads, 64-position q tile):
//   the block's R = 64 * GB query rows (GB = 2 when G is even) share each
//   K/V tile, so a tile is read from device memory G / GB times per group
//   instead of G times. When G is odd (hubert-xlarge's G = 1) a block takes
//   one query head over a 128-position q tile instead (QT = 128, when
//   S % 128 == 0): the same R = 128 rows, register blocking and shared
//   memory as two heads, where 64 rows would halve the FMAs per shared
//   read. 256 threads as 16 x 16 (ty, tx).
// - Register blocking with 16-byte shared reads. Thread (ty, tx) owns rows
//   ty * TM .. + TM - 1 (TM = R / 16: 8 or 4), logit columns tx + 16 j
//   (j < 4) and output columns in float4 chunks tx + 16 c (a float2 at
//   hd = 32). Q, K and V sit row-major in shared memory with the float4
//   chunk index XOR-swizzled (Q rows by thread row, K and V rows by
//   row & 7), so that the rows a warp reads in one instruction fall in
//   distinct banks and a thread's addresses cost one XOR per chunk. QK: per
//   four dimensions, TM + 4 float4 reads for 16 * TM FMAs (8 per 16-byte
//   read at TM = 8). P goes to shared memory column-major (its rows
//   contiguous) and is read back by the half-warp that wrote it; PV: per kv
//   row, TM / 4 + HD / 64 float4 reads for TM * HD / 16 FMAs (16 per read
//   at TM = 8, hd = 128).
// - Two K and two V buffers, filled with 16-byte cp.async one tile ahead:
//   tile t + 1's K and V are in flight during all of tile t, and one block
//   barrier a tile guards both buffers and P (one buffer each needed four).
//   230,400 B of shared memory at hd = 128 with two heads: one block an SM.
// - Causal scheduling: blockIdx.y walks the q tiles last first, so the
//   blocks with the most unmasked kv tiles start first and the last wave is
//   short. Tiles wholly under the causal or window mask are skipped; the
//   mask is evaluated only on tiles that cross the diagonal or the window's
//   edge.
// - expf / logf as before: the exponentials are 32 per thread and tile
//   against 8192 FMAs, so exp2f with log2(e) folded in would save nothing
//   measurable.
// - hd = 256 (recurrentgemma's local attention): one query head per block
//   and 32-row K/V tiles, so Q, the two K and two V buffers and P take
//   205,312 B; 64-row tiles would take 345,088 B and two heads more, over
//   the 227 KB a block may hold. A thread then holds 4 rows x 16 output
//   columns and 4 x 2 logits; the swizzle and the output chunks tx + 16 c
//   (c < 4) are those of hd = 128, twice over.
// - hd = 80 (hubert-xlarge's 1280 / 16): 20 float4 chunks a row, which the
//   XOR swizzle (a permutation of each group of 8 chunks) would carry past
//   the row's end (chunks 16-19 onto 16-23). Rows are stored at a pitch of
//   PITCH = 96 floats (24 chunks, three whole swizzle groups; the pad is
//   never read or stored), which keeps every row on bank 0 as at hd 128.
//   A thread's output columns are the float4 chunk tx (columns 0-63) and
//   one more column, 64 + tx (TAIL = 1): 5 of the 80 columns for each of
//   the 16 threads of a row, none idle. 181,248 B of shared memory at 128
//   query rows a block (two heads, or one over 128 positions), 140,288 B
//   at 64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;   // q positions per block (QT = 2 BQ: one head, odd G)
constexpr float NEG_INF = -1e30f;

template <int HD, int GB, int QT = BQ>
struct Shape {
  // kv rows per loop step: 32 at hd = 256, where 64 would not fit
  static constexpr int BKV = HD >= 256 ? 32 : 64;
  static constexpr int NJ = BKV / 16;    // logit columns per thread
  static constexpr int R = QT * GB;      // query rows per block
  static constexpr int TM = R / 16;      // rows per thread
  static constexpr int CH = HD / 4;      // float4 chunks per row
  // shared-memory row pitch in floats: whole groups of 8 swizzled chunks
  static constexpr int PITCH = (CH + 7) / 8 * 32;
  // output columns per thread: OC vectors of OV floats (float4 chunks
  // tx + 16 c; at hd = 32 one float2, columns 2 tx and 2 tx + 1), then
  // TAIL single columns 64 OC + tx + 16 t (hd = 80: column 64 + tx)
  static constexpr int OC = HD >= 64 ? HD / 64 : 1;
  static constexpr int OV = HD >= 64 ? 4 : 2;
  static constexpr int TAIL = HD >= 64 ? HD % 64 / 16 : 0;
  static constexpr int PP = R + 4;       // P pitch in floats
  // Q, two K and two V buffers, P
  static constexpr int SMEM = (R * PITCH + 4 * BKV * PITCH + BKV * PP) * 4;
};

// Float offset of float4 chunk `ch` of row `r` in a row-major tile whose
// chunk index is XOR-swizzled by `s` (0..7). Q rows swizzle by their
// thread row (r / TM: the two thread rows of a warp read distinct banks),
// K and V rows by r & 7 (the 8 rows that 8 lanes read at once read
// distinct banks); either way a thread's swizzle is one value for all the
// rows it reads at one chunk, so an address costs one XOR per chunk.
// Rows lie PITCH floats apart (a multiple of 32 floats: whole groups of 8
// chunks), so the XOR keeps a chunk inside its row.
template <int PITCH>
__device__ __forceinline__ int at(int r, int ch, int s) {
  return r * PITCH + ((ch ^ s) << 2);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// one K or V tile: BKV rows of HD floats, row stride `stride` in device
// memory, PITCH in shared memory
template <int HD, int PITCH, int BKV>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t stride) {
  constexpr int CH = HD / 4;
  for (int idx = threadIdx.x; idx < BKV * CH; idx += THREADS) {
    const int r = idx / CH, ch = idx % CH;
    cp_async16(dst + at<PITCH>(r, ch, r & 7),
               src + (size_t)r * stride + ch * 4);
  }
}

template <int HD, int GB, int QT>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int S, int KV, int G, int causal,
                 int window) {
  using P = Shape<HD, GB, QT>;
  constexpr int R = P::R, TM = P::TM, CH = P::CH, OC = P::OC, OV = P::OV;
  constexpr int PP = P::PP, BKV = P::BKV, NJ = P::NJ, TAIL = P::TAIL;
  constexpr int PITCH = P::PITCH;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // R x PITCH, swizzled
  float* ks0 = qs + R * PITCH;         // two K buffers, BKV x PITCH, swizzled
  float* vs0 = ks0 + 2 * BKV * PITCH;  // two V buffers
  float* ps = vs0 + 2 * BKV * PITCH;   // BKV x PP: p[row r][kv c] at c * PP + r

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_q = gridDim.y;
  const int qt = n_q - 1 - blockIdx.y;   // the largest causal work first
  const int q0 = qt * QT;
  const int hg = blockIdx.x;             // ((b * KV + h) * G / GB + gp)
  const int n_gp = G / GB;
  const int gbase = (hg % n_gp) * GB;
  const int h = (hg / n_gp) % KV;
  const int b = hg / (n_gp * KV);
  const size_t q_stride = (size_t)KV * G * HD;   // between sequence rows
  const size_t kv_stride = (size_t)KV * HD;
  const float* kb = k + ((size_t)b * S * KV + h) * HD;
  const float* vb = v + ((size_t)b * S * KV + h) * HD;

  const int n_kv = S / BKV;
  int kt_hi = n_kv - 1;
  if (causal) kt_hi = min(kt_hi, (q0 + QT - 1) / BKV);
  int kt_lo = 0;
  if (window > 0) {  // the first kv position any row of the tile attends
    const int first = q0 - window + 1;
    kt_lo = first > 0 ? first / BKV : 0;
  }

  // prologue: Q and the first K and V tiles
  for (int idx = tid; idx < R * CH; idx += THREADS) {
    const int r = idx / CH, ch = idx % CH;
    const float* src = q + (((size_t)b * S + q0 + r % QT) * KV + h) * G * HD +
                       (size_t)(gbase + r / QT) * HD + ch * 4;
    cp_async16(qs + at<PITCH>(r, ch, (r / TM) & 7), src);
  }
  load_tile<HD, PITCH, BKV>(ks0, kb + (size_t)kt_lo * BKV * kv_stride,
                            kv_stride);
  load_tile<HD, PITCH, BKV>(vs0, vb + (size_t)kt_lo * BKV * kv_stride,
                            kv_stride);
  cp_async_commit();

  // (TAIL + 1: a zero-length array is not C++)
  float m[TM], l[TM], o[TM][OC][OV], ot[TM][TAIL + 1];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OC; ++c)
#pragma unroll
      for (int e = 0; e < OV; ++e) o[i][c][e] = 0.0f;
#pragma unroll
    for (int t = 0; t < TAIL; ++t) ot[i][t] = 0.0f;
  }
  const float* qrow = qs + ty * TM * PITCH;  // this thread's rows, swizzle sq
  const int sq = ty & 7;
  const int sk = tx & 7;                   // rows tx + 16 j of a K tile

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BKV;
    const int buf = (kt - kt_lo) & 1;
    const float* ks = ks0 + buf * BKV * PITCH;
    const float* vs = vs0 + buf * BKV * PITCH;
    cp_async_wait_all();
    // K and V of this tile landed for every thread, and every thread is
    // done with the other buffers (the previous tile) and with P
    __syncthreads();
    if (kt < kt_hi) {
      load_tile<HD, PITCH, BKV>(ks0 + (buf ^ 1) * BKV * PITCH,
                                kb + (size_t)(kt + 1) * BKV * kv_stride,
                                kv_stride);
      load_tile<HD, PITCH, BKV>(vs0 + (buf ^ 1) * BKV * PITCH,
                                vb + (size_t)(kt + 1) * BKV * kv_stride,
                                kv_stride);
    }
    cp_async_commit();

    // ---- S = Q K^T for rows ty * TM + i, columns tx + 16 j
    float s[TM][NJ];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.0f;
    const float* krow = ks + tx * PITCH;
#pragma unroll 4
    for (int ch = 0; ch < CH; ++ch) {
      const int oq = (ch ^ sq) << 2, ok = (ch ^ sk) << 2;
      float4 a[TM], kk[NJ];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = lds4(qrow + i * PITCH + oq);
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = lds4(krow + 16 * j * PITCH + ok);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(a[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, kk[j].w, s[i][j]);
        }
    }

    // ---- mask (only on tiles that cross the diagonal or the window edge),
    // online softmax, p to shared memory
    const bool masked = (causal && k0 + BKV - 1 > q0) ||
                        (window > 0 && q0 + QT - 1 - k0 >= window);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (masked) {
        const int qpos = q0 + (ty * TM + i) % QT;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const bool valid = (!causal || kpos <= qpos) &&
                             (window <= 0 || qpos - kpos < window);
          s[i][j] += valid ? 0.0f : NEG_INF;
        }
      }
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < NJ; ++j) mx = fmaxf(mx, s[i][j]);
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      rs = row_sum16(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c)
#pragma unroll
        for (int e = 0; e < OV; ++e) o[i][c][e] *= alpha;
#pragma unroll
      for (int t = 0; t < TAIL; ++t) ot[i][t] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i4 = 0; i4 < TM / 4; ++i4)
        *reinterpret_cast<float4*>(ps + (tx + 16 * j) * PP + ty * TM + 4 * i4) =
            make_float4(s[4 * i4][j], s[4 * i4 + 1][j], s[4 * i4 + 2][j],
                        s[4 * i4 + 3][j]);
    __syncwarp();   // P's rows are written and read by one half-warp

    // ---- O += P V for rows ty * TM + i, columns in chunks tx + 16 c;
    // V row c sits swizzled by c & 7 = e, static in the unrolled loop
    for (int c8 = 0; c8 < BKV; c8 += 8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = c8 + e;
        float pr[TM];
#pragma unroll
        for (int i4 = 0; i4 < TM / 4; ++i4) {
          const float4 p4 = lds4(ps + c * PP + ty * TM + 4 * i4);
          pr[4 * i4] = p4.x;
          pr[4 * i4 + 1] = p4.y;
          pr[4 * i4 + 2] = p4.z;
          pr[4 * i4 + 3] = p4.w;
        }
#pragma unroll
        for (int cc = 0; cc < OC; ++cc) {
          float vv[OV];
          if constexpr (OV == 4) {
            const float4 t = lds4(vs + c * PITCH + (((tx ^ e) + 16 * cc) << 2));
            vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(
                vs + c * PITCH + (((tx >> 1) ^ e) << 2) + 2 * (tx & 1));
            vv[0] = t.x; vv[1] = t.y;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int u = 0; u < OV; ++u)
              o[i][cc][u] = fmaf(pr[i], vv[u], o[i][cc][u]);
        }
        // column 64 OC + tx + 16 t: float (tx & 3) of chunk 16 OC + 4 t +
        // tx / 4, stored at that chunk XOR e
#pragma unroll
        for (int t = 0; t < TAIL; ++t) {
          const float vt =
              vs[c * PITCH + (((16 * OC + 4 * t + (tx >> 2)) ^ e) << 2) +
                 (tx & 3)];
#pragma unroll
          for (int i = 0; i < TM; ++i) ot[i][t] = fmaf(pr[i], vt, ot[i][t]);
        }
      }
    }
  }
  cp_async_wait_all();                // (only an empty group remains)

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const int g = gbase + r / QT;
    const int pos = q0 + r % QT;
    const float lf = fmaxf(l[i], 1e-30f);
    float* orow = out + ((size_t)b * S + pos) * q_stride + ((size_t)h * G + g) * HD;
#pragma unroll
    for (int cc = 0; cc < OC; ++cc) {
      if constexpr (OV == 4)
        *reinterpret_cast<float4*>(orow + 4 * (tx + 16 * cc)) =
            make_float4(o[i][cc][0] / lf, o[i][cc][1] / lf, o[i][cc][2] / lf,
                        o[i][cc][3] / lf);
      else
        *reinterpret_cast<float2*>(orow + 2 * tx) =
            make_float2(o[i][cc][0] / lf, o[i][cc][1] / lf);
    }
#pragma unroll
    for (int t = 0; t < TAIL; ++t) orow[64 * OC + tx + 16 * t] = ot[i][t] / lf;
    if (tx == 0)
      lse[(((size_t)b * KV + h) * G + g) * S + pos] = m[i] + logf(lf);
  }
}

template <int HD, int GB, int QT>
int launch(const float* q, const float* k, const float* v, float* out,
           float* lse, int B, int S, int KV, int G, int causal, int window,
           cudaStream_t stream) {
  constexpr int bytes = Shape<HD, GB, QT>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, GB, QT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B * KV * (G / GB), S / QT);
  flash_fwd_kernel<HD, GB, QT><<<grid, THREADS, bytes, stream>>>(
      q, k, v, out, lse, S, KV, G, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// GB query heads of QT positions per block (GB = 2, QT = 64 or GB = 1,
// QT = 128 or 64); hd 256 takes one head of 64 positions at any G
template <int GB, int QT>
int launch_hd(const float* q, const float* k, const float* v, float* out,
              float* lse, int B, int S, int KV, int G, int hd, int causal,
              int window, cudaStream_t st) {
  switch (hd) {
    case 256:   // one query head per block at any G (shared memory)
      return launch<256, 1, BQ>(q, k, v, out, lse, B, S, KV, G, causal,
                                window, st);
    case 32:
      return launch<32, GB, QT>(q, k, v, out, lse, B, S, KV, G, causal,
                                window, st);
    case 64:
      return launch<64, GB, QT>(q, k, v, out, lse, B, S, KV, G, causal,
                                window, st);
    case 80:
      return launch<80, GB, QT>(q, k, v, out, lse, B, S, KV, G, causal,
                                window, st);
    case 128:
      return launch<128, GB, QT>(q, k, v, out, lse, B, S, KV, G, causal,
                                 window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: (B, S, KV, G, hd) f32; k, v: (B, S, KV, hd) f32; lse: (B, KV, G, S)
// f32. S % 64 == 0, hd in {32, 64, 80, 128, 256}, 16-byte aligned rows; window <= 0
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
  if (S % BQ != 0 || S / BQ > 65535 || B * KV * G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G % 2 == 0)
    return launch_hd<2, BQ>(qf, kf, vf, of, lf, B, S, KV, G, hd, causal,
                            window, st);
  if (S % (2 * BQ) == 0)
    return launch_hd<1, 2 * BQ>(qf, kf, vf, of, lf, B, S, KV, G, hd, causal,
                                window, st);
  return launch_hd<1, BQ>(qf, kf, vf, of, lf, B, S, KV, G, hd, causal,
                          window, st);
}

// Registers, dynamic shared memory and resident blocks per SM of the
// instance for head dim `hd`, `gb` query heads per block and `qt` q
// positions per block, from the runtime. Writes four ints to `info`:
// registers, shared bytes, blocks per SM, local (spill) bytes per thread.
extern "C" int flash_fwd_occupancy(int hd, int gb, int qt, void* info) {
  int* o = static_cast<int*>(info);
  const void* fn = nullptr;
  int bytes = 0;
  switch ((hd * 10 + gb) * 1000 + qt) {
#define FA_CASE(HD, GB, QT)                                              \
  case (HD * 10 + GB) * 1000 + QT:                                       \
    fn = reinterpret_cast<const void*>(flash_fwd_kernel<HD, GB, QT>);    \
    bytes = Shape<HD, GB, QT>::SMEM;                                     \
    break;
    FA_CASE(32, 1, 64) FA_CASE(32, 1, 128) FA_CASE(32, 2, 64)
    FA_CASE(64, 1, 64) FA_CASE(64, 1, 128) FA_CASE(64, 2, 64)
    FA_CASE(80, 1, 64) FA_CASE(80, 1, 128) FA_CASE(80, 2, 64)
    FA_CASE(128, 1, 64) FA_CASE(128, 1, 128) FA_CASE(128, 2, 64)
    FA_CASE(256, 1, 64)
#undef FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS,
                                                    bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  o[0] = a.numRegs;
  o[1] = static_cast<int>(a.sharedSizeBytes) + bytes;
  o[2] = blocks;
  o[3] = static_cast<int>(a.localSizeBytes);
  return 0;
}
