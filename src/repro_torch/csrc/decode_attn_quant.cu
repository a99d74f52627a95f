// GQA decode attention straight on the int8 KV cache: one query per slot on
// the ring layout (decode_attn_quant) and the paged layout
// (decode_attn_quant_paged), and S queries per slot, each at its own
// position, for the speculative verify pass (verify_attn_quant,
// verify_attn_quant_paged).
//
// Replaces the TPU kernels src/repro/kernels/quant_attention.py:_qdec_kernel
// (decode_attn_quant) and :_qdec_paged_kernel (decode_attn_quant_paged), and
// the verify functions of the same file (verify_attn_quant,
// verify_attn_quant_paged), which unroll S one-token launches.
//
// What it computes, per slot b and query head (kv head h, group row g):
//   logit[s] = (q . k_codes[b, s, h]) * k_scale[b, s, h]
//              + (0 <= pos[b, s] <= q_pos[b] [and q_pos - pos < window]
//                 ? 0 : -1e30)
//   out      = sum_s (p[s] * v_scale[b, s, h]) * v_codes[b, s, h] / max(l, 1e-30)
// with p the online-softmax probabilities and l their sum. q arrives
// pre-scaled by hd^-0.5 (the wrapper does it, as the TPU wrapper did). Scales
// multiply, never divide, so an all-zero row gives exactly 0. Slots carry
// absolute positions, so ring wraparound needs no special case and evicted
// or empty slots (pos = -1) are masked wherever they sit.
//
// What bounds it on an H100: every call reads the whole cache of codes and
// scales once (2 * B * Sc * KV * (hd + 4) bytes) and does 4 * B * H * Sc * hd
// float operations: bytes over 3.35 TB/s bound it by far.
//
// Design (simple and right first; splitting Sc across blocks is later work):
// one block of 256 threads per (slot, kv head) holds the G query rows that
// share the head, so each K/V row is read once per group. A loop over Sc in
// tiles of 64 positions takes the place of the TPU's sequential grid
// dimension. Per tile: each warp dots 8 key rows against the G queries (a
// lane takes 4 bytes of the row, a 128-byte coalesced load per row, then a
// shuffle reduction); one warp per query row runs the online-softmax update
// in f32 registers and stores p * v_scale in shared memory; then each thread
// owns one head dimension and half of the tile's positions and accumulates
// sum p * v_scale * v_code in registers. The two halves combine at the end.
//
// Verify (S queries per slot): a second grid dimension over the query
// index j. Block (slot, kv head, j) loads query row j and its position
// q_pos[b, j] and runs the one-token block's code unchanged, so query j is
// bit for bit one one-token launch at q_pos[:, j] (the TPU wrapper unrolled
// S launches to keep that equality; here it is one launch of S * B * KV
// blocks). Rows written for later queries mask out by position. What bounds
// it: the cache bytes, read once; the S blocks of a head each read it, the
// later ones mostly from L2. A kernel that reads each row once for all S
// queries is later work.
//
// Paged layout: codes (n_pages, ps, KV, hd), scales (n_pages, ps, KV) and
// positions (n_pages, ps) are pooled across slots; slot b's position t lives
// in page page_table[b, t / ps], row t % ps (-1 = unmapped). The block loads
// its slot's table row into shared memory once (the TPU kernel prefetched it
// as a scalar operand) and resolves each of the P * ps logical rows through
// it; everything else is the ring kernel's code, instantiated from the same
// template. An unmapped entry reads page 0 and masks the row, exactly as the
// dense view of PagedKVCache.gather() holds page 0's rows there with pos -1,
// so on every row the paged kernel computes what the ring kernel computes on
// the gathered view, in the same order: the two agree bit for bit. What bounds
// it: the mapped pages' codes and scales, read once, over 3.35 TB/s; pages
// shared by several slots are read once per slot.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;          // cache positions per loop step
constexpr int MAX_G = 8;          // query rows per kv head
constexpr int MAX_HD = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The cache row of slot b's logical position s: an index into the (rows, KV,
// hd) codes, the (rows, KV) scales and the (rows,) positions. The ring holds
// row b * Sc + s; the paged layout row page * ps + s % ps, with page the
// slot's table entry (page 0 where unmapped, and *mapped false).
template <bool PAGED>
__device__ __forceinline__ size_t kv_row(int b, int s, int Sc, const int* tbl,
                                         int ps, bool* mapped) {
  if (PAGED) {
    const int e = tbl[s / ps];
    *mapped = e >= 0;
    return (size_t)max(e, 0) * ps + s % ps;
  }
  *mapped = true;
  return (size_t)b * Sc + s;
}

// Ring: codes (B, Sc, KV, hd), scales (B, Sc, KV), pos (B, Sc), no table.
// Paged: codes (n_pages, ps, KV, hd), scales (n_pages, ps, KV), pos
// (n_pages, ps), table (B, P) and Sc = P * ps logical rows per slot.
template <bool PAGED>
__global__ void __launch_bounds__(THREADS)
decode_attn_quant_kernel(const float* __restrict__ q,      // (B, S, KV, G, hd)
                         const int8_t* __restrict__ kc,
                         const float* __restrict__ ks,
                         const int8_t* __restrict__ vc,
                         const float* __restrict__ vs,
                         const int* __restrict__ pos,
                         const int* __restrict__ qpos,     // (B, S)
                         const int* __restrict__ table,    // (B, P) or null
                         float* __restrict__ out,          // (B, S, KV, G, hd)
                         int S, int Sc, int KV, int G, int hd, int window,
                         int P, int ps) {
  extern __shared__ int tbl[];                            // (P,) when PAGED
  __shared__ float qs[MAX_G][MAX_HD];
  __shared__ float logit[MAX_G][TILE];
  __shared__ float pvs[MAX_G][TILE];
  __shared__ float vscale[TILE];
  __shared__ float m_s[MAX_G], l_s[MAX_G], alpha_s[MAX_G];
  __shared__ float part[MAX_G][MAX_HD];

  const int bh = blockIdx.x;            // b * KV + h
  const int b = bh / KV;
  const int h = bh % KV;
  const int j = blockIdx.y;             // query index within the slot
  const size_t qrow = ((size_t)(b * S + j) * KV + h) * G * hd;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qp = qpos[b * S + j];

  for (int i = tid; i < G * hd; i += THREADS)
    qs[i / hd][i % hd] = q[qrow + i];
  if (PAGED)
    for (int i = tid; i < P; i += THREADS) tbl[i] = table[(size_t)b * P + i];
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  // PV ownership: dimension d (and d + 128 when hd > 128), positions of one
  // parity within each tile
  const int d0 = tid % 128;
  const int half = tid / 128;
  float acc[MAX_G][2];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g][0] = acc[g][1] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < Sc; t0 += TILE) {
    // ---- logits: warp w takes positions w, w + WARPS, ... of the tile
    for (int t = warp; t < TILE; t += WARPS) {
      const int s = t0 + t;
      float dot[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) dot[g] = 0.f;
      bool mapped = false;
      const size_t r = s < Sc ? kv_row<PAGED>(b, s, Sc, tbl, ps, &mapped) : 0;
      if (s < Sc) {
        const int8_t* row = kc + (r * KV + h) * hd;
        for (int d = lane * 4; d < hd; d += 128) {
          const char4 c = *reinterpret_cast<const char4*>(row + d);
          const float c0 = c.x, c1 = c.y, c2 = c.z, c3 = c.w;
#pragma unroll
          for (int g = 0; g < MAX_G; ++g) {
            if (g < G)
              dot[g] += qs[g][d] * c0 + qs[g][d + 1] * c1 + qs[g][d + 2] * c2 +
                        qs[g][d + 3] * c3;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) dot[g] = warp_sum(dot[g]);
      if (lane == 0) {
        if (s < Sc) {
          const int p = pos[r];
          bool valid = mapped && p >= 0 && p <= qp;
          if (window > 0) valid = valid && (qp - p < window);
          const float bias = valid ? 0.f : NEG_INF;
          const float kscale = ks[r * KV + h];
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) logit[g][t] = dot[g] * kscale + bias;
          vscale[t] = vs[r * KV + h];
        } else {  // past the end of the cache: contributes nothing
          for (int g = 0; g < G; ++g) logit[g][t] = -INFINITY;
          vscale[t] = 0.f;
        }
      }
    }
    __syncthreads();

    // ---- online softmax: warp g owns query row g
    for (int g = warp; g < G; g += WARPS) {
      const float a = logit[g][lane];
      const float c = logit[g][lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new);
      const float pc = expf(c - m_new);
      const float psum = warp_sum(pa + pc);
      pvs[g][lane] = pa * vscale[lane];
      pvs[g][lane + 32] = pc * vscale[lane + 32];
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // ---- PV on the codes, V-scale riding on p
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        acc[g][0] *= alpha_s[g];
        acc[g][1] *= alpha_s[g];
      }
    }
    const int tend = min(TILE, Sc - t0);
    for (int t = half; t < tend; t += 2) {
      bool mapped;
      const size_t r = kv_row<PAGED>(b, t0 + t, Sc, tbl, ps, &mapped);
      const int8_t* row = vc + (r * KV + h) * hd;
      const float v0 = d0 < hd ? static_cast<float>(row[d0]) : 0.f;
      const float v1 = d0 + 128 < hd ? static_cast<float>(row[d0 + 128]) : 0.f;
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          acc[g][0] += pvs[g][t] * v0;
          acc[g][1] += pvs[g][t] * v1;
        }
      }
    }
    __syncthreads();
  }

  // ---- combine the two position halves and normalise
  if (half == 1) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G && d0 < hd) part[g][d0] = acc[g][0];
      if (g < G && d0 + 128 < hd) part[g][d0 + 128] = acc[g][1];
    }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) continue;
      const float l = fmaxf(l_s[g], 1e-30f);
      float* o = out + qrow + (size_t)g * hd;
      if (d0 < hd) o[d0] = (acc[g][0] + part[g][d0]) / l;
      if (d0 + 128 < hd) o[d0 + 128] = (acc[g][1] + part[g][d0 + 128]) / l;
    }
  }
}

}  // namespace

// Shapes as in the comments of the kernel's arguments; G <= 8, hd <= 256,
// hd % 4 == 0 and S <= 65535 (the wrapper checks). window <= 0 means no
// window. The one-token entry points are the S = 1 launch of the verify
// ones: one compiled kernel serves both.
extern "C" int verify_attn_quant(const void* q, const void* kc, const void* ks,
                                 const void* vc, const void* vs,
                                 const void* pos, const void* qpos, void* out,
                                 int B, int S, int Sc, int KV, int G, int hd,
                                 int window, void* stream) {
  decode_attn_quant_kernel<false><<<dim3(B * KV, S), THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<const int*>(qpos), nullptr, static_cast<float*>(out), S,
      Sc, KV, G, hd, window, 0, 1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_attn_quant(const void* q, const void* kc, const void* ks,
                                 const void* vc, const void* vs,
                                 const void* pos, const void* qpos, void* out,
                                 int B, int Sc, int KV, int G, int hd,
                                 int window, void* stream) {
  return verify_attn_quant(q, kc, ks, vc, vs, pos, qpos, out, B, 1, Sc, KV, G,
                           hd, window, stream);
}

// Paged layout: pages (n_pages, ps, KV, hd), table (B, P); the wrapper keeps
// P * 4 bytes of table within the 48 KB a block may take without opting in.
extern "C" int verify_attn_quant_paged(const void* q, const void* kc,
                                       const void* ks, const void* vc,
                                       const void* vs, const void* pos,
                                       const void* table, const void* qpos,
                                       void* out, int B, int S, int P, int ps,
                                       int KV, int G, int hd, int window,
                                       void* stream) {
  decode_attn_quant_kernel<true><<<dim3(B * KV, S), THREADS, P * sizeof(int),
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<const int*>(qpos), static_cast<const int*>(table),
      static_cast<float*>(out), S, P * ps, KV, G, hd, window, P, ps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int decode_attn_quant_paged(const void* q, const void* kc,
                                       const void* ks, const void* vc,
                                       const void* vs, const void* pos,
                                       const void* table, const void* qpos,
                                       void* out, int B, int P, int ps, int KV,
                                       int G, int hd, int window,
                                       void* stream) {
  return verify_attn_quant_paged(q, kc, ks, vc, vs, pos, table, qpos, out, B,
                                 1, P, ps, KV, G, hd, window, stream);
}
