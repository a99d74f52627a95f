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
//   logit[s] = (q * hd^-0.5 . k_codes[b, s, h]) * k_scale[b, s, h]
//              + (0 <= pos[b, s] <= q_pos[b] [and q_pos - pos < window]
//                 ? 0 : -1e30)
//   out      = sum_s (p[s] * v_scale[b, s, h]) * v_codes[b, s, h] / max(l, 1e-30)
// with p the softmax probabilities and l their sum. The kernel multiplies q
// by the scale it is given (hd^-0.5) as it loads it: one float32 multiply of
// the same operands as the TPU wrapper's pre-scale, so the same bits. Scales
// multiply, never divide, so an all-zero row gives exactly 0. Slots carry
// absolute positions, so ring wraparound needs no special case and evicted
// or empty slots (pos = -1) are masked wherever they sit.
//
// What bounds it on an H100: every call reads the whole cache of codes and
// scales once (2 * B * Sc * KV * (hd + 4) bytes) and does 4 * B * H * Sc * hd
// float operations: bytes over 3.35 TB/s bound it by far. At the serve shape
// that is under a microsecond, so what a launch costs is latency: how many
// trips to device memory a block waits for, and how many blocks share them.
//
// Design (split over cache rows, "flash-decoding"):
// - Grid (B * KV * n_split, S, n_grp). A block owns one (slot, kv head,
//   split, query), one group of at most 8 of the kv head's G query rows and
//   L consecutive logical cache rows of the slot, L a multiple of the 64-row
//   tile. The wrapper (ops.attn_split_rows) picks L from
//   (B, KV, Sc) alone: a slot's tiles spread evenly over at most as many
//   splits as bring B * KV * n_split to four blocks on each of the card's
//   132 SMs, and at least one tile per split.
//   At B=4, KV=8, Sc=320 that is L=64, 160 blocks (the undivided design ran
//   32); at Sc=4096, L=256, 512 blocks. L never depends on S or on the
//   layout: that keeps the two bitwise contracts below.
// - Query groups. G query heads share a kv head (GQA): 2 at Qwen3-0.6B, 9
//   at StarCoder2-7B, 48 at Granite-20B (MQA). A block holds at most
//   MAX_G = 8 query rows, because its shared arrays and its registers are
//   sized for 8 (a warp per row in the softmax step, acc[GM][4] a thread in
//   PV), so the kv head's rows split into n_grp = ceil(G / 8) groups of
//   gb = ceil(G / n_grp) rows (the last may hold fewer): 1 group of 2 at
//   Qwen, 2 of 5 and 4 at StarCoder2, 6 of 8 at Granite. Every row's
//   arithmetic is the same whichever group holds it and whoever else is in
//   it -- rows never mix until the output -- so a row's bits do not depend
//   on G's grouping, and the split (L) stays a function of (B, KV, Sc)
//   alone. The cost: each group reads the split's cache rows again (twice at
//   G = 9, six times at G = 48). A loop over the groups inside the block
//   would read them once, but it would have to hold every row's acc (192
//   registers a thread at G = 48) or make a second pass over the tiles;
//   that is later work.
// - Loads before math. The block copies its rows' K codes, V codes,
//   k_scale, v_scale and pos into shared memory with cp.async (16-byte
//   copies of a code row where hd and the pointers allow, else 8 or 4),
//   64-row tiles in two stages: tile i + 2 is in flight while tile i is
//   computed. A block waits for one trip to memory (two on the paged layout,
//   whose table entries come first), not one per row. Code rows sit 16
//   bytes apart beyond hd, so the four threads that dot one row and the
//   eight rows of a warp fall in distinct banks.
// - The math stays float32 on the CUDA cores. Tensor cores do not serve
//   here: a block has at most 8 query rows (2 at Qwen3-0.6B) where wgmma
//   takes 64; bf16, tf32 or int8 operands would change the function under
//   its rtol 2e-5 contract; and the bound is bytes, not operations. Per
//   tile: four threads dot each row against the G queries (explicit fma,
//   fixed order, a two-step shuffle), one warp per query row runs the
//   online-softmax update and stores p * v_scale, then each thread owns four
//   head dimensions and every eighth row of the tile for PV on the V codes.
//   The row groups combine in a fixed order at the end of the split.
// - Partials and the combine, in the same launch. With one split the block
//   writes acc / max(l, 1e-30) itself. Otherwise each split writes (m_i,
//   l_i, acc_i[gb][hd]) to its group's rows of the scratch the wrapper
//   allocates, fences, and takes a ticket per (b, h, j, group) with
//   atomicAdd; the block that takes the last ticket combines all splits of
//   its group's rows in split order (so the result does not depend on
//   which block came last): m = max m_i,
//   out = sum e^(m_i - m) acc_i / max(sum e^(m_i - m) l_i, 1e-30),
//   and resets the ticket to 0 for the next launch on the stream. Masked rows
//   keep the finite -1e30 bias, so a split whose every row is masked has a
//   finite m_i and weighs 0 (or 1 when every split is masked, which gives
//   the plain version's uniform average). Only rows past Sc in the last tile
//   get -inf and weigh nothing.
//
// Verify (S queries per slot): the grid's y axis is the query index j.
// Block (slot, kv head, split, j) loads query row j and its position
// q_pos[b, j] and runs the one-token block's code unchanged, with the same
// L, so query j is bit for bit one one-token launch at q_pos[:, j] (the TPU
// wrapper unrolled S launches to keep that equality). Each query's blocks
// read the split's rows; a kernel that reads each row once for all S
// queries is later work.
//
// Paged layout: codes (n_pages, ps, KV, hd), scales (n_pages, ps, KV) and
// positions (n_pages, ps) are pooled across slots; slot b's position t lives
// in page page_table[b, t / ps], row t % ps (-1 = unmapped). The block reads
// the table entries its split covers into shared memory, then resolves each
// row through them as it issues the row's copies; everything else is the
// ring kernel's code, instantiated from the same template. An unmapped entry
// copies page 0's rows and writes pos -1, exactly as the dense view of
// PagedKVCache.gather() holds page 0's rows there with pos -1, so with the
// same L the paged kernel computes what the ring kernel computes on the
// gathered view, in the same order: the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;          // cache rows per pipeline stage
constexpr int STAGES = 2;
constexpr int ROW_PAD = 16;       // bytes between code rows in shared memory
constexpr int MAX_G = 8;          // query rows per block (a group)
constexpr int MAX_RG = 8;         // row groups of the PV step
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

// One asynchronous copy of `bytes` (16, 8 or 4) from device to shared memory.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offsets of the dynamic shared memory: the scaled queries (G, hd) f32,
// the K and V code tiles (STAGES, TILE, hd + ROW_PAD) int8, the k_scale,
// v_scale and pos tiles (STAGES, TILE), the logits and p * v_scale (G,
// TILE) f32, the split's page-table entries (n_tbl,) int32 and the
// combine's per-split weights and sums (2, n_split, G) f32 (none with one
// split). The end of the split reuses the code tiles for the row groups'
// partial sums.
struct Layout {
  int q, k, v, ks, vs, pos, logit, pv, tbl, comb, total;
};

__host__ __device__ inline Layout layout(int G, int hd, int n_tbl,
                                         int n_split) {
  Layout l;
  const int tile_bytes = STAGES * TILE * (hd + ROW_PAD);
  l.q = 0;
  l.k = l.q + G * hd * 4;
  l.v = l.k + tile_bytes;
  l.ks = l.v + tile_bytes;
  l.vs = l.ks + STAGES * TILE * 4;
  l.pos = l.vs + STAGES * TILE * 4;
  l.logit = l.pos + STAGES * TILE * 4;
  l.pv = l.logit + G * TILE * 4;
  l.tbl = l.pv + G * TILE * 4;
  l.comb = l.tbl + n_tbl * 4;
  l.total = l.comb + (n_split > 1 ? 2 * n_split * G * 4 : 0);
  return l;
}

// The cache row of slot b's logical row s: an index into the (rows, KV, hd)
// codes, the (rows, KV) scales and the (rows,) positions. The ring holds row
// b * Sc + s; the paged layout row page * ps + s % ps, with page the slot's
// table entry (tbl holds the entries from e0 on; page 0 where unmapped, and
// *mapped false).
template <bool PAGED>
__device__ __forceinline__ size_t cache_row(int b, int s, int Sc,
                                            const int* tbl, int e0, int ps,
                                            bool* mapped) {
  if (PAGED) {
    const int e = tbl[s / ps - e0];
    *mapped = e >= 0;
    return (size_t)max(e, 0) * ps + s % ps;
  }
  *mapped = true;
  return (size_t)b * Sc + s;
}

// Ring: codes (B, Sc, KV, hd), scales (B, Sc, KV), pos (B, Sc), no table.
// Paged: codes (n_pages, ps, KV, hd), scales (n_pages, ps, KV), pos
// (n_pages, ps), table (B, P) and Sc = P * ps logical rows per slot.
// part: (B * S * KV, n_split, GT, hd) f32 then (B * S * KV, n_split, 2, GT)
// f32 of (m, l), null with one split; tickets: (B * S * KV, n_grp) int32, 0
// between launches. GT is the kv head's query rows, gb the rows of a group
// (blockIdx.z); GM >= gb sizes the per-thread registers (2, 4 or 8).
template <bool PAGED, int GM>
__global__ void __launch_bounds__(THREADS, GM <= 2 ? 4 : 2)
decode_attn_quant_kernel(const float* __restrict__ q,      // (B, S, KV, G, hd)
                         const int8_t* __restrict__ kc,
                         const float* __restrict__ ks,
                         const int8_t* __restrict__ vc,
                         const float* __restrict__ vs,
                         const int* __restrict__ pos,
                         const int* __restrict__ qpos,     // (B, S)
                         const int* __restrict__ table,    // (B, P) or null
                         float* __restrict__ out,          // (B, S, KV, G, hd)
                         float* __restrict__ part, int* __restrict__ tickets,
                         int S, int Sc, int KV, int GT, int gb, int hd,
                         int window, int P, int ps, int L, int n_split,
                         int n_tbl, int vec, float q_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[MAX_G], l_s[MAX_G], alpha_s[MAX_G];
  __shared__ int last_s;

  const int g0 = blockIdx.z * gb;          // the group's first query row
  const int G = min(gb, GT - g0);           // and its rows
  const Layout lay = layout(gb, hd, n_tbl, n_split);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  int8_t* k_t = reinterpret_cast<int8_t*>(smem + lay.k);
  int8_t* v_t = reinterpret_cast<int8_t*>(smem + lay.v);
  float* ks_t = reinterpret_cast<float*>(smem + lay.ks);
  float* vs_t = reinterpret_cast<float*>(smem + lay.vs);
  int* pos_t = reinterpret_cast<int*>(smem + lay.pos);
  float* logit = reinterpret_cast<float*>(smem + lay.logit);
  float* pvs = reinterpret_cast<float*>(smem + lay.pv);
  int* tbl = reinterpret_cast<int*>(smem + lay.tbl);
  float* comb = reinterpret_cast<float*>(smem + lay.comb);

  const int split = blockIdx.x % n_split;
  const int bh = blockIdx.x / n_split;      // b * KV + h
  const int b = bh / KV;
  const int h = bh % KV;
  const int j = blockIdx.y;                 // query index within the slot
  const int bhj = (b * S + j) * KV + h;
  const size_t qrow = ((size_t)bhj * GT + g0) * hd;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qp = qpos[b * S + j];
  const int kstride = hd + ROW_PAD;
  const int r0 = split * L;                 // the split's logical rows
  const int r1 = min(r0 + L, Sc);
  const int n_tiles = (r1 - r0 + TILE - 1) / TILE;
  const int e0 = PAGED ? r0 / ps : 0;

  // tile `i` of the split into stage i % STAGES, as one commit group (empty
  // past the last tile, so the wait below is always wait_group STAGES - 1)
  auto issue = [&](int i) {
    const int stage = i % STAGES;
    const int t0 = r0 + i * TILE;
    const int n = i < n_tiles ? min(TILE, r1 - t0) : 0;
    const int per_row = hd / vec;
    int8_t* kd = k_t + stage * TILE * kstride;
    int8_t* vd = v_t + stage * TILE * kstride;
    for (int c = tid; c < n * per_row; c += THREADS) {
      const int t = c / per_row;
      const int col = (c - t * per_row) * vec;
      bool mapped;
      const size_t row = cache_row<PAGED>(b, t0 + t, Sc, tbl, e0, ps, &mapped);
      const size_t off = (row * KV + h) * hd + col;
      cp_async(kd + t * kstride + col, kc + off, vec);
      cp_async(vd + t * kstride + col, vc + off, vec);
    }
    for (int t = tid; t < n; t += THREADS) {
      bool mapped;
      const size_t row = cache_row<PAGED>(b, t0 + t, Sc, tbl, e0, ps, &mapped);
      cp_async(ks_t + stage * TILE + t, ks + row * KV + h, 4);
      cp_async(vs_t + stage * TILE + t, vs + row * KV + h, 4);
      if (mapped)
        cp_async(pos_t + stage * TILE + t, pos + row, 4);
      else
        pos_t[stage * TILE + t] = -1;
    }
    cp_async_commit();
  };

  auto load_q = [&]() {
    for (int i = tid; i < G * hd; i += THREADS)
      qs[i] = __fmul_rn(q[qrow + i], q_scale);
  };

  if (PAGED) {  // the table entries first: every copy's address needs one
    const int ne = r1 > r0 ? (r1 - 1) / ps - e0 + 1 : 0;
    for (int i = tid; i < ne; i += THREADS) tbl[i] = table[(size_t)b * P + e0 + i];
    load_q();
    __syncthreads();
  }
  for (int i = 0; i < STAGES; ++i) issue(i);
  if (!PAGED) load_q();  // behind the copies, so they are in flight first
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // PV ownership: dimensions 4 * dg .. 4 * dg + 3, rows rg, rg + nrg, ...
  const int ndg = hd / 4;
  const int nrg = min(MAX_RG, THREADS / ndg);
  const int dg = tid % ndg;
  const int rg = tid / ndg;
  const bool pv_thread = rg < nrg;
  float acc[GM][4];
#pragma unroll
  for (int g = 0; g < GM; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % STAGES;
    const int tend = min(TILE, r1 - (r0 + i * TILE));
    cp_async_wait<STAGES - 1>();
    __syncthreads();

    // ---- logits: four threads per row, a quarter of the row's bytes each
    {
      const int t = tid / 4;
      const int quarter = tid % 4;
      float dot[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) dot[g] = 0.f;
      if (t < tend) {
        const int8_t* row = k_t + stage * TILE * kstride + t * kstride;
        for (int d = quarter * 4; d < hd; d += 16) {
          const char4 c = *reinterpret_cast<const char4*>(row + d);
          const float c0 = c.x, c1 = c.y, c2 = c.z, c3 = c.w;
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g < G) {
              const float4 qv = *reinterpret_cast<const float4*>(qs + g * hd + d);
              dot[g] = fmaf(qv.x, c0, dot[g]);
              dot[g] = fmaf(qv.y, c1, dot[g]);
              dot[g] = fmaf(qv.z, c2, dot[g]);
              dot[g] = fmaf(qv.w, c3, dot[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], 1);
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], 2);
        }
      }
      if (t < tend) {
        const int p = pos_t[stage * TILE + t];
        bool valid = p >= 0 && p <= qp;
        if (window > 0) valid = valid && (qp - p < window);
        const float bias = valid ? 0.f : NEG_INF;
        const float kscale = ks_t[stage * TILE + t];
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G && g % 4 == quarter)
            logit[g * TILE + t] = __fmul_rn(dot[g], kscale) + bias;
      } else {  // past the end of the cache: contributes nothing
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G && g % 4 == quarter) logit[g * TILE + t] = -INFINITY;
      }
    }
    __syncthreads();

    // ---- online softmax: warp g owns query row g
    for (int g = warp; g < G; g += WARPS) {
      const float a = logit[g * TILE + lane];
      const float c = logit[g * TILE + lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new);
      const float pc = expf(c - m_new);
      const float psum = warp_sum(pa + pc);
      pvs[g * TILE + lane] = lane < tend ? pa * vs_t[stage * TILE + lane] : 0.f;
      pvs[g * TILE + lane + 32] =
          lane + 32 < tend ? pc * vs_t[stage * TILE + lane + 32] : 0.f;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // ---- PV on the codes, V-scale riding on p
    if (pv_thread) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          const float a = alpha_s[g];
          acc[g][0] *= a;
          acc[g][1] *= a;
          acc[g][2] *= a;
          acc[g][3] *= a;
        }
      }
      const int8_t* vt = v_t + stage * TILE * kstride + dg * 4;
      for (int t = rg; t < tend; t += nrg) {
        const char4 c = *reinterpret_cast<const char4*>(vt + t * kstride);
        const float c0 = c.x, c1 = c.y, c2 = c.z, c3 = c.w;
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float p = pvs[g * TILE + t];
            acc[g][0] = fmaf(p, c0, acc[g][0]);
            acc[g][1] = fmaf(p, c1, acc[g][1]);
            acc[g][2] = fmaf(p, c2, acc[g][2]);
            acc[g][3] = fmaf(p, c3, acc[g][3]);
          }
        }
      }
    }
    __syncthreads();   // the stage is free: refill it
    issue(i + STAGES);
  }
  cp_async_wait<0>();  // (only empty groups remain)

  // ---- the row groups' sums, in row-group order, in the freed code tiles
  float* red = reinterpret_cast<float*>(smem + lay.k);
  if (pv_thread) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G)
        *reinterpret_cast<float4*>(red + (rg * G + g) * hd + dg * 4) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
  const size_t slot = (size_t)bhj * n_split;   // this (b, h, j)'s partials
  for (int i = tid; i < G * hd; i += THREADS) {
    float a = red[i];
    for (int r = 1; r < nrg; ++r) a += red[r * G * hd + i];
    if (n_split == 1)
      out[qrow + i] = a / fmaxf(l_s[i / hd], 1e-30f);
    else
      part[((slot + split) * GT + g0) * hd + i] = a;
  }
  if (n_split == 1) return;
  const float* part_acc = part;
  float* part_ml = part + (size_t)gridDim.x * gridDim.y * GT * hd;
  if (tid < G) {
    part_ml[(slot + split) * 2 * GT + g0 + tid] = m_s[tid];
    part_ml[(slot + split) * 2 * GT + GT + g0 + tid] = l_s[tid];
  }

  // ---- the last split of (b, h, j, group) to finish combines all of them
  const int ticket = bhj * gridDim.z + blockIdx.z;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(tickets + ticket, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // every split's (m_i, l_i) at once (the partials bypass L1: other SMs
  // wrote them), then warp g turns row g's m_i into e^(m_i - m) and sums
  // the weighted l_i (in an order fixed by n_split alone)
  float* w_c = comb;                     // (n_split, G)
  float* l_c = comb + n_split * G;       // (n_split, G)
  const float* ml = part_ml + slot * 2 * GT + g0;
  for (int k = tid; k < n_split * G; k += THREADS) {
    const int sp = k / G, g = k % G;
    w_c[k] = __ldcg(ml + sp * 2 * GT + g);
    l_c[k] = __ldcg(ml + sp * 2 * GT + GT + g);
  }
  __syncthreads();
  for (int g = warp; g < G; g += WARPS) {
    float m = NEG_INF;
    for (int sp = lane; sp < n_split; sp += 32) m = fmaxf(m, w_c[sp * G + g]);
    m = warp_max(m);
    float den = 0.f;
    for (int sp = lane; sp < n_split; sp += 32) {
      const float w = expf(w_c[sp * G + g] - m);
      den = fmaf(w, l_c[sp * G + g], den);
      w_c[sp * G + g] = w;
    }
    den = warp_sum(den);
    if (lane == 0) l_s[g] = den;
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd;
    float num = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < n_split; ++sp)
      num = fmaf(w_c[sp * G + g],
                 __ldcg(part_acc + ((slot + sp) * GT + g0) * hd + i), num);
    out[qrow + i] = num / fmaxf(l_s[g], 1e-30f);
  }
  if (tid == 0) tickets[ticket] = 0;
}

// The kv head's G query rows in n_grp groups of at most MAX_G, balanced:
// gb rows each, the last group the rest (ops.attn_query_groups mirrors it).
__host__ __device__ inline int query_groups(int G) {
  return (G + MAX_G - 1) / MAX_G;
}

template <bool PAGED, int GM>
int launch_g(const void* q, const void* kc, const void* ks, const void* vc,
           const void* vs, const void* pos, const void* table,
           const void* qpos, void* out, void* part, void* tickets, int B,
           int S, int Sc, int P, int ps, int KV, int G, int gb, int hd,
           int window, int L, float q_scale, void* stream) {
  const int n_split = Sc > 0 ? (Sc + L - 1) / L : 1;
  const int n_grp = query_groups(G);
  const uintptr_t align = reinterpret_cast<uintptr_t>(kc) |
                          reinterpret_cast<uintptr_t>(vc) | (uintptr_t)hd;
  const int vec = align % 16 == 0 ? 16 : align % 8 == 0 ? 8 : 4;
  // table entries a split of L rows spans, at most
  const int n_tbl = PAGED ? min(P, L / ps + 2) : 0;
  const int smem = layout(gb, hd, n_tbl, n_split).total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_quant_kernel<PAGED, GM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_attn_quant_kernel<PAGED, GM><<<dim3(B * KV * n_split, S, n_grp),
                                        THREADS,
                                        smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const int8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<const int*>(qpos), static_cast<const int*>(table),
      static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int*>(tickets), S, Sc, KV, G, gb, hd, window, P, ps, L,
      n_split, n_tbl, vec, q_scale);
  return static_cast<int>(cudaGetLastError());
}

// The instance whose registers hold a group's gb query rows (gb <= 8).
template <bool PAGED>
int launch(const void* q, const void* kc, const void* ks, const void* vc,
           const void* vs, const void* pos, const void* table,
           const void* qpos, void* out, void* part, void* tickets, int B,
           int S, int Sc, int P, int ps, int KV, int G, int hd, int window,
           int L, float q_scale, void* stream) {
  const int n_grp = query_groups(G);
  const int gb = (G + n_grp - 1) / n_grp;
  auto* fn = gb <= 2 ? launch_g<PAGED, 2>
             : gb <= 4 ? launch_g<PAGED, 4> : launch_g<PAGED, MAX_G>;
  return fn(q, kc, ks, vc, vs, pos, table, qpos, out, part, tickets, B, S, Sc,
            P, ps, KV, G, gb, hd, window, L, q_scale, stream);
}

}  // namespace

// Shapes as in the comments of the kernel's arguments; any G >= 1, hd <=
// 256, hd % 4 == 0, 4-byte aligned codes, S <= 65535 and L a positive
// multiple of 64 (the wrapper checks). window <= 0 means no window. part
// holds B * S * KV * ceil(Sc / L) * G * (hd + 2) floats (null when Sc <=
// L); tickets B * S * KV * ceil(G / 8) zeroed ints, which every launch
// leaves zeroed. The
// one-token entry points are the S = 1 launch of the verify ones: one
// compiled kernel serves both.
extern "C" int verify_attn_quant(const void* q, const void* kc, const void* ks,
                                 const void* vc, const void* vs,
                                 const void* pos, const void* qpos, void* out,
                                 void* part, void* tickets, int B, int S,
                                 int Sc, int KV, int G, int hd, int window,
                                 int L, float q_scale, void* stream) {
  return launch<false>(q, kc, ks, vc, vs, pos, nullptr, qpos, out, part,
                       tickets, B, S, Sc, 0, 1, KV, G, hd, window, L, q_scale,
                       stream);
}

extern "C" int decode_attn_quant(const void* q, const void* kc, const void* ks,
                                 const void* vc, const void* vs,
                                 const void* pos, const void* qpos, void* out,
                                 void* part, void* tickets, int B, int Sc,
                                 int KV, int G, int hd, int window, int L,
                                 float q_scale, void* stream) {
  return verify_attn_quant(q, kc, ks, vc, vs, pos, qpos, out, part, tickets,
                           B, 1, Sc, KV, G, hd, window, L, q_scale, stream);
}

// Paged layout: pages (n_pages, ps, KV, hd), table (B, P), Sc = P * ps.
extern "C" int verify_attn_quant_paged(const void* q, const void* kc,
                                       const void* ks, const void* vc,
                                       const void* vs, const void* pos,
                                       const void* table, const void* qpos,
                                       void* out, void* part, void* tickets,
                                       int B, int S, int P, int ps, int KV,
                                       int G, int hd, int window, int L,
                                       float q_scale, void* stream) {
  return launch<true>(q, kc, ks, vc, vs, pos, table, qpos, out, part, tickets,
                      B, S, P * ps, P, ps, KV, G, hd, window, L, q_scale,
                      stream);
}

extern "C" int decode_attn_quant_paged(const void* q, const void* kc,
                                       const void* ks, const void* vc,
                                       const void* vs, const void* pos,
                                       const void* table, const void* qpos,
                                       void* out, void* part, void* tickets,
                                       int B, int P, int ps, int KV, int G,
                                       int hd, int window, int L,
                                       float q_scale, void* stream) {
  return verify_attn_quant_paged(q, kc, ks, vc, vs, pos, table, qpos, out,
                                 part, tickets, B, 1, P, ps, KV, G, hd, window,
                                 L, q_scale, stream);
}
