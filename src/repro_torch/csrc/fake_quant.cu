// LSQ fake-quant (Eq. 1 of the paper) and its straight-through backward.
//
// Replaces the TPU kernels src/repro/kernels/fake_quant.py:_fwd_kernel
// (fake_quant_fwd) and src/repro/kernels/fake_quant.py:_bwd_kernel
// (fake_quant_bwd).
//
// What it computes, with s = max(scale, 1e-9) read from device memory:
//   forward   out = round(clip(v / s, qmin, qmax)) * s, with a scale for
//             each leading slice: n_s scales, scale i over the i-th of n_s
//             equal contiguous slices of v (n_s = 1: one scale; n_s = E: a
//             per-expert (E, 1, 1) scale against an (E, C, D) stack)
//   backward  dv  = g where qmin < v/s < qmax (strictly), else 0
//             ds  = sum g * (round(v/s) - v/s) inside, sum g * clip(v/s) outside
// The backward takes the forward's n_s scales on a (blocks per slice, n_s)
// grid, so no block straddles two slices, and writes one ds partial per
// block, (n_s, blocks per slice); the wrapper sums each slice's partials
// (and autograd multiplies by the LSQ grad scale through the scale chain),
// as the TPU wrapper sums its per-tile partials.
//
// Numerics: the division is IEEE (no fast math, never a reciprocal), the
// rounding is rintf (half to even, as torch.round and jnp.round; roundf
// would round half away from zero), and the clip keeps NaN. So the forward
// and dv equal the plain PyTorch version bit for bit. ds sums in another
// order than the plain version and is held to a relative tolerance. At
// n_s = 1 the forward reads the one scale once a thread, as before; past
// it each group of four elements reads its slice's scale (one load from
// L1 or L2, the same for every group of a slice), and a group takes the
// vector path only when a slice's length is a multiple of four, so its
// four elements share one scale. A backward block reads its slice's scale
// once, and takes the vector path on the same condition.
//
// What bounds it on an H100: a few float operations per element against 8
// (forward: v in, out) or 12 (backward: v and g in, dv out) bytes, so bytes
// over the 3.35 TB/s of device memory. Design: one fused pass per direction,
// each thread takes four consecutive elements with one 16-byte load per
// operand where the pointers allow it, in a grid-stride loop; the backward
// reduces ds in registers, then across the warp with shuffles and across the
// block in shared memory, and writes one partial per block (no atomics, so
// the sum is the same from run to run).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;  // min(max(x, lo), hi); a NaN passes through
  return x > hi ? hi : x;
}

__device__ __forceinline__ float fq_one(float v, float s, float qmin,
                                        float qmax) {
  return rintf(clip(v / s, qmin, qmax)) * s;
}

__global__ void __launch_bounds__(THREADS)
fq_fwd_kernel(const float* __restrict__ v, const float* __restrict__ scale,
              float* __restrict__ out, long long n, long long n_s, float qmin,
              float qmax, int vec) {
  const float s0 = fmaxf(scale[0], 1e-9f);
  const long long slice = n / n_s;  // elements a scale covers
  const long long groups = (n + 3) / 4;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < groups; i += (long long)gridDim.x * THREADS) {
    const long long base = 4 * i;
    if (vec && base + 4 <= n) {
      const float s = n_s == 1 ? s0 : fmaxf(scale[base / slice], 1e-9f);
      float4 x = *reinterpret_cast<const float4*>(v + base);
      x.x = fq_one(x.x, s, qmin, qmax);
      x.y = fq_one(x.y, s, qmin, qmax);
      x.z = fq_one(x.z, s, qmin, qmax);
      x.w = fq_one(x.w, s, qmin, qmax);
      *reinterpret_cast<float4*>(out + base) = x;
    } else {
      for (long long e = base; e < base + 4 && e < n; ++e) {
        const float s = n_s == 1 ? s0 : fmaxf(scale[e / slice], 1e-9f);
        out[e] = fq_one(v[e], s, qmin, qmax);
      }
    }
  }
}

// one element of the backward: returns dv, adds g * dsd to acc
__device__ __forceinline__ float fq_bwd_one(float v, float g, float s,
                                            float qmin, float qmax,
                                            float& acc) {
  const float vs = v / s;
  const bool inside = (vs > qmin) && (vs < qmax);
  const float c = clip(vs, qmin, qmax);
  const float d = inside ? rintf(c) - vs : c;
  acc = fmaf(g, d, acc);
  return inside ? g : 0.0f;
}

// grid (blocks per slice, n_s): block (x, y) takes slice y only, so its
// one scale is read once and its ds partial is that slice's; partials are
// laid out (n_s, gridDim.x)
__global__ void __launch_bounds__(THREADS)
fq_bwd_kernel(const float* __restrict__ v, const float* __restrict__ scale,
              const float* __restrict__ g, float* __restrict__ dv,
              float* __restrict__ partials, long long n, long long n_s,
              float qmin, float qmax, int vec) {
  __shared__ float warp_part[THREADS / 32];
  const long long slice = n / n_s;
  const long long off = (long long)blockIdx.y * slice;
  const float s = fmaxf(scale[blockIdx.y], 1e-9f);
  v += off;
  g += off;
  dv += off;
  const long long groups = (slice + 3) / 4;
  float acc = 0.0f;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < groups; i += (long long)gridDim.x * THREADS) {
    const long long base = 4 * i;
    if (vec && base + 4 <= slice) {
      const float4 x = *reinterpret_cast<const float4*>(v + base);
      const float4 gg = *reinterpret_cast<const float4*>(g + base);
      float4 o;
      o.x = fq_bwd_one(x.x, gg.x, s, qmin, qmax, acc);
      o.y = fq_bwd_one(x.y, gg.y, s, qmin, qmax, acc);
      o.z = fq_bwd_one(x.z, gg.z, s, qmin, qmax, acc);
      o.w = fq_bwd_one(x.w, gg.w, s, qmin, qmax, acc);
      *reinterpret_cast<float4*>(dv + base) = o;
    } else {
      for (long long e = base; e < base + 4 && e < slice; ++e)
        dv[e] = fq_bwd_one(v[e], g[e], s, qmin, qmax, acc);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) t += warp_part[w];
    partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = t;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// v, out: n f32; scale: n_s f32 on the device, n_s dividing n, one per
// leading slice -> out = fake-quant(v)
extern "C" int fake_quant_fwd(const void* v, const void* scale, void* out,
                              long long n, long long n_s, float qmin,
                              float qmax, int blocks, void* stream) {
  const int vec =
      aligned16(v) && aligned16(out) && (n_s == 1 || (n / n_s) % 4 == 0);
  fq_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(scale),
      static_cast<float*>(out), n, n_s, qmin, qmax, vec);
  return static_cast<int>(cudaGetLastError());
}

// v, g, dv: n f32; scale: n_s f32 on the device, n_s dividing n, one per
// leading slice; partials: n_s x `blocks` f32 (`blocks` per slice)
extern "C" int fake_quant_bwd(const void* v, const void* scale, const void* g,
                              void* dv, void* partials, long long n,
                              long long n_s, float qmin, float qmax,
                              int blocks, void* stream) {
  const int vec = aligned16(v) && aligned16(g) && aligned16(dv) &&
                  (n_s == 1 || (n / n_s) % 4 == 0);
  const dim3 grid(blocks, static_cast<unsigned>(n_s));
  fq_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(scale),
      static_cast<const float*>(g), static_cast<float*>(dv),
      static_cast<float*>(partials), n, n_s, qmin, qmax, vec);
  return static_cast<int>(cudaGetLastError());
}
