// Shared pieces of the window attention kernels: K3 (wattn_rpe_fwd.cu), K4
// (wattn_rpe_bwd_q.cu) and K5 (wattn_rpe_bwd_k.cu) with contextual RPE, and
// K2 (wattn_fwd.cu) without it.
//
// Over a window-sorted sequence of N rows (N a multiple of 32), for query i
// and key j of the same window (rank_i == rank_j), per head:
//
//   idx_a = clip(q_i^a, 0, G-1) - clip(q_j^a, 0, G-1) + G - 1   (difference axes)
//   idx_2 = clip(expsplit(r_i - r_j) + 24, 0, 2G-1)              (radial axis, sphere branch)
//
// Every RPE kernel computes the bins with the functions below, so the
// forward and the two backward kernels agree bin for bin; every kernel finds
// each row's window with warp_run_bounds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wattn {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// An odd row stride, so that threads reading one column of their own rows
// hit distinct shared-memory banks.
__host__ __device__ __forceinline__ int odd_stride(int width) { return width | 1; }

// exponential split of a range difference into a radial bin, clipped to
// [0, lr); the same f32 steps as the port's ops/wattn.py:exponential_split_index
__device__ __forceinline__ int radial_bin(float rel, float a, int lr) {
  const float ra = fabsf(rel);
  const float flag = rel >= 0.f ? 1.f : 0.f;
  float idx = 2.f * floorf(logf((ra + 2.f * a) / a) / 0.69314718055994531f) - 2.f;
  idx += ((3.f * exp2f(floorf(idx / 2.f)) - 2.f) * a <= ra) ? 1.f : 0.f;
  idx = idx * (2.f * flag - 1.f) + (flag - 1.f);
  const int b = (int)idx + 24;
  return min(max(b, 0), lr - 1);
}

__device__ __forceinline__ int clip_quant(int q, int G) { return min(max(q, 0), G - 1); }

// The per-row "mass" layout of the backward kernels: one slot per partner
// coordinate on each difference axis (G each) and one per radial bin (2G),
// so a row holds 3G (cubic) or 4G (sphere) floats instead of 3 * L2. Axis
// a's slot for partner coordinate c is a * G + c; radial bin l's is 2G + l.
__host__ __device__ __forceinline__ int mass_width(bool radial, int G) {
  return radial ? 4 * G : 3 * G;
}

constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

// The share of an SM's unified L1 and shared memory, in percent, that K4 and
// K5 ask to be shared memory (cudaFuncAttributePreferredSharedMemoryCarveout):
// 164 KB of the 256. The rest is L1, which holds the rows of the [N, h, 3,
// L2] projections each lane reads its own lookups from; the full 228 KB of
// shared memory keeps more warps resident but leaves L1 too small for those
// rows, and measured slower on the sphere branch.
constexpr int BWD_SMEM_CARVEOUT = 72;

// Let a kernel take `smem` bytes of dynamic shared memory, with `carveout`
// percent of the SM's unified L1 and shared memory as shared memory.
template <typename Kernel>
cudaError_t configure_smem(Kernel kern, size_t smem, int carveout) {
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  return e;
}

// out[0] = dynamic shared bytes per block, out[1] = resident blocks per SM,
// out[2] = resident warps per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// for a kernel of one-warp blocks, configured as configure_smem does.
template <typename Kernel>
int warp_occupancy(Kernel kern, size_t smem, int carveout, int* out) {
  cudaError_t e = configure_smem(kern, smem, carveout);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, WARP, smem);
  out[0] = (int)smem;
  out[1] = blocks;
  out[2] = blocks;  // one warp a block
  return (int)e;
}

// True where a run of equal rank begins among the n window-sorted rows;
// row n (past the end) counts as a start, so that it closes the last run.
// Ranks are f32 (the host geometry's, K3-K5) or int32 (K2's window sort).
template <typename R>
__device__ __forceinline__ bool run_starts_at(const R* __restrict__ rank, int j, int n) {
  return j <= 0 || j >= n || __ldg(rank + j) != __ldg(rank + j - 1);
}

// The run [x, y) of equal rank that holds row base + lane, for the 32 rows
// of one warp from base (a multiple of 32; n a multiple of 32 too). Windows
// are contiguous runs of the sorted rows, so a row's run is its window. The
// warp takes one ballot of its own rows' start flags; a lane's start is the
// highest flag at or below it (__clz), its end the lowest flag above it
// (__ffs). Lanes whose run begins before the warp share the start of row
// base's run, found by one ballot per 32 rows going back; lanes whose run
// ends after the warp share the end of row base + 31's run, found likewise
// going forward. So a window of any length costs a lane no step, and the
// warp one ballot per 32 rows of the windows it straddles. All 32 lanes must
// call it.
template <typename R>
__device__ __forceinline__ int2 warp_run_bounds(const R* __restrict__ rank, int base, int n,
                                                int lane) {
  const unsigned own = __ballot_sync(FULL_MASK, run_starts_at(rank, base + lane, n));
  const unsigned upto = lane == WARP - 1 ? FULL_MASK : (2u << lane) - 1u;
  const unsigned below = own & upto, above = own & ~upto;
  int first = base;  // start of row base's run
  if (!(own & 1u)) {
    for (int c = base - WARP;; c -= WARP) {  // row 0 starts a run: c stays >= 0
      const unsigned f = __ballot_sync(FULL_MASK, run_starts_at(rank, c + lane, n));
      if (f) {
        first = c + WARP - 1 - __clz(f);
        break;
      }
    }
  }
  int last = n;  // end of row base + 31's run
  for (int c = base + WARP;; c += WARP) {  // row n counts as a start: the loop ends
    const unsigned f = __ballot_sync(FULL_MASK, run_starts_at(rank, c + lane, n));
    if (f) {
      last = c + __ffs(f) - 1;
      break;
    }
  }
  return make_int2(below ? base + WARP - 1 - __clz(below) : first,
                   above ? base + __ffs(above) - 1 : last);
}

// Join NK scored keys (scores s, value rows val) to a lane's online softmax
// (running max m, sum l and D-wide output acc) at once: one rescale to the
// group's max, then the keys' terms in key order, so two launches give the
// same bits. Keys from `live` on take no part. K2 and K3 call it.
template <int NK, int D>
__device__ __forceinline__ void softmax_join(const float (&s)[NK], const float (&val)[NK][D],
                                             int live, float& m, float& l, float (&acc)[D]) {
  float mx = m;
#pragma unroll
  for (int u = 0; u < NK; ++u)
    if (u < live) mx = fmaxf(mx, s[u]);
  const float sc = expf(m - mx);
  float p[NK];
#pragma unroll
  for (int u = 0; u < NK; ++u) p[u] = u < live ? expf(s[u] - mx) : 0.f;
  l *= sc;
#pragma unroll
  for (int u = 0; u < NK; ++u) l += p[u];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    float x = acc[dd] * sc;
#pragma unroll
    for (int u = 0; u < NK; ++u) x = fmaf(p[u], val[u][dd], x);
    acc[dd] = x;
  }
  m = mx;
}

// A D-wide row of q, k, v (f32 or bf16) or of an f32 gradient, read through
// the read-only cache in 16-byte (or, for 4 bf16, 8-byte) loads; rows start
// at multiples of D elements, so a base pointer aligned to D * sizeof(T)
// bytes, up to 16, aligns every row (see row_aligned).
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&out)[D]) {
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p) + c);
    out[4 * c] = x.x;
    out[4 * c + 1] = x.y;
    out[4 * c + 2] = x.z;
    out[4 * c + 3] = x.w;
  }
}

__device__ __forceinline__ void unpack_bf16x2(unsigned w, float* out) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  out[0] = f.x;
  out[1] = f.y;
}

template <int D>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p, float (&out)[D]) {
  if constexpr (D % 8 == 0) {
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + c);
      unpack_bf16x2(x.x, out + 8 * c);
      unpack_bf16x2(x.y, out + 8 * c + 2);
      unpack_bf16x2(x.z, out + 8 * c + 4);
      unpack_bf16x2(x.w, out + 8 * c + 6);
    }
  } else {
    static_assert(D == 4, "bf16 rows of 4 or a multiple of 8");
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    unpack_bf16x2(x.x, out);
    unpack_bf16x2(x.y, out + 2);
  }
}

// Whether load_row may read rows of D elements of `bytes` each from p.
inline bool row_aligned(const void* p, int D, int bytes) {
  const int need = D * bytes < 16 ? D * bytes : 16;
  return reinterpret_cast<uintptr_t>(p) % need == 0;
}

}  // namespace wattn

// Each attention kernel is a template on its head dim D; its C entry points
// `return CALL(D)` for the D they were given, through this switch, and
// cudaErrorInvalidValue for another.
#define WATTN_HEAD_DIM_SWITCH(D, CALL)          \
  switch (D) {                                  \
    case 4: return CALL(4);                     \
    case 8: return CALL(8);                     \
    case 16: return CALL(16);                   \
    case 32: return CALL(32);                   \
    default: return (int)cudaErrorInvalidValue; \
  }
