// Shared pieces of the contextual-RPE window attention kernels: K3
// (wattn_rpe_fwd.cu), K4 (wattn_rpe_bwd_q.cu) and K5 (wattn_rpe_bwd_k.cu).
//
// Over a window-sorted sequence of N rows (N a multiple of TQ), for query i
// and key j of the same window (rank_i == rank_j), per head:
//
//   idx_a = clip(q_i^a, 0, G-1) - clip(q_j^a, 0, G-1) + G - 1   (difference axes)
//   idx_2 = clip(expsplit(r_i - r_j) + 24, 0, 2G-1)              (radial axis, sphere branch)
//
// Every kernel computes the bins with the functions below, so the forward
// and the two backward kernels agree bin for bin.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wattn {

constexpr int TQ = 128;  // rows per block: the host geometry's tile
constexpr int KC = 32;   // partner rows staged per chunk

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

}  // namespace wattn
