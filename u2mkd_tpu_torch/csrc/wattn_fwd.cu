// Window attention without relative position encoding, forward (K2).
//
// Over a window-sorted sequence of N rows (N a multiple of 32), each window
// a contiguous run of equal rank, per head:
//
//   out_i = sum_j softmax_j(q_i . k_j) v_j   over the keys j with rank_j == rank_i
//
// (q pre-scaled by the caller).
//
// Replaces the TPU kernel u2mkd_tpu/ops/pallas/wattn_kernel.py:_kernel,
// called by flash_window_attention_sorted (pl.pallas_call at :171). The TPU
// kernel pads the heads to 128 lanes, double-buffers 128-row key tiles by DMA
// and masks each [tile, tile] score matmul by window equality; those are
// artefacts of the TPU's lanes and its sequential grid, and none is kept.
//
// What bounds it on the H100. Per (query, key) pair of a window and head the
// work is a D-wide dot product, an exp and a D-wide value accumulation, ~4 D
// flops, while each row's bytes (q, k, v, rank, out) need moving once: at the
// windows of the SphereFormer levels (tens to hundreds of rows) the pairs'
// f32 arithmetic bounds it. The design, that of K3 (wattn_rpe_fwd.cu)
// without the tables:
//   * one block is one warp of 32 consecutive query rows of one head; lane t
//     owns row t and keeps q, the running max, the running sum and the D-wide
//     output in registers: a single pass with online rescaling, f32
//     throughout for f32 and bf16 inputs;
//   * each lane walks the keys of its own window only, [start, end) from
//     wattn::warp_run_bounds on the int32 ranks: no step lands on a key of
//     another window, so a window of any length costs only its own pairs;
//   * a key's k and v rows are read through the read-only cache: lanes of one
//     window read the same key at once, so the reads broadcast;
//   * a lane takes NK = 2 keys per step (independent chains; a step past the
//     run's end repeats its last key) and joins them to its online softmax
//     together (wattn::softmax_join: one rescale per step, not per key);
//   * every query attends at least itself, and the sum is floored at 1e-20
//     as the TPU kernel's is.
// No shared memory and no atomics: two launches give the same bits.
// The output is f32 [N, H, D].

#include "wattn_rpe_common.cuh"

namespace {

using wattn::WARP;
using wattn::load_row;

constexpr int NK = 2;           // keys per step of a lane
constexpr int MIN_BLOCKS = 16;  // resident warps per SM the registers must allow
// No shared memory is used, but each resident block reserves 1 KB of it:
// enough for the register-limited blocks, and the rest as L1.
constexpr int SMEM_CARVEOUT = 8;

template <typename T, int D>
__global__ void __launch_bounds__(WARP, MIN_BLOCKS)
wattn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int32_t* __restrict__ rank, float* __restrict__ out, int H) {
  const int lane = threadIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.x * WARP, i = row0 + lane;
  const int n = gridDim.x * WARP;
  const int2 run = wattn::warp_run_bounds(rank, row0, n, lane);

  const size_t hi = (size_t)i * H + h;
  float qv[D], acc[D];
  load_row<D>(q + hi * D, qv);
#pragma unroll
  for (int dd = 0; dd < D; ++dd) acc[dd] = 0.f;

  float m = -INFINITY, l = 0.f;
  for (int j0 = run.x; j0 < run.y; j0 += NK) {
    float s[NK], vv[NK][D];
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      const size_t hj = (size_t)min(j0 + u, run.y - 1) * H + h;
      float kk[D];
      load_row<D>(k + hj * D, kk);
      load_row<D>(v + hj * D, vv[u]);
      float sc = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) sc = fmaf(qv[dd], kk[dd], sc);
      s[u] = sc;
    }
    wattn::softmax_join<NK, D>(s, vv, run.y - j0, m, l, acc);
  }

  const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
  for (int dd = 0; dd < D; ++dd) out[hi * D + dd] = acc[dd] * inv;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* rank, void* out, int N,
           int H, void* stream) {
  if (N % WARP || !wattn::row_aligned(q, D, sizeof(T)) || !wattn::row_aligned(k, D, sizeof(T)) ||
      !wattn::row_aligned(v, D, sizeof(T)))
    return (int)cudaErrorMisalignedAddress;
  auto kern = wattn_fwd_kernel<T, D>;
  cudaError_t e = wattn::configure_smem(kern, 0, SMEM_CARVEOUT);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / WARP, H);
  kern<<<grid, WARP, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)rank, (float*)out, H);
  return (int)cudaGetLastError();
}

// the launch's shared bytes and resident blocks and warps per SM into out[3]
template <typename T, int D>
int occupancy(int* out) {
  return wattn::warp_occupancy(wattn_fwd_kernel<T, D>, 0, SMEM_CARVEOUT, out);
}

}  // namespace

extern "C" {

// Sorted inputs: q, k, v [N, H, D]; rank [N] int32; out [N, H, D] f32. D in
// {4, 8, 16, 32}, N a multiple of 32, q, k and v aligned to their rows'
// loads. Returns the cudaError_t of the launch.
int wattn_fwd_f32(const void* q, const void* k, const void* v, const void* rank, void* out,
                  int N, int H, int D, void* stream) {
#define WATTN_FWD_LAUNCH_F32(DD) launch<float, DD>(q, k, v, rank, out, N, H, stream)
  WATTN_HEAD_DIM_SWITCH(D, WATTN_FWD_LAUNCH_F32)
#undef WATTN_FWD_LAUNCH_F32
}

int wattn_fwd_bf16(const void* q, const void* k, const void* v, const void* rank, void* out,
                   int N, int H, int D, void* stream) {
#define WATTN_FWD_LAUNCH_BF16(DD) launch<__nv_bfloat16, DD>(q, k, v, rank, out, N, H, stream)
  WATTN_HEAD_DIM_SWITCH(D, WATTN_FWD_LAUNCH_BF16)
#undef WATTN_FWD_LAUNCH_BF16
}

// The kernel's shared bytes per block (none) and resident blocks and warps
// per SM into out[3], for bf16 (1) or f32 (0) inputs of head dim D; G and
// radial are not read (the signature of the other attention kernels'
// queries). Returns the cudaError_t.
int wattn_fwd_occupancy(int bf16, int D, int G, int radial, int* out) {
#define WATTN_FWD_OCC_F32(DD) occupancy<float, DD>(out)
#define WATTN_FWD_OCC_BF16(DD) occupancy<__nv_bfloat16, DD>(out)
  if (bf16) {
    WATTN_HEAD_DIM_SWITCH(D, WATTN_FWD_OCC_BF16)
  }
  WATTN_HEAD_DIM_SWITCH(D, WATTN_FWD_OCC_F32)
#undef WATTN_FWD_OCC_F32
#undef WATTN_FWD_OCC_BF16
}

}  // extern "C"
