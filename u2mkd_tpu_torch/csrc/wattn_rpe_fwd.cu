// Window attention with contextual relative position encoding, forward (K3).
//
// Over a window-sorted sequence of N rows (N a multiple of 32), for query i
// and key j of the same window (rank_i == rank_j), per head:
//
//   idx_a = clip(q_i^a, 0, G-1) - clip(q_j^a, 0, G-1) + G - 1   (difference axes)
//   idx_2 = clip(expsplit(r_i - r_j) + 24, 0, 2G-1)              (radial axis, sphere branch)
//   s_ij  = q_i . k_j + sum_a qT[i, a, idx_a] + sum_a kT[j, a, idx_a]
//   out_i = sum_j softmax_j(s)_ij * (v_j + sum_a Tv[idx_a, a])
//
// qT[i, a, l] = q_i . Tq[l, a] and kT[j, a, l] = k_j . Tk[l, a] are the per-row
// table projections; the wrapper computes them with one matmul each, as the
// JAX package computes them in XLA (_proj_shift).
//
// Replaces the TPU kernel u2mkd_tpu/ops/pallas/wattn_kernel.py:_call_fwd (body
// _fwd_kernel), together with its XLA prologue _build_cats and the V-table
// epilogue of _flash_rpe_fwd. The TPU kernel packs each head into 128-lane
// segments so that every term is one MXU matmul, and runs two passes because
// its carries had to stay small; neither constraint exists here.
//
// What bounds it on the H100. Per (query, key) pair of a window and head the
// work is ~7*D flops of dot product, value-table sum and accumulation, six
// table lookups, an exp and, on the sphere branch, a log for the radial bin,
// while each row's bytes (q, k, v, the projections) need moving once: at the
// windows of the SphereFormer levels the pairs' arithmetic sets the work,
// and how well the lanes are kept busy on it sets the time. The design:
//   * one block is one warp of 32 consecutive query rows of one head; lane t
//     owns row t and keeps q, the running max, the running sum and the D-wide
//     output in registers: a single pass with online rescaling. Warps share
//     nothing and never wait for each other;
//   * each lane walks the keys of its own window only, [start, end) from
//     wattn::warp_run_bounds (one ballot of the warp's run-start flags): no
//     step lands on a key of another window, and no tile range is read;
//   * a key's row (k, v, kT, coordinates, range) is read through the
//     read-only cache: lanes of one window read the same key at once, so the
//     reads broadcast. The lane's own lookups qT[i, a, idx_a] come from its
//     own row the same way, 32 rows per warp-wide load: L1 must hold the
//     warps' rows, and the launch leaves it half of the SM's unified memory
//     (SMEM_CARVEOUT). Staging those rows in shared memory (18.5 KB a warp)
//     left room for 7 warps an SM and measured slower at every level;
//   * the head's value table sits in shared memory, its (bin, axis) rows at
//     an odd stride (wattn::odd_stride), so that lanes reading the rows of
//     different bins hit different banks: a pair's three value-table rows
//     never touch device memory, and lanes conflict only where bins 32
//     apart meet;
//   * a lane takes NK = 2 keys per step: their scores and value rows are
//     independent chains (a step past the run's end repeats its last key,
//     so no branch splits them), and wattn::softmax_join adds them to the
//     online softmax together, with one rescale to the step's max: the
//     per-key join's chain of dependent exps and rescales measured slower.
//     The next step's key coordinates and ranges are loaded a step ahead.
// It also writes each row's log-sum-exp, lse_i = m_i + log(l_i), which the
// backward kernels K4 and K5 use to recompute the probabilities. No atomics:
// two launches give the same bits.
// q, k, v may be f32 or bf16; everything else is f32, and so are the outputs.

#include "wattn_rpe_common.cuh"

namespace {

using wattn::WARP;
using wattn::clip_quant;
using wattn::load_row;
using wattn::odd_stride;
using wattn::radial_bin;

constexpr int NK = 2;          // keys per step of a lane
constexpr int MIN_BLOCKS = 8;  // resident warps per SM the registers must allow
// Half of the SM's unified L1 and shared memory as shared memory: room for
// 12 blocks' value tables, and ~124 KB of L1 for the lanes' own projection
// rows (18 KB a warp). The 72% of K4 and K5 (16 blocks, ~92 KB of L1) and
// the warp's rows staged in shared memory (7 blocks) measured slower.
constexpr int SMEM_CARVEOUT = 50;

// the head's value table, [3 L2][odd_stride(D)]
size_t smem_bytes(int D, int L2) { return sizeof(float) * (size_t)3 * L2 * odd_stride(D); }

template <typename T, int D>
__global__ void __launch_bounds__(WARP, MIN_BLOCKS)
wattn_rpe_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ rank, const int32_t* __restrict__ quant,
                     const float* __restrict__ r, const float* __restrict__ qT,
                     const float* __restrict__ kT, const float* __restrict__ tv,
                     float* __restrict__ out, float* __restrict__ lse, int H, int G, int L2,
                     float a) {
  extern __shared__ float smem[];
  const bool radial = r != nullptr;
  const int W = 3 * L2;            // projection row width
  const int TS = odd_stride(D);    // value-table row stride
  float* tv_s = smem;              // [L2 * 3][TS]: row l * 3 + axis, this head

  const int lane = threadIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.x * WARP, i = row0 + lane;
  const int n = gridDim.x * WARP;
  for (int e = lane; e < W * D; e += WARP) {
    const int la = e / D, dd = e % D;  // la = l * 3 + axis
    tv_s[la * TS + dd] = __ldg(tv + ((size_t)la * H + h) * D + dd);
  }
  int cqi[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) cqi[ax] = clip_quant(quant[i * 3 + ax], G);
  const float ri = radial ? r[i] : 0.f;
  const int2 run = wattn::warp_run_bounds(rank, row0, n, lane);
  __syncwarp();

  const size_t hi = (size_t)i * H + h;
  float qv[D], acc[D];
  load_row<D>(q + hi * D, qv);
#pragma unroll
  for (int dd = 0; dd < D; ++dd) acc[dd] = 0.f;
  const float* qT_i = qT + hi * W;

  // The keys' coordinates and ranges head each pair's chain (coordinates,
  // bins, lookups), so the next step's are loaded one step ahead: their
  // loads overlap this step's work.
  int cq_next[NK][3];
  float r_next[NK];
  auto fetch = [&](int j0) {
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      const int j = min(j0 + u, run.y - 1);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) cq_next[u][ax] = __ldg(quant + j * 3 + ax);
      r_next[u] = radial ? __ldg(r + j) : 0.f;
    }
  };
  fetch(run.x);

  float m = -INFINITY, l = 0.f;
  for (int j0 = run.x; j0 < run.y; j0 += NK) {
    float s[NK], val[NK][D];
    int cq[NK][3];
    float rj[NK];
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      rj[u] = r_next[u];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) cq[u][ax] = cq_next[u][ax];
    }
    fetch(j0 + NK);
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      const int j = min(j0 + u, run.y - 1);
      int col[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) col[ax] = cqi[ax] - clip_quant(cq[u][ax], G) + G - 1;
      if (radial) col[2] = radial_bin(ri - rj[u], a, 2 * G);
      const size_t hj = (size_t)j * H + h;
      float kk[D];
      load_row<D>(k + hj * D, kk);
      load_row<D>(v + hj * D, val[u]);
      float sc = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) sc = fmaf(qv[dd], kk[dd], sc);
      const float* kT_j = kT + hj * W;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        sc += __ldg(qT_i + ax * L2 + col[ax]) + __ldg(kT_j + ax * L2 + col[ax]);
      s[u] = sc;
      const float* t0 = tv_s + (col[0] * 3 + 0) * TS;
      const float* t1 = tv_s + (col[1] * 3 + 1) * TS;
      const float* t2 = tv_s + (col[2] * 3 + 2) * TS;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) val[u][dd] = val[u][dd] + t0[dd] + t1[dd] + t2[dd];
    }
    wattn::softmax_join<NK, D>(s, val, run.y - j0, m, l, acc);
  }

  // every row attends at least itself, so l > 0
  const float inv = 1.f / l;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) out[hi * D + dd] = acc[dd] * inv;
  lse[hi] = m + logf(l);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* rank, const void* quant,
           const void* r, const void* qT, const void* kT, const void* tv, void* out, void* lse,
           int N, int H, int G, int L2, float a, void* stream) {
  if (N % WARP || !wattn::row_aligned(q, D, sizeof(T)) || !wattn::row_aligned(k, D, sizeof(T)) ||
      !wattn::row_aligned(v, D, sizeof(T)))
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = smem_bytes(D, L2);
  auto kern = wattn_rpe_fwd_kernel<T, D>;
  cudaError_t e = wattn::configure_smem(kern, smem, SMEM_CARVEOUT);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / WARP, H);
  kern<<<grid, WARP, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)rank, (const int32_t*)quant,
      (const float*)r, (const float*)qT, (const float*)kT, (const float*)tv, (float*)out,
      (float*)lse, H, G, L2, a);
  return (int)cudaGetLastError();
}

// the launch's shared bytes and resident blocks and warps per SM into out[3]
template <typename T, int D>
int occupancy(int L2, int* out) {
  return wattn::warp_occupancy(wattn_rpe_fwd_kernel<T, D>, smem_bytes(D, L2), SMEM_CARVEOUT,
                               out);
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const void* rank,
             const void* quant, const void* r, const void* qT, const void* kT, const void* tv,
             void* out, void* lse, int N, int H, int G, int L2, float a, void* stream) {
#define WATTN_FWD_LAUNCH(DD) \
  launch<T, DD>(q, k, v, rank, quant, r, qT, kT, tv, out, lse, N, H, G, L2, a, stream)
  WATTN_HEAD_DIM_SWITCH(D, WATTN_FWD_LAUNCH)
#undef WATTN_FWD_LAUNCH
}

}  // namespace

extern "C" {

// Sorted inputs: q, k, v [N, H, D]; rank [N] f32; quant [N, 3] int32; r [N]
// f32 or NULL (cubic branch); qT, kT [N, H, 3, L2] f32; tv [L2, 3, H, D] f32;
// out [N, H, D] f32; lse [N, H] f32. D in {4, 8, 16, 32}, N a multiple of
// 32, q, k and v aligned to their rows' loads. Returns the cudaError_t of the
// launch.
int wattn_rpe_fwd_f32(const void* q, const void* k, const void* v, const void* rank,
                      const void* quant, const void* r, const void* qT, const void* kT,
                      const void* tv, void* out, void* lse, int N, int H, int D, int G, int L2,
                      float a, void* stream) {
  return dispatch<float>(D, q, k, v, rank, quant, r, qT, kT, tv, out, lse, N, H, G, L2, a,
                         stream);
}

int wattn_rpe_fwd_bf16(const void* q, const void* k, const void* v, const void* rank,
                       const void* quant, const void* r, const void* qT, const void* kT,
                       const void* tv, void* out, void* lse, int N, int H, int D, int G, int L2,
                       float a, void* stream) {
  return dispatch<__nv_bfloat16>(D, q, k, v, rank, quant, r, qT, kT, tv, out, lse, N, H, G, L2,
                                 a, stream);
}

// The kernel's shared bytes per block and resident blocks and warps per SM
// into out[3], for bf16 (1) or f32 (0) inputs of head dim D at G, on the
// sphere branch (radial 1, L2 = 2G) or the cubic one (L2 = 2G - 1). Returns
// the cudaError_t.
int wattn_rpe_fwd_occupancy(int bf16, int D, int G, int radial, int* out) {
  const int L2 = radial ? 2 * G : 2 * G - 1;
#define WATTN_FWD_OCC_F32(DD) occupancy<float, DD>(L2, out)
#define WATTN_FWD_OCC_BF16(DD) occupancy<__nv_bfloat16, DD>(L2, out)
  if (bf16) {
    WATTN_HEAD_DIM_SWITCH(D, WATTN_FWD_OCC_BF16)
  }
  WATTN_HEAD_DIM_SWITCH(D, WATTN_FWD_OCC_F32)
#undef WATTN_FWD_OCC_F32
#undef WATTN_FWD_OCC_BF16
}

}  // extern "C"
