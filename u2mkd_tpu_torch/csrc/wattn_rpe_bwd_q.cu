// Window attention with contextual relative position encoding, backward over
// query rows (kernel K4).
//
// The forward (K3, wattn_rpe_fwd.cu) computes, per head, for query i and key
// j of one window (bins idx_a as in wattn_rpe_common.cuh):
//
//   s_ij  = q_i . k_j + sum_a qT[i, a, idx_a] + sum_a kT[j, a, idx_a]
//   out_i = sum_j p_ij (v_j + sum_a Tv[idx_a, a]),   p_ij = exp(s_ij - lse_i)
//
// With do_i the gradient of out_i, edo[i, a, l] = do_i . Tv[l, a] and
// dfac_i = do_i . out_i, the backward of a pair is
//
//   dp_ij = do_i . v_j + sum_a edo[i, a, idx_a],   ds_ij = p_ij (dp_ij - dfac_i)
//
// and this kernel writes the query-side sums
//
//   dq[i]          = sum_j ds_ij k_j
//   mq[i, a, l]    = sum_j ds_ij [idx_a = l]     (the gradient of qT)
//   pm[i, a, l]    = sum_j p_ij  [idx_a = l]     (dTv = sum_i pm[i] (x) do_i)
//
// K5 (wattn_rpe_bwd_k.cu) writes the key-side sums. The wrapper turns mq
// into dq and dTq through the einsum of the projection, as the JAX package's
// XLA epilogue does.
//
// Replaces the TPU kernel u2mkd_tpu/ops/pallas/wattn_kernel.py:_call_bwd_q
// (body _bwd_q_kernel) with the gradient prologue _build_gcat. The TPU kernel
// packs each head's terms into 128-lane segments so that every term is an MXU
// matmul, and splits heads into groups (_split_heads) to fit its scoped
// VMEM; neither is needed here.
//
// What bounds it on the H100. The bytes: the dense [N, h, 3, L2] f32 arrays
// (qT, kT and edo read, mq and pm written) dominate them. Per pair and head
// the work is ~6*D flops, nine table lookups, an exp, six mass updates and,
// on the sphere branch, a log for the radial bin, far below the f32 rate at
// these pair counts; what costs is moving the lookups to the lanes, six of
// them from the lane's own row, which no other lane shares. Design:
//   * one block is one warp of 32 consecutive query rows of one head; lane t
//     owns query row t, with q, do and the dq sum in registers. Warps share
//     nothing and never wait for each other;
//   * each lane walks the keys of its own window only: windows are contiguous
//     runs of the sorted rows, and wattn::warp_run_bounds finds each lane's
//     run from one ballot of its warp's run-start flags. No step lands on a
//     key of another window, and no tile range is needed;
//   * a key's row (k, v, kT, coordinates, range) is read through the
//     read-only cache: lanes of one window read the same key at once, so the
//     reads broadcast. The lane's own lookups qT[i, a, idx_a] and
//     edo[i, a, idx_a] are read from its own row the same way: 32 rows per
//     warp-wide load, so L1 must hold the warps' rows, and the launch leaves
//     it room (wattn::BWD_SMEM_CARVEOUT);
//   * only the two masses sit in shared memory, indexed by the partner's
//     coordinate c in [0, G) per difference axis (the "shifted mass" of the
//     TPU epilogue): 3G floats a row (4G with the 2G radial bins) instead of
//     3 * L2, at an odd stride, so that lanes adding to the same slot of
//     their own rows touch distinct banks. At G = 24 a block takes 19-26 KB:
//     six to nine warps resident on an SM beside that L1;
//   * a lane takes NK = 2 keys per step: their scores and exps are
//     independent chains (a step past the run's end repeats its last key, so
//     that no branch splits them), and their terms are then added in key
//     order, so the result is that of one key at a time;
//   * at the end the masses are written back in the [3, L2] bin layout,
//     coalesced, with zeros in the bins no partner reaches.
// No atomics: every sum is taken by the lane that owns its row, in key
// order, so two launches give the same bits.
// q, k, v may be f32 or bf16; everything else is f32, and so are the outputs.

#include "wattn_rpe_common.cuh"

namespace {

using wattn::WARP;
using wattn::clip_quant;
using wattn::load_row;
using wattn::mass_width;
using wattn::odd_stride;
using wattn::radial_bin;

constexpr int NK = 2;         // keys per step of a lane
constexpr int MIN_BLOCKS = 8;  // resident warps per SM the registers must allow

size_t smem_bytes(int G, bool radial) {
  return sizeof(float) * (size_t)2 * WARP * odd_stride(mass_width(radial, G)) +
         sizeof(int) * 3 * WARP;
}

template <typename T, int D>
__global__ void __launch_bounds__(WARP, MIN_BLOCKS)
wattn_rpe_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ rank, const int32_t* __restrict__ quant,
                       const float* __restrict__ r, const float* __restrict__ qT,
                       const float* __restrict__ kT, const float* __restrict__ edo,
                       const float* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ dfac, float* __restrict__ dq,
                       float* __restrict__ mq, float* __restrict__ pm, int H, int G, int L2,
                       float a) {
  extern __shared__ float smem[];
  const bool radial = r != nullptr;
  const int MS = odd_stride(mass_width(radial, G));
  const int W = 3 * L2;
  float* mq_s = smem;                                  // [WARP][MS] ds masses
  float* pm_s = mq_s + WARP * MS;                      // [WARP][MS] p masses
  int* cq_s = reinterpret_cast<int*>(pm_s + WARP * MS);  // [WARP][3] the rows' own

  const int lane = threadIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.x * WARP, i = row0 + lane;
  const int n = gridDim.x * WARP;
  for (int e = lane; e < 2 * WARP * MS; e += WARP) smem[e] = 0.f;
  int cqi[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    cqi[ax] = clip_quant(quant[i * 3 + ax], G);
    cq_s[lane * 3 + ax] = cqi[ax];
  }
  const int2 run = wattn::warp_run_bounds(rank, row0, n, lane);
  __syncwarp();

  const size_t hi = (size_t)i * H + h;
  float qv[D], dov[D], acc[D];
  load_row<D>(q + hi * D, qv);
  load_row<D>(dout + hi * D, dov);
#pragma unroll
  for (int dd = 0; dd < D; ++dd) acc[dd] = 0.f;
  const float ri = radial ? r[i] : 0.f;
  const float lse_i = lse[hi], dfac_i = dfac[hi];
  const float* qT_i = qT + hi * W;
  const float* e_i = edo + hi * W;
  float* my_mq = mq_s + lane * MS;
  float* my_pm = pm_s + lane * MS;

  for (int j0 = run.x; j0 < run.y; j0 += NK) {
    float p[NK], ds[NK], kk[NK][D];
    int slot[NK][3];
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      const int j = min(j0 + u, run.y - 1);
      int col[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const int c = clip_quant(__ldg(quant + j * 3 + ax), G);
        slot[u][ax] = ax * G + c;
        col[ax] = ax * L2 + cqi[ax] - c + G - 1;
      }
      if (radial) {
        const int l = radial_bin(ri - __ldg(r + j), a, 2 * G);
        slot[u][2] = 2 * G + l;
        col[2] = 2 * L2 + l;
      }
      const size_t hj = (size_t)j * H + h;
      float vv[D];
      load_row<D>(k + hj * D, kk[u]);
      load_row<D>(v + hj * D, vv);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        s = fmaf(qv[dd], kk[u][dd], s);
        dp = fmaf(dov[dd], vv[dd], dp);
      }
      const float* kT_j = kT + hj * W;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        s += __ldg(qT_i + col[ax]) + __ldg(kT_j + col[ax]);
        dp += __ldg(e_i + col[ax]);
      }
      p[u] = expf(s - lse_i);
      ds[u] = p[u] * (dp - dfac_i);
    }
#pragma unroll
    for (int u = 0; u < NK; ++u) {
      if (j0 + u >= run.y) continue;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) acc[dd] = fmaf(ds[u], kk[u][dd], acc[dd]);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        my_mq[slot[u][ax]] += ds[u];
        my_pm[slot[u][ax]] += p[u];
      }
    }
  }

#pragma unroll
  for (int dd = 0; dd < D; ++dd) dq[hi * D + dd] = acc[dd];
  __syncwarp();
  // back to the [3, L2] bin layout: bin l of a difference axis holds the mass
  // of partner coordinate c = cq + G - 1 - l
  for (int e = lane; e < WARP * W; e += WARP) {
    const int row = e / W, col = e % W;
    const int ax = col / L2, l = col % L2;
    int m;
    if (ax == 2 && radial) {
      m = 2 * G + l;
    } else {
      const int c = cq_s[row * 3 + ax] + G - 1 - l;
      m = (c >= 0 && c < G) ? ax * G + c : -1;
    }
    const size_t gi = ((size_t)(row0 + row) * H + h) * W + col;
    mq[gi] = m >= 0 ? mq_s[row * MS + m] : 0.f;
    pm[gi] = m >= 0 ? pm_s[row * MS + m] : 0.f;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* rank, const void* quant,
           const void* r, const void* qT, const void* kT, const void* edo, const void* dout,
           const void* lse, const void* dfac, void* dq, void* mq, void* pm, int N, int H, int G,
           int L2, float a, void* stream) {
  if (N % WARP || !wattn::row_aligned(q, D, sizeof(T)) || !wattn::row_aligned(k, D, sizeof(T)) ||
      !wattn::row_aligned(v, D, sizeof(T)) || !wattn::row_aligned(dout, D, sizeof(float)))
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = smem_bytes(G, r != nullptr);
  auto kern = wattn_rpe_bwd_q_kernel<T, D>;
  cudaError_t e = wattn::configure_smem(kern, smem, wattn::BWD_SMEM_CARVEOUT);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / WARP, H);
  kern<<<grid, WARP, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)rank, (const int32_t*)quant,
      (const float*)r, (const float*)qT, (const float*)kT, (const float*)edo,
      (const float*)dout, (const float*)lse, (const float*)dfac, (float*)dq, (float*)mq,
      (float*)pm, H, G, L2, a);
  return (int)cudaGetLastError();
}

// the launch's shared bytes and resident blocks and warps per SM into out[3]
template <typename T, int D>
int occupancy(int G, bool radial, int* out) {
  return wattn::warp_occupancy(wattn_rpe_bwd_q_kernel<T, D>, smem_bytes(G, radial),
                               wattn::BWD_SMEM_CARVEOUT, out);
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const void* rank,
             const void* quant, const void* r, const void* qT, const void* kT, const void* edo,
             const void* dout, const void* lse, const void* dfac, void* dq, void* mq, void* pm,
             int N, int H, int G, int L2, float a, void* stream) {
#define WATTN_BWD_Q_LAUNCH(DD)                                                               \
  launch<T, DD>(q, k, v, rank, quant, r, qT, kT, edo, dout, lse, dfac, dq, mq, pm, N, H, G, \
                L2, a, stream)
  WATTN_HEAD_DIM_SWITCH(D, WATTN_BWD_Q_LAUNCH)
#undef WATTN_BWD_Q_LAUNCH
}

}  // namespace

extern "C" {

// Sorted inputs: q, k, v [N, H, D]; rank [N] f32; quant [N, 3] int32; r [N]
// f32 or NULL (cubic branch); qT, kT, edo [N, H, 3, L2] f32; dout [N, H, D]
// f32; lse, dfac [N, H] f32. Outputs: dq [N, H, D] f32; mq, pm [N, H, 3, L2]
// f32. D in {4, 8, 16, 32}, N a multiple of 32, q, k, v and dout aligned to
// their rows' loads. Returns the cudaError_t of the launch.
int wattn_rpe_bwd_q_f32(const void* q, const void* k, const void* v, const void* rank,
                        const void* quant, const void* r, const void* qT, const void* kT,
                        const void* edo, const void* dout, const void* lse, const void* dfac,
                        void* dq, void* mq, void* pm, int N, int H, int D, int G, int L2, float a,
                        void* stream) {
  return dispatch<float>(D, q, k, v, rank, quant, r, qT, kT, edo, dout, lse, dfac, dq, mq, pm,
                         N, H, G, L2, a, stream);
}

int wattn_rpe_bwd_q_bf16(const void* q, const void* k, const void* v, const void* rank,
                         const void* quant, const void* r, const void* qT, const void* kT,
                         const void* edo, const void* dout, const void* lse, const void* dfac,
                         void* dq, void* mq, void* pm, int N, int H, int D, int G, int L2, float a,
                         void* stream) {
  return dispatch<__nv_bfloat16>(D, q, k, v, rank, quant, r, qT, kT, edo, dout, lse, dfac, dq,
                                 mq, pm, N, H, G, L2, a, stream);
}

// The kernel's shared bytes per block and resident blocks and warps per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into out[3], for bf16 (1)
// or f32 (0) inputs of head dim D at G, on the sphere branch (radial 1) or
// the cubic one. Returns the cudaError_t.
int wattn_rpe_bwd_q_occupancy(int bf16, int D, int G, int radial, int* out) {
#define WATTN_BWD_Q_OCC_F32(DD) occupancy<float, DD>(G, radial != 0, out)
#define WATTN_BWD_Q_OCC_BF16(DD) occupancy<__nv_bfloat16, DD>(G, radial != 0, out)
  if (bf16) {
    WATTN_HEAD_DIM_SWITCH(D, WATTN_BWD_Q_OCC_BF16)
  }
  WATTN_HEAD_DIM_SWITCH(D, WATTN_BWD_Q_OCC_F32)
#undef WATTN_BWD_Q_OCC_F32
#undef WATTN_BWD_Q_OCC_BF16
}

}  // extern "C"
