// Window attention with contextual relative position encoding, backward over
// key rows (kernel K5).
//
// With the notation of K4 (wattn_rpe_bwd_q.cu): p_ij = exp(s_ij - lse_i),
// dp_ij = do_i . v_j + sum_a edo[i, a, idx_a], ds_ij = p_ij (dp_ij - dfac_i).
// This kernel writes the key-side sums
//
//   dk[j]          = sum_i ds_ij q_i
//   dv[j]          = sum_i p_ij do_i
//   mk[j, a, l]    = sum_i ds_ij [idx_a = l]     (the gradient of kT)
//
// A key's partner queries are the rows of its own window, a contiguous run
// of the sorted rows, as its partner keys were in the forward.
//
// Replaces the TPU kernel u2mkd_tpu/ops/pallas/wattn_kernel.py:_call_bwd_k
// (body _bwd_k_kernel) with the dk/dTk part of the epilogue
// _flash_rpe_bwd; the epilogue's einsums (dk and dTk from mk) stay in torch,
// as they stayed in XLA.
//
// What bounds it on the H100. The bytes, as for K4: the dense [N, h, 3, L2]
// f32 arrays (qT, kT and edo read, mk written) dominate them. Per pair and
// head: ~8*D flops (two dot products, the dk and dv updates), nine table
// lookups, an exp, three mass updates and, on the sphere branch, a log; what
// costs is moving the lookups to the lanes. Design, the mirror of K4:
//   * one block is one warp of 32 consecutive key rows of one head; lane t
//     owns key row t, with k, v and the dk and dv sums in registers;
//   * each lane walks the queries of its own window only, found by
//     wattn::warp_run_bounds; a query's row (q, do, qT, edo, lse, dfac,
//     coordinates, range) is read through the read-only cache, broadcast to
//     the lanes of one window, and the lane's own lookups kT[j, a, idx_a]
//     from its own row;
//   * only the ds mass sits in shared memory, one row of 3G (4G on the
//     sphere branch) floats per key at an odd stride: 10-13 KB a block at
//     G = 24, and the registers are held to 128 a thread, so that 14-16
//     warps stay resident on an SM at D <= 16 beside the L1 that holds the
//     lanes' own kT rows (wattn::BWD_SMEM_CARVEOUT);
//   * a lane takes one query per step: two or four per step, with
//     independent score and exp chains, measured no faster at the main
//     path's shapes and slower at its levels 2-4 (PERF.md);
//   * the mass goes back to the [3, L2] bin layout at the end, coalesced.
// No atomics: every sum is taken by the lane that owns its row, in query
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

// resident warps per SM the registers must allow: 128 registers a thread
// hold k, v, dk and dv (4 * D) at D <= 16
constexpr int min_blocks(int D) { return D <= 16 ? 16 : 8; }

size_t smem_bytes(int G, bool radial) {
  return sizeof(float) * (size_t)WARP * odd_stride(mass_width(radial, G)) +
         sizeof(int) * 3 * WARP;
}

template <typename T, int D>
__global__ void __launch_bounds__(WARP, min_blocks(D))
wattn_rpe_bwd_k_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ rank, const int32_t* __restrict__ quant,
                       const float* __restrict__ r, const float* __restrict__ qT,
                       const float* __restrict__ kT, const float* __restrict__ edo,
                       const float* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ dfac, float* __restrict__ dk,
                       float* __restrict__ dv, float* __restrict__ mk, int H, int G, int L2,
                       float a) {
  extern __shared__ float smem[];
  const bool radial = r != nullptr;
  const int MS = odd_stride(mass_width(radial, G));
  const int W = 3 * L2;
  float* mk_s = smem;                                  // [WARP][MS] ds masses
  int* cq_s = reinterpret_cast<int*>(mk_s + WARP * MS);  // [WARP][3] the rows' own

  const int lane = threadIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.x * WARP, j = row0 + lane;
  const int n = gridDim.x * WARP;
  for (int e = lane; e < WARP * MS; e += WARP) mk_s[e] = 0.f;
  int cqj[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    cqj[ax] = clip_quant(quant[j * 3 + ax], G);
    cq_s[lane * 3 + ax] = cqj[ax];
  }
  const int2 run = wattn::warp_run_bounds(rank, row0, n, lane);
  __syncwarp();

  const size_t hj = (size_t)j * H + h;
  float kv[D], vv[D], dkv[D], dvv[D];
  load_row<D>(k + hj * D, kv);
  load_row<D>(v + hj * D, vv);
#pragma unroll
  for (int dd = 0; dd < D; ++dd) dkv[dd] = dvv[dd] = 0.f;
  const float rj = radial ? r[j] : 0.f;
  const float* kT_j = kT + hj * W;
  float* my_mk = mk_s + lane * MS;

  for (int i = run.x; i < run.y; ++i) {
    int slot[3], col[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const int c = clip_quant(__ldg(quant + i * 3 + ax), G);
      slot[ax] = ax * G + c;
      col[ax] = ax * L2 + c - cqj[ax] + G - 1;
    }
    if (radial) {
      const int l = radial_bin(__ldg(r + i) - rj, a, 2 * G);
      slot[2] = 2 * G + l;
      col[2] = 2 * L2 + l;
    }
    const size_t hi = (size_t)i * H + h;
    float qq[D], dd_[D];
    load_row<D>(q + hi * D, qq);
    load_row<D>(dout + hi * D, dd_);
    float s = 0.f, dp = 0.f;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      s = fmaf(qq[dd], kv[dd], s);
      dp = fmaf(dd_[dd], vv[dd], dp);
    }
    const float* qT_i = qT + hi * W;
    const float* e_i = edo + hi * W;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      s += __ldg(qT_i + col[ax]) + __ldg(kT_j + col[ax]);
      dp += __ldg(e_i + col[ax]);
    }
    const float p = expf(s - __ldg(lse + hi));
    const float ds = p * (dp - __ldg(dfac + hi));
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      dkv[dd] = fmaf(ds, qq[dd], dkv[dd]);
      dvv[dd] = fmaf(p, dd_[dd], dvv[dd]);
    }
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) my_mk[slot[ax]] += ds;
  }

#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    dk[hj * D + dd] = dkv[dd];
    dv[hj * D + dd] = dvv[dd];
  }
  __syncwarp();
  // back to the [3, L2] bin layout: bin l of a difference axis holds the mass
  // of partner coordinate c = l + cq - (G - 1)
  for (int e = lane; e < WARP * W; e += WARP) {
    const int row = e / W, col = e % W;
    const int ax = col / L2, l = col % L2;
    int m;
    if (ax == 2 && radial) {
      m = 2 * G + l;
    } else {
      const int c = l + cq_s[row * 3 + ax] - (G - 1);
      m = (c >= 0 && c < G) ? ax * G + c : -1;
    }
    mk[((size_t)(row0 + row) * H + h) * W + col] = m >= 0 ? mk_s[row * MS + m] : 0.f;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* rank, const void* quant,
           const void* r, const void* qT, const void* kT, const void* edo, const void* dout,
           const void* lse, const void* dfac, void* dk, void* dv, void* mk, int N, int H, int G,
           int L2, float a, void* stream) {
  if (N % WARP || !wattn::row_aligned(q, D, sizeof(T)) || !wattn::row_aligned(k, D, sizeof(T)) ||
      !wattn::row_aligned(v, D, sizeof(T)) || !wattn::row_aligned(dout, D, sizeof(float)))
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = smem_bytes(G, r != nullptr);
  auto kern = wattn_rpe_bwd_k_kernel<T, D>;
  cudaError_t e = wattn::configure_smem(kern, smem, wattn::BWD_SMEM_CARVEOUT);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / WARP, H);
  kern<<<grid, WARP, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)rank, (const int32_t*)quant,
      (const float*)r, (const float*)qT, (const float*)kT, (const float*)edo,
      (const float*)dout, (const float*)lse, (const float*)dfac, (float*)dk, (float*)dv,
      (float*)mk, H, G, L2, a);
  return (int)cudaGetLastError();
}

// the launch's shared bytes and resident blocks and warps per SM into out[3]
template <typename T, int D>
int occupancy(int G, bool radial, int* out) {
  return wattn::warp_occupancy(wattn_rpe_bwd_k_kernel<T, D>, smem_bytes(G, radial),
                               wattn::BWD_SMEM_CARVEOUT, out);
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const void* rank,
             const void* quant, const void* r, const void* qT, const void* kT, const void* edo,
             const void* dout, const void* lse, const void* dfac, void* dk, void* dv, void* mk,
             int N, int H, int G, int L2, float a, void* stream) {
#define WATTN_BWD_K_LAUNCH(DD)                                                               \
  launch<T, DD>(q, k, v, rank, quant, r, qT, kT, edo, dout, lse, dfac, dk, dv, mk, N, H, G, \
                L2, a, stream)
  WATTN_HEAD_DIM_SWITCH(D, WATTN_BWD_K_LAUNCH)
#undef WATTN_BWD_K_LAUNCH
}

}  // namespace

extern "C" {

// Sorted inputs as for wattn_rpe_bwd_q_*. Outputs: dk, dv [N, H, D] f32; mk
// [N, H, 3, L2] f32. D in {4, 8, 16, 32}. Returns the cudaError_t of the
// launch.
int wattn_rpe_bwd_k_f32(const void* q, const void* k, const void* v, const void* rank,
                        const void* quant, const void* r, const void* qT, const void* kT,
                        const void* edo, const void* dout, const void* lse, const void* dfac,
                        void* dk, void* dv, void* mk, int N, int H, int D, int G, int L2, float a,
                        void* stream) {
  return dispatch<float>(D, q, k, v, rank, quant, r, qT, kT, edo, dout, lse, dfac, dk, dv, mk,
                         N, H, G, L2, a, stream);
}

int wattn_rpe_bwd_k_bf16(const void* q, const void* k, const void* v, const void* rank,
                         const void* quant, const void* r, const void* qT, const void* kT,
                         const void* edo, const void* dout, const void* lse, const void* dfac,
                         void* dk, void* dv, void* mk, int N, int H, int D, int G, int L2, float a,
                         void* stream) {
  return dispatch<__nv_bfloat16>(D, q, k, v, rank, quant, r, qT, kT, edo, dout, lse, dfac, dk,
                                 dv, mk, N, H, G, L2, a, stream);
}

// As wattn_rpe_bwd_q_occupancy, for this kernel.
int wattn_rpe_bwd_k_occupancy(int bf16, int D, int G, int radial, int* out) {
#define WATTN_BWD_K_OCC_F32(DD) occupancy<float, DD>(G, radial != 0, out)
#define WATTN_BWD_K_OCC_BF16(DD) occupancy<__nv_bfloat16, DD>(G, radial != 0, out)
  if (bf16) {
    WATTN_HEAD_DIM_SWITCH(D, WATTN_BWD_K_OCC_BF16)
  }
  WATTN_HEAD_DIM_SWITCH(D, WATTN_BWD_K_OCC_F32)
#undef WATTN_BWD_K_OCC_F32
#undef WATTN_BWD_K_OCC_BF16
}

}  // extern "C"
