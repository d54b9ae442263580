// Window attention with contextual relative position encoding, backward over
// query tiles (kernel K4).
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
// What bounds it on the H100. Per pair and head: ~6*D flops (two dot
// products and the dq update), nine table lookups, an exp, six mass updates
// and, on the sphere branch, a log for the radial bin; each row's bytes are
// read once per tile. The pairs' arithmetic bounds it. Design:
//   * one block per (128-query tile, head); thread t owns query t of the
//     tile, with q, do and the dq sum in registers;
//   * a query's partner keys have one coordinate c in [0, G) per difference
//     axis, so its lookups qT[i, a, idx_a] and edo[i, a, idx_a] and its masses
//     are indexed by c (the "shifted mass" of the TPU epilogue): 3G floats a
//     row (4G with the 2G radial bins) instead of 3 * L2. The block keeps four
//     such rows per query in shared memory (lookups of qT and edo, the two
//     masses), at an odd stride, so the 32 threads of a warp, which read the
//     same key at once, touch 32 distinct banks;
//   * the block walks its tile's key range [kmin, kmax) from the host
//     geometry in chunks of 32 keys staged in shared memory (k, v, the key
//     projections, rank, coordinates, range), skipping keys of other windows;
//   * at the end the masses are written back in the [3, L2] bin layout,
//     coalesced, with zeros in the bins no partner reaches.
// At G = 24 the block takes ~220 KB of shared memory: one block per SM.
// q, k, v may be f32 or bf16; everything else is f32, and so are the outputs.

#include "wattn_rpe_common.cuh"

namespace {

using wattn::KC;
using wattn::TQ;
using wattn::clip_quant;
using wattn::mass_width;
using wattn::odd_stride;
using wattn::radial_bin;
using wattn::to_f;

template <int D>
size_t smem_bytes(int G, int L2, bool radial) {
  const int ms = odd_stride(mass_width(radial, G));
  const int rs = odd_stride(3 * L2);
  return sizeof(float) * ((size_t)4 * TQ * ms + (size_t)KC * rs + 2 * KC * D + 2 * KC) +
         sizeof(int) * (3 * KC + 3 * TQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(TQ)
wattn_rpe_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ rank, const int32_t* __restrict__ quant,
                       const float* __restrict__ r, const int32_t* __restrict__ kmin,
                       const int32_t* __restrict__ kmax, const float* __restrict__ qT,
                       const float* __restrict__ kT, const float* __restrict__ edo,
                       const float* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ dfac, float* __restrict__ dq,
                       float* __restrict__ mq, float* __restrict__ pm, int H, int G, int L2,
                       float a) {
  extern __shared__ float smem[];
  const bool radial = r != nullptr;
  const int MW = mass_width(radial, G), MS = odd_stride(MW);
  const int W = 3 * L2, RS = odd_stride(W);
  float* qsel = smem;                // [TQ][MS] qT of each query by partner slot
  float* esel = qsel + TQ * MS;      // [TQ][MS] edo likewise
  float* mq_s = esel + TQ * MS;      // [TQ][MS] ds masses
  float* pm_s = mq_s + TQ * MS;      // [TQ][MS] p masses
  float* kT_s = pm_s + TQ * MS;      // [KC][RS]
  float* k_s = kT_s + KC * RS;       // [KC][D]
  float* v_s = k_s + KC * D;         // [KC][D]
  float* rank_s = v_s + KC * D;      // [KC]
  float* r_s = rank_s + KC;          // [KC]
  int* cq_s = reinterpret_cast<int*>(r_s + KC);  // [KC][3]
  int* cqt_s = cq_s + 3 * KC;                     // [TQ][3] the tile's own

  const int tile = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int i = tile * TQ + tid;
  const size_t row0 = (size_t)tile * TQ;

#pragma unroll
  for (int ax = 0; ax < 3; ++ax) cqt_s[tid * 3 + ax] = clip_quant(quant[i * 3 + ax], G);
  __syncthreads();
  // slot m of a row: axis min(m / G, 2), partner coordinate (or radial bin)
  // c = m - axis * G, table column cq - c + G - 1 (or c on the radial axis)
  for (int e = tid; e < TQ * MW; e += TQ) {
    const int row = e / MW, m = e % MW;
    const int ax = min(m / G, 2), c = m - ax * G;
    const int col = (ax == 2 && radial) ? c : cqt_s[row * 3 + ax] - c + G - 1;
    const size_t gi = ((row0 + row) * H + h) * W + ax * L2 + col;
    qsel[row * MS + m] = qT[gi];
    esel[row * MS + m] = edo[gi];
    mq_s[row * MS + m] = 0.f;
    pm_s[row * MS + m] = 0.f;
  }

  float qv[D], dov[D], acc[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    qv[dd] = to_f(q[((size_t)i * H + h) * D + dd]);
    dov[dd] = dout[((size_t)i * H + h) * D + dd];
    acc[dd] = 0.f;
  }
  const float my_rank = rank[i];
  const float ri = radial ? r[i] : 0.f;
  const float lse_i = lse[(size_t)i * H + h];
  const float dfac_i = dfac[(size_t)i * H + h];
  int cqi[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) cqi[ax] = cqt_s[tid * 3 + ax];
  float* my_q = qsel + tid * MS;
  float* my_e = esel + tid * MS;
  float* my_mq = mq_s + tid * MS;
  float* my_pm = pm_s + tid * MS;

  const int k0 = kmin[tile], k1 = kmax[tile];
  for (int c0 = k0; c0 < k1; c0 += KC) {
    const int nk = min(KC, k1 - c0);
    __syncthreads();  // the previous chunk is consumed; the tile staging is complete
    for (int e = tid; e < nk * W; e += TQ) {
      const int row = e / W, col = e % W;
      kT_s[row * RS + col] = kT[((size_t)(c0 + row) * H + h) * W + col];
    }
    for (int e = tid; e < nk * D; e += TQ) {
      const int row = e / D, dd = e % D;
      const size_t gi = ((size_t)(c0 + row) * H + h) * D + dd;
      k_s[e] = to_f(k[gi]);
      v_s[e] = to_f(v[gi]);
    }
    if (tid < nk) {
      const int j = c0 + tid;
      rank_s[tid] = rank[j];
      r_s[tid] = radial ? r[j] : 0.f;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) cq_s[tid * 3 + ax] = clip_quant(quant[j * 3 + ax], G);
    }
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      if (rank_s[j] != my_rank) continue;
      int slot[3], col[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const int c = cq_s[j * 3 + ax];
        slot[ax] = ax * G + c;
        col[ax] = ax * L2 + cqi[ax] - c + G - 1;
      }
      if (radial) {
        const int l = radial_bin(ri - r_s[j], a, 2 * G);
        slot[2] = 2 * G + l;
        col[2] = 2 * L2 + l;
      }
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        s = fmaf(qv[dd], k_s[j * D + dd], s);
        dp = fmaf(dov[dd], v_s[j * D + dd], dp);
      }
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        s += my_q[slot[ax]] + kT_s[j * RS + col[ax]];
        dp += my_e[slot[ax]];
      }
      const float p = expf(s - lse_i);
      const float ds = p * (dp - dfac_i);
#pragma unroll
      for (int dd = 0; dd < D; ++dd) acc[dd] = fmaf(ds, k_s[j * D + dd], acc[dd]);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        my_mq[slot[ax]] += ds;
        my_pm[slot[ax]] += p;
      }
    }
  }

#pragma unroll
  for (int dd = 0; dd < D; ++dd) dq[((size_t)i * H + h) * D + dd] = acc[dd];
  __syncthreads();
  // back to the [3, L2] bin layout: bin l of a difference axis holds the mass
  // of partner coordinate c = cq + G - 1 - l
  for (int e = tid; e < TQ * W; e += TQ) {
    const int row = e / W, col = e % W;
    const int ax = col / L2, l = col % L2;
    int m;
    if (ax == 2 && radial) {
      m = 2 * G + l;
    } else {
      const int c = cqt_s[row * 3 + ax] + G - 1 - l;
      m = (c >= 0 && c < G) ? ax * G + c : -1;
    }
    const size_t gi = ((row0 + row) * H + h) * W + col;
    mq[gi] = m >= 0 ? mq_s[row * MS + m] : 0.f;
    pm[gi] = m >= 0 ? pm_s[row * MS + m] : 0.f;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* rank, const void* quant,
           const void* r, const void* kmin, const void* kmax, const void* qT, const void* kT,
           const void* edo, const void* dout, const void* lse, const void* dfac, void* dq,
           void* mq, void* pm, int N, int H, int G, int L2, float a, void* stream) {
  const size_t smem = smem_bytes<D>(G, L2, r != nullptr);
  auto kern = wattn_rpe_bwd_q_kernel<T, D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / TQ, H);
  kern<<<grid, TQ, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)rank, (const int32_t*)quant,
      (const float*)r, (const int32_t*)kmin, (const int32_t*)kmax, (const float*)qT,
      (const float*)kT, (const float*)edo, (const float*)dout, (const float*)lse,
      (const float*)dfac, (float*)dq, (float*)mq, (float*)pm, H, G, L2, a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const void* rank,
             const void* quant, const void* r, const void* kmin, const void* kmax,
             const void* qT, const void* kT, const void* edo, const void* dout, const void* lse,
             const void* dfac, void* dq, void* mq, void* pm, int N, int H, int G, int L2,
             float a, void* stream) {
#define WATTN_BWD_Q_CASE(DD)                                                                  \
  case DD:                                                                                    \
    return launch<T, DD>(q, k, v, rank, quant, r, kmin, kmax, qT, kT, edo, dout, lse, dfac,  \
                         dq, mq, pm, N, H, G, L2, a, stream);
  switch (D) {
    WATTN_BWD_Q_CASE(4)
    WATTN_BWD_Q_CASE(8)
    WATTN_BWD_Q_CASE(16)
    WATTN_BWD_Q_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WATTN_BWD_Q_CASE
}

}  // namespace

extern "C" {

// Sorted inputs: q, k, v [N, H, D]; rank [N] f32; quant [N, 3] int32; r [N]
// f32 or NULL (cubic branch); kmin, kmax [N / 128] int32; qT, kT, edo
// [N, H, 3, L2] f32; dout [N, H, D] f32; lse, dfac [N, H] f32. Outputs: dq
// [N, H, D] f32; mq, pm [N, H, 3, L2] f32. D in {4, 8, 16, 32}. Returns the
// cudaError_t of the launch.
int wattn_rpe_bwd_q_f32(const void* q, const void* k, const void* v, const void* rank,
                        const void* quant, const void* r, const void* kmin, const void* kmax,
                        const void* qT, const void* kT, const void* edo, const void* dout,
                        const void* lse, const void* dfac, void* dq, void* mq, void* pm, int N,
                        int H, int D, int G, int L2, float a, void* stream) {
  return dispatch<float>(D, q, k, v, rank, quant, r, kmin, kmax, qT, kT, edo, dout, lse, dfac,
                         dq, mq, pm, N, H, G, L2, a, stream);
}

int wattn_rpe_bwd_q_bf16(const void* q, const void* k, const void* v, const void* rank,
                         const void* quant, const void* r, const void* kmin, const void* kmax,
                         const void* qT, const void* kT, const void* edo, const void* dout,
                         const void* lse, const void* dfac, void* dq, void* mq, void* pm, int N,
                         int H, int D, int G, int L2, float a, void* stream) {
  return dispatch<__nv_bfloat16>(D, q, k, v, rank, quant, r, kmin, kmax, qT, kT, edo, dout, lse,
                                 dfac, dq, mq, pm, N, H, G, L2, a, stream);
}

}  // extern "C"
