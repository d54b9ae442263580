// Window attention with contextual relative position encoding, forward.
//
// Over a window-sorted sequence of N rows (N a multiple of 128), for query i
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
// work is ~4*D flops of dot product and value accumulation, six table
// lookups, an exp and, on the sphere branch, a log for the radial bin, while
// each row's bytes (q, k, v, the projections) are read once per query tile:
// the pairs' arithmetic bounds it, and windows of thousands of keys make the
// pair count, not the row count, the cost. The design:
//   * one block per (128-query tile, head); thread t owns query t of the tile
//     and keeps q, the running max, the running sum and the D-wide output in
//     registers: a single pass with online rescaling;
//   * the block walks only the keys of its tile's windows, [kmin, kmax) from
//     the host geometry, in chunks of 32 staged in shared memory (k, v, the
//     key projections, rank, quantized coordinates, range); every thread of a
//     warp reads the same key, so shared-memory reads broadcast;
//   * the tile's query projections and the head's value table sit in shared
//     memory for the whole block, so each pair's six lookups and three
//     value-table rows never touch device memory.
// It also writes each row's log-sum-exp, lse_i = m_i + log(l_i), which the
// backward kernels K4 and K5 use to recompute the probabilities.
// q, k, v may be f32 or bf16; everything else is f32, and so are the outputs.

#include "wattn_rpe_common.cuh"

namespace {

using wattn::KC;
using wattn::TQ;
using wattn::clip_quant;
using wattn::radial_bin;
using wattn::to_f;

__host__ __device__ __forceinline__ int row_stride(int l2) { return wattn::odd_stride(3 * l2); }

template <int D>
size_t smem_bytes(int l2) {
  const int rs = row_stride(l2);
  return sizeof(float) * ((size_t)(TQ + KC) * rs + 2 * KC * D + (size_t)l2 * 3 * D + 2 * KC) +
         sizeof(int) * 3 * KC;
}

template <typename T, int D>
__global__ void __launch_bounds__(TQ)
wattn_rpe_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ rank, const int32_t* __restrict__ quant,
                     const float* __restrict__ r, const int32_t* __restrict__ kmin,
                     const int32_t* __restrict__ kmax, const float* __restrict__ qT,
                     const float* __restrict__ kT, const float* __restrict__ tv,
                     float* __restrict__ out, float* __restrict__ lse, int H, int G, int L2,
                     float a) {
  extern __shared__ float smem[];
  const int RS = row_stride(L2);  // odd row stride of the projection rows
  const int W = 3 * L2;           // projection row width
  float* qT_s = smem;             // [TQ][RS]
  float* kT_s = qT_s + TQ * RS;   // [KC][RS]
  float* k_s = kT_s + KC * RS;    // [KC][D]
  float* v_s = k_s + KC * D;      // [KC][D]
  float* tv_s = v_s + KC * D;     // [L2][3][D], this head
  float* rank_s = tv_s + L2 * 3 * D;
  float* r_s = rank_s + KC;
  int* cq_s = reinterpret_cast<int*>(r_s + KC);  // [KC][3]

  const int tile = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int i = tile * TQ + tid;
  const bool radial = r != nullptr;

  for (int e = tid; e < TQ * W; e += TQ) {
    const int row = e / W, col = e % W;
    qT_s[row * RS + col] = qT[((size_t)(tile * TQ + row) * H + h) * W + col];
  }
  for (int e = tid; e < L2 * 3 * D; e += TQ) {
    const int la = e / D, dd = e % D;  // la = l * 3 + axis
    tv_s[e] = tv[((size_t)la * H + h) * D + dd];
  }

  float qv[D], acc[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    qv[dd] = to_f(q[((size_t)i * H + h) * D + dd]);
    acc[dd] = 0.f;
  }
  const float my_rank = rank[i];
  int cqi[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) cqi[ax] = clip_quant(quant[i * 3 + ax], G);
  const float ri = radial ? r[i] : 0.f;

  float m = -INFINITY, l = 0.f;
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
      const size_t g = ((size_t)(c0 + row) * H + h) * D + dd;
      k_s[e] = to_f(k[g]);
      v_s[e] = to_f(v[g]);
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
      int idx[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) idx[ax] = cqi[ax] - cq_s[j * 3 + ax] + G - 1;
      if (radial) idx[2] = radial_bin(ri - r_s[j], a, 2 * G);
      float s = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) s = fmaf(qv[dd], k_s[j * D + dd], s);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        s += qT_s[tid * RS + ax * L2 + idx[ax]] + kT_s[j * RS + ax * L2 + idx[ax]];
      if (s > m) {  // online softmax: rescale what was summed under the old max
        const float sc = expf(m - s);
        l *= sc;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) acc[dd] *= sc;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
      const float* t0 = tv_s + (idx[0] * 3 + 0) * D;
      const float* t1 = tv_s + (idx[1] * 3 + 1) * D;
      const float* t2 = tv_s + (idx[2] * 3 + 2) * D;
#pragma unroll
      for (int dd = 0; dd < D; ++dd)
        acc[dd] = fmaf(p, v_s[j * D + dd] + t0[dd] + t1[dd] + t2[dd], acc[dd]);
    }
  }

  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int dd = 0; dd < D; ++dd) out[((size_t)i * H + h) * D + dd] = acc[dd] * inv;
  // every row attends at least itself, so l > 0
  lse[(size_t)i * H + h] = m + logf(l);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* rank, const void* quant,
           const void* r, const void* kmin, const void* kmax, const void* qT, const void* kT,
           const void* tv, void* out, void* lse, int N, int H, int G, int L2, float a,
           void* stream) {
  const size_t smem = smem_bytes<D>(L2);
  auto kern = wattn_rpe_fwd_kernel<T, D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / TQ, H);
  kern<<<grid, TQ, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)rank, (const int32_t*)quant,
      (const float*)r, (const int32_t*)kmin, (const int32_t*)kmax, (const float*)qT,
      (const float*)kT, (const float*)tv, (float*)out, (float*)lse, H, G, L2, a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const void* rank,
             const void* quant, const void* r, const void* kmin, const void* kmax,
             const void* qT, const void* kT, const void* tv, void* out, void* lse, int N, int H,
             int G, int L2, float a, void* stream) {
  switch (D) {
    case 4: return launch<T, 4>(q, k, v, rank, quant, r, kmin, kmax, qT, kT, tv, out, lse, N, H, G, L2, a, stream);
    case 8: return launch<T, 8>(q, k, v, rank, quant, r, kmin, kmax, qT, kT, tv, out, lse, N, H, G, L2, a, stream);
    case 16: return launch<T, 16>(q, k, v, rank, quant, r, kmin, kmax, qT, kT, tv, out, lse, N, H, G, L2, a, stream);
    case 32: return launch<T, 32>(q, k, v, rank, quant, r, kmin, kmax, qT, kT, tv, out, lse, N, H, G, L2, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Sorted inputs: q, k, v [N, H, D]; rank [N] f32; quant [N, 3] int32; r [N]
// f32 or NULL (cubic branch); kmin, kmax [N / 128] int32; qT, kT [N, H, 3, L2]
// f32; tv [L2, 3, H, D] f32; out [N, H, D] f32; lse [N, H] f32. D in
// {4, 8, 16, 32}.
// Returns the cudaError_t of the launch.
int wattn_rpe_fwd_f32(const void* q, const void* k, const void* v, const void* rank,
                      const void* quant, const void* r, const void* kmin, const void* kmax,
                      const void* qT, const void* kT, const void* tv, void* out, void* lse, int N,
                      int H, int D, int G, int L2, float a, void* stream) {
  return dispatch<float>(D, q, k, v, rank, quant, r, kmin, kmax, qT, kT, tv, out, lse, N, H, G,
                         L2, a, stream);
}

int wattn_rpe_fwd_bf16(const void* q, const void* k, const void* v, const void* rank,
                       const void* quant, const void* r, const void* kmin, const void* kmax,
                       const void* qT, const void* kT, const void* tv, void* out, void* lse, int N,
                       int H, int D, int G, int L2, float a, void* stream) {
  return dispatch<__nv_bfloat16>(D, q, k, v, rank, quant, r, kmin, kmax, qT, kT, tv, out, lse,
                                 N, H, G, L2, a, stream);
}

}  // extern "C"
