// Window attention with contextual relative position encoding, backward over
// key tiles (kernel K5).
//
// With the notation of K4 (wattn_rpe_bwd_q.cu): p_ij = exp(s_ij - lse_i),
// dp_ij = do_i . v_j + sum_a edo[i, a, idx_a], ds_ij = p_ij (dp_ij - dfac_i).
// This kernel writes the key-side sums
//
//   dk[j]          = sum_i ds_ij q_i
//   dv[j]          = sum_i p_ij do_i
//   mk[j, a, l]    = sum_i ds_ij [idx_a = l]     (the gradient of kT)
//
// Window runs are contiguous in the sorted order, so the partner queries of a
// key tile lie in the same [kmin, kmax) range as the tile's partner keys in
// the forward: the kernel reuses the host geometry's ranges.
//
// Replaces the TPU kernel u2mkd_tpu/ops/pallas/wattn_kernel.py:_call_bwd_k
// (body _bwd_k_kernel) with the dk/dTk part of the epilogue
// _flash_rpe_bwd; the epilogue's einsums (dk and dTk from mk) stay in torch,
// as they stayed in XLA.
//
// What bounds it on the H100. Per pair and head: ~8*D flops (two dot
// products, the dk and dv updates), nine table lookups, an exp, three mass
// updates and, on the sphere branch, a log: the pairs' arithmetic. Design,
// the mirror of K4:
//   * one block per (128-key tile, head); thread t owns key t of the tile,
//     with k, v and the dk and dv sums in registers;
//   * a key's partner queries have one coordinate c in [0, G) per difference
//     axis, so its lookups kT[j, a, idx_a] and its masses are indexed by c:
//     two rows of 3G (4G on the sphere branch) floats per key in shared
//     memory, at an odd stride;
//   * the block walks the queries of [kmin, kmax) in chunks of 32 staged in
//     shared memory (q, do, the query projections qT and edo, lse, dfac,
//     rank, coordinates, range), skipping queries of other windows; every
//     thread of a warp reads the same query, so those reads broadcast;
//   * the masses go back to the [3, L2] bin layout at the end, coalesced.
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
  return sizeof(float) * ((size_t)2 * TQ * ms + (size_t)2 * KC * rs + 2 * KC * D + 4 * KC) +
         sizeof(int) * (3 * KC + 3 * TQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(TQ)
wattn_rpe_bwd_k_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ rank, const int32_t* __restrict__ quant,
                       const float* __restrict__ r, const int32_t* __restrict__ kmin,
                       const int32_t* __restrict__ kmax, const float* __restrict__ qT,
                       const float* __restrict__ kT, const float* __restrict__ edo,
                       const float* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ dfac, float* __restrict__ dk,
                       float* __restrict__ dv, float* __restrict__ mk, int H, int G, int L2,
                       float a) {
  extern __shared__ float smem[];
  const bool radial = r != nullptr;
  const int MW = mass_width(radial, G), MS = odd_stride(MW);
  const int W = 3 * L2, RS = odd_stride(W);
  float* ksel = smem;                // [TQ][MS] kT of each key by partner slot
  float* mk_s = ksel + TQ * MS;      // [TQ][MS] ds masses
  float* qT_s = mk_s + TQ * MS;      // [KC][RS]
  float* e_s = qT_s + KC * RS;       // [KC][RS] edo
  float* q_s = e_s + KC * RS;        // [KC][D]
  float* do_s = q_s + KC * D;        // [KC][D]
  float* rank_s = do_s + KC * D;     // [KC]
  float* r_s = rank_s + KC;          // [KC]
  float* lse_s = r_s + KC;           // [KC]
  float* dfac_s = lse_s + KC;        // [KC]
  int* cq_s = reinterpret_cast<int*>(dfac_s + KC);  // [KC][3]
  int* cqt_s = cq_s + 3 * KC;                        // [TQ][3] the tile's own

  const int tile = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int j = tile * TQ + tid;
  const size_t row0 = (size_t)tile * TQ;

#pragma unroll
  for (int ax = 0; ax < 3; ++ax) cqt_s[tid * 3 + ax] = clip_quant(quant[j * 3 + ax], G);
  __syncthreads();
  // slot m of a row: axis min(m / G, 2), partner coordinate (or radial bin)
  // c = m - axis * G, table column c - cq + G - 1 (or c on the radial axis)
  for (int e = tid; e < TQ * MW; e += TQ) {
    const int row = e / MW, m = e % MW;
    const int ax = min(m / G, 2), c = m - ax * G;
    const int col = (ax == 2 && radial) ? c : c - cqt_s[row * 3 + ax] + G - 1;
    ksel[row * MS + m] = kT[((row0 + row) * H + h) * W + ax * L2 + col];
    mk_s[row * MS + m] = 0.f;
  }

  float kv[D], vv[D], dkv[D], dvv[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    kv[dd] = to_f(k[((size_t)j * H + h) * D + dd]);
    vv[dd] = to_f(v[((size_t)j * H + h) * D + dd]);
    dkv[dd] = 0.f;
    dvv[dd] = 0.f;
  }
  const float my_rank = rank[j];
  const float rj = radial ? r[j] : 0.f;
  int cqj[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) cqj[ax] = cqt_s[tid * 3 + ax];
  float* my_k = ksel + tid * MS;
  float* my_mk = mk_s + tid * MS;

  const int i0 = kmin[tile], i1 = kmax[tile];
  for (int c0 = i0; c0 < i1; c0 += KC) {
    const int nq = min(KC, i1 - c0);
    __syncthreads();  // the previous chunk is consumed; the tile staging is complete
    for (int e = tid; e < nq * W; e += TQ) {
      const int row = e / W, col = e % W;
      const size_t gi = ((size_t)(c0 + row) * H + h) * W + col;
      qT_s[row * RS + col] = qT[gi];
      e_s[row * RS + col] = edo[gi];
    }
    for (int e = tid; e < nq * D; e += TQ) {
      const int row = e / D, dd = e % D;
      const size_t gi = ((size_t)(c0 + row) * H + h) * D + dd;
      q_s[e] = to_f(q[gi]);
      do_s[e] = dout[gi];
    }
    if (tid < nq) {
      const int i = c0 + tid;
      rank_s[tid] = rank[i];
      r_s[tid] = radial ? r[i] : 0.f;
      lse_s[tid] = lse[(size_t)i * H + h];
      dfac_s[tid] = dfac[(size_t)i * H + h];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) cq_s[tid * 3 + ax] = clip_quant(quant[i * 3 + ax], G);
    }
    __syncthreads();

    for (int i = 0; i < nq; ++i) {
      if (rank_s[i] != my_rank) continue;
      int slot[3], col[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const int c = cq_s[i * 3 + ax];
        slot[ax] = ax * G + c;
        col[ax] = ax * L2 + c - cqj[ax] + G - 1;
      }
      if (radial) {
        const int l = radial_bin(r_s[i] - rj, a, 2 * G);
        slot[2] = 2 * G + l;
        col[2] = 2 * L2 + l;
      }
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        s = fmaf(q_s[i * D + dd], kv[dd], s);
        dp = fmaf(do_s[i * D + dd], vv[dd], dp);
      }
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        s += qT_s[i * RS + col[ax]] + my_k[slot[ax]];
        dp += e_s[i * RS + col[ax]];
      }
      const float p = expf(s - lse_s[i]);
      const float ds = p * (dp - dfac_s[i]);
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        dkv[dd] = fmaf(ds, q_s[i * D + dd], dkv[dd]);
        dvv[dd] = fmaf(p, do_s[i * D + dd], dvv[dd]);
      }
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) my_mk[slot[ax]] += ds;
    }
  }

#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    dk[((size_t)j * H + h) * D + dd] = dkv[dd];
    dv[((size_t)j * H + h) * D + dd] = dvv[dd];
  }
  __syncthreads();
  // back to the [3, L2] bin layout: bin l of a difference axis holds the mass
  // of partner coordinate c = l + cq - (G - 1)
  for (int e = tid; e < TQ * W; e += TQ) {
    const int row = e / W, col = e % W;
    const int ax = col / L2, l = col % L2;
    int m;
    if (ax == 2 && radial) {
      m = 2 * G + l;
    } else {
      const int c = l + cqt_s[row * 3 + ax] - (G - 1);
      m = (c >= 0 && c < G) ? ax * G + c : -1;
    }
    mk[((row0 + row) * H + h) * W + col] = m >= 0 ? mk_s[row * MS + m] : 0.f;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* rank, const void* quant,
           const void* r, const void* kmin, const void* kmax, const void* qT, const void* kT,
           const void* edo, const void* dout, const void* lse, const void* dfac, void* dk,
           void* dv, void* mk, int N, int H, int G, int L2, float a, void* stream) {
  const size_t smem = smem_bytes<D>(G, L2, r != nullptr);
  auto kern = wattn_rpe_bwd_k_kernel<T, D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(N / TQ, H);
  kern<<<grid, TQ, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)rank, (const int32_t*)quant,
      (const float*)r, (const int32_t*)kmin, (const int32_t*)kmax, (const float*)qT,
      (const float*)kT, (const float*)edo, (const float*)dout, (const float*)lse,
      (const float*)dfac, (float*)dk, (float*)dv, (float*)mk, H, G, L2, a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const void* rank,
             const void* quant, const void* r, const void* kmin, const void* kmax,
             const void* qT, const void* kT, const void* edo, const void* dout, const void* lse,
             const void* dfac, void* dk, void* dv, void* mk, int N, int H, int G, int L2,
             float a, void* stream) {
#define WATTN_BWD_K_CASE(DD)                                                                  \
  case DD:                                                                                    \
    return launch<T, DD>(q, k, v, rank, quant, r, kmin, kmax, qT, kT, edo, dout, lse, dfac,  \
                         dk, dv, mk, N, H, G, L2, a, stream);
  switch (D) {
    WATTN_BWD_K_CASE(4)
    WATTN_BWD_K_CASE(8)
    WATTN_BWD_K_CASE(16)
    WATTN_BWD_K_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WATTN_BWD_K_CASE
}

}  // namespace

extern "C" {

// Sorted inputs as for wattn_rpe_bwd_q_*. Outputs: dk, dv [N, H, D] f32; mk
// [N, H, 3, L2] f32. D in {4, 8, 16, 32}. Returns the cudaError_t of the
// launch.
int wattn_rpe_bwd_k_f32(const void* q, const void* k, const void* v, const void* rank,
                        const void* quant, const void* r, const void* kmin, const void* kmax,
                        const void* qT, const void* kT, const void* edo, const void* dout,
                        const void* lse, const void* dfac, void* dk, void* dv, void* mk, int N,
                        int H, int D, int G, int L2, float a, void* stream) {
  return dispatch<float>(D, q, k, v, rank, quant, r, kmin, kmax, qT, kT, edo, dout, lse, dfac,
                         dk, dv, mk, N, H, G, L2, a, stream);
}

int wattn_rpe_bwd_k_bf16(const void* q, const void* k, const void* v, const void* rank,
                         const void* quant, const void* r, const void* kmin, const void* kmax,
                         const void* qT, const void* kT, const void* edo, const void* dout,
                         const void* lse, const void* dfac, void* dk, void* dv, void* mk, int N,
                         int H, int D, int G, int L2, float a, void* stream) {
  return dispatch<__nv_bfloat16>(D, q, k, v, rank, quant, r, kmin, kmax, qT, kT, edo, dout, lse,
                                 dfac, dk, dv, mk, N, H, G, L2, a, stream);
}

}  // extern "C"
