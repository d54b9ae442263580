// Window attention without relative position encoding, forward (K2).
//
// Over a window-sorted sequence of N rows (N a multiple of 128), each window
// a contiguous run of equal rank, per head:
//
//   out_i = sum_j softmax_j(q_i . k_j) v_j   over the keys j with rank_j == rank_i
//
// (q pre-scaled by the caller). Query tile t (rows 128 t .. 128 t + 127)
// reads only the keys [kmin[t], kmax[t]): the first row of its first window
// to one past the last row of its last window.
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
// windows of the SphereFormer levels (tens to thousands of rows) the pairs'
// f32 arithmetic bounds it. The design:
//   * one block per (128-query tile, head); thread t owns query t of the tile
//     and keeps q, the running max, the running sum and the D-wide output in
//     registers: a single pass with online rescaling, f32 throughout for f32
//     and bf16 inputs;
//   * the block walks the tile's whole key range [kmin, kmax) in chunks of KC
//     rows staged in shared memory (k and v as f32, and rank); any range
//     length works, so the radial windows' very uneven ranges need no bound;
//     every thread of a warp reads the same key, so shared-memory reads
//     broadcast;
//   * a key counts only where its rank equals the query's; every query
//     attends at least itself, and the sum is floored at 1e-20 as the TPU
//     kernel's is.
// The output is f32 [N, H, D].

#include "wattn_rpe_common.cuh"

namespace {

using wattn::TQ;
using wattn::to_f;

constexpr int KC = 64;  // key rows staged per chunk

template <typename T, int D>
__global__ void __launch_bounds__(TQ)
wattn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int32_t* __restrict__ rank, const int32_t* __restrict__ kmin,
                 const int32_t* __restrict__ kmax, float* __restrict__ out, int H) {
  __shared__ float k_s[KC * D];
  __shared__ float v_s[KC * D];
  __shared__ int rank_s[KC];

  const int tile = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int i = tile * TQ + tid;

  float qv[D], acc[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    qv[dd] = to_f(q[((size_t)i * H + h) * D + dd]);
    acc[dd] = 0.f;
  }
  const int my_rank = rank[i];

  float m = -INFINITY, l = 0.f;
  const int k0 = kmin[tile], k1 = kmax[tile];
  for (int c0 = k0; c0 < k1; c0 += KC) {
    const int nk = min(KC, k1 - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < nk * D; e += TQ) {
      const int row = e / D, dd = e % D;
      const size_t g = ((size_t)(c0 + row) * H + h) * D + dd;
      k_s[e] = to_f(k[g]);
      v_s[e] = to_f(v[g]);
    }
    if (tid < nk) rank_s[tid] = rank[c0 + tid];
    __syncthreads();

    for (int j = 0; j < nk; ++j) {
      if (rank_s[j] != my_rank) continue;
      float s = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) s = fmaf(qv[dd], k_s[j * D + dd], s);
      if (s > m) {  // online softmax: rescale what was summed under the old max
        const float sc = expf(m - s);
        l *= sc;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) acc[dd] *= sc;
        m = s;
      }
      const float p = expf(s - m);
      l += p;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) acc[dd] = fmaf(p, v_s[j * D + dd], acc[dd]);
    }
  }

  const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
  for (int dd = 0; dd < D; ++dd) out[((size_t)i * H + h) * D + dd] = acc[dd] * inv;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* rank, const void* kmin,
           const void* kmax, void* out, int N, int H, void* stream) {
  dim3 grid(N / TQ, H);
  wattn_fwd_kernel<T, D><<<grid, TQ, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)rank, (const int32_t*)kmin,
      (const int32_t*)kmax, (float*)out, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, const void* rank,
             const void* kmin, const void* kmax, void* out, int N, int H, void* stream) {
  switch (D) {
    case 4: return launch<T, 4>(q, k, v, rank, kmin, kmax, out, N, H, stream);
    case 8: return launch<T, 8>(q, k, v, rank, kmin, kmax, out, N, H, stream);
    case 16: return launch<T, 16>(q, k, v, rank, kmin, kmax, out, N, H, stream);
    case 32: return launch<T, 32>(q, k, v, rank, kmin, kmax, out, N, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Sorted inputs: q, k, v [N, H, D]; rank [N] int32; kmin, kmax [N / 128]
// int32; out [N, H, D] f32. D in {4, 8, 16, 32}.
// Returns the cudaError_t of the launch.
int wattn_fwd_f32(const void* q, const void* k, const void* v, const void* rank,
                  const void* kmin, const void* kmax, void* out, int N, int H, int D,
                  void* stream) {
  return dispatch<float>(D, q, k, v, rank, kmin, kmax, out, N, H, stream);
}

int wattn_fwd_bf16(const void* q, const void* k, const void* v, const void* rank,
                   const void* kmin, const void* kmax, void* out, int N, int H, int D,
                   void* stream) {
  return dispatch<__nv_bfloat16>(D, q, k, v, rank, kmin, kmax, out, N, H, stream);
}

}  // extern "C"
