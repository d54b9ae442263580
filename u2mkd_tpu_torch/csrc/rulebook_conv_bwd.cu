// Rulebook sparse convolution (ks=3, stride 1), weight gradient (kernel K1b).
//
//   gw[k, c, n] = sum_{b, v} x[b, nbr[b, k, v], c] * g[b, v, n]
//
// x [B, V, Cin] is the forward's input, g [B, V, Cout] the gradient of its
// output, nbr the host rulebook [B, 27, V]. Entries of nbr that are -1 or >= V
// contribute nothing. The gradient of the input needs no kernel of its own:
// the host rulebook is symmetric (P_k^T = P_rev(k)), so dX is the forward
// kernel K1 (rulebook_conv.cu) with the weights W[rev(k)]^T.
//
// Replaces the weight half of the TPU kernel's VJP,
// u2mkd_tpu/ops/pallas/spconv_kernel.py:_rc_bwd, which has the forward kernel
// _call emit the gathered concat [V, 27*Cin] and multiplies it by g in XLA.
// That concat would be 1.36 GB in f32 at V=131072, Cin 96, per conv; here the
// rows are gathered on the fly and never stored.
//
// What bounds it on the H100. Every valid (row, offset) pair costs
// 2*Cin*Cout flops against one gathered Cin row and one Cout row of g, which
// also serve the other 63 channels of the block's tile: 16..128 flops per
// byte read, so the f32 arithmetic on the CUDA cores bounds it, as it bounds
// K1. Design:
//   * a block owns one offset k, a 64 (Cin) x 64 (Cout) tile of gw[k] and one
//     range of rows; it walks its rows in chunks of 32, stages the gathered x
//     rows (zero where absent) and the g rows in shared memory, and every
//     thread accumulates a 4x4 register tile in f32;
//   * a chunk in which no row has offset k is skipped (__syncthreads_or);
//   * the rows are split into S ranges so that the grid fills the card even
//     for narrow convs (one tile, 27 offsets). The S partial tiles are
//     written to a scratch buffer and summed by a second kernel of this file
//     in a fixed order: no atomics, so the result is deterministic, bitwise
//     the same from run to run. With S = 1 the first kernel writes gw
//     itself.
// Every Cin and Cout is taken (tails are masked). Inputs are f32 or bf16;
// accumulation and the output are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 64;       // input channels per block (rows of the gw tile)
constexpr int TN = 64;       // output channels per block
constexpr int TR = 32;       // conv rows per step
constexpr int THREADS = 256; // 16 x 16 threads, 4x4 outputs each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
rulebook_conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const int32_t* __restrict__ nbr, float* __restrict__ part,
                        int B, int V, int Cin, int Cout, int K, int rows_per_split) {
  __shared__ float xs[TR][TC];
  __shared__ __align__(16) float gs[TR][TN];
  __shared__ int src[TR];  // flattened row b*V + nbr of each chunk row, or -1

  const int tiles_n = (Cout + TN - 1) / TN;
  const int c0 = (blockIdx.x / tiles_n) * TC;
  const int n0 = (blockIdx.x % tiles_n) * TN;
  const int k = blockIdx.y;
  const int split = blockIdx.z;
  const long long total = (long long)B * V;
  const long long r_begin = (long long)split * rows_per_split;
  const long long r_end = min(total, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels n0 + 4*tx .. +3
  const int ty = tid / 16;  // input channels c0 + 4*ty .. +3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long r0 = r_begin; r0 < r_end; r0 += TR) {
    int any = 0;
    if (tid < TR) {
      const long long row = r0 + tid;
      int s = -1;
      if (row < r_end) {
        const int b = (int)(row / V), v = (int)(row % V);
        const int r = nbr[((size_t)b * K + k) * V + v];
        if (r >= 0 && r < V) s = b * V + r;
      }
      src[tid] = s;
      any = s >= 0;
    }
    if (!__syncthreads_or(any)) continue;  // no row of this chunk has offset k

    for (int e = tid; e < TR * TC; e += THREADS) {
      const int rr = e / TC, cc = e % TC;
      const int s = src[rr], c = c0 + cc;
      xs[rr][cc] = (s >= 0 && c < Cin) ? to_f(x[(size_t)s * Cin + c]) : 0.f;
    }
    for (int e = tid; e < TR * TN; e += THREADS) {
      const int rr = e / TN, nn = e % TN;
      const int n = n0 + nn;
      gs[rr][nn] = (src[rr] >= 0 && n < Cout) ? to_f(g[(size_t)(r0 + rr) * Cout + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < TR; ++rr) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[rr][ty * 4 + i];
      const float4 bv = *reinterpret_cast<const float4*>(&gs[rr][tx * 4]);
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + ((size_t)split * K + k) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Cout) out[(size_t)c * Cout + n] = acc[i][j];
    }
  }
}

// gw[i] = sum_s part[s, i], s in order: the deterministic second pass.
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ gw,
                                  long long m, int S) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < S; ++p) s += part[(size_t)p * m + i];
    gw[i] = s;
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* nbr, void* part, void* gw, int B, int V,
           int Cin, int Cout, int K, int S, void* stream) {
  if (S < 1 || B < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * V;
  const int rows_per_split = (int)((total + S - 1) / S);
  const int tiles = ((Cin + TC - 1) / TC) * ((Cout + TN - 1) / TN);
  float* dst = S == 1 ? (float*)gw : (float*)part;
  dim3 grid(tiles, K, S);
  rulebook_conv_dw_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)g, (const int32_t*)nbr, dst, B, V, Cin, Cout, K, rows_per_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  const long long m = (long long)K * Cin * Cout;
  const long long want = (m + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  sum_splits_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((const float*)part, (float*)gw,
                                                               m, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, V, Cin], g [B, V, Cout] (one dtype), nbr [B, K, V] int32, part
// [S, K, Cin, Cout] f32 scratch (unused when S == 1), gw [K, Cin, Cout] f32;
// all contiguous on the device. Returns the cudaError_t of the launches.
int rulebook_conv_dw_f32(const void* x, const void* g, const void* nbr, void* part, void* gw,
                         int B, int V, int Cin, int Cout, int K, int S, void* stream) {
  return launch<float>(x, g, nbr, part, gw, B, V, Cin, Cout, K, S, stream);
}

int rulebook_conv_dw_bf16(const void* x, const void* g, const void* nbr, void* part, void* gw,
                          int B, int V, int Cin, int Cout, int K, int S, void* stream) {
  return launch<__nv_bfloat16>(x, g, nbr, part, gw, B, V, Cin, Cout, K, S, stream);
}

}  // extern "C"
