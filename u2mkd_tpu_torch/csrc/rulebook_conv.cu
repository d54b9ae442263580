// Rulebook sparse convolution (ks=3, stride 1): a direct gather-GEMM.
//
//   out[b, v, :] = sum_k x[b, nbr[b, k, v], :] @ w[k]      (k over the 27 offsets)
//
// nbr is the host pipeline's rulebook [B, 27, V] as it comes, with no
// transpose: for one offset a block's rows read consecutive indices.
// Rows of nbr that are -1 or >= V contribute zero (the port's
// ops/spconv.py:gather_rows convention).
//
// Replaces the TPU kernel u2mkd_tpu/ops/pallas/spconv_kernel.py:_call (body
// _kernel). That kernel builds {0,1} selection matrices per Morton source tile
// and gathers on the MXU, because a TPU gather of short rows is latency-bound.
// An H100 gathers rows directly: each block loads the neighbour rows it needs
// straight from device memory into shared memory.
//
// What bounds it on the H100. For each valid (row, offset) pair the kernel
// reads one Cin row and does 2*Cin*Cout flops: 2*Cout flops per gathered
// element (Cout = 32..256 on the main path), 16..128 flops per f32 byte.
// Counting each input and output byte once, the largest launch (V=131072,
// Cin 128 -> Cout 96) moves ~0.13 GB, ~0.04 ms at 3.35 TB/s, while
// sum_valid 2*Cin*Cout is tens of GFLOP, tenths of a ms at the 67 TFLOP/s
// f32 rate of the CUDA cores: the arithmetic bounds it (chip_smoke.py
// computes both from each run's rulebook). This first version stays on the
// CUDA cores (no tensor cores, TMA or wgmma; a later change). Its design:
//   * a block owns 64 output rows x 64 output channels and walks the 27
//     offsets and Cin in chunks of 32; per step it stages the gathered rows
//     (zero where absent) and the weight slice in shared memory, and every
//     thread accumulates a 4x4 register tile in f32;
//   * an offset for which none of the block's 64 rows has a neighbour is
//     skipped (__syncthreads_or), so empty offsets cost one index read. The
//     host pipeline's Morton row order keeps a block's neighbours close, so
//     the gathered rows mostly hit L2.
// Every row is written, including a tail when V is not a multiple of 64, and
// no Cin or Cout is refused. Inputs are f32 or bf16; accumulation is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TV = 64;       // output rows per block
constexpr int TN = 64;       // output channels per block
constexpr int TK = 32;       // input channels per step
constexpr int THREADS = 256; // 16 x 16 threads, 4x4 outputs each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
rulebook_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const int32_t* __restrict__ nbr, T* __restrict__ out,
                     int V, int Cin, int Cout, int K) {
  __shared__ float xs[TK][TV + 1];  // gathered rows, channel-major
  __shared__ __align__(16) float ws[TK][TN];
  __shared__ int rows[TV];

  const int b = blockIdx.z;
  const int v0 = blockIdx.x * TV;
  const int n0 = blockIdx.y * TN;
  const T* xb = x + (size_t)b * V * Cin;
  const int32_t* nb = nbr + (size_t)b * K * V;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels n0 + 4*tx .. +3
  const int ty = tid / 16;  // output rows v0 + 4*ty .. +3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    int any = 0;
    if (tid < TV) {
      const int v = v0 + tid;
      int r = -1;
      if (v < V) {
        r = nb[(size_t)k * V + v];
        if (r >= V) r = -1;
        if (r < 0) r = -1;
      }
      rows[tid] = r;
      any = r >= 0;
    }
    if (!__syncthreads_or(any)) continue;  // no row of this block has offset k

    for (int c0 = 0; c0 < Cin; c0 += TK) {
      for (int e = tid; e < TV * TK; e += THREADS) {
        const int rr = e / TK, cc = e % TK;
        const int r = rows[rr], c = c0 + cc;
        xs[cc][rr] = (r >= 0 && c < Cin) ? to_f(xb[(size_t)r * Cin + c]) : 0.f;
      }
      for (int e = tid; e < TK * TN; e += THREADS) {
        const int cc = e / TN, nn = e % TN;
        const int c = c0 + cc, n = n0 + nn;
        ws[cc][nn] = (c < Cin && n < Cout) ? to_f(w[((size_t)k * Cin + c) * Cout + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < TK; ++cc) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[cc][ty * 4 + i];
        const float4 bv = *reinterpret_cast<const float4*>(&ws[cc][tx * 4]);
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = v0 + ty * 4 + i;
    if (v >= V) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < Cout) store(&out[((size_t)b * V + v) * Cout + n], acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* nbr, void* out, int B, int V,
           int Cin, int Cout, int K, void* stream) {
  dim3 grid((V + TV - 1) / TV, (Cout + TN - 1) / TN, B);
  rulebook_conv_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const int32_t*)nbr, (T*)out, V, Cin, Cout, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, V, Cin], w [K, Cin, Cout], nbr [B, K, V] int32, out [B, V, Cout];
// all contiguous on the device. Returns the cudaError_t of the launch.
int rulebook_conv_f32(const void* x, const void* w, const void* nbr, void* out, int B,
                      int V, int Cin, int Cout, int K, void* stream) {
  return launch<float>(x, w, nbr, out, B, V, Cin, Cout, K, stream);
}

int rulebook_conv_bf16(const void* x, const void* w, const void* nbr, void* out, int B,
                       int V, int Cin, int Cout, int K, void* stream) {
  return launch<__nv_bfloat16>(x, w, nbr, out, B, V, Cin, Cout, K, stream);
}

}  // extern "C"
