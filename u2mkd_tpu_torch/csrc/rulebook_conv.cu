// Rulebook sparse convolution (ks=3, stride 1), kernel K1: a gather-GEMM on
// the tensor cores over a plan of the rulebook.
//
//   out[b, v, :] = sum_k x[b, nbr[b, k, v], :] @ w[k]      (k over the offsets)
//
// Rows of nbr that are -1 or >= V contribute zero. The same kernel computes
// the input gradient with the weights W[rev(k)]^T (spconv_kernel.py).
//
// Replaces the TPU kernel u2mkd_tpu/ops/pallas/spconv_kernel.py:_call (body
// _kernel), which builds {0,1} selection matrices per Morton source tile and
// gathers on the MXU because a TPU gather of short rows is latency-bound. An
// H100 gathers rows directly.
//
// What bounds it on the H100. Each valid (row, offset) pair costs 2*Cin*Cout
// flops against one gathered Cin row; the largest launch of the main path
// (V=131072, Cin 128 -> Cout 96, ~450k pairs) is ~11 GFLOP and moves ~0.13
// GB. In f32 through 3xTF32 that is three TF32 products per f32 product:
// 495/3 = 165 TFLOP/s of tensor-core rate, ~0.07 ms, above the bytes'
// ~0.04 ms, so the arithmetic bounds it (chip_smoke.py computes both from
// each run's rulebook). Three things kept the CUDA-core version ~19x above
// its bound, and the design answers each:
//   * Work on absent pairs. Rows come in Morton order and 64 of them hold
//     nearly every offset between them, so a tile paid for ~4.6 slots per
//     valid pair. The plan (ConvPlan in spconv_kernel.py, built once per
//     level on the device) sorts the rows stably by their 27-bit neighbour
//     mask (its bits ordered by the offsets' counts); rows that share
//     offsets share tiles, and each tile's union of offsets is precomputed.
//     A block walks only the offsets of its union (~2.2 slots per pair at
//     level 0 of the main path) and writes its rows back through the
//     permutation: out[perm[i]], no atomics, deterministic.
//   * CUDA-core arithmetic. Products run on the tensor cores with mma.sync:
//     bf16 natively, f32 in 3xTF32 (rulebook_mma.cuh), never one pass of
//     TF32, which keeps three decimal digits.
//   * Synchronous gathers, and each row gathered once per 64 output
//     channels. A block owns TV = 64 rows and a Cout tile as wide as the
//     layer, up to 256 (a warp per 32 rows x 32 channels), so each gathered
//     row is read once per launch for Cout <= 256 (512 takes two tiles).
//     The rows of (offset, 32-channel chunk) i+1 and i+2 and the matching
//     weight slices are in flight through cp.async in a three-stage
//     shared-memory ring while step i multiplies. The row indices of the
//     tile's offsets are staged in shared memory once.
// Measured on the H100 (PERF.md), the multiply and not the gathers bounds
// this design: the 3xTF32 splits and the per-step adds are CUDA-core work
// beside each mma.sync, ~2.2 slots are multiplied per pair, and a block of
// a narrow layer holds few warps.
// Every row is written, including tails (V % 64) and rows of no valid
// neighbour (zeros); every Cin and Cout is taken: widths that are not a
// multiple of 16 bytes are staged by plain loads instead of cp.async.
// Accumulation is f32; the output is x's dtype.

#include "rulebook_mma.cuh"

namespace {

using namespace rbmma;

constexpr int TV = 64;        // rows per tile (the plan's tile)
constexpr int TKC = 32;       // input channels per step
constexpr int STAGES = 3;     // depth of the cp.async ring
constexpr int MAX_BN = 256;   // widest Cout tile
constexpr int THREADS = (TV / 32) * (MAX_BN / 32) * 32;  // a warp per 32 x 32
constexpr int MAX_K = 32;     // offsets a tile mask can hold

// a staged row: TKC elements and 16 bytes of padding (conflict-free
// fragment reads: 36 words for f32, 20 for bf16)
template <typename T>
__host__ __device__ constexpr int row_stride() { return TKC + vec<T>(); }

template <typename T>
size_t smem_bytes(int bn, int k) {
  return (size_t)STAGES * (TV + bn) * row_stride<T>() * sizeof(T) + (size_t)k * TV * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rulebook_conv_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                     const int32_t* __restrict__ nbr_s, const int32_t* __restrict__ perm,
                     const int32_t* __restrict__ tile_mask, T* __restrict__ out,
                     int V, int Cin, int Cout, int K, int bn, int vec_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RS = row_stride<T>();
  constexpr int VEC = vec<T>();
  constexpr int CPR = TKC / VEC;  // 16-byte copies per staged row
  T* As = reinterpret_cast<T*>(smem);           // [STAGES][TV][RS] gathered rows
  T* Bs = As + STAGES * TV * RS;                // [STAGES][bn][RS] W^T slice
  int* idx = reinterpret_cast<int*>(Bs + STAGES * bn * RS);  // [nk][TV] source rows
  __shared__ int ks[MAX_K];
  __shared__ int nk_s;

  const int b = blockIdx.z, tile = blockIdx.x, n0 = blockIdx.y * bn;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int v0 = tile * TV;
  const T* xb = x + (size_t)b * V * Cin;

  if (tid == 0) {
    const uint32_t u = (uint32_t)tile_mask[(size_t)b * gridDim.x + tile];
    int n = 0;
    for (int k = 0; k < K; ++k)
      if ((u >> k) & 1u) ks[n++] = k;
    nk_s = n;
  }
  __syncthreads();
  const int nk = nk_s;
  const int32_t* nb = nbr_s + (size_t)b * K * V;
  for (int e = tid; e < nk * TV; e += nthreads) {
    const int v = v0 + e % TV;
    idx[e] = v < V ? nb[(size_t)ks[e / TV] * V + v] : -1;
  }
  __syncthreads();

  const int nchunk = (Cin + TKC - 1) / TKC;
  const int nsteps = nk * nchunk;

  // stage step st: the tile's rows at offset ks[st / nchunk] and the
  // matching W^T[k] slice, channels c0 .. c0 + TKC
  auto issue = [&](int st) {
    const int s = st / nchunk, c0 = (st % nchunk) * TKC, k = ks[s];
    T* a = As + (st % STAGES) * TV * RS;
    T* w = Bs + (st % STAGES) * bn * RS;
    const int* rows = idx + s * TV;
    const T* wk = wt + (size_t)k * Cout * Cin;
    if (vec_ok) {
      for (int e = tid; e < TV * CPR; e += nthreads) {
        const int r = e / CPR, cc = (e % CPR) * VEC, src = rows[r];
        const bool ok = src >= 0 && c0 + cc < Cin;
        cp_async16(a + r * RS + cc, ok ? xb + (size_t)src * Cin + c0 + cc : xb, ok);
      }
      for (int e = tid; e < bn * CPR; e += nthreads) {
        const int n = e / CPR, cc = (e % CPR) * VEC;
        const bool ok = n0 + n < Cout && c0 + cc < Cin;
        cp_async16(w + n * RS + cc, ok ? wk + (size_t)(n0 + n) * Cin + c0 + cc : wk, ok);
      }
    } else {
      for (int e = tid; e < TV * TKC; e += nthreads) {
        const int r = e / TKC, cc = e % TKC, src = rows[r];
        a[r * RS + cc] = (src >= 0 && c0 + cc < Cin) ? xb[(size_t)src * Cin + c0 + cc] : zero<T>();
      }
      for (int e = tid; e < bn * TKC; e += nthreads) {
        const int n = e / TKC, cc = e % TKC;
        w[n * RS + cc] = (n0 + n < Cout && c0 + cc < Cin)
                             ? wk[(size_t)(n0 + n) * Cin + c0 + cc] : zero<T>();
      }
    }
  };

  // the warp's 32 rows x 32 channels: 2 x 4 fragments of 16 x 8
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  const int wm = (warp % (TV / 32)) * 32, wn = (warp / (TV / 32)) * 32;

  auto compute = [&](int stage) {
    const T* a = As + stage * TV * RS + wm * RS;
    const T* w = Bs + stage * bn * RS + wn * RS;
    if constexpr (sizeof(T) == 4) {
      float d[2][4][4] = {};
#pragma unroll
      for (int kk = 0; kk < TKC; kk += 8) {
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* p = reinterpret_cast<const float*>(a) + (i * 16 + g) * RS + kk + t;
          split_tf32(p[0], ah[i][0], al[i][0]);
          split_tf32(p[8 * RS], ah[i][1], al[i][1]);
          split_tf32(p[4], ah[i][2], al[i][2]);
          split_tf32(p[8 * RS + 4], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* p = reinterpret_cast<const float*>(w) + (j * 8 + g) * RS + kk + t;
          split_tf32(p[0], bh[j][0], bl[j][0]);
          split_tf32(p[4], bh[j][1], bl[j][1]);
        }
        mma_3xtf32(d, ah, al, bh, bl);
      }
      flush(acc, d);
    } else {
#pragma unroll
      for (int kk = 0; kk < TKC; kk += 16) {
        uint32_t bf[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const T* p = w + (j * 8 + g) * RS + kk + 2 * t;
          bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
          bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const T* p = a + (i * 16 + g) * RS + kk + 2 * t;
          uint32_t af[4];
          af[0] = *reinterpret_cast<const uint32_t*>(p);
          af[1] = *reinterpret_cast<const uint32_t*>(p + 8 * RS);
          af[2] = *reinterpret_cast<const uint32_t*>(p + 8);
          af[3] = *reinterpret_cast<const uint32_t*>(p + 8 * RS + 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af, bf[j]);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }
  for (int st = 0; st < nsteps; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step st has landed; every warp is done with st - 1
    if (st + STAGES - 1 < nsteps) issue(st + STAGES - 1);
    cp_async_commit();
    compute(st % STAGES);
  }

  const int32_t* pb = perm + (size_t)b * V;
  T* ob = out + (size_t)b * V * Cout;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + wm + i * 16 + g + h * 8;
      if (v >= V) continue;
      T* orow = ob + (size_t)pb[v] * Cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t;
        if (n < Cout) store(orow + n, acc[i][j][2 * h]);
        if (n + 1 < Cout) store(orow + n + 1, acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* wt, const void* nbr_s, const void* perm,
           const void* tile_mask, void* out, int B, int V, int Cin, int Cout, int K, int tile,
           int vec_ok, void* stream) {
  if (tile != TV || K < 1 || K > MAX_K || B < 1 || V < 1 || Cin < 1 || Cout < 1)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(rulebook_conv_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_bytes<T>(MAX_BN, MAX_K));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int bn = Cout >= MAX_BN ? MAX_BN : (Cout + 31) / 32 * 32;
  dim3 grid((V + TV - 1) / TV, (Cout + bn - 1) / bn, B);
  rulebook_conv_kernel<T><<<grid, (TV / 32) * bn, smem_bytes<T>(bn, K), (cudaStream_t)stream>>>(
      (const T*)x, (const T*)wt, (const int32_t*)nbr_s, (const int32_t*)perm,
      (const int32_t*)tile_mask, (T*)out, V, Cin, Cout, K, bn, vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, V, Cin], wt [K, Cout, Cin] (the weights transposed), and the plan:
// nbr_s [B, K, V] int32 (the rulebook in the plan's row order, -1 where
// absent), perm [B, V] int32, tile_mask [B, ceil(V / tile)] int32; out
// [B, V, Cout]. All contiguous on the device; vec_ok says that every row
// starts on 16 bytes (Cin * elem % 16 == 0 and aligned bases). Returns the
// cudaError_t of the launch.
int rulebook_conv_f32(const void* x, const void* wt, const void* nbr_s, const void* perm,
                      const void* tile_mask, void* out, int B, int V, int Cin, int Cout, int K,
                      int tile, int vec_ok, void* stream) {
  return launch<float>(x, wt, nbr_s, perm, tile_mask, out, B, V, Cin, Cout, K, tile, vec_ok,
                       stream);
}

int rulebook_conv_bf16(const void* x, const void* wt, const void* nbr_s, const void* perm,
                       const void* tile_mask, void* out, int B, int V, int Cin, int Cout, int K,
                       int tile, int vec_ok, void* stream) {
  return launch<__nv_bfloat16>(x, wt, nbr_s, perm, tile_mask, out, B, V, Cin, Cout, K, tile,
                               vec_ok, stream);
}

}  // extern "C"
