// Rulebook sparse convolution (ks=3, stride 1), weight gradient (kernel K1b):
// a pair-list GEMM on the tensor cores.
//
//   gw[k, c, n] = sum_{b, v} x[b, nbr[b, k, v], c] * g[b, v, n]
//
// x [B, V, Cin] is the forward's input, g [B, V, Cout] the gradient of its
// output. Entries of nbr that are -1 or >= V contribute nothing. The input
// gradient needs no kernel of its own: the host rulebook is symmetric
// (P_k^T = P_rev(k)), so dX is K1 (rulebook_conv.cu) with W[rev(k)]^T.
//
// Replaces the weight half of the TPU kernel's VJP,
// u2mkd_tpu/ops/pallas/spconv_kernel.py:_rc_bwd, which has the forward kernel
// _call emit the gathered concat [V, 27*Cin] and multiplies it by g in XLA
// (1.36 GB in f32 at V=131072, Cin 96, per conv); here the rows are gathered
// on the fly and never stored.
//
// What bounds it on the H100: 2*Cin*Cout flops per valid (row, offset) pair
// against one gathered Cin row of x and one Cout row of g; in f32 through
// 3xTF32 the tensor cores' 165 TFLOP/s of f32 products bound it, as they
// bound K1. The CUDA-core version was ~37x above that bound: it walked every
// row of every offset in chunks of 32 and multiplied a whole chunk when one
// row of it had the offset, on the CUDA cores, with synchronous gathers.
// Design:
//   * the plan (ConvPlan in spconv_kernel.py) holds per offset k the list of
//     its valid pairs, compacted in Morton order (source row b*V + nbr,
//     output row b*V + v), and the offsets' segments seg[k] .. seg[k+1] in
//     the concatenation of the 27 lists, all on the device. No slot outside
//     a list is ever multiplied;
//   * that concatenation is cut into S equal ranges, one per block along
//     grid.x, so every block has the same number of pairs whatever the
//     offsets' counts; a block walks the segments its range meets and, for
//     each, contracts its pairs into an f32 tile of gw[k] (Cin x Cout, up to
//     128 x 128 a block, grid.y tiles wider ones; one warp per 32 x 32) on
//     the tensor cores, the pair index as the MMA's k dimension: bf16
//     mma.sync for bf16, 3xTF32 for f32 (rulebook_mma.cuh);
//   * 32 pairs a step, one per lane: the x and g rows of steps i+1 and i+2
//     are in flight through cp.async in a three-stage shared-memory ring
//     while step i multiplies, and each lane's pair indices for the step
//     after are loaded during the multiply;
//   * block s writes its partial tile for offset k to slot s + k of a
//     scratch buffer (unique: ranges and segments are both ordered), and a
//     second kernel sums each offset's slots in the order of s. No atomics:
//     the result is bitwise the same from run to run.
// Every Cin and Cout is taken (tails masked; widths not a multiple of 16
// bytes are staged by plain loads). Inputs are f32 or bf16; accumulation and
// the output are f32.

#include "rulebook_mma.cuh"

namespace {

using namespace rbmma;

constexpr int TP = 32;        // pairs per step, one per lane
constexpr int STAGES = 3;     // depth of the cp.async ring
constexpr int MAX_TILE = 128; // widest Cin or Cout tile of a block
constexpr int THREADS = (MAX_TILE / 32) * (MAX_TILE / 32) * 32;

// a staged pair row of w channels, padded by 8 elements: for f32 the
// fragment reads (k rows t, t+4 at 8 words apart) hit distinct banks
template <typename T>
__host__ __device__ constexpr int pad() { return 8; }

template <typename T>
size_t smem_bytes(int bm, int bn) {
  return (size_t)STAGES * TP * (bm + pad<T>() + bn + pad<T>()) * sizeof(T);
}

__device__ __forceinline__ long long range_begin(long long total, int s, int S) {
  return total * s / S;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rulebook_conv_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const int32_t* __restrict__ pair_src, const int32_t* __restrict__ pair_dst,
                        const long long* __restrict__ seg, float* __restrict__ part, int rows,
                        int Cin, int Cout, int K, int S, int bm, int bn, int vec_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VEC = vec<T>();
  const int RX = bm + pad<T>(), RG = bn + pad<T>();
  T* Xs = reinterpret_cast<T*>(smem);   // [STAGES][TP][RX] gathered x rows
  T* Gs = Xs + STAGES * TP * RX;        // [STAGES][TP][RG] g rows

  const int tiles_n = (Cout + bn - 1) / bn;
  const int c0 = (blockIdx.y / tiles_n) * bm, n0 = (blockIdx.y % tiles_n) * bn;
  const int s = blockIdx.x;
  const int tid = threadIdx.x, nwarps = blockDim.x >> 5;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int wm = (warp % (bm / 32)) * 32, wn = (warp / (bm / 32)) * 32;
  const int cx = bm / VEC, cg = bn / VEC;  // 16-byte copies per staged row
  const long long total = seg[K];
  const long long p0 = range_begin(total, s, S), p1 = range_begin(total, s + 1, S);

  for (int k = 0; k < K; ++k) {
    const long long lo = max(p0, seg[k]), hi = min(p1, seg[k + 1]);
    if (lo >= hi) continue;
    const int npairs = (int)(hi - lo);
    const int nsteps = (npairs + TP - 1) / TP;
    const int32_t* ps = pair_src + (size_t)k * rows + (lo - seg[k]);
    const int32_t* pd = pair_dst + (size_t)k * rows + (lo - seg[k]);

    // this lane's pair of step st: (x row, g row), -1 past the range
    auto load_pair = [&](int st, int& sr, int& dr) {
      const int j = st * TP + lane;
      const bool ok = st < nsteps && j < npairs;
      sr = ok ? ps[j] : -1;
      dr = ok ? pd[j] : -1;
    };
    auto issue = [&](int st, int sr, int dr) {
      T* xs = Xs + ((st % STAGES) * TP + lane) * RX;
      T* gs = Gs + ((st % STAGES) * TP + lane) * RG;
      if (vec_ok) {
        for (int q = warp; q < cx + cg; q += nwarps) {
          if (q < cx) {
            const int c = c0 + q * VEC;
            const bool ok = sr >= 0 && c < Cin;
            cp_async16(xs + q * VEC, ok ? x + (size_t)sr * Cin + c : x, ok);
          } else {
            const int n = n0 + (q - cx) * VEC;
            const bool ok = dr >= 0 && n < Cout;
            cp_async16(gs + (q - cx) * VEC, ok ? g + (size_t)dr * Cout + n : g, ok);
          }
        }
      } else {
        for (int q = warp; q < bm + bn; q += nwarps) {
          if (q < bm) {
            const int c = c0 + q;
            xs[q] = (sr >= 0 && c < Cin) ? x[(size_t)sr * Cin + c] : zero<T>();
          } else {
            const int n = n0 + q - bm;
            gs[q - bm] = (dr >= 0 && n < Cout) ? g[(size_t)dr * Cout + n] : zero<T>();
          }
        }
      }
    };

    // the warp's 32 (Cin) x 32 (Cout): 2 x 4 fragments of 16 x 8
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

    auto compute = [&](int stage) {
      const T* xs = Xs + stage * TP * RX + wm + gq;
      const T* gs = Gs + stage * TP * RG + wn + gq;
      if constexpr (sizeof(T) == 4) {
        float d[2][4][4] = {};
#pragma unroll
        for (int kk = 0; kk < TP; kk += 8) {
          // A[c][p] = xs[p][c], B[p][n] = gs[p][n]
          const float* xa = reinterpret_cast<const float*>(xs) + (kk + t) * RX;
          const float* gb = reinterpret_cast<const float*>(gs) + (kk + t) * RG;
          uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            split_tf32(xa[i * 16], ah[i][0], al[i][0]);
            split_tf32(xa[i * 16 + 8], ah[i][1], al[i][1]);
            split_tf32(xa[4 * RX + i * 16], ah[i][2], al[i][2]);
            split_tf32(xa[4 * RX + i * 16 + 8], ah[i][3], al[i][3]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            split_tf32(gb[j * 8], bh[j][0], bl[j][0]);
            split_tf32(gb[4 * RG + j * 8], bh[j][1], bl[j][1]);
          }
          mma_3xtf32(d, ah, al, bh, bl);
        }
        flush(acc, d);
      } else {
#pragma unroll
        for (int kk = 0; kk < TP; kk += 16) {
          const T* xa = xs + (kk + 2 * t) * RX;
          const T* gb = gs + (kk + 2 * t) * RG;
          uint32_t af[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const T* p = xa + (q >> 1) * 8 * RX + i * 16 + (q & 1) * 8;
              af[i][q] = pack_bf16(p[0], p[RX]);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t bf[2];
            bf[0] = pack_bf16(gb[j * 8], gb[RG + j * 8]);
            bf[1] = pack_bf16(gb[8 * RG + j * 8], gb[9 * RG + j * 8]);
#pragma unroll
            for (int i = 0; i < 2; ++i) mma_bf16(acc[i][j], af[i], bf);
          }
        }
      }
    };

    int sr, dr;
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      load_pair(st, sr, dr);
      if (st < nsteps) issue(st, sr, dr);
      cp_async_commit();
    }
    load_pair(STAGES - 1, sr, dr);
    for (int st = 0; st < nsteps; ++st) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // step st has landed; every warp is done with st - 1
      if (st + STAGES - 1 < nsteps) issue(st + STAGES - 1, sr, dr);
      cp_async_commit();
      load_pair(st + STAGES, sr, dr);  // in flight during the multiply
      compute(st % STAGES);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next segment

    float* out = part + (size_t)(s + k) * Cin * Cout;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wm + i * 16 + gq + h * 8;
        if (c >= Cin) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + wn + j * 8 + 2 * t;
          if (n < Cout) out[(size_t)c * Cout + n] = acc[i][j][2 * h];
          if (n + 1 < Cout) out[(size_t)c * Cout + n + 1] = acc[i][j][2 * h + 1];
        }
      }
    }
  }
}

// gw[k, i] = sum over the ranges s that meet offset k's segment, in the
// order of s, of part[s + k, i]; zero for an offset with no pair. The same
// test as the first kernel's picks the ranges: the deterministic second pass.
__global__ void sum_splits_kernel(const float* __restrict__ part, const long long* __restrict__ seg,
                                  float* __restrict__ gw, long long m, int K, int S) {
  const long long total = seg[K];
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < K * m;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(i / m);
    const long long lo = seg[k], hi = seg[k + 1];
    float acc = 0.f;
    if (hi > lo) {
      int s = (int)(lo * S / total) - 1;
      for (s = s < 0 ? 0 : s; s < S; ++s) {
        const long long p0 = range_begin(total, s, S), p1 = range_begin(total, s + 1, S);
        if (p0 >= hi) break;
        if (max(p0, lo) < min(p1, hi)) acc += part[(size_t)(s + k) * m + i % m];
      }
    }
    gw[i] = acc;
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* pair_src, const void* pair_dst,
           const void* seg, void* part, void* gw, int rows, int Cin, int Cout, int K, int S,
           int vec_ok, void* stream) {
  if (S < 1 || rows < 1 || K < 1 || Cin < 1 || Cout < 1) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(rulebook_conv_dw_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_bytes<T>(MAX_TILE, MAX_TILE));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int bm = Cin >= MAX_TILE ? MAX_TILE : (Cin + 31) / 32 * 32;
  const int bn = Cout >= MAX_TILE ? MAX_TILE : (Cout + 31) / 32 * 32;
  const int tiles = ((Cin + bm - 1) / bm) * ((Cout + bn - 1) / bn);
  dim3 grid(S, tiles);
  rulebook_conv_dw_kernel<T><<<grid, (bm / 32) * (bn / 32) * 32, smem_bytes<T>(bm, bn),
                               (cudaStream_t)stream>>>(
      (const T*)x, (const T*)g, (const int32_t*)pair_src, (const int32_t*)pair_dst,
      (const long long*)seg, (float*)part, rows, Cin, Cout, K, S, bm, bn, vec_ok);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long m = (long long)Cin * Cout;
  const long long want = (K * m + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  sum_splits_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)part, (const long long*)seg, (float*)gw, m, K, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B*V, Cin], g [B*V, Cout] (one dtype) and the plan's pair lists:
// pair_src, pair_dst [K, rows = B*V] int32 (per offset its valid pairs
// first: x row, g row), seg [K + 1] int64 (the offsets' segments in the
// concatenated lists); part [S + K, Cin, Cout] f32 scratch, gw [K, Cin,
// Cout] f32. All contiguous on the device; vec_ok says that every x and g
// row starts on 16 bytes. Returns the cudaError_t of the launches.
int rulebook_conv_dw_f32(const void* x, const void* g, const void* pair_src,
                         const void* pair_dst, const void* seg, void* part, void* gw, int rows,
                         int Cin, int Cout, int K, int S, int vec_ok, void* stream) {
  return launch<float>(x, g, pair_src, pair_dst, seg, part, gw, rows, Cin, Cout, K, S, vec_ok,
                       stream);
}

int rulebook_conv_dw_bf16(const void* x, const void* g, const void* pair_src,
                          const void* pair_dst, const void* seg, void* part, void* gw, int rows,
                          int Cin, int Cout, int K, int S, int vec_ok, void* stream) {
  return launch<__nv_bfloat16>(x, g, pair_src, pair_dst, seg, part, gw, rows, Cin, Cout, K, S,
                               vec_ok, stream);
}

}  // extern "C"
