// Tensor-core and asynchronous-copy building blocks shared by the rulebook
// conv kernels K1 (rulebook_conv.cu) and K1b (rulebook_conv_bwd.cu).
//
//   * cp.async: 16-byte copies from device memory into shared memory that
//     complete in groups, so a block gathers the rows of a later step while
//     it multiplies the current one; a copy that is not valid writes zeros.
//   * mma.sync on the tensor cores, f32 accumulation:
//       - bf16 inputs: m16n8k16 bf16, one product per fragment pair;
//       - f32 inputs: 3xTF32 with m16n8k8 tf32. Each operand is split into
//         hi = tf32(a) and lo = tf32(a - hi) (10 mantissa bits each, both
//         rounded to nearest), and hi*hi + hi*lo + lo*hi is summed, the
//         small terms first, one step at a time, and each step's sum is
//         added to the f32 sum by a rounded add.
//         What is dropped, lo*lo and the rounding of lo, is ~2^-22 of each
//         product: f32 accuracy, where one pass of TF32 keeps ~2^-11 (three
//         decimal digits).
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k8/k16"), with
// g = lane / 4 and t = lane % 4:
//   tf32 m16n8k8: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
//                 b0 (k=t, n=g), b1 (k=t+4, n=g);
//   bf16 m16n8k16: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                  a3 (g+8, 2t+8..); b0 (k=2t..2t+1, n=g), b1 (k=2t+8.., n=g),
//                  the lower k in the lower 16 bits;
//   accumulator:  c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rbmma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src into shared dst, or 16 zero bytes when !valid (src is
// then not read, but must still be a device address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}

// a = hi + lo to ~2^-22 of a, both exact tf32 values
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(a);
  lo = to_tf32(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i][j] += a[i] * b[j] over M x N fragments in 3xTF32: lo*hi, hi*lo,
// then hi*hi, each pass over every fragment so that no mma waits on the one
// before it.
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[M][N][4], const uint32_t (&ah)[M][4],
                                           const uint32_t (&al)[M][4], const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(d[i][j], al[i], bh[j]);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(d[i][j], ah[i], bl[j]);
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(d[i][j], ah[i], bh[j]);
}

// c += d on the CUDA cores (rounded adds). The tensor cores'
// f32 accumulation truncates, so a long sum kept in their accumulator drifts
// (~1e-5 of it over the ~3500 products of a row of the main path); the
// kernels sum one step (32 channels or pairs) on the tensor cores and add
// the steps here, which keeps f32 accuracy.
template <int M, int N>
__device__ __forceinline__ void flush(float (&c)[M][N][4], const float (&d)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[i][j][q] += d[i][j][q];
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 values of consecutive k in one register, the lower k low
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// elements in one 16-byte copy
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / (int)sizeof(T); }

}  // namespace rbmma
