// Device pieces shared by the tensor-core attention kernels (sm_90a): bf16
// mma.sync with float32 accumulators, ldmatrix, cp.async staging with a
// zero-fill predicate, and the pack of float32 accumulator (C) fragments
// into bf16 operand (A) fragments.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 g + c, g < 8, c < 4):
//   A (16 x 16, row-major), four b16x2 registers: rows g | g + 8, columns
//     2c, 2c + 1 | 2c + 8, 2c + 9, in the order (g, lo), (g + 8, lo),
//     (g, hi), (g + 8, hi);
//   B (16 x 8, column-major), two registers: rows 2c, 2c + 1 | 2c + 8,
//     2c + 9 of column g;
//   C/D (16 x 8), four float32: (g, 2c), (g, 2c + 1), (g + 8, 2c),
//     (g + 8, 2c + 1).
// So the C fragments of two neighbouring n-tiles of a product, each pair
// packed to bf16x2, are the A fragment of the next product's 16-wide k step
// (pack_a): a score tile goes from one product to the next in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- PTX wrappers --
__device__ __forceinline__ uint8_t* dyn_smem() {
  extern __shared__ __align__(16) uint8_t smem_[];
  return smem_;
}

__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}

// 16 bytes global -> shared, in flight until cp_async_wait; zeros if !valid
// (src is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 b16 matrices: lane l gives the address of row l % 8 of matrix
// l / 8 and gets word l % 4 of row l / 4 of each (of each transposed
// matrix with kTrans: the elements (2 (l % 4), l / 4) and (2 (l % 4) + 1,
// l / 4)).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major); bf16 in, float32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16x2 {lo, hi}, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// -- end PTX wrappers --

// The A fragment of a 16-wide k step from the C fragments of the two
// n-tiles c0 (k columns 0-7) and c1 (8-15), rounded once to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

}  // namespace
