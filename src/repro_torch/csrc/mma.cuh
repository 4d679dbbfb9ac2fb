// Tensor-core and asynchronous-copy building blocks (sm_80+ PTX, run on
// sm_90a): 16-byte cp.async with zero fill, ldmatrix (plain and
// transposed) and the bf16 m16n8k16 mma with f32 accumulation (the paged
// attention kernel), and the bf16 pair conversions and ex2 that the
// wgmma kernels share (hopper.cuh includes this file).
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4):
//   A 16x16 (row-major): a0 (row g, cols 2t, 2t+1), a1 (row g+8, the
//     same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8..);
//   B 16x8 (k x n, "col"): b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g);
//   C 16x8 f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, ...).
// A C tile pair (n-tiles 2j, 2j+1) is therefore the A fragment of the
// next product over those 16 columns (P in P.V) without a shuffle.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; with `valid` false the 16
// bytes are zero-filled and nothing is read (src may be any address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a . b, bf16 inputs, f32 accumulators. Not volatile: a pure
// function of registers, so the compiler may schedule it after later
// (volatile) ldmatrix loads and overlap their latency.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Two f32 values x0, x1 rounded to a bf16 pair (x0 in the low half).
__device__ __forceinline__ uint32_t bf16x2(float x0, float x1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}

// Two f32 values x0, x1 (low half first) split into bf16 pairs
// hi = bf16(x), lo = bf16(x - hi): hi + lo is x to ~2^-17 relative.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = bf16x2(x0, x1);
  lo = bf16x2(x0 - __uint_as_float(hi << 16),
              x1 - __uint_as_float(hi & 0xffff0000u));
}

// 2^x (MUFU.EX2; a result below 2^-126 flushes to 0, far under any
// softmax weight that can move a sum whose largest term is 1).
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

}  // namespace repro_torch
