// Shared front-end (format decode) and back-end (MAC) for the port's
// matmul kernels: the CUDA counterpart of repro/kernels/common.py.
//
// The paper's idea (§III.C) carries over: each weight format has its own
// front-end that turns packed quants plus block scales into one dense
// representation, and every format shares one multiply-accumulate
// back-end with f32 accumulation (the CGLA's 24-bit accumulator, the
// TPU's f32 MXU accumulation). Here the dense representation is the
// sub-block's integer codes as exact bf16 plus one f32 scale: the
// tensor-core back-end (dequant_matmul.cuh) multiplies the codes and
// scales each sub-block's partial sum in f32, and the f32 CUDA-core
// back-end (mac_4x4) multiplies code * scale.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace repro_torch {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ void from_float(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

// Front-ends. A format decodes a 16-element sub-block of a weight row
// into its integer codes, as exact bf16 (pairs packed low half first),
// and one f32 scale, exactly the product the format's dequantizer forms
// (q8_0 d, q6_k sc * d, q3_k (us - 32) * d): the weight is code * scale
// in f32, bit for bit. fp16 has no scale; its weight splits exactly into
// two bf16 codes, hi + lo.

// bf16 pair of u0 - bias, u1 - bias for u in [0, 128): 0x4300 | u is the
// bf16 of 128 + u, and one bf16x2 fma adds neg2 = -(128 + bias) in both
// halves, exactly (every value involved is an integer below 2^8).
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t u0, uint32_t u1,
                                                 uint32_t neg2) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(0x43004300u | u0 | (u1 << 16)), "r"(0x3F803F80u), "r"(neg2));
  return r;
}

// q8_0 (apply_block_scales): 16 int8 quants, loaded as one 16-byte
// vector. Byte q ^ 0x80 = q + 128 in the low mantissa bits of 2^23 gives
// 2^23 + 128 + q exactly; subtracting 2^23 + 128 leaves q.
__device__ __forceinline__ void q8_0_codes(const int4& raw, uint32_t c[8]) {
  const uint32_t w[4] = {static_cast<uint32_t>(raw.x) ^ 0x80808080u,
                         static_cast<uint32_t>(raw.y) ^ 0x80808080u,
                         static_cast<uint32_t>(raw.z) ^ 0x80808080u,
                         static_cast<uint32_t>(raw.w) ^ 0x80808080u};
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const uint32_t sel = 0x7440u | (2 * (p % 2));
    const float f0 =
        __uint_as_float(__byte_perm(w[p / 2], 0x4B000000u, sel)) - 8388736.f;
    const float f1 =
        __uint_as_float(__byte_perm(w[p / 2], 0x4B000000u, sel + 1)) -
        8388736.f;
    c[p] = bf16x2(f0, f1);
  }
}

// q6_k (CVT86 + SML16): ql0/ql1 hold the 16 4-bit lows (element j in bits
// 4j..4j+3 of ql0, j >= 8 in ql1), qh the 16 2-bit highs (bits 2j..2j+1);
// the code is (lo | hi << 4) - 32. The words are unsigned: field 7 of ql
// and field 15 of qh reach bit 31, and the shifts must be logical (JAX's
// shift_right_logical).
__device__ __forceinline__ void q6_k_codes(uint32_t ql0, uint32_t ql1,
                                           uint32_t qh, uint32_t c[8]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    uint32_t u[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * p + h;
      u[h] = (((j < 8 ? ql0 : ql1) >> (4 * (j % 8))) & 0xFu) |
             (((qh >> (2 * j)) & 0x3u) << 4);
    }
    c[p] = codes_bf16x2(u[0], u[1], 0xC320C320u);   // -160
  }
}

// q3_k (CVT53): ql holds the 16 2-bit lows (bits 2j..2j+1), qh16 the 16
// 1-bit highs (bit j; the caller shifts the sub-block's half of the
// 32-bit qh word down, logically); the code is lo + 4 hi - 4.
__device__ __forceinline__ void q3_k_codes(uint32_t ql, uint32_t qh16,
                                           uint32_t c[8]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    uint32_t u[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * p + h;
      u[h] = ((ql >> (2 * j)) & 0x3u) | (((qh16 >> j) & 0x1u) << 2);
    }
    c[p] = codes_bf16x2(u[0], u[1], 0xC304C304u);   // -132
  }
}

// fp16 (the LUT upconvert): 16 halves, each split into hi = bf16(w) and
// lo = bf16(w - hi). Both are exact: fp16's 11 significant bits leave at
// most 3 for lo, and fp16's range lies inside bf16's.
__device__ __forceinline__ void fp16_codes(const uint32_t h[8],
                                           uint32_t hi[8], uint32_t lo[8]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h[p]));
    split_bf16(f.x, f.y, hi[p], lo[p]);
  }
}

// Element j of a packed bf16 pair array, as f32.
__device__ __forceinline__ float bf16_at(const uint32_t c[8], int j) {
  return __uint_as_float(j % 2 ? c[j / 2] & 0xffff0000u : c[j / 2] << 16);
}

// Back-end (mac_backend): one k-step of a 4x4 register tile,
// acc[i][j] += a[i] * b[j] in f32.
__device__ __forceinline__ void mac_4x4(const float4 a, const float4 b,
                                        float acc[4][4]) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

}  // namespace repro_torch
