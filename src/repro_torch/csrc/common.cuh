// Shared front-end (format decode) and back-end (MAC) for the port's
// matmul kernels: the CUDA counterpart of repro/kernels/common.py.
//
// The paper's idea (§III.C) carries over unchanged: each weight format
// has its own front-end that turns packed quants plus block scales into
// one dense f32 representation, and every format shares one f32
// multiply-accumulate back-end. Here the front-end writes the dense tile
// into shared memory and the back-end is a register-tiled outer product
// with f32 accumulation (the CGLA's 24-bit accumulator, the TPU's f32
// MXU accumulation).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Front-end (apply_block_scales): 16 int8 quants of one q8_0 block,
// loaded as one 16-byte vector, times the block's fp16 scale -> f32.
__device__ __forceinline__ void q8_0_decode16(const int8_t* __restrict__ src,
                                              __half scale, float out[16]) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
  const float d = __half2float(scale);
#pragma unroll
  for (int j = 0; j < 16; ++j) out[j] = static_cast<float>(q[j]) * d;
}

// Front-end (FP16 LUT-upconvert analog): 16 consecutive halves of one
// weight row, loaded as two 16-byte vectors (src 16-byte aligned).
__device__ __forceinline__ void fp16_decode16(const __half* __restrict__ src,
                                              float out[16]) {
  const int4 raw[2] = {reinterpret_cast<const int4*>(src)[0],
                       reinterpret_cast<const int4*>(src)[1]};
  const __half* h = reinterpret_cast<const __half*>(raw);
#pragma unroll
  for (int j = 0; j < 16; ++j) out[j] = __half2float(h[j]);
}

// Front-end (CVT86 + SML16 analog): one 16-element q6_k sub-block. ql0/ql1
// hold its 16 4-bit lows (element j in bits 4j..4j+3 of ql0, j >= 8 in
// ql1), qh its 16 2-bit highs (bits 2j..2j+1). q = (lo | hi << 4) - 32;
// the weight is q * (sc * d) in f32, in the order dequantize_q6_k takes.
// The words are unsigned: field 7 of ql and field 15 of qh reach bit 31,
// and the shifts must be logical (JAX's shift_right_logical).
__device__ __forceinline__ void q6_k_decode16(uint32_t ql0, uint32_t ql1,
                                              uint32_t qh, int8_t sc,
                                              __half d, float out[16]) {
  const float eff = static_cast<float>(sc) * __half2float(d);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t lo = ((j < 8 ? ql0 : ql1) >> (4 * (j % 8))) & 0xFu;
    const uint32_t hi = (qh >> (2 * j)) & 0x3u;
    out[j] = static_cast<float>(static_cast<int>(lo | (hi << 4)) - 32) * eff;
  }
}

// Front-end (CVT53 analog): one 16-element q3_k sub-block. ql holds its 16
// 2-bit lows (bits 2j..2j+1), qh16 its 16 1-bit highs (bit j; the caller
// shifts the sub-block's half of the 32-bit qh word down, logically).
// q = lo + 4 * hi - 4; sc holds us in [32, 63] and the weight is
// q * ((us - 32) * d) in f32, in the order dequantize_q3_k takes. With
// kApprox (the paper's CVT53, approx_cvt53=True) the 6-bit scale loses
// its low bit first: us = sc & ~1, bit for bit q3_k_matmul.py:33-34. A
// template parameter, so the exact form's code carries no test of it.
template <bool kApprox>
__device__ __forceinline__ void q3_k_decode16(uint32_t ql, uint32_t qh16,
                                              int8_t sc, __half d,
                                              float out[16]) {
  const int us = kApprox ? (static_cast<int>(sc) & ~1) : static_cast<int>(sc);
  const float eff = (static_cast<float>(us) - 32.f) * __half2float(d);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int lo = static_cast<int>((ql >> (2 * j)) & 0x3u);
    const int hi = static_cast<int>((qh16 >> j) & 0x1u);
    out[j] = static_cast<float>(lo + 4 * hi - 4) * eff;
  }
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
