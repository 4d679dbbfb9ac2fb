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
