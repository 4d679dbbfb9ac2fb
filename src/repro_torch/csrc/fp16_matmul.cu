// FP16 fused upconvert-matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/fp16_matmul.py::matmul_fp16
// (Pallas body _kernel). Computes
//     y(M, N) = x(M, K) . w(N, K)^T,   w fp16 upconverted to f32,
// with f32 accumulation; any K (the JAX wrapper zero-pads K to 128; here
// the K tail past the last 32-step is masked in the kernel instead, so
// the planes are used as they are). The tile loop, split-K and the bound
// are dequant_matmul.cuh's; this file is the fp16 front-end: 16 halves
// of a row per thread as two 16-byte loads, or element by element where
// the row is not 16-byte aligned (K % 8 != 0) or at the K tail, each
// split exactly into two bf16 codes hi + lo (common.cuh fp16_codes: two
// tensor-core products, no scale). At 2 bytes per weight and M = 64 (64
// flops per byte) the weight stream bounds it.
#include "dequant_matmul.cuh"

namespace {

using namespace repro_torch;

struct Fp16 {
  const __half* w;              // (N, K)
  bool vec;                     // rows 16-byte aligned: K % 8 == 0
  static constexpr bool kRaggedK = true;
  static constexpr int kScaleK = 0, kParts = 2;
  struct Raw {
    uint32_t h[8];              // 16 halves, zero past K
  };

  __device__ __forceinline__ Raw load(int n, int k, int K) const {
    const __half* src = w + (size_t)n * K + k;
    Raw r;
    if (vec && k + 16 <= K) {
      const uint4 a = reinterpret_cast<const uint4*>(src)[0];
      const uint4 b = reinterpret_cast<const uint4*>(src)[1];
      r = Raw{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
    } else {
      __half* h = reinterpret_cast<__half*>(r.h);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        h[j] = k + j < K ? src[j] : __float2half(0.f);
    }
    return r;
  }
  __device__ __forceinline__ void codes(const Raw& r, uint32_t c[2][8]) const {
    fp16_codes(r.h, c[0], c[1]);
  }
};

}  // namespace

// See dequant_matmul::launch for the arguments.
extern "C" int fp16_matmul(const void* x, int x_dtype, const void* w,
                           void* y, int y_dtype, void* workspace, int M,
                           int N, int K, int tile, int k_split, int splits,
                           void* stream) {
  const bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const Fp16 fmt{static_cast<const __half*>(w), vec};
  return repro_torch::dequant_matmul::launch(
      fmt, x, x_dtype, y, y_dtype, workspace, M, N, K, tile, k_split, splits,
      stream);
}
