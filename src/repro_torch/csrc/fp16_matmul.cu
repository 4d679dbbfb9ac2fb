// FP16 fused upconvert-matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/fp16_matmul.py::matmul_fp16
// (Pallas body _kernel). Computes
//     y(M, N) = x(M, K) . w(N, K)^T,   w fp16 upconverted to f32,
// with f32 accumulation; any K (the JAX wrapper zero-pads K to 128; here
// the K tail past the last 32-step is masked in the kernel instead, so
// the planes are used as they are). The tile loop, split-K and the bound
// are dequant_matmul.cuh's; this file is the fp16 front-end: 16 halves
// of a row per thread as two 16-byte loads, upconverted in registers
// (common.cuh fp16_decode16), or element by element where the row is not
// 16-byte aligned (K % 8 != 0) or at the K tail. At 2 bytes per weight
// and M = 64 (64 flops per byte) the kernel is bound by f32 FMA issue.
#include "dequant_matmul.cuh"

namespace {

using namespace repro_torch;

struct Fp16 {
  const __half* w;              // (N, K)
  bool vec;                     // rows 16-byte aligned: K % 8 == 0
  static constexpr bool kRaggedK = true;

  __device__ __forceinline__ void decode16(int n, int k, int K,
                                           float out[16]) const {
    const __half* src = w + (size_t)n * K + k;
    if (vec && k + 16 <= K) {
      fp16_decode16(src, out);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        out[j] = k + j < K ? __half2float(src[j]) : 0.f;
    }
  }
};

}  // namespace

// See dequant_matmul::launch for the arguments.
extern "C" int fp16_matmul(const void* x, int x_dtype, const void* w,
                           void* y, int y_dtype, void* workspace, int M,
                           int N, int K, int k_split, int splits,
                           void* stream) {
  const bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const Fp16 fmt{static_cast<const __half*>(w), vec};
  return repro_torch::dequant_matmul::launch(
      fmt, x, x_dtype, y, y_dtype, workspace, M, N, K, k_split, splits,
      stream);
}
