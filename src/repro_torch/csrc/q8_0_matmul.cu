// Q8_0 fused dequant-matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/q8_0_matmul.py::matmul_q8_0
// (Pallas body _kernel). Computes
//     y(M, N) = x(M, K) . (qs(N, K) int8 * d(N, K/32) fp16)^T
// with f32 accumulation; K % 32 == 0. The tile loop, split-K and the
// bound are dequant_matmul.cuh's; this file is the q8_0 front-end: each
// weight row's 32 quants of a K step are read once per M-tile as two
// 16-byte vectors and scaled by the block's fp16 scale in registers
// (common.cuh q8_0_decode16). At 1.0625 bytes per weight and M = 64 the
// kernel is bound by f32 FMA issue, not by the weight stream.
#include "dequant_matmul.cuh"

namespace {

using namespace repro_torch;

struct Q8_0 {
  const int8_t* qs;             // (N, K), 16-byte aligned
  const __half* d;              // (N, K/32)
  static constexpr bool kRaggedK = false;

  __device__ __forceinline__ void decode16(int n, int k, int K,
                                           float w[16]) const {
    q8_0_decode16(qs + (size_t)n * K + k, d[(size_t)n * (K / 32) + k / 32],
                  w);
  }
};

}  // namespace

// See dequant_matmul::launch for the arguments.
extern "C" int q8_0_matmul(const void* x, int x_dtype, const void* qs,
                           const void* d, void* y, int y_dtype,
                           void* workspace, int M, int N, int K, int k_split,
                           int splits, void* stream) {
  const Q8_0 fmt{static_cast<const int8_t*>(qs),
                 static_cast<const __half*>(d)};
  return repro_torch::dequant_matmul::launch(
      fmt, x, x_dtype, y, y_dtype, workspace, M, N, K, k_split, splits,
      stream);
}
