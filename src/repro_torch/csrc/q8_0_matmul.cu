// Q8_0 fused dequant-matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/q8_0_matmul.py::matmul_q8_0
// (Pallas body _kernel). Computes
//     y(M, N) = x(M, K) . (qs(N, K) int8 * d(N, K/32) fp16)^T
// with f32 accumulation; K % 32 == 0. The tile loop, split-K and the
// bound are dequant_matmul.cuh's; this file is the q8_0 front-end: a
// sub-block's 16 quants are one 16-byte vector, turned into exact bf16
// codes (common.cuh q8_0_codes), and its scale is the block's fp16 d
// (one scale per 32: two k16 products per fragment). At 1.0625 bytes per
// weight and M = 64 the weight stream bounds it; at M = 4,096 the tensor
// cores.
#include "dequant_matmul.cuh"

namespace {

using namespace repro_torch;

struct Q8_0 {
  const int8_t* qs;             // (N, K), 16-byte aligned
  const __half* d;              // (N, K/32)
  static constexpr bool kRaggedK = false;
  static constexpr int kScaleK = 32, kParts = 1;
  struct Raw {
    int4 q;
    __half d;
  };

  __device__ __forceinline__ Raw load(int n, int k, int K) const {
    return Raw{*reinterpret_cast<const int4*>(qs + (size_t)n * K + k),
               d[(size_t)n * (K / 32) + k / 32]};
  }
  __device__ __forceinline__ void codes(const Raw& r, uint32_t c[1][8]) const {
    q8_0_codes(r.q, c[0]);
  }
  __device__ __forceinline__ float scale(const Raw& r) const {
    return __half2float(r.d);
  }
};

}  // namespace

// See dequant_matmul::launch for the arguments.
extern "C" int q8_0_matmul(const void* x, int x_dtype, const void* qs,
                           const void* d, void* y, int y_dtype,
                           void* workspace, int M, int N, int K, int tile,
                           int k_split, int splits, void* stream) {
  const Q8_0 fmt{static_cast<const int8_t*>(qs),
                 static_cast<const __half*>(d)};
  return repro_torch::dequant_matmul::launch(
      fmt, x, x_dtype, y, y_dtype, workspace, M, N, K, tile, k_split, splits,
      stream);
}
