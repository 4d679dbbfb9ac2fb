// Q6_K fused dequant-matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/q6_k_matmul.py::matmul_q6_k
// (Pallas body _kernel). Computes
//     y(M, N) = x(M, K) . dequant_q6_k(ql, qh, sc, d)(N, K)^T
// with f32 accumulation; K % 256 == 0. Planes (core/quant/pack.py):
//     ql i32 (N, K/8)   8 x 4-bit lows per word
//     qh i32 (N, K/16)  16 x 2-bit highs per word
//     sc i8  (N, K/16)  signed sub-block scale per 16
//     d  f16 (N, K/256) super-block scale per 256
// The tile loop, split-K and the bound are dequant_matmul.cuh's; this
// file is the q6_k front-end: a thread reads one 16-element sub-block of
// a row (two ql words, one qh word, its sc and its super-block's d) and
// decodes it in registers (common.cuh q6_k_decode16), bit-identical to
// dequantize_q6_k. At 0.82 bytes per weight and M = 64 the kernel is
// bound by f32 FMA issue, not by the weight stream.
#include "dequant_matmul.cuh"

namespace {

using namespace repro_torch;

struct Q6_K {
  const uint32_t* ql;
  const uint32_t* qh;
  const int8_t* sc;
  const __half* d;
  static constexpr bool kRaggedK = false;

  __device__ __forceinline__ void decode16(int n, int k, int K,
                                           float w[16]) const {
    const uint32_t* lo = ql + (size_t)n * (K / 8) + k / 8;
    const size_t s = (size_t)n * (K / 16) + k / 16;
    q6_k_decode16(lo[0], lo[1], qh[s], sc[s],
                  d[(size_t)n * (K / 256) + k / 256], w);
  }
};

}  // namespace

// See dequant_matmul::launch for the arguments.
extern "C" int q6_k_matmul(const void* x, int x_dtype, const void* ql,
                           const void* qh, const void* sc, const void* d,
                           void* y, int y_dtype, void* workspace, int M,
                           int N, int K, int k_split, int splits,
                           void* stream) {
  const Q6_K fmt{static_cast<const uint32_t*>(ql),
                 static_cast<const uint32_t*>(qh),
                 static_cast<const int8_t*>(sc),
                 static_cast<const __half*>(d)};
  return repro_torch::dequant_matmul::launch(
      fmt, x, x_dtype, y, y_dtype, workspace, M, N, K, k_split, splits,
      stream);
}
