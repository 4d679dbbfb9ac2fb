// Q3_K fused dequant-matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/q3_k_matmul.py::matmul_q3_k
// (Pallas body _kernel, its default approx_cvt53=False form). Computes
//     y(M, N) = x(M, K) . dequant_q3_k(ql, qh, sc, d)(N, K)^T
// with f32 accumulation; K % 256 == 0. Planes (core/quant/pack.py):
//     ql i32 (N, K/16)  16 x 2-bit lows per word
//     qh i32 (N, K/32)  32 x 1-bit highs per word
//     sc i8  (N, K/16)  us in [32, 63]; the sub-block scale is us - 32
//     d  f16 (N, K/256) super-block scale per 256
// The tile loop, split-K and the bound are dequant_matmul.cuh's; this
// file is the q3_k front-end: a thread reads one 16-element sub-block of
// a row (one ql word, the 16-bit half of a qh word that holds its highs,
// its sc and its super-block's d) and decodes it in registers
// (common.cuh q3_k_decode16), bit-identical to dequantize_q3_k. At
// 0.45 bytes per weight and M = 64 the kernel is bound by f32 FMA issue,
// not by the weight stream.
#include "dequant_matmul.cuh"

namespace {

using namespace repro_torch;

struct Q3_K {
  const uint32_t* ql;
  const uint32_t* qh;
  const int8_t* sc;
  const __half* d;
  static constexpr bool kRaggedK = false;

  __device__ __forceinline__ void decode16(int n, int k, int K,
                                           float w[16]) const {
    const size_t s = (size_t)n * (K / 16) + k / 16;
    // Sub-block k/16 holds bits 16 * (k/16 & 1) .. +15 of qh word k/32.
    const uint32_t hi =
        qh[(size_t)n * (K / 32) + k / 32] >> (16 * ((k / 16) & 1));
    q3_k_decode16(ql[s], hi, sc[s], d[(size_t)n * (K / 256) + k / 256], w);
  }
};

}  // namespace

// See dequant_matmul::launch for the arguments.
extern "C" int q3_k_matmul(const void* x, int x_dtype, const void* ql,
                           const void* qh, const void* sc, const void* d,
                           void* y, int y_dtype, void* workspace, int M,
                           int N, int K, int k_split, int splits,
                           void* stream) {
  const Q3_K fmt{static_cast<const uint32_t*>(ql),
                 static_cast<const uint32_t*>(qh),
                 static_cast<const int8_t*>(sc),
                 static_cast<const __half*>(d)};
  return repro_torch::dequant_matmul::launch(
      fmt, x, x_dtype, y, y_dtype, workspace, M, N, K, k_split, splits,
      stream);
}
