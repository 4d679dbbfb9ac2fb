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
// decodes it in registers into exact bf16 codes (common.cuh q6_k_codes)
// and the scale sc * d: code * scale is dequantize_q6_k, bit for bit. At
// 0.82 bytes per weight and M = 64 the weight stream bounds it; at
// M = 4,096 the tensor cores and the per-sub-block scaling.
#include "dequant_matmul.cuh"

namespace {

using namespace repro_torch;

struct Q6_K {
  const uint32_t* ql;
  const uint32_t* qh;
  const int8_t* sc;
  const __half* d;
  static constexpr bool kRaggedK = false;
  static constexpr int kScaleK = 16, kParts = 1;
  struct Raw {
    uint32_t ql0, ql1, qh;
    int8_t sc;
    __half d;
  };

  __device__ __forceinline__ Raw load(int n, int k, int K) const {
    const uint32_t* lo = ql + (size_t)n * (K / 8) + k / 8;
    const size_t s = (size_t)n * (K / 16) + k / 16;
    return Raw{lo[0], lo[1], qh[s], sc[s],
               d[(size_t)n * (K / 256) + k / 256]};
  }
  __device__ __forceinline__ void codes(const Raw& r, uint32_t c[1][8]) const {
    q6_k_codes(r.ql0, r.ql1, r.qh, c[0]);
  }
  // sc * d in f32, in the order dequantize_q6_k takes.
  __device__ __forceinline__ float scale(const Raw& r) const {
    return static_cast<float>(r.sc) * __half2float(r.d);
  }
};

}  // namespace

// See dequant_matmul::launch for the arguments.
extern "C" int q6_k_matmul(const void* x, int x_dtype, const void* ql,
                           const void* qh, const void* sc, const void* d,
                           void* y, int y_dtype, void* workspace, int M,
                           int N, int K, int tile, int k_split, int splits,
                           void* stream) {
  const Q6_K fmt{static_cast<const uint32_t*>(ql),
                 static_cast<const uint32_t*>(qh),
                 static_cast<const int8_t*>(sc),
                 static_cast<const __half*>(d)};
  return repro_torch::dequant_matmul::launch(
      fmt, x, x_dtype, y, y_dtype, workspace, M, N, K, tile, k_split, splits,
      stream);
}
