// Q3_K fused dequant-matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/q3_k_matmul.py::matmul_q3_k
// (Pallas body _kernel) in both its forms: exact (approx_cvt53=False,
// every serving path) and the paper's CVT53 approximation
// (approx_cvt53=True: each 6-bit sub-block scale loses its low bit,
// sc & ~1, before sc - 32; entry point q3_k_matmul_approx). Computes
//     y(M, N) = x(M, K) . dequant_q3_k(ql, qh, sc, d)(N, K)^T
// with f32 accumulation; K % 256 == 0. Planes (core/quant/pack.py):
//     ql i32 (N, K/16)  16 x 2-bit lows per word
//     qh i32 (N, K/32)  32 x 1-bit highs per word
//     sc i8  (N, K/16)  us in [32, 63]; the sub-block scale is us - 32
//     d  f16 (N, K/256) super-block scale per 256
// The tile loop, split-K and the bound are dequant_matmul.cuh's; this
// file is the q3_k front-end: a thread reads one 16-element sub-block of
// a row (one ql word, the 16-bit half of a qh word that holds its highs,
// its sc and its super-block's d) and decodes it in registers into exact
// bf16 codes (common.cuh q3_k_codes) and the scale (us - 32) * d: code *
// scale is dequantize_q3_k, bit for bit. At 0.45 bytes per weight and
// M = 64 the weight stream bounds it; at M = 4,096 the tensor cores and
// the per-sub-block scaling.
#include "dequant_matmul.cuh"

namespace {

using namespace repro_torch;

template <bool kApprox>                  // CVT53: sc & ~1
struct Q3_K {
  const uint32_t* ql;
  const uint32_t* qh;
  const int8_t* sc;
  const __half* d;
  static constexpr bool kRaggedK = false;
  static constexpr int kScaleK = 16, kParts = 1;
  struct Raw {
    uint32_t ql, qh16;
    int8_t sc;
    __half d;
  };

  __device__ __forceinline__ Raw load(int n, int k, int K) const {
    const size_t s = (size_t)n * (K / 16) + k / 16;
    // Sub-block k/16 holds bits 16 * (k/16 & 1) .. +15 of qh word k/32.
    return Raw{ql[s],
               qh[(size_t)n * (K / 32) + k / 32] >> (16 * ((k / 16) & 1)),
               sc[s], d[(size_t)n * (K / 256) + k / 256]};
  }
  __device__ __forceinline__ void codes(const Raw& r, uint32_t c[1][8]) const {
    q3_k_codes(r.ql, r.qh16, c[0]);
  }
  // sc holds us in [32, 63]; the scale is (us - 32) * d in f32, in the
  // order dequantize_q3_k takes. With kApprox (the paper's CVT53,
  // approx_cvt53=True) us loses its low bit first: us = sc & ~1, bit for
  // bit q3_k_matmul.py:33-34.
  __device__ __forceinline__ float scale(const Raw& r) const {
    const int us = kApprox ? (static_cast<int>(r.sc) & ~1)
                           : static_cast<int>(r.sc);
    return (static_cast<float>(us) - 32.f) * __half2float(r.d);
  }
};

template <bool kApprox>
int run(const void* x, int x_dtype, const void* ql, const void* qh,
        const void* sc, const void* d, void* y, int y_dtype,
        void* workspace, int M, int N, int K, int tile, int k_split,
        int splits, void* stream) {
  const Q3_K<kApprox> fmt{static_cast<const uint32_t*>(ql),
                          static_cast<const uint32_t*>(qh),
                          static_cast<const int8_t*>(sc),
                          static_cast<const __half*>(d)};
  return repro_torch::dequant_matmul::launch(
      fmt, x, x_dtype, y, y_dtype, workspace, M, N, K, tile, k_split, splits,
      stream);
}

}  // namespace

// See dequant_matmul::launch for the arguments. The exact form.
extern "C" int q3_k_matmul(const void* x, int x_dtype, const void* ql,
                           const void* qh, const void* sc, const void* d,
                           void* y, int y_dtype, void* workspace, int M,
                           int N, int K, int tile, int k_split, int splits,
                           void* stream) {
  return run<false>(x, x_dtype, ql, qh, sc, d, y, y_dtype, workspace, M,
                    N, K, tile, k_split, splits, stream);
}

// The approx_cvt53 form: the same arguments, scales sc & ~1.
extern "C" int q3_k_matmul_approx(const void* x, int x_dtype, const void* ql,
                                  const void* qh, const void* sc,
                                  const void* d, void* y, int y_dtype,
                                  void* workspace, int M, int N, int K,
                                  int tile, int k_split, int splits,
                                  void* stream) {
  return run<true>(x, x_dtype, ql, qh, sc, d, y, y_dtype, workspace, M,
                   N, K, tile, k_split, splits, stream);
}
