// Q8_0 fused dequant-matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/q8_0_matmul.py::matmul_q8_0
// (Pallas body _kernel). Computes
//     y(M, N) = x(M, K) . (qs(N, K) int8 * d(N, K/32) fp16)^T
// with f32 accumulation; x is f32 or bf16; y is f32, or bf16 rounded
// from the f32 result (what the model layers cast it to anyway, without
// a second pass); K % 32 == 0; any M and N (the ragged edges are masked,
// nothing is padded or copied).
//
// What bounds it on the card: on the serving path M = slots x chunk is
// small (64), so the kernel streams the weight planes once per call --
// 1.0625 bytes per weight (int8 + one fp16 scale per 32) against 2*M
// flops per weight. At M = 64 that is ~120 flops per byte: below the
// bf16 tensor-core ridge, above the f32 CUDA-core ridge (~20). This
// first kernel runs its MACs on the CUDA cores in f32, so at full width
// it is bound by f32 FMA issue, not by the weight stream; the tensor-core
// (mma/wgmma) back-end that reaches the byte bound is later work.
//
// Design:
//   * one 64 x 64 output tile per block of 256 threads, each thread a
//     4 x 4 register tile (the back-end, common.cuh mac_4x4);
//   * K walks in steps of one q8_0 block (32): each weight row's 32 quants
//     are read once per M-tile as two 16-byte vectors, scaled by the
//     block's fp16 scale in registers (the front-end, q8_0_decode16) and
//     staged in shared memory as f32 next to the x tile;
//   * small N leaves most SMs idle, so the wrapper may split K across
//     gridDim.z; each split writes its partial tile to a workspace and a
//     second pass sums the splits in a fixed order (no atomics, so a
//     result never varies from run to run).
#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;          // one q8_0 block
constexpr int THREADS = 256;
constexpr int PAD = 4;          // keeps rows 16-byte aligned for float4

// Writes TY (the final dtype) when the grid has one split, f32 partials
// into the workspace otherwise.
template <typename TX, typename TY>
__global__ void __launch_bounds__(THREADS)
q8_0_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ qs,
                   const __half* __restrict__ d, TY* __restrict__ y,
                   float* __restrict__ parts, int M, int N, int K,
                   int k_split) {
  __shared__ __align__(16) float xs[BK][BM + PAD];   // xs[k][m]
  __shared__ __align__(16) float ws[BK][BN + PAD];   // ws[k][n]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int kb_per_row = K / BK;

  const int tm = tid / 16;      // output rows m0 + tm*4 .. +3
  const int tn = tid % 16;      // output cols n0 + tn*4 .. +3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    if (tid < 128) {
      // Front-end: weight row n0 + tid/2, half (tid%2) of its 32 quants.
      const int nl = tid / 2, h = tid % 2;
      const int n = n0 + nl;
      float w[16];
      if (n < N) {
        q8_0_decode16(qs + (size_t)n * K + k0 + h * 16,
                      d[(size_t)n * kb_per_row + k0 / BK], w);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) ws[h * 16 + j][nl] = w[j];
    } else {
      // Activation tile: row m0 + (tid-128)/2, half of its 32 columns.
      const int ml = (tid - 128) / 2, h = (tid - 128) % 2;
      const int m = m0 + ml;
      const TX* src = x + (size_t)m * K + k0 + h * 16;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        xs[h * 16 + j][ml] = (m < M) ? to_float(src[j]) : 0.f;
    }
    __syncthreads();
    // Back-end: 32 k-steps of the 4 x 4 outer product.
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][tm * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[k][tn * 4]);
      mac_4x4(a, b, acc);
    }
    __syncthreads();
  }

  float* part = gridDim.z > 1 ? parts + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n >= N) continue;
      if (part != nullptr) part[(size_t)m * N + n] = acc[i][j];
      else from_float(acc[i][j], &y[(size_t)m * N + n]);
    }
  }
}

// Second pass of a split-K launch: y = sum over splits, in split order.
template <typename TY>
__global__ void q8_0_splitk_reduce(const float* __restrict__ parts,
                                   TY* __restrict__ y, int splits,
                                   long long mn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += parts[z * mn + i];
  from_float(s, &y[i]);
}

template <typename TX, typename TY>
int launch(const void* x, const int8_t* q, const __half* d, void* y,
           float* parts, int M, int N, int K, int k_split, int splits,
           cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  q8_0_matmul_kernel<TX, TY><<<grid, THREADS, 0, s>>>(
      static_cast<const TX*>(x), q, d, static_cast<TY*>(y), parts, M, N, K,
      k_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const long long mn = (long long)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((mn + threads - 1) / threads);
  q8_0_splitk_reduce<TY><<<blocks, threads, 0, s>>>(
      parts, static_cast<TY*>(y), splits, mn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype / y_dtype: 0 = float32, 1 = bfloat16. With splits > 1,
// `workspace` holds splits * M * N floats; `k_split` is a multiple of 32.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int q8_0_matmul(const void* x, int x_dtype, const void* qs,
                           const void* d, void* y, int y_dtype,
                           void* workspace, int M, int N, int K, int k_split,
                           int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(qs);
  const __half* dd = static_cast<const __half*>(d);
  float* parts = static_cast<float*>(workspace);
  if (x_dtype == 1 && y_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, q, dd, y, parts, M, N, K,
                                                 k_split, splits, s);
  if (x_dtype == 1)
    return launch<__nv_bfloat16, float>(x, q, dd, y, parts, M, N, K, k_split,
                                        splits, s);
  if (y_dtype == 1)
    return launch<float, __nv_bfloat16>(x, q, dd, y, parts, M, N, K, k_split,
                                        splits, s);
  return launch<float, float>(x, q, dd, y, parts, M, N, K, k_split, splits,
                              s);
}
