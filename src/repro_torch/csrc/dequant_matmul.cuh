// The tile loop shared by the port's fused dequant-matmul kernels
// (q8_0, fp16, q6_k, q3_k): the counterpart of the grid and BlockSpec
// plumbing every repro/kernels/*_matmul.py repeats around common.py.
//
// Computes y(M, N) = x(M, K) . dequant(planes)(N, K)^T with f32
// accumulation; x is f32 or bf16; y is f32, or bf16 rounded once from
// the f32 result (what the model layers cast it to anyway, without a
// second pass). Any M and N: the ragged edges are masked, nothing is
// padded or copied.
//
// What bounds it on the card: on the serving path M = slots x chunk is
// small (64), so a call streams the weight planes once -- between 0.45
// (q3_k) and 2 (fp16) bytes per weight against 2 * M flops per weight.
// At M = 64 that is 64 to 285 flops per byte: near or above the bf16
// tensor-core ridge (~295) only for q3_k, and far above the f32
// CUDA-core ridge (~20). These kernels run their MACs on the CUDA cores
// in f32, so at full width they are bound by f32 FMA issue, not by the
// weight stream; the tensor-core (mma/wgmma) back-end that reaches the
// byte bound is later work.
//
// Design (one template over the format's front-end):
//   * one 64 x 64 output tile per block of 256 threads, each thread a
//     4 x 4 register tile (the back-end, common.cuh mac_4x4);
//   * K walks in steps of 32 (two 16-element sub-blocks): threads 0-127
//     decode one sub-block of one weight row each (the format's
//     front-end, Fmt::decode16, straight from the packed planes into
//     registers) and stage the dense f32 tile in shared memory; threads
//     128-255 stage the x tile as f32 beside it;
//   * small N leaves most SMs idle, so the wrapper may split K across
//     gridDim.z in multiples of 32; each split writes its partial tile
//     to a workspace and a second pass sums the splits in a fixed order
//     (no atomics, so a result never varies from run to run). Each
//     sub-block reads its scales by absolute K index, so a split need
//     not align with a 256-element super-block.
//
// A format supplies
//   struct Fmt {
//     static constexpr bool kRaggedK;   // K need not be a multiple of 32
//     __device__ void decode16(int n, int k, int K, float w[16]) const;
//   };
// where decode16 writes row n's weights k .. k+15 (k % 16 == 0, k < K),
// zero past K, bit-identical to the format's dequantizer.
#pragma once

#include "common.cuh"

namespace repro_torch {
namespace dequant_matmul {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;          // two 16-element sub-blocks
constexpr int THREADS = 256;
constexpr int PAD = 4;          // keeps rows 16-byte aligned for float4

// Writes TY (the final dtype) when the grid has one split, f32 partials
// into the workspace otherwise.
template <typename Fmt, typename TX, typename TY>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const Fmt fmt, const TX* __restrict__ x, TY* __restrict__ y,
            float* __restrict__ parts, int M, int N, int K, int k_split) {
  __shared__ __align__(16) float xs[BK][BM + PAD];   // xs[k][m]
  __shared__ __align__(16) float ws[BK][BN + PAD];   // ws[k][n]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);

  const int tm = tid / 16;      // output rows m0 + tm*4 .. +3
  const int tn = tid % 16;      // output cols n0 + tn*4 .. +3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    if (tid < 128) {
      // Front-end: weight row n0 + tid/2, sub-block (tid%2) of this step.
      const int nl = tid / 2, h = tid % 2;
      const int n = n0 + nl;
      const int k = k0 + h * 16;
      float w[16];
      if (n < N && (!Fmt::kRaggedK || k < K)) {
        fmt.decode16(n, k, K, w);
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
      const int k = k0 + h * 16;
      const TX* src = x + (size_t)m * K + k;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        xs[h * 16 + j][ml] = (m < M && (!Fmt::kRaggedK || k + j < K))
                                 ? to_float(src[j]) : 0.f;
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
__global__ void splitk_reduce(const float* __restrict__ parts,
                              TY* __restrict__ y, int splits, long long mn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += parts[z * mn + i];
  from_float(s, &y[i]);
}

template <typename Fmt, typename TX, typename TY>
int launch_typed(const Fmt& fmt, const void* x, void* y, float* parts, int M,
                 int N, int K, int k_split, int splits, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  tile_kernel<Fmt, TX, TY><<<grid, THREADS, 0, s>>>(
      fmt, static_cast<const TX*>(x), static_cast<TY*>(y), parts, M, N, K,
      k_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  const long long mn = (long long)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((mn + threads - 1) / threads);
  splitk_reduce<TY><<<blocks, threads, 0, s>>>(parts, static_cast<TY*>(y),
                                               splits, mn);
  return static_cast<int>(cudaGetLastError());
}

// x_dtype / y_dtype: 0 = float32, 1 = bfloat16. With splits > 1,
// `workspace` holds splits * M * N floats; `k_split` is a multiple of 32.
// Returns the cudaError_t of the launches (0 = success).
template <typename Fmt>
int launch(const Fmt& fmt, const void* x, int x_dtype, void* y, int y_dtype,
           void* workspace, int M, int N, int K, int k_split, int splits,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* parts = static_cast<float*>(workspace);
  if (x_dtype == 1 && y_dtype == 1)
    return launch_typed<Fmt, __nv_bfloat16, __nv_bfloat16>(
        fmt, x, y, parts, M, N, K, k_split, splits, s);
  if (x_dtype == 1)
    return launch_typed<Fmt, __nv_bfloat16, float>(fmt, x, y, parts, M, N, K,
                                                   k_split, splits, s);
  if (y_dtype == 1)
    return launch_typed<Fmt, float, __nv_bfloat16>(fmt, x, y, parts, M, N, K,
                                                   k_split, splits, s);
  return launch_typed<Fmt, float, float>(fmt, x, y, parts, M, N, K, k_split,
                                         splits, s);
}

}  // namespace dequant_matmul
}  // namespace repro_torch
