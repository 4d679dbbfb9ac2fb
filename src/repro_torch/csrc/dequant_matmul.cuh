// The tile loop shared by the port's fused dequant-matmul kernels
// (q8_0, fp16, q6_k, q3_k): the counterpart of the grid and BlockSpec
// plumbing every repro/kernels/*_matmul.py repeats around common.py.
//
// Computes y(M, N) = x(M, K) . dequant(planes)(N, K)^T with f32
// accumulation; x is bf16 (every model layer) or f32 (the f32 checks);
// y is f32, or bf16 rounded once from the f32 result (what the model
// layers cast it to anyway, without a second pass). Any M and N: the
// ragged edges are masked, nothing is padded or copied. x's dtype alone
// picks the back-end.
//
// What bounds it on the card: on the serving path M = slots x chunk is
// small (64), so a call streams the weight planes once -- between 0.45
// (q3_k) and 2 (fp16) bytes per weight against 2 * M flops per weight,
// under the bf16 tensor-core ridge (~295 flops per byte): the weight
// stream and the launches bound it. At prefill (M = 4,096) the tensor
// cores do.
//
// bf16 x: the tensor-core kernel (namespace tc), warp-specialised:
//   * a producer warpgroup fills a 4-stage ring of 64-wide K steps: one
//     thread loads the x tile (BM x 64 bf16) by TMA; all 128 decode the
//     weight tile (BN rows x 64) from the packed planes -- loaded into
//     registers a step ahead -- into its integer codes as bf16 (exact),
//     written in the 128-byte swizzle wgmma reads, and each 16-element
//     sub-block's f32 scale beside them (the format's front-end,
//     Fmt::codes and Fmt::scale); a full mbarrier per stage takes the TMA
//     bytes and the 128 arrivals, an empty one the consumers' releases;
//   * BM / 64 consumer warpgroups, each 64 rows of x against the BN
//     weight rows: per scale group (16 elements; q8_0 32; fp16 the whole
//     step) one wgmma m64nBNk16 chain into a fresh f32 fragment, then
//     acc += scale[n] * fragment on the CUDA cores (fp16: acc +=
//     fragment of hi and lo). A code times a bf16 x is exact in f32, so
//     the result differs from the plain version's (which rounds code *
//     scale once, then dots) only in summation order and that rounding,
//     and the tensor cores never sum more than 128 products;
//   * tiles 64 x 64 (one consumer) where M <= 64, else 128 x 128 (two);
//   * where the x rows are not 16-byte aligned (K % 8 != 0) the producer
//     stages x with plain loads instead of TMA.
//
// f32 x: the CUDA-core kernel, 64 x 64 f32 tiles, each thread a 4 x 4
// register tile (common.cuh mac_4x4), K in steps of 32 with the weights
// decoded to code * scale in f32 -- bit-identical to the format's
// dequantizer -- in shared memory.
//
// Both: small N leaves most SMs idle, so the wrapper may split K across
// gridDim.z in whole K steps (kernels/_dequant_matmul.py plan()), and the
// splits are summed in split order (no atomics: a result never varies
// from run to run, and the f32 and bf16 outputs come from one
// accumulation order). The tensor-core kernel launches a tile's splits
// (at most 8) as one thread-block cluster: each block leaves its partial
// tile in its own shared memory and block 0 reads them all over
// distributed shared memory, so there is no second launch; the CUDA-core
// kernel writes partials to a workspace and a second pass sums them. Each
// sub-block reads its scales by absolute K index, so a split need not
// align with a 256-element super-block.
//
// A format supplies
//   struct Fmt {
//     static constexpr bool kRaggedK;   // K need not be a multiple of 32
//     static constexpr int kScaleK;     // elements per scale (0: none)
//     static constexpr int kParts;      // bf16 code tiles (fp16: hi, lo)
//     struct Raw;                       // a sub-block's packed bits
//     __device__ Raw load(int n, int k, int K) const;
//     __device__ void codes(const Raw&, uint32_t c[kParts][8]) const;
//     __device__ float scale(const Raw&) const;   // if kScaleK
//   };
// for row n's elements k .. k+15 (k % 16 == 0, k < K), zero past K.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace dequant_matmul {

// Row n's weights k .. k+15 in f32: code * scale (fp16: hi + lo), what
// the format's dequantizer gives, bit for bit.
template <typename Fmt>
__device__ __forceinline__ void decode16(const Fmt& fmt, int n, int k, int K,
                                         float w[16]) {
  const typename Fmt::Raw raw = fmt.load(n, k, K);
  uint32_t c[Fmt::kParts][8];
  fmt.codes(raw, c);
  float s = 1.f;
  if constexpr (Fmt::kScaleK != 0) s = fmt.scale(raw);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float v = bf16_at(c[0], j);
    if constexpr (Fmt::kParts == 2) v += bf16_at(c[1], j);
    w[j] = Fmt::kScaleK != 0 ? v * s : v;
  }
}

template <typename TY>
__device__ __forceinline__ void store_out(float v, TY* y, float* part,
                                          size_t i) {
  if (part != nullptr) part[i] = v;
  else from_float(v, &y[i]);
}

// ---------------------------------------------------------------------
// f32 x: the CUDA-core kernel.
// ---------------------------------------------------------------------
namespace cc {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;          // two 16-element sub-blocks
constexpr int THREADS = 256;
constexpr int PAD = 4;          // keeps rows 16-byte aligned for float4

// Writes TY (the final dtype) when the grid has one split, f32 partials
// into the workspace otherwise.
template <typename Fmt, typename TY>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const Fmt fmt, const float* __restrict__ x, TY* __restrict__ y,
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
        decode16(fmt, n, k, K, w);
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
      const float* src = x + (size_t)m * K + k;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        xs[h * 16 + j][ml] =
            (m < M && (!Fmt::kRaggedK || k + j < K)) ? src[j] : 0.f;
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
      if (n < N) store_out(acc[i][j], y, part, (size_t)m * N + n);
    }
  }
}

template <typename Fmt, typename TY>
int launch(const Fmt& fmt, const void* x, void* y, float* parts, int M,
           int N, int K, int k_split, int splits, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  tile_kernel<Fmt, TY><<<grid, THREADS, 0, s>>>(
      fmt, static_cast<const float*>(x), static_cast<TY*>(y), parts, M, N, K,
      k_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cc

// ---------------------------------------------------------------------
// bf16 x: the tensor-core kernel (see the top note).
// ---------------------------------------------------------------------
namespace tc {

using namespace repro_torch::hopper;

constexpr int BK = 64;          // K step: four 16-element sub-blocks
constexpr int STAGES = 4;

template <typename Fmt, int BM, int BN>
struct Layout {
  static constexpr int X = BM * 128;                       // x tile
  static constexpr int W = Fmt::kParts * BN * 128;         // code tiles
  static constexpr int S = Fmt::kScaleK != 0 ? 4 * BN * 4 : 0;  // scales
  static constexpr int STAGE = X + W + S;                  // 1024-aligned
  static constexpr size_t SMEM = STAGES * STAGE + 16 * STAGES + 1024;
};

template <int BN>
__device__ __forceinline__ void product(float (&d)[BN / 2], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (BN == 128)
    wgmma_ss_n128(d, da, db, scale_d);
  else
    wgmma_ss_n64(d, da, db, scale_d);
}

template <typename Fmt, typename TY, int BM, int BN>
__global__ void __launch_bounds__(128 * (BM / 64 + 1), BM == 64 ? 2 : 1)
tc_kernel(const __grid_constant__ CUtensorMap xmap, const Fmt fmt,
          const __nv_bfloat16* __restrict__ x, int x_tma, TY* __restrict__ y,
          int M, int N, int K, int k_split) {
  using L = Layout<Fmt, BM, BN>;
  constexpr int NC = BM / 64;                    // consumer warpgroups
  constexpr int PARTS = Fmt::kParts;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * L::STAGE);
  uint64_t* empty = full + STAGES;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int nst = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int wgi = warpgroup_index(), tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 129);        // thread 0's TMA arrival + 128
      mbar_init(&empty[i], 4 * NC);    // one per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wgi == 0) {
    // Producer. Thread tid decodes SUBS sub-blocks of weight row n per
    // step; the planes of step it + 1 load while step it decodes. With two
    // consumers it gives registers to them (their accumulator and
    // fragment take 128 of the 168 a thread has at launch).
    if constexpr (NC == 2) setmaxnreg_dec<120>();
    constexpr int TPR = 128 / BN;                // threads per weight row
    constexpr int SUBS = 4 / TPR;
    const int nl = tid / TPR, j0 = (tid % TPR) * SUBS, n = n0 + nl;
    using Raw = typename Fmt::Raw;
    Raw cur[SUBS], nxt[SUBS];
    auto fetch = [&](Raw (&r)[SUBS], int k0) {
#pragma unroll
      for (int u = 0; u < SUBS; ++u) {
        const int k = k0 + 16 * (j0 + u);
        r[u] = n < N && k < K ? fmt.load(n, k, K) : Raw{};
      }
    };
    if (nst > 0) fetch(cur, k_begin);
    for (int it = 0; it < nst; ++it) {
      const int st = it % STAGES, k0 = k_begin + it * BK;
      if (it + 1 < nst) fetch(nxt, k0 + BK);
      mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
      unsigned char* stage = smem + st * L::STAGE;
      if (tid == 0) {
        if (x_tma) {
          mbar_arrive_tx(&full[st], L::X);
          tma_load_2d(stage, &xmap, &full[st], k0, m0);
        } else {
          mbar_arrive(&full[st]);
        }
      }
      if (!x_tma) {                    // x rows not 16-byte aligned
        for (int i = tid; i < BM * 32; i += 128) {
          const int r = i / 32, c = 2 * (i % 32), m = m0 + r, k = k0 + c;
          const __nv_bfloat16 z = __float2bfloat16(0.f);
          const __nv_bfloat16* src = x + (size_t)m * K + k;
          const __nv_bfloat16 a = m < M && k < K ? src[0] : z;
          const __nv_bfloat16 b = m < M && k + 1 < K ? src[1] : z;
          *reinterpret_cast<uint32_t*>(stage + sw128(r, c / 8) + (c % 8) * 2) =
              pack_bf16(a, b);
        }
      }
#pragma unroll
      for (int u = 0; u < SUBS; ++u) {
        const int j = j0 + u, k = k0 + 16 * j;
        const bool ok = n < N && k < K;
        uint32_t c[PARTS][8];
        if (ok) {
          fmt.codes(cur[u], c);
        } else {
#pragma unroll
          for (int p = 0; p < PARTS; ++p)
#pragma unroll
            for (int e = 0; e < 8; ++e) c[p][e] = 0u;
        }
#pragma unroll
        for (int p = 0; p < PARTS; ++p)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint4*>(stage + L::X + p * BN * 128 +
                                      sw128(nl, 2 * j + h)) =
                make_uint4(c[p][4 * h], c[p][4 * h + 1], c[p][4 * h + 2],
                           c[p][4 * h + 3]);
        if constexpr (Fmt::kScaleK != 0)
          reinterpret_cast<float*>(stage + L::X + L::W)[j * BN + nl] =
              ok ? fmt.scale(cur[u]) : 0.f;
      }
      fence_proxy_async();
      mbar_arrive(&full[st]);
#pragma unroll
      for (int u = 0; u < SUBS; ++u) cur[u] = nxt[u];
    }
    return;
  }

  // Consumer warpgroup cw: x rows m0 + 64 cw .. + 63 against the tile's
  // BN weight rows. A warpgroup whose rows all lie past M only releases
  // the stages.
  if constexpr (NC == 2) setmaxnreg_inc<192>();
  const int cw = wgi - 1;
  const bool active = m0 + 64 * cw < M;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[BN / 2], frag[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = frag[i] = 0.f;
  // Scale groups of a step and their k16 products.
  constexpr int GK = Fmt::kScaleK != 0 ? Fmt::kScaleK / 16 : 4;
  for (int it = 0; it < nst; ++it) {
    const int st = it % STAGES;
    mbar_wait(&full[st], (it / STAGES) & 1);
    if (active) {
      unsigned char* stage = smem + st * L::STAGE;
      const uint32_t xa = smem_addr(stage) + cw * 64 * 128;
      const uint32_t wa = smem_addr(stage + L::X);
#pragma unroll
      for (int j = 0; j < 4; j += GK) {
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < GK; ++u)
#pragma unroll
          for (int p = 0; p < PARTS; ++p)
            product<BN>(frag, desc(xa + (j + u) * 32, 16, 1024),
                        desc(wa + p * BN * 128 + (j + u) * 32, 16, 1024),
                        u + p > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(frag);
        if constexpr (Fmt::kScaleK != 0) {
          const float* sc =
              reinterpret_cast<const float*>(stage + L::X + L::W) + j * BN;
#pragma unroll
          for (int i = 0; i < BN / 8; ++i) {
            const float2 s2 =
                *reinterpret_cast<const float2*>(sc + 8 * i + 2 * t);
            acc[4 * i] = fmaf(s2.x, frag[4 * i], acc[4 * i]);
            acc[4 * i + 1] = fmaf(s2.y, frag[4 * i + 1], acc[4 * i + 1]);
            acc[4 * i + 2] = fmaf(s2.x, frag[4 * i + 2], acc[4 * i + 2]);
            acc[4 * i + 3] = fmaf(s2.y, frag[4 * i + 3], acc[4 * i + 3]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += frag[i];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  const int mr = 64 * cw + 16 * warp + g;        // the tile's rows mr, +8
  if (gridDim.z == 1) {
    if (!active) return;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + mr + (e / 2) * 8, n = n0 + 8 * i + 2 * t + e % 2;
        if (m < M && n < N) from_float(acc[4 * i + e], &y[(size_t)m * N + n]);
      }
    return;
  }

  // Split K: the splits of this tile are one cluster. Each block leaves
  // its partial tile (BM x BN f32, row-major) in its own shared memory,
  // where the ring was; then block r of the cluster sums slice r of the
  // tile over distributed shared memory, every split's four values loaded
  // before they are added in split order -- the order of the two-pass
  // reduction, with no atomics -- and stores it.
  named_bar_sync(1, 128 * NC);         // every consumer is done with the ring
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(mr + (e / 2) * 8) * BN + 8 * i + 2 * t + e % 2] = acc[4 * i + e];
  cluster_sync();
  const int splits = gridDim.z, per = BM * BN / 4 / splits + 1;
  const uint32_t base = smem_addr(part);
  const int q_end = min(BM * BN / 4, per * (int)(cluster_rank() + 1));
  for (int q = per * cluster_rank() + threadIdx.x - 128; q < q_end;
       q += 128 * NC) {
    float4 v[8];
#pragma unroll
    for (int z = 0; z < 8; ++z)
      if (z < splits) v[z] = ld_cluster_f32x4(base + 16 * q, z);
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int z = 0; z < 8; ++z)
      if (z < splits) {
        sum[0] += v[z].x;
        sum[1] += v[z].y;
        sum[2] += v[z].z;
        sum[3] += v[z].w;
      }
    const int m = m0 + 4 * q / BN, n = n0 + 4 * q % BN;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (m < M && n + e < N) from_float(sum[e], &y[(size_t)m * N + n + e]);
  }
  cluster_sync();                      // peers keep their partials till then
}

template <typename Fmt, typename TY, int BM, int BN>
int launch(const Fmt& fmt, const void* x, void* y, int M, int N, int K,
           int k_split, int splits, cudaStream_t s) {
  using L = Layout<Fmt, BM, BN>;
  static_assert(BM * BN * 4 <= STAGES * L::STAGE, "partial tile > ring");
  auto kern = tc_kernel<Fmt, TY, BM, BN>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  // x by TMA where its rows are 16-byte aligned: (K, M) in boxes of
  // {64, BM}, zeros past either edge.
  CUtensorMap xmap{};
  const int x_tma =
      K > 0 && K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (x_tma) {
    const uint64_t dims[2] = {(uint64_t)K, (uint64_t)M};
    const uint64_t strides[1] = {(uint64_t)K * 2};
    const uint32_t box[2] = {(uint32_t)BK, (uint32_t)BM};
    const int err = make_map_bf16(&xmap, x, 2, dims, strides, box);
    if (err) return err;
  }
  // The splits of a tile form one cluster (at most 8 blocks).
  if (splits > 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  cfg.blockDim = dim3(128 * (BM / 64 + 1));
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, xmap, fmt, static_cast<const __nv_bfloat16*>(x), x_tma,
      static_cast<TY*>(y), M, N, K, k_split);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace tc

// Second pass of a CUDA-core split-K launch: y = sum over splits, in
// split order.
template <typename TY>
__global__ void splitk_reduce(const float* __restrict__ parts,
                              TY* __restrict__ y, int splits, long long mn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += parts[z * mn + i];
  from_float(s, &y[i]);
}

template <typename Fmt, typename TY>
int launch_typed(const Fmt& fmt, const void* x, bool bf16_x, void* y,
                 float* parts, int M, int N, int K, int tile, int k_split,
                 int splits, cudaStream_t s) {
  if (bf16_x && tile == 64)
    return tc::launch<Fmt, TY, 64, 64>(fmt, x, y, M, N, K, k_split, splits,
                                       s);
  if (bf16_x)
    return tc::launch<Fmt, TY, 128, 128>(fmt, x, y, M, N, K, k_split, splits,
                                         s);
  const int err =
      cc::launch<Fmt, TY>(fmt, x, y, parts, M, N, K, k_split, splits, s);
  if (err != 0 || splits <= 1) return err;
  const long long mn = (long long)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((mn + threads - 1) / threads);
  splitk_reduce<TY><<<blocks, threads, 0, s>>>(parts, static_cast<TY*>(y),
                                               splits, mn);
  return static_cast<int>(cudaGetLastError());
}

// x_dtype / y_dtype: 0 = float32, 1 = bfloat16. bf16 x runs the
// tensor-core kernel with tile x tile output tiles (64 or 128), K steps
// of 64 and at most 8 splits (one cluster a tile); f32 x the CUDA-core
// kernel (tile 64, K steps of 32), whose splits > 1 need `workspace` of
// splits * M * N floats for the second pass. `k_split` is a multiple of
// the K step. Returns the cudaError_t of the launches (0 = success).
template <typename Fmt>
int launch(const Fmt& fmt, const void* x, int x_dtype, void* y, int y_dtype,
           void* workspace, int M, int N, int K, int tile, int k_split,
           int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* parts = static_cast<float*>(workspace);
  if ((x_dtype == 1 && tile != 64 && tile != 128) ||
      (x_dtype == 0 && tile != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (y_dtype == 1)
    return launch_typed<Fmt, __nv_bfloat16>(fmt, x, x_dtype == 1, y, parts,
                                            M, N, K, tile, k_split, splits, s);
  return launch_typed<Fmt, float>(fmt, x, x_dtype == 1, y, parts, M, N, K,
                                  tile, k_split, splits, s);
}

}  // namespace dequant_matmul
}  // namespace repro_torch
