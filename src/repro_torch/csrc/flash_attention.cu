// Blocked online-softmax attention for Hopper (sm_90a), CUDA C++: the
// prefill / full-sequence attention of the GQA models.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention (Pallas body _kernel), whose XLA twin
// repro/models/attention.py::chunked_attention the models call. It
// computes the same function: f32 scores, f32 running max and sum, an
// f32 accumulator, output acc / l (l == 0 reads as 1) rounded once to
// the input dtype. GQA maps head h to kv-head h / (H / Hkv). Key
// j < Skv is visible to query i iff, when causal, j <= q_offset + i.
// Unlike the Pallas kernel (which halves block_q until it divides Sq and
// pads K/V to the key block), a ragged query or key tile is masked here:
// rows past Sq are never stored and keys past Skv are never loaded.
//
// Layout: the model's (B, S, heads, D) tensors are read in place (no
// transposes around the call); V may have its own width Dv (MLA prefill
// has Dv != D). D and Dv are at most 256.
//
// Two kernels, picked by dtype alone (the wrapper's docstring says so):
//
// bf16 (every prefill and forward of the models; D, Dv multiples of 16):
// the tensor-core kernel, tc::flash_tc_kernel. At prefill sizes the
// flops (~S * Hkv-group per byte) are far above the ridge, so the
// tensor cores bound the function. Design:
//   * a block of 4 warps takes 64 query rows: 64 / G positions of the G
//     heads that share a kv-head (G <= 8; else one head), so every K/V
//     tile feeds all of them; the heaviest causal tiles first; each
//     warp owns 16 rows and keeps their running max, sum and output in
//     registers (a row's 4 lanes reduce with shuffles), and up to D = 128
//     its Q fragments too;
//   * Q once and K/V tiles of 32 keys in a cp.async ring (3 stages and
//     one barrier a tile where three blocks still fit an SM, else 2), in
//     bf16 read straight from the (B, S, heads, D) rows (row stride
//     heads x D) and zero-filled past Skv, past the causal horizon and
//     past D (cp.async src-size 0: nothing is read, and a masked p of 0
//     never meets garbage); rows padded by 16 bytes, so every ldmatrix
//     is conflict-free and every fragment address is a constant offset;
//   * S = Q.K^T with mma.sync m16n8k16 bf16 -> f32 (bf16 products are
//     exact in f32: the scores match the f32 plain version up to
//     summation order), the next fragment loading while the current
//     products run; the online softmax in the log2 domain (ex2);
//   * P.V as two bf16 products on P_hi = bf16(p) and P_lo = bf16(p -
//     P_hi) (exact to ~2^-17 of p; one bf16 P would lose 2^-9 and miss
//     the f32 tolerance), V fragments by ldmatrix.trans; l from the f32
//     p; causal tiles past the diagonal are never loaded.
//   It runs well below the mma.sync rate: each tile's S -> softmax ->
//   P.V chain is serial inside a warp and three warps share an SM
//   sub-partition (registers), so the tensor cores idle through the
//   softmax; wgmma (asynchronous products from shared memory) is the
//   way past that (PERF.md).
//
// f32 (the f32 checks; tensor cores cannot meet the f32 tolerance): the
// CUDA-core kernel, flash_attention_kernel (D and Dv multiples of 4),
// bound by the f32 instruction rate:
//   * one block per (batch, head, 64-query tile); 256 threads, thread
//     (rg, kg) = (tid / 16, tid % 16) owns query rows rg + 16 i and key
//     columns kg + 16 j (i, j < 4) of the 64 x 64 score tile, so each
//     16-byte shared-memory load of q and of k feeds 16 FMAs;
//   * the same thread owns rows rg + 16 i of the output, so the running
//     max, sum and rescale stay in its registers;
//   * Q, K and V tiles are staged in f32 shared memory (rows of Q and K
//     padded by 4 floats: conflict-free 16-byte loads), ~118 KB at
//     D = Dv = 128 (the dynamic shared-memory opt-in);
//   * causal key tiles past the tile's last query are never loaded, the
//     heaviest query tiles are scheduled first, and masked keys never
//     enter P.V (their p is exactly 0 and skipped).
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace repro_torch;

constexpr int THREADS = 256;
constexpr int BQ = 64;                 // query rows of a block
constexpr int BK = 64;                 // keys of a tile
constexpr int PS = BK + 4;             // p tile row stride (floats)

struct Shape {
  int B, Sq, Skv, H, Hkv, D, Dv, q_offset, causal;
  int fold;                            // bf16 kernel: heads of a block
};

// 4 consecutive elements -> f32 (16-byte f32 / 8-byte bf16 loads).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float4 v, float* p) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(float4 v, __nv_bfloat16* p) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// rows x width elements of a (B, S, heads, width) tensor, starting at
// sequence row s0 of (b, head), into f32 shared memory with row stride
// `stride`; rows at or past `valid` are zero-filled (never read).
template <typename T>
__device__ __forceinline__ void stage(float* dst, int stride,
                                      const T* __restrict__ src, int b,
                                      int s0, int S, int heads, int head,
                                      int width, int valid) {
  const int w4 = width / 4;
  for (int idx = threadIdx.x; idx < BQ * w4; idx += THREADS) {
    const int r = idx / w4, c = (idx % w4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + r < valid)
      v = load4(src + (((size_t)b * S + s0 + r) * heads + head) * width + c);
    store4(v, dst + r * stride + c);
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       Shape s, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int D = s.D, Dv = s.Dv;
  const int QS = D + 4;
  float* q_sh = smem;                  // [BQ][D + 4]
  float* k_sh = q_sh + BQ * QS;        // [BK][D + 4]
  float* v_sh = k_sh + BK * QS;        // [BK][Dv]
  float* p_sh = v_sh + BK * Dv;        // [BQ][BK + 4]

  const int nq = gridDim.x;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (s.H / s.Hkv);
  const int tid = threadIdx.x;
  const int rg = tid / 16, kg = tid % 16;

  stage(q_sh, QS, q, b, q0, s.Sq, s.H, h, D, s.Sq);

  // Keys this tile's queries can see: [0, k_hi).
  int k_hi = s.Skv;
  if (s.causal)
    k_hi = min(k_hi, s.q_offset + min(q0 + BQ, s.Sq));
  k_hi = max(k_hi, 0);

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int k0 = 0; k0 < k_hi; k0 += BK) {
    __syncthreads();                   // previous tile's readers are done
    stage(k_sh, QS, k, b, k0, s.Skv, s.Hkv, hk, D, k_hi);
    stage(v_sh, Dv, v, b, k0, s.Skv, s.Hkv, hk, Dv, k_hi);
    __syncthreads();

    // Scores of rows rg + 16 i against keys kg + 16 j.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load4(q_sh + (rg + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = load4(k_sh + (kg + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
    }

    // Online softmax, one row at a time; the 16 threads of a row (one
    // half-warp) reduce with shuffles.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + kg + 16 * j;
        const bool vis = kj < k_hi && (!s.causal || kj <= s.q_offset + qi);
        sc[i][j] = vis ? sc[i][j] * sm_scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = (sc[i][j] == -INFINITY) ? 0.f : expf(sc[i][j] - m_new);
        p_sh[(rg + 16 * i) * PS + kg + 16 * j] = pv;
        sum += pv;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();

    // acc += P . V over the tile's keys; a key with p == 0 (masked, or
    // its exp underflowed) is skipped, so masked V rows never enter.
    const int nk = min(BK, k_hi - k0);
    for (int t0 = 0; t0 < nk; t0 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = load4(p_sh + (rg + 16 * i) * PS + t0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = 4 * kg + 64 * c;
          vv[c] = col < Dv ? load4(v_sh + (t0 + u) * Dv + col)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
          if (p != 0.f) {
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              acc[i][c][0] = fmaf(p, vv[c].x, acc[i][c][0]);
              acc[i][c][1] = fmaf(p, vv[c].y, acc[i][c][1]);
              acc[i][c][2] = fmaf(p, vv[c].z, acc[i][c][2]);
              acc[i][c][3] = fmaf(p, vv[c].w, acc[i][c][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= s.Sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * kg + 64 * c;
      if (col >= Dv) continue;
      const float4 o = make_float4(acc[i][c][0] * inv, acc[i][c][1] * inv,
                                   acc[i][c][2] * inv, acc[i][c][3] * inv);
      store4(o, out + (((size_t)b * s.Sq + qi) * s.H + h) * Dv + col);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, Shape sh,
           float sm_scale, size_t smem, cudaStream_t st) {
  auto kern = flash_attention_kernel<T, NC>;
  if (smem > 48 * 1024) {
    // Opt in to the card's whole per-block limit once per instantiation;
    // the wrapper has already checked smem against that limit.
    static const cudaError_t opt_in = [] {
      int dev = 0, limit = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(flash_attention_kernel<T, NC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 limit);
      return e;
    }();
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  }
  const dim3 grid((sh.Sq + BQ - 1) / BQ, sh.H, sh.B);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sh, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             Shape sh, float sm_scale, size_t smem, cudaStream_t st) {
  if (sh.Dv <= 64) return launch<T, 1>(q, k, v, out, sh, sm_scale, smem, st);
  if (sh.Dv <= 128) return launch<T, 2>(q, k, v, out, sh, sm_scale, smem, st);
  return launch<T, 4>(q, k, v, out, sh, sm_scale, smem, st);
}

// ---------------------------------------------------------------------
// bf16 form: tensor-core products, cp.async staging (see the top note).
// ---------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;

// Staged rows are padded by 8 elements (16 bytes): the 8 rows an
// ldmatrix reads at one column then start in 8 different bank groups,
// and every fragment address is a lane's base plus a constant.
constexpr int PAD = 8;
constexpr int BQ = 16 * WARPS;         // query rows of a block: 16 a warp
constexpr int BK = 32;                 // keys of a staged K/V tile
constexpr int SMEM_SM = 227 * 1024;    // shared memory an SM can give

// Bytes of a block with NS ring stages.
__host__ __device__ constexpr size_t smem_bytes(int DP, int DVP, int NS) {
  return sizeof(bf16) *
         ((size_t)BQ * (DP + PAD) + (size_t)NS * BK * (DP + DVP + 2 * PAD));
}
// Ring stages: 3 (the next-but-one tile loads while this one computes,
// one barrier a tile) where three blocks still share an SM, else 2.
__host__ __device__ constexpr int stages_for(int DP, int DVP) {
  return 3 * (smem_bytes(DP, DVP, 3) + 1024) <= SMEM_SM ? 3 : 2;
}
__host__ __device__ constexpr size_t smem_for(int DP, int DVP) {
  return smem_bytes(DP, DVP, stages_for(DP, DVP));
}

// cp.async of ROWS rows, from sequence row s0 of (b, head), of a
// (B, S, heads, width) bf16 tensor into a [ROWS][W + PAD] tile.
// Rows at or past `valid` and columns past `width` are zero-filled and
// never read (zero columns add nothing to a product).
template <int W, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int b, int s0, int S, int heads,
                                          int head, int width, int valid) {
  constexpr int CPR = W / 8;           // 16-byte chunks per tile row
  const int cw = width / 8;
#pragma unroll
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = s0 + r < valid && c < cw;
    const bf16* g =
        ok ? src + (((size_t)b * S + s0 + r) * heads + head) * width + c * 8
           : src;
    cp_async16(dst + r * (W + PAD) + c * 8, g, ok);
  }
}

// cp.async of a block's Q rows: row r is query position p0 + r / F of
// head h0 + r % F (the F heads of a block share their kv-head); rows
// past BQP * F or Sq, and columns past D, are zero-filled.
template <int DP>
__device__ __forceinline__ void load_q(bf16* dst, const bf16* __restrict__ q,
                                       const Shape& s, int b, int p0,
                                       int h0, int bqp) {
  constexpr int CPR = DP / 8;
  const int cw = s.D / 8, F = s.fold;
#pragma unroll
  for (int i = 0; i < BQ * CPR / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx / CPR, c = idx % CPR;
    const int pp = r / F, gi = r - pp * F;
    const bool ok = pp < bqp && p0 + pp < s.Sq && c < cw;
    const bf16* g =
        ok ? q + (((size_t)b * s.Sq + p0 + pp) * s.H + h0 + gi) * s.D + c * 8
           : q;
    cp_async16(dst + r * (DP + PAD) + c * 8, g, ok);
  }
}

template <int DP, int DVP>
__global__ void __launch_bounds__(THREADS, 3)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, Shape s,
                float sm_scale) {
  constexpr int NS = stages_for(DP, DVP);
  constexpr int NB = BK / 8;           // key n-tiles of a tile
  constexpr int NKD = DP / 16;         // k-steps of S
  constexpr int NVT = DVP / 8;         // output n-tiles
  constexpr int QS = DP + PAD, VS = DVP + PAD;     // row strides
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_sh = reinterpret_cast<bf16*>(smem_raw);  // [BQ][QS]
  bf16* k_sh = q_sh + BQ * QS;                     // [NS][BK][QS]
  bf16* v_sh = k_sh + NS * BK * QS;                // [NS][BK][VS]

  // Block (position tile, head group, batch): BQP query positions of
  // the F = s.fold heads h0 .. h0 + F - 1 that share kv-head hk (GQA:
  // each K/V tile then feeds F heads), row r = position r / F, head
  // r % F; the heaviest causal tiles first.
  const int F = s.fold, bqp = BQ / F;
  const int p0 = (gridDim.x - 1 - (int)blockIdx.x) * bqp;
  const int h0 = blockIdx.y * F, b = blockIdx.z;
  const int hk = h0 / (s.H / s.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;                        // the warp's 16 rows
  // Query positions of this lane's rows r0 + g and r0 + g + 8.
  const int qp[2] = {p0 + (r0 + g) / F, p0 + (r0 + g + 8) / F};

  // Keys this tile's queries can see: [0, k_hi).
  int k_hi = s.Skv;
  if (s.causal) k_hi = min(k_hi, s.q_offset + min(p0 + bqp, s.Sq));
  k_hi = max(k_hi, 0);
  const int ntiles = (k_hi + BK - 1) / BK;

  // Prologue: Q and key tile 0 (one group), key tile 1 (the next);
  // every iteration then commits one group, empty or not.
  load_q<DP>(q_sh, q, s, b, p0, h0, bqp);
  for (int j = 0; j < 2; ++j) {
    if (j < ntiles) {
      load_tile<DP, BK>(k_sh + j * BK * QS, k, b, j * BK, s.Skv, s.Hkv, hk,
                        s.D, k_hi);
      load_tile<DVP, BK>(v_sh + j * BK * VS, v, b, j * BK, s.Skv, s.Hkv,
                         hk, s.Dv, k_hi);
    }
    cp_async_commit();
  }

  // Rows g and g + 8 of the warp's 16 (hh = 0, 1): output, running max
  // m (of scores times sm_scale * log2 e) and this lane's share of the
  // running sum l.
  float o[NVT][4];
#pragma unroll
  for (int i = 0; i < NVT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = sm_scale * 1.4426950408889634f;

  // Shared addresses of this lane's ldmatrix rows (A: rows lane % 16,
  // column half lane / 16; B: rows lane % 8 + 8 (lane / 16), column half
  // lane / 8 % 2; V, transposed: rows lane % 8 + 8 (lane / 8 % 2), column
  // half lane / 16); every fragment adds a constant to these.
  const uint32_t k_lane =
      smem_addr(k_sh) +
      (((lane & 7) + 8 * (lane >> 4)) * QS + 8 * ((lane >> 3) & 1)) * 2;
  const uint32_t v_lane =
      smem_addr(v_sh) +
      (((lane & 7) + 8 * ((lane >> 3) & 1)) * VS + 8 * (lane >> 4)) * 2;
  const uint32_t q_lane =
      smem_addr(q_sh) + ((r0 + (lane & 15)) * QS + 8 * (lane >> 4)) * 2;
  // The warp's Q fragments stay in registers up to DP = 128; wider rows
  // would spill, so they reload from shared memory every tile.
  constexpr bool kQReg = DP <= 128;
  uint32_t qf[kQReg ? NKD : 1][4];

  for (int it = 0; it < ntiles; ++it) {
    const int st = it % NS, k0 = it * BK;
    cp_async_wait<1>();                // tile it has landed (this thread)
    __syncthreads();                   // ... and every thread's copies
    if (kQReg && it == 0) {
#pragma unroll
      for (int kd = 0; kd < (kQReg ? NKD : 0); ++kd)
        ldsm_x4(qf[kd], q_lane + kd * 32);
    }
    if (NS == 3) {                     // stage of tile it - 1 is free
      const int nx = (it + 2) % NS;
      if (it + 2 < ntiles) {
        load_tile<DP, BK>(k_sh + nx * BK * QS, k, b, k0 + 2 * BK, s.Skv,
                          s.Hkv, hk, s.D, k_hi);
        load_tile<DVP, BK>(v_sh + nx * BK * VS, v, b, k0 + 2 * BK, s.Skv,
                           s.Hkv, hk, s.Dv, k_hi);
      }
      cp_async_commit();
    }
    const uint32_t ks = k_lane + st * BK * QS * 2;
    const uint32_t vs = v_lane + st * BK * VS * 2;

    // S = Q . K^T: 16 rows x BK keys per warp, f32; the next K fragment
    // loads while this one's products run. Columns past D are zero in Q
    // and K.
    float sc[NB][4];
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
    {
      constexpr int NP = NB / 2, STEPS = NKD * NP;
      uint32_t kb[2][4], qa[2][4];
#pragma unroll
      for (int i = 0; i <= STEPS; ++i) {
        if (i < STEPS) {               // load step i
          if (!kQReg && i % NP == 0)
            ldsm_x4(qa[(i / NP) & 1], q_lane + (i / NP) * 32);
          ldsm_x4(kb[i & 1],
                  ks + ((i % NP) * 16 * QS + (i / NP) * 16) * 2);
        }
        if (i > 0) {                   // products of step i - 1
          const int j = i - 1, kd = j / NP, np = j % NP;
          const uint32_t* a = kQReg ? qf[kQReg ? kd : 0] : qa[kd & 1];
          mma_bf16(sc[2 * np], a, kb[j & 1][0], kb[j & 1][1]);
          mma_bf16(sc[2 * np + 1], a, kb[j & 1][2], kb[j & 1][3]);
        }
      }
    }

    // Scale into the log2 domain and mask: only a tile on the causal
    // diagonal or the ragged key edge has masked entries (a branch the
    // whole block takes alike). Row r sees this tile's columns
    // c < lim(r) = min(k_hi, q_offset + qi(r) + 1) - k0.
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] *= sl2;
    if (k0 + BK > k_hi || (s.causal && k0 + BK - 1 > s.q_offset + p0)) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        int lim = k_hi - k0 - 2 * t;
        if (s.causal)
          lim = min(lim, s.q_offset + qp[hh] + 1 - k0 - 2 * t);
#pragma unroll
        for (int nt = 0; nt < NB; ++nt) {
          if (nt * 8 >= lim) sc[nt][2 * hh] = -INFINITY;
          if (nt * 8 + 1 >= lim) sc[nt][2 * hh + 1] = -INFINITY;
        }
      }
    }
    // Online softmax: row maxima by a tree, then across the row's quad.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v8[NB];
#pragma unroll
      for (int nt = 0; nt < NB; ++nt)
        v8[nt] = fmaxf(sc[nt][2 * hh], sc[nt][2 * hh + 1]);
#pragma unroll
      for (int w = NB / 2; w > 0; w >>= 1)
#pragma unroll
        for (int i = 0; i < w; ++i) v8[i] = fmaxf(v8[i], v8[i + w]);
      float mx = fmaxf(v8[0], __shfl_xor_sync(0xffffffffu, v8[0], 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = m[hh] == -INFINITY ? 0.f : ex2(m[hh] - m_new);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      m[hh] = m_new;
      if (__any_sync(0xffffffffu, alpha != 1.f)) {     // rows' max moved
#pragma unroll
        for (int i = 0; i < NVT; ++i) {
          o[i][2 * hh] *= alpha;
          o[i][2 * hh + 1] *= alpha;
        }
      }
      float s8[NB];
#pragma unroll
      for (int nt = 0; nt < NB; ++nt) {
        const float p0 = ex2(sc[nt][2 * hh] - mu);       // masked: 0
        const float p1 = ex2(sc[nt][2 * hh + 1] - mu);
        sc[nt][2 * hh] = p0;
        sc[nt][2 * hh + 1] = p1;
        s8[nt] = p0 + p1;
      }
#pragma unroll
      for (int w = NB / 2; w > 0; w >>= 1)
#pragma unroll
        for (int i = 0; i < w; ++i) s8[i] += s8[i + w];
      l[hh] = l[hh] * alpha + s8[0];
    }

    // O += P . V with P = P_hi + P_lo (two bf16 products): exact to
    // ~2^-17 of p, where one bf16 P would lose 2^-9. Each V fragment
    // feeds 4 products; the next fragment loads meanwhile.
    {
      constexpr int NVP = DVP / 16, STEPS = (BK / 16) * NVP;
      uint32_t pp[2][4];               // [lo, hi] of the current 16 keys
      uint32_t vf[2][4];
#pragma unroll
      for (int i = 0; i <= STEPS; ++i) {
        if (i < STEPS)
          ldsm_x4_trans(vf[i & 1],
                        vs + ((i / NVP) * 16 * VS + (i % NVP) * 16) * 2);
        if (i > 0) {
          const int j = i - 1, kk = j / NVP, vp = j % NVP;
          if (vp == 0) {
            split_bf16(sc[2 * kk][0], sc[2 * kk][1], pp[1][0], pp[0][0]);
            split_bf16(sc[2 * kk][2], sc[2 * kk][3], pp[1][1], pp[0][1]);
            split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], pp[1][2],
                       pp[0][2]);
            split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], pp[1][3],
                       pp[0][3]);
          }
#pragma unroll
          for (int part = 0; part < 2; ++part) {
            mma_bf16(o[2 * vp], pp[part], vf[j & 1][0], vf[j & 1][1]);
            mma_bf16(o[2 * vp + 1], pp[part], vf[j & 1][2], vf[j & 1][3]);
          }
        }
      }
    }

    if (NS == 2) {
      __syncthreads();                 // every warp is done with stage st
      if (it + 2 < ntiles) {
        load_tile<DP, BK>(k_sh + st * BK * QS, k, b, k0 + 2 * BK, s.Skv,
                          s.Hkv, hk, s.D, k_hi);
        load_tile<DVP, BK>(v_sh + st * BK * VS, v, b, k0 + 2 * BK, s.Skv,
                           s.Hkv, hk, s.Dv, k_hi);
      }
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  const int nvt = s.Dv / 8;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lr = l[hh];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / (lr == 0.f ? 1.f : lr);
    const int r = r0 + g + 8 * hh;
    if (r >= bqp * F || qp[hh] >= s.Sq) continue;
    bf16* orow =
        out + (((size_t)b * s.Sq + qp[hh]) * s.H + h0 + r % F) * s.Dv + 2 * t;
#pragma unroll
    for (int i = 0; i < NVT; ++i)
      if (i < nvt)
        *reinterpret_cast<__nv_bfloat162*>(orow + i * 8) =
            __floats2bfloat162_rn(o[i][2 * hh] * inv, o[i][2 * hh + 1] * inv);
  }
}

// The (D, Dv) widths instantiated: the smallest that holds D and Dv.
// Every model width is one of them: 64/64 (granite-moe), 128/128
// (qwen3), 192/128 (deepseek-v3's MLA prefill).
struct Widths {
  int dp, dvp;
};
constexpr Widths WIDTHS[] = {{64, 64},   {128, 64},  {128, 128}, {192, 128},
                             {192, 192}, {256, 128}, {256, 256}};

Widths pick(int D, int Dv) {
  for (const Widths& w : WIDTHS)
    if (D <= w.dp && Dv <= w.dvp) return w;
  return Widths{0, 0};
}

template <int DP, int DVP>
int launch(const void* q, const void* k, const void* v, void* out, Shape sh,
           float sm_scale, cudaStream_t st) {
  constexpr size_t smem = smem_for(DP, DVP);
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_tc_kernel<DP, DVP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int bqp = BQ / sh.fold;
  const dim3 grid((sh.Sq + bqp - 1) / bqp, sh.H / sh.fold, sh.B);
  flash_tc_kernel<DP, DVP><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), sh, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* out,
             Shape sh, float sm_scale, cudaStream_t st) {
  const Widths w = pick(sh.D, sh.Dv);
#define REPRO_FLASH_TC(DP, DVP)                                  \
  if (w.dp == DP && w.dvp == DVP)                                \
    return launch<DP, DVP>(q, k, v, out, sh, sm_scale, st)
  REPRO_FLASH_TC(64, 64);
  REPRO_FLASH_TC(128, 64);
  REPRO_FLASH_TC(128, 128);
  REPRO_FLASH_TC(192, 128);
  REPRO_FLASH_TC(192, 192);
  REPRO_FLASH_TC(256, 128);
  REPRO_FLASH_TC(256, 256);
#undef REPRO_FLASH_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

// Shared-memory bytes one block needs (the wrapper checks it against the
// card's limit before launching): the bf16 tensor-core kernel's
// (tensor_cores = 1; 0 if D, Dv have no instantiation) or the CUDA-core
// kernel's.
extern "C" long long flash_attention_smem(int tensor_cores, int D, int Dv) {
  if (tensor_cores) {
    const tc::Widths w = tc::pick(D, Dv);
    return w.dp ? (long long)tc::smem_for(w.dp, w.dvp) : 0;
  }
  return 4LL * (2LL * 64 * (D + 4) + 64LL * Dv + 64LL * (64 + 4));
}

// The CUDA-core kernel at either dtype (q, k, v and out alike; D, Dv
// multiples of 4): the wrapper's f32 route, and at bf16 the earlier
// design that chip_smoke.py times the tensor-core kernel against (no
// model path calls it).
extern "C" int flash_attention_cuda_cores(const void* q, const void* k,
                                          const void* v, void* out,
                                          int dtype, int B, int Sq, int Skv,
                                          int H, int Hkv, int D, int Dv,
                                          int q_offset, int causal,
                                          float sm_scale, void* stream) {
  const Shape sh{B, Sq, Skv, H, Hkv, D, Dv, q_offset, causal, 1};
  const size_t smem = (size_t)flash_attention_smem(0, D, Dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, sh, sm_scale, smem, st);
  return dispatch<float>(q, k, v, out, sh, sm_scale, smem, st);
}

// The tensor-core kernel: dtype must be 1 = bfloat16 (q, k, v and out
// alike; the wrapper sends f32 to flash_attention_cuda_cores). q is
// (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv), out
// (B, Sq, H, Dv), all contiguous and 16-byte aligned; D, Dv multiples of
// 16, at most 256. Returns the cudaError_t of the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int dtype, int B, int Sq, int Skv,
                               int H, int Hkv, int D, int Dv, int q_offset,
                               int causal, float sm_scale, void* stream) {
  if (dtype != 1 || D % 16 || Dv % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // A block takes all G = H / Hkv heads of a kv-head while G <= 8 (at
  // least 8 query positions a block), else one head.
  const int G = H / Hkv;
  const Shape sh{B, Sq, Skv, H, Hkv, D, Dv, q_offset, causal, G <= 8 ? G : 1};
  return tc::dispatch(q, k, v, out, sh, sm_scale,
                      static_cast<cudaStream_t>(stream));
}
