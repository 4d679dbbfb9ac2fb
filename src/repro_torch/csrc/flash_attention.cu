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
// the wgmma kernel, wg::flash_wgmma_kernel. At prefill sizes the flops
// (~S * Hkv-group per byte) are far above the ridge, so the tensor cores
// -- and the softmax's exponentials between their products -- bound it.
// Design:
//   * persistent: one block per SM walks work items (item_at: rounds of
//     gridDim.x items, zig-zag); an item is 128 query rows, 128 / G
//     positions of the G heads that share a kv-head (G <= 8; else one
//     head), so every K/V tile feeds all of them; items are numbered head
//     group by head group (heaviest causal tiles first within one), so
//     the items that read one K/V run at about the same time and find it
//     in L2;
//   * a producer warp (setmaxnreg: 24 registers) loads the item's Q by
//     TMA -- the (B, S, heads, D) tensor described in place as a 5-D map,
//     so the box is the item's rows in order -- and K/V tiles of 128 keys
//     (64 at D or Dv > 128) into a 2- or 3-stage ring, in the 128-byte
//     swizzle wgmma reads; mbarriers carry the TMA bytes and the
//     consumers' releases; Q is released when the item's last S product
//     has read it, so the next item's Q loads under this one's P.V;
//   * two consumer warpgroups (240 registers) of 64 rows each: S = Q.K^T
//     with wgmma m64nBKk16 from shared memory (bf16 products are exact
//     in f32: the scores match the f32 plain version up to summation
//     order), the online softmax on the accumulator in registers in the
//     log2 domain (ex2), and O += P.V with the register-A form of wgmma
//     (m64n128k16), V read transposed from shared memory (no transpose
//     anywhere), P as P_hi = bf16(p) and P_lo = bf16(p - P_hi) (exact to
//     ~2^-17 of p; one bf16 P would lose 2^-9 and miss the f32
//     tolerance);
//   * FA3's overlaps: within a warpgroup, S of tile j and P.V of tile
//     j - 1 are issued together and the softmax of tile j runs while that
//     P.V is on the tensor cores (wait_group 1), O is rescaled after it;
//     across the two warpgroups, named barriers make them take turns to
//     issue, so one's softmax runs under the other's products. Nothing is
//     in flight across loop iterations (ptxas would serialize every
//     wgmma);
//   * keys past Skv arrive as zeros (TMA) and are masked; causal tiles
//     past the diagonal are never loaded; in an item's last tile V rows
//     past its horizon are zeroed before P.V, so NaN there cannot meet a
//     masked p of 0.
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
#include "hopper.cuh"

namespace {

using namespace repro_torch;

constexpr int THREADS = 256;
constexpr int BQ = 64;                 // query rows of a block
constexpr int BK = 64;                 // keys of a tile
constexpr int PS = BK + 4;             // p tile row stride (floats)

struct Shape {
  int B, Sq, Skv, H, Hkv, D, Dv, q_offset, causal;
  int fold;                            // bf16 kernel: heads of an item
};

// 4 consecutive floats (16-byte loads and stores).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float4 v, float* p) {
  *reinterpret_cast<float4*>(p) = v;
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
// bf16 form: wgmma products, TMA staging, a producer warp (see the top
// note).
// ---------------------------------------------------------------------
namespace wg {


using bf16 = __nv_bfloat16;
using namespace repro_torch::hopper;

constexpr int BQ = 128;                // query rows of a block
constexpr int THREADS = 384;           // producer warpgroup + 2 consumers
constexpr int SMEM_SM = 227 * 1024;

__host__ __device__ constexpr bool fits(int DP, int DVP, int BK, int NS) {
  return BQ * DP * 2 + NS * BK * (DP + DVP) * 2 + 2048 <= SMEM_SM;
}

template <int DP, int DVP>
struct Layout {
  // Keys of a K/V tile: 128 where Q and a 2-stage ring of them fit the
  // SM, else 64; a third stage where it fits too.
  static constexpr int BK = fits(DP, DVP, 128, 2) ? 128 : 64;
  static constexpr int NS = fits(DP, DVP, BK, 3) ? 3 : 2;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int K_BYTES = BK * DP * 2;
  static constexpr int V_BYTES = BK * DVP * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + NS * K_BYTES;
  static constexpr int BAR_OFF = V_OFF + NS * V_BYTES;
  // q_full, q_empty, k_full[NS], v_full[NS], empty[NS]; 1024 bytes of
  // alignment.
  static constexpr size_t SMEM = BAR_OFF + 8 * (2 + 3 * NS) + 1024;
};

template <int BK>
__device__ __forceinline__ void qk_product(float (&s)[BK / 2], uint64_t dq,
                                           uint64_t dk, int scale_d) {
  if constexpr (BK == 128)
    wgmma_ss_n128(s, dq, dk, scale_d);
  else
    wgmma_ss_n64(s, dq, dk, scale_d);
}

// One work item: BQ / F query positions of the F heads of a head group
// in one batch row. Items are numbered head group by head group, so the
// items that read one K/V run close together in time and find it in L2;
// within a head group the heaviest causal tiles come first.
struct Item {
  int p0, hg, b, hk, k_hi, ntiles;
};

template <int BK>
__device__ __forceinline__ Item item_of(const Shape& s, int w) {
  const int F = s.fold, bqp = BQ / F, hgs = s.H / F;
  const int npt = (s.Sq + bqp - 1) / bqp;
  const int r = w / npt, t = w % npt;
  Item it;
  it.p0 = (npt - 1 - t) * bqp;
  it.hg = r % hgs;
  it.b = r / hgs;
  it.hk = it.hg * F / (s.H / s.Hkv);
  int k_hi = s.Skv;                    // keys the item's rows can see
  if (s.causal) k_hi = min(k_hi, s.q_offset + min(it.p0 + bqp, s.Sq));
  it.k_hi = max(k_hi, 0);
  it.ntiles = (it.k_hi + BK - 1) / BK;
  return it;
}

// Item of round k of this block: rounds of gridDim.x items, taken in
// ascending block order in even rounds and descending in odd ones, so the
// heavy and light causal tiles even out across blocks.
__device__ __forceinline__ int item_at(int k) {
  const int n = gridDim.x, x = blockIdx.x;
  return k * n + (k & 1 ? n - 1 - x : x);
}

template <int DP, int DVP>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ out, Shape s, float sm_scale,
                   int items) {
  using L = Layout<DP, DVP>;
  constexpr int BK = L::BK, NS = L::NS;
  constexpr int NQC = DP / 64, NVC = DVP / 64;     // 64-column tiles
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* q_sh = smem;                      // [NQC][BQ][64]
  unsigned char* k_sh = smem + L::K_OFF;           // [NS][NQC][BK][64]
  unsigned char* v_sh = smem + L::V_OFF;           // [NS][NVC][BK][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* v_full = bars + 2 + NS;
  uint64_t* empty = bars + 2 + 2 * NS;

  // Rows r = position r / F, head r % F of the F heads that share a
  // kv-head; rows past F * bqp are no box's (zeros, never stored).
  const int F = s.fold, bqp = BQ / F, rows = F * bqp;
  const int wgi = warpgroup_index();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);             // one arrival per consumer warp
    for (int i = 0; i < NS; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_init_fence();
  }
  if (rows < BQ && wgi > 0) {
    for (int i = threadIdx.x - 128; i < NQC * (BQ - rows) * 8; i += 256) {
      const int c = i / ((BQ - rows) * 8), r = rows + (i / 8) % (BQ - rows);
      *reinterpret_cast<uint4*>(q_sh + c * BQ * 128 + r * 128 + (i % 8) * 16) =
          make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
  }
  __syncthreads();

  if (wgi == 0) {
    // Producer: one thread loads each item's Q once its last S product
    // has read the previous one, and keeps the K/V ring full by TMA.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int g = 0;                       // K/V tiles loaded so far
      for (int li = 0; item_at(li) < items; ++li) {
        const Item itm = item_of<BK>(s, item_at(li));
        mbar_wait(q_empty, (li & 1) ^ 1);
        mbar_arrive_tx(q_full, NQC * rows * 128);
        for (int c = 0; c < NQC; ++c)
          tma_load_5d(q_sh + c * BQ * 128, &tq, q_full, c * 64, 0, itm.hg,
                      itm.p0, itm.b);
        for (int it = 0; it < itm.ntiles; ++it, ++g) {
          const int st = g % NS;
          mbar_wait(&empty[st], ((g / NS) & 1) ^ 1);
          mbar_arrive_tx(&k_full[st], L::K_BYTES);
          for (int c = 0; c < NQC; ++c)
            tma_load_4d(k_sh + st * L::K_BYTES + c * BK * 128, &tk,
                        &k_full[st], c * 64, itm.hk, it * BK, itm.b);
          mbar_arrive_tx(&v_full[st], L::V_BYTES);
          for (int c = 0; c < NVC; ++c)
            tma_load_4d(v_sh + st * L::V_BYTES + c * BK * 128, &tv,
                        &v_full[st], c * 64, itm.hk, it * BK, itm.b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup cw takes rows 64 cw .. 64 cw + 63 of each item.
  setmaxnreg_inc<240>();
  const int cw = wgi - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g4 = lane / 4, t = lane % 4;
  const int r0 = 64 * cw + 16 * warp + g4;         // rows r0, r0 + 8
  const uint32_t q_base = smem_addr(q_sh) + cw * 64 * 128;
  const uint32_t k_base = smem_addr(k_sh), v_base = smem_addr(v_sh);
  const float sl2 = sm_scale * 1.4426950408889634f;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  // Scores of the current tile (then its p), and P = P_hi + P_lo of the
  // tile before it, whose P.V may be in flight.
  float sc[BK / 2];
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
  // S = Q . K^T of ring tile g: 64 rows x BK keys, f32.
  auto issue_s = [&](int g) {
    const int st = g % NS;
    mbar_wait(&k_full[st], (g / NS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      qk_product<BK>(
          sc, desc(q_base + (kd / 4) * BQ * 128 + (kd % 4) * 32, 16, 1024),
          desc(k_base + st * L::K_BYTES + (kd / 4) * BK * 128 + (kd % 4) * 32,
               16, 1024),
          kd > 0);
  };
  // O += P . V of ring tile g (P_hi and P_lo, V read transposed): 128
  // output columns a product (two 64-column tiles, the leading byte
  // offset apart), and 64 for an odd last tile.
  auto issue_pv = [&](float (&o)[NVC][32], int g) {
    const int st = g % NS;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NVC; j += 2) {
        const uint64_t dv = desc(v_base + st * L::V_BYTES + j * BK * 128 +
                                     kk * 16 * 128,
                                 BK * 128, 1024);
        if (j + 1 < NVC) {             // o[j], o[j + 1]: one fragment
          float(&o2)[64] = *reinterpret_cast<float(*)[64]>(o[j]);
          wgmma_rs_n128_tb(o2, ph[kk], dv);
          wgmma_rs_n128_tb(o2, pl[kk], dv);
          continue;
        }
        wgmma_rs_n64_tb(o[j], ph[kk], dv);
        wgmma_rs_n64_tb(o[j], pl[kk], dv);
      }
  };

  // The two warpgroups take turns to issue their products (named
  // barriers 3 + cw), so one's softmax runs under the other's tensor-core
  // work (FA3's ping-pong). Warpgroup 0 goes first; each issues the same
  // number of times (both take the same items).
  auto my_turn = [&] { named_bar_sync(3 + cw, 256); };
  auto your_turn = [&] { named_bar_arrive(3 + (1 - cw), 256); };
  if (cw == 1) your_turn();
  int g = 0;                           // K/V tiles consumed so far
  for (int li = 0; item_at(li) < items; ++li) {
    const Item itm = item_of<BK>(s, item_at(li));
    const int k_hi = itm.k_hi, ntiles = itm.ntiles;
    const int qp[2] = {itm.p0 + r0 / F, itm.p0 + (r0 + 8) / F};
    float o[NVC][32];
#pragma unroll
    for (int j = 0; j < NVC; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[j][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // Tile it's scores -> p in sc (in the log2 domain), its row sums into
    // l; returns in alpha the factors the rows' O must take before tile
    // it's P.V. O itself is not touched: the previous P.V may be in
    // flight. Only a tile on the causal diagonal or the ragged key edge
    // has masked entries. Row r sees this tile's columns c < lim(r) =
    // min(k_hi, q_offset + qp(r) + 1) - k0; a masked score is set (not
    // added), so a NaN key past k_hi is gone.
    auto softmax = [&](int it, float (&alpha)[2]) {
      const int k0 = it * BK;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= sl2;
      if (k0 + BK > k_hi || (s.causal && k0 + BK - 1 > s.q_offset + itm.p0)) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          int lim = k_hi - k0 - 2 * t;
          if (s.causal) lim = min(lim, s.q_offset + qp[hh] + 1 - k0 - 2 * t);
#pragma unroll
          for (int nt = 0; nt < BK / 8; ++nt) {
            if (nt * 8 >= lim) sc[4 * nt + 2 * hh] = -INFINITY;
            if (nt * 8 + 1 >= lim) sc[4 * nt + 2 * hh + 1] = -INFINITY;
          }
        }
      }
      // Row maxima over the thread's columns, then across the row's quad.
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt)
          v4[nt % 4] = fmaxf(v4[nt % 4], fmaxf(sc[4 * nt + 2 * hh],
                                               sc[4 * nt + 2 * hh + 1]));
        float mx = fmaxf(fmaxf(v4[0], v4[1]), fmaxf(v4[2], v4[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        alpha[hh] = m[hh] == -INFINITY ? 0.f : ex2(m[hh] - m_new);
        const float mu = m_new == -INFINITY ? 0.f : m_new;
        m[hh] = m_new;
        float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          const float pa = ex2(sc[4 * nt + 2 * hh] - mu);   // masked: 0
          const float pb = ex2(sc[4 * nt + 2 * hh + 1] - mu);
          sc[4 * nt + 2 * hh] = pa;
          sc[4 * nt + 2 * hh + 1] = pb;
          s4[nt % 4] += pa + pb;
        }
        l[hh] = l[hh] * alpha[hh] + ((s4[0] + s4[1]) + (s4[2] + s4[3]));
      }
    };
    // O *= alpha, then P = P_hi + P_lo of the tile in sc (exact to ~2^-17
    // of p; one bf16 P would lose 2^-9).
    auto rescale_split = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int j = 0; j < NVC; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][4 * i + e] *= alpha[e / 2];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r],
                     pl[kk][r]);
    };

    // Tile 0: S, softmax, P. Then, per tile it >= 1, S(it) and the
    // previous tile's P.V go to the tensor cores back to back; the wait
    // for S(it) leaves that P.V in flight while softmax(it) runs, and
    // the second wait completes it before O is rescaled (FA3's
    // intra-warpgroup overlap). No product is in flight across
    // iterations, or ptxas would serialize every wgmma.
    mbar_wait(q_full, li & 1);
    float alpha[2];
    if (ntiles > 0) {
      my_turn();
      issue_s(g);
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      if (ntiles == 1) release(q_empty);   // the item's last S has read Q
      softmax(0, alpha);
      rescale_split(alpha);
    } else {
      release(q_empty);
    }
    for (int it = 1; it < ntiles; ++it) {
      const int gp = g + it - 1;         // the previous tile's ring slot
      my_turn();
      issue_s(g + it);
      wgmma_commit();
      mbar_wait(&v_full[gp % NS], (gp / NS) & 1);
      issue_pv(o, gp);
      wgmma_commit();
      your_turn();
      wgmma_wait<1>();                   // S(it) done; P.V in flight
      fence_regs(sc);
      if (it == ntiles - 1) release(q_empty);
      softmax(it, alpha);
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NVC; ++j) fence_regs(o[j]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }
      release(&empty[gp % NS]);
      rescale_split(alpha);
    }
    if (ntiles > 0) {
      // The last tile's P.V. V rows past k_hi (loaded by the box, maybe
      // NaN) are zeroed first: a masked p of 0 must not meet them.
      const int gl = g + ntiles - 1, st = gl % NS, k0 = (ntiles - 1) * BK;
      mbar_wait(&v_full[st], (gl / NS) & 1);
      if (k_hi - k0 < BK) {
        unsigned char* vs = v_sh + st * L::V_BYTES;
        const int dead = BK - (k_hi - k0);
        for (int i = threadIdx.x - 128 - 128 * cw; i < NVC * dead * 8;
             i += 128) {
          const int c = i / (dead * 8), r = k_hi - k0 + (i / 8) % dead;
          *reinterpret_cast<uint4*>(vs + c * BK * 128 + r * 128 +
                                    (i % 8) * 16) = make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();
        named_bar_sync(1 + cw, 128);
      }
      my_turn();
      issue_pv(o, gl);
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NVC; ++j) fence_regs(o[j]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }
      release(&empty[st]);
    }
    g += ntiles;

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lr = l[hh];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float inv = 1.f / (lr == 0.f ? 1.f : lr);
      const int r = r0 + 8 * hh;
      if (r >= rows || qp[hh] >= s.Sq) continue;
      bf16* orow = out + (((size_t)itm.b * s.Sq + qp[hh]) * s.H +
                          itm.hg * F + r % F) * s.Dv + 2 * t;
#pragma unroll
      for (int j = 0; j < NVC; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (64 * j + 8 * i < s.Dv)
            *reinterpret_cast<__nv_bfloat162*>(orow + 64 * j + 8 * i) =
                __floats2bfloat162_rn(o[j][4 * i + 2 * hh] * inv,
                                      o[j][4 * i + 2 * hh + 1] * inv);
    }
  }
  if (cw == 0) my_turn();              // warpgroup 1's last arrival
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

size_t smem_for(const Widths& w) {
#define REPRO_FLASH_SMEM(DP, DVP) \
  if (w.dp == DP && w.dvp == DVP) return Layout<DP, DVP>::SMEM
  REPRO_FLASH_SMEM(64, 64);
  REPRO_FLASH_SMEM(128, 64);
  REPRO_FLASH_SMEM(128, 128);
  REPRO_FLASH_SMEM(192, 128);
  REPRO_FLASH_SMEM(192, 192);
  REPRO_FLASH_SMEM(256, 128);
  REPRO_FLASH_SMEM(256, 256);
#undef REPRO_FLASH_SMEM
  return 0;
}

template <int DP, int DVP>
int launch(const void* q, const void* k, const void* v, void* out, Shape sh,
           float sm_scale, cudaStream_t st) {
  using L = Layout<DP, DVP>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP, DVP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  // The model's tensors in place: q as (D, F, H / F, Sq, B) so a box of
  // {64, F, 1, BQ / F, 1} is the block's rows in order (position-major);
  // k and v as (width, Hkv, Skv, B) in boxes of {64, 1, BK, 1}.
  const int F = sh.fold;
  const uint64_t e = 2;                          // bytes of a bf16
  const uint64_t skv = sh.Skv > 0 ? sh.Skv : 1;  // never loaded if 0
  CUtensorMap tq, tk, tv;
  const uint64_t qd[5] = {(uint64_t)sh.D, (uint64_t)F, (uint64_t)(sh.H / F),
                          (uint64_t)sh.Sq, (uint64_t)sh.B};
  const uint64_t qs[4] = {sh.D * e, F * sh.D * e, sh.H * sh.D * e,
                          (uint64_t)sh.Sq * sh.H * sh.D * e};
  const uint32_t qb[5] = {64, (uint32_t)F, 1, (uint32_t)(BQ / F), 1};
  const uint64_t kd[4] = {(uint64_t)sh.D, (uint64_t)sh.Hkv, skv,
                          (uint64_t)sh.B};
  const uint64_t ks[3] = {sh.D * e, sh.Hkv * sh.D * e, skv * sh.Hkv * sh.D * e};
  const uint64_t vd[4] = {(uint64_t)sh.Dv, (uint64_t)sh.Hkv, skv,
                          (uint64_t)sh.B};
  const uint64_t vs[3] = {sh.Dv * e, sh.Hkv * sh.Dv * e,
                          skv * sh.Hkv * sh.Dv * e};
  const uint32_t kvb[4] = {64, 1, (uint32_t)L::BK, 1};
  int err = make_map_bf16(&tq, q, 5, qd, qs, qb);
  if (!err) err = make_map_bf16(&tk, k, 4, kd, ks, kvb);
  if (!err) err = make_map_bf16(&tv, v, 4, vd, vs, kvb);
  if (err) return err;
  // Persistent: one block per SM (at most one per item) walks its items
  // (item_at), so the next item's loads overlap this one's work.
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int bqp = BQ / F;
  const int items = (sh.Sq + bqp - 1) / bqp * (sh.H / F) * sh.B;
  flash_wgmma_kernel<DP, DVP><<<min(items, sms), THREADS, L::SMEM, st>>>(
      tq, tk, tv, static_cast<bf16*>(out), sh, sm_scale, items);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* out,
             Shape sh, float sm_scale, cudaStream_t st) {
  const Widths w = pick(sh.D, sh.Dv);
#define REPRO_FLASH_WG(DP, DVP)                                  \
  if (w.dp == DP && w.dvp == DVP)                                \
    return launch<DP, DVP>(q, k, v, out, sh, sm_scale, st)
  REPRO_FLASH_WG(64, 64);
  REPRO_FLASH_WG(128, 64);
  REPRO_FLASH_WG(128, 128);
  REPRO_FLASH_WG(192, 128);
  REPRO_FLASH_WG(192, 192);
  REPRO_FLASH_WG(256, 128);
  REPRO_FLASH_WG(256, 256);
#undef REPRO_FLASH_WG
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wg

}  // namespace

// Shared-memory bytes one block needs (the wrapper checks it against the
// card's limit before launching): the bf16 wgmma kernel's (bf16 = 1; 0 if
// D, Dv have no instantiation) or the f32 CUDA-core kernel's.
extern "C" long long flash_attention_smem(int bf16, int D, int Dv) {
  if (bf16) {
    const wg::Widths w = wg::pick(D, Dv);
    return w.dp ? (long long)wg::smem_for(w) : 0;
  }
  return 4LL * (2LL * 64 * (D + 4) + 64LL * Dv + 64LL * (64 + 4));
}

// The f32 CUDA-core kernel (q, k, v and out f32; D, Dv multiples of 4).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Skv, int H, int Hkv, int D, int Dv,
                                   int q_offset, int causal, float sm_scale,
                                   void* stream) {
  const Shape sh{B, Sq, Skv, H, Hkv, D, Dv, q_offset, causal, 1};
  const size_t smem = (size_t)flash_attention_smem(0, D, Dv);
  return dispatch<float>(q, k, v, out, sh, sm_scale, smem,
                         static_cast<cudaStream_t>(stream));
}

// The bf16 wgmma kernel: q (B, Sq, H, D), k (B, Skv, Hkv, D), v
// (B, Skv, Hkv, Dv), out (B, Sq, H, Dv), all bf16, contiguous and 16-byte
// aligned; D, Dv multiples of 16, at most 256. Returns the cudaError_t of
// the launch (or of a tensor map's encoding).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Sq, int Skv, int H,
                               int Hkv, int D, int Dv, int q_offset,
                               int causal, float sm_scale, void* stream) {
  if (D % 16 || Dv % 16) return static_cast<int>(cudaErrorInvalidValue);
  // An item folds the G = H / Hkv heads of a kv-head while G <= 8, else
  // it takes one head.
  const int G = H / Hkv;
  const Shape sh{B, Sq, Skv, H, Hkv, D, Dv, q_offset, causal, G <= 8 ? G : 1};
  return wg::dispatch(q, k, v, out, sh, sm_scale,
                      static_cast<cudaStream_t>(stream));
}
