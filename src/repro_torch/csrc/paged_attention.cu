// Fused paged decode attention for Hopper (sm_90a), CUDA C++: the GQA
// form and the MLA form.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_decode_attention (Pallas body _kernel, head folding _fold_heads)
// in all its forms: GQA over bf16 or f32 pages, or int8 code pages with
// fp16 scale pages (one scale per (in-page position, kv-head)); and the
// MLA form (shared_kv + has_rope): the K pages double as V and a second
// score term q2 . k2 (the decoupled-RoPE side) joins the scores before
// the scale, with int8 pages on both sides. C >= 1 chunk queries per
// slot.
//
// Semantics, as in the Pallas kernel: for slot b, query i < C at
// position positions[b] + i attends kv positions <= positions[b] + i,
// read through the block table (logical block j -> physical page
// tables[b, j]). The C*G query rows of one kv-head map as r = i*G + g ->
// head hkv*G + g, causal mask ki <= pos + r / G. Online softmax with f32
// running max and sum and an f32 accumulator; a row whose sum stays 0
// divides by 1. Blocks past last_live = (pos + max(len, 1) - 1) / bs are
// never read, so dead pages and the null page cannot reach the output.
// int8 pages are dequantized right after the load, as the Pallas page()
// does: each staged element is float(code) * float(scale) in f32 (never
// rounded to bf16), and a dead page's scales are never loaded either.
//
// GQA form. Two kernels, picked by dtype alone (the wrapper's docstring
// says so). The bytes of the live K/V pages bound the function (each
// read once; the flops are ~C * G per byte, far below the ridge), but at
// decode sizes a call lasts a few round trips to memory, so both designs
// are about latency.
//
// bf16 q on bf16 or int8 pages (every serving path; D a multiple of 16):
// the tensor-core kernel, gtc::paged_gqa_tc_kernel (entry point
// paged_attention_gqa_tc):
//   * the grid is (slot x kv-head x row group, split); a block's 16 or
//     32 query rows (C * G rows of a kv-head, padded to m16 tiles) meet
//     16-key tiles decoupled from the page size (a tile spans several
//     pages at bs = 4, a quarter page at bs = 64); a split is two tiles
//     per warp (more only past 64 splits), so the serve's 256-key table
//     is one split and needs no merge;
//   * the block loads the split's page ids from the table itself; each
//     warp walks its own tiles through its own 2-stage cp.async ring (the
//     next tile loads while this one computes; no block-wide barrier per
//     tile): 16-byte copies of the key rows, each lane finding one key's
//     row and sharing it by shuffles; keys past the slot's deepest valid
//     position (pos + max(len, 1) - 1) are zero-filled, never loaded, and
//     pages past last_live are never touched, so garbage in dead pages
//     changes no bit;
//   * S = Q.K^T and P.V with mma.sync m16n8k16 bf16 -> f32, P split into
//     three bf16 parts (hi + mid + lo is p to ~2^-25, so the product keeps
//     the f32 plain version's precision); int8 codes become bf16 in a
//     warp buffer (exact: |code| <= 127), the K scale multiplies each
//     score column in f32 and the V scale folds into p before the split
//     (float(code) * float(scale) up to rounding order; a zeroed page
//     reads as exactly 0);
//   * the warps' states merge through shared memory in warp order; with
//     more than one split the last block of a (slot, kv-head, row group)
//     to finish, picked by an atomic ticket, merges the live splits'
//     partials in split order (one launch; the sums follow a fixed order,
//     so two runs give the same bits); blocks of splits past the slot's
//     live keys exit at once.
//
// f32 q (on f32, bf16 or int8 pages): the CUDA-core kernel,
// paged_attention_gqa_kernel (entry point paged_attention_gqa), whose f32
// products meet the f32 tolerance:
//   * the grid is (slot x kv-head, split): the TPU's sequential walk over
//     kv blocks becomes `splits` blocks that each walk a contiguous run of
//     the slot's pages (flash-decoding); each block loads its page ids
//     from the table itself;
//   * a page's K and V tiles are staged in shared memory together, rows
//     padded to D + 1 floats, so the thread-per-(row, key) score loop and
//     the thread-per-(row, feature) P.V loop are free of bank conflicts;
//   * masked keys get p = 0 and are skipped in P.V, so garbage past a
//     row's depth in a live page is never multiplied in;
//   * with more than one split, each block leaves its (max, sum, acc)
//     partials and a second kernel merges them in split order (no
//     atomics, so a result never varies from run to run).
//
// MLA form. Hkv is 1 and G = H = 128 (deepseek-v3), so a slot has C * 128
// query rows of width 512 + 64, and every row reads the same pages: the
// work is S = [q_eff | q_rope] . [ckv | krope]^T, then acc += P . ckv
// (~2 * (576 + 512) flops per row and key), f32 q_eff and q_rope in, f32
// out (what mla_decode passes). Its least time is set by the bytes of the
// valid rows' f32 queries and output; the flops at the bf16 tensor-core
// rate take less. Two kernels, picked by the page dtype alone.
//
// bf16 pages, or int8 code pages with fp16 scales (every serving path):
// the tensor-core kernel, mtc::paged_mla_tc_kernel (entry point
// paged_attention_mla_tc):
//   * rows r = i * G + g in 64-row tiles: at G = 128 a chunk entry's heads
//     are two tiles of one causal depth; at small G a tile spans entries
//     and masks per row. Each live page is read once per 64 rows: a
//     16-key tile [ckv | krope] (bf16, swizzled; int8 codes turned into
//     exact bf16 once per block) serves the scores and, its ckv part, P.V;
//   * products on mma.sync m16n8k16 (bf16 -> f32). The f32 queries stay
//     f32 in shared memory and each fragment is split into NQ = 3 bf16
//     parts (hi + mid + lo, ~2^-25 relative); the keys are exact in bf16
//     (int8: |code| <= 127). p is split into NP = 3 parts too, as the GQA
//     form splits it. tests/test_torch_mla.py emulates the split at
//     deepseek-v3's widths: on its seeded inputs two parts of q and of p
//     already hold the card tolerance (0.81 of it at worst), three and
//     three use 0.17 of it; three are kept for the margin that the card's
//     order of summation and harder inputs need (a rough bound puts two
//     parts of q at up to ~2^-17 of sum |q||k| per score, ~2e-4 in a
//     logit). On int8 pages the ckv and krope terms are scaled per key
//     column in f32 before they join, and the ckv scale folds into p
//     before its split;
//   * why mma.sync and not wgmma: three bf16 parts of a 64 x 576 query
//     tile are 221 KB, more than fits beside a key ring, so the A operand
//     is split in registers either way, and the products are small (S is
//     64 x 16 per key tile) in a kernel bound by memory traffic and
//     latency, where wgmma's higher rate would not show. The block's 16
//     warps are 4 row groups x 4 column quarters: each warp sums a
//     quarter of the score's features for its 16 rows, the four shares
//     are pooled through shared memory and summed in one fixed order (so
//     the four warps hold the same S and run the same softmax), and each
//     warp owns D1 / 4 output columns (rank 512: 64 f32 accumulators a
//     thread). Built for the ported configurations' ranks, 512 and 32
//     (deepseek-v3 reduced: 8 columns a warp, an odd count of 8-column
//     tiles);
//   * shared memory: the q tile 64 x (576 + 8) f32 (149.5 KB), a 3-stage
//     ring of key tiles (55 KB; int8 27.6 KB + an 18 KB conversion
//     buffer), score shares 16 KB: one block per SM. It does not grow
//     with the table's width: each warp reads its key's page id from the
//     table in global memory a tile before it stages the page (only the
//     step's item list, one int per 64-row tile, and the slots'
//     positions grow with the step);
//   * one cooperative launch of one block per SM. Every block plans the
//     step from positions and lengths (the same plan in each): the key
//     tiles each live row tile walks, and `per` tiles a split -- at least
//     work / SMs, and the fewest that fit all of the step's (row tile,
//     split) items on the SMs at once (or the whole walk, nothing split,
//     when even that does not fit); a tile's splits share its tiles
//     evenly. Block i walks item i (q rows and the first key tile in
//     one cp.async group). The launch shape depends on the table's width
//     alone. Block 0 writes the plan it took to a 3-int output, which
//     the wrapper keeps (mla_last_plan);
//   * the splits of a row tile merge inside the launch: each writes its
//     partial (acc, max, sum), counts itself on the tile's ticket (zeroed
//     by the wrapper for each launch), waits until every split has (they
//     all run at once), and merges its own slice of the tile's rows from
//     every split, staged in shared memory, summed in split order (no
//     atomics on sums: two launches give the same bits);
//   * rows past a slot's valid length are garbage by contract: a row tile
//     whose rows all lie past max(len, 1) reads no page and is written as
//     0; keys past a walk's end are zero-filled, never loaded, and pages
//     past last_live are never touched, so garbage in dead pages changes
//     no bit;
//   * what holds it back, by estimate (no committed per-stage profile;
//     PERF.md section 6): a split block moves ~0.5 MB (the 147 KB q tile,
//     its pages, a 128 KB partial written and read back, its output rows)
//     through one SM's share of the memory system, and splitting the f32
//     queries costs ALU on every key tile.
//
// f32 pages (on no serving path): the CUDA-core kernel,
// paged_attention_mla_kernel (entry point paged_attention_mla), whose f32
// products meet the f32 tolerance: the grid is (slot x kv-head x 32-row
// tile, split); a tile's q rows and each live page are staged once per
// block as f32; scores one thread per (key, two rows), P.V two output
// columns per thread for all 32 rows; the split count follows the step
// (from positions and lengths, on the card), and a second kernel merges
// the splits in split order.
#include <math.h>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace repro_torch;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Shape {
  int B, C, H, Hkv, D, bs, MB, pages_per_split, splits;
};

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_attention_gqa_kernel(const TQ* __restrict__ q,
                           const TKV* __restrict__ k_pages,
                           const TKV* __restrict__ v_pages,
                           const __half* __restrict__ k_scales,
                           const __half* __restrict__ v_scales,
                           const int* __restrict__ tables,
                           const int* __restrict__ positions,
                           const int* __restrict__ lengths,
                           TQ* __restrict__ out, float* __restrict__ part_acc,
                           float* __restrict__ part_ml, Shape s,
                           float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int D = s.D, bs = s.bs, KS = D + 1;
  const int G = s.H / s.Hkv;
  const int R = s.C * G;               // query rows of this kv-head
  float* q_sh = smem;                  // [R][D]
  float* acc_sh = q_sh + R * D;        // [R][D]
  float* k_sh = acc_sh + R * D;        // [bs][D + 1]
  float* v_sh = k_sh + bs * KS;        // [bs][D + 1]
  float* p_sh = v_sh + bs * KS;        // [R][bs]  scores, then probs
  float* m_sh = p_sh + R * bs;         // [R] running max
  float* l_sh = m_sh + R;              // [R] running sum
  float* a_sh = l_sh + R;              // [R] rescale of this page

  const int bh = blockIdx.x;
  const int b = bh / s.Hkv, hkv = bh % s.Hkv;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int pos0 = positions[b];
  const int last_live =
      min((pos0 + max(lengths[b], 1) - 1) / bs, s.MB - 1);
  const int j_begin = split * s.pages_per_split;
  const int j_end = min(last_live + 1, j_begin + s.pages_per_split);

  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, dd = idx % D;
    const int i = r / G, g = r % G;
    q_sh[idx] = to_float(q[(((size_t)b * s.C + i) * s.H + hkv * G + g) * D + dd]);
    acc_sh[idx] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_sh[r] = -INFINITY;
    l_sh[r] = 0.f;
  }
  __syncthreads();

  for (int j = j_begin; j < j_end; ++j) {
    const size_t page = (size_t)tables[(size_t)b * s.MB + j];
    // K and V pages -> shared (coalesced along D, both loads in flight).
    for (int idx = tid; idx < bs * D; idx += THREADS) {
      const int t = idx / D, dd = idx % D;
      const size_t row = (page * bs + t) * s.Hkv + hkv;
      float kx = to_float(k_pages[row * D + dd]);
      float vx = to_float(v_pages[row * D + dd]);
      if constexpr (std::is_same<TKV, int8_t>::value) {
        kx *= __half2float(k_scales[row]);
        vx *= __half2float(v_scales[row]);
      }
      k_sh[t * KS + dd] = kx;
      v_sh[t * KS + dd] = vx;
    }
    __syncthreads();
    // Scores: one thread per (row, key).
    for (int p = tid; p < R * bs; p += THREADS) {
      const int r = p / bs, t = p % bs;
      const float* qr = q_sh + r * D;
      const float* kt = k_sh + t * KS;
      float dot = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], kt[dd], dot);
      const int ki = j * bs + t;
      p_sh[p] = (ki <= pos0 + r / G) ? dot * sm_scale : -INFINITY;
    }
    __syncthreads();
    // Online-softmax statistics: one warp per row.
    for (int r = warp; r < R; r += WARPS) {
      float mx = -INFINITY;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, p_sh[r * bs + t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_sh[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float sv = p_sh[r * bs + t];
        const float pv = (sv == -INFINITY) ? 0.f : expf(sv - m_new);
        p_sh[r * bs + t] = pv;
        sum += pv;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
        a_sh[r] = alpha;
        l_sh[r] = l_sh[r] * alpha + sum;
        m_sh[r] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p . V over the page's live keys.
    for (int idx = tid; idx < R * D; idx += THREADS) {
      const int r = idx / D, dd = idx % D;
      const float* pr = p_sh + r * bs;
      float a = acc_sh[idx] * a_sh[r];
      for (int t = 0; t < bs; ++t) {
        const float pv = pr[t];
        if (pv != 0.f) a = fmaf(pv, v_sh[t * KS + dd], a);
      }
      acc_sh[idx] = a;
    }
    __syncthreads();
  }

  if (s.splits == 1) {
    for (int idx = tid; idx < R * D; idx += THREADS) {
      const int r = idx / D, dd = idx % D;
      const int i = r / G, g = r % G;
      const float l = l_sh[r];
      from_float(acc_sh[idx] / (l == 0.f ? 1.f : l),
                 &out[(((size_t)b * s.C + i) * s.H + hkv * G + g) * D + dd]);
    }
    return;
  }
  // Partials of this split: acc [R][D], then (max, sum) per row.
  const size_t slot = (size_t)bh * s.splits + split;
  float* pa = part_acc + slot * R * D;
  for (int idx = tid; idx < R * D; idx += THREADS) pa[idx] = acc_sh[idx];
  float* pml = part_ml + slot * 2 * R;
  for (int r = tid; r < R; r += THREADS) {
    pml[r] = m_sh[r];
    pml[R + r] = l_sh[r];
  }
}

// Merge the splits of one (slot, kv-head): rescale each split's partials
// to the common max, in split order, and normalize.
template <typename TQ>
__global__ void __launch_bounds__(THREADS)
paged_attention_merge(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, TQ* __restrict__ out,
                      Shape s) {
  const int bh = blockIdx.x;
  const int b = bh / s.Hkv, hkv = bh % s.Hkv;
  const int D = s.D, G = s.H / s.Hkv, R = s.C * G;
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, dd = idx % D;
    float m = -INFINITY;
    for (int z = 0; z < s.splits; ++z)
      m = fmaxf(m, part_ml[((size_t)bh * s.splits + z) * 2 * R + r]);
    float num = 0.f, den = 0.f;
    if (m != -INFINITY) {
      for (int z = 0; z < s.splits; ++z) {
        const size_t slot = (size_t)bh * s.splits + z;
        const float mz = part_ml[slot * 2 * R + r];
        if (mz == -INFINITY) continue;
        const float w = expf(mz - m);
        den = fmaf(w, part_ml[slot * 2 * R + R + r], den);
        num = fmaf(w, part_acc[slot * R * D + idx], num);
      }
    }
    const int i = r / G, g = r % G;
    from_float(num / (den == 0.f ? 1.f : den),
               &out[(((size_t)b * s.C + i) * s.H + hkv * G + g) * D + dd]);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const __half* ks,
           const __half* vs, const int* tables,
           const int* positions, const int* lengths, void* out,
           float* part_acc, float* part_ml, Shape sh, float sm_scale,
           size_t smem, cudaStream_t st) {
  auto kern = paged_attention_gqa_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    // Opt in to the card's whole per-block limit once per instantiation
    // (the first launch that needs more than 48 KB); the wrapper has
    // already checked smem against that limit.
    static const cudaError_t opt_in = [] {
      int dev = 0, limit = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(paged_attention_gqa_kernel<TQ, TKV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 limit);
      return e;
    }();
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  }
  const dim3 grid(sh.B * sh.Hkv, sh.splits);
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), ks, vs, tables, positions, lengths,
      static_cast<TQ*>(out), part_acc, part_ml, sh, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sh.splits == 1) return static_cast<int>(err);
  paged_attention_merge<TQ><<<sh.B * sh.Hkv, THREADS, 0, st>>>(
      part_acc, part_ml, static_cast<TQ*>(out), sh);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// GQA form, bf16 q over bf16 or int8 pages: tensor-core products and a
// per-warp cp.async ring (see the top note).
// ---------------------------------------------------------------------
namespace gtc {

using bf16 = __nv_bfloat16;
constexpr int KT = 16;                 // keys of a tile
constexpr int TPW = 2;                 // key tiles a warp walks, at least
constexpr int MAX_SPLITS = 64;         // bounds the merge's weights
constexpr int WSTR = MAX_SPLITS + 2;   // weights row: [split] M den

// Warps of a block: 8, or 4 at DP = 256 (their rings' shared memory).
__host__ __device__ constexpr int warps_for(int DP) {
  return DP > 192 ? 4 : 8;
}

struct TcShape {
  int B, C, H, Hkv, D, bs, MB, splits, row_groups;
  int tps;                             // key tiles of a split
};

// Byte offset of (row, byte) in a tile of `row_bytes`-byte rows whose
// 16-byte chunks are XOR-swizzled by the row (conflict-free ldmatrix
// and 16-byte accesses down a column).
__device__ __forceinline__ int swb(int row, int byte, int row_bytes) {
  const int chunks = row_bytes >> 4;
  const int mask = (chunks < 8 ? chunks : 8) - 1;
  const int c = byte >> 4;
  return row * row_bytes + (((c & ~mask) | ((c ^ row) & mask)) << 4) +
         (byte & 15);
}

// Shared-memory layout of one block (bytes), DP = D rounded up to 64,
// RB = 16 * RTB query rows, ES = bytes of a page element.
struct Layout {
  int q, ids, ring, conv, merge, wts, flag, total;
};

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

__host__ __device__ inline Layout layout(int RB, int DP, int ES, int tps) {
  const int W = warps_for(DP);
  Layout L{};
  L.q = 0;                                        // [RB][DP] bf16
  L.ids = L.q + align128(RB * DP * 2);            // split's page ids
  const int ring_b = W * 2 * 2 * KT * DP * ES;    // 2 stages of K and V
  const int conv_b = ES == 1 ? W * 2 * KT * DP * 2 : 0;
  const int merge_b = W * RB * (DP + 10) * 4;     // per-warp states
  L.ring = L.ids + align128((tps * KT + 1) * 4);
  L.conv = L.ring + ring_b;
  L.merge = L.ring;                               // aliases the ring
  const int body = ring_b + conv_b > merge_b ? ring_b + conv_b : merge_b;
  L.wts = L.ring + align128(body);                // [RB][WSTR] f32
  L.flag = L.wts + align128(RB * WSTR * 4);
  L.total = L.flag + 16;
  return L;
}

// 4 f32 / den -> 4 bf16 (one 8-byte store; dst 8-byte aligned).
__device__ __forceinline__ void store_bf16x4(bf16* dst, float4 v,
                                             float den) {
  const float d = den == 0.f ? 1.f : den;
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x / d, v.y / d);
  __nv_bfloat162 c = __floats2bfloat162_rn(v.z / d, v.w / d);
  *reinterpret_cast<uint2*>(dst) = make_uint2(
      *reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&c));
}

__device__ __forceinline__ void fma4(float a, float4 x, float4& acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// 16 int8 codes (one 16-byte chunk) -> 16 bf16 at dst (two chunks).
__device__ __forceinline__ void codes_to_bf16(const int4 raw, uint4* lo,
                                              uint4* hi) {
  const uint32_t w[4] = {(uint32_t)raw.x, (uint32_t)raw.y, (uint32_t)raw.z,
                         (uint32_t)raw.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float f0 = (float)(int8_t)(w[i] & 0xffu);
    const float f1 = (float)(int8_t)((w[i] >> 8) & 0xffu);
    const float f2 = (float)(int8_t)((w[i] >> 16) & 0xffu);
    const float f3 = (float)(int8_t)(w[i] >> 24);
    __nv_bfloat162 a = __floats2bfloat162_rn(f0, f1);
    __nv_bfloat162 c = __floats2bfloat162_rn(f2, f3);
    o[2 * i] = *reinterpret_cast<uint32_t*>(&a);
    o[2 * i + 1] = *reinterpret_cast<uint32_t*>(&c);
  }
  *lo = make_uint4(o[0], o[1], o[2], o[3]);
  *hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// One block: RTB row tiles of one (slot, kv-head) against one split of
// the slot's key tiles; warp w walks tiles w, w + W, ... of the
// split through its own ring. TKV: bf16 pages or int8 codes.
template <typename TKV, int RTB, int DP>
__global__ void __launch_bounds__(32 * warps_for(DP))
paged_gqa_tc_kernel(const bf16* __restrict__ q,
                    const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ v_pages,
                    const __half* __restrict__ k_scales,
                    const __half* __restrict__ v_scales,
                    const int* __restrict__ tables,
                    const int* __restrict__ positions,
                    const int* __restrict__ lengths, bf16* __restrict__ out,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml,
                    int* __restrict__ tickets, TcShape s, float sm_scale) {
  constexpr int W = warps_for(DP);
  constexpr int THREADS = 32 * W;
  constexpr bool kInt8 = sizeof(TKV) == 1;
  constexpr int ES = sizeof(TKV);
  constexpr int RB = RTB * 16;
  constexpr int NVT = DP / 8;
  constexpr int ROW_B = DP * ES;       // bytes of a staged key row
  constexpr int TILE_B = KT * ROW_B;
  extern __shared__ __align__(128) unsigned char sm[];
  const Layout lay = layout(RB, DP, ES, s.tps);
  float* wts = reinterpret_cast<float*>(sm + lay.wts);
  bf16* q_sh = reinterpret_cast<bf16*>(sm + lay.q);
  int* ids = reinterpret_cast<int*>(sm + lay.ids);
  int* flag = reinterpret_cast<int*>(sm + lay.flag);

  const int unit = blockIdx.x;         // (slot, kv-head, row group)
  const int rg = unit % s.row_groups;
  const int bh = unit / s.row_groups;
  const int b = bh / s.Hkv, hkv = bh % s.Hkv;
  const int z = blockIdx.y;
  const int G = s.H / s.Hkv, R = s.C * G, D = s.D, bs = s.bs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // Q rows of this row group -> shared (bf16, swizzled; rows past R
  // zero), in flight while the positions and page ids load.
  const int row0 = rg * RB;
  {
    constexpr int CPR = DP / 8;
    for (int idx = tid; idx < RB * CPR; idx += THREADS) {
      const int r = idx / CPR, c = idx % CPR;
      const int rr = row0 + r;
      const bool ok = rr < R && c * 8 < D;   // pad columns: zero
      const int i = ok ? rr / G : 0, gg = ok ? rr % G : 0;
      const bf16* src =
          q + (((size_t)b * s.C + i) * s.H + hkv * G + gg) * D + c * 8;
      cp_async16(reinterpret_cast<unsigned char*>(q_sh) +
                     swb(r, c * 16, DP * 2),
                 ok ? src : q, ok);
    }
    cp_async_commit();
  }
  // Keys any valid row of the slot can see: [0, keys_end). Pages past
  // it (past last_live) are never touched, and the keys of a live page
  // past it are zero-filled, never loaded.
  const int pos0 = positions[b];
  const int keys_end = min(pos0 + max(lengths[b], 1), s.MB * bs);
  const int ntile = (keys_end + KT - 1) / KT;
  const int nlive = (ntile + s.tps - 1) / s.tps;
  if (z >= nlive) {
    cp_async_wait<0>();
    return;
  }
  const int t_begin = z * s.tps, t_end = min(ntile, t_begin + s.tps);

  const int key0 = t_begin * KT;
  const int j0 = key0 / bs;
  const int j1 = (min(keys_end, t_end * KT) - 1) / bs;
  for (int j = j0 + tid; j <= j1; j += THREADS)
    ids[j - j0] = tables[(size_t)b * s.MB + j];
  cp_async_wait<0>();
  __syncthreads();

  // This warp's tiles of the split, walked through its ring.
  const int my_n = t_begin + warp < t_end
                       ? (t_end - (t_begin + warp) + W - 1) / W
                       : 0;
  unsigned char* ring = sm + lay.ring + warp * 2 * 2 * TILE_B;

  // The staged row of key (lane % 16) of this warp's tile n, in rows of
  // D elements from the pages' start (-1: no such tile, or past
  // keys_end); each lane finds one, and the others shuffle it.
  auto key_row = [&](int n) -> long long {
    const int key = (t_begin + warp + n * W) * KT + (lane & 15);
    if (n >= my_n || key >= keys_end) return -1;
    return ((long long)ids[key / bs - j0] * bs + key % bs) * s.Hkv + hkv;
  };
  auto issue = [&](int n, long long kr) {  // tile n -> stage n % 2
    if (n < my_n) {
      unsigned char* kd = ring + (n & 1) * 2 * TILE_B;
      unsigned char* vd = kd + TILE_B;
      constexpr int CPR = ROW_B / 16;  // 16-byte chunks of a staged row
      const int cw = D * ES / 16;      // ... of a page row; the rest is 0
#pragma unroll
      for (int i = 0; i < KT * CPR / 32; ++i) {
        const int idx = lane + 32 * i, kk = idx / CPR, c = idx % CPR;
        const long long r = __shfl_sync(0xffffffffu, kr, kk);
        const bool ok = r >= 0 && c < cw;
        const size_t src = ok ? (size_t)r * D * ES + c * 16 : 0;
        const int off = swb(kk, c * 16, ROW_B);
        cp_async16(kd + off,
                   reinterpret_cast<const unsigned char*>(k_pages) + src, ok);
        cp_async16(vd + off,
                   reinterpret_cast<const unsigned char*>(v_pages) + src, ok);
      }
    }
    cp_async_commit();                 // empty groups keep the count
  };
  // int8: lane l < 16 holds the K scale of key l of a tile, lane 16 + l
  // its V scale (0 for keys past keys_end: never loaded).
  auto scale_at = [&](long long kr) -> float {
    if (!kInt8 || kr < 0) return 0.f;
    return __half2float((lane < 16 ? k_scales : v_scales)[kr]);
  };

  float acc[RTB][NVT][4];
  float m[RTB][2], l[RTB][2];
#pragma unroll
  for (int rt = 0; rt < RTB; ++rt) {
#pragma unroll
    for (int i = 0; i < NVT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][i][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[rt][h] = -INFINITY;
      l[rt][h] = 0.f;
    }
  }

  // Two stages: tile n + 1 is in flight while tile n is computed.
  const long long kr0 = key_row(0);
  issue(0, kr0);
  float sc_cur = scale_at(kr0);
  // Columns past D are zero in Q and the staged tiles, so the products
  // run over the padded width DP with no guard.
  constexpr int nkd = DP / 16, nvt = NVT;

  for (int n = 0; n < my_n; ++n) {
    const long long kr1 = key_row(n + 1);
    issue(n + 1, kr1);                 // into the stage tile n - 1 left
    const float sc_nxt = scale_at(kr1);            // in flight meanwhile
    cp_async_wait<1>();
    __syncwarp();
    const int tile = t_begin + warp + n * W;
    const unsigned char* kst = ring + (n & 1) * 2 * TILE_B;
    const unsigned char* vst = kst + TILE_B;
    const bf16* kb;                    // bf16 [KT][DP] tiles, swizzled
    const bf16* vb;
    if constexpr (kInt8) {
      // Codes -> bf16 (exact: |code| <= 127) in the warp's own buffer.
      bf16* kc = reinterpret_cast<bf16*>(sm + lay.conv) + warp * 2 * KT * DP;
      bf16* vc = kc + KT * DP;
      constexpr int CPR = DP / 16;     // code chunks of a staged row
#pragma unroll
      for (int i = 0; i < KT * CPR / 32; ++i) {
        const int idx = lane + 32 * i, kk = idx / CPR, c = idx % CPR;
        const int off = swb(kk, c * 16, ROW_B);
        uint4 *lo, *hi;
        unsigned char* kcb = reinterpret_cast<unsigned char*>(kc);
        unsigned char* vcb = reinterpret_cast<unsigned char*>(vc);
        lo = reinterpret_cast<uint4*>(kcb + swb(kk, c * 32, DP * 2));
        hi = reinterpret_cast<uint4*>(kcb + swb(kk, c * 32 + 16, DP * 2));
        codes_to_bf16(*reinterpret_cast<const int4*>(kst + off), lo, hi);
        lo = reinterpret_cast<uint4*>(vcb + swb(kk, c * 32, DP * 2));
        hi = reinterpret_cast<uint4*>(vcb + swb(kk, c * 32 + 16, DP * 2));
        codes_to_bf16(*reinterpret_cast<const int4*>(vst + off), lo, hi);
      }
      __syncwarp();
      kb = kc;
      vb = vc;
    } else {
      kb = reinterpret_cast<const bf16*>(kst);
      vb = reinterpret_cast<const bf16*>(vst);
    }
    const unsigned char* kbb = reinterpret_cast<const unsigned char*>(kb);
    const unsigned char* vbb = reinterpret_cast<const unsigned char*>(vb);
    const unsigned char* qbb = reinterpret_cast<const unsigned char*>(q_sh);

    // S = Q . K^T: RTB x (16 rows x 16 keys), f32; step kd + 1's
    // fragments load while step kd's products run.
    float sc[RTB][2][4];
#pragma unroll
    for (int rt = 0; rt < RTB; ++rt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[rt][j][e] = 0.f;
    uint32_t kf[2][4], qa[2][RTB][4];
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      if (kd < nkd) {
#pragma unroll
        for (int ld = (kd == 0 ? 0 : 1); ld < 2; ++ld) {
          const int kl = kd + ld;
          if (kl < nkd) {
            ldmatrix_x4(kf[kl & 1],
                        kbb + swb((lane & 7) + 8 * (lane >> 4),
                                  (kl * 16 + 8 * ((lane >> 3) & 1)) * 2,
                                  DP * 2));
#pragma unroll
            for (int rt = 0; rt < RTB; ++rt)
              ldmatrix_x4(qa[kl & 1][rt],
                          qbb + swb(rt * 16 + (lane & 15),
                                    (kl * 16 + 8 * (lane >> 4)) * 2, DP * 2));
          }
        }
#pragma unroll
        for (int rt = 0; rt < RTB; ++rt) {
          mma_bf16(sc[rt][0], qa[kd & 1][rt], kf[kd & 1][0], kf[kd & 1][1]);
          mma_bf16(sc[rt][1], qa[kd & 1][rt], kf[kd & 1][2], kf[kd & 1][3]);
        }
      }
    }

    // Scale, mask, online softmax (a row's 4 threads reduce by
    // shuffles), P = p (times the key's V scale on int8 pages).
#pragma unroll
    for (int rt = 0; rt < RTB; ++rt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = j * 8 + 2 * t + (e & 1);  // key within the tile
          const int key = tile * KT + kl;
          const int r = row0 + rt * 16 + g + 8 * (e >> 1);
          float x = sc[rt][j][e];
          if constexpr (kInt8) x *= __shfl_sync(0xffffffffu, sc_cur, kl);
          x *= sm_scale;
          if (key >= keys_end || key > pos0 + r / G) x = -INFINITY;
          sc[rt][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float mu[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[rt][h], mx[h]);
        const float alpha =
            m[rt][h] == -INFINITY ? 0.f : expf(m[rt][h] - m_new);
        mu[h] = m_new == -INFINITY ? 0.f : m_new;
        m[rt][h] = m_new;
        l[rt][h] *= alpha;
#pragma unroll
        for (int i = 0; i < NVT; ++i) {
          acc[rt][i][2 * h] *= alpha;
          acc[rt][i][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = expf(sc[rt][j][e] - mu[e >> 1]);       // masked: 0
          l[rt][e >> 1] += p;
          if constexpr (kInt8)
            p *= __shfl_sync(0xffffffffu, sc_cur,
                             16 + j * 8 + 2 * t + (e & 1));
          sc[rt][j][e] = p;
        }
    }

    // acc += P . V, P split into three bf16 parts (hi + mid + lo is p to
    // ~2^-25): the product keeps the f32 plain version's precision. p3
    // [rt][part] is an A fragment: f = (n-tile j, row half) gives a0
    // (rows g, keys 2t..), a1 (rows g+8), a2 (rows g, keys 2t+8..), a3.
    uint32_t p3[RTB][3][4];
#pragma unroll
    for (int rt = 0; rt < RTB; ++rt)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int j = f >> 1, e0 = (f & 1) * 2;
        float x0 = sc[rt][j][e0], x1 = sc[rt][j][e0 + 1];
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
          const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
          p3[rt][part][f] = pack_bf16(h0, h1);
          x0 -= __bfloat162float(h0);
          x1 -= __bfloat162float(h1);
        }
      }
    // V fragments four column tiles at a time, the next four loading
    // while this group's products run (lo parts first).
    constexpr int NG = DP / 64;
    uint32_t vf[2][4][4];
#pragma unroll
    for (int vg = 0; vg < NG; ++vg) {
#pragma unroll
      for (int ld = (vg == 0 ? 0 : 1); ld < 2; ++ld) {
        const int gl = vg + ld;
        if (gl < NG) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int vp = gl * 4 + jj;
            if (2 * vp < nvt)
              ldmatrix_x4_trans(
                  vf[gl & 1][jj],
                  vbb + swb((lane & 7) + 8 * ((lane >> 3) & 1),
                            (vp * 16 + 8 * (lane >> 4)) * 2, DP * 2));
          }
        }
      }
#pragma unroll
      for (int part = 2; part >= 0; --part)
#pragma unroll
        for (int rt = 0; rt < RTB; ++rt)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int vp = vg * 4 + jj;
            if (2 * vp < nvt) {
              mma_bf16(acc[rt][2 * vp], p3[rt][part], vf[vg & 1][jj][0],
                       vf[vg & 1][jj][1]);
              mma_bf16(acc[rt][2 * vp + 1], p3[rt][part], vf[vg & 1][jj][2],
                       vf[vg & 1][jj][3]);
            }
          }
    }
    sc_cur = sc_nxt;
    __syncwarp();                      // the stage (and buffer) is free
  }
  cp_async_wait<0>();

  // The warps' states -> shared, then merged in warp order.
#pragma unroll
  for (int rt = 0; rt < RTB; ++rt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[rt][h] += __shfl_xor_sync(0xffffffffu, l[rt][h], 1);
      l[rt][h] += __shfl_xor_sync(0xffffffffu, l[rt][h], 2);
    }
  __syncthreads();                     // every ring is drained
  float* mst = reinterpret_cast<float*>(sm + lay.merge);
  // A warp's state: acc rows of MS floats (8 more than DP: the 8 rows a
  // store of g = 0..7 writes fall in different banks), then m and l.
  constexpr int MS = DP + 8;
  const int WS = RB * (MS + 2);        // floats of one warp's state
  const int ML = RB * MS;              // offset of m (then l) in it
  {
    float* w = mst + warp * WS;        // [RB][MS] acc, [RB] m, [RB] l
#pragma unroll
    for (int rt = 0; rt < RTB; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rt * 16 + g + 8 * h;
#pragma unroll
        for (int i = 0; i < NVT; ++i)
          if (i < nvt)
            *reinterpret_cast<float2*>(w + r * MS + i * 8 + 2 * t) =
                make_float2(acc[rt][i][2 * h], acc[rt][i][2 * h + 1]);
        if (t == 0) {
          w[ML + r] = m[rt][h];
          w[ML + RB + r] = l[rt][h];
        }
      }
  }
  __syncthreads();
  // Per row: the common max, each warp's weight and the merged sum.
  for (int r = tid; r < RB; r += THREADS) {
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) mm = fmaxf(mm, mst[w * WS + ML + r]);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float mw = mst[w * WS + ML + r];
      const float a = mw == -INFINITY ? 0.f : expf(mw - mm);
      wts[r * WSTR + w] = a;
      den = fmaf(a, mst[w * WS + ML + RB + r], den);
    }
    wts[r * WSTR + WSTR - 2] = mm;
    wts[r * WSTR + WSTR - 1] = den;
  }
  __syncthreads();
  const int D4 = D / 4;
  float* pa = part_acc + ((size_t)unit * s.splits + z) * RB * D;
  float* pml = part_ml + ((size_t)unit * s.splits + z) * 2 * RB;
  for (int idx = tid; idx < RB * D4; idx += THREADS) {
    const int r = idx / D4, c = (idx % D4) * 4;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < W; ++w)
      fma4(wts[r * WSTR + w],
           *reinterpret_cast<const float4*>(mst + w * WS + r * MS + c), num);
    const int rr = row0 + r;
    if (nlive == 1) {
      if (rr < R)
        store_bf16x4(
            out + (((size_t)b * s.C + rr / G) * s.H + hkv * G + rr % G) * D +
                c,
            num, wts[r * WSTR + WSTR - 1]);
    } else {
      *reinterpret_cast<float4*>(pa + r * D + c) = num;
    }
  }
  if (nlive == 1) return;
  for (int r = tid; r < RB; r += THREADS) {
    pml[r] = wts[r * WSTR + WSTR - 2];
    pml[RB + r] = wts[r * WSTR + WSTR - 1];
  }

  // The last split block of this unit to finish (an atomic ticket)
  // merges the live splits' partials in split order.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(&tickets[unit], 1);
    *flag = ticket == nlive - 1;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* pa0 = part_acc + (size_t)unit * s.splits * RB * D;
  const float* pm0 = part_ml + (size_t)unit * s.splits * 2 * RB;
  for (int r = tid; r < RB; r += THREADS) {
    float mm = -INFINITY;
    for (int zz = 0; zz < nlive; ++zz)
      mm = fmaxf(mm, __ldcg(pm0 + (size_t)zz * 2 * RB + r));
    float den = 0.f;
    for (int zz = 0; zz < nlive; ++zz) {
      const float mz = __ldcg(pm0 + (size_t)zz * 2 * RB + r);
      const float a = mz == -INFINITY ? 0.f : expf(mz - mm);
      wts[r * WSTR + zz] = a;
      den = fmaf(a, __ldcg(pm0 + (size_t)zz * 2 * RB + RB + r), den);
    }
    wts[r * WSTR + WSTR - 1] = den;
  }
  __syncthreads();
  for (int idx = tid; idx < RB * D4; idx += THREADS) {
    const int r = idx / D4, c = (idx % D4) * 4;
    const int rr = row0 + r;
    if (rr >= R) continue;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int zz = 0; zz < nlive; ++zz)
      fma4(wts[r * WSTR + zz],
           __ldcg(reinterpret_cast<const float4*>(
               pa0 + (size_t)zz * RB * D + r * D + c)),
           num);
    store_bf16x4(
        out + (((size_t)b * s.C + rr / G) * s.H + hkv * G + rr % G) * D + c,
        num, wts[r * WSTR + WSTR - 1]);
  }
}

// Row tiles a block takes: two while the accumulators stay within 128
// registers a thread (DP <= 128), else one.
__host__ __device__ inline int rtb_for(int rows, int DP) {
  return (DP <= 128 && rows > 16) ? 2 : 1;
}
__host__ __device__ inline int dp_for(int D) { return (D + 63) / 64 * 64; }

template <typename TKV, int RTB, int DP>
int launch(const void* q, const void* kp, const void* vp, const __half* ks,
           const __half* vs, const int* tables, const int* positions,
           const int* lengths, void* out, float* part_acc, float* part_ml,
           int* tickets, TcShape sh, float sm_scale, cudaStream_t st) {
  const Layout lay = layout(RTB * 16, DP, (int)sizeof(TKV), sh.tps);
  // Opt in to the card's whole per-block limit once per instantiation
  // (the block's bytes grow with the split); the wrapper has checked
  // lay.total against that limit.
  static const cudaError_t opt_in = [] {
    int dev = 0, limit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(paged_gqa_tc_kernel<TKV, RTB, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    return e;
  }();
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid(sh.B * sh.Hkv * sh.row_groups, sh.splits);
  paged_gqa_tc_kernel<TKV, RTB, DP>
      <<<grid, 32 * warps_for(DP), lay.total, st>>>(
      static_cast<const bf16*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), ks, vs, tables, positions, lengths,
      static_cast<bf16*>(out), part_acc, part_ml, tickets, sh, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV>
int dispatch(const void* q, const void* kp, const void* vp, const __half* ks,
             const __half* vs, const int* tables, const int* positions,
             const int* lengths, void* out, float* part_acc, float* part_ml,
             int* tickets, TcShape sh, float sm_scale, cudaStream_t st) {
  const int dp = dp_for(sh.D);
  const int rtb = rtb_for(sh.C * (sh.H / sh.Hkv), dp);
#define REPRO_GQA_TC(RTB, DP)                                              \
  if (rtb == RTB && dp == DP)                                              \
  return launch<TKV, RTB, DP>(q, kp, vp, ks, vs, tables, positions, lengths, \
                              out, part_acc, part_ml, tickets, sh, sm_scale, \
                              st)
  REPRO_GQA_TC(1, 64);
  REPRO_GQA_TC(2, 64);
  REPRO_GQA_TC(1, 128);
  REPRO_GQA_TC(2, 128);
  REPRO_GQA_TC(1, 192);
  REPRO_GQA_TC(1, 256);
#undef REPRO_GQA_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gtc

// ---------------------------------------------------------------------
// MLA form on f32 pages: shared K/V pages plus the RoPE score side on
// the CUDA cores (see the top note).
// ---------------------------------------------------------------------
constexpr int MLA_RT = 32;             // query rows of a block
constexpr int MLA_COLS = 2;            // output columns a thread owns
constexpr int MLA_MAX_D1 = THREADS * MLA_COLS;
constexpr int MLA_LOADS = 8;           // q rows' loads in flight a thread
constexpr int MLA_PAGE_LOADS = 4;      // keys' loads in flight a thread
constexpr int MLA_MERGE_THREADS = MLA_MAX_D1 / 4;
constexpr int MLA_MAX_SPLITS = 16;     // bounds the partials' memory

struct MlaShape {
  int B, C, H, Hkv, D1, D2, bs, MB;
  int splits;                          // launched: the most a step takes
  int sms, row_tiles;
  int KS;                              // staged row stride (floats)
};

// 4 consecutive f32 (one 16-byte load; the wrapper checks the
// alignment).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The tile a block works on, and whether any of its rows is valid.
struct MlaTile {
  int b, hkv, tile, r0, pos0, last_live, e_max;
  bool live;
};

__device__ __forceinline__ MlaTile mla_tile(const MlaShape& s, int bx,
                                            const int* positions,
                                            const int* lengths) {
  MlaTile t;
  const int G = s.H / s.Hkv;
  t.tile = bx % s.row_tiles;
  const int bh = bx / s.row_tiles;
  t.b = bh / s.Hkv;
  t.hkv = bh % s.Hkv;
  t.r0 = t.tile * MLA_RT;
  t.pos0 = positions[t.b];
  const int len1 = max(lengths[t.b], 1);
  t.live = t.r0 / G < len1;
  t.last_live = min((t.pos0 + len1 - 1) / s.bs, s.MB - 1);
  // Deepest chunk entry among the tile's rows: no row of the tile sees a
  // key past pos0 + e_max.
  t.e_max = min((t.r0 + MLA_RT - 1) / G, s.C - 1);
  return t;
}

// Flat (slot, chunk entry, head) index of row r of the tile.
__device__ __forceinline__ size_t mla_head(const MlaTile& t,
                                           const MlaShape& s, int G, int r) {
  const int rr = t.r0 + r, i = rr / G, g = rr - i * G;
  return ((size_t)t.b * s.C + i) * s.H + t.hkv * G + g;
}

// This step's (pages per split, splits). Every block of the walk
// computes the same from positions and lengths: W, the pages that all
// live tiles walk, and per = ceil(W / (2 * SMs)) pages per split, so no
// split's run is much longer than the average load of the card's two
// resident blocks per SM, and a step with little work is split finely.
// Never more splits than were launched. `red` is WARPS ints of shared
// memory.
struct MlaSplit {
  int per, splits;
};

__device__ __forceinline__ MlaSplit mla_split(const MlaShape& s,
                                              const int* positions,
                                              const int* lengths, int* red) {
  int w = 0;
  for (int i = threadIdx.x; i < s.B * s.Hkv * s.row_tiles; i += THREADS) {
    const MlaTile t = mla_tile(s, i, positions, lengths);
    if (t.live) w += min(t.last_live, (t.pos0 + t.e_max) / s.bs) + 1;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) w += __shfl_down_sync(0xffffffffu, w, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = w;
  __syncthreads();
  int work = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) work += red[k];
  const int slots = 2 * s.sms;
  const int per = min(s.MB, max((work + slots - 1) / slots,
                                (s.MB + s.splits - 1) / s.splits));
  return MlaSplit{per, (s.MB + per - 1) / per};
}

__global__ void __launch_bounds__(THREADS, 2)
paged_attention_mla_kernel(const float* __restrict__ q,
                           const float* __restrict__ q2,
                           const float* __restrict__ k_pages,
                           const float* __restrict__ k2_pages,
                           const int* __restrict__ tables,
                           const int* __restrict__ positions,
                           const int* __restrict__ lengths,
                           float* __restrict__ out,
                           float* __restrict__ part_acc,
                           float* __restrict__ part_ml, MlaShape s,
                           float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int D1 = s.D1, D2 = s.D2, KS = s.KS, bs = s.bs;
  const int W1 = D1 / 4, WT = (D1 + D2) / 4;   // 16-byte columns
  const int G = s.H / s.Hkv;
  const int R = s.C * G;
  float* q_sh = smem;                    // [RT][KS]  [q | q2] rows
  float* k_sh = q_sh + MLA_RT * KS;      // [bs][KS]  [ckv | krope] keys
  float* pt_sh = k_sh + bs * KS;         // [bs][RT]  scores, then probs
  float* m_sh = pt_sh + bs * MLA_RT;     // [RT] running max
  float* l_sh = m_sh + MLA_RT;           // [RT] running sum
  float* a_sh = l_sh + MLA_RT;           // [RT] rescale of this page
  int* red = reinterpret_cast<int*>(a_sh + MLA_RT);  // [WARPS] split sums

  const MlaTile tl = mla_tile(s, blockIdx.x, positions, lengths);
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int rows = min(MLA_RT, R - tl.r0);  // rows of the tile that exist
  if (!tl.live) {                        // every row garbage: write 0
    if (split == 0)
      for (int r = 0; r < rows; ++r) {
        float* o = out + mla_head(tl, s, G, r) * D1;
        for (int c = tid; c < D1; c += THREADS) o[c] = 0.f;
      }
    return;
  }
  const MlaSplit sp = mla_split(s, positions, lengths, red);
  // Tile 0 is always live: its first block leaves the step's split count
  // after the partials for the merge.
  if (s.splits > 1 && blockIdx.x == 0 && split == 0 && tid == 0)
    *reinterpret_cast<int*>(part_ml + (size_t)gridDim.x * s.splits * 2 *
                                          MLA_RT) = sp.splits;
  if (split >= sp.splits) return;        // a split this step does not take
  const int j_begin = split * sp.per;
  const int j_end = min(min(tl.last_live, (tl.pos0 + tl.e_max) / bs) + 1,
                        j_begin + sp.per);
  if (j_begin >= j_end) {                // a split past the tile's walk
    float* pml = part_ml + ((size_t)blockIdx.x * s.splits + split) * 2 *
                               MLA_RT;
    for (int r = tid; r < MLA_RT; r += THREADS) {
      pml[r] = -INFINITY;
      pml[MLA_RT + r] = 0.f;
    }
    return;
  }

  // [q | q2] rows of the tile -> shared: thread c4 copies 16-byte column
  // c4 of every row, MLA_LOADS rows' loads in flight at a time (a chain
  // of dependent load-store pairs would wait out the memory latency once
  // per element); rows past R are 0.
  for (int c4 = tid; c4 < WT; c4 += THREADS) {
    for (int r0 = 0; r0 < MLA_RT; r0 += MLA_LOADS) {
      float4 buf[MLA_LOADS];
#pragma unroll
      for (int u = 0; u < MLA_LOADS; ++u) {
        buf[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + u < rows) {
          const size_t head = mla_head(tl, s, G, r0 + u);
          buf[u] = c4 < W1 ? load4(q + head * D1 + 4 * c4)
                           : load4(q2 + head * D2 + 4 * (c4 - W1));
        }
      }
#pragma unroll
      for (int u = 0; u < MLA_LOADS; ++u)
        *reinterpret_cast<float4*>(&q_sh[(r0 + u) * KS + 4 * c4]) = buf[u];
    }
  }
  for (int r = tid; r < MLA_RT; r += THREADS) {
    m_sh[r] = -INFINITY;
    l_sh[r] = 0.f;
  }
  float acc[MLA_RT][MLA_COLS];
#pragma unroll
  for (int r = 0; r < MLA_RT; ++r)
#pragma unroll
    for (int ci = 0; ci < MLA_COLS; ++ci) acc[r][ci] = 0.f;
  __syncthreads();

  for (int j = j_begin; j < j_end; ++j) {
    const size_t page = (size_t)tables[(size_t)tl.b * s.MB + j];
    // Keys of this page some row of the tile may see.
    const int t_end = min(bs, tl.pos0 + tl.e_max - j * bs + 1);
    // [ckv | krope] rows of the page -> shared, once: thread c4 copies
    // column c4 of each key, MLA_PAGE_LOADS keys' loads in flight.
    for (int c4 = tid; c4 < WT; c4 += THREADS) {
      for (int t0 = 0; t0 < t_end; t0 += MLA_PAGE_LOADS) {
        float4 buf[MLA_PAGE_LOADS];
#pragma unroll
        for (int u = 0; u < MLA_PAGE_LOADS; ++u) {
          if (t0 + u >= t_end) break;
          const size_t row = (page * bs + t0 + u) * s.Hkv + tl.hkv;
          buf[u] = c4 < W1 ? load4(k_pages + row * D1 + 4 * c4)
                           : load4(k2_pages + row * D2 + 4 * (c4 - W1));
        }
#pragma unroll
        for (int u = 0; u < MLA_PAGE_LOADS; ++u) {
          if (t0 + u >= t_end) break;
          *reinterpret_cast<float4*>(&k_sh[(t0 + u) * KS + 4 * c4]) = buf[u];
        }
      }
    }
    __syncthreads();
    // Scores: thread (key t, rows ra and ra + 16).
    {
      const int ra = tid / 16;
      for (int t = tid % 16; t < t_end; t += 16) {
        const float* kt = k_sh + t * KS;
        const float* qa = q_sh + ra * KS;
        const float* qb = q_sh + (ra + 16) * KS;
        // Two chains per row (the x/z and y/w lanes of each 16-byte
        // load), so four independent FMA chains per thread.
        float da0 = 0.f, da1 = 0.f, db0 = 0.f, db1 = 0.f;
#pragma unroll 4
        for (int c4 = 0; c4 < WT; ++c4) {
          const float4 kv = *reinterpret_cast<const float4*>(kt + 4 * c4);
          const float4 xa = *reinterpret_cast<const float4*>(qa + 4 * c4);
          const float4 xb = *reinterpret_cast<const float4*>(qb + 4 * c4);
          da0 = fmaf(xa.x, kv.x, da0); da1 = fmaf(xa.y, kv.y, da1);
          da0 = fmaf(xa.z, kv.z, da0); da1 = fmaf(xa.w, kv.w, da1);
          db0 = fmaf(xb.x, kv.x, db0); db1 = fmaf(xb.y, kv.y, db1);
          db0 = fmaf(xb.z, kv.z, db0); db1 = fmaf(xb.w, kv.w, db1);
        }
        const int ki = j * bs + t;
        pt_sh[t * MLA_RT + ra] = ki <= tl.pos0 + (tl.r0 + ra) / G
                                     ? (da0 + da1) * sm_scale : -INFINITY;
        pt_sh[t * MLA_RT + ra + 16] =
            ki <= tl.pos0 + (tl.r0 + ra + 16) / G ? (db0 + db1) * sm_scale
                                                  : -INFINITY;
      }
    }
    __syncthreads();
    // Online-softmax statistics: one thread per row.
    if (tid < MLA_RT) {
      const int r = tid;
      float mx = -INFINITY;
      for (int t = 0; t < t_end; ++t) mx = fmaxf(mx, pt_sh[t * MLA_RT + r]);
      const float m_old = m_sh[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = 0; t < t_end; ++t) {
        const float sv = pt_sh[t * MLA_RT + r];
        const float pv = (sv == -INFINITY) ? 0.f : expf(sv - m_new);
        pt_sh[t * MLA_RT + r] = pv;
        sum += pv;
      }
      const float alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
      a_sh[r] = alpha;
      l_sh[r] = l_sh[r] * alpha + sum;
      m_sh[r] = m_new;
    }
    __syncthreads();
    // acc = acc * alpha + P . ckv (the staged page's first D1 columns).
#pragma unroll
    for (int r = 0; r < MLA_RT; ++r) {
      const float a = a_sh[r];
#pragma unroll
      for (int ci = 0; ci < MLA_COLS; ++ci) acc[r][ci] *= a;
    }
    for (int t = 0; t < t_end; ++t) {
      float v[MLA_COLS];
#pragma unroll
      for (int ci = 0; ci < MLA_COLS; ++ci) {
        const int c = tid + ci * THREADS;
        v[ci] = c < D1 ? k_sh[t * KS + c] : 0.f;
      }
      const float* pr = pt_sh + t * MLA_RT;
#pragma unroll
      for (int r = 0; r < MLA_RT; r += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pr + r);
#pragma unroll
        for (int ci = 0; ci < MLA_COLS; ++ci) {
          acc[r][ci] = fmaf(p4.x, v[ci], acc[r][ci]);
          acc[r + 1][ci] = fmaf(p4.y, v[ci], acc[r + 1][ci]);
          acc[r + 2][ci] = fmaf(p4.z, v[ci], acc[r + 2][ci]);
          acc[r + 3][ci] = fmaf(p4.w, v[ci], acc[r + 3][ci]);
        }
      }
    }
    __syncthreads();
  }

  if (sp.splits == 1) {
#pragma unroll
    for (int r = 0; r < MLA_RT; ++r) {
      if (r >= rows) break;
      const float l = l_sh[r];
      float* o = out + mla_head(tl, s, G, r) * D1;
#pragma unroll
      for (int ci = 0; ci < MLA_COLS; ++ci) {
        const int c = tid + ci * THREADS;
        if (c < D1) o[c] = acc[r][ci] / (l == 0.f ? 1.f : l);
      }
    }
    return;
  }
  // Partials of this split: acc [RT][D1], then (max, sum) per row (a
  // split past the walk left max -inf above, and the merge never reads
  // its acc).
  const size_t slot = (size_t)blockIdx.x * s.splits + split;
  float* pa = part_acc + slot * MLA_RT * D1;
#pragma unroll
  for (int r = 0; r < MLA_RT; ++r)
#pragma unroll
    for (int ci = 0; ci < MLA_COLS; ++ci) {
      const int c = tid + ci * THREADS;
      if (c < D1) pa[r * D1 + c] = acc[r][ci];
    }
  float* pml = part_ml + slot * 2 * MLA_RT;
  for (int r = tid; r < MLA_RT; r += THREADS) {
    pml[r] = m_sh[r];
    pml[MLA_RT + r] = l_sh[r];
  }
}

// Merge the splits of one row of a live tile (block (tile, row), thread
// c4 owns 4 output columns), in split order, and normalize; a garbage
// tile was written as 0 by the walk's split 0, and a step of one split
// (the count the walk left after the partials) by the walk itself. One
// block per row keeps enough partial loads in flight to hide their
// latency.
__global__ void __launch_bounds__(MLA_MERGE_THREADS)
paged_attention_mla_merge(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          const int* __restrict__ positions,
                          const int* __restrict__ lengths,
                          float* __restrict__ out, MlaShape s) {
  const MlaTile tl = mla_tile(s, blockIdx.x, positions, lengths);
  const int r = blockIdx.y;
  const int D1 = s.D1, G = s.H / s.Hkv, R = s.C * G;
  const int c = 4 * threadIdx.x;
  const int splits = *reinterpret_cast<const int*>(
      part_ml + (size_t)gridDim.x * s.splits * 2 * MLA_RT);
  if (splits == 1 || !tl.live || tl.r0 + r >= R || c >= D1) return;
  const size_t base = (size_t)blockIdx.x * s.splits;
  float m = -INFINITY;
  for (int z = 0; z < splits; ++z)
    m = fmaxf(m, part_ml[(base + z) * 2 * MLA_RT + r]);
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  if (m != -INFINITY) {
    for (int z = 0; z < splits; ++z) {
      const float mz = part_ml[(base + z) * 2 * MLA_RT + r];
      if (mz == -INFINITY) continue;
      const float w = expf(mz - m);
      den = fmaf(w, part_ml[(base + z) * 2 * MLA_RT + MLA_RT + r], den);
      const float4 a = *reinterpret_cast<const float4*>(
          part_acc + ((base + z) * MLA_RT + r) * D1 + c);
      num.x = fmaf(w, a.x, num.x);
      num.y = fmaf(w, a.y, num.y);
      num.z = fmaf(w, a.z, num.z);
      num.w = fmaf(w, a.w, num.w);
    }
  }
  const float d = den == 0.f ? 1.f : den;
  *reinterpret_cast<float4*>(out + mla_head(tl, s, G, r) * D1 + c) =
      make_float4(num.x / d, num.y / d, num.z / d, num.w / d);
}

int launch_mla(const float* q, const float* q2, const float* kp,
               const float* k2p, const int* tables, const int* positions,
               const int* lengths, float* out, float* part_acc,
               float* part_ml, MlaShape sh, float sm_scale, size_t smem,
               cudaStream_t st) {
  if (smem > 48 * 1024) {
    static const cudaError_t opt_in = [] {
      int dev = 0, limit = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(paged_attention_mla_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 limit);
      return e;
    }();
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  }
  const dim3 grid(sh.B * sh.Hkv * sh.row_tiles, sh.splits);
  paged_attention_mla_kernel<<<grid, THREADS, smem, st>>>(
      q, q2, kp, k2p, tables, positions, lengths, out, part_acc, part_ml, sh,
      sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sh.splits == 1) return static_cast<int>(err);
  const dim3 merge_grid(sh.B * sh.Hkv * sh.row_tiles, MLA_RT);
  paged_attention_mla_merge<<<merge_grid, MLA_MERGE_THREADS, 0, st>>>(
      part_acc, part_ml, positions, lengths, out, sh);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// MLA form on bf16 or int8 pages: tensor-core products, 64-row tiles
// (see the top note).
// ---------------------------------------------------------------------
namespace mtc {

constexpr int RT = 64;                 // query rows of a row tile
constexpr int KT = 16;                 // keys of a tile
constexpr int NS = 3;                  // stages of the key ring
constexpr int WARPS = 16;              // 4 row groups x 4 column quarters
constexpr int THREADS = 32 * WARPS;
constexpr int XW = 256;                // floats of a warp's score share
constexpr int MAX_SPLITS = 16;         // bounds the partials' memory
constexpr int NQ = 3;                  // bf16 parts of the f32 queries
constexpr int NP = 3;                  // bf16 parts of p
constexpr int WSTR = MAX_SPLITS + 1;   // merge weights row: [split] den
constexpr int MAX_D2 = 256;
constexpr float LOG2E = 1.4426950408889634f;

// A call may be one shard of a whole call: its B slots are slots
// [slot0, slot0 + B) of the whole call's Bw, and its G = H / Hkv query
// heads of a kv head are heads [g0, g0 + G) of the whole call's Gw. The
// step is planned, and every row's page walk split, as the whole call's;
// the shard walks only the row tiles that hold its rows. A whole call is
// the shard with Bw = B, slot0 = 0, Gw = G, g0 = 0.
struct Shape {
  int B, C, H, Hkv, D1, D2, bs, MB;
  int splits;                          // the most a step takes (partials)
  int row_tiles, units;                // the whole call's: Bw * Hkv * row_tiles
  int Bw, slot0, Gw, g0;
};

// Staged feature width: [ckv | krope] rounded up to 64 (zero columns).
__host__ __device__ constexpr int feat_width(int D1, int D2) {
  return (D1 + D2 + 63) / 64 * 64;
}

// Shared-memory layout of one block (bytes); FT = feat_width, ES = bytes
// of a page element, U = units, B = slots: it does not grow with the
// table's width (page ids are read from the table in global memory).
// After a walk, the merge stages the partials where the q rows and the
// ring were, and their (max, sum) rows and weights in xch.
struct Layout {
  int q, ring, conv, xch, off, pl, red, total;
};

__host__ __device__ inline Layout layout(int FT, int ES, int U, int B) {
  Layout L{};
  L.q = 0;                                        // [RT][FT + 8] f32
  L.ring = gtc::align128(RT * (FT + 8) * 4);      // NS x [KT][FT] pages
  L.conv = L.ring + NS * KT * FT * ES;            // int8: [KT][FT] bf16
  L.xch = L.conv + (ES == 1 ? KT * FT * 2 : 0);   // [WARPS][XW] f32
  L.off = L.xch + WARPS * XW * 4;                 // [U + 1] first items
  L.pl = L.off + gtc::align128((U + 1) * 4);      // [B] positions, lengths
  L.red = L.pl + gtc::align128(2 * B * 4);        // the step's per
  L.total = L.red + 16;
  return L;
}

// Keys the walk of row tile `tile` of a slot must cover: the deepest
// causal depth among its rows of valid chunk entries; 0 when every row
// lies past max(len, 1) (garbage by contract: the tile reads no page).
__device__ __forceinline__ int walk_keys(int tile, int pos0, int len, int C,
                                         int G, int MB, int bs) {
  const int len1 = len > 1 ? len : 1;
  const int r0 = tile * RT;
  if (r0 / G >= len1) return 0;
  int e_end = (r0 + RT - 1) / G + 1;   // one past the deepest entry
  e_end = e_end < C ? e_end : C;
  const int keys = pos0 + (e_end < len1 ? e_end : len1);
  return keys < MB * bs ? keys : MB * bs;
}

// The shard's rows in row tile `tile` of the whole call (of one slot and
// kv head): a run [x, x + y) of the shard's C * G rows (y = 0: none).
// The run is contiguous: the entries the tile meets hold the shard's
// heads [g0, g0 + G) each, and only the first and last entry can be cut.
__device__ __forceinline__ int2 shard_rows(int tile, int C, int G, int Gw,
                                           int g0) {
  const int w0 = tile * RT, w1 = min(w0 + RT, C * Gw);
  if (G == Gw) return make_int2(w0, w1 - w0);
  int first = 0, count = 0;
  for (int i = w0 / Gw; i * Gw < w1; ++i) {
    const int lo = max(w0, i * Gw + g0), hi = min(w1, i * Gw + g0 + G);
    if (lo < hi) {
      if (count == 0) first = i * G + lo - i * Gw - g0;
      count += hi - lo;
    }
  }
  return make_int2(first, count);
}

// A step's split: `per` key tiles a split. The launch holds one block
// per SM (`sms`), and every split of a tile merges the tile's partials
// after all of them are written, so all items of a step must run at
// once: per is the fewest tiles, from per_floor up, whose items fit the
// SMs, or the whole walk (one split a tile, nothing merged) when even
// that needs more (a binary search: the step's items at p tiles a split
// never grow with p). The least `per`: work / SMs (work: the key tiles
// all live row tiles walk), no more splits than the partials hold, at
// most maxt.
__device__ __forceinline__ int per_floor(int work, int maxt, int most,
                                         int sms) {
  int lo = (work + sms - 1) / sms;
  const int fit = (maxt + most - 1) / most;
  lo = lo > fit ? lo : fit;
  return lo < maxt ? lo : maxt;
}

__host__ __device__ inline int max_splits(int MB, int bs) {
  const int maxt = (MB * bs + KT - 1) / KT;
  return maxt < MAX_SPLITS ? maxt : MAX_SPLITS;
}

// x0, x1 split into N bf16 pairs a[0..N)[f] (x0 in the low halves)
// whose sum is (x0, x1) to ~2^(-8N - 1) relative: each part is the
// previous remainder rounded, and each remainder is exact in f32.
template <int N>
__device__ __forceinline__ void split_into(float x0, float x1,
                                           uint32_t (&a)[N][4], int f) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i][f] = bf16x2(x0, x1);
    x0 -= __uint_as_float(a[i][f] << 16);
    x1 -= __uint_as_float(a[i][f] & 0xffff0000u);
  }
}

// The launch: one block per SM. Each block plans the step from the whole
// call's row tiles and depths (block 0 writes the plan it took to
// plan_out: key tiles a split, the shard's items, the most splits of a
// row tile), then walks the items
// i = blockIdx.x, i + gridDim.x, ... of the step's list (split z of live
// row tile u, in (u, z) order), then writes the row tiles u = blockIdx.x,
// ... whose rows are all garbage as 0. Warp w of a block: rows 16 (w % 4)
// .. + 15 of the tile, output columns D1 / 4 * (w / 4) .. + D1 / 4, and
// a quarter of the score's features.
template <typename TKV, int D1, bool kShard>
__global__ void __launch_bounds__(THREADS, 1)
paged_mla_tc_kernel(const float* __restrict__ q, const float* __restrict__ q2,
                    const TKV* __restrict__ k_pages,
                    const TKV* __restrict__ k2_pages,
                    const __half* __restrict__ k_scales,
                    const __half* __restrict__ k2_scales,
                    const int* __restrict__ tables,
                    const int* __restrict__ positions,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int* __restrict__ tickets,
                    int* __restrict__ plan_out, Shape s, float sm_scale) {
  constexpr bool kInt8 = sizeof(TKV) == 1;
  constexpr int ES = sizeof(TKV);
  constexpr int QC = D1 / 4;           // output columns of a warp
  constexpr int NT = QC / 8;           // ... in 8-column tiles
  static_assert(D1 % 32 == 0, "a warp's columns are whole 8-column tiles");
  static_assert(KT == WARPS, "one key of a tile a warp");
  constexpr int D4 = D1 / 4;           // float4s of an output row
  extern __shared__ __align__(128) unsigned char sm[];
  const int D2 = s.D2, bs = s.bs, U = s.units;
  const int FT = feat_width(D1, D2), QS = FT + 8, RB = FT * ES;
  const Layout lay = layout(FT, ES, U, s.Bw);
  float* q_sh = reinterpret_cast<float*>(sm + lay.q);
  unsigned char* ring = sm + lay.ring;
  float* xch = reinterpret_cast<float*>(sm + lay.xch);
  int* off = reinterpret_cast<int*>(sm + lay.off);
  int* red = reinterpret_cast<int*>(sm + lay.red);  // [2][WARPS], flag
  const int G = s.H / s.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, cq = warp >> 2;
  // A whole call (kShard false) compiles to the unsharded walk: every
  // unit is its own, a tile's rows its own 64.
  const int Bw = kShard ? s.Bw : s.B, Gw = kShard ? s.Gw : G;
  const int slot0 = kShard ? s.slot0 : 0;
  // The whole call's positions and lengths: [Bw], then [Bw].
  int* pos_sh = reinterpret_cast<int*>(sm + lay.pl);
  for (int i = tid; i < Bw; i += THREADS) {
    pos_sh[i] = positions[i];
    pos_sh[Bw + i] = lengths[i];
  }
  __syncthreads();
  // Whole-call unit u: (slot, kv head, row tile); the shard's own are
  // those of its slots that hold some of its rows.
  const int u_lo = slot0 * s.Hkv * s.row_tiles;
  const int u_hi = kShard ? (slot0 + s.B) * s.Hkv * s.row_tiles : U;
  auto rows_of = [&](int u) -> int2 {
    const int tile = u % s.row_tiles;
    if constexpr (kShard) return shard_rows(tile, s.C, G, Gw, s.g0);
    return make_int2(tile * RT, min(RT, s.C * G - tile * RT));
  };

  // The step's plan and item list, the same in every block, made by warp
  // 0: unit u's splits are items off[u] .. off[u + 1] - 1 (none for a
  // unit that is not the shard's). Lane l owns units [l * cpl, (l + 1) *
  // cpl) and keeps their walk tiles in off[] first; `per` follows every
  // whole-call unit's walk, the items only the shard's.
  if (warp == 0) {
    auto warp_sum = [&](int v) -> int {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      return v;
    };
    const int cpl = (U + 31) / 32;
    const int ub = min(U, lane * cpl), ue = min(U, ub + cpl);
    int work = 0;
    for (int u = ub; u < ue; ++u) {
      const int b = u / s.row_tiles / s.Hkv;
      off[u] = (walk_keys(u % s.row_tiles, pos_sh[b], pos_sh[Bw + b], s.C,
                          Gw, s.MB, bs) + KT - 1) / KT;
      work += off[u];
    }
    const int maxt = (s.MB * bs + KT - 1) / KT;
    int per = per_floor(warp_sum(work), maxt, s.splits, gridDim.x);
    for (int hi = maxt; per < hi;) {
      const int mid = (per + hi) / 2;
      int n = 0;
      for (int u = ub; u < ue; ++u) n += (off[u] + mid - 1) / mid;
      if (warp_sum(n) <= (int)gridDim.x) hi = mid; else per = mid + 1;
    }
    auto splits_of = [&](int u) -> int {
      if constexpr (kShard)
        if (u < u_lo || u >= u_hi || rows_of(u).y == 0) return 0;
      return (off[u] + per - 1) / per;
    };
    int items = 0, most = 0;           // this lane's units' splits
    for (int u = ub; u < ue; ++u) {
      const int n = splits_of(u);
      items += n;
      most = max(most, n);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      most = max(most, __shfl_xor_sync(0xffffffffu, most, o));
    int incl = items;                  // inclusive scan over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int first = incl - items;
    for (int u = ub; u < ue; ++u) {
      const int n = splits_of(u);
      off[u] = first;
      first += n;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (lane == 0) {
      off[U] = total;
      red[0] = per;
      if (blockIdx.x == 0) {
        plan_out[0] = per;
        plan_out[1] = total;
        plan_out[2] = most;
      }
    }
  }
  __syncthreads();
  const int per = red[0], total = off[U];

  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    // Unit u: the last with off[u] <= item.
    int lo = 0, hi = U - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= item) lo = mid; else hi = mid - 1;
    }
    const int z = item - off[lo];
    const int nlive = off[lo + 1] - off[lo];
    const int tile = lo % s.row_tiles, bh = lo / s.row_tiles;
    const int bw = bh / s.Hkv, hkv = bh % s.Hkv, b = bw - slot0;
    const int unit = lo - u_lo;        // the shard's partials and tickets
    // The shard's rows of the tile: [r0, r0 + rows) of its C * G.
    const int2 run = rows_of(lo);
    const int r0 = run.x, rows = run.y;
    const int pos0 = pos_sh[bw];
    const int wk = walk_keys(tile, pos0, pos_sh[Bw + bw], s.C, Gw, s.MB, bs);
    const int ntile = (wk + KT - 1) / KT;
    // Flat (slot, chunk entry, head) index of row r of the tile.
    auto head = [&](int r) -> size_t {
      const int rr = r0 + r, i = rr / G;
      return ((size_t)b * s.C + i) * s.H + hkv * G + (rr - i * G);
    };
    // Split z of the tile's nlive splits: its share of the walk's tiles,
    // as even as the tiles allow.
    const int each = (ntile + nlive - 1) / nlive;
    const int t_begin = z * each;
    const int my_n = max(0, min(ntile, t_begin + each) - t_begin);
    // Keys of this split: [t_begin KT, kend). Pages past it are never
    // touched, and the keys of its last tile past it are zero-filled,
    // never loaded.
    const int kend = min(wk, (t_begin + my_n) * KT);

    // The page of key kk of tile n of the split, read from the table in
    // global memory a tile before the page is (so its latency hides
    // behind a tile's products); -1 past the split's keys (never read).
    auto page_of = [&](int n, int kk) -> int {
      const int key = (t_begin + n) * KT + kk;
      return n < my_n && key < kend ? tables[(size_t)b * s.MB + key / bs]
                                    : -1;
    };
    // Tile n of the split -> stage n % NS, key `warp` of it (on page
    // `page`) by warp `warp`: ckv at row bytes [0, D1 ES), krope after
    // it, zero to FT (bf16 swizzled for ldmatrix; int8 codes as they
    // are, converted below).
    auto issue = [&](int n, int page) {
      if (n < my_n) {
        unsigned char* dst = ring + (n % NS) * KT * RB;
        const int cpr = RB / 16, c1 = D1 * ES / 16;
        const int c2 = (D1 + D2) * ES / 16;
        const int kk = warp, key = (t_begin + n) * KT + kk;
        const unsigned char* kr =
            reinterpret_cast<const unsigned char*>(k_pages);
        const unsigned char* k2r = kr;
        if (page >= 0) {
          const size_t row = ((size_t)page * bs + key % bs) * s.Hkv + hkv;
          kr += row * D1 * ES;
          k2r = reinterpret_cast<const unsigned char*>(k2_pages) +
                row * D2 * ES;
        }
        for (int c = lane; c < cpr; c += 32) {
          unsigned char* d =
              dst + (kInt8 ? kk * RB + 16 * c : gtc::swb(kk, 16 * c, RB));
          if (page >= 0 && c < c2)
            cp_async16(d, c < c1 ? kr + 16 * c : k2r + 16 * (c - c1));
          else
            *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
        }
      }
      cp_async_commit();               // empty groups keep the count
    };
    // int8: lane l < 16 holds the ckv scale of key l of tile n (on page
    // `page`, page_of(n, l)), lane 16 + l its krope scale (0 past the
    // split's keys: never loaded).
    auto scale_at = [&](int n, int page) -> float {
      if (!kInt8 || page < 0 || (lane >= 16 && D2 == 0)) return 0.f;
      const int key = (t_begin + n) * KT + (lane & 15);
      const size_t row = ((size_t)page * bs + key % bs) * s.Hkv + hkv;
      return __half2float((lane < 16 ? k_scales : k2_scales)[row]);
    };

    // The causal limit of this thread's rows g and g + 8 (-1: a pad
    // row).
    int lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rg * 16 + g + 8 * h;
      lim[h] = r < rows ? pos0 + (r0 + r) / G : -1;
    }
    // The 16-feature steps of the score this warp sums: a quarter of
    // [ckv | krope] (9 of 36 at rank 512, rope 64); ckv steps before K1.
    const int K1 = D1 / 16, KS = (D1 + D2) / 16;
    const int ks0 = cq * KS / 4, ks1 = (cq + 1) * KS / 4;
    const float* qa = q_sh + (rg * 16 + g) * QS + 2 * t;
    const float sl2 = sm_scale * LOG2E;  // scores in log2 units

    float acc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // NS - 1 tiles in flight ahead of the one computed; the tile's
    // [q | q2] rows (f32; rows past the run and columns past D1 + D2 zero; warp
    // w stages rows w, w + 16, ...) and the first one are one group. The
    // first NS tiles' page ids (this warp's key's; int8: also lane
    // l % 16's key's, for the scales) load while the q rows are issued.
    int pk[NS], ps[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      pk[n] = page_of(n, warp);
      ps[n] = kInt8 ? page_of(n, lane & 15) : -1;
    }
    {
      const int c1 = D1 / 4, c2 = (D1 + D2) / 4, cpr = FT / 4;
      for (int r = warp; r < RT; r += WARPS) {
        const bool row_ok = r < rows;
        const float* qr = row_ok ? q + head(r) * D1 : q;
        const float* q2r = row_ok ? q2 + head(r) * D2 : q;
        for (int c = lane; c < cpr; c += 32) {
          float* dst = q_sh + r * QS + 4 * c;
          if (row_ok && c < c2)
            cp_async16(dst, c < c1 ? qr + 4 * c : q2r + 4 * (c - c1));
          else
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      issue(0, pk[0]);
    }
#pragma unroll
    for (int n = 1; n < NS - 1; ++n) issue(n, pk[n]);
    static_assert(NS == 3, "two scales ahead of the tile computed");
    float sc0 = scale_at(0, ps[0]), sc1 = scale_at(1, ps[1]);
    // The pages of the next tile to issue.
    int pk_next = pk[NS - 1], ps_next = ps[NS - 1];

    for (int n = 0; n < my_n; ++n) {
      cp_async_wait<NS - 2>();         // tile n (and q), this thread's part
      __syncthreads();                 // ... every thread's; tile n - 1 done
      issue(n + NS - 1, pk_next);      // into the stage tile n - 1 left
      const float sc2 = scale_at(n + NS - 1, ps_next);  // in flight meanwhile
      pk_next = page_of(n + NS, warp);
      if constexpr (kInt8) ps_next = page_of(n + NS, lane & 15);
      const unsigned char* kb = ring + (n % NS) * KT * RB;
      if constexpr (kInt8) {
        // Codes -> bf16 (exact: |code| <= 127), once for the block.
        unsigned char* conv = sm + lay.conv;
        const int cpr = FT / 16;
        for (int idx = tid; idx < KT * cpr; idx += THREADS) {
          const int kk = idx / cpr, c = idx - kk * cpr;
          uint32_t cv[8];
          q8_0_codes(*reinterpret_cast<const int4*>(kb + kk * RB + c * 16),
                     cv);
          *reinterpret_cast<uint4*>(conv + gtc::swb(kk, c * 32, FT * 2)) =
              make_uint4(cv[0], cv[1], cv[2], cv[3]);
          *reinterpret_cast<uint4*>(conv +
                                    gtc::swb(kk, c * 32 + 16, FT * 2)) =
              make_uint4(cv[4], cv[5], cv[6], cv[7]);
        }
        __syncthreads();
        kb = conv;
      }

      // This warp's share of S = q . [ckv | krope]^T for its 16 rows and
      // the tile's 16 keys: the f32 q fragment split into NQ bf16 parts
      // (smallest first) against the exact bf16 keys.
      float sa[2][4], sr[2][4];        // ckv and (int8) krope terms
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[j][e] = sr[j][e] = 0.f;
      auto kstep = [&](int f, float (&d)[2][4]) {
        uint32_t a[NQ][4];
        const float2 x0 = *reinterpret_cast<const float2*>(qa + f);
        const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * QS + f);
        const float2 x2 = *reinterpret_cast<const float2*>(qa + f + 8);
        const float2 x3 =
            *reinterpret_cast<const float2*>(qa + 8 * QS + f + 8);
        split_into<NQ>(x0.x, x0.y, a, 0);
        split_into<NQ>(x1.x, x1.y, a, 1);
        split_into<NQ>(x2.x, x2.y, a, 2);
        split_into<NQ>(x3.x, x3.y, a, 3);
        uint32_t kf[4];
        ldmatrix_x4(kf, kb + gtc::swb((lane & 7) + 8 * (lane >> 4),
                                      (f + 8 * ((lane >> 3) & 1)) * 2,
                                      FT * 2));
#pragma unroll
        for (int i = NQ - 1; i >= 0; --i) {
          mma_bf16(d[0], a[i], kf[0], kf[1]);
          mma_bf16(d[1], a[i], kf[2], kf[3]);
        }
      };
      const int kc = min(ks1, K1);
#pragma unroll 3
      for (int kk = ks0; kk < kc; ++kk) kstep(16 * kk, sa);
#pragma unroll 2
      for (int kk = max(ks0, K1); kk < ks1; ++kk)
        kstep(16 * kk, kInt8 ? sr : sa);
      // int8: each term scaled per key column in f32 before they join.
      float sp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kInt8) {
            const int kl = j * 8 + 2 * t + (e & 1);
            sp[j][e] = sa[j][e] * __shfl_sync(0xffffffffu, sc0, kl) +
                       sr[j][e] * __shfl_sync(0xffffffffu, sc0, 16 + kl);
          } else {
            sp[j][e] = sa[j][e];
          }
        }
      // The four warps of a row group pool their shares, summed in the
      // same order by each (so all four hold the same S and run the same
      // softmax).
      {
        float* mine = xch + warp * XW + lane * 4;
        *reinterpret_cast<float4*>(mine) =
            make_float4(sp[0][0], sp[0][1], sp[0][2], sp[0][3]);
        *reinterpret_cast<float4*>(mine + 128) =
            make_float4(sp[1][0], sp[1][1], sp[1][2], sp[1][3]);
        hopper::named_bar_sync(1 + rg, 128);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float* o = xch + (rg + 4 * w) * XW + lane * 4;
          const float4 o0 = *reinterpret_cast<const float4*>(o);
          const float4 o1 = *reinterpret_cast<const float4*>(o + 128);
          if (w == 0) {
            sp[0][0] = o0.x; sp[0][1] = o0.y; sp[0][2] = o0.z;
            sp[0][3] = o0.w;
            sp[1][0] = o1.x; sp[1][1] = o1.y; sp[1][2] = o1.z;
            sp[1][3] = o1.w;
          } else {
            sp[0][0] += o0.x; sp[0][1] += o0.y; sp[0][2] += o0.z;
            sp[0][3] += o0.w;
            sp[1][0] += o1.x; sp[1][1] += o1.y; sp[1][2] += o1.z;
            sp[1][3] += o1.w;
          }
        }
      }

      // Scale (to log2 units), mask, online softmax (a row's 4 threads
      // reduce by shuffles), P = p (times the key's ckv scale on int8
      // pages).
      const int key_t = (t_begin + n) * KT;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_t + j * 8 + 2 * t + (e & 1);
          float x = sp[j][e] * sl2;
          if (key >= wk || key > lim[e >> 1]) x = -INFINITY;
          sp[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float mu[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = m[h] == -INFINITY ? 0.f : ex2(m[h] - m_new);
        mu[h] = m_new == -INFINITY ? 0.f : m_new;
        m[h] = m_new;
        l[h] *= alpha[h];
      }
      // acc *= alpha, skipped where no row's max moved (alpha 1 exactly).
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          acc[i][0] *= alpha[0];
          acc[i][1] *= alpha[0];
          acc[i][2] *= alpha[1];
          acc[i][3] *= alpha[1];
        }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(sp[j][e] - mu[e >> 1]);          // masked: 0
          l[e >> 1] += p;
          if constexpr (kInt8)
            p *= __shfl_sync(0xffffffffu, sc0, j * 8 + 2 * t + (e & 1));
          sp[j][e] = p;
        }

      // acc += P . ckv over this warp's columns, P split into NP bf16
      // parts (an A fragment each: f = (key tile j, row half) gives a0
      // (rows g, keys 2t..), a1 (rows g + 8), a2 (rows g, keys 2t + 8..),
      // a3).
      uint32_t pa[NP][4];
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_into<NP>(sp[f >> 1][(f & 1) * 2], sp[f >> 1][(f & 1) * 2 + 1],
                       pa, f);
      // 16 columns an ldmatrix; with NT odd (D1 = 32 mod 64) the last
      // one's second 8 columns (the next warp's, or krope's: inside FT)
      // are loaded and not used.
#pragma unroll
      for (int vp = 0; vp < (NT + 1) / 2; ++vp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, kb + gtc::swb((lane & 7) + 8 * ((lane >> 3) & 1),
                              (cq * QC + vp * 16 + 8 * (lane >> 4)) * 2,
                              FT * 2));
#pragma unroll
        for (int i = NP - 1; i >= 0; --i) {
          mma_bf16(acc[2 * vp], pa[i], vf[0], vf[1]);
          if (2 * vp + 1 < NT) mma_bf16(acc[2 * vp + 1], pa[i], vf[2], vf[3]);
        }
      }
      sc0 = sc1;
      sc1 = sc2;
    }
    cp_async_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }

    if (nlive == 1) {                  // the walk in one split: no merge
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rg * 16 + g + 8 * h;
        if (r >= rows) continue;
        const float d = l[h] == 0.f ? 1.f : l[h];
        float* o = out + head(r) * D1 + cq * QC + 2 * t;
#pragma unroll
        for (int i = 0; i < NT; ++i)
          *reinterpret_cast<float2*>(o + 8 * i) =
              make_float2(acc[i][2 * h] / d, acc[i][2 * h + 1] / d);
      }
      __syncthreads();                 // shared memory is the next item's
      continue;
    }
    // Partials of this split: acc [RT][D1], then (max, sum) per row.
    {
      const size_t slot = (size_t)unit * s.splits + z;
      float* pw = part_acc + slot * RT * D1 + cq * QC + 2 * t;
      float* pml = part_ml + slot * 2 * RT;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rg * 16 + g + 8 * h;
#pragma unroll
        for (int i = 0; i < NT; ++i)
          *reinterpret_cast<float2*>(pw + r * D1 + 8 * i) =
              make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
        if (cq == 0 && t == 0) {
          pml[r] = m[h];
          pml[RT + r] = l[h];
        }
      }
    }

    // Every split of the tile merges a slice of its rows once all the
    // tile's partials are written (a ticket counts them; the plan runs
    // all of a step's items at once, and the launch is cooperative, so
    // every split is running), summing the splits in split order.
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      atomicAdd(&tickets[unit], 1);
      int done;
      do {
        asm volatile("ld.acquire.gpu.b32 %0, [%1];\n"
                     : "=r"(done)
                     : "l"(tickets + unit)
                     : "memory");
        if (done < nlive) __nanosleep(64);
      } while (done < nlive);
    }
    __syncthreads();
    const int slice = (RT + nlive - 1) / nlive;
    const int ra = min(rows, z * slice), sr = min(rows, ra + slice) - ra;
    // Every split's (max, sum) rows and the slice's rows of every split's
    // partial -> shared memory (the q rows' and the ring's space), all
    // loads in flight at once.
    {
      const float* pm0 = part_ml + (size_t)unit * s.splits * 2 * RT;
      const float* pa0 = part_acc + ((size_t)unit * s.splits * RT + ra) * D1;
      for (int i = tid; i < nlive * 2 * RT / 4; i += THREADS)
        cp_async16(xch + 4 * i, pm0 + 4 * i, true);
      const int per_split = sr * D4;
      for (int i = tid; i < nlive * per_split; i += THREADS) {
        const int zz = i / per_split, k = i - zz * per_split;
        cp_async16(q_sh + 4 * i, pa0 + ((size_t)zz * RT * D1) + 4 * k, true);
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    // Each slice row's weights w_z = 2^(m_z - max m) and den = sum w_z
    // l_z, in split order.
    float* wts = xch + MAX_SPLITS * 2 * RT;        // [RT][WSTR]
    for (int r = tid; r < sr; r += THREADS) {
      float mm = -INFINITY;
      for (int zz = 0; zz < nlive; ++zz)
        mm = fmaxf(mm, xch[zz * 2 * RT + ra + r]);
      float den = 0.f;
      for (int zz = 0; zz < nlive; ++zz) {
        const float mz = xch[zz * 2 * RT + ra + r];
        const float a = mz == -INFINITY ? 0.f : ex2(mz - mm);
        wts[r * WSTR + zz] = a;
        den = fmaf(a, xch[zz * 2 * RT + RT + ra + r], den);
      }
      wts[r * WSTR + MAX_SPLITS] = den == 0.f ? 1.f : den;
    }
    __syncthreads();
    {
      // Warp w: rows w, w + 16, ... of the slice.
      const float4* st = reinterpret_cast<const float4*>(q_sh);
      for (int r = warp; r < sr; r += WARPS) {
        float4* o = reinterpret_cast<float4*>(out + head(ra + r) * D1);
        const float d = 1.f / wts[r * WSTR + MAX_SPLITS];
        for (int c = lane; c < D4; c += 32) {
          float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int zz = 0; zz < nlive; ++zz)
            gtc::fma4(wts[r * WSTR + zz], st[(zz * sr + r) * D4 + c], num);
          o[c] = make_float4(num.x * d, num.y * d, num.z * d, num.w * d);
        }
      }
    }
    __syncthreads();                   // shared memory is the next item's
  }

  // The shard's rows of row tiles whose rows all lie past max(len, 1)
  // (its units without items): written as 0, no page read.
  for (int u = u_lo + blockIdx.x; u < u_hi; u += gridDim.x) {
    if (off[u + 1] != off[u]) continue;
    const int2 run = rows_of(u);
    const int bh = u / s.row_tiles;
    const int b = bh / s.Hkv - slot0, hkv = bh % s.Hkv;
    const int r0 = run.x, rows = run.y;
    for (int idx = tid; idx < rows * D4; idx += THREADS) {
      const int rr = r0 + idx / D4, i = rr / G;
      *reinterpret_cast<float4*>(
          out + (((size_t)b * s.C + i) * s.H + hkv * G + (rr - i * G)) * D1 +
          4 * (idx % D4)) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <typename TKV, int D1, bool kShard>
int launch(const float* q, const float* q2, const void* kp, const void* k2p,
           const __half* ks, const __half* k2s, const int* tables,
           const int* positions, const int* lengths, float* out,
           float* part_acc, float* part_ml, int* tickets, int* plan_out,
           Shape sh, int blocks, float sm_scale, cudaStream_t st) {
  const Layout lay =
      layout(feat_width(D1, sh.D2), (int)sizeof(TKV), sh.units, sh.Bw);
  // Opt in to the card's whole per-block limit once per instantiation;
  // the wrapper has checked lay.total against that limit.
  static const cudaError_t opt_in = [] {
    int dev = 0, limit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(paged_mla_tc_kernel<TKV, D1, kShard>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    return e;
  }();
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  // Cooperative: every block is resident at once (the merge waits for
  // the splits of a tile, each on its own block).
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = st;
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, paged_mla_tc_kernel<TKV, D1, kShard>, q, q2,
      static_cast<const TKV*>(kp), static_cast<const TKV*>(k2p), ks, k2s,
      tables, positions, lengths, out, part_acc, part_ml, tickets, plan_out,
      sh, sm_scale);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename TKV>
int dispatch(const float* q, const float* q2, const void* kp,
             const void* k2p, const __half* ks, const __half* k2s,
             const int* tables, const int* positions, const int* lengths,
             float* out, float* part_acc, float* part_ml, int* tickets,
             int* plan_out, Shape sh, int blocks, float sm_scale,
             cudaStream_t st) {
  const bool shard = sh.Bw != sh.B || sh.Gw != sh.H / sh.Hkv;
#define REPRO_MLA_TC(RANK, SHARD)                                           \
  if (sh.D1 == RANK && shard == SHARD)                                      \
  return launch<TKV, RANK, SHARD>(q, q2, kp, k2p, ks, k2s, tables,          \
                                  positions, lengths, out, part_acc,        \
                                  part_ml, tickets, plan_out, sh, blocks,   \
                                  sm_scale, st)
  REPRO_MLA_TC(32, false);
  REPRO_MLA_TC(512, false);
  REPRO_MLA_TC(32, true);
  REPRO_MLA_TC(512, true);
#undef REPRO_MLA_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace mtc


}  // namespace

// Shared-memory bytes one block needs (the wrapper checks it against the
// card's limit before launching).
extern "C" long long paged_attention_gqa_smem(int C, int H, int Hkv, int D,
                                              int bs) {
  const long long R = (long long)C * (H / Hkv);
  return 4LL * (2 * R * D + 2LL * bs * (D + 1) + R * bs + 3 * R);
}

// The CUDA-core kernel: q_dtype must be 0 = float32 (bf16 q runs the
// tensor-core kernel, paged_attention_gqa_tc); kv_dtype 0 = float32,
// 1 = bfloat16 or 2 = int8 codes, which need k_scales/v_scales fp16 (NP,
// bs, Hkv) scale pages (null otherwise). out is f32 in q's (B, C, H, D)
// layout.
// With splits > 1, part_acc holds B*Hkv*splits*R*D floats and part_ml
// B*Hkv*splits*2*R floats (R = C * H / Hkv). Returns the cudaError_t of the launches.
extern "C" int paged_attention_gqa(const void* q, int q_dtype,
                                   const void* k_pages, const void* v_pages,
                                   int kv_dtype, const void* k_scales,
                                   const void* v_scales, const void* tables,
                                   const void* positions, const void* lengths,
                                   void* out, void* part_acc, void* part_ml,
                                   int B, int C, int H, int Hkv, int D,
                                   int bs, int MB, int pages_per_split,
                                   int splits, float sm_scale, void* stream) {
  const Shape sh{B, C, H, Hkv, D, bs, MB, pages_per_split, splits};
  const size_t smem = (size_t)paged_attention_gqa_smem(C, H, Hkv, D, bs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  const int* ln = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  const __half* ks = static_cast<const __half*>(k_scales);
  const __half* vs = static_cast<const __half*>(v_scales);
#define REPRO_PAGED_LAUNCH(TQ, TKV)                                     \
  return launch<TQ, TKV>(q, k_pages, v_pages, ks, vs, tb, ps, ln, out, pa, \
                         pm, sh, sm_scale, smem, st)
  if (q_dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == 2) REPRO_PAGED_LAUNCH(float, int8_t);
  if (kv_dtype == 1) REPRO_PAGED_LAUNCH(float, __nv_bfloat16);
  REPRO_PAGED_LAUNCH(float, float);
#undef REPRO_PAGED_LAUNCH
}

// GQA form, bf16 q on bf16 or int8 pages: the tensor-core kernel
// (gtc). Its launch plan for a table of MB pages of bs keys: plan[0]
// query rows of a block (16 or 32), plan[1] row groups of a (slot,
// kv-head) (ceil(C * H / Hkv / rows)), plan[2] key tiles (16 keys) of a
// page-walk split (two per warp, more only if the table would need
// over 64 splits), plan[3] splits, plan[4] shared-memory bytes.
extern "C" void paged_attention_gqa_tc_plan(int C, int H, int Hkv, int D,
                                            int kv_dtype, int MB, int bs,
                                            int* plan) {
  const int dp = gtc::dp_for(D);
  const int rows = C * (H / Hkv);
  const int rb = 16 * gtc::rtb_for(rows, dp);
  const int w = gtc::warps_for(dp);
  const int tiles = (MB * bs + gtc::KT - 1) / gtc::KT;
  const int need = (tiles + w * gtc::MAX_SPLITS - 1) / (w * gtc::MAX_SPLITS);
  const int tps = w * (need > gtc::TPW ? need : gtc::TPW);
  plan[0] = rb;
  plan[1] = (rows + rb - 1) / rb;
  plan[2] = tps;
  plan[3] = (tiles + tps - 1) / tps;
  plan[4] = gtc::layout(rb, dp, kv_dtype == 2 ? 1 : 2, tps).total;
}

// q bf16 (B, C, H, D), D % 16 == 0, D <= 256; pages bf16 (kv_dtype 1)
// or int8 codes (2) with fp16 (NP, bs, Hkv) k_scales/v_scales; out bf16
// like q. row_groups, tps and splits as the plan gives them; with
// splits > 1,
// part_acc holds B*Hkv*row_groups*splits*rows*D floats, part_ml
// B*Hkv*row_groups*splits*2*rows and tickets B*Hkv*row_groups ints,
// which must be zero when the launch starts (the wrapper zeroes them for
// each launch). Returns the cudaError_t of the launch.
extern "C" int paged_attention_gqa_tc(
    const void* q, const void* k_pages, const void* v_pages, int kv_dtype,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* positions, const void* lengths, void* out, void* part_acc,
    void* part_ml, void* tickets, int B, int C, int H, int Hkv, int D,
    int bs, int MB, int splits, int row_groups, int tps, float sm_scale,
    void* stream) {
  if (D % 16 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  const gtc::TcShape sh{B, C, H, Hkv, D, bs, MB, splits, row_groups, tps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  const int* ln = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* tk = static_cast<int*>(tickets);
  const __half* ks = static_cast<const __half*>(k_scales);
  const __half* vs = static_cast<const __half*>(v_scales);
  if (kv_dtype == 2)
    return gtc::dispatch<int8_t>(q, k_pages, v_pages, ks, vs, tb, ps, ln, out,
                                 pa, pm, tk, sh, sm_scale, st);
  if (kv_dtype == 1)
    return gtc::dispatch<__nv_bfloat16>(q, k_pages, v_pages, ks, vs, tb, ps,
                                        ln, out, pa, pm, tk, sh, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// MLA form. Row stride of the staged [q | q2] and [ckv | krope] tiles:
// D1 + D2 rounded up to 32 floats, plus 4 (rows start 4 banks apart).
static int mla_stride(int D1, int D2) { return (D1 + D2 + 31) / 32 * 32 + 4; }

// Query rows of a row tile: the CUDA-core kernel's on f32 pages
// (kv_dtype 0), the tensor-core kernel's on bf16 (1) or int8 (2) pages.
extern "C" int paged_attention_mla_row_tile(int kv_dtype) {
  return kv_dtype == 0 ? MLA_RT : mtc::RT;
}
extern "C" int paged_attention_mla_max_d1() { return MLA_MAX_D1; }

extern "C" long long paged_attention_mla_smem(int D1, int D2, int bs) {
  const long long KS = mla_stride(D1, D2);
  return 4LL * ((MLA_RT + bs) * KS + (long long)bs * MLA_RT + 3 * MLA_RT +
                WARPS);
}

// The most splits a step can take for MB pages per slot: the launch's,
// which sizes the partials below.
extern "C" int paged_attention_mla_splits(int MB) {
  return MB < MLA_MAX_SPLITS ? MB : MLA_MAX_SPLITS;
}

// MLA form on f32 pages (the CUDA-core kernel): q (B, C, H, D1) and q2
// (B, C, H, D2), k_pages (NP, bs, Hkv, D1) and k2_pages (NP, bs, Hkv, D2),
// all float32. out is float32 (B, C, H, D1). `splits` is the
// launch's (paged_attention_mla_splits, or fewer); each step takes at
// most that many, chosen from `lengths` on the card for `sms` SMs. With
// splits > 1, part_acc holds B*Hkv*row_tiles*splits*32*D1 floats and
// part_ml B*Hkv*row_tiles*splits*64 + 1 (the last: the step's split
// count). Returns the cudaError_t of the launches.
extern "C" int paged_attention_mla(const void* q, const void* q2,
                                   const void* k_pages,
                                   const void* k2_pages, const void* tables,
                                   const void* positions, const void* lengths,
                                   void* out, void* part_acc, void* part_ml,
                                   int B, int C, int H, int Hkv, int D1,
                                   int D2, int bs, int MB, int splits,
                                   int sms, float sm_scale, void* stream) {
  const int R = C * (H / Hkv);
  const MlaShape sh{B, C, H, Hkv, D1, D2, bs, MB, splits, sms,
                    (R + MLA_RT - 1) / MLA_RT, mla_stride(D1, D2)};
  const size_t smem = (size_t)paged_attention_mla_smem(D1, D2, bs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  const int* ln = static_cast<const int*>(lengths);
  const float* qf = static_cast<const float*>(q);
  const float* q2f = static_cast<const float*>(q2);
  float* o = static_cast<float*>(out);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  return launch_mla(qf, q2f, static_cast<const float*>(k_pages),
                    static_cast<const float*>(k2_pages), tb, ps, ln, o, pa, pm,
                    sh, sm_scale, smem, st);
}

// MLA form on bf16 or int8 pages: the tensor-core kernel (mtc). Shared
// bytes of one block (the wrapper checks them against the card's limit);
// they do not depend on the table's width. B and H are the whole call's
// (a shard plans from them).
extern "C" long long paged_attention_mla_tc_smem(int B, int C, int H, int Hkv,
                                                 int D1, int D2,
                                                 int kv_dtype) {
  const int units = B * Hkv * ((C * (H / Hkv) + mtc::RT - 1) / mtc::RT);
  return mtc::layout(mtc::feat_width(D1, D2), kv_dtype == 2 ? 1 : 2, units,
                     B)
      .total;
}

// The scratch of a call: n[0] the most splits a step can take for a
// table of MB pages of bs keys, n[1] floats of part_acc, n[2] floats of
// part_ml, n[3] ints of tickets (all 0 when a step takes one split). B
// is the call's slots, H the whole call's heads (a shard's units are the
// whole call's row tiles of its slots).
extern "C" void paged_attention_mla_tc_scratch(int B, int C, int H, int Hkv,
                                               int D1, int bs, int MB,
                                               long long* n) {
  const long long units =
      (long long)B * Hkv * ((C * (H / Hkv) + mtc::RT - 1) / mtc::RT);
  const long long splits = mtc::max_splits(MB, bs);
  const bool merge = splits > 1;
  n[0] = splits;
  n[1] = merge ? units * splits * mtc::RT * D1 : 0;
  n[2] = merge ? units * splits * 2 * mtc::RT : 0;
  n[3] = merge ? units : 0;
}

// q (B, C, H, D1) and q2 (B, C, H, D2) float32, D1 32 or 512 (the ranks
// of deepseek-v3 reduced and at full width) and D2 % 16 == 0, D2 <= 256
// (q2 and k2 null when D2 is 0); k_pages (NP, bs, Hkv, D1) and k2_pages
// (NP, bs, Hkv, D2), kv_dtype 1 = bfloat16 or 2 = int8 codes with
// k_scales/k2_scales fp16 (NP, bs, Hkv) scale pages; all 16-byte aligned.
// out is float32 (B, C, H, D1). `splits`, part_acc, part_ml and tickets
// as paged_attention_mla_tc_scratch gives them (tickets zero when the
// launch starts). The call may be a shard of a whole call of Bw slots
// and Hw heads: its slots are [slot0, slot0 + B) of the whole call's, its
// query heads [g0, g0 + H / Hkv) of each kv head's Hw / Hkv; positions
// and lengths are the whole call's (Bw each), and its rows are the whole
// call's bit for bit (a whole call: Bw = B, slot0 = 0, Hw = H, g0 = 0).
// The launch is one block per SM (`sms`); each step's split is chosen on
// the card from the whole call's positions and lengths, and written to
// plan_out (3 ints: key tiles of 16 keys a split, the shard's (row tile,
// split) items, the most splits of a row tile). Returns the cudaError_t
// of the launch.
extern "C" int paged_attention_mla_tc(
    const void* q, const void* q2, const void* k_pages, const void* k2_pages,
    int kv_dtype, const void* k_scales, const void* k2_scales,
    const void* tables, const void* positions, const void* lengths,
    void* out, void* part_acc, void* part_ml, void* tickets, void* plan_out,
    int B, int C, int H, int Hkv, int D1, int D2, int bs, int MB, int splits,
    int sms, int Bw, int slot0, int Hw, int g0, float sm_scale,
    void* stream) {
  if (D2 % 16 || D2 > mtc::MAX_D2 || H % Hkv || Hw % Hkv || g0 < 0 ||
      g0 + H / Hkv > Hw / Hkv || slot0 < 0 || slot0 + B > Bw)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (C * (Hw / Hkv) + mtc::RT - 1) / mtc::RT;
  const mtc::Shape sh{B,         C,      H,         Hkv,    D1,
                      D2,        bs,     MB,        splits, row_tiles,
                      Bw * Hkv * row_tiles, Bw, slot0, Hw / Hkv, g0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* q2f = static_cast<const float*>(q2);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  const int* ln = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* tk = static_cast<int*>(tickets);
  int* pl = static_cast<int*>(plan_out);
  const __half* ks = static_cast<const __half*>(k_scales);
  const __half* k2s = static_cast<const __half*>(k2_scales);
  if (kv_dtype == 2)
    return mtc::dispatch<int8_t>(qf, q2f, k_pages, k2_pages, ks, k2s, tb, ps,
                                 ln, o, pa, pm, tk, pl, sh, sms, sm_scale,
                                 st);
  if (kv_dtype == 1)
    return mtc::dispatch<__nv_bfloat16>(qf, q2f, k_pages, k2_pages, ks, k2s,
                                        tb, ps, ln, o, pa, pm, tk, pl, sh,
                                        sms, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
