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
// GQA form. What bounds it on the card: the bytes of the live K/V pages
// (each read once); the flops are ~C * G per byte, far below the ridge.
// So the design is about keeping enough page loads in flight and
// spending few instructions per byte:
//   * the grid is (slot x kv-head, split): the TPU's sequential walk over
//     kv blocks becomes `splits` blocks that each walk a contiguous run of
//     the slot's pages (flash-decoding), so a handful of slots still fill
//     the card; each block loads its page ids from the table itself (the
//     TPU's scalar prefetch becomes a load by the block);
//   * a page's K and V tiles are staged in shared memory together, rows
//     padded to D + 1 floats, so the thread-per-(row, key) score loop and
//     the thread-per-(row, feature) P.V loop are free of bank conflicts;
//   * masked keys get p = 0 and are skipped in P.V, so garbage past a
//     row's depth in a live page is never multiplied in;
//   * with more than one split, each block leaves its (max, sum, acc)
//     partials and a second kernel merges them in split order (no
//     atomics, so a result never varies from run to run).
//
// MLA form (paged_attention_mla below). Hkv is 1 and G = H = 128, so one
// (slot, kv-head) has C * 128 query rows of width 512 + 64: too many to
// stage in one block (the GQA design would need 4 MB of shared memory at
// C = 8). Every row reads the same pages, so the work is a small matrix
// product per page, S = [q_eff | q_rope] . [ckv | krope]^T, then
// acc += P . ckv (~2 * (576 + 512) flops per row and key), f32 q_eff and
// q_rope in, f32 out (what mla_decode passes). Its least time is set by
// the bytes of the valid rows' f32 q_eff, q2 and output and by those f32
// flops:
//   * the grid is (slot x kv-head x 32-row tile, split); a tile's q rows
//     are staged once, and each live page is staged ONCE per block as one
//     f32 tile [ckv | krope] (rows padded to 4 mod 32 floats: conflict-free
//     16-byte loads), used for the scores and, its ckv part, as V (the
//     JAX contract "one DMA per live block");
//   * scores: thread (key t, rows r and r + 16), each 16-byte load of the
//     key row feeding 8 FMAs; P.V: each thread owns two of the 512 output
//     columns for all 32 rows in registers (64 accumulators), reading P
//     as broadcast 16-byte loads;
//   * rows past a slot's valid length are garbage by contract: a tile
//     whose first chunk entry is at or past max(len, 1) reads no page and
//     writes its rows as 0 (in steady decode 7 of 8 entries), and a tile
//     walks no page past the causal depth of its last row;
//   * the page walk is split as in the GQA form, with the same fixed-order
//     merge (one block per output row, so its loads overlap). The split
//     count follows the step: every block sums, from positions and
//     lengths, the pages all live tiles walk and takes that over two
//     blocks per SM as the pages per split (steady decode at the serve's
//     shape: 1 or 2 of 10 pages; more live rows, longer runs and fewer
//     splits; one split is written without a merge). The launch has
//     room for up to 16 splits; blocks past the step's count return at
//     once;
//   * with so few blocks per SM the kernel is bound by latency inside a
//     block: each thread keeps 8 (q) or 4 (page) 16-byte loads in flight
//     while staging, and two FMA chains per row in the score loop.
// cp.async/TMA page loads and tensor-core products are later work.
#include <math.h>
#include <type_traits>

#include "common.cuh"

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
// MLA form: shared K/V pages plus the RoPE score side.
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

// 4 consecutive page elements -> f32 (16-byte f32, 8-byte bf16, 4-byte
// int8 loads; the wrapper checks the alignment).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), c = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, c.x, c.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(to_float(static_cast<int8_t>(c.x)),
                     to_float(static_cast<int8_t>(c.y)),
                     to_float(static_cast<int8_t>(c.z)),
                     to_float(static_cast<int8_t>(c.w)));
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

template <typename TKV>
__global__ void __launch_bounds__(THREADS, 2)
paged_attention_mla_kernel(const float* __restrict__ q,
                           const float* __restrict__ q2,
                           const TKV* __restrict__ k_pages,
                           const TKV* __restrict__ k2_pages,
                           const __half* __restrict__ k_scales,
                           const __half* __restrict__ k2_scales,
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
          float sc = 1.f;
          if (c4 < W1) {
            buf[u] = load4(k_pages + row * D1 + 4 * c4);
            if constexpr (std::is_same<TKV, int8_t>::value)
              sc = __half2float(k_scales[row]);
          } else {
            buf[u] = load4(k2_pages + row * D2 + 4 * (c4 - W1));
            if constexpr (std::is_same<TKV, int8_t>::value)
              sc = __half2float(k2_scales[row]);
          }
          if constexpr (std::is_same<TKV, int8_t>::value) {
            buf[u].x *= sc; buf[u].y *= sc; buf[u].z *= sc; buf[u].w *= sc;
          }
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

template <typename TKV>
int launch_mla(const float* q, const float* q2, const void* kp,
               const void* k2p, const __half* ks, const __half* k2s,
               const int* tables, const int* positions, const int* lengths,
               float* out, float* part_acc, float* part_ml, MlaShape sh,
               float sm_scale, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    static const cudaError_t opt_in = [] {
      int dev = 0, limit = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(paged_attention_mla_kernel<TKV>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 limit);
      return e;
    }();
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  }
  const dim3 grid(sh.B * sh.Hkv * sh.row_tiles, sh.splits);
  paged_attention_mla_kernel<TKV><<<grid, THREADS, smem, st>>>(
      q, q2, static_cast<const TKV*>(kp), static_cast<const TKV*>(k2p), ks,
      k2s, tables, positions, lengths, out, part_acc, part_ml, sh, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sh.splits == 1) return static_cast<int>(err);
  const dim3 merge_grid(sh.B * sh.Hkv * sh.row_tiles, MLA_RT);
  paged_attention_mla_merge<<<merge_grid, MLA_MERGE_THREADS, 0, st>>>(
      part_acc, part_ml, positions, lengths, out, sh);
  return static_cast<int>(cudaGetLastError());
}


}  // namespace

// Shared-memory bytes one block needs (the wrapper checks it against the
// card's limit before launching).
extern "C" long long paged_attention_gqa_smem(int C, int H, int Hkv, int D,
                                              int bs) {
  const long long R = (long long)C * (H / Hkv);
  return 4LL * (2 * R * D + 2LL * bs * (D + 1) + R * bs + 3 * R);
}

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: the same, or 2 = int8
// codes, which need k_scales/v_scales fp16 (NP, bs, Hkv) scale pages
// (null otherwise). out has q's dtype and q's (B, C, H, D) layout.
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
  if (q_dtype == 1) {
    if (kv_dtype == 2) REPRO_PAGED_LAUNCH(__nv_bfloat16, int8_t);
    if (kv_dtype == 1) REPRO_PAGED_LAUNCH(__nv_bfloat16, __nv_bfloat16);
    REPRO_PAGED_LAUNCH(__nv_bfloat16, float);
  }
  if (kv_dtype == 2) REPRO_PAGED_LAUNCH(float, int8_t);
  if (kv_dtype == 1) REPRO_PAGED_LAUNCH(float, __nv_bfloat16);
  REPRO_PAGED_LAUNCH(float, float);
#undef REPRO_PAGED_LAUNCH
}

// MLA form. Row stride of the staged [q | q2] and [ckv | krope] tiles:
// D1 + D2 rounded up to 32 floats, plus 4 (rows start 4 banks apart).
static int mla_stride(int D1, int D2) { return (D1 + D2 + 31) / 32 * 32 + 4; }

extern "C" int paged_attention_mla_row_tile() { return MLA_RT; }
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

// q (B, C, H, D1) and q2 (B, C, H, D2) float32; k_pages (NP, bs, Hkv, D1)
// and k2_pages (NP, bs, Hkv, D2), kv_dtype 0 = float32, 1 = bfloat16 or
// 2 = int8 codes with k_scales/k2_scales fp16 (NP, bs, Hkv) scale pages
// (null otherwise). out is float32 (B, C, H, D1). `splits` is the
// launch's (paged_attention_mla_splits, or fewer); each step takes at
// most that many, chosen from `lengths` on the card for `sms` SMs. With
// splits > 1, part_acc holds B*Hkv*row_tiles*splits*32*D1 floats and
// part_ml B*Hkv*row_tiles*splits*64 + 1 (the last: the step's split
// count). Returns the cudaError_t of the launches.
extern "C" int paged_attention_mla(const void* q, const void* q2,
                                   const void* k_pages,
                                   const void* k2_pages, int kv_dtype,
                                   const void* k_scales,
                                   const void* k2_scales, const void* tables,
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
  const __half* ks = static_cast<const __half*>(k_scales);
  const __half* k2s = static_cast<const __half*>(k2_scales);
#define REPRO_MLA_LAUNCH(TKV)                                              \
  return launch_mla<TKV>(qf, q2f, k_pages, k2_pages, ks, k2s, tb, ps, ln, o, \
                         pa, pm, sh, sm_scale, smem, st)
  if (kv_dtype == 2) REPRO_MLA_LAUNCH(int8_t);
  if (kv_dtype == 1) REPRO_MLA_LAUNCH(__nv_bfloat16);
  REPRO_MLA_LAUNCH(float);
#undef REPRO_MLA_LAUNCH
}
