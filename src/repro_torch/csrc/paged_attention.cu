// Fused paged decode attention for Hopper (sm_90a), GQA form, CUDA C++.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_decode_attention (Pallas body _kernel, head folding _fold_heads)
// in its GQA forms: bf16 or f32 pages, or int8 code pages with fp16
// scale pages (one scale per (in-page position, kv-head)), C >= 1 chunk
// queries per slot. The MLA RoPE side (q2/k2 and shared K/V) is later
// work.
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
// What bounds it on the card: the bytes of the live K/V pages (each read
// once); the flops are ~C * G per byte, far below the ridge. So the
// design is about keeping enough page loads in flight and spending few
// instructions per byte:
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
