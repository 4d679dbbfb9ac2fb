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
// has Dv != D). D and Dv are multiples of 4 and at most 256.
//
// What bounds it on the card: at prefill sizes (S in the hundreds) the
// flops (~S * Hkv-group per byte) are far above the ridge, so the tensor
// cores would bound it; this first kernel does its products on the f32
// CUDA cores, so it is bound by their instruction rate. The design
// keeps that cost down without tensor cores:
//   * one block per (batch, head, 64-query tile); 256 threads, thread
//     (rg, kg) = (tid / 16, tid % 16) owns query rows rg + 16 i and key
//     columns kg + 16 j (i, j < 4) of the 64 x 64 score tile, so each
//     16-byte shared-memory load of q and of k feeds 16 FMAs;
//   * the same thread owns rows rg + 16 i of the output, so the running
//     max, sum and rescale stay in its registers (the 16 threads of a
//     row reduce with shuffles, never through shared memory);
//   * Q, K and V tiles are staged in f32 shared memory (rows of Q and K
//     padded by 4 floats: conflict-free 16-byte loads); at D = Dv = 128
//     that is ~118 KB, so the block opts in to the dynamic shared-memory
//     limit;
//   * causal key tiles past the tile's last query are never loaded, the
//     heaviest query tiles are scheduled first, and masked keys never
//     enter P.V (their p is exactly 0 and skipped).
// Tensor-core products (wgmma on bf16 tiles) and cp.async/TMA staging
// are later work.
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro_torch;

constexpr int THREADS = 256;
constexpr int BQ = 64;                 // query rows of a block
constexpr int BK = 64;                 // keys of a tile
constexpr int PS = BK + 4;             // p tile row stride (floats)

struct Shape {
  int B, Sq, Skv, H, Hkv, D, Dv, q_offset, causal;
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

}  // namespace

// Shared-memory bytes one block needs (the wrapper checks it against the
// card's limit before launching).
extern "C" long long flash_attention_smem(int D, int Dv) {
  return 4LL * (2LL * 64 * (D + 4) + 64LL * Dv + 64LL * (64 + 4));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). q is
// (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv), out
// (B, Sq, H, Dv), all contiguous and 16-byte aligned; D % 4 == 0,
// Dv % 4 == 0, both <= 256. Returns the cudaError_t of the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int dtype, int B, int Sq, int Skv,
                               int H, int Hkv, int D, int Dv, int q_offset,
                               int causal, float sm_scale, void* stream) {
  const Shape sh{B, Sq, Skv, H, Hkv, D, Dv, q_offset, causal};
  const size_t smem = (size_t)flash_attention_smem(D, Dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, sh, sm_scale, smem, st);
  return dispatch<float>(q, k, v, out, sh, sm_scale, smem, st);
}
