// FastAttention forward for Hopper (sm_90a): the paper's two-level-tiled
// FlashAttention-2 forward with its tiling-mask block classification.
//
// Replaces the TPU kernel `fastattn_fwd`
// (src/repro/kernels/fastattn/kernel.py:156, body `_kernel`).  Same
// function: q (B, Hq, Sq, D) against k/v (B, Hkv, Skv, D), GQA by head
// index (kv head = hq / (Hq / Hkv)), a static `q_offset` (global position
// of query row 0), a `kv_valid` tail (keys at or past it are masked),
// causal or not, sliding `window` (visible iff row - col < window),
// `softcap` after the scale, f32 online softmax, output in the input dtype.
// A query row with no valid key gives exactly 0 (the JAX kernel averages
// the masked values there).
//
// What bounds it on the H100: operations.  At training shapes (llama2-7b,
// B=4, Hq=32, S=2048, D=128) it does 4 * B * Hq * Sq * Skv * D FLOP, about
// halved by the causal SKIP sub-tiles, against (Sq + 2 Skv) * D * bytes per
// head: ~300 FLOP per byte, over the bf16 ridge of the card, so the least
// time is the operation count over the tensor cores' 989 TFLOP/s.
//
// The entry point dispatches on dtype alone, with no fallback between the
// two instances:
//
//  * bfloat16 -> `fastattn_fwd_wgmma`, the tensor-core kernel of
//    attn_sm90.cuh (shared with paged_prefill.cu): one CTA per (128- or
//    64-row query block, query head, sequence), one consumer warpgroup per
//    64 rows; S = Q K^T and O += P V as bf16 `wgmma` with f32 accumulators,
//    Q staged once in bf16, K/V in a three-slot `cp.async` ring of
//    `block_kv1` keys (level 1, from core/tiling.py), each stage walked in
//    64-key sub-tiles classified SKIP / FULL / PARTIAL (level 2).  Causal
//    CTAs with the most keys start first (blockIdx.x is walked backwards).
//    A launch it refuses returns its CUDA error; nothing retries elsewhere.
//  * float32 -> `fastattn_fwd_kernel` below, FP32 FMA register tiles
//    (67 TFLOP/s peak): `wgmma` has no f32 form, and its TF32 form would
//    not hold float32 results to 1e-4.  Its design:
//
//  * Grid and scratch.  One CTA per (64-row query block, query head,
//    sequence).  The TPU's sequential `ki` grid axis and its VMEM scratch
//    become a loop inside the CTA with the running max, sum and the f32
//    accumulator in registers, longest causal CTAs first.
//  * Level 1.  The CTA walks only the macro-blocks of `block_kv1` keys in
//    [first_valid, last_valid] (kernel.py:55-62: the causal end, the
//    kv_valid tail, the window start); pruned macro-blocks are never
//    fetched (the TPU's clamped index map, kernel.py:204-217).  A
//    macro-block is staged into shared memory -- K transposed and V --
//    behind ONE barrier, so the barrier count per key falls as block_kv1
//    grows (the synchronisations the paper's level 1 removes).  block_kv1
//    comes from the Hopper planner: the largest that keeps two CTAs per
//    SM, within the 227 KB a CTA may use.
//  * Level 2.  Each 32-key sub-tile is classified with the rule of
//    kernel.py:80-91, which is tiling_mask.classify_block: SKIP sub-tiles
//    are neither loaded nor computed; FULL sub-tiles go straight to the
//    online softmax with no mask evaluation; only PARTIAL sub-tiles are
//    masked, by arithmetic (causal q_offset + row >= col, window row - col
//    < window, tail col < kv_valid); the (2M)^2 M-mask lookup is not
//    carried over, the SKIP/FULL/PARTIAL classification -- the saving the
//    paper claims -- is.
//  * Register tiles.  Each thread computes 4 query rows x 4 keys of S and
//    owns 4 output rows x D/8 columns of the accumulator (float4 chunks
//    32 apart; at D = 80 lanes tx < 4 own 12 columns, the others 8), so
//    both products issue 16 FMAs per pair of shared-memory loads.  P goes
//    from the S layout to the PV layout through warp shuffles (the 8 lanes
//    of a row group are one warp quarter), not through shared memory, so
//    a sub-tile needs no barrier at all.
#include "attn_sm90.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NUM_THREADS = 128;   // 16 x 8 threads
constexpr int BQ = 64;             // query rows per CTA (block_q)
constexpr int TK = 32;             // keys per level-2 sub-tile (block_kv2)
constexpr int PAD = 4;             // row padding of the transposed tiles
constexpr int QPAD = BQ + PAD;     // row length of the transposed Q tile
constexpr int VEC = 8;             // elements per staging load
constexpr int MAX_SUB = 32;        // sub-tiles per macro-block (bit masks)
constexpr int MAX_SMEM = 232448;   // 227 KB: the most one CTA may use

// 8 consecutive elements from global memory, as floats
__device__ __forceinline__ void load8(const float* p, float (&o)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// 8 consecutive elements copied as they are (16 or 32 bytes)
template <typename T>
struct Raw8 {
  uint4 u[VEC * sizeof(T) / 16];
};

template <typename T>
__device__ __forceinline__ Raw8<T> copy8(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < (int)(VEC * sizeof(T) / 16); ++i)
    r.u[i] = reinterpret_cast<const uint4*>(p)[i];
  return r;
}

template <typename T>
__device__ __forceinline__ Raw8<T> zero8() {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < (int)(VEC * sizeof(T) / 16); ++i)
    r.u[i] = make_uint4(0u, 0u, 0u, 0u);
  return r;
}

// 4 consecutive elements from shared memory, as a float4
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Dynamic shared memory of one CTA; core/tiling.py:smem_working_set
// computes the same number.
template <typename T, int D>
constexpr size_t smem_bytes(int kv1) {
  return sizeof(float) * (size_t)D * QPAD +
         sizeof(T) * ((size_t)D * (kv1 + PAD) + (size_t)kv1 * D);
}

// grid: (ceil(Sq / BQ), Hq, B); block: NUM_THREADS; dynamic shared
// memory: smem_bytes<T, D>(kv1).
template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS)
fastattn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int hq,
                    int hkv, int sq, int skv, int kv1, int causal, int window,
                    float softcap, float scale, int q_offset, int kv_valid) {
  static_assert(D % VEC == 0 && D <= 256,
                "head_dim must be a multiple of 8, at most 256");
  constexpr int DC = D / VEC;        // 8-element chunks per row
  // float4 column chunks a thread: columns 32 jc + 4 tx .. + 3; where D is
  // no multiple of 32 (80) the last chunk exists only for tx < (D % 32) / 4
  constexpr int DJ = (D + 31) / 32;
  const int KP = kv1 + PAD;          // row length of the transposed K tile
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);   // [D][QPAD]  Q^T, f32
  T* sK = reinterpret_cast<T*>(sQ + D * QPAD);     // [D][KP]    K^T
  T* sV = sK + (size_t)D * KP;                     // [kv1][D]   V

  const int qb = gridDim.x - 1 - blockIdx.x;       // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 8;            // rows 4ty .. 4ty+3
  const int tx = tid % 8;            // sub-tile keys 4tx .. 4tx+3
  const int lane = tid & 31;
  const int row_lane0 = lane & ~7;   // first lane of this row group

  const int row0 = qb * BQ;          // first query row of this CTA
  const int q_start = q_offset + row0;   // its global position
  const int q_end = q_start + BQ - 1;
  const int n_sub = kv1 / TK;

  // ---- level 1: the macro-blocks that can hold a visible key -----------
  int last = (skv + kv1 - 1) / kv1 - 1;
  if (causal) last = min(last, q_end / kv1);
  last = kv_valid > 0 ? min(last, (kv_valid - 1) / kv1) : -1;
  const int first = window > 0 ? max(0, q_start - window + 1) / kv1 : 0;

  // ---- Q block -> shared memory, transposed (rows fastest), f32 --------
  const T* qh = q + ((size_t)b * hq + h) * (size_t)sq * D;
  for (int idx = tid; idx < BQ * DC; idx += NUM_THREADS) {
    const int r = idx % BQ;
    const int c = (idx / BQ) * VEC;
    float e[VEC];
    if (row0 + r < sq) {
      load8(qh + (size_t)(row0 + r) * D + c, e);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) e[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sQ[(c + i) * QPAD + r] = e[i];
  }

  float m[4], l[4], acc[4][DJ * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ * 4; ++j) acc[i][j] = 0.f;
  }

  const size_t kv_off = ((size_t)b * hkv + kvh) * (size_t)skv * D;
  const T* kh = k + kv_off;
  const T* vh = v + kv_off;

  for (int mb = first; mb <= last; ++mb) {
    const int mb0 = mb * kv1;        // global position of its first key

    // ---- level 2: classify the sub-tiles (kernel.py:80-91) -------------
    uint32_t live = 0u, full = 0u;
    for (int j = 0; j < n_sub; ++j) {
      const int ks = mb0 + j * TK;
      const int ke = ks + TK - 1;
      bool skip = ks >= kv_valid;
      bool all = ke < kv_valid;
      if (causal) {
        const int delta = q_start - ks;
        skip = skip || delta <= -BQ;
        all = all && delta >= TK - 1;
      }
      if (window > 0) {
        skip = skip || ke <= q_start - window;
        all = all && ks >= q_end - window + 1;
      }
      if (!skip) {
        live |= 1u << j;
        if (all) full |= 1u << j;
      }
    }
    if (live == 0u) continue;        // CTA-uniform: no barrier skipped

    __syncthreads();   // the previous macro-block (and the Q load) consumed
    // K^T: keys fastest, so the transposed stores do not conflict
    const int nkeys = n_sub * TK;
    for (int idx = tid; idx < nkeys * DC; idx += NUM_THREADS) {
      const int j = idx % nkeys;
      if (!((live >> (j / TK)) & 1u)) continue;
      const int c = (idx / nkeys) * VEC;
      const int key = mb0 + j;
      const Raw8<T> r = key < kv_valid ? copy8(kh + (size_t)key * D + c)
                                       : zero8<T>();
      const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
      for (int i = 0; i < VEC; ++i) sK[(size_t)(c + i) * KP + j] = e[i];
    }
    // V: columns fastest (coalesced rows, contiguous stores)
    for (int idx = tid; idx < nkeys * DC; idx += NUM_THREADS) {
      const int j = idx / DC;
      if (!((live >> (j / TK)) & 1u)) continue;
      const int c = (idx % DC) * VEC;
      const int key = mb0 + j;
      *reinterpret_cast<Raw8<T>*>(sV + (size_t)j * D + c) =
          key < kv_valid ? copy8(vh + (size_t)key * D + c) : zero8<T>();
    }
    __syncthreads();

    for (int j = 0; j < n_sub; ++j) {
      if (!((live >> j) & 1u)) continue;          // SKIP: no math
      const bool is_full = (full >> j) & 1u;
      const int ks = mb0 + j * TK;                // global key of column 0

      // ---- S = Q K^T on a 4 x 4 register tile ----------------------------
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
      const T* kt = sK + j * TK + 4 * tx;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 qa = ld4(sQ + d * QPAD + 4 * ty);
        const float4 kb = ld4(kt + (size_t)d * KP);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] += qv[i] * kv[jj];
      }

      // ---- scale, softcap, PARTIAL-only mask, online softmax -------------
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q_start + 4 * ty + i;
        float mt = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float sc = s[i][jj] * scale;
          if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
          if (!is_full) {
            const int col = ks + 4 * tx + jj;
            const bool ok = col < kv_valid && (!causal || row >= col) &&
                            (window <= 0 || row - col < window);
            sc = ok ? sc : NEG_INF;
          }
          s[i][jj] = sc;
          mt = fmaxf(mt, sc);
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float mn = fmaxf(m[i], mt);
        // a row with no visible key so far keeps p = 0 (not exp(0) = 1)
        const float mref = mn == NEG_INF ? 0.f : mn;
        const float alpha = expf(m[i] - mref);
        float psum = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = expf(s[i][jj] - mref);
          psum += s[i][jj];
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, o);
        l[i] = l[i] * alpha + psum;
        m[i] = mn;
#pragma unroll
        for (int c = 0; c < DJ * 4; ++c) acc[i][c] *= alpha;
      }

      // ---- O += P V: P rows move between the row group's lanes -----------
#pragma unroll 2
      for (int src = 0; src < 8; ++src) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pv[i] = __shfl_sync(0xffffffffu, s[i][jj], row_lane0 + src);
          const T* vr = sV + (size_t)(j * TK + 4 * src + jj) * D + 4 * tx;
#pragma unroll
          for (int jc = 0; jc < DJ; ++jc) {
            if (D % 32 != 0 && jc * 32 + 4 * tx >= D) continue;
            const float4 vv = ld4(vr + jc * 32);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][4 * jc + 0] += pv[i] * vv.x;
              acc[i][4 * jc + 1] += pv[i] * vv.y;
              acc[i][4 * jc + 2] += pv[i] * vv.z;
              acc[i][4 * jc + 3] += pv[i] * vv.w;
            }
          }
        }
      }
    }
  }

  // ---- normalise and store the rows that exist -------------------------
  T* oh = out + ((size_t)b * hq + h) * (size_t)sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int jc = 0; jc < DJ; ++jc) {
      if (D % 32 != 0 && jc * 32 + 4 * tx >= D) continue;
      store4(oh + (size_t)r * D + jc * 32 + 4 * tx,
             acc[i][4 * jc + 0] * inv, acc[i][4 * jc + 1] * inv,
             acc[i][4 * jc + 2] * inv, acc[i][4 * jc + 3] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       void* out, int B, int hq, int hkv, int sq, int skv,
                       int kv1, int causal, int window, float softcap,
                       float scale, int q_offset, int kv_valid,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>(kv1);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static size_t configured = 0;    // the largest size allowed so far
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fastattn_fwd_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const dim3 grid((sq + BQ - 1) / BQ, hq, B);
  fastattn_fwd_kernel<T, D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv, kv1,
      causal, window, softcap, scale, q_offset, kv_valid);
  return cudaGetLastError();
}

// ---- bfloat16: the tensor-core kernel of attn_sm90.cuh ---------------------

template <int D>
struct DenseRows {      // element offset of key `key`'s row in its kv head
  __device__ size_t operator()(int key) const { return (size_t)key * D; }
};

// grid: (ceil(Sq / BQ), Hq, B); block: Cfg<D>::NT; dynamic shared memory:
// sm90::smem_bytes<D>(kv1).
template <int D>
__global__ void __launch_bounds__(sm90::Cfg<D>::NT, 1)
fastattn_fwd_wgmma(const sm90::bf16* __restrict__ q,
                  const sm90::bf16* __restrict__ k,
                  const sm90::bf16* __restrict__ v,
                  sm90::bf16* __restrict__ out, int hq, int hkv, int sq,
                  int skv, int kv1, int causal, int window, float softcap,
                  float scale, int q_offset, int kv_valid) {
  constexpr int BQ = sm90::Cfg<D>::BQ;
  const int qb = gridDim.x - 1 - blockIdx.x;       // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int row0 = qb * BQ;
  const size_t q_off = (((size_t)b * hq + h) * sq + row0) * D;
  const size_t kv_off = ((size_t)b * hkv + kvh) * (size_t)skv * D;
  sm90::attn_fwd_tile<D>(q + q_off, min(BQ, sq - row0), k + kv_off,
                         v + kv_off, DenseRows<D>{}, out + q_off,
                         q_offset + row0, kv_valid, causal, window, softcap,
                         scale, kv1);
}

template <int D>
cudaError_t launch_sm90(const void* q, const void* k, const void* v,
                        void* out, int B, int hq, int hkv, int sq, int skv,
                        int kv1, int causal, int window, float softcap,
                        float scale, int q_offset, int kv_valid,
                        cudaStream_t stream) {
  const size_t smem = sm90::smem_bytes<D>(kv1);
  if (kv1 % sm90::BKV2 != 0 || smem > (size_t)MAX_SMEM)
    return cudaErrorInvalidValue;
  static size_t configured = 0;    // the largest size allowed so far
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fastattn_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  constexpr int BQ = sm90::Cfg<D>::BQ;
  const dim3 grid((sq + BQ - 1) / BQ, hq, B);
  fastattn_fwd_wgmma<D><<<grid, sm90::Cfg<D>::NT, smem, stream>>>(
      static_cast<const sm90::bf16*>(q), static_cast<const sm90::bf16*>(k),
      static_cast<const sm90::bf16*>(v), static_cast<sm90::bf16*>(out), hq,
      hkv, sq, skv, kv1, causal, window, softcap, scale, q_offset, kv_valid);
  return cudaGetLastError();
}

// the instance of dtype T: float32 -> FMA kernel, bfloat16 -> wgmma kernel
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int hq, int hkv, int sq, int skv, int kv1,
                   int causal, int window, float softcap, float scale,
                   int q_offset, int kv_valid, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4)
    return launch_fma<float, D>(q, k, v, out, B, hq, hkv, sq, skv, kv1,
                                causal, window, softcap, scale, q_offset,
                                kv_valid, stream);
  else
    return launch_sm90<D>(q, k, v, out, B, hq, hkv, sq, skv, kv1, causal,
                          window, softcap, scale, q_offset, kv_valid,
                          stream);
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* out, int B, int hq, int hkv, int sq, int skv,
                       int kv1, int causal, int window, float softcap,
                       float scale, int q_offset, int kv_valid,
                       cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, out, B, hq, hkv, sq, skv, kv1, causal,
                           window, softcap, scale, q_offset, kv_valid, stream);
    case 80:
      return launch<T, 80>(q, k, v, out, B, hq, hkv, sq, skv, kv1, causal,
                           window, softcap, scale, q_offset, kv_valid, stream);
    case 96:
      return launch<T, 96>(q, k, v, out, B, hq, hkv, sq, skv, kv1, causal,
                           window, softcap, scale, q_offset, kv_valid, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, hq, hkv, sq, skv, kv1, causal,
                            window, softcap, scale, q_offset, kv_valid,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, hq, hkv, sq, skv, kv1, causal,
                            window, softcap, scale, q_offset, kv_valid,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D); out (B, Hq, Sq, D), all
// contiguous.  dtype 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma
// kernel).  block_kv1: keys per level-1 macro-block, from
// core/tiling.py's plan for the dtype: float32 a multiple of 32 (at most
// 32 sub-tiles), bfloat16 a multiple of 64 whose ring fits.  window
// <= 0 and softcap <= 0 mean "none"; kv_valid in [0, Skv].  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int fastattn_fwd(const void* q, const void* k, const void* v,
                            void* out, int B, int hq, int hkv, int sq,
                            int skv, int d, int block_kv1, int causal,
                            int window, float softcap, float scale,
                            int q_offset, int kv_valid, int dtype,
                            void* stream) {
  if (B <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      block_kv1 < TK || block_kv1 % TK != 0 ||
      (dtype == 0 && block_kv1 / TK > MAX_SUB) || q_offset < 0 ||
      kv_valid < 0 || kv_valid > skv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(d, q, k, v, out, B, hq, hkv, sq, skv,
                                  block_kv1, causal, window, softcap, scale,
                                  q_offset, kv_valid, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(d, q, k, v, out, B, hq, hkv, sq,
                                          skv, block_kv1, causal, window,
                                          softcap, scale, q_offset, kv_valid,
                                          s);
  return (int)cudaErrorInvalidValue;
}
