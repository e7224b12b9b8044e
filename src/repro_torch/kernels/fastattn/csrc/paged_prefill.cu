// Paged chunked prefill for Hopper (sm_90a): one prompt chunk of every
// sequence in the batch against the global KV page pools, read through the
// page table, at runtime per-sequence offsets.
//
// Replaces the TPU kernel `paged_prefill_fwd`
// (src/repro/kernels/fastattn/kernel.py:322, body `_paged_prefill_kernel`).
// Same function: the chunk's own K/V rows are already scattered into the
// pools; arithmetic masks -- causal on global positions, `cols < kv_len`,
// `rows - cols < window` -- then softcap after the scale, then an f32
// online softmax.  A row with no valid key (a padded batch row with
// kv_len = 0) gives exactly 0.
//
// What bounds it on the H100: operations at long chunks against long
// contexts (512 query rows against up to a few thousand keys: ~4 * rows *
// keys * D FLOP against (rows + 2 * keys) * D * bytes); at the serving
// path's chunks, where most sequences hold few keys, the bytes of the
// pages read once.
//
// The entry point dispatches on dtype alone, with no fallback between the
// two instances:
//
//  * bfloat16 -> `paged_prefill_wgmma`, the tensor-core mainloop of
//    attn_sm90.cuh (shared with fastattn_fwd.cu): bf16 `wgmma` for
//    S = Q K^T and O += P V, K/V in a three-slot `cp.async` ring of
//    `block_kv1` keys a stage (level 1, from core/tiling.py's plan for the
//    table's n_kv * page_size keys, as fastattn_fwd's) whose row addresses
//    go through the page table (table[clamp(key / ps)] * ps + key % ps
//    within the kv head's pool), so a stage and a 64-key sub-tile may
//    straddle pages of any size.  The CTA walks only keys in [first_key, last_key]
//    (the window start, min(q_end, kv_len - 1)); keys at or past kv_len
//    are zero-filled, never read.  One CTA per (128- or 64-row query block,
//    query head, sequence); the kv head is hq / (Hq / Hkv).
//  * float32 -> `paged_prefill_kernel` below, FP32 FMA register tiles
//    (`wgmma` has no f32 form): one CTA per (64-row query block, query
//    head, sequence); it walks the pages from first_valid =
//    (q_start - window + 1) / page_size to last_valid = min(q_end,
//    kv_len - 1) / page_size, clamping every table index to [0, n_kv - 1];
//    K/V are staged through shared memory in sub-tiles of at most 32 keys,
//    those outside the valid range skipped; each thread computes a 4 x 4
//    register tile of scores and owns 4 output rows x D/8 columns of the
//    f32 accumulator.
#include "attn_sm90.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NUM_THREADS = 128;   // 16 x 8 threads
constexpr int BQ = 64;             // query rows per CTA
constexpr int TK = 32;             // keys per shared-memory sub-tile
constexpr int QPAD = BQ + 4;       // row length of the transposed Q tile
constexpr int KPAD = TK + 4;       // row length of the transposed K tile
constexpr int PPAD = TK + 1;       // row length of the P tile
constexpr int VEC = 8;

__device__ __forceinline__ void load8(const float* p, float (&o)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)D * QPAD + (size_t)D * KPAD + (size_t)TK * D +
          (size_t)BQ * PPAD);
}

// grid: (ceil(Sq / BQ), Hq, B); block: NUM_THREADS; dynamic shared
// memory: smem_bytes<D>().
template <typename T, int D>
__global__ void __launch_bounds__(NUM_THREADS)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ page_table,
                     const int* __restrict__ pos_starts,
                     const int* __restrict__ kv_lens, T* __restrict__ out,
                     int hq, int sq, int hkv, int num_pages, int page_size,
                     int n_kv, int window, float softcap, float scale) {
  constexpr int DC = D / VEC;        // 8-element chunks per row
  constexpr int DJ = D / 32;         // float4 column chunks per thread
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);   // [D][QPAD]  (Q^T)
  float* sK = sQ + D * QPAD;                       // [D][KPAD]  (K^T)
  float* sV = sK + D * KPAD;                       // [TK][D]
  float* sP = sV + TK * D;                         // [BQ][PPAD]

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 8;            // rows 4ty .. 4ty+3
  const int tx = tid % 8;            // score cols 4tx .. 4tx+3

  const int row0 = qb * BQ;          // first chunk row of this CTA
  const int q_start = pos_starts[b] + row0;   // its global position
  const int kv_len = min(kv_lens[b], n_kv * page_size);
  const int last_key = min(q_start + BQ - 1, kv_len - 1);
  const int first_key = window > 0 ? max(0, q_start - window + 1) : 0;

  // ---- Q block -> shared memory, transposed (rows fastest) -------------
  const T* qh = q + ((size_t)b * hq + h) * (size_t)sq * D;
  for (int idx = tid; idx < BQ * DC; idx += NUM_THREADS) {
    const int r = idx % BQ;
    const int c = (idx / BQ) * VEC;
    float v[VEC];
    if (row0 + r < sq) {
      load8(qh + (size_t)(row0 + r) * D + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sQ[(c + e) * QPAD + r] = v[e];
  }

  float m[4], l[4], acc[4][DJ * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ * 4; ++j) acc[i][j] = 0.f;
  }

  const int* table = page_table + (size_t)b * n_kv;
  const size_t head_off = (size_t)kvh * num_pages * page_size * D;

  if (last_key >= first_key) {
    const int lp_first = first_key / page_size;
    const int lp_last = last_key / page_size;
    for (int lp = lp_first; lp <= lp_last; ++lp) {
      const int page = min(max(table[min(lp, n_kv - 1)], 0), num_pages - 1);
      const T* kp = k_pages + head_off + (size_t)page * page_size * D;
      const T* vp = v_pages + head_off + (size_t)page * page_size * D;
      for (int off = 0; off < page_size; off += TK) {
        const int key0 = lp * page_size + off;   // global position of col 0
        const int nk = min(TK, page_size - off);
        if (key0 + nk - 1 < first_key || key0 > last_key) continue;
        __syncthreads();   // previous sub-tile (and the Q load) consumed
        // K^T: keys fastest, so the transposed stores do not conflict
        for (int idx = tid; idx < TK * DC; idx += NUM_THREADS) {
          const int j = idx % TK;
          const int c = (idx / TK) * VEC;
          float v[VEC];
          if (j < nk) {
            load8(kp + (size_t)(off + j) * D + c, v);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) sK[(c + e) * KPAD + j] = v[e];
        }
        // V: columns fastest (coalesced rows, contiguous stores)
        for (int idx = tid; idx < TK * DC; idx += NUM_THREADS) {
          const int j = idx / DC;
          const int c = (idx % DC) * VEC;
          float v[VEC];
          if (j < nk) {
            load8(vp + (size_t)(off + j) * D + c, v);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[e] = 0.f;
          }
          float4* dst = reinterpret_cast<float4*>(sV + j * D + c);
          dst[0] = make_float4(v[0], v[1], v[2], v[3]);
          dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        }
        __syncthreads();

        // ---- S = Q K^T on a 4 x 4 register tile --------------------------
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float4 qa = *reinterpret_cast<const float4*>(
              sQ + d * QPAD + 4 * ty);
          const float4 kb = *reinterpret_cast<const float4*>(
              sK + d * KPAD + 4 * tx);
          const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
          const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
        }

        // ---- mask, online softmax (rows shared by the 8 tx lanes) --------
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q_start + 4 * ty + i;
          bool ok[4];
          float mt = NEG_INF;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int jj = 4 * tx + j;
            const int col = key0 + jj;
            ok[j] = jj < nk && col <= row && col < kv_len &&
                    (window <= 0 || row - col < window);
            float sc = s[i][j] * scale;
            if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
            s[i][j] = ok[j] ? sc : NEG_INF;
            mt = fmaxf(mt, s[i][j]);
          }
#pragma unroll
          for (int o = 1; o < 8; o <<= 1)
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
          const float mn = fmaxf(m[i], mt);
          const float alpha = expf(m[i] - mn);
          float psum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = ok[j] ? expf(s[i][j] - mn) : 0.f;
            sP[(4 * ty + i) * PPAD + 4 * tx + j] = p;
            psum += p;
          }
#pragma unroll
          for (int o = 1; o < 8; o <<= 1)
            psum += __shfl_xor_sync(0xffffffffu, psum, o);
          l[i] = l[i] * alpha + psum;
          m[i] = mn;
#pragma unroll
          for (int j = 0; j < DJ * 4; ++j) acc[i][j] *= alpha;
        }
        __syncthreads();

        // ---- O += P V ----------------------------------------------------
#pragma unroll 4
        for (int kk = 0; kk < TK; ++kk) {
          float pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = sP[(4 * ty + i) * PPAD + kk];
#pragma unroll
          for (int jc = 0; jc < DJ; ++jc) {
            const float4 vv = *reinterpret_cast<const float4*>(
                sV + kk * D + jc * 32 + 4 * tx);
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
      store4(oh + (size_t)r * D + jc * 32 + 4 * tx,
             acc[i][4 * jc + 0] * inv, acc[i][4 * jc + 1] * inv,
             acc[i][4 * jc + 2] * inv, acc[i][4 * jc + 3] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const void* table, const void* starts,
                       const void* lens, void* out, int B, int hq, int sq,
                       int hkv, int num_pages, int page_size, int n_kv,
                       int window, float softcap, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((sq + BQ - 1) / BQ, hq, B);
  paged_prefill_kernel<T, D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(table),
      static_cast<const int*>(starts), static_cast<const int*>(lens),
      static_cast<T*>(out), hq, sq, hkv, num_pages, page_size, n_kv, window,
      softcap, scale);
  return cudaGetLastError();
}

// ---- bfloat16: the tensor-core kernel of attn_sm90.cuh ---------------------

struct PagedRows {      // element offset of key `key`'s row in its kv head
  const int* table;     // this sequence's page table row
  int n_kv, page_size, num_pages, d;
  __device__ size_t operator()(int key) const {
    const int page =
        min(max(table[min(key / page_size, n_kv - 1)], 0), num_pages - 1);
    return ((size_t)page * page_size + key % page_size) * d;
  }
};

// grid: (ceil(Sq / BQ), Hq, B); block: Cfg<D>::NT; dynamic shared memory:
// sm90::smem_bytes<D>(kv1).
template <int D>
__global__ void __launch_bounds__(sm90::Cfg<D>::NT, 1)
paged_prefill_wgmma(const sm90::bf16* __restrict__ q,
                   const sm90::bf16* __restrict__ k_pages,
                   const sm90::bf16* __restrict__ v_pages,
                   const int* __restrict__ page_table,
                   const int* __restrict__ pos_starts,
                   const int* __restrict__ kv_lens,
                   sm90::bf16* __restrict__ out, int hq, int sq, int hkv,
                   int num_pages, int page_size, int n_kv, int kv1,
                   int window, float softcap, float scale) {
  constexpr int BQ = sm90::Cfg<D>::BQ;
  const int qb = gridDim.x - 1 - blockIdx.x;       // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int row0 = qb * BQ;
  const size_t q_off = (((size_t)b * hq + h) * sq + row0) * D;
  const size_t head_off = (size_t)kvh * num_pages * page_size * D;
  const int kv_len = min(kv_lens[b], n_kv * page_size);
  const PagedRows rows{page_table + (size_t)b * n_kv, n_kv, page_size,
                       num_pages, D};
  sm90::attn_fwd_tile<D>(q + q_off, min(BQ, sq - row0), k_pages + head_off,
                         v_pages + head_off, rows, out + q_off,
                         pos_starts[b] + row0, kv_len, /*causal=*/1, window,
                         softcap, scale, kv1);
}

template <int D>
cudaError_t launch_sm90(const void* q, const void* k, const void* v,
                        const void* table, const void* starts,
                        const void* lens, void* out, int B, int hq, int sq,
                        int hkv, int num_pages, int page_size, int n_kv,
                        int kv1, int window, float softcap, float scale,
                        cudaStream_t stream) {
  const size_t smem = sm90::smem_bytes<D>(kv1);
  if (kv1 < sm90::BKV2 || kv1 % sm90::BKV2 != 0 ||
      smem > (size_t)sm90::MAX_SMEM)
    return cudaErrorInvalidValue;
  static size_t configured = 0;    // the largest size allowed so far
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  constexpr int BQ = sm90::Cfg<D>::BQ;
  const dim3 grid((sq + BQ - 1) / BQ, hq, B);
  paged_prefill_wgmma<D><<<grid, sm90::Cfg<D>::NT, smem, stream>>>(
      static_cast<const sm90::bf16*>(q), static_cast<const sm90::bf16*>(k),
      static_cast<const sm90::bf16*>(v), static_cast<const int*>(table),
      static_cast<const int*>(starts), static_cast<const int*>(lens),
      static_cast<sm90::bf16*>(out), hq, sq, hkv, num_pages, page_size, n_kv,
      kv1, window, softcap, scale);
  return cudaGetLastError();
}

// the instance of dtype T: float32 -> FMA kernel, bfloat16 -> wgmma kernel
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* table, const void* starts, const void* lens,
                   void* out, int B, int hq, int sq, int hkv, int num_pages,
                   int page_size, int n_kv, int kv1, int window,
                   float softcap, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4)
    return launch_fma<float, D>(q, k, v, table, starts, lens, out, B, hq, sq,
                                hkv, num_pages, page_size, n_kv, window,
                                softcap, scale, stream);
  else
    return launch_sm90<D>(q, k, v, table, starts, lens, out, B, hq, sq, hkv,
                          num_pages, page_size, n_kv, kv1, window, softcap,
                          scale, stream);
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const void* table, const void* starts,
                       const void* lens, void* out, int B, int hq, int sq,
                       int hkv, int num_pages, int page_size, int n_kv,
                       int kv1, int window, float softcap, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, table, starts, lens, out, B, hq, sq, hkv,
                           num_pages, page_size, n_kv, kv1, window, softcap,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, table, starts, lens, out, B, hq, sq,
                            hkv, num_pages, page_size, n_kv, kv1, window,
                            softcap, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, table, starts, lens, out, B, hq, sq,
                            hkv, num_pages, page_size, n_kv, kv1, window,
                            softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D); k/v pages (Hkv, P, page_size, D); page_table
// (B, n_kv), pos_start (B,), kv_len (B,) int32; out (B, Hq, Sq, D).
// dtype 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel).
// block_kv1: keys a stage of the bfloat16 ring, from core/tiling.py's plan
// for n_kv * page_size keys (a multiple of 64 whose ring fits); the
// float32 kernel stages 32-key sub-tiles of a page and does not read it.
// window <= 0 and softcap <= 0 mean "none".  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int paged_prefill(const void* q, const void* k_pages,
                             const void* v_pages, const void* page_table,
                             const void* pos_start, const void* kv_len,
                             void* out, int B, int hq, int sq, int hkv,
                             int num_pages, int page_size, int d, int n_kv,
                             int block_kv1, int window, float softcap,
                             float scale, int dtype, void* stream) {
  if (B <= 0 || sq <= 0 || hkv <= 0 || hq % hkv != 0 || n_kv <= 0 ||
      page_size <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(d, q, k_pages, v_pages, page_table,
                                  pos_start, kv_len, out, B, hq, sq, hkv,
                                  num_pages, page_size, n_kv, block_kv1,
                                  window, softcap, scale, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(
        d, q, k_pages, v_pages, page_table, pos_start, kv_len, out, B, hq,
        sq, hkv, num_pages, page_size, n_kv, block_kv1, window, softcap,
        scale, s);
  return (int)cudaErrorInvalidValue;
}
