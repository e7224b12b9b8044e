// Paged flash decode for Hopper (sm_90a): one query token per sequence
// against the global KV page pools, read through the page table.
//
// Replaces the TPU kernel `paged_flash_decode_fwd`
// (src/repro/kernels/flash_decode/kernel.py, body `_paged_kernel` ->
// `_kernel`).  Same function: softcap after the scale, then the window
// mask `pos >= kv_len - window`, then an f32 online softmax; a row with no
// valid key gives 0.
//
// What bounds it on the H100: memory.  Every valid K and V row of the
// sequence is read once (2 * kv_len * D * sizeof(T) bytes per kv head)
// against ~2 * g * kv_len * D multiply-adds, far below the ~295 FLOP/byte
// the card needs before compute matters.  The least time is
// 2 * B * Hkv * kv_len * D * bytes / 3.35 TB/s.
//
// What the design does about it:
//  * split-KV: the grid is (B, Hkv * ceil(g / G), n_split).  A CTA owns
//    one kv head, a tile of <= G query rows of its GQA group (each K/V row
//    is read once for every query head sharing it) and split `z` of the
//    row's valid key range [max(kv_len - window, 0), kv_len): keys
//    kv_begin + z * split_keys onwards, split_keys of them.  The host picks
//    split_keys from the shapes alone (`plan_splits` in ops.py; kv_len
//    stays on the card), so a long row is walked by many CTAs at once and
//    a short or idle row's surplus CTAs exit at once;
//  * a row whose keys fill one split is written directly; otherwise each
//    active CTA writes its partial (m, l, acc) and the last one merges
//    them in the same launch (`decode_split.cuh`: an atomic counter per
//    row tile, reset by the merging CTA);
//  * a "thread group" of D/8 threads owns one key at a time, each thread
//    loading 16 bytes of bf16 (8 values) of the K and V rows, so a group
//    reads a whole row in one coalesced transaction; every table index is
//    clamped to [0, n_kv - 1] and every page to [0, P - 1];
//  * a register double buffer: a group's next U keys are loaded while its
//    current U are folded into its online softmax (one rescale per U), so
//    each iteration no longer waits out a whole load latency;
//  * the groups' partial (m, l, acc) merge through shared memory.
// Not done (later work): cp.async/TMA staging.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NUM_THREADS = 128;
constexpr int VEC = 8;      // elements of a row per thread (16 B of bf16)

// 16-byte words of a thread's VEC elements: 1 (bf16) or 2 (float32)
template <typename T>
__host__ __device__ constexpr int words() {
  return (int)sizeof(T) * VEC / 16;
}

template <typename T, int W>
__device__ __forceinline__ void load_raw(const T* p, uint4 (&r)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w)
    r[w] = __ldg(reinterpret_cast<const uint4*>(p) + w);
}

__device__ __forceinline__ void to_float(const uint4 (&r)[2],
                                         float (&o)[VEC]) {
  const float* f = reinterpret_cast<const float*>(r);
#pragma unroll
  for (int e = 0; e < VEC; ++e) o[e] = f[e];
}

__device__ __forceinline__ void to_float(const uint4 (&r)[1],
                                         float (&o)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* page_table;
  const int* kv_lens;
  void* out;
  float* partials;      // decode_split workspace
  int* counters;        // one per row tile, 0 between launches
  int hq, hkv, num_pages, page_size, n_kv, window, split_keys, n_split;
  float softcap, scale;
};

// grid: (B, Hkv * ceil(g / G), n_split); block: NUM_THREADS.
template <typename T, int D, int G>
__global__ void __launch_bounds__(NUM_THREADS)
paged_decode_kernel(const Args a) {
  constexpr int TG = D / VEC;            // threads per key row
  constexpr int NG = NUM_THREADS / TG;   // thread groups per CTA
  constexpr int W = words<T>();
  // keys of a group per buffer: 4 for bf16, 2 for f32 and 8-row tiles
  // (their registers hold 8 query rows)
  constexpr int U = W == 1 && G < 8 ? 4 : 2;
  static_assert(TG <= 32 && 32 % TG == 0, "a group must sit in one warp");

  __shared__ float sm_m[NG][G];
  __shared__ float sm_l[NG][G];
  __shared__ float sm_acc[NG][G][D];

  const int b = blockIdx.x;
  const int g = a.hq / a.hkv;
  const int n_tiles = (g + G - 1) / G;
  const int h = blockIdx.y / n_tiles;
  const int tile = blockIdx.y % n_tiles;
  const int split = blockIdx.z;
  const int r0 = tile * G;               // first query row of the group
  const int nrows = min(G, g - r0);
  const int row0 = b * a.hq + h * g + r0;   // its output row
  T* const out = static_cast<T*>(a.out);

  const int len = a.kv_lens[b];
  const int kv_end = min(len, a.n_kv * a.page_size);
  const int kv_begin = a.window > 0 ? max(len - a.window, 0) : 0;
  const int n_keys = max(kv_end - kv_begin, 0);
  const int n_active = (n_keys + a.split_keys - 1) / a.split_keys;
  if (n_active == 0) {                   // no valid key: the row is 0
    if (split == 0)
      for (int idx = threadIdx.x; idx < nrows * D; idx += NUM_THREADS)
        decode_split::store_out(out + (size_t)row0 * D + idx, 0.f);
    return;
  }
  if (split >= n_active) return;
  const int s0 = kv_begin + split * a.split_keys;
  const int s1 = min(s0 + a.split_keys, kv_end);

  const int gi = threadIdx.x / TG;
  const int li = threadIdx.x % TG;
  const int d0 = li * VEC;
  const T* const q = static_cast<const T*>(a.q);
  float qr[G][VEC];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r < nrows) {
      uint4 raw[W];
      load_raw(q + (size_t)(row0 + r) * D + d0, raw);
      to_float(raw, qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[r][e] = 0.f;
    }
  }

  const int* table = a.page_table + (size_t)b * a.n_kv;
  const size_t head_off = (size_t)h * a.num_pages * a.page_size * D;
  const T* const kp = static_cast<const T*>(a.k_pages) + head_off + d0;
  const T* const vp = static_cast<const T*>(a.v_pages) + head_off + d0;

  // loads of the keys [base, base + U) of this group (positions past s1
  // read the split's first key and are masked when folded)
  auto fetch = [&](int base, uint4 (&kr)[U][W], uint4 (&vr)[U][W]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u < s1 ? base + u : s0;
      const int lp = min(p / a.page_size, a.n_kv - 1);
      const int page = min(max(table[lp], 0), a.num_pages - 1);
      const size_t off = ((size_t)page * a.page_size + p % a.page_size) * D;
      load_raw(kp + off, kr[u]);
      load_raw(vp + off, vr[u]);
    }
  };

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  uint4 kc[U][W], vc[U][W], kn[U][W], vn[U][W];
  fetch(s0 + gi * U, kc, vc);
  // uniform trip count for the whole CTA: the in-group shuffles below
  // need every lane of the warp present
  for (int base0 = s0; base0 < s1; base0 += NG * U) {
    if (base0 + NG * U < s1) fetch(base0 + NG * U + gi * U, kn, vn);
    const int base = base0 + gi * U;
    float kf[U][VEC], vf[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      to_float(kc[u], kf[u]);
      to_float(vc[u], vf[u]);
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) part += qr[r][e] * kf[u][e];
#pragma unroll
        for (int o = TG / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        float sc = part * a.scale;
        if (a.softcap > 0.f) sc = a.softcap * tanhf(sc / a.softcap);
        s[u] = base + u < s1 ? sc : NEG_INF;
      }
      float mt = s[0];
#pragma unroll
      for (int u = 1; u < U; ++u) mt = fmaxf(mt, s[u]);
      const float mn = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - mn);
      float p[U];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = base + u < s1 ? expf(s[u] - mn) : 0.f;
        psum += p[u];
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float x = acc[r][e] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) x += p[u] * vf[u][e];
        acc[r][e] = x;
      }
      m[r] = mn;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int w = 0; w < W; ++w) {
        kc[u][w] = kn[u][w];
        vc[u][w] = vn[u][w];
      }
  }

#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (li == 0) {
      sm_m[gi][r] = m[r];
      sm_l[gi][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm_acc[gi][r][d0 + e] = acc[r][e];
  }
  __syncthreads();

  // this CTA's (m, l, acc) per row: the output itself when the row's keys
  // fill one split, else a partial for decode_split's merge
  for (int idx = threadIdx.x; idx < nrows * D; idx += NUM_THREADS) {
    const int r = idx / D;
    const int d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NG; ++j) mx = fmaxf(mx, sm_m[j][r]);
    float lsum = 0.f, x = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const float w = expf(sm_m[j][r] - mx);
      lsum += sm_l[j][r] * w;
      x += sm_acc[j][r][d] * w;
    }
    if (n_active == 1) {
      decode_split::store_out(out + (size_t)(row0 + r) * D + d,
                              lsum > 0.f ? x / lsum : 0.f);
    } else {
      float* pp =
          decode_split::partial(a.partials, row0 + r, split, a.n_split, D);
      pp[2 + d] = x;
      if (d == 0) {
        pp[0] = mx;
        pp[1] = lsum;
      }
    }
  }
  if (n_active == 1) return;
  int* const counter = a.counters + (size_t)b * a.hkv * n_tiles + blockIdx.y;
  if (decode_split::arrive_last(counter, n_active))
    decode_split::merge_rows(a.partials, row0, nrows, a.n_split, n_active, D,
                             out, counter);
}

template <typename T, int D, int G>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int g = a.hq / a.hkv;
  const dim3 grid(B, a.hkv * ((g + G - 1) / G), a.n_split);
  paged_decode_kernel<T, D, G><<<grid, NUM_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// G: query rows a CTA (the wrapper's `rows_per_cta` mirrors this)
template <typename T, int D>
cudaError_t dispatch_g(const Args& a, int B, cudaStream_t stream) {
  const int g = a.hq / a.hkv;
  if (g == 1) return launch<T, D, 1>(a, B, stream);
  if (g == 2) return launch<T, D, 2>(a, B, stream);
  if (g <= 4) return launch<T, D, 4>(a, B, stream);
  return launch<T, D, 8>(a, B, stream);
}

template <typename T>
cudaError_t dispatch_d(int d, const Args& a, int B, cudaStream_t stream) {
  switch (d) {
    case 64:
      return dispatch_g<T, 64>(a, B, stream);
    case 128:
      return dispatch_g<T, 128>(a, B, stream);
    case 256:
      return dispatch_g<T, 256>(a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, D); k/v pages (Hkv, P, page_size, D); page_table (B, n_kv)
// int32; kv_len (B,) int32; out (B, Hq, D).  dtype 0 = float32,
// 1 = bfloat16.  window <= 0 and softcap <= 0 mean "none".  Split-KV:
// split_keys keys a CTA; n_split = ceil(span / split_keys), span =
// n_kv * page_size, or the window where it is smaller.  partials: at
// least B * Hq * n_split * (D + 2) floats; counters: at least B * Hq int32,
// all 0 (each launch leaves them 0).  Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* page_table,
                            const void* kv_len, void* out, void* partials,
                            void* counters, int B, int hq, int hkv,
                            int num_pages, int page_size, int d, int n_kv,
                            int window, int split_keys, float softcap,
                            float scale, int dtype, void* stream) {
  if (B <= 0 || hkv <= 0 || hq % hkv != 0 || n_kv <= 0 || page_size <= 0 ||
      split_keys <= 0)
    return (int)cudaErrorInvalidValue;
  const int width = n_kv * page_size;
  const int span = window > 0 ? min(window, width) : width;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(kv_len), out,
               static_cast<float*>(partials), static_cast<int*>(counters),
               hq, hkv, num_pages, page_size, n_kv, window, split_keys,
               (span + split_keys - 1) / split_keys, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(d, a, B, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(d, a, B, s);
  return (int)cudaErrorInvalidValue;
}
