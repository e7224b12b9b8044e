// Flash decode for Hopper (sm_90a): one query token per sequence against
// dense per-sequence KV caches, read through their strides.
//
// Replaces the TPU kernel `flash_decode_fwd`
// (src/repro/kernels/flash_decode/kernel.py, body `_kernel`).  Same
// function: softcap after the scale, then the window mask
// `pos >= kv_len - window`, then an f32 online softmax; a row with no valid
// key gives exactly 0.  The TPU kernel streamed `block_kv` macro-blocks
// through VMEM over a sequential grid axis, padded the GQA group to 8
// sublanes and clamped out-of-range blocks for the Pallas grid; none of
// that carries over.
//
// What bounds it on the H100: memory.  Every valid K and V row is read once
// (2 * kv_len * D * sizeof(T) bytes per kv head) against ~4 * g * kv_len * D
// flops, 1-8 flops a byte, far below the ~295 the card needs before
// compute matters.  The least time is 2 * B * Hkv * kv_len * D * bytes /
// 3.35 TB/s: 0.3205 ms for llama2-7b at B=1 on a 65,536-token bf16 cache.
// To reach it the card must keep ~32 KB of loads in flight on each of its
// 132 SMs, whatever B and Hkv are.
//
// What the design does about it:
//  * split-KV: the grid is (B, Hkv * ceil(g / G), n_split).  A CTA owns
//    one kv head, a tile of <= G query rows of its GQA group (each K/V row
//    is read once for every query head sharing it) and split `z` of the
//    row's valid key range [max(kv_len - window, 0), min(kv_len, S)): keys
//    kv_begin + z * split_keys onwards, split_keys of them.  The host picks
//    split_keys from the shapes alone (`plan_dense_splits` in ops.py: the
//    paged kernel's planner with the cache width as the span; kv_len stays
//    on the card), so llama2-7b at B=1 runs 32 x 8 CTAs where one CTA a
//    head (32 for 132 SMs) walked the whole cache alone, and rows that
//    already fill the card (B=8 x 32 heads) are not split;
//  * a row whose keys fill one split is written directly; otherwise each
//    active CTA writes its partial (m, l, acc) and the last one merges
//    them in the same launch (`decode_split.cuh`, shared with
//    paged_decode.cu: an atomic counter per row tile, reset by the merging
//    CTA), so a decode step gains no launch and no memset.  Splits a row
//    does not reach exit without a write;
//  * a "thread group" of D/8 threads owns one key at a time, each thread
//    holding 8 elements (16 bytes of bf16) of the K and V rows, so a group
//    reads a whole row in one coalesced transaction.  The group is D/8
//    rounded up to a power of two lanes (in one warp, a butterfly for its
//    sums): at D = 80 and 96 (10 and 12 lanes of 16) the lanes past D/8
//    load and store nothing and hold zeros, which add nothing to a sum.
//    The G rows' partial dot products are summed over the group by one
//    butterfly
//    (`group_sums`: 16 shuffles a key for 8 rows where reducing each row
//    alone takes 32); U keys a group are folded into its online softmax
//    with one rescale, V converted one key at a time;
//  * bytes in flight from registers: a group's next U keys are loaded
//    into a register double buffer while its current U are folded, ~16 KB
//    of K/V in flight a CTA; the plan aims just under two CTAs an SM (the
//    ~32 KB an SM the card needs) and keeps the grid in one wave of
//    resident CTAs.  A shared-memory ring (each thread `cp.async`-copying
//    its own words of the next steps, four 8 KB stages) kept more bytes in
//    flight for fewer registers and was slower at every shape measured on
//    the H100 (PERF.md);
//  * the groups' partial (m, l, acc) merge through shared memory and
//    divide by l there.
//
// Context-parallel decode (core/distributed_decode.py) reads one rank's
// slice of a cache sharded along its sequence: `kv_start` is the global
// position of the slice's row 0 and kv_len stays global, so the slice's
// valid keys are the global range [max(kv_len - window, 0), kv_len) cut
// to [kv_start, kv_start + S).  With `lse` given the launch also writes
// each row's log-sum-exp m + log(l) of its scaled (and softcapped)
// scores, float32, for the ranks' merge, and `out` is float32 too: the
// merge weighs the partials unrounded, so a merged row is rounded to the
// model's dtype once, as one launch over the whole cache rounds it.  A
// row whose slice holds no valid key writes 0 and NEG_INF, which the
// merge weighs at zero.  The split plan and the launch are those of
// kv_start 0 with no lse.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "decode_split.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NUM_THREADS = 128;
constexpr int VEC = 8;               // elements of a row per thread

// 16-byte words of a thread's VEC elements: 1 (bf16) or 2 (float32)
template <typename T>
__host__ __device__ constexpr int words() {
  return (int)sizeof(T) * VEC / 16;
}

// threads a key row: D / VEC rounded up to a power of two
template <int D>
__host__ __device__ constexpr int group_threads() {
  int t = 1;
  while (t < D / VEC) t *= 2;
  return t;
}

template <int W>
__device__ __forceinline__ void load_raw(const void* p, uint4 (&r)[W]) {
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

// Every lane of a group of TG lanes gets the G sums over the group of
// v[0..G): a butterfly that halves the values a lane holds at each of the
// first log2(G) levels (lanes with the level's bit set keep the upper half),
// xor-adds of the one value left below that, then one broadcast a row from
// a lane that holds it.  (G - 1) + log2(TG / G) + G shuffles, against
// G * log2(TG) reducing each value alone.  Needs G <= TG, both powers of 2.
template <int G, int TG>
__device__ __forceinline__ void group_sums(float (&v)[G]) {
  constexpr unsigned FULL = 0xffffffffu;
  if constexpr (G == 1) {
#pragma unroll
    for (int o = TG / 2; o > 0; o >>= 1)
      v[0] += __shfl_xor_sync(FULL, v[0], o);
  } else {
    static_assert(G <= TG, "a lane must end with at most one row");
    const int li = threadIdx.x % TG;
    float w[G];
#pragma unroll
    for (int i = 0; i < G; ++i) w[i] = v[i];
#pragma unroll
    for (int h = G / 2, o = TG / 2; h >= 1; h /= 2, o /= 2) {
      const bool up = li & o;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = up ? w[i] : w[i + h];
        const float keep = up ? w[i + h] : w[i];
        w[i] = keep + __shfl_xor_sync(FULL, send, o);
      }
    }
    // lane li now holds the row whose bits are li's bits TG/2 .. TG/G
#pragma unroll
    for (int o = TG / (2 * G); o > 0; o >>= 1)
      w[0] += __shfl_xor_sync(FULL, w[0], o);
#pragma unroll
    for (int r = 0; r < G; ++r) {
      int src = 0;
#pragma unroll
      for (int h = G / 2, o = TG / 2; h >= 1; h /= 2, o /= 2)
        if (r & h) src += o;
      v[r] = __shfl_sync(FULL, w[0], src, TG);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_lens;
  void* out;
  float* partials;      // decode_split workspace
  int* counters;        // one per row tile, 0 between launches
  float* lse;           // (B, Hq) float32, or null
  int hq, hkv, s_max, kv_start;
  int64_t stride_b, stride_s, stride_h;   // cache strides, in elements
  int window, split_keys, n_split;
  float softcap, scale;
};

// f(out) with the output as T*, or as float* when the launch writes the
// log-sum-exp (the partial of a cross-rank merge, kept unrounded): one
// branch for a loop of stores, not one a store.
template <typename T, typename F>
__device__ __forceinline__ void with_out(const Args& a, F&& f) {
  if constexpr (std::is_same<T, float>::value) {
    f(static_cast<float*>(a.out));
  } else {
    if (a.lse == nullptr) f(static_cast<T*>(a.out));
    else f(static_cast<float*>(a.out));
  }
}

// grid: (B, Hkv * ceil(g / G), n_split); block: NUM_THREADS.
template <typename T, int D, int G>
__global__ void __launch_bounds__(NUM_THREADS)
flash_decode_kernel(const Args a) {
  static_assert(D % VEC == 0, "head_dim must be a multiple of 8");
  constexpr int TG = group_threads<D>();   // threads per key row
  constexpr int NG = NUM_THREADS / TG;     // thread groups per CTA
  constexpr int W = words<T>();
  // keys of a group a step: 4 for bf16, 2 for f32 and 8-row tiles (their
  // registers hold 8 query rows)
  constexpr int U = W == 1 && G < 8 ? 4 : 2;
  constexpr int KPS = NG * U;            // keys a step
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

  // the valid keys as rows of the slice: global [lo, len) minus kv_start
  const int len = a.kv_lens[b];
  const int lo = a.window > 0 ? max(len - a.window, 0) : 0;
  const int kv_end = min(len - a.kv_start, a.s_max);
  const int kv_begin = max(lo - a.kv_start, 0);
  const int n_keys = max(kv_end - kv_begin, 0);
  const int n_active = (n_keys + a.split_keys - 1) / a.split_keys;
  if (n_active == 0) {                   // no valid key: the row is 0
    if (split == 0) {
      with_out<T>(a, [&](auto* out) {
        for (int idx = threadIdx.x; idx < nrows * D; idx += NUM_THREADS)
          decode_split::store_out(out + (size_t)row0 * D + idx, 0.f);
      });
      if (a.lse != nullptr)
        for (int r = threadIdx.x; r < nrows; r += NUM_THREADS)
          a.lse[row0 + r] = NEG_INF;
    }
    return;
  }
  if (split >= n_active) return;
  const int s0 = kv_begin + split * a.split_keys;
  const int s1 = min(s0 + a.split_keys, kv_end);
  const int n_steps = (s1 - s0 + KPS - 1) / KPS;

  const int gi = threadIdx.x / TG;
  const int li = threadIdx.x % TG;
  const int d0 = li * VEC;
  // false in the lanes past D / VEC: they load nothing and hold zeros
  const bool cols = TG * VEC == D || d0 < D;
  const T* const q = static_cast<const T*>(a.q);
  float qr[G][VEC];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r < nrows && cols) {
      uint4 raw[W];
      load_raw(q + (size_t)(row0 + r) * D + d0, raw);
      to_float(raw, qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[r][e] = 0.f;
    }
  }

  const int64_t head = (int64_t)b * a.stride_b + (int64_t)h * a.stride_h + d0;
  const T* const kp = static_cast<const T*>(a.k) + head;
  const T* const vp = static_cast<const T*>(a.v) + head;

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  // fold step t's U keys of this group (positions past s1 are masked)
  auto fold = [&](int t, const uint4 (&kr)[U][W], const uint4 (&vr)[U][W]) {
    const int base = s0 + t * KPS + gi * U;
    float s[G][U];                       // scores, then weights
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC], part[G];
      to_float(kr[u], kf);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        part[r] = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) part[r] += qr[r][e] * kf[e];
      }
      group_sums<G, TG>(part);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float sc = part[r] * a.scale;
        if (a.softcap > 0.f) sc = a.softcap * tanhf(sc / a.softcap);
        s[r][u] = base + u < s1 ? sc : NEG_INF;
      }
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float mt = s[r][0];
#pragma unroll
      for (int u = 1; u < U; ++u) mt = fmaxf(mt, s[r][u]);
      const float mn = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - mn);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[r][u] = base + u < s1 ? expf(s[r][u] - mn) : 0.f;
        psum += s[r][u];
      }
      l[r] = l[r] * alpha + psum;
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] *= alpha;
    }
    // one key's V at a time: 8 floats live, whatever G is
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      to_float(vr[u], vf);
#pragma unroll
      for (int r = 0; r < G; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] += s[r][u] * vf[e];
    }
  };

  auto fetch = [&](int t, uint4 (&kr)[U][W], uint4 (&vr)[U][W]) {
    const int first = s0 + t * KPS + gi * U;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t off =
          (int64_t)(first + u < s1 ? first + u : s0) * a.stride_s;
      if (cols) {
        load_raw(kp + off, kr[u]);
        load_raw(vp + off, vr[u]);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w)
          kr[u][w] = vr[u][w] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  // uniform trip count for the whole CTA: the in-group shuffles need
  // every lane of the warp present
  uint4 kc[U][W], vc[U][W], kn[U][W], vn[U][W];
  fetch(0, kc, vc);
  for (int t = 0; t < n_steps; ++t) {
    if (t + 1 < n_steps) fetch(t + 1, kn, vn);
    fold(t, kc, vc);
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
    if (cols) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[gi][r][d0 + e] = acc[r][e];
    }
  }
  __syncthreads();

  // this CTA's (m, l, acc) per row: the output itself when the row's keys
  // fill one split, else a partial for decode_split's merge
  with_out<T>(a, [&](auto* out) {
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
        if (a.lse != nullptr && d == 0)
          a.lse[row0 + r] = decode_split::log_sum_exp(mx, lsum);
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
  });
  if (n_active == 1) return;
  int* const counter = a.counters + (size_t)b * a.hkv * n_tiles + blockIdx.y;
  if (decode_split::arrive_last(counter, n_active))
    decode_split::merge_rows(a.partials, row0, nrows, a.n_split, n_active, D,
                             static_cast<T*>(a.out), counter, a.lse);
}

template <typename T, int D, int G>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int g = a.hq / a.hkv;
  const dim3 grid(B, a.hkv * ((g + G - 1) / G), a.n_split);
  flash_decode_kernel<T, D, G><<<grid, NUM_THREADS, 0, stream>>>(a);
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
    case 80:
      return dispatch_g<T, 80>(a, B, stream);
    case 96:
      return dispatch_g<T, 96>(a, B, stream);
    case 128:
      return dispatch_g<T, 128>(a, B, stream);
    case 256:
      return dispatch_g<T, 256>(a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, D) contiguous; k/v caches with element strides stride_b /
// stride_s / stride_h over (batch, token, kv head) and a contiguous head
// dim, s_max tokens each; kv_len (B,) int32; out (B, Hq, D) contiguous.
// dtype 0 = float32, 1 = bfloat16.  window <= 0 and softcap <= 0 mean
// "none".  kv_start: the global position of the caches' row 0 (0 for a
// whole cache); lse: (B, Hq) float32, or null for none; with lse, out is
// float32 whatever dtype says.  Split-KV:
// split_keys keys a CTA; n_split = ceil(span / split_keys), span = s_max,
// or the window where it is smaller.
// partials: at least B * Hq * n_split * (D + 2) floats; counters: at least
// B * Hq int32, all 0 (each launch leaves them 0).  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int flash_decode(const void* q, const void* k_cache,
                            const void* v_cache, const void* kv_len,
                            void* out, void* partials, void* counters,
                            void* lse, int B, int hq, int hkv, int s_max,
                            int kv_start, int d,
                            long long stride_b, long long stride_s,
                            long long stride_h, int window, int split_keys,
                            float softcap, float scale, int dtype,
                            void* stream) {
  if (B <= 0 || hkv <= 0 || hq % hkv != 0 || s_max <= 0 || split_keys <= 0
      || kv_start < 0)
    return (int)cudaErrorInvalidValue;
  const int span = window > 0 ? min(window, s_max) : s_max;
  const int n_split = (span + split_keys - 1) / split_keys;
  if (n_split > 65535) return (int)cudaErrorInvalidValue;   // grid.z
  const Args a{q, k_cache, v_cache, static_cast<const int*>(kv_len), out,
               static_cast<float*>(partials), static_cast<int*>(counters),
               static_cast<float*>(lse), hq, hkv, s_max, kv_start, stride_b,
               stride_s, stride_h, window, split_keys, n_split, softcap,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_d<float>(d, a, B, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(d, a, B, s);
  return (int)cudaErrorInvalidValue;
}
