// Flash decode for Hopper (sm_90a): one query token per sequence against
// dense per-sequence KV caches, read through their strides.
//
// Replaces the TPU kernel `flash_decode_fwd`
// (src/repro/kernels/flash_decode/kernel.py, body `_kernel`).  Same
// function: softcap after the scale, then the window mask
// `pos >= kv_len - window`, then an f32 online softmax; a row with no valid
// key gives 0.  The TPU kernel streamed `block_kv` macro-blocks through VMEM
// over a sequential grid axis, padded the GQA group to 8 sublanes and
// clamped out-of-range blocks for the Pallas grid; none of that carries
// over.
//
// What bounds it on the H100: memory.  Every valid K and V row is read once
// (2 * kv_len * D * sizeof(T) bytes per kv head) against ~2 * g * kv_len * D
// multiply-adds, far below the ~295 FLOP/byte the card needs before compute
// matters.  The least time is 2 * B * Hkv * kv_len * D * bytes / 3.35 TB/s.
//
// What the design does about it (that of paged_decode.cu, with the page
// lookup replaced by strided addressing):
//  * one CTA per (sequence, kv head, tile of <= 8 query rows of its GQA
//    group), so each K/V row is read once for every query head sharing it;
//  * the cache is addressed through its batch, token and head strides, so
//    the "bshd" (B, S, Hkv, D) cache of the model and a "bhsd"
//    (B, Hkv, S, D) cache are both read in place -- the JAX facade
//    transposed "bshd" to (B, Hkv, S, D) before every launch, a copy of both
//    caches larger than the attention's own traffic;
//  * only the valid key range [max(kv_len - window, 0), kv_len) is walked;
//  * a "thread group" of D/8 threads owns one key at a time, each thread
//    loading 16 bytes of bf16 (8 values) of the K and V rows, so a group
//    reads a whole row in one coalesced transaction; each group keeps 4
//    keys' loads in flight before it reduces them (shuffles inside the
//    group) and folds them into its online softmax with one rescale;
//  * P multiplies V unnormalised in f32; the groups' partial (m, l, acc)
//    merge once at the end through shared memory and divide by l there.
// Known limit (later work): at B * Hkv below the 132 SMs (llama2-7b at
// B=1 has 32 CTAs) most SMs idle on a long cache; split-KV across CTAs with
// an LSE merge would fill them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NUM_THREADS = 128;
constexpr int VEC = 8;      // elements of a row per thread (16 B of bf16)
constexpr int UNROLL = 4;   // keys in flight per thread group

__device__ __forceinline__ void load8(const float* p, float (&o)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&o)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// grid: (B, Hkv, ceil(g / G)); block: NUM_THREADS.  Strides in elements.
template <typename T, int D, int G>
__global__ void __launch_bounds__(NUM_THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    int hq, int hkv, int s_max, int64_t stride_b,
                    int64_t stride_s, int64_t stride_h, int window,
                    float softcap, float scale) {
  constexpr int TG = D / VEC;            // threads per key row
  constexpr int NG = NUM_THREADS / TG;   // thread groups per CTA
  static_assert(TG <= 32 && 32 % TG == 0, "a group must sit in one warp");

  __shared__ float sm_m[NG][G];
  __shared__ float sm_l[NG][G];
  __shared__ float sm_acc[NG][G][D];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int g = hq / hkv;
  const int r0 = blockIdx.z * G;         // first query row of the group
  const int nrows = min(G, g - r0);
  const int gi = threadIdx.x / TG;
  const int li = threadIdx.x % TG;
  const int d0 = li * VEC;

  float qr[G][VEC];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r < nrows) {
      load8(q + ((size_t)b * hq + (size_t)h * g + r0 + r) * D + d0, qr[r]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[r][e] = 0.f;
    }
  }

  const int len = kv_lens[b];
  const int kv_end = min(len, s_max);
  const int kv_begin = window > 0 ? max(len - window, 0) : 0;
  const int64_t base_off = (int64_t)b * stride_b + (int64_t)h * stride_h + d0;

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  // uniform trip count for the whole CTA: the in-group shuffles below
  // need every lane of the warp present
  for (int base0 = kv_begin; base0 < kv_end; base0 += NG * UNROLL) {
    const int base = base0 + gi * UNROLL;
    float kf[UNROLL][VEC], vf[UNROLL][VEC];
    bool valid[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int pos = base + u;
      valid[u] = pos < kv_end;
      const int p = valid[u] ? pos : kv_begin;
      const int64_t off = base_off + (int64_t)p * stride_s;
      load8(k_cache + off, kf[u]);
      load8(v_cache + off, vf[u]);
    }
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float s[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) part += qr[r][e] * kf[u][e];
#pragma unroll
        for (int o = TG / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        float sc = part * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        s[u] = valid[u] ? sc : NEG_INF;
      }
      float mt = s[0];
#pragma unroll
      for (int u = 1; u < UNROLL; ++u) mt = fmaxf(mt, s[u]);
      const float mn = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - mn);
      float p[UNROLL];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        p[u] = valid[u] ? expf(s[u] - mn) : 0.f;
        psum += p[u];
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) a += p[u] * vf[u][e];
        acc[r][e] = a;
      }
      m[r] = mn;
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

  for (int idx = threadIdx.x; idx < nrows * D; idx += NUM_THREADS) {
    const int r = idx / D;
    const int d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NG; ++j) mx = fmaxf(mx, sm_m[j][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const float w = expf(sm_m[j][r] - mx);
      lsum += sm_l[j][r] * w;
      a += sm_acc[j][r][d] * w;
    }
    const float o = lsum > 0.f ? a / lsum : 0.f;
    store1(out + ((size_t)b * hq + (size_t)h * g + r0 + r) * D + d, o);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* lens;
  void* out;
  int B, hq, hkv, s_max;
  int64_t stride_b, stride_s, stride_h;
  int window;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, int D, int G>
cudaError_t launch(const Args& a) {
  const int g = a.hq / a.hkv;
  const dim3 grid(a.B, a.hkv, (g + G - 1) / G);
  flash_decode_kernel<T, D, G><<<grid, NUM_THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.lens),
      static_cast<T*>(a.out), a.hq, a.hkv, a.s_max, a.stride_b, a.stride_s,
      a.stride_h, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(const Args& a) {
  const int g = a.hq / a.hkv;
  if (g == 1) return launch<T, D, 1>(a);
  if (g == 2) return launch<T, D, 2>(a);
  if (g <= 4) return launch<T, D, 4>(a);
  return launch<T, D, 8>(a);
}

template <typename T>
cudaError_t dispatch_d(int d, const Args& a) {
  switch (d) {
    case 64: return dispatch_g<T, 64>(a);
    case 128: return dispatch_g<T, 128>(a);
    case 256: return dispatch_g<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, D) contiguous; k/v caches with element strides stride_b /
// stride_s / stride_h over (batch, token, kv head) and a contiguous head
// dim, s_max tokens each; kv_len (B,) int32; out (B, Hq, D) contiguous.
// dtype 0 = float32, 1 = bfloat16.  window <= 0 and softcap <= 0 mean
// "none".  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int flash_decode(const void* q, const void* k_cache,
                            const void* v_cache, const void* kv_len,
                            void* out, int B, int hq, int hkv, int s_max,
                            int d, long long stride_b, long long stride_s,
                            long long stride_h, int window, float softcap,
                            float scale, int dtype, void* stream) {
  if (B <= 0 || hkv <= 0 || hq % hkv != 0 || s_max <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_cache, v_cache, kv_len, out, B, hq, hkv, s_max,
               stride_b, stride_s, stride_h, window, softcap, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch_d<float>(d, a);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(d, a);
  return (int)cudaErrorInvalidValue;
}
