// Split-KV for the decode kernels: the partial softmax state of one split
// of a row's keys, and the merge of a row's splits by the last CTA of the
// launch to finish one.
//
// A split-KV decode launch runs n_split CTAs over consecutive ranges of a
// row's valid keys.  Where a row's keys fill more than one split, each
// active CTA writes, per query row, its partial (m, l, acc[d]): the running
// max m of its scores, l = sum exp(s - m) and acc = sum exp(s - m) v, f32.
// Then it arrives on the row tile's counter (`arrive_last`); the last of
// the n_active CTAs to arrive merges the partials with the log-sum-exp rule
//     M = max_s m_s,  out = sum_s e^{m_s - M} acc_s / sum_s e^{m_s - M} l_s
// (`merge_rows`), writes the output and sets the counter back to 0, so the
// next launch on the stream finds every counter at 0 without a memset.
// The merge runs in the same launch: a decode step gains no launch.
//
// Workspace (the wrapper keeps it per device and grows it): partials of
// `partial_floats(d)` floats at [row][split] (row = the output row: batch
// x query head), and one int counter per row tile, zero when no launch is
// running.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_split {

// floats of one partial: m, l, then the d accumulator values
__host__ __device__ constexpr int partial_floats(int d) { return d + 2; }

__device__ __forceinline__ float* partial(float* ws, int row, int split,
                                          int n_split, int d) {
  return ws + ((size_t)row * n_split + split) * partial_floats(d);
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Called by every thread of the CTA after it wrote its partials.  True,
// for the whole CTA, in the last of the `n_active` CTAs sharing `counter`
// to arrive; that CTA then sees the partials of all of them.
__device__ __forceinline__ bool arrive_last(int* counter, int n_active) {
  __shared__ int last;
  __threadfence();               // this thread's partials before the count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n_active - 1;
  __syncthreads();
  return last != 0;
}

// A row's log-sum-exp from its running max m and sum l = sum exp(s - m).
__device__ __forceinline__ float log_sum_exp(float m, float l) {
  return m + logf(l);
}

// out[(row0 + r) * d + c] for r < nrows, c < d: the merge of the first
// n_active partials of each row, and with `lse` given its log-sum-exp
// M + log(L) at lse[row0 + r] and `out` float32 whatever T is (the
// partial of a cross-rank merge, kept unrounded).  Partials are read
// through L2 (__ldcg): other SMs wrote them in this launch.  Sets
// *counter to 0 at the end.
template <typename T>
__device__ void merge_rows(const float* ws, int row0, int nrows, int n_split,
                           int n_active, int d, T* out, int* counter,
                           float* lse = nullptr) {
  const int pf = partial_floats(d);
  for (int idx = threadIdx.x; idx < nrows * d; idx += blockDim.x) {
    const int r = idx / d, c = idx % d;
    const float* p = ws + (size_t)(row0 + r) * n_split * pf;
    float mx = -1e30f;
    for (int s = 0; s < n_active; ++s) mx = fmaxf(mx, __ldcg(p + s * pf));
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_active; ++s) {
      const float w = expf(__ldcg(p + s * pf) - mx);
      l += __ldcg(p + s * pf + 1) * w;
      a += __ldcg(p + s * pf + 2 + c) * w;
    }
    const float o = l > 0.f ? a / l : 0.f;
    const size_t i = (size_t)(row0 + r) * d + c;
    if (lse == nullptr) {
      store_out(out + i, o);
    } else {
      reinterpret_cast<float*>(out)[i] = o;
      if (c == 0) lse[row0 + r] = log_sum_exp(mx, l);
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

}  // namespace decode_split
