// Chunkwise stabilised mLSTM forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `mlstm_chunkwise_fwd`
// (src/repro/kernels/mlstm/kernel.py, body `_kernel`).  It computes what
// the plain `ref.mlstm_chunkwise` computes: per chunk of L <= 128 rows, the
// log-sigmoid forget cumsum b, the decay matrix D_ij = b_i - b_j + i_j
// (j <= i), the row stabiliser m_row = max(max_j D_ij, m_prev + b_i), the
// causal intra-chunk term (q k^T * exp(D - m_row)) v, the inter-chunk term
// exp(m_prev + b_i - m_row) q C, den = max(|q . n_row|, exp(-m_row)), then
// the (C, n, m) update.  It returns h and the final (C, n, m).
//
// Layout: q, k, v and h are (B, H, S, D) tensors read and written through
// their batch, head and token strides (the head dim contiguous), so the
// model's (B, S, H, D) projections are read in place and h is written in
// the caller's layout.  The gates are contiguous (B, H, S) float32.
//
// What bounds it on the H100.  The useful work is ~2 * L / 2 * (2 dk + dv)
// operations per token for the causal intra-chunk half plus ~4 dk dv for
// q C and the k^T v update; at xlstm-125m's training shape (dk = dv = 384,
// L = 128) that is ~0.74 M operations per (b, h, token) against ~3 KB of
// bf16 q/k/v/h, so the least time is set by the bytes (~0.06 ms at
// B = 8, H = 4, S = 2048).  This kernel is plain FP32 FMA (no tensor
// cores), so its own floor is the 67 TFLOP/s FP32 rate, and the per-dv-tile
// recompute below adds to it: it is bound by FP32 issue, not by memory.
//
// The state does not fit one CTA.  At dk = dv = 384 one (b, h)'s C is
// 576 KB, 2.5x a CTA's 227 KB of shared memory (the Pallas kernel kept it
// whole in VMEM).  Columns of C, of the numerator and of h depend only on
// their own columns of v, so the grid is (ceil(dv / BV), H, B): each CTA
// owns a dk x BV slice of C in shared memory (BV = 64, or 32 where dk is
// large or dv small) and walks the chunks of its (b, h) in order -- the
// Pallas grid's sequential "arbitrary" axis becomes that loop.  Everything
// that does not depend on dv (b, D, m_row, the q.k scores, their row sums,
// q . n, n and m) is recomputed by every CTA of a (b, h); only the
// dv-tile-0 CTA writes the final n and m.  q . n_row is taken as the row
// sum of the weighted scores plus exp(m_prev + b_i - m_row) q . n_prev (the
// same sum, regrouped), so the L x dk n_row matrix is never formed.
//
// Per chunk, 256 threads as a 16 x 16 grid of register tiles:
//  A. gates: masked past the sequence end (i -> -1e30, log f -> 0: JAX's
//     sentinels, no infinities), b by a sequential scan, m_row, m_new and
//     the weights; the chunk's v columns staged in shared memory;
//  B. q k^T over dk in slices of 16 staged in shared memory, 8 x 8 rows x
//     keys a thread, key groups above a warp's last row skipped; in the
//     same pass q C_prev (8 x BV/16 a thread) and q . n_prev; then the
//     weights applied, the causal mask, and S^T stored in shared memory;
//  C. h = (S v + w_inter q C_prev) / den, written once in q's dtype;
//  D. C <- exp(m_prev + b_L - m_new) C + (k * w_k)^T v over dk in slices of
//     128 staged in the score buffer, and n likewise.
// All sums are f32.  Built without fast math: exp(-1e30 - x) is 0, and
// den may reach inf where m_row is very negative (then h = 0, as in the
// plain version).  Not yet done (later work): mma.sync/wgmma tiles, TMA
// staging, and sharing the dv-free work between the dv tiles of a (b, h).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;          // threads of a CTA (16 x 16 tiles)
constexpr int LMAX = 128;        // rows of a chunk
constexpr int SROW = LMAX + 4;   // row stride (floats) of the L x L tile
constexpr int DKS = 16;          // dk slice of q / k staged in phase B
constexpr int DKD = 128;         // dk slice of k staged in phase D
constexpr int NO_FIT = -2;       // status: dk does not fit shared memory

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// log(sigmoid(x)) = -softplus(-x), written without overflow
__device__ __forceinline__ float logsigmoid(float x) {
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ig;
  const float* fg;
  void* h;
  float* c_out;
  float* n_out;
  float* m_out;
  int B, H, S, dk, dv, L;
  float scale;
  int64_t qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, hsb, hsh, hss;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// shared memory of one CTA, in floats, in the order the kernel carves it
inline size_t smem_floats(int dk, int bv) {
  const size_t dkp = round_up(dk, DKD);
  return dkp * bv            // C slice (rows past dk stay 0)
         + LMAX * SROW       // S^T tile; in phase D the (k * w_k) slice
         + LMAX * bv         // v slice of the chunk
         + 2 * DKS * SROW    // q and k slices of phase B
         + dkp               // n
         + 7 * LMAX          // b, i, m_row, w_inter, w_k, q.n_prev, row sums
         + 4;                // m, m_new, w_C
}

// grid: (ceil(dv / BV), H, B); block: NT; dynamic shared memory
// smem_floats(dk, BV) floats.
template <typename T, int BV>
__global__ void __launch_bounds__(NT, 1)
mlstm_chunkwise_kernel(const Args a) {
  constexpr int NC = BV / 16;    // value columns a thread owns
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int dk = a.dk, dv = a.dv, L = a.L, S = a.S;
  const int dkp = round_up(dk, DKD);
  float* const Cs = smem;                    // [dkp][BV]
  float* const Ss = Cs + (size_t)dkp * BV;   // [LMAX][SROW]: S^T[j][i]
  float* const Vs = Ss + LMAX * SROW;        // [LMAX][BV]
  float* const Qs = Vs + LMAX * BV;          // [DKS][SROW]: q^T slice
  float* const Ks = Qs + DKS * SROW;         // [DKS][SROW]: k^T slice
  float* const ns = Ks + DKS * SROW;         // [dkp]
  float* const bsum = ns + dkp;              // [LMAX] each below
  float* const igs = bsum + LMAX;
  float* const mrow = igs + LMAX;
  float* const wis = mrow + LMAX;
  float* const wks = wis + LMAX;
  float* const qnp = wks + LMAX;
  float* const rsum = qnp + LMAX;
  float* const scal = rsum + LMAX;           // m, m_new, w_C

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5;
  const int v0 = blockIdx.x * BV;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const T* const qb =
      static_cast<const T*>(a.q) + bb * a.qsb + hh * a.qsh;
  const T* const kb =
      static_cast<const T*>(a.k) + bb * a.ksb + hh * a.ksh;
  const T* const vb =
      static_cast<const T*>(a.v) + bb * a.vsb + hh * a.vsh;
  T* const hb = static_cast<T*>(a.h) + bb * a.hsb + hh * a.hsh;
  const int64_t bh = (int64_t)bb * a.H + hh;
  const float* const igb = a.ig + bh * S;
  const float* const fgb = a.fg + bh * S;

  for (int i = tid; i < dkp * BV; i += NT) Cs[i] = 0.f;
  for (int i = tid; i < dkp; i += NT) ns[i] = 0.f;
  if (tid == 0) scal[0] = NEG_INF;

  // a warp's rows are 16 * warp .. 16 * warp + 15; its keys j = tx + 16 c
  // with c > warp all lie above the diagonal
  const int cmax = warp;
  const int nchunks = (S + L - 1) / L;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * L;
    // ---- A. gates and the v slice ------------------------------------
    if (tid < LMAX) {
      const int t = t0 + tid;
      const bool ok = tid < L && t < S;
      igs[tid] = ok ? igb[t] : NEG_INF;
      bsum[tid] = ok ? logsigmoid(fgb[t]) : 0.f;
    }
    for (int idx = tid; idx < LMAX * BV; idx += NT) {
      const int j = idx / BV, c = idx % BV;
      const int t = t0 + j, v = v0 + c;
      Vs[idx] = (j < L && t < S && v < dv) ? ld(vb + t * a.vss + v) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < L; ++i) {
        acc += bsum[i];
        bsum[i] = acc;
      }
    }
    __syncthreads();
    const float m_prev = scal[0];
    const float btot = bsum[L - 1];
    if (tid < LMAX) {
      const int i = tid;
      float mr = 0.f, wi = 0.f, cand = NEG_INF;
      if (i < L) {
        const float bi = bsum[i];
        float mi = NEG_INF;
        for (int j = 0; j <= i; ++j) mi = fmaxf(mi, (bi - bsum[j]) + igs[j]);
        const float minter = m_prev + bi;
        mr = fmaxf(mi, minter);
        wi = expf(minter - mr);
        cand = (btot - bi) + igs[i];
      }
      mrow[i] = mr;
      wis[i] = wi;
      wks[i] = cand;
    }
    __syncthreads();
    if (tid == 0) {
      float mx = NEG_INF;
#pragma unroll 8
      for (int j = 0; j < L; ++j) mx = fmaxf(mx, wks[j]);
      const float m_new = fmaxf(m_prev + btot, mx);
      scal[1] = m_new;
      scal[2] = expf((m_prev + btot) - m_new);
    }
    __syncthreads();
    if (tid < LMAX) wks[tid] = expf(wks[tid] - scal[1]);

    // ---- B. scores q k^T, q C_prev and q . n_prev --------------------
    float acc[8][8];
    float qc[8][NC];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) qc[r][c] = 0.f;
    }
    float qn = 0.f;
    for (int d0 = 0; d0 < dk; d0 += DKS) {
      for (int idx = tid; idx < LMAX * DKS; idx += NT) {
        const int i = idx / DKS, dd = idx % DKS;
        const int t = t0 + i, d = d0 + dd;
        const bool ok = i < L && t < S && d < dk;
        Qs[dd * SROW + i] = ok ? ld(qb + t * a.qss + d) * a.scale : 0.f;
        Ks[dd * SROW + i] = ok ? ld(kb + t * a.kss + d) : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int dd = 0; dd < DKS; ++dd) {
        float qa[8];
        load8(Qs + dd * SROW + ty * 8, qa);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (c <= cmax) {
            const float kv = Ks[dd * SROW + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 8; ++r) acc[r][c] = fmaf(qa[r], kv, acc[r][c]);
          }
        }
        const float* crow = Cs + (d0 + dd) * BV + tx;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float cv = crow[16 * c];
#pragma unroll
          for (int r = 0; r < 8; ++r) qc[r][c] = fmaf(qa[r], cv, qc[r][c]);
        }
      }
      if (tid < L) {
#pragma unroll
        for (int dd = 0; dd < DKS; ++dd)
          qn = fmaf(Qs[dd * SROW + tid], ns[d0 + dd], qn);
      }
      __syncthreads();
    }
    if (tid < LMAX) qnp[tid] = qn;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty * 8 + r;
      const float bi = bsum[i], mi = mrow[i];
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = tx + 16 * c;
        float sv = 0.f;
        if (c <= cmax && j <= i && i < L)
          sv = acc[r][c] * expf(((bi - bsum[j]) + igs[j]) - mi);
        Ss[j * SROW + i] = sv;
        rs += sv;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      if (tx == 0) rsum[i] = rs;
    }
    __syncthreads();

    // ---- C. h = (S v + w_inter q C_prev) / den -----------------------
    {
      float sv[8][NC];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) sv[r][c] = 0.f;
      const int jmax = min(L, 16 * (warp + 1));
      for (int j = 0; j < jmax; ++j) {
        float s[8];
        load8(Ss + j * SROW + ty * 8, s);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = Vs[j * BV + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 8; ++r) sv[r][c] = fmaf(s[r], vv, sv[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty * 8 + r;
        const int t = t0 + i;
        if (i < L && t < S) {
          const float wi = wis[i];
          const float den =
              fmaxf(fabsf(rsum[i] + wi * qnp[i]), expf(-mrow[i]));
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int v = v0 + tx + 16 * c;
            if (v < dv)
              st(hb + t * a.hss + v, (sv[r][c] + wi * qc[r][c]) / den);
          }
        }
      }
    }
    __syncthreads();

    // ---- D. state update: C, n ----------------------------------------
    const float wC = scal[2];
    for (int d0 = 0; d0 < dkp; d0 += DKD) {
      for (int idx = tid; idx < LMAX * DKD; idx += NT) {
        const int j = idx / DKD, dd = idx % DKD;
        const int t = t0 + j, d = d0 + dd;
        Ss[j * SROW + dd] = (j < L && t < S && d < dk)
                                ? ld(kb + t * a.kss + d) * wks[j]
                                : 0.f;
      }
      __syncthreads();
      float cu[8][NC];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) cu[r][c] = 0.f;
      for (int j = 0; j < L; ++j) {
        float kw[8];
        load8(Ss + j * SROW + ty * 8, kw);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = Vs[j * BV + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 8; ++r) cu[r][c] = fmaf(kw[r], vv, cu[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float* cp = Cs + (d0 + ty * 8 + r) * BV + tx;
#pragma unroll
        for (int c = 0; c < NC; ++c) cp[16 * c] = wC * cp[16 * c] + cu[r][c];
      }
      if (tid < DKD) {
        float s = 0.f;
        for (int j = 0; j < L; ++j) s += Ss[j * SROW + tid];
        ns[d0 + tid] = wC * ns[d0 + tid] + s;
      }
      __syncthreads();
    }
    if (tid == 0) scal[0] = scal[1];
  }
  __syncthreads();

  // ---- final state -----------------------------------------------------
  for (int idx = tid; idx < dk * BV; idx += NT) {
    const int d = idx / BV, c = idx % BV;
    const int v = v0 + c;
    if (v < dv) a.c_out[(bh * dk + d) * dv + v] = Cs[d * BV + c];
  }
  if (blockIdx.x == 0) {
    for (int i = tid; i < dk; i += NT) a.n_out[bh * dk + i] = ns[i];
    if (tid == 0) a.m_out[bh] = scal[0];
  }
}

template <typename T, int BV>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto* kern = mlstm_chunkwise_kernel<T, BV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.dv + BV - 1) / BV, a.H, a.B);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t s64 = smem_floats(a.dk, 64) * sizeof(float);
  const size_t s32 = smem_floats(a.dk, 32) * sizeof(float);
  if (a.dv > 32 && s64 <= (size_t)max_smem)
    return (int)launch<T, 64>(a, s64, stream);
  if (s32 <= (size_t)max_smem) return (int)launch<T, 32>(a, s32, stream);
  return NO_FIT;
}

}  // namespace

// q, k (B, H, S, dk) and v (B, H, S, dv) with element strides q_s* / k_s* /
// v_s* over (batch, head, token) and a contiguous last dim; i_gate, f_gate
// (B, H, S) contiguous float32; h (B, H, S, dv) with strides h_s*, in q's
// dtype; c_out (B, H, dk, dv), n_out (B, H, dk), m_out (B, H) contiguous
// float32.  chunk: 1..128 rows; scale: dk^-0.5.  dtype 0 = float32,
// 1 = bfloat16.  Launches on `stream`, allocates nothing; returns
// cudaGetLastError(), or -2 when dk does not fit shared memory.
extern "C" int mlstm_chunkwise(
    const void* q, const void* k, const void* v, const void* i_gate,
    const void* f_gate, void* h, void* c_out, void* n_out, void* m_out,
    int B, int H, int S, int dk, int dv, int chunk, float scale,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long h_sb, long long h_sh, long long h_ss,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || dk <= 0 || dv <= 0 || chunk <= 0 ||
      chunk > LMAX || chunk > S)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(i_gate),
               static_cast<const float*>(f_gate), h,
               static_cast<float*>(c_out), static_cast<float*>(n_out),
               static_cast<float*>(m_out), B, H, S, dk, dv, chunk, scale,
               q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, h_sb,
               h_sh, h_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}
