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
// B = 8, H = 4, S = 2048).
//
// bfloat16: three launches, on the tensor cores (mma.sync m16n8k16, f32
// accumulators).  Only the scalar gate recurrence runs chunk after chunk
// alone; the state recurrence is parallel over state tiles and the outputs
// over chunks:
//  1. mlstm_chunkwise_gates, one CTA per (b, h): per chunk the masked gates
//     (past the sequence end i -> -1e30, log f -> 0: JAX's sentinels, no
//     infinities), b by a block scan, m_row by a prefix max of i_j - b_j,
//     w_inter = exp(m_prev + b_i - m_row), the state weights w_k =
//     exp(b_L - b_j + i_j - m_new) and w_C = exp(m_prev + b_L - m_new),
//     then m_prev = m_new.  Written to the workspace once per chunk.
//  2. mlstm_chunkwise_states, one CTA per (b, h, 64-row dk tile, 64-column
//     dv tile), 4 warps, 3 CTAs an SM: C's tile in f32 registers; per
//     chunk it writes the state before the chunk (C, and n in the dv-tile-0
//     CTAs) to the workspace, then C <- w_C C + (k * w_k)^T v, the k
//     fragments scaled by w_k and split in registers.
//  3. mlstm_chunkwise_outputs, one CTA per (b, h, chunk, 128-column dv
//     tile), 8 warps of 16 rows, one CTA an SM: over dk in slices of 64,
//     S = q k^T (the causal key tiles only) and q C_prev, and q . n_prev
//     in f32; then the decay weights, the row sums, den, S v, and h written
//     once.
// Operands that are bf16 inputs (q, k, v) go to the tensor cores as they
// are; an operand that is f32 in the plain version (k * w_k, C, the
// weighted scores S) is split into a bf16 high part and the bf16 rounding
// of its remainder, and both products accumulate in f32 (~2^-16 relative,
// where one bf16 rounding would be 2^-9).  dk^-0.5 multiplies the f32
// products.  q/k/v/C slices are staged by cp.async into two-slot rings
// (the next slice's loads in flight during this one's products), bf16 rows
// padded by 16 bytes so that ldmatrix reads hit distinct banks.  The
// workspace (from the wrapper) holds the state before every chunk and the
// gate records: B * H * ceil(S / L) * (dk * dv + dk + GATE_FLOATS) floats.
// What bounds it now: not the 0.2 GB of inputs but the tensor-core work
// with the splits (~100 GFLOP at xlstm-125m's training shape: ~0.76 ms,
// ~130 TFLOP/s, on an H100 SXM at 700 W) and the workspace's ~0.6 GB
// (written by 2, read by 3).
//
// float32: one launch of the FMA kernel below (no tensor cores).  The
// state does not fit one CTA (576 KB a (b, h) at dk = dv = 384), so the
// grid is (ceil(dv / BV), H, B): each CTA owns a dk x BV slice of C in
// shared memory (BV = 64, or 32 where dk is large or dv small) and walks
// the chunks of its (b, h) in order.  Everything that does not depend on
// dv (b, D, m_row, the q.k scores, their row sums, q . n, n and m) is
// recomputed by every CTA of a (b, h); only the dv-tile-0 CTA writes the
// final n and m.  q . n_row is taken as the row sum of the weighted
// scores plus exp(m_prev + b_i - m_row) q . n_prev (the same sum,
// regrouped), so the L x dk n_row matrix is never formed.  Per chunk, 256
// threads as a 16 x 16 grid of register tiles:
//  A. gates and the chunk's v columns staged in shared memory;
//  B. q k^T over dk in slices of 16 staged in shared memory, 8 x 8 rows x
//     keys a thread, key groups above a warp's last row skipped; in the
//     same pass q C_prev (8 x BV/16 a thread) and q . n_prev; then the
//     weights applied, the causal mask, and S^T stored in shared memory;
//  C. h = (S v + w_inter q C_prev) / den, written once;
//  D. C <- exp(m_prev + b_L - m_new) C + (k * w_k)^T v over dk in slices of
//     128 staged in the score buffer, and n likewise.
// All sums are f32.  Built without fast math: exp(-1e30 - x) is 0, and
// den may reach inf where m_row is very negative (then h = 0, as in the
// plain version).
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
  float* ws;            // the bf16 path's workspace (see carve)
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

// ---- float32: the FMA kernel ----------------------------------------------

// grid: (ceil(dv / BV), H, B); block: NT; dynamic shared memory
// smem_floats(dk, BV) floats.
template <int BV>
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
  const float* const qb =
      static_cast<const float*>(a.q) + bb * a.qsb + hh * a.qsh;
  const float* const kb =
      static_cast<const float*>(a.k) + bb * a.ksb + hh * a.ksh;
  const float* const vb =
      static_cast<const float*>(a.v) + bb * a.vsb + hh * a.vsh;
  float* const hb = static_cast<float*>(a.h) + bb * a.hsb + hh * a.hsh;
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
      Vs[idx] = (j < L && t < S && v < dv) ? vb[t * a.vss + v] : 0.f;
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
        Qs[dd * SROW + i] = ok ? qb[t * a.qss + d] * a.scale : 0.f;
        Ks[dd * SROW + i] = ok ? kb[t * a.kss + d] : 0.f;
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
              hb[t * a.hss + v] = (sv[r][c] + wi * qc[r][c]) / den;
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
                                ? kb[t * a.kss + d] * wks[j]
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

template <int BV>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto* kern = mlstm_chunkwise_kernel<BV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.dv + BV - 1) / BV, a.H, a.B);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

int dispatch_f32(const Args& a, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t s64 = smem_floats(a.dk, 64) * sizeof(float);
  const size_t s32 = smem_floats(a.dk, 32) * sizeof(float);
  if (a.dv > 32 && s64 <= (size_t)max_smem)
    return (int)launch<64>(a, s64, stream);
  if (s32 <= (size_t)max_smem) return (int)launch<32>(a, s32, stream);
  return NO_FIT;
}

// ---- bfloat16: the tensor-core path ----------------------------------------

constexpr int TK = 64;           // dk tile (state kernel) and dk slice
constexpr int TV = 64;           // dv tile of the state kernel
constexpr int TVO = 128;         // dv tile of the output kernel
constexpr int PAD = TK + 8;      // bf16 row stride of a staged 64-col tile
constexpr int PADO = TVO + 8;    // and of a 128-col tile
constexpr int GATE_FLOATS = 5 * LMAX + 4;   // a chunk's gate record (644)
constexpr int T_GATES = LMAX;    // threads of the three bf16 kernels
constexpr int T_STATES = 128;
constexpr int T_OUT = 256;

// a chunk's gate record in the workspace: b, i (masked), m_row, w_inter,
// w_k (LMAX each), then w_C
enum { G_B = 0, G_I = LMAX, G_M = 2 * LMAX, G_W = 3 * LMAX, G_K = 4 * LMAX,
       G_C = 5 * LMAX };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; valid false zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulators (not
// volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) = hi + lo: hi their bf16 rounding, lo the bf16 rounding of the
// remainder; each a packed pair, x0 in the low half
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - f.x, x1 - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ldmatrix lane addresses in a 16 x 16 tile: lane l points at row r16(l),
// column c16(l), which loads the four 8 x 8 matrices in the order (rows
// 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) -- an A fragment
// from a row-major [m][k] tile, or (transposed) the B fragments of two
// n-tiles from a [k][n] tile.  r16x / c16x give the order (0-7, 0-7),
// (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) -- the B fragments of two n-tiles
// from an [n][k] tile, or (transposed) an A fragment from a [k][m] tile.
__device__ __forceinline__ int r16(int l) { return (l & 7) + (l & 8); }
__device__ __forceinline__ int c16(int l) { return (l >> 4) << 3; }
__device__ __forceinline__ int r16x(int l) { return (l & 7) + ((l >> 4) << 3); }
__device__ __forceinline__ int c16x(int l) { return l & 8; }

struct Workspace {
  float* c;       // [B*H][nc][dk][dv]: C before each chunk
  float* n;       // [B*H][nc][dk]
  float* gates;   // [B*H][nc][GATE_FLOATS]
};

__host__ __device__ inline Workspace carve(const Args& a) {
  const size_t bhn = (size_t)a.B * a.H * ((a.S + a.L - 1) / a.L);
  Workspace w;
  w.c = a.ws;
  w.n = w.c + bhn * a.dk * a.dv;
  w.gates = w.n + bhn * a.dk;
  return w;
}

// inclusive scan over the LMAX threads of a CTA (sum or max); `part`
// holds LMAX / 32 floats and is free again when this returns
template <bool MAX>
__device__ __forceinline__ float block_scan(float x, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = MAX ? fmaxf(x, y) : x + y;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) x = MAX ? fmaxf(x, part[w]) : x + part[w];
  __syncthreads();
  return x;
}

// grid: B * H; block: T_GATES.  Thread i is row i of every chunk.
__global__ void __launch_bounds__(T_GATES)
mlstm_chunkwise_gates(const Args a) {
  __shared__ float part[LMAX / 32];
  __shared__ float btot_s, mnew_s;
  const int bh = blockIdx.x, i = threadIdx.x;
  const int L = a.L, S = a.S, nc = (S + L - 1) / L;
  const float* const igb = a.ig + (size_t)bh * S;
  const float* const fgb = a.fg + (size_t)bh * S;
  float* const rec0 = carve(a).gates + (size_t)bh * nc * GATE_FLOATS;
  float m_prev = NEG_INF;
  for (int ch = 0; ch < nc; ++ch) {
    const int t = ch * L + i;
    const bool ok = i < L && t < S;
    const float ig = ok ? igb[t] : NEG_INF;
    const float b = block_scan<false>(ok ? logsigmoid(fgb[t]) : 0.f, part);
    if (i == L - 1) btot_s = b;
    // max_{j <= i} (b_i - b_j + i_j) = b_i + max_{j <= i} (i_j - b_j)
    const float pm = block_scan<true>(ig - b, part);
    const float btot = btot_s;
    const float m_inter = m_prev + b;
    const float m_row = fmaxf(b + pm, m_inter);
    const float cand = i < L ? (btot - b) + ig : NEG_INF;
    // the scan's last value is the chunk's max
    const float cmax = block_scan<true>(cand, part);
    if (i == LMAX - 1) mnew_s = fmaxf(m_prev + btot, cmax);
    __syncthreads();
    const float mn = mnew_s;
    float* const rec = rec0 + (size_t)ch * GATE_FLOATS;
    rec[G_B + i] = b;
    rec[G_I + i] = ig;
    rec[G_M + i] = m_row;
    rec[G_W + i] = expf(m_inter - m_row);
    rec[G_K + i] = expf(cand - mn);
    if (i == 0) rec[G_C] = expf((m_prev + btot) - mn);
    m_prev = mn;
    __syncthreads();
  }
  if (i == 0) a.m_out[bh] = m_prev;
}

struct __align__(16) StateSmem {
  __nv_bfloat16 k[2][LMAX][PAD];   // ring: the chunk's k, dk tile
  __nv_bfloat16 v[2][LMAX][PAD];   // ring: the chunk's v, dv tile
  float wk[2][LMAX];               // ring: the chunk's w_k
};

// a packed pair of bf16 k values times their w_k, split into hi + lo
__device__ __forceinline__ void scale_split(uint32_t x, float2 w,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x));
  split2(f.x * w.x, f.y * w.y, hi, lo);
}

// grid: (ceil(dv / TV), ceil(dk / TK), B * H); block: T_STATES (4 warps,
// warp w owns rows 16 w .. 16 w + 15 of the dk tile, all TV columns);
// 73 KB of shared memory, so 3 CTAs an SM.
__global__ void __launch_bounds__(T_STATES, 3)
mlstm_chunkwise_states(const Args a) {
  extern __shared__ float4 smem4[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * TV, d0 = blockIdx.y * TK, bh = blockIdx.z;
  const int bb = bh / a.H, hh = bh % a.H;
  const int L = a.L, S = a.S, dk = a.dk, dv = a.dv;
  const int nc = (S + L - 1) / L;
  const __nv_bfloat16* const kb =
      static_cast<const __nv_bfloat16*>(a.k) + bb * a.ksb + hh * a.ksh;
  const __nv_bfloat16* const vb =
      static_cast<const __nv_bfloat16*>(a.v) + bb * a.vsb + hh * a.vsh;
  const Workspace w = carve(a);
  float* const cws = w.c + (size_t)bh * nc * dk * dv;
  float* const nws = w.n + (size_t)bh * nc * dk;
  const float* const gates = w.gates + (size_t)bh * nc * GATE_FLOATS;
  const bool has_n = blockIdx.x == 0;

  auto load = [&](int ch, int st) {
    const int t0 = ch * L;
    for (int idx = tid; idx < LMAX * 8; idx += T_STATES) {
      const int j = idx >> 3, c8 = (idx & 7) * 8;
      const bool okj = j < L && t0 + j < S;
      const size_t t = okj ? t0 + j : 0;
      const bool okk = okj && d0 + c8 < dk, okv = okj && v0 + c8 < dv;
      cp_async16(&sm.k[st][j][c8], kb + t * a.kss + (okk ? d0 + c8 : 0),
                 okk);
      cp_async16(&sm.v[st][j][c8], vb + t * a.vss + (okv ? v0 + c8 : 0),
                 okv);
    }
    if (tid < LMAX / 4)
      cp_async16(&sm.wk[st][tid * 4],
                 gates + (size_t)ch * GATE_FLOATS + G_K + tid * 4, true);
  };

  float c[TV / 8][4];
#pragma unroll
  for (int nt = 0; nt < TV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
  float n_acc = 0.f;              // n[d0 + tid], threads < TK of dv tile 0
  const int ra = d0 + warp * 16 + (lane >> 2);   // rows of c[.][0..1]
  auto store_c = [&](float* dst) {                // rows ra and ra + 8
#pragma unroll
    for (int nt = 0; nt < TV / 8; ++nt) {
      const int col = v0 + nt * 8 + 2 * (lane & 3);
      if (col >= dv) continue;
      if (ra < dk)
        *reinterpret_cast<float2*>(dst + (size_t)ra * dv + col) =
            make_float2(c[nt][0], c[nt][1]);
      if (ra + 8 < dk)
        *reinterpret_cast<float2*>(dst + (size_t)(ra + 8) * dv + col) =
            make_float2(c[nt][2], c[nt][3]);
    }
  };

  load(0, 0);
  cp_commit();
  for (int ch = 0; ch < nc; ++ch) {
    const int st = ch & 1;
    if (ch + 1 < nc) load(ch + 1, st ^ 1);
    cp_commit();
    // the state before chunk ch
    store_c(cws + (size_t)ch * dk * dv);
    if (has_n && tid < TK && d0 + tid < dk)
      nws[(size_t)ch * dk + d0 + tid] = n_acc;
    cp_wait<1>();
    __syncthreads();
    const float wC = gates[(size_t)ch * GATE_FLOATS + G_C];
    if (has_n && tid < TK) {
      float s = 0.f;
      for (int j = 0; j < L; ++j)
        s += __bfloat162float(sm.k[st][j][tid]) * sm.wk[st][j];
      n_acc = wC * n_acc + s;
    }
#pragma unroll
    for (int nt = 0; nt < TV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nt][e] *= wC;
    const int nk = (L + 15) >> 4;
    for (int kk = 0; kk < nk; ++kk) {
      // A = (k * w_k)^T: the bf16 k fragment (rows d, columns j), each
      // value times its w_k in f32, split into hi + lo in registers
      uint32_t kr[4], ah[4], al[4];
      ldsm_t(kr, &sm.k[st][kk * 16 + r16x(lane)][warp * 16 + c16x(lane)]);
      const int j0 = kk * 16 + 2 * (lane & 3);
      const float2 w0 = *reinterpret_cast<const float2*>(&sm.wk[st][j0]);
      const float2 w8 = *reinterpret_cast<const float2*>(&sm.wk[st][j0 + 8]);
      scale_split(kr[0], w0, ah[0], al[0]);
      scale_split(kr[1], w0, ah[1], al[1]);
      scale_split(kr[2], w8, ah[2], al[2]);
      scale_split(kr[3], w8, ah[3], al[3]);
      uint32_t bv[TV / 16][4];
#pragma unroll
      for (int np = 0; np < TV / 16; ++np)
        ldsm_t(bv[np], &sm.v[st][kk * 16 + r16(lane)][np * 16 + c16(lane)]);
      // the hi products of every n-tile, then the lo ones: no two
      // neighbouring products share an accumulator
#pragma unroll
      for (int nt = 0; nt < TV / 8; ++nt)
        mma(c[nt], ah, bv[nt / 2][2 * (nt & 1)], bv[nt / 2][2 * (nt & 1) + 1]);
#pragma unroll
      for (int nt = 0; nt < TV / 8; ++nt)
        mma(c[nt], al, bv[nt / 2][2 * (nt & 1)], bv[nt / 2][2 * (nt & 1) + 1]);
    }
    __syncthreads();
  }
  // the final state
  float* const c_out = a.c_out + (size_t)bh * dk * dv;
  store_c(c_out);
  if (has_n && tid < TK && d0 + tid < dk)
    a.n_out[(size_t)bh * dk + d0 + tid] = n_acc;
}

struct __align__(16) OutSmem {
  __nv_bfloat16 q[2][LMAX][PAD];   // ring: q, k of the chunk, a dk slice
  __nv_bfloat16 k[2][LMAX][PAD];
  float c[2][TK][TVO];             // ring: C_prev, dk slice x dv tile
  __nv_bfloat16 chi[TK][PADO];     // C_prev split
  __nv_bfloat16 clo[TK][PADO];
  __nv_bfloat16 v[LMAX][PADO];     // the chunk's v, dv tile
  float n[2][TK];                  // ring: n_prev, dk slice
  float gate[4][LMAX];             // b, i, m_row, w_inter
  float qn[LMAX];                  // q . n_prev (unscaled)
};

// grid: (ceil(dv / TVO), ceil(S / L), B * H); block: T_OUT (8 warps, warp
// w owns rows 16 w .. 16 w + 15 of the chunk, all TVO columns).
__global__ void __launch_bounds__(T_OUT, 1)
mlstm_chunkwise_outputs(const Args a) {
  extern __shared__ float4 smem4[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * TVO, ch = blockIdx.y, bh = blockIdx.z;
  const int bb = bh / a.H, hh = bh % a.H;
  const int L = a.L, S = a.S, dk = a.dk, dv = a.dv;
  const int nc = (S + L - 1) / L, t0 = ch * L;
  const __nv_bfloat16* const qb =
      static_cast<const __nv_bfloat16*>(a.q) + bb * a.qsb + hh * a.qsh;
  const __nv_bfloat16* const kb =
      static_cast<const __nv_bfloat16*>(a.k) + bb * a.ksb + hh * a.ksh;
  const __nv_bfloat16* const vb =
      static_cast<const __nv_bfloat16*>(a.v) + bb * a.vsb + hh * a.vsh;
  const Workspace w = carve(a);
  const size_t slot = (size_t)bh * nc + ch;
  const float* const cs = w.c + slot * dk * dv;
  const float* const ns = w.n + slot * dk;
  const float* const rec = w.gates + slot * GATE_FLOATS;

  auto load = [&](int ds, int st) {
    const int dd = ds * TK;
    for (int idx = tid; idx < LMAX * 8; idx += T_OUT) {
      const int j = idx >> 3, c8 = (idx & 7) * 8;
      const bool ok = j < L && t0 + j < S && dd + c8 < dk;
      const size_t t = ok ? t0 + j : 0;
      const int d = ok ? dd + c8 : 0;
      cp_async16(&sm.q[st][j][c8], qb + t * a.qss + d, ok);
      cp_async16(&sm.k[st][j][c8], kb + t * a.kss + d, ok);
    }
    for (int idx = tid; idx < TK * TVO / 4; idx += T_OUT) {
      const int d = idx / (TVO / 4), c4 = (idx % (TVO / 4)) * 4;
      const bool ok = dd + d < dk && v0 + c4 < dv;
      cp_async16(&sm.c[st][d][c4],
                 cs + (ok ? (size_t)(dd + d) * dv + v0 + c4 : 0), ok);
    }
    if (tid < TK / 4) {
      const bool ok = dd + tid * 4 < dk;
      cp_async16(&sm.n[st][tid * 4], ns + (ok ? dd + tid * 4 : 0), ok);
    }
  };

  // with the first slice: the chunk's v tile and its gate record
  for (int idx = tid; idx < LMAX * TVO / 8; idx += T_OUT) {
    const int j = idx / (TVO / 8), c8 = (idx % (TVO / 8)) * 8;
    const bool ok = j < L && t0 + j < S && v0 + c8 < dv;
    cp_async16(&sm.v[j][c8],
               vb + (ok ? (size_t)(t0 + j) * a.vss + v0 + c8 : 0), ok);
  }
  if (tid < LMAX) cp_async16(&sm.gate[0][0] + tid * 4, rec + tid * 4, true);
  load(0, 0);
  cp_commit();

  float s[LMAX / 8][4], o[TVO / 8][4];
#pragma unroll
  for (int nt = 0; nt < LMAX / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < TVO / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  float qn = 0.f;                 // row tid / 2, half tid % 2 of a slice
  const int nslice = (dk + TK - 1) / TK;
  for (int ds = 0; ds < nslice; ++ds) {
    const int st = ds & 1;
    if (ds + 1 < nslice) load(ds + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    for (int idx = tid; idx < TK * TVO / 8; idx += T_OUT) {
      const int d = idx / (TVO / 8), c8 = (idx % (TVO / 8)) * 8;
      const float4 x0 = *reinterpret_cast<const float4*>(&sm.c[st][d][c8]);
      const float4 x1 =
          *reinterpret_cast<const float4*>(&sm.c[st][d][c8 + 4]);
      uint32_t hi[4], lo[4];
      split2(x0.x, x0.y, hi[0], lo[0]);
      split2(x0.z, x0.w, hi[1], lo[1]);
      split2(x1.x, x1.y, hi[2], lo[2]);
      split2(x1.z, x1.w, hi[3], lo[3]);
      *reinterpret_cast<uint4*>(&sm.chi[d][c8]) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(&sm.clo[d][c8]) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    {
      const int row = tid >> 1, c0 = (tid & 1) * (TK / 2);
#pragma unroll
      for (int e8 = 0; e8 < TK / 16; ++e8) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(&sm.q[st][row][c0 + e8 * 8]);
        const __nv_bfloat162* q2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(q2[e]);
          qn = fmaf(f.x, sm.n[st][c0 + e8 * 8 + 2 * e], qn);
          qn = fmaf(f.y, sm.n[st][c0 + e8 * 8 + 2 * e + 1], qn);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t aq[4];
      ldsm(aq, &sm.q[st][warp * 16 + r16(lane)][kk * 16 + c16(lane)]);
#pragma unroll
      for (int np = 0; np < LMAX / 16; ++np) {
        if (np <= warp) {        // key tiles at or below the diagonal
          uint32_t bk[4];
          ldsm(bk, &sm.k[st][np * 16 + r16x(lane)][kk * 16 + c16x(lane)]);
          mma(s[2 * np], aq, bk[0], bk[1]);
          mma(s[2 * np + 1], aq, bk[2], bk[3]);
        }
      }
      // in two halves of the columns, to bound the fragments held
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        constexpr int NP = TVO / 32;
        uint32_t bh_[NP][4], bl[NP][4];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int col = (half * NP + p) * 16 + c16(lane);
          ldsm_t(bh_[p], &sm.chi[kk * 16 + r16(lane)][col]);
          ldsm_t(bl[p], &sm.clo[kk * 16 + r16(lane)][col]);
        }
#pragma unroll
        for (int n = 0; n < 2 * NP; ++n)
          mma(o[half * 2 * NP + n], aq, bh_[n / 2][2 * (n & 1)],
              bh_[n / 2][2 * (n & 1) + 1]);
#pragma unroll
        for (int n = 0; n < 2 * NP; ++n)
          mma(o[half * 2 * NP + n], aq, bl[n / 2][2 * (n & 1)],
              bl[n / 2][2 * (n & 1) + 1]);
      }
    }
    __syncthreads();
  }
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  if ((tid & 1) == 0) sm.qn[tid >> 1] = qn;
  __syncthreads();

  // decay weights on the scores, their row sums, den; rows ra and ra + 8
  const float scale = a.scale;
  const float* const gb = sm.gate[0];
  const float* const gi = sm.gate[1];
  const int ra = warp * 16 + (lane >> 2);
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < LMAX / 8; ++nt) {
    if (nt <= 2 * warp + 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ra + (e >> 1) * 8;
        const int j = nt * 8 + 2 * (lane & 3) + (e & 1);
        float x = 0.f;
        if (j <= i)
          x = s[nt][e] * scale *
              expf(((gb[i] - gb[j]) + gi[j]) - sm.gate[2][i]);
        s[nt][e] = x;
        rs[e >> 1] += x;
      }
    }
  }
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    const int i = ra + r * 8;
    const float wi = sm.gate[3][i] * scale;
    den[r] = fmaxf(fabsf(rs[r] + wi * sm.qn[i]), expf(-sm.gate[2][i]));
#pragma unroll
    for (int nt = 0; nt < TVO / 8; ++nt) {
      o[nt][2 * r] *= wi;
      o[nt][2 * r + 1] *= wi;
    }
  }
  // + S v, the key tiles at or below the diagonal
#pragma unroll
  for (int kk = 0; kk < LMAX / 16; ++kk) {
    if (kk <= warp) {
      uint32_t ah[4], al[4];
      split2(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split2(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
      uint32_t bv[TVO / 16][4];
#pragma unroll
      for (int np = 0; np < TVO / 16; ++np)
        ldsm_t(bv[np], &sm.v[kk * 16 + r16(lane)][np * 16 + c16(lane)]);
#pragma unroll
      for (int nt = 0; nt < TVO / 8; ++nt)
        mma(o[nt], ah, bv[nt / 2][2 * (nt & 1)], bv[nt / 2][2 * (nt & 1) + 1]);
#pragma unroll
      for (int nt = 0; nt < TVO / 8; ++nt)
        mma(o[nt], al, bv[nt / 2][2 * (nt & 1)], bv[nt / 2][2 * (nt & 1) + 1]);
    }
  }
  // h = (S v + w_inter q C_prev) / den, written once
  __nv_bfloat16* const hb =
      static_cast<__nv_bfloat16*>(a.h) + bb * a.hsb + hh * a.hsh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = ra + r * 8;
    if (i >= L || t0 + i >= S) continue;
    __nv_bfloat16* const hrow = hb + (size_t)(t0 + i) * a.hss;
#pragma unroll
    for (int nt = 0; nt < TVO / 8; ++nt) {
      const int col = v0 + nt * 8 + 2 * (lane & 3);
      if (col < dv)
        *reinterpret_cast<__nv_bfloat162*>(hrow + col) =
            __floats2bfloat162_rn(o[nt][2 * r] / den[r],
                                  o[nt][2 * r + 1] / den[r]);
    }
  }
}

cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  const int nc = (a.S + a.L - 1) / a.L;
  const int bh = a.B * a.H;
  mlstm_chunkwise_gates<<<bh, T_GATES, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlstm_chunkwise_states,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(StateSmem));
  if (err != cudaSuccess) return err;
  mlstm_chunkwise_states<<<dim3((a.dv + TV - 1) / TV, (a.dk + TK - 1) / TK,
                                bh),
                           T_STATES, sizeof(StateSmem), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlstm_chunkwise_outputs,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(OutSmem));
  if (err != cudaSuccess) return err;
  mlstm_chunkwise_outputs<<<dim3((a.dv + TVO - 1) / TVO, nc, bh), T_OUT,
                            sizeof(OutSmem), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k (B, H, S, dk) and v (B, H, S, dv) with element strides q_s* / k_s* /
// v_s* over (batch, head, token) and a contiguous last dim; i_gate, f_gate
// (B, H, S) contiguous float32; h (B, H, S, dv) with strides h_s*, in q's
// dtype; c_out (B, H, dk, dv), n_out (B, H, dk), m_out (B, H) contiguous
// float32.  chunk: 1..128 rows; scale: dk^-0.5.  dtype 0 = float32,
// 1 = bfloat16.  bfloat16 also needs dk, dv and every stride a multiple of
// 8, 16-byte aligned q/k/v, and `workspace`: B * H * ceil(S / chunk) *
// (dk * dv + dk + 644) float32 values, 16-byte aligned (float32 takes
// none: pass null).
// Launches on `stream`, allocates nothing; returns cudaGetLastError(), or
// -2 when dk does not fit the float32 kernel's shared memory.
extern "C" int mlstm_chunkwise(
    const void* q, const void* k, const void* v, const void* i_gate,
    const void* f_gate, void* h, void* c_out, void* n_out, void* m_out,
    void* workspace,
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
               static_cast<float*>(m_out), static_cast<float*>(workspace),
               B, H, S, dk, dv, chunk, scale,
               q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, h_sb,
               h_sh, h_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(a, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const long long steps[] = {dk, dv, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                             v_sb, v_sh, v_ss, h_sb, h_sh, h_ss};
  for (int i = 0; i < 14; ++i)
    if (steps[i] % 8) return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(workspace);
  if (workspace == nullptr || ptrs % 16) return (int)cudaErrorInvalidValue;
  return (int)launch_tc(a, st);
}
