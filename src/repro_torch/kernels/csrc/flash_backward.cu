// Backward of the prefill flash attention for Hopper (sm_90a), plain
// CUDA C++.
//
// Differentiates the function that the Pallas TPU kernel
//   repro/kernels/flash_attention/kernel.py::flash_attention
// computes (and flash_prefill.cu computes on this card).  The Pallas
// kernel has no backward: the JAX package trains through XLA's autodiff
// of L.chunked_attention (repro/models/model.py:257).  The port's model
// runs the forward kernel, so its training step needs this gradient.
//
// Semantics: for O = softmax(mask(softcap(Q.K^T / sqrt(Dh)))) . V with
// q/o/dO (B, Sq, Hq, Dh) and k/v (B, Skv, Hkv, Dh), GQA (kv head = q head
// / G), key j at position j and query i at position i, the causal mask,
// a window (i - j < window) and the tanh softcap, it writes dQ (B, Sq,
// Hq, Dh) and dK, dV (B, Skv, Hkv, Dh) in q's dtype, accumulated in
// float32.  Masked scores held the finite -1e30 in the forward and get
// no gradient.  The forward saved its float32 log-sum-exp lse = m +
// log(l) per (b, q head, row) (flash_prefill.cu, through its optional
// pointer), so P = exp(x - lse) is recomputed exactly where it was made.
// kv_len and q_start have no backward: the training path never passes
// them and the wrapper refuses them.
//
// Three launches on one stream, made by one C call:
//   1. delta = rowsum(dO . O) in float32, (B, Hq, Sq), one warp a row;
//   2. dK, dV: one block per (64-key tile, kv head, batch row), looping
//      over the G query heads of its kv head and, for each, over the
//      query tiles that can see its keys (causal: from the tile's first
//      key on; window: up to its last key + window).  Per tile it
//      recomputes S^T = K.Q^T and P^T, then dV += P^T.dO, dP^T = V.dO^T,
//      dS^T = P^T (dP^T - delta) times the softcap's 1 - tanh^2 and the
//      scale 1/sqrt(Dh), and dK += dS^T.Q;
//   3. dQ: one block per (64-row query tile, q head, batch row), looping
//      over the key tiles its rows can see: S, P and dS as above, and
//      dQ += dS.K.
// Every sum runs inside one block in a fixed order over fixed-length
// tiles: no float atomics, so a call repeats bitwise.
//
// bfloat16 bodies (the training path): four warps, each owning 16 rows
// of the block's tile (keys in pass 2, queries in pass 3), products on
// the tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulate)
// through mma_bf16.cuh.  The accumulator layout of S^T (or S) over two
// adjacent 8-column blocks is the A layout of the next product, so P and
// dS are rounded to bf16 in registers and never touch shared memory
// (FlashAttention-2's backward).  Operands stay bf16 in shared memory,
// rows padded by 16 bytes (no ldmatrix bank conflicts), staged by
// cp.async in a ring of two: pass 2 streams (Q, dO, lse, delta) tiles
// while its K/V tile stays put, pass 3 streams K/V tiles.  Tiles of 32
// instead of 64 at Dh = 128 keep the accumulators (dK and dV, or dQ and
// the Q/dO fragments) in registers.
//
// float32 bodies: the CUDA cores, four threads a row, as the forward's
// float32 body, so the float32 errors stay about 1e-6.
//
// What bounds it on the H100.  At minicpm-2b's training shape (B=4,
// S=1024, 36 heads of 64, causal) the backward does about 2.5x the
// forward's work, about 48 GFLOP against 151 MB of operands: operations
// bound it (0.049 ms at the bf16 peak).  This first version is the
// simple, correct one: mma.sync with cp.async, no wgmma, TMA or warp
// specialisation, and the dQ pass recomputes P beside the dK/dV pass
// rather than sharing it through atomics.  Making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Sq) from the forward
  float* delta;      // (B, Hq, Sq) scratch, written by pass 1
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, Hq, Hkv;
  int causal;
  int window;     // <= 0: none
  float softcap;  // <= 0: none
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Whether query row qi may attend to key kj, as the forward masks.
__device__ __forceinline__ bool pair_valid(const Params& p, int qi, int kj) {
  if (qi >= p.Sq || kj >= p.Skv) return false;
  if (p.causal && kj > qi) return false;
  if (p.window > 0 && qi - kj >= p.window) return false;
  return true;
}

// The gradient of the loss at a raw score s = q.k, given dP = dO.v for
// the pair, the row's lse and delta; *prob receives P.
template <bool FAST>
__device__ __forceinline__ float grad_score(const Params& p, float s, float dp,
                                            float lse, float delta, bool ok,
                                            float* prob) {
  float x = s * p.scale;
  float dx = p.scale;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = p.softcap * t;
    dx *= 1.f - t * t;
  }
  const float pr = ok ? (FAST ? __expf(x - lse) : expf(x - lse)) : 0.f;
  *prob = pr;
  return pr * (dp - delta) * dx;
}

// The query rows [q_lo, q_hi) that can see some key of [k0, k_last].
__device__ __forceinline__ void query_range(const Params& p, int k0,
                                            int k_last, int* q_lo,
                                            int* q_hi) {
  *q_lo = p.causal ? k0 : 0;
  *q_hi = p.window > 0 ? min(p.Sq, k_last + p.window) : p.Sq;
}

// The keys [k_begin, k_end) that rows [q0, q_last] can see; k_begin is
// rounded down to a multiple of bk.
__device__ __forceinline__ void key_range(const Params& p, int q0, int q_last,
                                          int bk, int* k_begin, int* k_end) {
  *k_begin = p.window > 0 ? (max(0, q0 - p.window + 1) / bk) * bk : 0;
  *k_end = p.causal ? min(p.Skv, q_last + 1) : p.Skv;
}

// ---------------------------------------------------------------------------
// Pass 1: delta = rowsum(dO . O)
// ---------------------------------------------------------------------------

constexpr int DELTA_THREADS = 128;

template <typename T, int DH>
__global__ void __launch_bounds__(DELTA_THREADS) delta_kernel(Params p) {
  const int row = blockIdx.x * (DELTA_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.B * p.Sq * p.Hq) return;  // whole warps leave together
  const T* o = static_cast<const T*>(p.o) + (size_t)row * DH;
  const T* g = static_cast<const T*>(p.dout) + (size_t)row * DH;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32) acc += to_f(o[d]) * to_f(g[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % p.Hq;
    const int bi = row / p.Hq;  // b * Sq + i
    const int i = bi % p.Sq, b = bi / p.Sq;
    p.delta[((size_t)b * p.Hq + h) * p.Sq + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_BK = 32;               // keys per tile
constexpr int F_BQ = 32;               // queries per tile
constexpr int F_TPR = 4;               // threads per row
constexpr int F_THREADS = 32 * F_TPR;  // 128
constexpr int F_PER = 32 / F_TPR;      // pairs per thread per tile row

template <int DH>
constexpr size_t f_smem_bytes() {
  return sizeof(float) *
         (4 * 32 * (DH + 1) + 2 * 32 * (32 + 1) + 2 * 32);
}

// Pass 2, float32: one block per (32 keys, kv head, batch row); thread
// (key row, sub) scores queries sub + 4c of each tile.
template <int DH>
__global__ void __launch_bounds__(F_THREADS) dkdv_f32_kernel(Params p) {
  constexpr int QS = DH + 1;
  constexpr int DPT = DH / F_TPR;
  extern __shared__ float smem[];
  float* Ks = smem;                 // F_BK x QS
  float* Vs = Ks + F_BK * QS;       // F_BK x QS
  float* Qs = Vs + F_BK * QS;       // F_BQ x QS
  float* Gs = Qs + F_BQ * QS;       // F_BQ x QS (dO)
  float* Ps = Gs + F_BQ * QS;       // F_BK x (F_BQ + 1)
  float* Ss = Ps + F_BK * (F_BQ + 1);  // F_BK x (F_BQ + 1) (dS)
  float* Ls = Ss + F_BK * (F_BQ + 1);  // F_BQ (lse)
  float* Ds = Ls + F_BQ;               // F_BQ (delta)

  const float* __restrict__ q = static_cast<const float*>(p.q);
  const float* __restrict__ k = static_cast<const float*>(p.k);
  const float* __restrict__ v = static_cast<const float*>(p.v);
  const float* __restrict__ dout = static_cast<const float*>(p.dout);

  const int tid = threadIdx.x;
  const int row = tid / F_TPR, sub = tid % F_TPR;
  const int k0 = blockIdx.x * F_BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int kj = k0 + row;

  for (int i = tid; i < F_BK * DH; i += F_THREADS) {
    const int r = i / DH, d = i % DH;
    const bool ok = k0 + r < p.Skv;
    const size_t off = (((size_t)b * p.Skv + k0 + r) * p.Hkv + hk) * DH + d;
    Ks[r * QS + d] = ok ? k[off] : 0.f;
    Vs[r * QS + d] = ok ? v[off] : 0.f;
  }
  int q_lo, q_hi;
  query_range(p, k0, min(k0 + F_BK, p.Skv) - 1, &q_lo, &q_hi);
  const int q_begin = (q_lo / F_BQ) * F_BQ;

  float dk[DPT], dv[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) dk[j] = dv[j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = q_begin; q0 < q_hi; q0 += F_BQ) {
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < F_BQ * DH; i += F_THREADS) {
        const int r = i / DH, d = i % DH;
        const bool ok = q0 + r < p.Sq;
        const size_t off = (((size_t)b * p.Sq + q0 + r) * p.Hq + h) * DH + d;
        Qs[r * QS + d] = ok ? q[off] : 0.f;
        Gs[r * QS + d] = ok ? dout[off] : 0.f;
      }
      if (tid < F_BQ) {
        const bool ok = q0 + tid < p.Sq;
        const size_t r = ((size_t)b * p.Hq + h) * p.Sq + q0 + tid;
        Ls[tid] = ok ? p.lse[r] : 0.f;
        Ds[tid] = ok ? p.delta[r] : 0.f;
      }
      __syncthreads();

      float s[F_PER], dp[F_PER];
#pragma unroll
      for (int c = 0; c < F_PER; ++c) s[c] = dp[c] = 0.f;
      for (int d = 0; d < DH; ++d) {
        const float kd = Ks[row * QS + d], vd = Vs[row * QS + d];
#pragma unroll
        for (int c = 0; c < F_PER; ++c) {
          s[c] += kd * Qs[(sub + F_TPR * c) * QS + d];
          dp[c] += vd * Gs[(sub + F_TPR * c) * QS + d];
        }
      }
#pragma unroll
      for (int c = 0; c < F_PER; ++c) {
        const int qq = sub + F_TPR * c;
        float pr;
        const float ds = grad_score<false>(p, s[c], dp[c], Ls[qq], Ds[qq],
                                           pair_valid(p, q0 + qq, kj), &pr);
        Ps[row * (F_BQ + 1) + qq] = pr;
        Ss[row * (F_BQ + 1) + qq] = ds;
      }
      __syncwarp();  // a row's four threads are adjacent lanes of one warp
      for (int qq = 0; qq < F_BQ; ++qq) {
        const float pr = Ps[row * (F_BQ + 1) + qq];
        const float ds = Ss[row * (F_BQ + 1) + qq];
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dv[j] += pr * Gs[qq * QS + sub + F_TPR * j];
          dk[j] += ds * Qs[qq * QS + sub + F_TPR * j];
        }
      }
      __syncwarp();  // Ps and Ss are rewritten by the next tile
    }
  }
  if (kj < p.Skv) {
    const size_t off = (((size_t)b * p.Skv + kj) * p.Hkv + hk) * DH;
    float* dkd = static_cast<float*>(p.dk) + off;
    float* dvd = static_cast<float*>(p.dv) + off;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dkd[sub + F_TPR * j] = dk[j];
      dvd[sub + F_TPR * j] = dv[j];
    }
  }
}

// Pass 3, float32: one block per (32 query rows, q head, batch row);
// thread (query row, sub) scores keys sub + 4c of each tile.
template <int DH>
__global__ void __launch_bounds__(F_THREADS) dq_f32_kernel(Params p) {
  constexpr int QS = DH + 1;
  constexpr int DPT = DH / F_TPR;
  extern __shared__ float smem[];
  float* Qs = smem;                 // F_BQ x QS
  float* Gs = Qs + F_BQ * QS;       // F_BQ x QS (dO)
  float* Ks = Gs + F_BQ * QS;       // F_BK x QS
  float* Vs = Ks + F_BK * QS;       // F_BK x QS
  float* Ss = Vs + F_BK * QS;       // F_BQ x (F_BK + 1) (dS)

  const float* __restrict__ q = static_cast<const float*>(p.q);
  const float* __restrict__ k = static_cast<const float*>(p.k);
  const float* __restrict__ v = static_cast<const float*>(p.v);
  const float* __restrict__ dout = static_cast<const float*>(p.dout);

  const int tid = threadIdx.x;
  const int row = tid / F_TPR, sub = tid % F_TPR;
  const int q0 = blockIdx.x * F_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int qi = q0 + row;

  for (int i = tid; i < F_BQ * DH; i += F_THREADS) {
    const int r = i / DH, d = i % DH;
    const bool ok = q0 + r < p.Sq;
    const size_t off = (((size_t)b * p.Sq + q0 + r) * p.Hq + h) * DH + d;
    Qs[r * QS + d] = ok ? q[off] : 0.f;
    Gs[r * QS + d] = ok ? dout[off] : 0.f;
  }
  float lse = 0.f, delta = 0.f;
  if (qi < p.Sq) {
    const size_t r = ((size_t)b * p.Hq + h) * p.Sq + qi;
    lse = p.lse[r];
    delta = p.delta[r];
  }
  int k_begin, k_end;
  key_range(p, q0, min(q0 + F_BQ, p.Sq) - 1, F_BK, &k_begin, &k_end);

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += F_BK) {
    __syncthreads();  // the previous tile's readers are done (Q staged)
    for (int i = tid; i < F_BK * DH; i += F_THREADS) {
      const int r = i / DH, d = i % DH;
      const bool ok = kt + r < p.Skv;
      const size_t off = (((size_t)b * p.Skv + kt + r) * p.Hkv + hk) * DH + d;
      Ks[r * QS + d] = ok ? k[off] : 0.f;
      Vs[r * QS + d] = ok ? v[off] : 0.f;
    }
    __syncthreads();
    float s[F_PER], dp[F_PER];
#pragma unroll
    for (int c = 0; c < F_PER; ++c) s[c] = dp[c] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float qd = Qs[row * QS + d], gd = Gs[row * QS + d];
#pragma unroll
      for (int c = 0; c < F_PER; ++c) {
        s[c] += qd * Ks[(sub + F_TPR * c) * QS + d];
        dp[c] += gd * Vs[(sub + F_TPR * c) * QS + d];
      }
    }
#pragma unroll
    for (int c = 0; c < F_PER; ++c) {
      const int kk = sub + F_TPR * c;
      float pr;
      Ss[row * (F_BK + 1) + kk] = grad_score<false>(
          p, s[c], dp[c], lse, delta, pair_valid(p, qi, kt + kk), &pr);
    }
    __syncwarp();
    for (int kk = 0; kk < F_BK; ++kk) {
      const float ds = Ss[row * (F_BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        acc[j] += ds * Ks[kk * QS + sub + F_TPR * j];
    }
  }
  if (qi < p.Sq) {
    float* dst = static_cast<float*>(p.dq) +
                 (((size_t)b * p.Sq + qi) * p.Hq + h) * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dst[sub + F_TPR * j] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int T_WARPS = 4;
constexpr int T_THREADS = 32 * T_WARPS;
constexpr int T_ROWS = 16 * T_WARPS;  // the block's own rows (keys or queries)

// the streamed tile's length: 64, or 32 at Dh = 128 (registers)
template <int DH>
__host__ __device__ constexpr int t_stream() {
  return DH > 80 ? 32 : 64;
}

template <int DH>
constexpr size_t dkdv_bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * T_ROWS + 4 * t_stream<DH>()) *
             (DH + 8) +
         sizeof(float) * 4 * t_stream<DH>();
}

template <int DH>
constexpr size_t dq_bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * T_ROWS + 4 * t_stream<DH>()) * (DH + 8);
}

// A fragments (row-major 16 x 16, rows r0.., cols ks*16..) of a shared
// tile with row stride LDS.
template <int LDS>
__device__ __forceinline__ void load_a(uint32_t a[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int ks, int lane) {
  mma::ldmatrix_x4(a, tile + (r0 + (lane & 15)) * LDS + ks * 16 +
                          (lane >> 4) * 8);
}

// B fragments of two n-blocks (rows nb*16 .. +15 of the tile as n, cols
// ks*16 .. +15 as k): b[0], b[1] for n-block 2nb, b[2], b[3] for 2nb+1.
template <int LDS>
__device__ __forceinline__ void load_b_rows(uint32_t b[4],
                                            const __nv_bfloat16* tile, int nb,
                                            int ks, int lane) {
  mma::ldmatrix_x4(b, tile + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                 LDS + ks * 16 + ((lane >> 3) & 1) * 8);
}

// B fragments of two n-blocks read transposed (rows kk*16 .. +15 of the
// tile as k, cols db*16 .. +15 as n).
template <int LDS>
__device__ __forceinline__ void load_b_cols(uint32_t b[4],
                                            const __nv_bfloat16* tile, int kk,
                                            int db, int lane) {
  mma::ldmatrix_x4_trans(
      b, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
             db * 16 + (lane >> 4) * 8);
}

// The C fragments of a 16 x 16 block pair (c[2kk], c[2kk+1]) as a bf16 A
// fragment.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = mma::pack_bf16x2(c0[0], c0[1]);
  a[1] = mma::pack_bf16x2(c0[2], c0[3]);
  a[2] = mma::pack_bf16x2(c1[0], c1[1]);
  a[3] = mma::pack_bf16x2(c1[2], c1[3]);
}

// Pass 2, bf16: one block per (64 keys, kv head, batch row), warp w
// owning keys w*16 .. +15; streams (Q, dO, lse, delta) tiles of BQ rows
// over the G heads and the visible query tiles.
template <int DH>
__global__ void __launch_bounds__(T_THREADS) dkdv_bf16_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int BQ = t_stream<DH>();
  constexpr int LDS = DH + 8;
  constexpr int CH = DH / 8;
  constexpr int KSTEPS = DH / 16;
  constexpr int SB = BQ / 8;  // score n-blocks (queries)
  constexpr int OB = DH / 8;  // output n-blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // T_ROWS x LDS
  bf16* Vs = Ks + T_ROWS * LDS;                   // T_ROWS x LDS
  bf16* Qs = Vs + T_ROWS * LDS;                   // 2 x BQ x LDS
  bf16* Gs = Qs + 2 * BQ * LDS;                   // 2 x BQ x LDS (dO)
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BQ * LDS);  // 2 x BQ
  float* Ds = Ls + 2 * BQ;                                  // 2 x BQ

  const bf16* __restrict__ q = static_cast<const bf16*>(p.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(p.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(p.v);
  const bf16* __restrict__ dout = static_cast<const bf16*>(p.dout);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * T_ROWS;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  int q_lo, q_hi;
  query_range(p, k0, min(k0 + T_ROWS, p.Skv) - 1, &q_lo, &q_hi);
  const int qt0 = q_lo / BQ;
  const int n_qt = q_hi > q_lo ? (q_hi - 1) / BQ - qt0 + 1 : 0;
  const int n_items = G * n_qt;  // (head, query tile), head-major

  for (int i = tid; i < T_ROWS * CH; i += T_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = k0 + r < p.Skv;
    const size_t off =
        ok ? (((size_t)b * p.Skv + k0 + r) * p.Hkv + hk) * DH + c * 8 : 0;
    mma::cp_async16(Ks + r * LDS + c * 8, k + off, ok);
    mma::cp_async16(Vs + r * LDS + c * 8, v + off, ok);
  }
  auto load_item = [&](int stage, int item) {
    const int h = hk * G + item / n_qt;
    const int q0 = (qt0 + item % n_qt) * BQ;
    bf16* qd = Qs + stage * BQ * LDS;
    bf16* gd = Gs + stage * BQ * LDS;
    for (int i = tid; i < BQ * CH; i += T_THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = q0 + r < p.Sq;
      const size_t off =
          ok ? (((size_t)b * p.Sq + q0 + r) * p.Hq + h) * DH + c * 8 : 0;
      mma::cp_async16(qd + r * LDS + c * 8, q + off, ok);
      mma::cp_async16(gd + r * LDS + c * 8, dout + off, ok);
    }
    for (int i = tid; i < BQ; i += T_THREADS) {
      const bool ok = q0 + i < p.Sq;
      const size_t r = ((size_t)b * p.Hq + h) * p.Sq + q0 + i;
      Ls[stage * BQ + i] = ok ? p.lse[r] : 0.f;
      Ds[stage * BQ + i] = ok ? p.delta[r] : 0.f;
    }
  };
  if (n_items > 0) load_item(0, 0);
  mma::cp_async_commit();

  float dk[OB][4], dv[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    mma::cp_async_wait<0>();
    __syncthreads();  // item it landed; every warp is done with item it - 1
    if (it + 1 < n_items) load_item((it + 1) & 1, it + 1);
    mma::cp_async_commit();
    const bf16* Qt = Qs + (it & 1) * BQ * LDS;
    const bf16* Gt = Gs + (it & 1) * BQ * LDS;
    const float* Lt = Ls + (it & 1) * BQ;
    const float* Dt = Ds + (it & 1) * BQ;
    const int q0 = (qt0 + it % n_qt) * BQ;

    // S^T = K.Q^T and dP^T = V.dO^T: this warp's 16 keys x BQ queries
    float st[SB][4], dpt[SB][4];
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t ka[4], va[4];
      load_a<LDS>(ka, Ks, warp * 16, ks, lane);
      load_a<LDS>(va, Vs, warp * 16, ks, lane);
#pragma unroll
      for (int nb = 0; nb < SB / 2; ++nb) {
        uint32_t qb[4], gb[4];
        load_b_rows<LDS>(qb, Qt, nb, ks, lane);
        load_b_rows<LDS>(gb, Gt, nb, ks, lane);
        mma::mma_bf16(st[2 * nb], ka, qb[0], qb[1]);
        mma::mma_bf16(st[2 * nb + 1], ka, qb[2], qb[3]);
        mma::mma_bf16(dpt[2 * nb], va, gb[0], gb[1]);
        mma::mma_bf16(dpt[2 * nb + 1], va, gb[2], gb[3]);
      }
    }
    // P^T into st, dS^T into dpt
#pragma unroll
    for (int j = 0; j < SB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + warp * 16 + gq + 8 * (e >> 1);
        const int qq = j * 8 + 2 * tq + (e & 1);
        float pr;
        const float ds =
            grad_score<true>(p, st[j][e], dpt[j][e], Lt[qq], Dt[qq],
                             pair_valid(p, q0 + qq, kj), &pr);
        st[j][e] = pr;
        dpt[j][e] = ds;
      }
    }
    // dV += P^T.dO and dK += dS^T.Q over the tile's queries
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], sa[4];
      c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      c_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int db = 0; db < DH / 16; ++db) {
        uint32_t gb[4], qb[4];
        load_b_cols<LDS>(gb, Gt, kk, db, lane);
        load_b_cols<LDS>(qb, Qt, kk, db, lane);
        mma::mma_bf16(dv[2 * db], pa, gb[0], gb[1]);
        mma::mma_bf16(dv[2 * db + 1], pa, gb[2], gb[3]);
        mma::mma_bf16(dk[2 * db], sa, qb[0], qb[1]);
        mma::mma_bf16(dk[2 * db + 1], sa, qb[2], qb[3]);
      }
    }
  }
  mma::cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = k0 + warp * 16 + gq + 8 * h;
    if (kj < p.Skv) {
      const size_t off =
          (((size_t)b * p.Skv + kj) * p.Hkv + hk) * DH + 2 * tq;
      bf16* dkd = static_cast<bf16*>(p.dk) + off;
      bf16* dvd = static_cast<bf16*>(p.dv) + off;
#pragma unroll
      for (int j = 0; j < OB; ++j) {
        *reinterpret_cast<uint32_t*>(dkd + 8 * j) =
            mma::pack_bf16x2(dk[j][2 * h], dk[j][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dvd + 8 * j) =
            mma::pack_bf16x2(dv[j][2 * h], dv[j][2 * h + 1]);
      }
    }
  }
}

// Pass 3, bf16: one block per (64 query rows, q head, batch row), warp w
// owning rows w*16 .. +15; streams K/V tiles of BK keys.
template <int DH>
__global__ void __launch_bounds__(T_THREADS) dq_bf16_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = t_stream<DH>();
  constexpr int LDS = DH + 8;
  constexpr int CH = DH / 8;
  constexpr int KSTEPS = DH / 16;
  constexpr int SB = BK / 8;  // score n-blocks (keys)
  constexpr int OB = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // T_ROWS x LDS
  bf16* Gs = Qs + T_ROWS * LDS;                   // T_ROWS x LDS (dO)
  bf16* Ks = Gs + T_ROWS * LDS;                   // 2 x BK x LDS
  bf16* Vs = Ks + 2 * BK * LDS;                   // 2 x BK x LDS

  const bf16* __restrict__ q = static_cast<const bf16*>(p.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(p.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(p.v);
  const bf16* __restrict__ dout = static_cast<const bf16*>(p.dout);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T_ROWS;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  int k_begin, k_end;
  key_range(p, q0, min(q0 + T_ROWS, p.Sq) - 1, BK, &k_begin, &k_end);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  for (int i = tid; i < T_ROWS * CH; i += T_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = q0 + r < p.Sq;
    const size_t off =
        ok ? (((size_t)b * p.Sq + q0 + r) * p.Hq + h) * DH + c * 8 : 0;
    mma::cp_async16(Qs + r * LDS + c * 8, q + off, ok);
    mma::cp_async16(Gs + r * LDS + c * 8, dout + off, ok);
  }
  auto load_tile = [&](int stage, int kt) {
    bf16* kd = Ks + stage * BK * LDS;
    bf16* vd = Vs + stage * BK * LDS;
    for (int i = tid; i < BK * CH; i += T_THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = kt + r < p.Skv;
      const size_t off =
          ok ? (((size_t)b * p.Skv + kt + r) * p.Hkv + hk) * DH + c * 8 : 0;
      mma::cp_async16(kd + r * LDS + c * 8, k + off, ok);
      mma::cp_async16(vd + r * LDS + c * 8, v + off, ok);
    }
  };
  if (n_tiles > 0) load_tile(0, k_begin);
  mma::cp_async_commit();

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + gq + 8 * hh;
    const size_t r = ((size_t)b * p.Hq + h) * p.Sq + qi;
    lse_r[hh] = qi < p.Sq ? p.lse[r] : 0.f;
    delta_r[hh] = qi < p.Sq ? p.delta[r] : 0.f;
  }

  uint32_t qf[KSTEPS][4], gf[KSTEPS][4];
  float acc[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    mma::cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < n_tiles) load_tile((it + 1) & 1, k_begin + (it + 1) * BK);
    mma::cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        load_a<LDS>(qf[ks], Qs, warp * 16, ks, lane);
        load_a<LDS>(gf[ks], Gs, warp * 16, ks, lane);
      }
    }
    const bf16* Kt = Ks + (it & 1) * BK * LDS;
    const bf16* Vt = Vs + (it & 1) * BK * LDS;
    const int kt = k_begin + it * BK;

    float s[SB][4], dp[SB][4];
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int nb = 0; nb < SB / 2; ++nb) {
        uint32_t kb[4], vb[4];
        load_b_rows<LDS>(kb, Kt, nb, ks, lane);
        load_b_rows<LDS>(vb, Vt, nb, ks, lane);
        mma::mma_bf16(s[2 * nb], qf[ks], kb[0], kb[1]);
        mma::mma_bf16(s[2 * nb + 1], qf[ks], kb[2], kb[3]);
        mma::mma_bf16(dp[2 * nb], gf[ks], vb[0], vb[1]);
        mma::mma_bf16(dp[2 * nb + 1], gf[ks], vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < SB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int qi = q0 + warp * 16 + gq + 8 * hh;
        const int kj = kt + j * 8 + 2 * tq + (e & 1);
        float pr;
        s[j][e] = grad_score<true>(p, s[j][e], dp[j][e], lse_r[hh],
                                   delta_r[hh], pair_valid(p, qi, kj), &pr);
      }
    }
    // dQ += dS.K over the tile's keys
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sa[4];
      c_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int db = 0; db < DH / 16; ++db) {
        uint32_t kb[4];
        load_b_cols<LDS>(kb, Kt, kk, db, lane);
        mma::mma_bf16(acc[2 * db], sa, kb[0], kb[1]);
        mma::mma_bf16(acc[2 * db + 1], sa, kb[2], kb[3]);
      }
    }
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + warp * 16 + gq + 8 * hh;
    if (qi < p.Sq) {
      bf16* dst = static_cast<bf16*>(p.dq) +
                  (((size_t)b * p.Sq + qi) * p.Hq + h) * DH + 2 * tq;
#pragma unroll
      for (int j = 0; j < OB; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            mma::pack_bf16x2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------------

template <typename T, int DH>
cudaError_t launch_delta(const Params& p, cudaStream_t stream) {
  const int rows = p.B * p.Sq * p.Hq;
  const int per_block = DELTA_THREADS / 32;
  delta_kernel<T, DH><<<(rows + per_block - 1) / per_block, DELTA_THREADS, 0,
                        stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch_delta<float, DH>(p, stream);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = f_smem_bytes<DH>();
  static size_t done_kv[mma::MAX_DEVICES] = {};
  static size_t done_q[mma::MAX_DEVICES] = {};
  err = mma::opt_in_smem(reinterpret_cast<const void*>(dkdv_f32_kernel<DH>),
                         smem, done_kv);
  if (err != cudaSuccess) return err;
  err = mma::opt_in_smem(reinterpret_cast<const void*>(dq_f32_kernel<DH>),
                         smem, done_q);
  if (err != cudaSuccess) return err;
  dkdv_f32_kernel<DH><<<dim3((p.Skv + F_BK - 1) / F_BK, p.Hkv, p.B),
                        F_THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_f32_kernel<DH><<<dim3((p.Sq + F_BQ - 1) / F_BQ, p.Hq, p.B), F_THREADS,
                      smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch_delta<__nv_bfloat16, DH>(p, stream);
  if (err != cudaSuccess) return err;
  constexpr size_t smem_kv = dkdv_bf16_smem_bytes<DH>();
  constexpr size_t smem_q = dq_bf16_smem_bytes<DH>();
  static size_t done_kv[mma::MAX_DEVICES] = {};
  static size_t done_q[mma::MAX_DEVICES] = {};
  err = mma::opt_in_smem(reinterpret_cast<const void*>(dkdv_bf16_kernel<DH>),
                         smem_kv, done_kv);
  if (err != cudaSuccess) return err;
  err = mma::opt_in_smem(reinterpret_cast<const void*>(dq_bf16_kernel<DH>),
                         smem_q, done_q);
  if (err != cudaSuccess) return err;
  dkdv_bf16_kernel<DH><<<dim3((p.Skv + T_ROWS - 1) / T_ROWS, p.Hkv, p.B),
                         T_THREADS, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_bf16_kernel<DH><<<dim3((p.Sq + T_ROWS - 1) / T_ROWS, p.Hq, p.B),
                       T_THREADS, smem_q, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (p.Hkv <= 0 || p.Hq % p.Hkv) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32<DH>(p, stream);
  if (dtype == 1) return launch_bf16<DH>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  delta is float32 scratch of B * Hq *
// Sq.  Returns the cudaError_t of the first launch that failed, else 0.
extern "C" int repro_flash_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int Dh, int causal,
    int window, float softcap, float scale, int dtype, void* stream) {
  Params p{q, k, v, o, dout, static_cast<const float*>(lse),
           static_cast<float*>(delta), dq, dk, dv, B, Sq, Skv, Hq, Hkv,
           causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 16: err = launch<16>(p, dtype, s); break;
    case 64: err = launch<64>(p, dtype, s); break;
    case 80: err = launch<80>(p, dtype, s); break;
    case 128: err = launch<128>(p, dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_flash_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
