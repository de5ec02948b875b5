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
// them and the wrapper refuses them.  Per valid (query, key) pair and q
// head the function needs five products of 2 Dh operations (S = q.k,
// dP = dO.v, dV += P dO, dK += dS q, dQ += dS k): 10 Dh.  At minicpm-2b's
// training shape (B=4, S=1024, 36 heads of 64, causal) that is 48 GFLOP
// against 151 MB of operands, so operations bound it (0.049 ms at the
// bf16 peak).
//
// One C call, on one stream, picks the body by (dtype, Dh); each body
// first computes delta = rowsum(dO . O) in float32, one warp a row.
//
// bfloat16 at Dh 64 and 128 (every model the port trains at full width):
// one pass on wgmma and TMA, FlashAttention-3's backward with dQ (and,
// for GQA, dK and dV) summed in a fixed order.  A persistent grid (as
// many blocks as fit on the SMs) takes work items from an int32 ticket
// counter, in increasing order.  An item is (key tile of 128 keys, batch
// row, kv head, split s): it takes G / n_split of the kv head's G query
// heads (w_split picks n_split from one batch row's shape and the
// resident blocks).  A block has three warpgroups:
//   - a producer thread loads the item's K and V once (TMA, 4-D maps over
//     (B, S, H, Dh) with a box of 64 columns, one head, the tile's rows
//     and one batch row, 128-byte swizzle: a ragged S reads zeros, never
//     the next batch row), then streams (Q, dO) tiles of 64 rows with
//     their lse and delta (one bulk copy from the pre-pass's tile-major
//     scratch) through a ring of two stages with full/empty mbarriers.
//     It runs ahead into the next item's first tiles, and at Dh 64 its K
//     and V into a second pair of tiles, while the consumers finish;
//   - two consumer warpgroups (setmaxnreg up) each own 64 of the keys.
//     Per tile: S^T = K.Q^T and dP^T = V.dO^T on wgmma (both operands in
//     shared memory, M = 64 keys, N = 64 queries, K = Dh); P^T and dS^T
//     in registers (exp2 of one FMA; the softcap's 1 - tanh^2; the scale
//     is applied to dK and dQ at the end, a mask only on tiles that
//     need one); dV += P^T.dO and dK += dS^T.Q on wgmma with A from
//     registers (the accumulator of S^T over 16 columns is the A
//     fragment of a k-step), dK and dV staying in registers over the
//     item and its heads; dS^T stored key-major as the fragments hold it,
//     then the tile's dQ partial dS.K (64 x Dh, split between the
//     warpgroups by columns, dS read MN-major) on wgmma, handed to a
//     writer through a float32 slot in shared memory.  At the item's end
//     dK and dV go out in bf16 through the K and V tiles and one TMA
//     store each;
//   - writer warps (three at Dh 64, two at Dh 128: as many as slots fit),
//     warp i taking every i-th slot, add the partials into a float32
//     scratch (B, Hq, query tile, 64, Dh) in key-tile order.
// So S and dP are made once per pair (10 Dh instead of the two-pass
// body's 14 Dh), and every product runs on wgmma with its operands
// brought by TMA.
//
// Fixed orders, no float atomics.  An int32 turn counter per (b, q head,
// query tile) counts the key tiles that have added their dQ partial.  The
// writer of key tile kt waits, one lane spinning on an acquire load,
// until it equals kt's rank among the key tiles that see the query tile
// (counted from the first), copies the sums so far (cp.async, L2 not
// L1), adds, stores and bumps the counter with a release.  The first
// contributor stores without reading (the scratch needs no zero fill);
// the last writes dQ in bf16 itself.  With n_split > 1 a (b, kv head, key
// tile)'s items add their dK and dV the same way, in split order, through
// float32 sums (one counter per (b, kv head, key tile) and warpgroup),
// the last writing bf16.  The orders are the key tiles' and the splits'
// own, and n_split does not depend on B, so a call repeats bitwise and a
// batch row alone equals that row in a batch.  The pre-pass writes dQ = 0
// for query rows no key can see.
//
// Items walk the key tiles from the first to the last (each over every
// batch row, kv head and split), and each item its query tiles from the
// last to the first.  Under the causal mask the first key tiles see the
// most query tiles, so the longest items start first and the grid ends
// on the shortest (the other order left a tenth of the grid idle at the
// end on the card); and every key tile reaches a query tile after the
// same number of tiles, so the partials of a query tile come in the order
// the items started, which is the order they are added.
//
// It cannot deadlock: blocks take items in increasing order and finish
// one before they start the next (the producer may prefetch the next
// item's tiles and K and V, which waits on nothing but the block's own
// consumers), and an item waits only on items before it: for dQ the key
// tiles before it in the same (b, q head), for dK and dV the splits
// before it at the same (b, kv head, key tile).  Tickets are handed out
// in order, so every item below the counter is held by a running block,
// and the smallest unfinished item waits on nothing: it runs to its end.
// This holds even when fewer blocks are resident than were launched (a
// block that has not started holds no item).
//
// bfloat16 at Dh 16 (the reduced configs) and 80 (hubert-xlarge, which
// the reference only runs forward, so no training path reaches it): a
// body of its own by design, since the wgmma body's tiles are 64-column
// slabs of 128 bytes (TMA boxes, the 128-byte swizzle, N of the dQ
// product), which 16 and 80 do not fill.  Two passes on mma.sync m16n8k16
// (mma_bf16.cuh), four warps, each owning 16 rows of the block's tile
// (keys in pass 2, queries in pass 3).  The accumulator layout of S^T
// (or S) over two adjacent 8-column blocks is the A layout of the next
// product, so P and dS are rounded to bf16 in registers and never touch
// shared memory (FlashAttention-2's backward).  Operands stay bf16 in
// shared memory, rows padded by 16 bytes (no ldmatrix bank conflicts),
// staged by cp.async in a ring of two: pass 2 (dK, dV; one block per 64
// keys, kv head and batch row) streams (Q, dO, lse, delta) tiles while
// its K/V tile stays put, pass 3 (dQ; one block per 64 query rows, q head
// and batch row, heaviest first) streams K/V tiles.  Every sum runs
// inside one block in a fixed order.
//
// float32 bodies: the CUDA cores, four threads a row, as the forward's
// float32 body, so the float32 errors stay about 1e-6; two passes like
// the mma.sync body.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, Sq) from the forward
  float* delta;      // two-pass bodies: (B, Hq, Sq) scratch
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, Hq, Hkv;
  int causal;
  int window;     // <= 0: none
  float softcap;  // <= 0: none
  float scale;
};

// The wgmma body's scratch and tile counts, on top of the above.
struct WParams : Params {
  float* ld;       // (B, Hq, n_qt, 2, 64) lse (base 2) and delta by tile
  float* dq_acc;   // (B, Hq, n_qt, 64, Dh) float32 dQ sums
  float* dkv_acc;  // G > 1: (2, B, Hkv, n_kt * 128, Dh) dK and dV sums
  int* ticket;     // the next work item
  int* turns;      // (B, Hq, n_qt) dQ partials added so far
  int* kv_turns;   // G > 1: (B, Hkv, n_kt, 2) heads added
  int n_qt, n_kt;  // query tiles of 64, key tiles of 128
  int n_split;     // items per (b, kv head, key tile), each G / n_split heads
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
__host__ __device__ __forceinline__ void query_range(const Params& p,
                                                     int k0,
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
// Two-pass bodies, pass 1: delta = rowsum(dO . O)
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
// float32: the CUDA cores, two passes
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
// bfloat16 at Dh 16 and 80: mma.sync, two passes
// ---------------------------------------------------------------------------

constexpr int T_WARPS = 4;
constexpr int T_THREADS = 32 * T_WARPS;
constexpr int T_ROWS = 16 * T_WARPS;  // the block's own rows (keys or queries)

constexpr int T_STREAM = 64;  // the streamed tile's length

template <int DH>
constexpr size_t dkdv_bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * T_ROWS + 4 * T_STREAM) *
             (DH + 8) +
         sizeof(float) * 4 * T_STREAM;
}

template <int DH>
constexpr size_t dq_bf16_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * T_ROWS + 4 * T_STREAM) * (DH + 8);
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
  constexpr int BQ = T_STREAM;
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
  constexpr int BK = T_STREAM;
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
// bfloat16 at Dh 64 and 128: one pass on wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int W_BK = 128;       // keys of an item, 64 per consumer warpgroup
constexpr int W_BQ = 64;        // query rows of a streamed tile
constexpr int W_THREADS = 384;  // consumers 0-255, producer 256, writers 288-383
constexpr int W_CONSUMERS = 256;
constexpr int W_CHUNK = 256;  // float4s of a writer's staged chunk
constexpr int W_LD = 2 * W_BQ;  // floats of a tile's lse and delta
// setmaxnreg: 2 x 128 x 232 + 128 x 40 = 64,512 of the SM's 65,536
constexpr int W_CONSUMER_REGS = 232;
constexpr int W_PRODUCER_REGS = 40;
constexpr int BAR_DS = 1;  // named barriers: the consumers' dS,
constexpr int BAR_KV = 2;  // each consumer warpgroup's dK, dV (2, 3)
constexpr float LOG2E = 1.4426950408889634f;

// Byte offsets in the block's shared memory (each tile 1024-aligned).
template <int DH>
struct WSmem {
  // the (Q, dO, lse, delta) ring
  static constexpr int STAGES = 2;
  static constexpr int SLABS = DH / 64;       // 64-column slabs of a row
  static constexpr int KV_SLAB = W_BK * 128;  // bytes of a slab of K or V
  static constexpr int T_SLAB = W_BQ * 128;   // of Q or dO
  static constexpr int TILE = SLABS * T_SLAB;
  static constexpr int DQ_TILE = W_BQ * DH * 4;  // a float32 dQ tile
  // dQ hand-off tiles, one per writer warp: three at Dh 64, two at Dh 128
  // (where three do not fit)
  static constexpr int SLOTS = DH == 64 ? 3 : 2;
  // the chunks of the sums so far a writer holds: the whole tile at Dh
  // 64 (one round trip), two at Dh 128 (one fetched ahead)
  static constexpr int CHUNKS = W_BQ * DH / 4 / W_CHUNK;
  static constexpr int STAGED_CHUNKS = DH == 64 ? CHUNKS : 2;
  static constexpr int STAGED = STAGED_CHUNKS * W_CHUNK * 16;
  // K and V tiles: two pairs at Dh 64, so the next item's load while an
  // item runs (pair i of them at KV + i * KV_PAIR, V after K)
  static constexpr int KV_BUFS = DH == 64 ? 2 : 1;
  static constexpr int KV_PAIR = 2 * SLABS * KV_SLAB;
  static constexpr size_t KV = 0;
  static constexpr size_t Q = KV + KV_BUFS * KV_PAIR;
  static constexpr size_t DO = Q + STAGES * TILE;
  static constexpr size_t DS = DO + STAGES * TILE;  // dS^T: 128 keys x 64
  static constexpr size_t DQ = DS + KV_SLAB;          // hand-off tiles
  static constexpr size_t ACC = DQ + SLOTS * DQ_TILE;  // the sums so far
  static constexpr size_t LD = ACC + SLOTS * STAGED;
  // full[STAGES], empty[STAGES], kv_full[KV_BUFS], kv_empty[KV_BUFS],
  // dq_full[SLOTS], dq_empty[SLOTS]
  static constexpr size_t BAR = LD + STAGES * W_LD * 4;
  // the item id of each K/V pair, then per hand-off tile (b, h, query
  // tile, rank, count)
  static constexpr size_t META =
      BAR + (2 * STAGES + 2 * KV_BUFS + 2 * SLOTS) * 8;
  static constexpr size_t BYTES = META + 16 + SLOTS * 8 * 4 + 1024;  // + align
  static_assert(BYTES <= 232448, "more shared memory than a block has");
};

// Float index of (row r, column c) in a dQ hand-off tile: columns XORed
// by 8 (r % 4), so the consumers' float2 stores of a warp hit every bank
// once and a float4 stays whole.
template <int DH>
__device__ __forceinline__ int dq_at(int r, int c) {
  return r * DH + (c ^ ((r & 3) << 3));
}

struct WItem {
  int b, hk, s, h0, n_h, kt, k0, qt0, n_qt;
};

// Item -> (key tile, batch row, kv head, split s of the kv head's G
// query heads): the key tiles from the first to the last, each over every
// (b, kv head), the n_split items of a key tile one after another; item s
// takes the n_h = G / n_split heads h0 .. h0 + n_h - 1 over its query
// tiles qt0 .. qt0 + n_qt - 1.  Under the causal mask the first key tiles
// see the most query tiles, so the longest items go first and the grid
// ends on the shortest.
__device__ __forceinline__ WItem w_item(const WParams& p, int item) {
  const int G = p.Hq / p.Hkv;
  WItem it;
  it.s = item % p.n_split;
  const int rest = item / p.n_split;
  const int grp = rest % (p.B * p.Hkv);
  it.kt = rest / (p.B * p.Hkv);
  it.hk = grp % p.Hkv;
  it.b = grp / p.Hkv;
  it.n_h = G / p.n_split;
  it.h0 = it.hk * G + it.s * it.n_h;
  it.k0 = it.kt * W_BK;
  int q_lo, q_hi;
  query_range(p, it.k0, min(it.k0 + W_BK, p.Skv) - 1, &q_lo, &q_hi);
  it.qt0 = q_lo / W_BQ;
  it.n_qt = q_hi > q_lo ? (q_hi - 1) / W_BQ - it.qt0 + 1 : 0;
  return it;
}

// Tile u of an item: its query tiles from the last to the first, the
// item's heads in turn at each.  Every key tile that sees query tile m
// reaches it after the same number of tiles, so the partials of m come in
// the order the items started: key-tile order, the order they are added.
__device__ __forceinline__ void w_tile(const WItem& it, int u, int* h, int* m) {
  *h = it.h0 + u % it.n_h;
  *m = it.qt0 + it.n_qt - 1 - u / it.n_h;
}

// The key tiles kt_lo .. kt_hi that see query tile m (none: kt_hi <
// kt_lo); the relation is the one w_item walks.
__device__ __forceinline__ void w_contributors(const Params& p, int m,
                                               int* kt_lo, int* kt_hi) {
  const int q0 = m * W_BQ;
  int k_begin, k_end;
  key_range(p, q0, min(q0 + W_BQ, p.Sq) - 1, W_BK, &k_begin, &k_end);
  *kt_lo = k_begin / W_BK;
  *kt_hi = k_end > k_begin ? (k_end - 1) / W_BK : *kt_lo - 1;
}

// Whether some (query, key) pair of queries q0 .. q0 + 63 and keys kb ..
// kb + 63 is masked (or out of range).
__device__ __forceinline__ bool w_needs_mask(const Params& p, int q0, int kb) {
  return q0 + W_BQ > p.Sq || kb + 64 > p.Skv ||
         (p.causal && kb + 63 > q0) ||
         (p.window > 0 && q0 + W_BQ - 1 - kb >= p.window);
}

// Pre-pass: per (b, row i, q head), padded to whole query tiles, lse (in
// base 2) and delta = rowsum(dO . O) into the tile-major scratch (zeros
// past Sq), and dQ = 0 for a row of a query tile that no key tile sees.
template <int DH>
__global__ void __launch_bounds__(DELTA_THREADS)
    delta_tiles_kernel(WParams p) {
  using bf16 = __nv_bfloat16;
  const int row = blockIdx.x * (DELTA_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sq_pad = p.n_qt * W_BQ;
  if (row >= p.B * sq_pad * p.Hq) return;  // whole warps leave together
  const int h = row % p.Hq;
  const int bi = row / p.Hq;
  const int i = bi % sq_pad, b = bi / sq_pad;
  float acc = 0.f, lse2 = 0.f;
  if (i < p.Sq) {
    const size_t off = (((size_t)b * p.Sq + i) * p.Hq + h) * DH;
    const bf16* o = static_cast<const bf16*>(p.o) + off;
    const bf16* g = static_cast<const bf16*>(p.dout) + off;
    for (int d = 2 * lane; d < DH; d += 64) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + d));
      const float2 c = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(g + d));
      acc += a.x * c.x + a.y * c.y;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, s);
    lse2 = p.lse[((size_t)b * p.Hq + h) * p.Sq + i] * LOG2E;
    int kt_lo, kt_hi;
    w_contributors(p, i / W_BQ, &kt_lo, &kt_hi);
    if (kt_hi < kt_lo) {
      bf16* dq = static_cast<bf16*>(p.dq) + off;
      for (int d = 2 * lane; d < DH; d += 64)
        *reinterpret_cast<uint32_t*>(dq + d) = 0u;
    }
  }
  if (lane == 0) {
    float* t = p.ld + (((size_t)b * p.Hq + h) * p.n_qt + i / W_BQ) * W_LD +
               i % W_BQ;
    t[0] = lse2;
    t[W_BQ] = acc;
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P^T into st and dS^T / scale into dpt, for one warpgroup's 64 keys x
// the tile's 64 queries: this thread's keys are krow and krow + 8, its
// queries 8j + 2tq (+1) from q0; Lt holds the tile's lse (base 2) and
// delta by query.  CAP: the tanh softcap; MASK: test every pair.
template <bool CAP, bool MASK>
__device__ __forceinline__ void w_grads(const Params& p, float (&st)[32],
                                        float (&dpt)[32], const float* Lt,
                                        int q0, int krow, int tq) {
  const float scale2 = p.scale * LOG2E;
  const float inv_cap = CAP ? p.scale / p.softcap : 0.f;
  const float cap2 = p.softcap * LOG2E;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * tq);
    const float2 dl =
        *reinterpret_cast<const float2*>(Lt + W_BQ + 8 * j + 2 * tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse2 = (e & 1) ? l2.y : l2.x;
      const float delta = (e & 1) ? dl.y : dl.x;
      const float s = st[4 * j + e];
      float pr, dx = 1.f;
      if constexpr (CAP) {
        const float t = tanhf(s * inv_cap);
        pr = ex2(fmaf(cap2, t, -lse2));
        dx = 1.f - t * t;
      } else {
        pr = ex2(fmaf(s, scale2, -lse2));
      }
      if constexpr (MASK) {
        if (!pair_valid(p, q0 + 8 * j + 2 * tq + (e & 1), krow + 8 * (e >> 1)))
          pr = 0.f;
      }
      st[4 * j + e] = pr;
      dpt[4 * j + e] = CAP ? pr * (dpt[4 * j + e] - delta) * dx
                           : pr * (dpt[4 * j + e] - delta);
    }
  }
}

// One accumulation step of dV or dK: d (64 keys x DH) += A (64 x 16,
// registers) . B (16 query rows x DH, MN-major in a swizzled tile).
template <int DH>
__device__ __forceinline__ void w_rs(float (&d)[DH / 2],
                                     const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DH == 64)
    hopper::wgmma_rs_n64<1>(d, a, b, 1);
  else
    hopper::wgmma_rs_n128<1>(d, a, b, 1);
}

template <int DH>
__global__ void __launch_bounds__(W_THREADS, 1)
    dkdvq_wgmma_kernel(const WParams p,
                       const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_dk,
                       const __grid_constant__ CUtensorMap map_dv) {
  using bf16 = __nv_bfloat16;
  using L = WSmem<DH>;
  constexpr int SLABS = L::SLABS;
  constexpr int SLOTS = L::SLOTS;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_w[];
  // 1024-aligned, and still a shared-memory pointer to the compiler
  unsigned char* smem =
      smem_w + ((1024 - (mma::smem_addr(smem_w) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  constexpr int KV_BUFS = L::KV_BUFS;
  uint64_t* kv_full = empty + STAGES;
  uint64_t* kv_empty = kv_full + KV_BUFS;
  uint64_t* dq_full = kv_empty + KV_BUFS;
  uint64_t* dq_empty = dq_full + SLOTS;
  volatile int* s_item = reinterpret_cast<volatile int*>(smem + L::META);
  volatile int* s_dq = s_item + 4;  // per slot: b, h, query tile, rank, count
  const int n_items = p.B * p.Hkv * p.n_split * p.n_kt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one thread a consumer warpgroup
    }
    for (int i = 0; i < KV_BUFS; ++i) {
      hopper::mbar_init(&kv_full[i], 1);
      hopper::mbar_init(&kv_empty[i], 2);  // one thread a consumer warpgroup
    }
    for (int s = 0; s < SLOTS; ++s) {
      hopper::mbar_init(&dq_full[s], W_CONSUMERS);
      hopper::mbar_init(&dq_empty[s], 32);  // the slot's writer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= W_CONSUMERS) {
    hopper::reg_dealloc<W_PRODUCER_REGS>();
    if (threadIdx.x == W_CONSUMERS) {
      // ---- producer: one thread issues every load ----
      const CUtensorMap* mq = &map_q;
      const CUtensorMap* mdo = &map_do;
      int stage = 0, empty_par = 1;
      auto load_tile = [&](const WItem& it, int u) {
        int h, m;
        w_tile(it, u, &h, &m);
        hopper::mbar_wait(&empty[stage], empty_par);
        hopper::mbar_expect_tx(&full[stage], 2 * L::TILE + W_LD * 4);
        unsigned char* q = smem + L::Q + stage * L::TILE;
        unsigned char* d = smem + L::DO + stage * L::TILE;
        for (int c = 0; c < SLABS; ++c) {
          hopper::tma_load_4d(q + c * L::T_SLAB, mq, &full[stage], c * 64, h,
                              m * W_BQ, it.b);
          hopper::tma_load_4d(d + c * L::T_SLAB, mdo, &full[stage], c * 64,
                              h, m * W_BQ, it.b);
        }
        hopper::bulk_load(
            smem + L::LD + stage * W_LD * 4,
            p.ld + (((size_t)it.b * p.Hq + h) * p.n_qt + m) * W_LD, W_LD * 4,
            &full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          empty_par ^= 1;
        }
      };
      int next = hopper::take_ticket(p.ticket);
      for (int n = 0;; ++n) {  // the block's n-th item, in K/V pair n % KV_BUFS
        const int item = next;
        const int kv = n % KV_BUFS, kv_par = (n / KV_BUFS) & 1;
        unsigned char* const k_tile = smem + L::KV + kv * L::KV_PAIR;
        const bool valid = item < n_items;
        WItem it{};
        if (valid) it = w_item(p, item);
        // the first tiles go into the ring while the consumers finish
        // the previous item; its K and V wait for them
        const int n_tiles = it.n_h * it.n_qt;
        const int ahead = min(STAGES, n_tiles);
        for (int u = 0; u < ahead; ++u) load_tile(it, u);
        hopper::mbar_wait(&kv_empty[kv], kv_par ^ 1);
        s_item[kv] = item;
        if (!valid || it.n_qt == 0) {
          hopper::mbar_arrive(&kv_full[kv]);
          if (!valid) break;
        } else {
          hopper::mbar_expect_tx(&kv_full[kv], L::KV_PAIR);
          for (int c = 0; c < SLABS; ++c) {
            hopper::tma_load_4d(k_tile + c * L::KV_SLAB, &map_k, &kv_full[kv],
                                c * 64, it.hk, it.k0, it.b);
            hopper::tma_load_4d(k_tile + (SLABS + c) * L::KV_SLAB, &map_v,
                                &kv_full[kv], c * 64, it.hk, it.k0, it.b);
          }
        }
        for (int u = ahead; u < n_tiles; ++u) load_tile(it, u);
        next = hopper::take_ticket(p.ticket);
      }
    } else if (threadIdx.x >= W_CONSUMERS + 32 &&
               threadIdx.x < W_CONSUMERS + 32 * (1 + SLOTS)) {
      // ---- writers: warp `slot` adds the partials handed over in its
      // slot (every SLOTS-th tile) into the scratch, in key-tile order
      const int slot = threadIdx.x / 32 - W_CONSUMERS / 32 - 1;
      const int lane = threadIdx.x % 32;
      constexpr int CHUNKS = L::CHUNKS, STAGED = L::STAGED_CHUNKS;
      const float* src =
          reinterpret_cast<const float*>(smem + L::DQ + slot * L::DQ_TILE);
      float* staged = reinterpret_cast<float*>(smem + L::ACC + slot * L::STAGED);
      // the sums so far of chunk k, each lane copying (L2, not L1) and
      // later reading back only its own float4s
      auto fetch = [&](const float* acc, int k) {
#pragma unroll
        for (int i = 0; i < W_CHUNK / 32; ++i) {
          const int f = k * W_CHUNK + i * 32 + lane;
          mma::cp_async16(
              staged + 4 * ((k % STAGED) * W_CHUNK + i * 32 + lane),
              acc + 4 * f, true);
        }
        mma::cp_async_commit();
      };
      for (int par = 0;; par ^= 1) {
        hopper::mbar_wait(&dq_full[slot], par);
        const volatile int* md = s_dq + slot * 8;
        const int b = md[0];
        if (b < 0) break;
        const int h = md[1], m = md[2], rank = md[3], count = md[4];
        const size_t tile = ((size_t)b * p.Hq + h) * p.n_qt + m;
        int* turn = p.turns + tile;
        float* acc = p.dq_acc + tile * W_BQ * DH;
        const bool last = rank == count - 1;
        if (rank > 0) {
          if (lane == 0)
            while (hopper::load_acquire(turn) != rank) {
            }
          __syncwarp();
          fetch(acc, 0);
          if constexpr (STAGED == CHUNKS) {
            for (int k = 1; k < CHUNKS; ++k) fetch(acc, k);
            mma::cp_async_wait<0>();
          }
        }
        for (int k = 0; k < CHUNKS; ++k) {
          if (STAGED < CHUNKS && rank > 0) {
            if (k + 1 < CHUNKS) {
              fetch(acc, k + 1);
              mma::cp_async_wait<1>();
            } else {
              mma::cp_async_wait<0>();
            }
          }
#pragma unroll
          for (int i = 0; i < W_CHUNK / 32; ++i) {
            const int f = k * W_CHUNK + i * 32 + lane;
            const int r = f / (DH / 4), c = f % (DH / 4) * 4;
            float4 x = *reinterpret_cast<const float4*>(src + dq_at<DH>(r, c));
            if (rank > 0) {
              const float4 y = *reinterpret_cast<const float4*>(
                  staged + 4 * ((k % STAGED) * W_CHUNK + i * 32 + lane));
              x.x += y.x;
              x.y += y.y;
              x.z += y.z;
              x.w += y.w;
            }
            if (!last) {
              __stcg(reinterpret_cast<float4*>(acc + 4 * f), x);
            } else if (m * W_BQ + r < p.Sq) {
              bf16* dst = static_cast<bf16*>(p.dq) +
                          (((size_t)b * p.Sq + m * W_BQ + r) * p.Hq + h) * DH +
                          c;
              *reinterpret_cast<uint2*>(dst) =
                  make_uint2(mma::pack_bf16x2(x.x, x.y),
                             mma::pack_bf16x2(x.z, x.w));
            }
          }
        }
        hopper::mbar_arrive(&dq_empty[slot]);
        if (!last) {
          __syncwarp();  // every lane's adds are stored
          if (lane == 0) hopper::add_release(turn, 1);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys 64 wg .. 64 wg + 63 ----
    hopper::reg_alloc<W_CONSUMER_REGS>();
    const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = tw % 32;
    const int gq = lane >> 2, tq = lane & 3;
    int stage = 0, full_par = 0, slot = 0, dq_par = 1;
    for (int n = 0;; ++n) {
      const int kv = n % KV_BUFS;
      hopper::mbar_wait(&kv_full[kv], (n / KV_BUFS) & 1);
      const int item = s_item[kv];
      if (item >= n_items) break;
      unsigned char* const k_tile = smem + L::KV + kv * L::KV_PAIR;
      unsigned char* const v_tile = k_tile + SLABS * L::KV_SLAB;
      const WItem it = w_item(p, item);
      const int kb = it.k0 + wg * 64;  // this warpgroup's first key
      float dk[DH / 2], dv[DH / 2];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
      // the (b, kv head, key tile)'s last item stores dK and dV by TMA
      // through its K and V tiles, which it then frees only at its end: at
      // Dh 64, where the other pair holds the next item's, or at Dh 128
      // with one item a key tile (else another item waits for them)
      const bool last = it.s == p.n_split - 1;
      const bool tma_out =
          last && it.n_qt > 0 && (KV_BUFS > 1 || p.n_split == 1);
      if (it.n_qt == 0 && tw == 0) hopper::mbar_arrive(&kv_empty[kv]);

      const int n_tiles = it.n_h * it.n_qt;
      for (int u = 0; u < n_tiles; ++u) {
        int h, m;
        w_tile(it, u, &h, &m);
        const int q0 = m * W_BQ;
        const unsigned char* Qt = smem + L::Q + stage * L::TILE;
        const unsigned char* Dt = smem + L::DO + stage * L::TILE;
        const float* Lt =
            reinterpret_cast<const float*>(smem + L::LD) + stage * W_LD;
        hopper::mbar_wait(&full[stage], full_par);

        // S^T = K.Q^T and dP^T = V.dO^T: 64 keys x 64 queries
        float st[32], dpt[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const int c = kk / 4, o = (kk % 4) * 32;
          const int rows = c * L::KV_SLAB + wg * 64 * 128 + o;
          hopper::wgmma_ss_n64<0, 0>(
              st, hopper::desc_sw128(k_tile + rows, 16, 1024),
              hopper::desc_sw128(Qt + c * L::T_SLAB + o, 16, 1024), kk > 0);
          hopper::wgmma_ss_n64<0, 0>(
              dpt, hopper::desc_sw128(v_tile + rows, 16, 1024),
              hopper::desc_sw128(Dt + c * L::T_SLAB + o, 16, 1024), kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(st);
        hopper::fence_regs(dpt);

        // P^T into st, dS^T into dpt (the scale is applied to dK and dQ)
        const int krow = kb + warp * 16 + gq;
        const bool mask = w_needs_mask(p, q0, kb);
        if (p.softcap > 0.f) {
          if (mask)
            w_grads<true, true>(p, st, dpt, Lt, q0, krow, tq);
          else
            w_grads<true, false>(p, st, dpt, Lt, q0, krow, tq);
        } else {
          if (mask)
            w_grads<false, true>(p, st, dpt, Lt, q0, krow, tq);
          else
            w_grads<false, false>(p, st, dpt, Lt, q0, krow, tq);
        }
        uint32_t pa[4][4], sa[4][4];  // A fragments, k-step = 16 queries
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = mma::pack_bf16x2(st[8 * kk + 2 * r],
                                         st[8 * kk + 2 * r + 1]);
            sa[kk][r] = mma::pack_bf16x2(dpt[8 * kk + 2 * r],
                                         dpt[8 * kk + 2 * r + 1]);
          }

        // dS^T (key-major, as the fragments hold it) into this warpgroup's
        // 64 rows of the dS^T tile, once the other warpgroup's last dQ
        // product is done with it: word sa[kk][r] is (key row + 8 (r & 1),
        // queries 16 kk + 8 (r >> 1) + 2 tq and the next)
        hopper::named_sync(BAR_DS, W_CONSUMERS);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = wg * 64 + warp * 16 + gq + 8 * (r & 1);
            const int chunk = 2 * kk + (r >> 1);
            *reinterpret_cast<uint32_t*>(smem + L::DS + row * 128 +
                                         ((chunk ^ gq) << 4) + 4 * tq) =
                sa[kk][r];
          }
        hopper::fence_proxy_async();

        // dV += P^T.dO and dK += dS^T.Q over the tile's 64 queries
        hopper::fence_regs(pa[0]);
        hopper::fence_regs(pa[1]);
        hopper::fence_regs(pa[2]);
        hopper::fence_regs(pa[3]);
        hopper::fence_regs(sa[0]);
        hopper::fence_regs(sa[1]);
        hopper::fence_regs(sa[2]);
        hopper::fence_regs(sa[3]);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          w_rs<DH>(dv, pa[kk],
                   hopper::desc_sw128(Dt + kk * 2048, L::T_SLAB, 1024));
          w_rs<DH>(dk, sa[kk],
                   hopper::desc_sw128(Qt + kk * 2048, L::T_SLAB, 1024));
        }
        hopper::wgmma_commit();

        // the tile's dQ partial dS.K: 64 queries x this warpgroup's DH/2
        // columns, over the item's 128 keys; dS (M = queries) is read
        // MN-major from the dS^T tile
        hopper::named_sync(BAR_DS, W_CONSUMERS);  // all of dS^T is there
        float dq[DH / 4];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t a =
              hopper::desc_sw128(smem + L::DS + kk * 2048, L::KV_SLAB, 1024);
          if constexpr (DH == 64)
            hopper::wgmma_ss_n32<1, 1>(
                dq, a,
                hopper::desc_sw128(k_tile + kk * 2048 + wg * 64,
                                   L::KV_SLAB, 1024),
                kk > 0);
          else
            hopper::wgmma_ss_n64<1, 1>(
                dq, a,
                hopper::desc_sw128(k_tile + wg * L::KV_SLAB + kk * 2048,
                                   L::KV_SLAB, 1024),
                kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dk);
        hopper::fence_regs(dv);
        hopper::fence_regs(dq);
        if (tw == 0) {
          hopper::mbar_arrive(&empty[stage]);
          if (u == n_tiles - 1 && !tma_out)
            hopper::mbar_arrive(&kv_empty[kv]);
        }
        if (++stage == STAGES) {
          stage = 0;
          full_par ^= 1;
        }

        // hand the partial (times the scale) to the writers
        hopper::mbar_wait(&dq_empty[slot], dq_par);
        float* dst = reinterpret_cast<float*>(smem + L::DQ + slot * L::DQ_TILE);
#pragma unroll
        for (int j = 0; j < DH / 16; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(
                dst + dq_at<DH>(warp * 16 + gq + 8 * hh,
                                wg * DH / 2 + 8 * j + 2 * tq)) =
                make_float2(dq[4 * j + 2 * hh] * p.scale,
                            dq[4 * j + 2 * hh + 1] * p.scale);
        if (threadIdx.x == 0) {
          int kt_lo, kt_hi;
          w_contributors(p, m, &kt_lo, &kt_hi);
          volatile int* md = s_dq + slot * 8;
          md[0] = it.b;
          md[1] = h;
          md[2] = m;
          md[3] = it.kt - kt_lo;
          md[4] = kt_hi - kt_lo + 1;
        }
        hopper::mbar_arrive(&dq_full[slot]);
        if (++slot == SLOTS) {
          slot = 0;
          dq_par ^= 1;
        }
      }

      // dK (times the scale) and dV of this warpgroup's keys, summed over
      // the item's heads; with n_split > 1 the (b, kv head, key tile)'s
      // items add theirs in split order through float32 sums, the last
      // writing bf16: into the bf16 tiles, swizzled as TMA loads them (the
      // K tile once both warpgroups' last dQ products are done with it,
      // EPI once the last item's stores have read it), then TMA stores
      const size_t kvt = ((size_t)it.b * p.Hkv + it.hk) * p.n_kt + it.kt;
      int* turn = p.kv_turns + 2 * kvt + wg;
      float* sk = p.dkv_acc + (kvt * W_BK + wg * 64) * DH;
      float* sv = sk + (size_t)p.B * p.Hkv * p.n_kt * W_BK * DH;
      const bool first = it.s == 0;
      if (!first) {
        if (tw == 0)
          while (hopper::load_acquire(turn) != it.s) {
          }
        hopper::named_sync(BAR_KV + wg, 128);
      }
      if (tma_out) hopper::named_sync(BAR_DS, W_CONSUMERS);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = warp * 16 + gq + 8 * hh;  // key kb + r
        const int row = wg * 64 + r;              // of the K and V tiles
        const size_t off =
            (((size_t)it.b * p.Skv + kb + r) * p.Hkv + it.hk) * DH + 2 * tq;
        bf16* dkd = static_cast<bf16*>(p.dk) + off;
        bf16* dvd = static_cast<bf16*>(p.dv) + off;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          float2 k2 = make_float2(dk[4 * j + 2 * hh], dk[4 * j + 2 * hh + 1]);
          float2 v2 = make_float2(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
          float2* ka = reinterpret_cast<float2*>(sk + r * DH + 8 * j + 2 * tq);
          float2* va = reinterpret_cast<float2*>(sv + r * DH + 8 * j + 2 * tq);
          if (!first) {
            const float2 k1 = __ldcg(ka), v1 = __ldcg(va);
            k2.x += k1.x;
            k2.y += k1.y;
            v2.x += v1.x;
            v2.y += v1.y;
          }
          if (!last) {
            __stcg(ka, k2);
            __stcg(va, v2);
          } else if (tma_out) {
            const int at = (j / 8) * L::KV_SLAB + row * 128 +
                           (((j % 8) ^ (row & 7)) << 4) + 4 * tq;
            *reinterpret_cast<uint32_t*>(k_tile + at) =
                mma::pack_bf16x2(k2.x * p.scale, k2.y * p.scale);
            *reinterpret_cast<uint32_t*>(v_tile + at) =
                mma::pack_bf16x2(v2.x, v2.y);
          } else if (kb + r < p.Skv) {
            *reinterpret_cast<uint32_t*>(dkd + 8 * j) =
                mma::pack_bf16x2(k2.x * p.scale, k2.y * p.scale);
            *reinterpret_cast<uint32_t*>(dvd + 8 * j) =
                mma::pack_bf16x2(v2.x, v2.y);
          }
        }
      }
      if (!last) {
        hopper::named_sync(BAR_KV + wg, 128);  // every add stored
        if (tw == 0) hopper::add_release(turn, 1);
      }
      if (tma_out) {
        hopper::fence_proxy_async();
        hopper::named_sync(BAR_DS, W_CONSUMERS);
        if (threadIdx.x == 0) {
          for (int c = 0; c < SLABS; ++c) {
            hopper::tma_store_4d(&map_dk, k_tile + c * L::KV_SLAB, c * 64,
                                 it.hk, it.k0, it.b);
            hopper::tma_store_4d(&map_dv, v_tile + c * L::KV_SLAB, c * 64,
                                 it.hk, it.k0, it.b);
          }
          hopper::bulk_commit();
          hopper::bulk_wait_read();
          hopper::mbar_arrive(&kv_empty[kv]);  // for both warpgroups
          hopper::mbar_arrive(&kv_empty[kv]);
        }
      }
    }
    // no item left: stop every writer
    for (int i = 0; i < SLOTS; ++i) {
      hopper::mbar_wait(&dq_empty[slot], dq_par);
      if (threadIdx.x == 0) s_dq[slot * 8] = -1;
      hopper::mbar_arrive(&dq_full[slot]);
      if (++slot == SLOTS) {
        slot = 0;
        dq_par ^= 1;
      }
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
cudaError_t launch_mma_sync(const Params& p, cudaStream_t stream) {
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

// How many items share a (b, kv head, key tile)'s G query heads.  An
// item loops over its G / n_split heads with dK and dV in registers; with
// n_split > 1 the items after the first wait for the one before and add
// through the float32 sums.  Take the fewest whose longest item (in 128 x
// 64 tiles) is at most twice one batch row's tiles spread over the
// resident blocks: llama's causal 32/8 heads at S = 1,024 take 2 (1
// leaves key tile 0's items of 64 tiles to a few blocks; 4 adds hand-offs
// and was 10% slower on the card), gemma2's window of 256 with 32/16
// heads takes 1 (its key tiles see about the same query tiles, and 2 was
// 17% slower).  Counted per batch row, so a row alone takes its batch's
// split and sums dK and dV in the same order.
int w_split(const Params& p, int resident) {
  const int G = p.Hq / p.Hkv;
  long long row = 0;
  int longest = 0;
  for (int k0 = 0; k0 < p.Skv; k0 += W_BK) {
    int q_lo, q_hi;
    query_range(p, k0, min(k0 + W_BK, p.Skv) - 1, &q_lo, &q_hi);
    const int n_qt = q_hi > q_lo ? (q_hi - 1) / W_BQ - q_lo / W_BQ + 1 : 0;
    row += (long long)G * p.Hkv * n_qt;
    longest = n_qt > longest ? n_qt : longest;
  }
  const double spread = (double)row / resident;
  const double limit = 2.0 * (spread > 1.0 ? spread : 1.0);
  for (int n = 1; n < G; ++n)
    if (G % n == 0 && (double)(G / n) * longest <= limit) return n;
  return G;
}

// Blocks of the wgmma kernel that the card holds at once.
template <int DH>
cudaError_t w_resident(int* resident) {
  const void* kernel = reinterpret_cast<const void*>(dkdvq_wgmma_kernel<DH>);
  static size_t done[mma::MAX_DEVICES] = {};
  cudaError_t err = mma::opt_in_smem(kernel, WSmem<DH>::BYTES, done);
  int dev = 0, sms = 0, per_sm = 0;
  if (err || (err = cudaGetDevice(&dev)) ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, W_THREADS, WSmem<DH>::BYTES)))
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *resident = per_sm * sms;
  return cudaSuccess;
}

template <int DH>
cudaError_t launch_wgmma(WParams p, cudaStream_t stream) {
  const int rows = p.B * p.n_qt * W_BQ * p.Hq;
  const int per_block = DELTA_THREADS / 32;
  delta_tiles_kernel<DH><<<(rows + per_block - 1) / per_block, DELTA_THREADS,
                           0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_k, map_v, map_do, map_dk, map_dv;
  if ((err = hopper::map_bshd(&map_q, p.q, p.B, p.Sq, p.Hq, DH, W_BQ)) ||
      (err = hopper::map_bshd(&map_do, p.dout, p.B, p.Sq, p.Hq, DH, W_BQ)) ||
      (err = hopper::map_bshd(&map_k, p.k, p.B, p.Skv, p.Hkv, DH, W_BK)) ||
      (err = hopper::map_bshd(&map_v, p.v, p.B, p.Skv, p.Hkv, DH, W_BK)) ||
      (err = hopper::map_bshd(&map_dk, p.dk, p.B, p.Skv, p.Hkv, DH, W_BK)) ||
      (err = hopper::map_bshd(&map_dv, p.dv, p.B, p.Skv, p.Hkv, DH, W_BK)))
    return err;
  // persistent: every block resident at once
  int resident = 0;
  if ((err = w_resident<DH>(&resident))) return err;
  p.n_split = w_split(p, resident);
  const int grid = min(p.B * p.Hkv * p.n_kt * p.n_split, resident);
  dkdvq_wgmma_kernel<DH><<<grid, W_THREADS, WSmem<DH>::BYTES, stream>>>(
      p, map_q, map_k, map_v, map_do, map_dk, map_dv);
  return cudaGetLastError();
}

// Which body serves (Dh, dtype): 0 float32 on the CUDA cores, 1 bf16 on
// mma.sync (two passes), 2 bf16 on wgmma (one pass); -1 none.  Dh 32
// (the float32 demo configs) has the float32 body only.
int body_of(int Dh, int dtype) {
  const bool dh_ok = Dh == 16 || Dh == 64 || Dh == 80 || Dh == 128 ||
                     (Dh == 32 && dtype == 0);
  if (!dh_ok || dtype < 0 || dtype > 1) return -1;
  if (dtype == 0) return 0;
  return Dh == 64 || Dh == 128 ? 2 : 1;
}

// The wgmma body's scratch, as offsets: floats lse/delta | dQ sums | dK
// and dV sums (G > 1); int32s ticket | dQ turns | dK, dV turns (G > 1).
struct WScratch {
  long long dq, dkv, floats, turns, kv_turns, ints;
};

WScratch w_scratch(int B, int Sq, int Skv, int Hq, int Hkv, int Dh) {
  const long long n_qt = (Sq + W_BQ - 1) / W_BQ;
  const long long n_kt = (Skv + W_BK - 1) / W_BK;
  const bool gqa = Hq > Hkv;
  WScratch w;
  w.dq = (long long)B * Hq * n_qt * W_LD;
  w.dkv = w.dq + (long long)B * Hq * n_qt * W_BQ * Dh;
  w.floats = w.dkv + (gqa ? 2LL * B * Hkv * n_kt * W_BK * Dh : 0);
  w.turns = 1;
  w.kv_turns = w.turns + (long long)B * Hq * n_qt;
  w.ints = w.kv_turns + (gqa ? 2LL * B * Hkv * n_kt : 0);
  return w;
}

template <int DH>
cudaError_t launch(const WParams& p, int dtype, cudaStream_t stream) {
  if (p.Hkv <= 0 || p.Hq % p.Hkv) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32<DH>(p, stream);
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (DH == 64 || DH == 128)
    return launch_wgmma<DH>(p, stream);
  else if constexpr (DH == 32)  // float32 only
    return cudaErrorInvalidValue;
  else
    return launch_mma_sync<DH>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scratch holds the floats and
// iscratch the zeroed int32s that repro_flash_backward_scratch_* size
// (iscratch may be null where that is 0).  Returns the cudaError_t of
// the first launch that failed, else 0.
extern "C" int repro_flash_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* iscratch,
    void* dq, void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
    int Dh, int causal, int window, float softcap, float scale, int dtype,
    void* stream) {
  float* f = static_cast<float*>(scratch);
  int* ints = static_cast<int*>(iscratch);
  WParams p{{q, k, v, o, dout, static_cast<const float*>(lse), f, dq, dk,
             dv, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale},
            nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
            (Sq + W_BQ - 1) / W_BQ, (Skv + W_BK - 1) / W_BK};
  if (body_of(Dh, dtype) == 2 && Hkv > 0) {
    if (ints == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const WScratch w = w_scratch(B, Sq, Skv, Hq, Hkv, Dh);
    p.ld = f;
    p.dq_acc = f + w.dq;
    p.dkv_acc = f + w.dkv;
    p.ticket = ints;
    p.turns = ints + w.turns;
    p.kv_turns = ints + w.kv_turns;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 16: err = launch<16>(p, dtype, s); break;
    case 32: err = launch<32>(p, dtype, s); break;
    case 64: err = launch<64>(p, dtype, s); break;
    case 80: err = launch<80>(p, dtype, s); break;
    case 128: err = launch<128>(p, dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The body that serves (Dh, dtype), as body_of numbers them.
extern "C" int repro_flash_backward_body(int Dh, int dtype) {
  return body_of(Dh, dtype);
}

// Float32 scratch: the two-pass bodies' delta (B, Hq, Sq); the wgmma
// body's lse and delta by query tile (B, Hq, n_qt, 2, 64), its dQ sums
// (B, Hq, n_qt, 64, Dh) and, with G > 1, its dK and dV sums (2, B, Hkv,
// n_kt * 128, Dh).
extern "C" long long repro_flash_backward_scratch_floats(int B, int Sq,
                                                         int Skv, int Hq,
                                                         int Hkv, int Dh,
                                                         int dtype) {
  if (body_of(Dh, dtype) != 2 || Hkv <= 0) return (long long)B * Hq * Sq;
  return w_scratch(B, Sq, Skv, Hq, Hkv, Dh).floats;
}

// Zeroed int32 scratch: the wgmma body's ticket, one turn counter per
// (b, q head, query tile) and, with G > 1, two per (b, kv head, key tile);
// none for the other bodies.
extern "C" long long repro_flash_backward_scratch_ints(int B, int Sq, int Skv,
                                                       int Hq, int Hkv, int Dh,
                                                       int dtype) {
  if (body_of(Dh, dtype) != 2 || Hkv <= 0) return 0;
  return w_scratch(B, Sq, Skv, Hq, Hkv, Dh).ints;
}

// The items the wgmma body makes of a (b, kv head, key tile) on this
// card (w_split, which counts one batch row); 0 for the other bodies or
// when the card says no.
extern "C" int repro_flash_backward_split(int Sq, int Skv, int Hq, int Hkv,
                                          int Dh, int causal, int window,
                                          int dtype) {
  if (body_of(Dh, dtype) != 2 || Hkv <= 0 || Hq % Hkv) return 0;
  int resident = 0;
  const cudaError_t err = Dh == 64 ? w_resident<64>(&resident)
                                   : w_resident<128>(&resident);
  if (err != cudaSuccess) return 0;
  Params p{};
  p.B = 1;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.window = window;
  return w_split(p, resident);
}

extern "C" const char* repro_flash_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
