// Prefill flash attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention/kernel.py::flash_attention (_flash_kernel),
// the GQA prefill attention that the JAX model computes through
// L.chunked_attention (repro/models/model.py:257).
//
// Semantics (the Pallas kernel's, plus an optional per-row kv_len and
// query offset q_start):
//   q (B, Sq, Hq, Dh), k/v (B, Skv, Hkv, Dh), out (B, Sq, Hq, Dh) in q's
//   dtype; key position = key index from 0; query position = q_start[b]
//   + row index (row index alone without q_start, as in the Pallas
//   kernel).  The offset is the paged prefill after a radix prefix hit:
//   the new tokens sit after ctx resident tokens, and k/v is the
//   gathered view of the whole table (repro/models/model.py:710-800);
//   kv head = q head / (Hq / Hkv); scores = (q . k) / sqrt(Dh), then the
//   tanh softcap, then the mask (causal, window, key < kv_len) with the
//   finite -1e30; online softmax in float32; l clamped at 1e-37.  A row
//   with no valid key averages V over every key, as the reference does.
//
// Head dims: 16, 64, 80 (hubert-xlarge's bidirectional encoder) and 128,
// the switch at the end of this file and _build.FLASH_HEAD_DIMS alike.
// The bf16 body needs DH % 16 == 0.  At DH = 80 it runs five k-steps of
// Q.K^T and ten output n-blocks (five ldmatrix.trans pairs of P.V), and
// its shared rows of 88 bf16 (176 B, eleven 16-byte chunks: an odd
// count) keep ldmatrix 16-byte aligned and free of bank conflicts.
//
// bfloat16 design (the served path).  One block per (query tile, kv
// head, batch row), grid (ceil(Sq / BQP), Hkv, B), heaviest causal tiles
// first (blockIdx.x reversed).  A block holds ROWS = 64 rows: BQP = 64 / G
// query positions times the G = Hq / Hkv query heads of its kv head, row
// r = (position r / G, head r % G), so each K/V tile is staged once for
// all G heads.  Four warps each own 16 rows, one m16 fragment: Q
// fragments stay in registers for the whole key loop, S = Q.K^T and
// O += P.V run on the tensor cores (mma.sync m16n8k16, bf16 in, float32
// accumulate), K read with ldmatrix and V with ldmatrix.trans, P rounded
// to bf16 in registers (the accumulator layout of S is the A layout of
// P).  The online softmax runs on the fragment rows with quad shuffles.
// K/V tiles of 64 keys stay bf16 in shared memory, rows padded by 16
// bytes so that ldmatrix has no bank conflicts, in a ring of two stages
// filled by cp.async: tile i + 1 is in flight while tile i computes.
// Block size: 64 rows x 4 warps gives 256 blocks at the main shape (B=1,
// S=512, Hkv=8, G=4), about two per SM; 87 KB of shared memory and 206
// registers a thread at Dh=128 let two blocks share an SM.  The
// alternatives each give something up: a register cap for three or four
// blocks per SM spills the fragments, 32-key tiles pay a barrier per 32
// keys, a third 64-key stage leaves room for one block per SM, and two
// warps halve the warps that hide the mma latency.  Ragged edges are
// masked here (keys past Skv are zero-filled and get no weight), so Sq
// and Skv need not be multiples of the tile.
//
// Tiles that lie wholly outside every row's valid interval (the causal
// future, before the window, past kv_len; all in positions, so shifted
// by q_start) are skipped: a fully masked tile after a valid key adds
// exp(-1e30 - m) = 0 and one before it is wiped by alpha = 0, so the
// result is unchanged.  When some row has no valid key at all, the block
// visits every tile, to reproduce the reference's average over V.
//
// float32 keeps the first version's body (no served path on the card
// runs float32, and its errors against the plain version, about 1e-6,
// must not move to TF32's): one block per (32 query rows, q head, batch
// row), four threads per row, K/V staged as float32, the dot products
// on the CUDA cores.
//
// What bounds it on the H100.  Causal prefill over S tokens with 32 q and
// 8 kv heads does about 0.4 * S FLOPs per byte it must move, so the
// roofline bound is bytes below S of about 740 (the bf16 tensor-core ridge
// is about 295 FLOPs per byte) and operations above.  At the main shape
// the work (about 1.9 GFLOP) is a few microseconds at either bound, so
// latency and occupancy bound the kernel: the cp.async ring hides the
// loads, the GQA rows cut K/V traffic by G, and the tile order runs the
// longest blocks first.  wgmma, TMA and warp specialisation are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 32;                // query rows per block
constexpr int BK = 32;                // keys per K/V tile
constexpr int TPR = 4;                // threads per query row
constexpr int THREADS = BQ * TPR;     // 128
constexpr int KPT = BK / TPR;         // scores per thread per tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// 16-byte vector load of 16 / sizeof(T) elements, widened to float.
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ src, float* dst) {
  constexpr int N = 16 / sizeof(T);
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = to_f(e[i]);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_len;   // (B,) or null
  const int* q_start;  // (B,) or null: position of query row 0
  int B, Sq, Skv, Hq, Hkv;
  int causal;
  int window;     // <= 0: none
  float softcap;  // <= 0: none
  float scale;
};

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(Params p) {
  constexpr int QS = DH + 1;        // padded row stride of Q and K tiles
  constexpr int DPT = DH / TPR;     // output columns per thread
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x QS
  float* Ks = Qs + BQ * QS;         // BK x QS
  float* Vs = Ks + BK * QS;         // BK x DH
  float* Ps = Vs + BK * DH;         // BQ x (BK + 1)

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int qi = q0 + row;
  const int kv_len = p.kv_len ? min(max(p.kv_len[b], 0), p.Skv) : p.Skv;
  const int qs = p.q_start ? p.q_start[b] : 0;
  const int qpos = qs + qi;  // this row's position

  // this row's valid key interval [lo, hi]
  int hi = kv_len - 1;
  if (p.causal) hi = min(hi, qpos);
  const int lo = p.window > 0 ? max(0, qpos - p.window + 1) : 0;
  const int empty = (qi < p.Sq) && (lo > hi);
  const int any_empty = __syncthreads_or(empty);
  int k_begin = 0, k_end = p.Skv;
  if (!any_empty) {
    // both ends are non-decreasing in the row, so the block's union is
    // [lo(first row), hi(last row)]
    const int q_last = qs + min(q0 + BQ, p.Sq) - 1;
    int hi_last = kv_len - 1;
    if (p.causal) hi_last = min(hi_last, q_last);
    const int lo_first = p.window > 0 ? max(0, qs + q0 - p.window + 1) : 0;
    k_begin = (lo_first / BK) * BK;
    k_end = hi_last + 1;
  }

  // stage the Q tile (rows past Sq read as 0 and are never written)
  for (int i = tid * VEC; i < BQ * DH; i += THREADS * VEC) {
    const int r = i / DH, d = i % DH;
    float buf[VEC];
    if (q0 + r < p.Sq) {
      load16(q + ((size_t)(b * p.Sq + q0 + r) * p.Hq + h) * DH + d, buf);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) buf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) Qs[r * QS + d + e] = buf[e];
  }

  float m_i = NEG_INF, l_i = 0.f;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile's readers are done (and Q staged)
    for (int i = tid * VEC; i < BK * DH; i += THREADS * VEC) {
      const int r = i / DH, d = i % DH;
      float kb[VEC], vb[VEC];
      if (kt + r < p.Skv) {
        const size_t off = ((size_t)(b * p.Skv + kt + r) * p.Hkv + hk) * DH + d;
        load16(k + off, kb);
        load16(v + off, vb);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kb[e] = vb[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[r * QS + d + e] = kb[e];
        Vs[r * DH + d + e] = vb[e];
      }
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int c = 0; c < KPT; ++c) s[c] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float qd = Qs[row * QS + d];
#pragma unroll
      for (int c = 0; c < KPT; ++c) s[c] += qd * Ks[(sub + TPR * c) * QS + d];
    }

    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      const int kj = kt + sub + TPR * c;
      float x;
      if (kj >= p.Skv) {
        x = -CUDART_INF_F;  // past the end: no weight at all
      } else {
        x = s[c] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kj < kv_len;
        if (p.causal) ok = ok && kj <= qpos;
        if (p.window > 0) ok = ok && (qpos - kj < p.window);
        if (!ok) x = NEG_INF;
      }
      s[c] = x;
      tile_max = fmaxf(tile_max, x);
    }
    // the TPR threads of a row are adjacent lanes of one warp
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_i, tile_max);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < KPT; ++c) {
      const float pc = expf(s[c] - m_new);
      psum += pc;
      Ps[row * (BK + 1) + sub + TPR * c] = pc;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    __syncwarp();  // a row's probabilities are read by the same warp

#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
    for (int kk = 0; kk < BK; ++kk) {
      const float pk = Ps[row * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] += pk * Vs[kk * DH + sub + TPR * j];
    }
  }

  if (qi < p.Sq) {
    const float inv = 1.f / fmaxf(l_i, 1e-37f);
    T* dst = o + ((size_t)(b * p.Sq + qi) * p.Hq + h) * DH;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dst[sub + TPR * j] = from_f<T>(acc[j] * inv);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16 * TC_WARPS;  // (position, grouped head) rows
constexpr int TC_BK = 64;               // keys per K/V tile
constexpr int TC_STAGES = 2;            // cp.async ring of K/V tiles

template <int DH>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * (TC_ROWS + 2 * TC_STAGES * TC_BK) * (DH + 8);
}

template <int DH>
__global__ void __launch_bounds__(TC_THREADS)
    flash_prefill_bf16_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int LDS = DH + 8;       // padded shared row: no ldmatrix conflicts
  constexpr int CH = DH / 8;        // 16-byte chunks per row
  constexpr int KSTEPS = DH / 16;   // k-steps of Q.K^T
  constexpr int SB = TC_BK / 8;     // score n-blocks per tile
  constexpr int OB = DH / 8;        // output n-blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // TC_ROWS x LDS
  bf16* Ks = Qs + TC_ROWS * LDS;                  // TC_STAGES x TC_BK x LDS
  bf16* Vs = Ks + TC_STAGES * TC_BK * LDS;        // TC_STAGES x TC_BK x LDS

  const bf16* __restrict__ q = static_cast<const bf16*>(p.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(p.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(p.v);
  bf16* __restrict__ o = static_cast<bf16*>(p.o);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row group, column pair
  const int G = p.Hq / p.Hkv;
  const int BQP = TC_ROWS / G;              // positions per block
  const int n_rows = BQP * G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQP;  // heaviest tiles first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_len = p.kv_len ? min(max(p.kv_len[b], 0), p.Skv) : p.Skv;
  const int qs = p.q_start ? p.q_start[b] : 0;

  // the block's key range, as in the float32 body, over its positions
  int empty = 0;
  if (tid < BQP && q0 + tid < p.Sq) {
    const int qpos = qs + q0 + tid;
    int hi = kv_len - 1;
    if (p.causal) hi = min(hi, qpos);
    const int lo = p.window > 0 ? max(0, qpos - p.window + 1) : 0;
    empty = lo > hi;
  }
  const int any_empty = __syncthreads_or(empty);
  int k_begin = 0, k_end = p.Skv;
  if (!any_empty) {
    const int q_last = qs + min(q0 + BQP, p.Sq) - 1;
    int hi_last = kv_len - 1;
    if (p.causal) hi_last = min(hi_last, q_last);
    const int lo_first = p.window > 0 ? max(0, qs + q0 - p.window + 1) : 0;
    k_begin = (lo_first / TC_BK) * TC_BK;
    k_end = hi_last + 1;
  }
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + TC_BK - 1) / TC_BK : 0;

  // Q tile (rows past n_rows or Sq are zero and never written); it joins
  // the first K/V tile's copy group
  for (int i = tid; i < TC_ROWS * CH; i += TC_THREADS) {
    const int r = i / CH, c = i % CH;
    const int pos = q0 + r / G;
    const bool ok = r < n_rows && pos < p.Sq;
    const bf16* src =
        ok ? q + (((size_t)b * p.Sq + pos) * p.Hq + (size_t)hk * G + r % G) *
                         DH + c * 8
           : q;
    mma::cp_async16(Qs + r * LDS + c * 8, src, ok);
  }
  auto load_tile = [&](int stage, int kt) {
    bf16* kd = Ks + stage * TC_BK * LDS;
    bf16* vd = Vs + stage * TC_BK * LDS;
    for (int i = tid; i < TC_BK * CH; i += TC_THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = kt + r < p.Skv;  // past the end: zeros
      const size_t off =
          ok ? (((size_t)b * p.Skv + kt + r) * p.Hkv + hk) * DH + c * 8 : 0;
      mma::cp_async16(kd + r * LDS + c * 8, k + off, ok);
      mma::cp_async16(vd + r * LDS + c * 8, v + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, k_begin + s * TC_BK);
    mma::cp_async_commit();
  }

  // this thread's two fragment rows (h = 0: row gq, h = 1: row gq + 8)
  // and their valid key intervals [lo, hi]
  int lo_r[2], hi_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = qs + q0 + (warp * 16 + gq + 8 * h) / G;
    hi_r[h] = p.causal ? min(kv_len - 1, qpos) : kv_len - 1;
    lo_r[h] = p.window > 0 ? qpos - p.window + 1 : 0;
  }

  uint32_t qf[KSTEPS][4];
  float acc[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    mma::cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    {
      const int nx = it + TC_STAGES - 1;
      if (nx < n_tiles) load_tile(nx % TC_STAGES, k_begin + nx * TC_BK);
      mma::cp_async_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        mma::ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LDS +
                                     ks * 16 + (lane >> 4) * 8);
    }
    const bf16* Kt = Ks + (it % TC_STAGES) * TC_BK * LDS;
    const bf16* Vt = Vs + (it % TC_STAGES) * TC_BK * LDS;

    float s[SB][4];
#pragma unroll
    for (int j = 0; j < SB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int nb = 0; nb < SB / 2; ++nb) {
        // keys nb*16 .. +15, dims ks*16 .. +15: two n-blocks' b0, b1
        uint32_t kf[4];
        mma::ldmatrix_x4(kf, Kt + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      LDS + ks * 16 + ((lane >> 3) & 1) * 8);
        mma::mma_bf16(s[2 * nb], qf[ks], kf[0], kf[1]);
        mma::mma_bf16(s[2 * nb + 1], qf[ks], kf[2], kf[3]);
      }
    }

    const int kt = k_begin + it * TC_BK;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < SB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kj = kt + j * 8 + 2 * tq + (e & 1);
        float x;
        if (kj >= p.Skv) {
          x = -CUDART_INF_F;  // past the end: no weight at all
        } else {
          x = s[j][e] * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          if (kj < lo_r[h] || kj > hi_r[h]) x = NEG_INF;
        }
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_r[h], mma::quad_max(mx[h]));
      alpha[h] = __expf(m_r[h] - m_new);
      m_r[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < SB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[j][e] - m_r[e >> 1]);
        s[j][e] = pe;
        psum[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + psum[h];
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = mma::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = mma::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = mma::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = mma::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int db = 0; db < DH / 16; ++db) {
        // keys kk*16 .. +15, dims db*16 .. +15, transposed to k x n
        uint32_t vf[4];
        mma::ldmatrix_x4_trans(
            vf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                    db * 16 + (lane >> 4) * 8);
        mma::mma_bf16(acc[2 * db], pa, vf[0], vf[1]);
        mma::mma_bf16(acc[2 * db + 1], pa, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = mma::quad_sum(l_r[h]);
    const int r = warp * 16 + gq + 8 * h;
    const int pos = q0 + r / G;
    if (r < n_rows && pos < p.Sq) {
      const float inv = 1.f / fmaxf(l, 1e-37f);
      bf16* dst = o + (((size_t)b * p.Sq + pos) * p.Hq + (size_t)hk * G + r % G) *
                          DH + 2 * tq;
#pragma unroll
      for (int j = 0; j < OB; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            mma::pack_bf16x2(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    }
  }
}

template <int DH>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<DH>();
  static size_t done[mma::MAX_DEVICES] = {};
  const cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(flash_prefill_bf16_kernel<DH>), smem,
      done);
  if (err != cudaSuccess) return err;
  const int bqp = TC_ROWS / (p.Hq / p.Hkv);
  const dim3 grid((p.Sq + bqp - 1) / bqp, p.Hkv, p.B);
  flash_prefill_bf16_kernel<DH><<<grid, TC_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------

template <int DH>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<DH>() * sizeof(float);
  static size_t done[mma::MAX_DEVICES] = {};
  const cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(flash_prefill_kernel<float, DH>), smem,
      done);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_prefill_kernel<float, DH><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<DH>(p, stream);
  if (dtype == 1) {
    if (p.Hkv <= 0 || p.Hq % p.Hkv || p.Hq / p.Hkv > TC_ROWS)
      return cudaErrorInvalidValue;
    return launch_bf16<DH>(p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_flash_prefill(const void* q, const void* k, const void* v,
                                   void* o, const void* kv_len,
                                   const void* q_start, int B, int Sq,
                                   int Skv, int Hq, int Hkv, int Dh, int causal,
                                   int window, float softcap, float scale,
                                   int dtype, void* stream) {
  Params p{q, k, v, o, static_cast<const int*>(kv_len),
           static_cast<const int*>(q_start), B, Sq, Skv, Hq, Hkv,
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

extern "C" const char* repro_flash_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
