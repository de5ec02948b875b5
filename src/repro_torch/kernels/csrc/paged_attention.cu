// Paged decode and speculative-verify attention for Hopper (sm_90a),
// plain CUDA C++.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/decode_attention/kernel.py::paged_verify_attention
//     (_paged_verify_kernel), and
//   repro/kernels/decode_attention/kernel.py::paged_decode_attention,
//     which is its T == 1 call,
// the attention of T new tokens per sequence over a paged KV pool that the
// JAX model computes through L.verify_attention on the gathered pages
// (repro/models/model.py:825-909; decode_step_paged is its T == 1 call).
//
// Semantics (the Pallas kernel's): q (B, T, Hq, Dh); the pool k/v
// (P, ps, Hkv, Dh), page-major, as the serving cache holds it (no
// transpose: a layer's pool is about 100 MB at full width);
// block_tables (B, Pmax) int32, -1 = unused (clamps to page 0);
// lengths (B,) int32 counts the sequence's tokens including the T new
// ones, whose K/V the caller has already scattered into the pool.  Query
// row r = t * G + g is token t at position lengths[b] - T + t, grouped
// head g of kv head hk.  Position i lives in page block_tables[b, i / ps]
// at offset i % ps.  Key i is valid when i < length and i <= the row's
// position (and position - i < window); scores = (q . k) / sqrt(Dh),
// tanh softcap, masked with the finite -1e30; online softmax in float32,
// l clamped at 1e-37; out (B, T, Hq, Dh) in q's dtype.  Only the pages
// with p * ps < length are visited, so a length == 0 row returns 0, as
// the Pallas kernel does (the plain version averages V there).
//
// What bounds it on the H100: bytes.  Each key is read once and used in
// T * G dot products, a few FLOPs per byte, far below the card's ridge
// (about 295 bf16 FLOPs per byte).  The main path reads about 12.6 MB a
// call (8 rows of up to 1,024 positions, 8 kv heads, Dh 128), 3.8 us at
// 3.35 TB/s, so the kernel must keep many copies in flight on every SM.
//
// bfloat16 design (the served path): a split over positions, then a
// combine pass.
//   * Split.  Grid (Hkv, B, n_split), n_split = ceil(Pmax * ps / SPLIT):
//     block s covers positions [s * SPLIT, (s + 1) * SPLIT) of its row,
//     a fixed run (SPLIT = 128, 8 pages of 16), never derived from the
//     batch's longest row, so a row's output depends only on its own
//     inputs and a call is bit-reproducible.  At the main shape that is
//     512 blocks instead of 64 (256 instead of 32 at the tp=2 shard).  A
//     split that starts at or past the visited positions returns at once
//     and writes nothing: the combine reads only the live splits, which
//     it derives from the row's length the same way.
//   * Staging.  Each of the four warps owns 32 positions of the split and
//     copies them, bf16, into its own shared slice with cp.async (16
//     bytes a copy; lane i looks up the page of position i in
//     block_tables, clamping -1 and out-of-pool ids, and the copying
//     lanes take it by shuffle).  K and V are two commit groups, so V is
//     in flight while S and the softmax run; a block stages its whole
//     split at once (64 KB at Dh 128), and three blocks fit on an SM.
//   * Scores.  The T * G query rows (4 for decode, 12 for verify, 3 for
//     the drafter; at most 32) are padded to one or two m16 fragments;
//     S = Q.K^T and P.V run on mma.sync (mma_bf16.cuh), K read with
//     ldmatrix and V with ldmatrix.trans, P rounded to bf16 in registers.
//   * Partials.  The four warps' (m, l, acc) are merged in shared memory
//     in warp order, and the split writes (m, l) and the unnormalised acc
//     in float32 to a scratch tensor that the wrapper allocates.  A
//     second kernel reduces a row's live splits in index order and writes
//     q's dtype.  No float atomics.  A warp with no visited position has
//     m = -inf and adds nothing; a split whose keys are all masked (a
//     window that starts in a later split) has m = -1e30 and its weight
//     exp(-1e30 - M) is exactly 0 beside a valid key; a row with no
//     valid key at all averages V over its visited positions, as the
//     float32 body does.
//
// float32 keeps the first version's body: one block per (kv head, batch
// row) holding the T * G query rows, one warp per row (T * G <= 32),
// walking the positions in tiles of 32 that each thread looks up in the
// block table itself and stages in shared memory as float32; lane c
// scores key c of the tile, the warp reduces max and sum with shuffles,
// and each lane accumulates Dh / 32 output columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TC = 32;  // positions per tile: one per lane
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ src, float* dst) {
  constexpr int N = 16 / sizeof(T);
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = to_f(e[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* block_tables;
  const int* lengths;
  void* o;
  int B, n_tok, Hq, Hkv;  // n_tok: T, the query tokens per sequence
  int P, ps, Pmax;
  int window;     // <= 0: none
  float softcap;  // <= 0: none
  float scale;
  float* part;    // bf16 split pass: (B, Hkv, n_split, T * G, Dh + 2) float32
  int n_split;
};

template <int DH>
size_t smem_bytes(int rows) {
  return sizeof(float) * (rows * DH + TC * (DH + 1) + TC * DH);
}

template <typename T, int DH>
__global__ void __launch_bounds__(1024) paged_attention_kernel(Params p) {
  constexpr int KS = DH + 1;               // padded row stride of K tiles
  constexpr int DPL = (DH + 31) / 32;      // output columns per lane
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int R = blockDim.x / 32;           // T * G query rows
  float* Qs = smem;                        // R x DH
  float* Ks = Qs + R * DH;                 // TC x KS
  float* Vs = Ks + TC * KS;                // TC x DH

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = p.Hq / p.Hkv;
  const int ps = p.ps;
  const int length = p.lengths[b];
  // pages with p * ps < length, at most the table's width
  const int n_pages = length > 0 ? min(p.Pmax, (length + ps - 1) / ps) : 0;
  const int n_pos = n_pages * ps;
  const int* __restrict__ table = p.block_tables + (size_t)b * p.Pmax;
  const int qpos = length - p.n_tok + warp / G;  // this warp's row position

  // row r = t * G + g reads q[b, t, hk * G + g]
  for (int i = tid * VEC; i < R * DH; i += blockDim.x * VEC) {
    const int r = i / DH, d = i % DH;
    const int t = r / G, g = r % G;
    load16(q + (((size_t)b * p.n_tok + t) * p.Hq + (size_t)hk * G + g) * DH + d,
           Qs + i);
  }

  float m = NEG_INF, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < n_pos; c0 += TC) {
    __syncthreads();  // the previous tile's readers are done (and Q staged)
    for (int i = tid * VEC; i < TC * DH; i += blockDim.x * VEC) {
      const int r = i / DH, d = i % DH;
      const int pos = c0 + r;
      float kb[VEC], vb[VEC];
      if (pos < n_pos) {
        // -1 clamps to page 0 as in the reference; an id past the pool
        // is clamped too, so a bad table cannot read outside it
        const int page = min(max(table[pos / ps], 0), p.P - 1);
        const size_t off =
            (((size_t)page * ps + pos % ps) * p.Hkv + hk) * DH + d;
        load16(k + off, kb);
        load16(v + off, vb);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kb[e] = vb[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[r * KS + d + e] = kb[e];
        Vs[r * DH + d + e] = vb[e];
      }
    }
    __syncthreads();

    const int c = c0 + lane;
    float s;
    if (c >= n_pos) {
      s = -CUDART_INF_F;  // past the visited pages: no weight at all
    } else {
      float dot = 0.f;
      const float* qr = Qs + warp * DH;
      const float* kr = Ks + lane * KS;
      for (int d = 0; d < DH; ++d) dot += qr[d] * kr[d];
      s = dot * p.scale;
      if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
      bool ok = c < length && c <= qpos;
      if (p.window > 0) ok = ok && (qpos - c < p.window);
      if (!ok) s = NEG_INF;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float pe = expf(s - m_new);
    l = l * alpha + warp_sum(pe);
    m = m_new;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= alpha;
    for (int r = 0; r < TC; ++r) {
      const float pr = __shfl_sync(0xffffffffu, pe, r);
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        if (d < DH) acc[j] += pr * Vs[r * DH + d];
      }
    }
  }

  const float inv = 1.f / fmaxf(l, 1e-37f);
  const int t = warp / G, g = warp % G;
  T* dst = o + (((size_t)b * p.n_tok + t) * p.Hq + (size_t)hk * G + g) * DH;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    if (d < DH) dst[d] = from_f<T>(acc[j] * inv);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: split over positions on the tensor cores, then the combine
// ---------------------------------------------------------------------------

constexpr int SPLIT = 128;            // positions per split (L_s)
constexpr int SP_WARPS = 4;
constexpr int SP_THREADS = 32 * SP_WARPS;
constexpr int WPOS = SPLIT / SP_WARPS;  // positions per warp: 32

template <int DH, int MF>
constexpr size_t split_smem_bytes() {
  // Q (16 MF rows), K and V (SPLIT rows each), padded by 8 elements; the
  // warps' (m, l)
  return sizeof(__nv_bfloat16) * (16 * MF + 2 * SPLIT) * (DH + 8) +
         sizeof(float) * SP_WARPS * 16 * MF * 2;
}

// The partial of a row's split s sits at part + ((b * Hkv + hk) * n_split
// + s) * R * (Dh + 2): R x Dh accumulators, then R pairs (m, l).
__device__ __forceinline__ float* partial(const Params& p, int b, int hk,
                                          int s, int R, int dh) {
  return p.part + (((size_t)b * p.Hkv + hk) * p.n_split + s) * R * (dh + 2);
}

// visited positions of row b: whole pages with p * ps < length
__device__ __forceinline__ int visited(const Params& p, int b) {
  const int length = p.lengths[b];
  return length > 0 ? min(p.Pmax, (length + p.ps - 1) / p.ps) * p.ps : 0;
}

template <int DH, int MF>
__global__ void __launch_bounds__(SP_THREADS)
    paged_split_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int LDS = DH + 8;       // padded shared row: no ldmatrix conflicts
  constexpr int CH = DH / 8;        // 16-byte chunks per row
  constexpr int KSTEPS = DH / 16;
  constexpr int RP = 16 * MF;       // query rows, padded to whole fragments
  constexpr int SB = WPOS / 8;      // score n-blocks per warp
  constexpr int OB = DH / 8;        // output n-blocks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // RP x LDS
  bf16* Ks = Qs + RP * LDS;                       // SPLIT x LDS
  bf16* Vs = Ks + SPLIT * LDS;                    // SPLIT x LDS
  float* ml = reinterpret_cast<float*>(Vs + SPLIT * LDS);  // warps x RP x 2
  float* merge = reinterpret_cast<float*>(Ks);  // warps x RP x DH, after K/V

  const bf16* __restrict__ q = static_cast<const bf16*>(p.q);
  const bf16* __restrict__ k = static_cast<const bf16*>(p.k);
  const bf16* __restrict__ v = static_cast<const bf16*>(p.v);

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int n_pos = visited(p, b);
  const int s0 = split * SPLIT;
  if (s0 >= n_pos) return;  // not a live split: the combine skips it
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int G = p.Hq / p.Hkv;
  const int R = p.n_tok * G;
  const int length = p.lengths[b];
  const int ps = p.ps;

  // Q rows r = t * G + g (rows past R are zero): group 0
  for (int i = tid; i < RP * CH; i += SP_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < R;
    const bf16* src =
        ok ? q + (((size_t)b * p.n_tok + r / G) * p.Hq + (size_t)hk * G +
                  r % G) * DH + c * 8
           : q;
    mma::cp_async16(Qs + r * LDS + c * 8, src, ok);
  }
  mma::cp_async_commit();

  // this warp's positions w0 .. w0 + nv - 1: K is group 1, V group 2
  const int w0 = s0 + warp * WPOS;
  const int nv = min(WPOS, n_pos - w0);  // <= 0: nothing visited
  bf16* Kw = Ks + warp * WPOS * LDS;
  bf16* Vw = Vs + warp * WPOS * LDS;
  int page = 0;
  if (lane < nv) {
    // -1 clamps to page 0 as in the reference; an id past the pool is
    // clamped too, so a bad table cannot read outside it
    const int* table = p.block_tables + (size_t)b * p.Pmax;
    page = min(max(table[(w0 + lane) / ps], 0), p.P - 1);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf16* src = half ? v : k;
    bf16* dst = half ? Vw : Kw;
    for (int i = lane; i < WPOS * CH; i += 32) {
      const int r = i / CH, c = i % CH;
      const int pg = __shfl_sync(0xffffffffu, page, r);
      const bool ok = r < nv;
      const size_t off =
          ok ? (((size_t)pg * ps + (w0 + r) % ps) * p.Hkv + hk) * DH + c * 8
             : 0;
      mma::cp_async16(dst + r * LDS + c * 8, src + off, ok);
    }
    mma::cp_async_commit();
  }

  mma::cp_async_wait<2>();
  __syncthreads();  // Q landed for every thread
  uint32_t qf[MF][KSTEPS][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      mma::ldmatrix_x4(qf[f][ks], Qs + (f * 16 + (lane & 15)) * LDS +
                                      ks * 16 + (lane >> 4) * 8);

  // a warp with no visited position adds nothing: m = -inf, l = acc = 0
  float m_r[MF][2], l_r[MF][2], acc[MF][OB][4];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    m_r[f][0] = m_r[f][1] = -CUDART_INF_F;
    l_r[f][0] = l_r[f][1] = 0.f;
#pragma unroll
    for (int j = 0; j < OB; ++j)
      acc[f][j][0] = acc[f][j][1] = acc[f][j][2] = acc[f][j][3] = 0.f;
  }
  if (nv > 0) {
    mma::cp_async_wait<1>();
    __syncwarp();  // this warp's K landed
    float s[MF][SB][4];
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int j = 0; j < SB; ++j)
        s[f][j][0] = s[f][j][1] = s[f][j][2] = s[f][j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int nb = 0; nb < SB / 2; ++nb) {
        uint32_t kf[4];
        mma::ldmatrix_x4(kf, Kw + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      LDS + ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          mma::mma_bf16(s[f][2 * nb], qf[f][ks], kf[0], kf[1]);
          mma::mma_bf16(s[f][2 * nb + 1], qf[f][ks], kf[2], kf[3]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < MF; ++f) {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < SB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int qpos = length - p.n_tok + (f * 16 + gq + 8 * h) / G;
          const int c = w0 + j * 8 + 2 * tq + (e & 1);
          float x;
          if (c >= n_pos) {
            x = -CUDART_INF_F;  // past the visited pages: no weight at all
          } else {
            x = s[f][j][e] * p.scale;
            if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
            bool ok = c < length && c <= qpos;
            if (p.window > 0) ok = ok && (qpos - c < p.window);
            if (!ok) x = NEG_INF;
          }
          s[f][j][e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) m_r[f][h] = mma::quad_max(mx[h]);
#pragma unroll
      for (int j = 0; j < SB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = __expf(s[f][j][e] - m_r[f][e >> 1]);
          s[f][j][e] = pe;
          l_r[f][e >> 1] += pe;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_r[f][h] = mma::quad_sum(l_r[f][h]);
    }
    mma::cp_async_wait<0>();
    __syncwarp();  // this warp's V landed
#pragma unroll
    for (int kk = 0; kk < WPOS / 16; ++kk) {
      uint32_t pa[MF][4];
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        pa[f][0] = mma::pack_bf16x2(s[f][2 * kk][0], s[f][2 * kk][1]);
        pa[f][1] = mma::pack_bf16x2(s[f][2 * kk][2], s[f][2 * kk][3]);
        pa[f][2] = mma::pack_bf16x2(s[f][2 * kk + 1][0], s[f][2 * kk + 1][1]);
        pa[f][3] = mma::pack_bf16x2(s[f][2 * kk + 1][2], s[f][2 * kk + 1][3]);
      }
#pragma unroll
      for (int db = 0; db < DH / 16; ++db) {
        uint32_t vf[4];
        mma::ldmatrix_x4_trans(
            vf, Vw + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                    db * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          mma::mma_bf16(acc[f][2 * db], pa[f], vf[0], vf[1]);
          mma::mma_bf16(acc[f][2 * db + 1], pa[f], vf[2], vf[3]);
        }
      }
    }
  } else {
    mma::cp_async_wait<0>();
  }

  // merge the four warps in warp order: (m, l) first ...
  if (tq == 0) {
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* d = ml + (warp * RP + f * 16 + gq + 8 * h) * 2;
        d[0] = m_r[f][h];
        d[1] = l_r[f][h];
      }
  }
  __syncthreads();  // (m, l) visible; every warp is done reading K and V
  // ... then each warp's acc, scaled to the split's max, into the freed
  // K/V space
#pragma unroll
  for (int f = 0; f < MF; ++f) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f * 16 + gq + 8 * h;
      float M = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < SP_WARPS; ++w) M = fmaxf(M, ml[(w * RP + r) * 2]);
      const float sc = __expf(m_r[f][h] - M);
      float* d = merge + (warp * RP + r) * DH + 2 * tq;
#pragma unroll
      for (int j = 0; j < OB; ++j)
        *reinterpret_cast<float2*>(d + 8 * j) =
            make_float2(acc[f][j][2 * h] * sc, acc[f][j][2 * h + 1] * sc);
    }
  }
  __syncthreads();
  float* out = partial(p, b, hk, split, R, DH);
  for (int i = tid; i < R * DH; i += SP_THREADS) {
    const int r = i / DH, d = i % DH;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < SP_WARPS; ++w) sum += merge[(w * RP + r) * DH + d];
    out[i] = sum;
  }
  for (int r = tid; r < R; r += SP_THREADS) {
    float M = -CUDART_INF_F, L = 0.f;
#pragma unroll
    for (int w = 0; w < SP_WARPS; ++w) M = fmaxf(M, ml[(w * RP + r) * 2]);
#pragma unroll
    for (int w = 0; w < SP_WARPS; ++w)
      L += __expf(ml[(w * RP + r) * 2] - M) * ml[(w * RP + r) * 2 + 1];
    out[R * DH + 2 * r] = M;
    out[R * DH + 2 * r + 1] = L;
  }
}

// Grid (Hkv, B, ceil(R * Dh / CB_THREADS)): one thread per output
// element of a (kv head, batch row).  The block loads every live split's
// (m, l) of the row at once, forms the weights exp(m_s - M) and 1 / L in
// shared memory, then each thread sums its element over the live splits
// in index order (independent loads, all in flight together) and writes
// bf16.  A row with no live split (length 0) writes exactly 0.
constexpr int CB_THREADS = 256;

__global__ void __launch_bounds__(CB_THREADS) paged_combine_kernel(Params p,
                                                                   int dh) {
  extern __shared__ float wts[];  // n_split x R weights, n_split x R l,
                                  // then R x 1 / L
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = p.Hq / p.Hkv;
  const int R = p.n_tok * G;
  const int n_live = (visited(p, b) + SPLIT - 1) / SPLIT;
  float* ls = wts + p.n_split * R;
  float* inv = ls + p.n_split * R;
  for (int j = threadIdx.x; j < n_live * R; j += blockDim.x) {
    const float* ml = partial(p, b, hk, j / R, R, dh) + R * dh + 2 * (j % R);
    wts[j] = ml[0];
    ls[j] = ml[1];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float M = -CUDART_INF_F, L = 0.f;
    for (int s = 0; s < n_live; ++s) M = fmaxf(M, wts[s * R + r]);
    for (int s = 0; s < n_live; ++s) {
      const float w = __expf(wts[s * R + r] - M);
      wts[s * R + r] = w;
      L += w * ls[s * R + r];
    }
    inv[r] = n_live ? 1.f / fmaxf(L, 1e-37f) : 0.f;
  }
  __syncthreads();
  const int i = blockIdx.z * blockDim.x + threadIdx.x;
  if (i >= R * dh) return;
  const int r = i / dh, d = i % dh;
  float a = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_live; ++s)
    a += wts[s * R + r] * partial(p, b, hk, s, R, dh)[i];
  __nv_bfloat16* __restrict__ o = static_cast<__nv_bfloat16*>(p.o);
  o[(((size_t)b * p.n_tok + r / G) * p.Hq + (size_t)hk * G + r % G) * dh +
    d] = __float2bfloat16(a * inv[r]);
}

template <int DH, int MF>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<DH, MF>();
  static size_t done[mma::MAX_DEVICES] = {};
  const cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(paged_split_kernel<DH, MF>), smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hkv, p.B, p.n_split);
  paged_split_kernel<DH, MF><<<grid, SP_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------

template <int DH>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int rows = p.n_tok * (p.Hq / p.Hkv);
  const size_t smem = smem_bytes<DH>(rows);
  static size_t done[mma::MAX_DEVICES] = {};
  const cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(paged_attention_kernel<float, DH>), smem,
      done);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hkv, p.B);
  paged_attention_kernel<float, DH><<<grid, 32 * rows, smem, stream>>>(p);
  return cudaGetLastError();
}

// The second launch of the bfloat16 path: partials -> o.
cudaError_t launch_combine(const Params& p, int dh, cudaStream_t stream) {
  const int R = p.n_tok * (p.Hq / p.Hkv);
  const size_t smem = sizeof(float) * (2 * p.n_split + 1) * R;
  static size_t done[mma::MAX_DEVICES] = {};
  const cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(paged_combine_kernel), smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hkv, p.B, (R * dh + CB_THREADS - 1) / CB_THREADS);
  paged_combine_kernel<<<grid, CB_THREADS, smem, stream>>>(p, dh);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<DH>(p, stream);
  if (dtype != 1 || p.part == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = p.n_tok * (p.Hq / p.Hkv) <= 16
                              ? launch_split<DH, 1>(p, stream)
                              : launch_split<DH, 2>(p, stream);
  if (err != cudaSuccess) return err;
  return launch_combine(p, DH, stream);
}

int n_splits(int ps, int Pmax) { return (Pmax * ps + SPLIT - 1) / SPLIT; }

}  // namespace

// Floats of the partials scratch that repro_paged_attention needs for
// these shapes: B * Hkv * n_split * T * (Hq / Hkv) * (Dh + 2) in bfloat16
// (dtype 1), none in float32 (dtype 0).
extern "C" long long repro_paged_attention_scratch_floats(int B, int T,
                                                          int Hq, int Hkv,
                                                          int Dh, int ps,
                                                          int Pmax,
                                                          int dtype) {
  if (dtype != 1 || Hkv <= 0 || ps <= 0 || Pmax <= 0) return 0;
  return (long long)B * Hkv * n_splits(ps, Pmax) * T * (Hq / Hkv) * (Dh + 2);
}

// dtype: 0 = float32 (one launch writes o), 1 = bfloat16 (the split pass
// writes `partials`, then the combine writes o, both on `stream`;
// `partials` holds repro_paged_attention_scratch_floats floats).  Returns
// the cudaError_t of the first launch that failed, else cudaSuccess.
extern "C" int repro_paged_attention(const void* q, const void* k,
                                     const void* v, const void* block_tables,
                                     const void* lengths, void* o,
                                     void* partials, int B, int T, int Hq,
                                     int Hkv, int Dh, int P, int ps, int Pmax,
                                     int window, float softcap, float scale,
                                     int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || T <= 0 || T * (Hq / Hkv) > 32 ||
      P <= 0 || ps <= 0 || Pmax <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, k, v, static_cast<const int*>(block_tables),
           static_cast<const int*>(lengths), o, B, T, Hq, Hkv, P, ps, Pmax,
           window, softcap, scale, static_cast<float*>(partials),
           n_splits(ps, Pmax)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (Dh) {
    case 16: err = launch<16>(p, dtype, s); break;
    case 64: err = launch<64>(p, dtype, s); break;
    case 128: err = launch<128>(p, dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
