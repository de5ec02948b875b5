// Ring-cache decode attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/decode_attention/kernel.py::decode_attention (_decode_kernel),
// the one-token attention over the dense ring KV cache that the JAX model
// computes through L.decode_attention (repro/models/model.py:297).
//
// Semantics: q (B, Hq, Dh), k/v (B, C, Hkv, Dh), slot_pos (B, C) int32
// (-1 = empty), q_pos (B,) int32; slot c is valid when
// 0 <= slot_pos <= q_pos (and q_pos - slot_pos < window); scores =
// (q . k) / sqrt(Dh), tanh softcap, masked with the finite -1e30; online
// softmax in float32, l clamped at 1e-37; out in q's dtype.  A row whose
// slots are all empty returns the mean of V over the C slots, as the
// reference does (free decode slots hit this on every batched step).
//
// What bounds it on the H100: bytes.  One token attends over the whole
// cache, about 1 FLOP per byte of K/V read, far below the card's ridge
// (about 295 bf16 FLOPs per byte).  What counts is how many bytes are in
// flight on every SM, and reading no byte that cannot change the result.
// On the main path the ring is laid out as the identity (slot i holds
// position i, slots at or past a row's length stay empty), so with
// prompts of 73-511 tokens in a 1,024-slot ring about half the cache is
// dead.
//
// bfloat16 design (the served path): a split over the ring's slots, then
// a combine pass.
//   * Split.  Grid (Hkv, B, n_split), n_split = ceil(C / SPLIT): block s
//     covers slots [s * SPLIT, (s + 1) * SPLIT) of its row.  SPLIT = 128
//     is fixed, never derived from the batch, so a row's output depends
//     only on its own inputs and a call repeats bitwise.  128 slots of K
//     and V at Dh 128 are 64 KB, staged in one go with three blocks to an
//     SM, and the main shape (B=8, Hkv=8, C=1024) gets 512 blocks for
//     132 SMs instead of 64 (256 instead of 32 at the tp=2 shard).
//   * Empty runs.  Each thread reads the slot_pos of one slot of the run
//     (the row's 4 KB stay in L2), and only valid slots' K and V are
//     copied: cp.async zero-fills the others, whose weight is exactly 0
//     beside a valid slot.  A run with no valid slot reads the rest of
//     the row's slot_pos.  If the row has a valid slot elsewhere, the run
//     copies nothing and writes (m, l) = (-inf, 0), which the combine
//     weighs 0.  If the row has none (a free decode slot), the run copies
//     V for each of its slots and, its scores all being -1e30, gives each
//     weight 1, so the combine forms the mean of V over the C slots: the
//     reference's -1e30 arithmetic, up to rounding.
//   * Staging.  Each of the four warps owns 32 slots and copies their K
//     and V, bf16, into its own shared slice with cp.async (mma_bf16.cuh,
//     16 bytes a copy).  K and V are two commit groups: V is still in
//     flight while the scores and the softmax run.
//   * Products.  The G grouped heads of the kv head (G <= 32; 3, 4 and 12
//     in the configs, 2 at the tp=2 shard, 1 for the drafter) are the
//     rows of one m16 fragment, or two above 16; S = Q.K^T and P.V run
//     on mma.sync m16n8k16 with K read by ldmatrix and V by
//     ldmatrix.trans, P rounded to bf16 in registers.  The padded rows
//     cost nothing that shows: a warp makes 64 mma.sync against 16 KB of
//     copies.  Putting the slots on M (S^T = K.Q^T) would fill the
//     fragments, and matters only to a kernel bound by operations.
//   * Partials.  The four warps' (m, l, acc) are merged in shared memory
//     in warp order, and the split writes (m, l) and the unnormalised acc
//     in float32 to a scratch tensor that the wrapper allocates.  A
//     second kernel reduces a row's runs in index order and writes bf16.
//     No float atomics.
//   * Measured on one H100 80GB HBM3 at 700 W, at the main shape: 0.019
//     ms on the device (split 0.0115, combine 0.0033) against a bytes
//     bound of 0.0057 and SDPA's 0.029; the first version took 0.130.
//
// float32 keeps the first version's body: one block per (kv head, batch
// row) holds the G grouped query rows, one warp per row, walking the C
// slots in tiles of 32 staged in shared memory as float32; lane c scores
// slot c of the tile, the warp reduces max and sum with shuffles, and
// each lane accumulates Dh/32 output columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TC = 32;  // ring slots per tile: one per lane
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
  const int* slot_pos;
  const int* q_pos;
  void* o;
  int B, C, Hq, Hkv;
  int window;     // <= 0: none
  float softcap;  // <= 0: none
  float scale;
  float* part;    // bf16 split pass: (B, Hkv, n_split, G, Dh + 2) float32
  int n_split;
};

// slot_pos sp is valid for a query at qpos: 0 <= sp <= qpos, inside the
// window
__device__ __forceinline__ bool slot_valid(const Params& p, int sp,
                                           int qpos) {
  bool ok = sp >= 0 && sp <= qpos;
  if (p.window > 0) ok = ok && (qpos - sp < p.window);
  return ok;
}

template <int DH>
size_t smem_bytes(int G) {
  return sizeof(float) * (G * DH + TC * (DH + 1) + TC * DH);
}

template <typename T, int DH>
__global__ void __launch_bounds__(1024) ring_decode_kernel(Params p) {
  constexpr int KS = DH + 1;               // padded row stride of K tiles
  constexpr int DPL = (DH + 31) / 32;      // output columns per lane
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int G = blockDim.x / 32;
  float* Qs = smem;                        // G x DH
  float* Ks = Qs + G * DH;                 // TC x KS
  float* Vs = Ks + TC * KS;                // TC x DH

  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ o = static_cast<T*>(p.o);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int C = p.C;
  const int qpos = p.q_pos[b];
  const int* __restrict__ spos = p.slot_pos + (size_t)b * C;

  // the G query heads of this kv head are contiguous in q
  const T* qb = q + ((size_t)b * p.Hq + (size_t)hk * G) * DH;
  for (int i = tid * VEC; i < G * DH; i += blockDim.x * VEC) load16(qb + i, Qs + i);

  float m = NEG_INF, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += TC) {
    __syncthreads();  // the previous tile's readers are done (and Q staged)
    for (int i = tid * VEC; i < TC * DH; i += blockDim.x * VEC) {
      const int r = i / DH, d = i % DH;
      float kb[VEC], vb[VEC];
      if (c0 + r < C) {
        const size_t off = (((size_t)b * C + c0 + r) * p.Hkv + hk) * DH + d;
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
    if (c >= C) {
      s = -CUDART_INF_F;  // past the end: no weight at all
    } else {
      float dot = 0.f;
      const float* qr = Qs + warp * DH;
      const float* kr = Ks + lane * KS;
      for (int d = 0; d < DH; ++d) dot += qr[d] * kr[d];
      s = dot * p.scale;
      if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
      if (!slot_valid(p, spos[c], qpos)) s = NEG_INF;
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
  T* dst = o + ((size_t)b * p.Hq + (size_t)hk * G + warp) * DH;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    if (d < DH) dst[d] = from_f<T>(acc[j] * inv);
  }
}

template <int DH>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int G = p.Hq / p.Hkv;
  const size_t smem = smem_bytes<DH>(G);
  static size_t done[mma::MAX_DEVICES] = {};
  const cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(ring_decode_kernel<float, DH>), smem,
      done);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hkv, p.B);
  ring_decode_kernel<float, DH><<<grid, 32 * G, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: split over ring slots on the tensor cores, then the combine
// ---------------------------------------------------------------------------

constexpr int SPLIT = 128;              // ring slots per split
constexpr int SP_WARPS = 4;
constexpr int SP_THREADS = 32 * SP_WARPS;
constexpr int WPOS = SPLIT / SP_WARPS;  // slots per warp: 32, one per lane

template <int DH, int MF>
constexpr size_t split_smem_bytes() {
  // Q (16 MF rows), K and V (SPLIT rows each), padded by 8 elements; the
  // warps' (m, l)
  return sizeof(__nv_bfloat16) * (16 * MF + 2 * SPLIT) * (DH + 8) +
         sizeof(float) * SP_WARPS * 16 * MF * 2;
}

// The partial of a row's split s sits at part + ((b * Hkv + hk) * n_split
// + s) * G * (Dh + 2): G x Dh accumulators, then G pairs (m, l).
__device__ __forceinline__ float* partial(const Params& p, int b, int hk,
                                          int s, int G, int dh) {
  return p.part + (((size_t)b * p.Hkv + hk) * p.n_split + s) * G * (dh + 2);
}

template <int DH, int MF>
__global__ void __launch_bounds__(SP_THREADS) ring_split_kernel(Params p) {
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
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int C = p.C;
  const int G = p.Hq / p.Hkv;
  const int qpos = p.q_pos[b];
  const int* __restrict__ spos = p.slot_pos + (size_t)b * C;

  // this warp's slots w0 .. w0 + 31; lane i reads slot w0 + i
  const int w0 = split * SPLIT + warp * WPOS;
  const bool in_range = w0 + lane < C;
  const bool valid = in_range && slot_valid(p, spos[w0 + lane], qpos);
  bool row_empty = false;
  if (!__syncthreads_or(valid)) {
    bool any = false;
    for (int i = tid; i < C; i += SP_THREADS)
      any = any || slot_valid(p, spos[i], qpos);
    if (__syncthreads_or(any)) {
      // a run with no valid slot beside one that has: no weight at all
      float* ml_out = partial(p, b, hk, split, G, DH) + G * DH;
      for (int r = tid; r < G; r += SP_THREADS) {
        ml_out[2 * r] = -CUDART_INF_F;
        ml_out[2 * r + 1] = 0.f;
      }
      return;
    }
    row_empty = true;  // no valid slot in the row: every run sums V
  }
  const unsigned kmask = __ballot_sync(0xffffffffu, valid);
  const unsigned inr = __ballot_sync(0xffffffffu, in_range);
  const unsigned vmask = row_empty ? inr : kmask;

  // Q rows r = g (rows past G are zero): group 0
  for (int i = tid; i < RP * CH; i += SP_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < G;
    const bf16* src =
        ok ? q + ((size_t)b * p.Hq + (size_t)hk * G + r) * DH + c * 8 : q;
    mma::cp_async16(Qs + r * LDS + c * 8, src, ok);
  }
  mma::cp_async_commit();

  // K of the valid slots is group 1, V (of every slot in an empty row)
  // group 2; the rest is zero-filled
  bf16* Kw = Ks + warp * WPOS * LDS;
  bf16* Vw = Vs + warp * WPOS * LDS;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf16* src = half ? v : k;
    bf16* dst = half ? Vw : Kw;
    const unsigned mask = half ? vmask : kmask;
    for (int i = lane; i < WPOS * CH; i += 32) {
      const int r = i / CH, c = i % CH;
      const bool ok = (mask >> r) & 1u;
      const size_t off =
          ok ? (((size_t)b * C + w0 + r) * p.Hkv + hk) * DH + c * 8 : 0;
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

  // a warp with no slot in range adds nothing: m = -inf, l = acc = 0
  float m_r[MF][2], l_r[MF][2], acc[MF][OB][4];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    m_r[f][0] = m_r[f][1] = -CUDART_INF_F;
    l_r[f][0] = l_r[f][1] = 0.f;
#pragma unroll
    for (int j = 0; j < OB; ++j)
      acc[f][j][0] = acc[f][j][1] = acc[f][j][2] = acc[f][j][3] = 0.f;
  }
  if (inr != 0u) {
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
          const int idx = j * 8 + 2 * tq + (e & 1);  // slot w0 + idx
          float x;
          if (!((inr >> idx) & 1u)) {
            x = -CUDART_INF_F;  // past the ring: no weight at all
          } else {
            x = s[f][j][e] * p.scale;
            if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
            if (!((kmask >> idx) & 1u)) x = NEG_INF;
          }
          s[f][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
  float* out = partial(p, b, hk, split, G, DH);
  for (int i = tid; i < G * DH; i += SP_THREADS) {
    const int r = i / DH, d = i % DH;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < SP_WARPS; ++w) sum += merge[(w * RP + r) * DH + d];
    out[i] = sum;
  }
  for (int r = tid; r < G; r += SP_THREADS) {
    float M = -CUDART_INF_F, L = 0.f;
#pragma unroll
    for (int w = 0; w < SP_WARPS; ++w) M = fmaxf(M, ml[(w * RP + r) * 2]);
#pragma unroll
    for (int w = 0; w < SP_WARPS; ++w)
      L += __expf(ml[(w * RP + r) * 2] - M) * ml[(w * RP + r) * 2 + 1];
    out[G * DH + 2 * r] = M;
    out[G * DH + 2 * r + 1] = L;
  }
}

// Grid (Hkv, B, ceil(G * Dh / CB_THREADS)): one thread per output element
// of a (kv head, batch row).  The block loads every run's (m, l) of the
// row at once, forms the weights exp(m_s - M) and 1 / L in shared memory
// (a run marked (-inf, 0) weighs 0), then each thread sums its element
// over the runs of nonzero weight in index order and writes bf16.
constexpr int CB_THREADS = 256;

__global__ void __launch_bounds__(CB_THREADS) ring_combine_kernel(Params p,
                                                                  int dh) {
  extern __shared__ float wts[];  // n_split x G weights, n_split x G l,
                                  // then G x 1 / L
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = p.Hq / p.Hkv;
  const int n = p.n_split;
  float* ls = wts + n * G;
  float* inv = ls + n * G;
  for (int j = threadIdx.x; j < n * G; j += blockDim.x) {
    const float* ml = partial(p, b, hk, j / G, G, dh) + G * dh + 2 * (j % G);
    wts[j] = ml[0];
    ls[j] = ml[1];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < G; r += blockDim.x) {
    float M = -CUDART_INF_F, L = 0.f;
    for (int s = 0; s < n; ++s) M = fmaxf(M, wts[s * G + r]);
    for (int s = 0; s < n; ++s) {
      const float w = __expf(wts[s * G + r] - M);
      wts[s * G + r] = w;
      L += w * ls[s * G + r];
    }
    inv[r] = 1.f / fmaxf(L, 1e-37f);
  }
  __syncthreads();
  const int i = blockIdx.z * blockDim.x + threadIdx.x;
  if (i >= G * dh) return;
  const int r = i / dh, d = i % dh;
  float a = 0.f;
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    const float w = wts[s * G + r];
    // a run of weight 0 adds nothing; one marked empty wrote no acc
    if (w != 0.f) a += w * partial(p, b, hk, s, G, dh)[i];
  }
  __nv_bfloat16* __restrict__ o = static_cast<__nv_bfloat16*>(p.o);
  o[((size_t)b * p.Hq + (size_t)hk * G + r) * dh + d] =
      __float2bfloat16(a * inv[r]);
}

template <int DH, int MF>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<DH, MF>();
  static size_t done[mma::MAX_DEVICES] = {};
  const cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(ring_split_kernel<DH, MF>), smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hkv, p.B, p.n_split);
  ring_split_kernel<DH, MF><<<grid, SP_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The second launch of the bfloat16 path: partials -> o.
cudaError_t launch_combine(const Params& p, int dh, cudaStream_t stream) {
  const int G = p.Hq / p.Hkv;
  const size_t smem = sizeof(float) * (2 * p.n_split + 1) * G;
  static size_t done[mma::MAX_DEVICES] = {};
  const cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(ring_combine_kernel), smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hkv, p.B, (G * dh + CB_THREADS - 1) / CB_THREADS);
  ring_combine_kernel<<<grid, CB_THREADS, smem, stream>>>(p, dh);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<DH>(p, stream);
  if (dtype != 1 || p.part == nullptr || p.n_split <= 0)
    return cudaErrorInvalidValue;
  const cudaError_t err = p.Hq / p.Hkv <= 16 ? launch_split<DH, 1>(p, stream)
                                             : launch_split<DH, 2>(p, stream);
  if (err != cudaSuccess) return err;
  return launch_combine(p, DH, stream);
}

int n_splits(int C) { return (C + SPLIT - 1) / SPLIT; }

}  // namespace

// Floats of the partials scratch that repro_ring_decode needs for these
// shapes: B * Hkv * n_split * (Hq / Hkv) * (Dh + 2) in bfloat16 (dtype 1),
// none in float32 (dtype 0).
extern "C" long long repro_ring_decode_scratch_floats(int B, int C, int Hq,
                                                      int Hkv, int Dh,
                                                      int dtype) {
  if (dtype != 1 || B <= 0 || C <= 0 || Hkv <= 0) return 0;
  return (long long)B * Hkv * n_splits(C) * (Hq / Hkv) * (Dh + 2);
}

// dtype: 0 = float32 (one launch writes o), 1 = bfloat16 (the split pass
// writes `partials`, then the combine writes o, both on `stream`;
// `partials` holds repro_ring_decode_scratch_floats floats).  Returns the
// cudaError_t of the first launch that failed, else cudaSuccess.
extern "C" int repro_ring_decode(const void* q, const void* k, const void* v,
                                 const void* slot_pos, const void* q_pos,
                                 void* o, void* partials, int B, int C,
                                 int Hq, int Hkv, int Dh, int window,
                                 float softcap, float scale, int dtype,
                                 void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 32) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, static_cast<const int*>(slot_pos),
           static_cast<const int*>(q_pos), o, B, C, Hq, Hkv, window, softcap,
           scale, static_cast<float*>(partials), n_splits(C)};
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

extern "C" const char* repro_ring_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
