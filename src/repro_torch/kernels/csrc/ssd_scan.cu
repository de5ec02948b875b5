// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a),
// plain CUDA C++.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/ssd/kernel.py::ssd_scan (_ssd_kernel),
// the scan the JAX model computes through L.ssd_chunked
// (repro/models/model.py:355).
//
// Semantics (the Pallas kernel's): for each (b, h), from a zero state,
//   state_t = exp(dt_t * A_h) * state_{t-1} + dt_t * x_t (outer) B_t
//   y_t     = state_t . C_t
// with x (B, S, H, P) and B/C (B, S, N) in the model dtype (one group:
// B and C are shared by all heads), dt (B, S, H) and A (H,) float32;
// y (B, S, H, P) in x's dtype, the final state (B, H, P, N) in float32.
// x, B and C are read through their batch and sequence strides (in the
// model they are slices of one (B, S, conv_dim) tensor); within a row x
// is (H, P) contiguous and B/C are contiguous.
//
// What bounds it on the H100.  At B=1, S=512, H=80, P=64, N=128 in bf16
// the scan must move about 13.5 MB (x and y 5.2 MB each, the float32
// state 2.6 MB, dt, B and C) and do about 2 GFLOP (the causal half of
// C.B per chunk, shared by the heads, and per head the intra-chunk,
// inter-chunk and state products): bytes bound it, at about 4 us.  The
// first version ran every product on the float32 CUDA cores out of
// shared memory, and each of the 320 blocks recomputed the same C.B
// tile: 0.43 ms, about 107x its bound, on one H100 80GB HBM3 at 700 W.
//
// The walk over the sequence.  The TPU grid walks the chunks of one
// (b, h) in order and keeps the (P, N) state in VMEM scratch; blocks on
// the card run in no order, so the walk lives inside one block.  Rows p
// of the state are independent (y[:, p] needs only x[:, p] and
// state[p, :]), so the grid is (P / 16, H, B): each block owns 16 state
// rows and carries them, with no combine pass (B=1 and 80 heads give 320
// blocks for 132 SMs).  The sequence goes in sub-chunks of LC = 64 rows,
// whatever the caller's chunk: chunking is exact algebra, so only
// rounding changes.  Per sub-chunk, with a = dt * A and cum its inclusive
// prefix sum inside the sub-chunk:
//   M[i][j]  = (C_i . B_j) * exp(cum_i - cum_j) * dt_j   for j <= i
//   y_i      = sum_j M[i][j] x_j  +  exp(cum_i) * (C_i . state)
//   state    = exp(cum_last) * state + sum_j x_j (outer) (w_j B_j),
//              w_j = exp(cum_last - cum_j) * dt_j
// exp is evaluated only where its argument is <= 0 (j <= i), so a masked
// entry never becomes inf * 0.  Rows past S read as dt = x = B = C = 0,
// which leaves the state as it is.
//
// bfloat16 design (the served path): two launches.
//   * C.B^T once per (batch row, sub-chunk).  B and C are shared by every
//     head (one group), so a pre-pass (grid (n_sub, B), four warps)
//     computes the causal blocks of each sub-chunk's 64 x 64 C.B^T on
//     mma.sync and writes them in float32 to a scratch tensor the wrapper
//     allocates (16 KB a sub-chunk; 128 KB a row at S = 512), which the
//     scan blocks read from L2.
//   * The scan.  Four warps a block; warp w owns y rows 16w .. 16w + 15
//     of a sub-chunk and the state's n-column pairs w, w + 4, ...  B, C
//     and the x tile are staged by cp.async (16-byte copies through
//     their strides).  Every product runs on mma.sync m16n8k16, bf16 in,
//     float32 out: M . x with M formed in float32 from the pre-pass's
//     tile (blocks above the diagonal skipped); C . state^T, the
//     exp(cum_i) factor applied to the float32 product; and the state
//     update (w o x)^T . B, accumulated into the state, which stays
//     float32 in the warps' registers across the whole walk.  x, B and C
//     arrive in bf16 and go in as they are.  M, w o x and the state are
//     float32 values: each goes in as three bf16 parts whose sum holds
//     the float32 value to 2^-27, at three products each (mma_bf16.cuh
//     split_bf16x2), so the scan keeps the float32 body's precision.
//     It has to: under the served init the scan's y is far below D x,
//     and with float32 products the model's kernel and plain paths round
//     every layer's y + D x to the same bf16 (chip_smoke.py phase 8).  On
//     one H100 80GB HBM3 at 700 W, with the operands rounded to one bf16
//     (2^-9) each layer's scan stayed inside its tolerance (0.0075
//     against 3e-2, scale-normalised) but the two paths' prefill states
//     parted by 0.157 by layer 60, and with two parts (about 2^-17) by
//     0.078, against 0.03; tf32 (2^-11) keeps fewer bits than two parts.
//     The state's three parts sit in shared memory for the next
//     sub-chunk's C . state^T.
//   * What bounds it now: latency.  On one H100 80GB HBM3 at 700 W the
//     mamba2 shape takes 0.072 ms (pre-pass 0.003, scan 0.064-0.066),
//     18x its bound: each block walks its 8 sub-chunks in order, and each
//     sub-chunk waits for its copies (one stage; two or three blocks
//     share an SM to hide it) and re-reads B, C and its tile of C.B^T
//     from L2 (about 45 KB).
//
// float32 keeps the first version's body on the CUDA cores: B, C, x and
// M in shared memory as float32, each thread a 4 x 4 register tile of M
// and of y, and the state rows in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int LC = 64;          // sequence rows per sub-chunk
constexpr int PT = 16;          // state rows (head-dim columns) per block
constexpr int THREADS = 256;    // the float32 body
constexpr int TC_WARPS = 4;     // the bf16 bodies
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int PARTS = 3;        // bf16 parts of a float32 operand

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* state;
  long long x_sb, x_ss;  // x strides (elements) over batch and sequence
  long long b_sb, b_ss;  // B strides
  long long c_sb, c_ss;  // C strides
  int B, S, H, P;
  float* cb;  // bf16 pre-pass: (B, n_sub, LC, LC) float32 C.B^T
  int n_sub;
  // training only (null when serving): the state entering each sub-chunk,
  // (B, n_sub, H, P, N) float32, which ssd_backward.cu reads
  float* states;
};

template <int N>
constexpr int smem_floats() {
  return 2 * LC * (N + 1)   // B and C rows, padded
         + LC * PT          // x tile
         + LC * (LC + 1)    // M
         + PT * (N + 1)     // carried state rows
         + 3 * LC;          // dt, cum, w
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_scan_kernel(Params p) {
  static_assert(THREADS % N == 0 && PT * N % THREADS == 0, "state tiling");
  constexpr int NS = N + 1;   // padded row stride of B, C and the state
  constexpr int MS = LC + 1;  // padded row stride of M
  constexpr int EPT = PT * N / THREADS;  // state entries per thread
  extern __shared__ float smem[];
  float* Bs = smem;            // LC x NS
  float* Cs = Bs + LC * NS;    // LC x NS
  float* Xs = Cs + LC * NS;    // LC x PT
  float* Ms = Xs + LC * PT;    // LC x MS
  float* St = Ms + LC * MS;    // PT x NS
  float* dts = St + PT * NS;   // LC
  float* cum = dts + LC;       // LC
  float* w = cum + LC;         // LC

  const T* __restrict__ xg = static_cast<const T*>(p.x);
  const T* __restrict__ bg = static_cast<const T*>(p.Bm);
  const T* __restrict__ cg = static_cast<const T*>(p.Cm);
  T* __restrict__ yg = static_cast<T*>(p.y);

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float A = p.A[h];

  for (int i = tid; i < PT * NS; i += THREADS) St[i] = 0.f;

  for (int s0 = 0; s0 < p.S; s0 += LC) {
    const int rows = min(LC, p.S - s0);
    __syncthreads();  // the previous sub-chunk's readers are done
    if (p.states) {
      float* out = p.states +
          ((((size_t)b * p.n_sub + s0 / LC) * p.H + h) * p.P + p0) * N;
      for (int i = tid; i < PT * N; i += THREADS)
        out[i] = St[(i / N) * NS + i % N];
    }

    // warp 0: dt and the inclusive prefix sum of a = dt * A (two rows a
    // lane, a shuffle scan over the lanes)
    if (tid < 32) {
      const int i0 = 2 * tid, i1 = 2 * tid + 1;
      const size_t base = ((size_t)b * p.S + s0) * p.H + h;
      const float d0 = i0 < rows ? p.dt[base + (size_t)i0 * p.H] : 0.f;
      const float d1 = i1 < rows ? p.dt[base + (size_t)i1 * p.H] : 0.f;
      const float a0 = d0 * A, a1 = d1 * A;
      const float pair = a0 + a1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - pair;
      dts[i0] = d0;
      dts[i1] = d1;
      cum[i0] = excl + a0;
      cum[i1] = incl;
    }
    // every thread: B and C rows and the x tile, widened to float
    for (int i = tid; i < LC * N; i += THREADS) {
      const int r = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (r < rows) {
        const long long s = s0 + r;
        bv = to_f(bg[b * p.b_sb + s * p.b_ss + n]);
        cv = to_f(cg[b * p.c_sb + s * p.c_ss + n]);
      }
      Bs[r * NS + n] = bv;
      Cs[r * NS + n] = cv;
    }
    for (int i = tid; i < LC * PT; i += THREADS) {
      const int r = i / PT, c = i % PT;
      const long long s = s0 + r;
      Xs[i] = r < rows
          ? to_f(xg[b * p.x_sb + s * p.x_ss + (long long)h * p.P + p0 + c])
          : 0.f;
    }
    __syncthreads();

    // M: a 4 x 4 register tile a thread, rows ti + 16a, columns tj + 16c;
    // tiles wholly above the diagonal (c > a) are 0 and not computed
    {
      const int ti = tid / 16, tj = tid % 16;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ti + 16 * a) * NS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[(tj + 16 * c) * NS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c <= a; ++c) acc[a][c] += cv[a] * bv[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ti + 16 * a, j = tj + 16 * c;
          Ms[i * MS + j] = (c <= a && j <= i)
              ? acc[a][c] * expf(cum[i] - cum[j]) * dts[j]
              : 0.f;
        }
      }
    }
    if (tid < LC) w[tid] = expf(cum[LC - 1] - cum[tid]) * dts[tid];
    __syncthreads();

    // y: four rows r0 + 16k of one column c a thread; the intra-chunk
    // sum over j, then the carried state's contribution
    {
      const int c = tid % PT, r0 = tid / PT;
      float intra[4] = {0.f, 0.f, 0.f, 0.f};
      float inter[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < LC; ++j) {
        const float xv = Xs[j * PT + c];
#pragma unroll
        for (int k = 0; k < 4; ++k) intra[k] += Ms[(r0 + 16 * k) * MS + j] * xv;
      }
      for (int n = 0; n < N; ++n) {
        const float sv = St[c * NS + n];
#pragma unroll
        for (int k = 0; k < 4; ++k) inter[k] += Cs[(r0 + 16 * k) * NS + n] * sv;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = r0 + 16 * k;
        if (i < rows) {
          const size_t off = (((size_t)b * p.S + s0 + i) * p.H + h) * p.P + p0 + c;
          yg[off] = from_f<T>(intra[k] + expf(cum[i]) * inter[k]);
        }
      }
    }
    __syncthreads();  // the state is read above and rewritten below

    // state: entries (tid / N + e * THREADS / N, tid % N)
    {
      const int n = tid % N;
      const float dec = expf(cum[LC - 1]);
      float acc[EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[e] = 0.f;
      for (int j = 0; j < LC; ++j) {
        const float bw = Bs[j * NS + n] * w[j];
#pragma unroll
        for (int e = 0; e < EPT; ++e)
          acc[e] += Xs[j * PT + tid / N + e * (THREADS / N)] * bw;
      }
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        float& s = St[(tid / N + e * (THREADS / N)) * NS + n];
        s = s * dec + acc[e];
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < PT * N; i += THREADS) {
    const int c = i / N, n = i % N;
    p.state[(((size_t)b * p.H + h) * p.P + p0 + c) * N + n] = St[c * NS + n];
  }
}

template <int N>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<N>() * sizeof(float);
  static size_t done[mma::MAX_DEVICES] = {};
  const cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(ssd_scan_kernel<float, N>), smem, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.P / PT, p.H, p.B);
  ssd_scan_kernel<float, N><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: C.B^T once per sub-chunk, then the scan on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Stage rows s0 .. s0 + LC - 1 of B or C (N wide, through the batch and
// sequence strides) into shared rows of `lds` elements; rows past S are
// zero.
template <int N>
__device__ __forceinline__ void stage_rows(bf16* dst, int lds,
                                           const bf16* src, long long sb,
                                           long long ss, int b, int s0,
                                           int rows) {
  constexpr int CH = N / 8;
  for (int i = threadIdx.x; i < LC * CH; i += TC_THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < rows;
    mma::cp_async16(dst + r * lds + c * 8,
                    ok ? src + b * sb + (s0 + r) * ss + c * 8 : src, ok);
  }
}

// The pre-pass: grid (n_sub, B).  Warp w computes rows 16w .. 16w + 15
// of the sub-chunk's C.B^T, in the column blocks at or below the
// diagonal (the only ones the scan reads), K = N on mma.sync.
template <int N>
__global__ void __launch_bounds__(TC_THREADS) ssd_cb_kernel(Params p) {
  constexpr int LDS = N + 8;  // padded shared row: no ldmatrix conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);  // LC x LDS
  bf16* Cs = Bs + LC * LDS;                       // LC x LDS
  const int sub = blockIdx.x, b = blockIdx.y;
  const int s0 = sub * LC;
  const int rows = min(LC, p.S - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  stage_rows<N>(Bs, LDS, static_cast<const bf16*>(p.Bm), p.b_sb, p.b_ss, b,
                s0, rows);
  stage_rows<N>(Cs, LDS, static_cast<const bf16*>(p.Cm), p.c_sb, p.c_ss, b,
                s0, rows);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  float acc[LC / 16][2][4] = {};
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t ca[4];
    mma::ldmatrix_x4(ca, Cs + (16 * warp + (lane & 15)) * LDS + ks * 16 +
                             (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < LC / 16; ++nb) {
      if (nb > warp) continue;
      uint32_t bf[4];
      mma::ldmatrix_x4(bf, Bs + (nb * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                    LDS + ks * 16 + ((lane >> 3) & 1) * 8);
      mma::mma_bf16(acc[nb][0], ca, bf[0], bf[1]);
      mma::mma_bf16(acc[nb][1], ca, bf[2], bf[3]);
    }
  }
  float* out = p.cb + ((size_t)b * p.n_sub + sub) * LC * LC;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < LC / 16; ++nb) {
    if (nb > warp) continue;
#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
      const int j = nb * 16 + hb * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + (16 * warp + g) * LC + j) =
          make_float2(acc[nb][hb][0], acc[nb][hb][1]);
      *reinterpret_cast<float2*>(out + (16 * warp + g + 8) * LC + j) =
          make_float2(acc[nb][hb][2], acc[nb][hb][3]);
    }
  }
}

template <int N>
constexpr size_t chunk_smem_bytes() {
  // B and C (LC rows), the state's bf16 parts (PT rows each), all N + 8
  // wide; the x tile; dt, cum, w, exp(cum)
  return sizeof(bf16) * ((2 * LC + PARTS * PT) * (N + 8) + LC * (PT + 8)) +
         sizeof(float) * 4 * LC;
}

template <int N>
__global__ void __launch_bounds__(TC_THREADS) ssd_chunk_kernel(Params p) {
  constexpr int LDS = N + 8;   // B, C and state rows
  constexpr int XLD = PT + 8;  // x rows
  constexpr int NP = N / 16;   // the state's n-column pairs (16 columns)
  constexpr int PPW = (NP + TC_WARPS - 1) / TC_WARPS;  // pairs per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);  // LC x LDS
  bf16* Cs = Bs + LC * LDS;                       // LC x LDS
  bf16* Sp = Cs + LC * LDS;  // PARTS x PT x LDS: the state's bf16 parts
  bf16* Xs = Sp + PARTS * PT * LDS;               // LC x XLD
  float* dts = reinterpret_cast<float*>(Xs + LC * XLD);  // LC
  float* cum = dts + LC;                                 // LC
  float* wv = cum + LC;                                  // LC
  float* ecum = wv + LC;                                 // LC

  const bf16* __restrict__ xg = static_cast<const bf16*>(p.x);
  bf16* __restrict__ yg = static_cast<bf16*>(p.y);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const float A = p.A[h];
  const int i0 = 16 * warp + g, i1 = i0 + 8;  // this thread's rows of y

  // the carried state: this warp's n-column pairs, rows p = g and g + 8
  float st[PPW][2][4] = {};
  for (int i = threadIdx.x; i < PARTS * PT * LDS; i += TC_THREADS)
    Sp[i] = __float2bfloat16(0.f);

  for (int sub = 0; sub < p.n_sub; ++sub) {
    const int s0 = sub * LC;
    const int rows = min(LC, p.S - s0);
    if (p.states) {  // the state entering this sub-chunk, for the backward
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        const int pair = warp + TC_WARPS * i;
        if (pair >= NP) continue;
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
          const int n = pair * 16 + hb * 8 + 2 * t;
          float* d = p.states +
              ((((size_t)b * p.n_sub + sub) * p.H + h) * p.P + p0 + g) * N +
              n;
          *reinterpret_cast<float2*>(d) =
              make_float2(st[i][hb][0], st[i][hb][1]);
          *reinterpret_cast<float2*>(d + 8 * N) =
              make_float2(st[i][hb][2], st[i][hb][3]);
        }
      }
    }
    __syncthreads();  // the last sub-chunk's readers are done, Sp written
    stage_rows<N>(Bs, LDS, static_cast<const bf16*>(p.Bm), p.b_sb, p.b_ss,
                  b, s0, rows);
    stage_rows<N>(Cs, LDS, static_cast<const bf16*>(p.Cm), p.c_sb, p.c_ss,
                  b, s0, rows);
    for (int i = threadIdx.x; i < LC * (PT / 8); i += TC_THREADS) {
      const int r = i / (PT / 8), c = i % (PT / 8);
      const bool ok = r < rows;
      mma::cp_async16(
          Xs + r * XLD + c * 8,
          ok ? xg + b * p.x_sb + (s0 + r) * p.x_ss + (long long)h * p.P +
                   p0 + c * 8
             : xg,
          ok);
    }
    mma::cp_async_commit();
    // warp 0: dt and the inclusive prefix sum of a = dt * A (two rows a
    // lane, a shuffle scan over the lanes), then w and exp(cum)
    if (warp == 0) {
      const int j0 = 2 * lane, j1 = 2 * lane + 1;
      const size_t base = ((size_t)b * p.S + s0) * p.H + h;
      const float d0 = j0 < rows ? p.dt[base + (size_t)j0 * p.H] : 0.f;
      const float d1 = j1 < rows ? p.dt[base + (size_t)j1 * p.H] : 0.f;
      const float a0 = d0 * A, a1 = d1 * A;
      const float pair = a0 + a1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const float c0 = incl - pair + a0, c1 = incl;
      const float last = __shfl_sync(0xffffffffu, incl, 31);
      dts[j0] = d0;
      dts[j1] = d1;
      cum[j0] = c0;
      cum[j1] = c1;
      wv[j0] = expf(last - c0) * d0;
      wv[j1] = expf(last - c1) * d1;
      ecum[j0] = expf(c0);
      ecum[j1] = expf(c1);
    }
    // this warp's rows of C.B^T in the column blocks at or below the
    // diagonal, in the A fragment's order (rows i0 / i1, columns
    // 16 ks + 2t and + 8), from the pre-pass
    const float* cbt = p.cb + ((size_t)b * p.n_sub + sub) * LC * LC;
    float2 cbv[LC / 16][4];
#pragma unroll
    for (int ks = 0; ks < LC / 16; ++ks) {
      if (ks > warp) continue;
      const int j = 16 * ks + 2 * t;
      cbv[ks][0] = *reinterpret_cast<const float2*>(cbt + i0 * LC + j);
      cbv[ks][1] = *reinterpret_cast<const float2*>(cbt + i1 * LC + j);
      cbv[ks][2] = *reinterpret_cast<const float2*>(cbt + i0 * LC + j + 8);
      cbv[ks][3] = *reinterpret_cast<const float2*>(cbt + i1 * LC + j + 8);
    }
    mma::cp_async_wait<0>();
    __syncthreads();  // the tiles and the scan are visible

    // y_i = sum_j M[i][j] x_j (M formed from C.B^T in float32, in parts)
    float ya[2][4] = {}, yi[2][4] = {};
    const float ci0 = cum[i0], ci1 = cum[i1];
#pragma unroll
    for (int ks = 0; ks < LC / 16; ++ks) {
      if (ks > warp) continue;
      float m[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = q & 1 ? i1 : i0;
        const float ci = q & 1 ? ci1 : ci0;
        const float2 c = cbv[ks][q];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 16 * ks + 2 * t + 8 * (q >> 1) + e;
          m[q][e] = j <= i ? (e ? c.y : c.x) * expf(ci - cum[j]) * dts[j]
                           : 0.f;
        }
      }
      uint32_t a[4][PARTS];  // fragment register q, part k
#pragma unroll
      for (int q = 0; q < 4; ++q) mma::split_bf16x2(m[q][0], m[q][1], a[q]);
      uint32_t xf[4];  // x as the k x n operand: rows j, columns p
      mma::ldmatrix_x4_trans(
          xf, Xs + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * XLD +
                  (lane >> 4) * 8);
#pragma unroll
      for (int k = PARTS - 1; k >= 0; --k) {
        const uint32_t ak[4] = {a[0][k], a[1][k], a[2][k], a[3][k]};
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          mma::mma_bf16(ya[nb], ak, xf[2 * nb], xf[2 * nb + 1]);
      }
    }
    // ... + exp(cum_i) (C_i . state), the state's parts as k x n
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t ca[4];
      mma::ldmatrix_x4(ca, Cs + (16 * warp + (lane & 15)) * LDS + ks * 16 +
                               (lane >> 4) * 8);
      const int so = ((lane & 7) + ((lane >> 4) << 3)) * LDS + ks * 16 +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int k = PARTS - 1; k >= 0; --k) {
        uint32_t sf[4];
        mma::ldmatrix_x4(sf, Sp + k * PT * LDS + so);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          mma::mma_bf16(yi[nb], ca, sf[2 * nb], sf[2 * nb + 1]);
      }
    }
    {
      const float e0 = ecum[i0], e1 = ecum[i1];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int col = p0 + nb * 8 + 2 * t;
        if (i0 < rows)
          *reinterpret_cast<uint32_t*>(
              yg + (((size_t)b * p.S + s0 + i0) * p.H + h) * p.P + col) =
              mma::pack_bf16x2(ya[nb][0] + e0 * yi[nb][0],
                               ya[nb][1] + e0 * yi[nb][1]);
        if (i1 < rows)
          *reinterpret_cast<uint32_t*>(
              yg + (((size_t)b * p.S + s0 + i1) * p.H + h) * p.P + col) =
              mma::pack_bf16x2(ya[nb][2] + e1 * yi[nb][2],
                               ya[nb][3] + e1 * yi[nb][3]);
      }
    }

    // state = exp(cum_last) state + (w o x)^T . B, in float32 registers
    const float dec = expf(cum[LC - 1]);
#pragma unroll
    for (int i = 0; i < PPW; ++i)
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][hb][e] *= dec;
#pragma unroll
    for (int ks = 0; ks < LC / 16; ++ks) {
      uint32_t xa[4];  // x^T as the m x k operand: rows p, columns j
      mma::ldmatrix_x4_trans(
          xa, Xs + (16 * ks + ((lane >> 4) << 3) + (lane & 7)) * XLD +
                  ((lane >> 3) & 1) * 8);
      const int j = 16 * ks + 2 * t;
      uint32_t wx[4][PARTS];  // (w o x)^T in float32, in parts
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xa[q]));
        const int jq = j + 8 * (q >> 1);
        mma::split_bf16x2(xv.x * wv[jq], xv.y * wv[jq + 1], wx[q]);
      }
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        const int pair = warp + TC_WARPS * i;
        if (pair >= NP) continue;
        uint32_t bf[4];  // B as the k x n operand: rows j, columns n
        mma::ldmatrix_x4_trans(
            bf, Bs + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                    pair * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int k = PARTS - 1; k >= 0; --k) {
          const uint32_t wk[4] = {wx[0][k], wx[1][k], wx[2][k], wx[3][k]};
#pragma unroll
          for (int hb = 0; hb < 2; ++hb)
            mma::mma_bf16(st[i][hb], wk, bf[2 * hb], bf[2 * hb + 1]);
        }
      }
    }
    __syncthreads();  // every warp is done reading the state's parts
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      const int pair = warp + TC_WARPS * i;
      if (pair >= NP) continue;
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const int n = pair * 16 + hb * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // rows p = g, g + 8
          uint32_t part[PARTS];
          mma::split_bf16x2(st[i][hb][2 * r], st[i][hb][2 * r + 1], part);
#pragma unroll
          for (int k = 0; k < PARTS; ++k)
            *reinterpret_cast<uint32_t*>(Sp + k * PT * LDS +
                                         (g + 8 * r) * LDS + n) = part[k];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PPW; ++i) {
    const int pair = warp + TC_WARPS * i;
    if (pair >= NP) continue;
#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
      const int n = pair * 16 + hb * 8 + 2 * t;
      float* d = p.state + (((size_t)b * p.H + h) * p.P + p0 + g) * N + n;
      *reinterpret_cast<float2*>(d) = make_float2(st[i][hb][0], st[i][hb][1]);
      *reinterpret_cast<float2*>(d + 8 * N) =
          make_float2(st[i][hb][2], st[i][hb][3]);
    }
  }
}

template <int N>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  if (p.cb == nullptr || p.n_sub <= 0) return cudaErrorInvalidValue;
  constexpr size_t cb_smem = sizeof(bf16) * 2 * LC * (N + 8);
  constexpr size_t smem = chunk_smem_bytes<N>();
  static size_t cb_done[mma::MAX_DEVICES] = {};
  static size_t done[mma::MAX_DEVICES] = {};
  cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(ssd_cb_kernel<N>), cb_smem, cb_done);
  if (err != cudaSuccess) return err;
  err = mma::opt_in_smem(reinterpret_cast<const void*>(ssd_chunk_kernel<N>),
                         smem, done);
  if (err != cudaSuccess) return err;
  ssd_cb_kernel<N><<<dim3(p.n_sub, p.B), TC_THREADS, cb_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<N><<<dim3(p.P / PT, p.H, p.B), TC_THREADS, smem,
                        stream>>>(p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<N>(p, stream);
  if (dtype == 1) return launch_bf16<N>(p, stream);
  return cudaErrorInvalidValue;
}

int n_subs(int S) { return (S + LC - 1) / LC; }

}  // namespace

// Floats of the C.B^T scratch that repro_ssd_scan needs: B * n_sub * 64 *
// 64 in bfloat16 (dtype 1), none in float32 (dtype 0).
extern "C" long long repro_ssd_scan_scratch_floats(int B, int S, int dtype) {
  if (dtype != 1 || B <= 0 || S <= 0) return 0;
  return (long long)B * n_subs(S) * LC * LC;
}

// dtype: 0 = float32 (one launch), 1 = bfloat16 (x, B, C and y: the C.B^T
// pre-pass writes `cb`, then the scan, both on `stream`; `cb` holds
// repro_ssd_scan_scratch_floats floats).  `states`, null when serving,
// receives the state entering each 64-row sub-chunk, (B, n_sub, H, P, N)
// float32, for ssd_backward.cu.  Returns the cudaError_t of the
// first launch that failed, else cudaSuccess.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* state, void* cb, void* states,
                              long long x_sb,
                              long long x_ss, long long b_sb, long long b_ss,
                              long long c_sb, long long c_ss, int B, int S,
                              int H, int P, int N, int dtype, void* stream) {
  if (P % PT) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           Bm, Cm, y, static_cast<float*>(state), x_sb, x_ss, b_sb, b_ss,
           c_sb, c_ss, B, S, H, P, static_cast<float*>(cb), n_subs(S),
           static_cast<float*>(states)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 16: err = launch<16>(p, dtype, s); break;
    case 32: err = launch<32>(p, dtype, s); break;
    case 64: err = launch<64>(p, dtype, s); break;
    case 128: err = launch<128>(p, dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
