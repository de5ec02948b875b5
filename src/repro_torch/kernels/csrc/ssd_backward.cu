// Backward of the Mamba2 SSD chunked scan (csrc/ssd_scan.cu) for Hopper
// (sm_90a), plain CUDA C++.
//
// The JAX package has no kernel for this: it differentiates the chunked
// scan L.ssd_chunked with XLA (repro/models/model.py:355), the function
// the Pallas kernel repro/kernels/ssd/kernel.py::ssd_scan computes.  This
// is the vector-Jacobian product of the forward kernel's function,
//   state_t = exp(dt_t * A_h) * state_{t-1} + dt_t * x_t (outer) B_t
//   y_t     = state_t . C_t,
// from a zero state, at the cotangents dy (B, S, H, P) of y and dstate
// (B, H, P, N) of the final state (null: zero).  It returns dx
// (B, S, H, P) in x's dtype, ddt (B, S, H) and dA (H,) in float32, and
// dB, dC (B, S, N) in the model dtype, all dense.  x, B and C are read
// through their batch and sequence strides, as the forward reads them.
//
// The forward, called with its `states` pointer, writes the state
// entering each of its 64-row sub-chunks, (B, n_sub, H, P, N) float32;
// the backward reads them.  Per (b, h) and sub-chunk of L = 64 rows,
// with a = dt * A, cum its inclusive prefix sum inside the sub-chunk,
// E_ij = exp(cum_i - cum_j) for j <= i (0 above the diagonal) and
// w_j = exp(cum_L - cum_j) * dt_j, S_in the state entering the sub-chunk
// and dS_out the gradient of the state leaving it:
//   dS_in = exp(cum_L) dS_out + sum_i exp(cum_i) dy_i (outer) C_i
//   dx_j  = sum_{i>=j} (C_i . B_j) E_ij dt_j dy_i + w_j (dS_out B_j)
//   D_ij  = dy_i . x_j,  W_ij = D_ij E_ij dt_j
//   dC_i  = sum_h [ sum_{j<=i} W_ij B_j + exp(cum_i) S_in^T dy_i ]
//   dB_j  = sum_h [ sum_{i>=j} W_ij C_i + w_j dS_out^T x_j ]
//   G_ij  = (C_i . B_j) D_ij E_ij,  u_i = C_i . S_in^T dy_i,
//   v_j   = B_j . dS_out^T x_j
//   dcum_k = sum_j G_kj dt_j - dt_k sum_i G_ik + exp(cum_k) u_k
//            - w_k v_k  [+ exp(cum_L) <dS_out, S_in> + sum_j w_j v_j
//            at k = L]
//   da_t  = sum_{k>=t} dcum_k
//   ddt_t = sum_i G_it + exp(cum_L - cum_t) v_t + A_h da_t
//   dA_h  = sum_{b, t} dt_t da_t.
// exp is evaluated only where its argument is <= 0.  Rows past S read as
// zero, which adds nothing.
//
// Three launches, one C call, one stream, no atomics; every sum runs in
// a fixed order, so a call repeats bit for bit and a batch row's
// results do not depend on the other rows:
//   1. the walk: the state gradient from the last sub-chunk to the first,
//      writing dS_out of each to scratch (B, n_sub, H, P, N);
//   2. the sub-chunks: dx, ddt, the terms of dB and dC summed over a
//      block's heads (scratch (B, S, groups, N)) and each head's term of
//      dA (scratch (B, n_sub, H));
//   3. the sums: dB and dC over the groups in group order, one block a
//      (b, s) row, and dA over (b, sub) in that order, one more block.
//
// What bounds it on the H100.  At mamba2-2.7b's training shape (B=4,
// S=1,024, H=80, P=64, N=128, bf16, x, B and C slices of one tensor) the
// function must move 132.6 MB (x, dy, dx 41.9 MB each, B, C, dB, dC, dt,
// ddt) and do 29.7 GFLOP: bytes bound it, at 0.0396 ms.  The design adds
// traffic of its own: the forward's states (167.8 MB read), the walk's
// dS (167.8 MB written, then read) and the partial sums of dB and dC.
// The first body, every product on the float32 CUDA cores with per-head
// partials (167.8 MB each for dB and dC, written and read), took 4.7440 ms
// device on one H100 80GB HBM3 at 700 W (walk 0.92, sub-chunks
// 3.70, sums 0.12): one 127 KB block an SM, scalar loads, products from
// shared memory, C.B^T recomputed by each of the 80 heads.
//
// bfloat16 design (the training path):
//   * Tensor cores for every product (mma.sync m16n8k16, bf16 in,
//     float32 out, operands by ldmatrix).  x, dy, B and C go in as they
//     are (their products are exact in float32); each float32 operand
//     (C.B^T o E, W summed over heads, S_in, dS_out, exp(cum) dy) goes in
//     as three bf16 parts (mma_bf16.cuh split_bf16x2), three products
//     each, so the backward keeps the float32 body's precision, as the
//     forward does (ssd_scan.cu).
//   * The walk, grid (H, B), eight warps: warp w carries state-gradient
//     rows 16 (w % 4) .. + 15, columns of half w / 4 of N, in float32
//     registers across the walk, as the forward carries its state; per
//     sub-chunk dS = exp(cum_L) dS + (exp(cum) o dy)^T C.  The next
//     sub-chunk's C rows, dy tile and dt are in flight (cp.async) while
//     this one computes: they do not depend on the carry.
//   * The sub-chunks, grid (n_sub, ceil(H / GROUP), B), sixteen warps: a
//     block takes GROUP heads in head order.  B, C and C.B^T (K = N on the
//     tensor cores) once per block.  Per head the states enter in tiles of
//     PT head-dim rows, each (S_in and dS_out, contiguous) by one bulk copy
//     (TMA) that lands on its stage's mbarrier; the next tile, and at a
//     head's first tile the next head's x, dy and dt (cp.async), are in
//     flight while this one computes.  Each float32 tile is split into
//     bf16 parts once, in shared memory, for all warps.  dB and dC are
//     summed over the group's heads in the warps' float32 registers: the
//     heads' state terms exp(cum) o (dy S_in) and w o (x dS_out) head by
//     head, and the intra-chunk terms as one product of B and C with W
//     summed over the heads, after the last head (B and C are shared by
//     every head).  A block writes one partial per group: 21.0 MB each
//     for dB and dC at GROUP = 8 where the first body wrote 167.8 MB.
//     GROUP is a constant, never a function of B, so a row alone equals
//     the batch.  One 227,696-byte block an SM at N = 128, 128 registers
//     a thread.  What bounds it is latency more than the tensor cores:
//     every tile passes two barriers, so sixteen warps share the
//     products, dx's sums are split between warp pairs, and a head's scan
//     over its rows (dcum, da) runs on one warp while the others compute
//     the next tile.
//   * The design's own traffic at that shape: 761.7 MB in all (the
//     function's 132.6, states 167.8, dS 2 x 167.8, partials 4 x 21.0,
//     and the walk's second read of dy), 0.2274 ms at 3.35 TB/s; its
//     tensor-core work, three parts counted, 148 GFLOP.
//
// float32 keeps the first body: the walk, grid (P / 16, H, B), and the
// sub-chunks, grid (n_sub, H, B), on the CUDA cores out of shared memory,
// with per-head partials (groups = H); errors about 1e-6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int LC = 64;        // sequence rows per sub-chunk (the forward's)
constexpr int PT = 16;        // state rows per walk block; P tile of pass 2
constexpr int THREADS = 256;  // float32 passes: a 16 x 16 thread grid
constexpr int SUM_THREADS = 128;
// the bf16 body
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int PARTS = 3;      // bf16 parts of a float32 operand
constexpr int GROUP = 8;      // heads a sub-chunk block takes, in order
constexpr int P_MAX = 64;     // the largest head dim of the bf16 body
constexpr int LDX = P_MAX + 8;  // x and dy rows (bf16)
constexpr int LDL = LC + 8;     // rows of C.B^T o E, and of W (bf16 parts)

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* dy;        // (B, S, H, P) dense, x's dtype
  const float* dstate;   // (B, H, P, N) or null
  const float* states;   // (B, n_sub, H, P, N): the forward's
  float* dS;             // (B, n_sub, H, P, N) scratch
  float* dBp;            // (B, S, groups, N) scratch
  float* dCp;            // (B, S, groups, N) scratch
  float* dAp;            // (B, n_sub, H) scratch
  void* dx;              // (B, S, H, P) x's dtype
  float* ddt;            // (B, S, H)
  float* dA;             // (H,)
  void* dB;              // (B, S, N) B's dtype
  void* dC;              // (B, S, N)
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
  int B, S, H, P, N, n_sub;
  int groups;  // partials of dB and dC a row: H (float32), ceil(H / GROUP)
};

// dt of a sub-chunk's rows and the inclusive prefix sum of a = dt * A,
// by warp 0 (two rows a lane, a shuffle scan over the lanes), as the
// forward computes them.
__device__ __forceinline__ void scan_rows(const Params& p, int b, int h,
                                          int s0, int rows, float A,
                                          float* dts, float* cum) {
  const int lane = threadIdx.x;
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
  dts[j0] = d0;
  dts[j1] = d1;
  cum[j0] = incl - pair + a0;
  cum[j1] = incl;
}

// Rows s0 .. s0 + LC - 1 of B or C (N wide, through the strides) into
// shared rows of `ld` floats; rows past `rows` are zero.
template <int N>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long sb, long long ss, int b,
                                          int s0, int rows) {
  for (int i = threadIdx.x; i < LC * N; i += THREADS) {
    const int r = i / N, n = i % N;
    dst[r * ld + n] =
        r < rows ? src[b * sb + (long long)(s0 + r) * ss + n] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// 1. The walk: dS_out of every sub-chunk, last to first
// ---------------------------------------------------------------------------

template <int N>
constexpr size_t walk_smem_bytes() {
  // C rows (padded), dy tile scaled by exp(cum), the carried rows, dt, cum
  return sizeof(float) * (LC * (N + 1) + LC * PT + PT * (N + 1) + 2 * LC);
}

template <int N>
__global__ void __launch_bounds__(THREADS) ssd_dstate_kernel(Params p) {
  static_assert(THREADS % N == 0 && PT * N % THREADS == 0, "state tiling");
  constexpr int NS = N + 1;
  constexpr int EPT = PT * N / THREADS;  // state entries per thread
  extern __shared__ float smem[];
  float* Cs = smem;            // LC x NS
  float* Ys = Cs + LC * NS;    // LC x PT: exp(cum_i) dy_i
  float* St = Ys + LC * PT;    // PT x NS: the carried gradient rows
  float* dts = St + PT * NS;   // LC
  float* cum = dts + LC;       // LC

  const float* __restrict__ cg = static_cast<const float*>(p.Cm);
  const float* __restrict__ yg = static_cast<const float*>(p.dy);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const float A = p.A[h];

  for (int i = tid; i < PT * N; i += THREADS) {
    const int c = i / N, n = i % N;
    St[c * NS + n] = p.dstate
        ? p.dstate[(((size_t)b * p.H + h) * p.P + p0 + c) * N + n]
        : 0.f;
  }
  for (int sub = p.n_sub - 1; sub >= 0; --sub) {
    const int s0 = sub * LC;
    const int rows = min(LC, p.S - s0);
    __syncthreads();  // the last update of St is done
    for (int i = tid; i < PT * N; i += THREADS) {
      const int c = i / N, n = i % N;
      p.dS[((((size_t)b * p.n_sub + sub) * p.H + h) * p.P + p0 + c) * N +
           n] = St[c * NS + n];
    }
    if (tid < 32) scan_rows(p, b, h, s0, rows, A, dts, cum);
    load_rows<N>(Cs, NS, cg, p.c_sb, p.c_ss, b, s0, rows);
    __syncthreads();
    for (int i = tid; i < LC * PT; i += THREADS) {
      const int r = i / PT, c = i % PT;
      Ys[i] = r < rows
          ? yg[(((size_t)b * p.S + s0 + r) * p.H + h) * p.P + p0 + c] *
                expf(cum[r])
          : 0.f;
    }
    __syncthreads();
    const int n = tid % N;
    const float dec = expf(cum[LC - 1]);
    float acc[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[e] = 0.f;
    for (int i = 0; i < LC; ++i) {
      const float cv = Cs[i * NS + n];
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        acc[e] += Ys[i * PT + tid / N + e * (THREADS / N)] * cv;
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      float& s = St[(tid / N + e * (THREADS / N)) * NS + n];
      s = s * dec + acc[e];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. The sub-chunks: dx, ddt, and each head's terms of dB, dC and dA
// ---------------------------------------------------------------------------

template <int N>
constexpr size_t chunk_smem_bytes() {
  // B and C rows; C.B^T E and D (then G and W); x and dy tiles; S_in and
  // dS_out tiles; dt, cum, exp(cum), exp(cum_L - cum), w, u, v, dcum and
  // the column / row sums (9 LC); the warps' partial sums
  return sizeof(float) * (2 * LC * (N + 1) + 2 * LC * (LC + 1) + 2 * LC * PT +
                          2 * PT * (N + 1) + 9 * LC + THREADS / 32);
}

template <int N>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_chunk_kernel(Params p) {
  constexpr int NS = N + 1;
  constexpr int MS = LC + 1;
  constexpr int NC = N / 16;  // a thread's columns of an L x N tile
  extern __shared__ float smem[];
  float* Bs = smem;              // LC x NS
  float* Cs = Bs + LC * NS;      // LC x NS
  float* Es = Cs + LC * NS;      // LC x MS: (C.B^T) o E, then G
  float* Ws = Es + LC * MS;      // LC x MS: W
  float* Xt = Ws + LC * MS;      // LC x PT
  float* Yt = Xt + LC * PT;      // LC x PT
  float* Si = Yt + LC * PT;      // PT x NS: S_in rows
  float* Sd = Si + PT * NS;      // PT x NS: dS_out rows
  float* dts = Sd + PT * NS;     // LC
  float* cum = dts + LC;
  float* ecum = cum + LC;        // exp(cum_i)
  float* el = ecum + LC;         // exp(cum_L - cum_j)
  float* wv = el + LC;           // w_j
  float* uu = wv + LC;           // u_i
  float* vv = uu + LC;           // v_j
  float* dcum = vv + LC;
  float* colG = dcum + LC;       // sum_i G_ik
  float* red = colG + LC;        // THREADS / 32

  const float* __restrict__ xg = static_cast<const float*>(p.x);
  const float* __restrict__ yg = static_cast<const float*>(p.dy);
  float* __restrict__ dxg = static_cast<float*>(p.dx);
  const int tid = threadIdx.x;
  const int sub = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = sub * LC;
  const int rows = min(LC, p.S - s0);
  const float A = p.A[h];
  const int ti = tid / 16, tj = tid % 16;  // rows ti + 16a, columns tj + 16c
  const size_t st_base =
      (((size_t)b * p.n_sub + sub) * p.H + h) * (size_t)p.P * N;

  if (tid < 32) {
    scan_rows(p, b, h, s0, rows, A, dts, cum);
    __syncwarp();
    const float last = cum[LC - 1];
    for (int j = tid; j < LC; j += 32) {
      ecum[j] = expf(cum[j]);
      el[j] = expf(last - cum[j]);
      wv[j] = el[j] * dts[j];
    }
  }
  load_rows<N>(Bs, NS, static_cast<const float*>(p.Bm), p.b_sb, p.b_ss, b, s0,
                  rows);
  load_rows<N>(Cs, NS, static_cast<const float*>(p.Cm), p.c_sb, p.c_ss, b, s0,
                  rows);
  __syncthreads();

  // (C.B^T) o E in the blocks at or below the diagonal (a thread's 4 x 4
  // tile: rows ti + 16a, columns tj + 16c, c <= a); 0 elsewhere
  {
    float acc[4][4] = {};
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
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ti + 16 * a, j = tj + 16 * c;
        Es[i * MS + j] =
            (c <= a && j <= i) ? acc[a][c] * expf(cum[i] - cum[j]) : 0.f;
      }
  }

  // over the head dim in tiles of PT: D = dy x^T, q = dy S_in, r = x dS_out
  // and <dS_out, S_in> accumulate in registers; dx is written tile by tile
  float dacc[4][4] = {};
  float q[4][NC] = {}, r[4][NC] = {};
  float sdot = 0.f;
  for (int pt = 0; pt < p.P; pt += PT) {
    __syncthreads();  // the last tile's readers are done; Es is written
    for (int i = tid; i < LC * PT; i += THREADS) {
      const int row = i / PT, c = i % PT;
      const bool ok = row < rows;
      const long long s = s0 + row;
      Xt[i] = ok ? xg[b * p.x_sb + s * p.x_ss + (long long)h * p.P + pt + c]
                 : 0.f;
      Yt[i] = ok ? yg[(((size_t)b * p.S + s) * p.H + h) * p.P + pt + c]
                 : 0.f;
    }
    for (int i = tid; i < PT * N; i += THREADS) {
      const int c = i / N, n = i % N;
      const size_t off = st_base + (size_t)(pt + c) * N + n;
      Si[c * NS + n] = p.states[off];
      Sd[c * NS + n] = p.dS[off];
    }
    __syncthreads();
    for (int c = 0; c < PT; ++c) {
      float ya[4], xa[4], xb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ya[a] = Yt[(ti + 16 * a) * PT + c];
        xa[a] = Xt[(ti + 16 * a) * PT + c];
        xb[a] = Xt[(tj + 16 * a) * PT + c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k <= a; ++k) dacc[a][k] += ya[a] * xb[k];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const float si = Si[c * NS + tj + 16 * k];
        const float sd = Sd[c * NS + tj + 16 * k];
        if (c == ti) sdot += si * sd;  // each (p, n) once: p by ti, n by tj
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          q[a][k] += ya[a] * si;
          r[a][k] += xa[a] * sd;
        }
      }
    }
    // dx_j[pt + c] = sum_{i>=j} (C.B^T o E)_ij dt_j dy_i + w_j (dS_out B_j)
    {
      const int c = tid % PT;
#pragma unroll
      for (int k = 0; k < LC * PT / THREADS; ++k) {
        const int j = tid / PT + k * (THREADS / PT);
        float intra = 0.f, inter = 0.f;
        for (int i = j; i < LC; ++i) intra += Es[i * MS + j] * Yt[i * PT + c];
        for (int n = 0; n < N; ++n) inter += Bs[j * NS + n] * Sd[c * NS + n];
        if (j < rows)
          dxg[(((size_t)b * p.S + s0 + j) * p.H + h) * p.P + pt + c] =
              intra * dts[j] + wv[j] * inter;
      }
    }
  }
  __syncthreads();  // every reader of Es is done

  // G = (C.B^T o E) o D and W = D o E o dt_j, in the thread's own tile
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ti + 16 * a, j = tj + 16 * c;
      const bool on = c <= a && j <= i;
      const float d = on ? dacc[a][c] : 0.f;
      Es[i * MS + j] *= d;
      Ws[i * MS + j] = on ? d * expf(cum[i] - cum[j]) * dts[j] : 0.f;
    }
  // u_i = C_i . q_i and v_j = B_j . r_j: the 16 lanes of a row's half
  // warp, in a fixed order
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ti + 16 * a;
    float u = 0.f, v = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      u += q[a][k] * Cs[i * NS + tj + 16 * k];
      v += r[a][k] * Bs[i * NS + tj + 16 * k];
    }
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      u += __shfl_xor_sync(0xffffffffu, u, off);
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    if (tj == 0) {
      uu[i] = u;
      vv[i] = v;
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1)
    sdot += __shfl_xor_sync(0xffffffffu, sdot, off);
  if (tid % 32 == 0) red[tid / 32] = sdot;
  __syncthreads();

  // this head's terms of dC and dB, in the layout of q and r
  {
    float* dCp = p.dCp;
    float* dBp = p.dBp;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + 16 * a;
      float cacc[NC], bacc[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        cacc[k] = ecum[i] * q[a][k];
        bacc[k] = wv[i] * r[a][k];
      }
      for (int j = 0; j <= i; ++j) {  // dC_i: W_ij B_j
        const float wij = Ws[i * MS + j];
#pragma unroll
        for (int k = 0; k < NC; ++k) cacc[k] += wij * Bs[j * NS + tj + 16 * k];
      }
      for (int m = i; m < LC; ++m) {  // dB_i: W_mi C_m
        const float wmi = Ws[m * MS + i];
#pragma unroll
        for (int k = 0; k < NC; ++k) bacc[k] += wmi * Cs[m * NS + tj + 16 * k];
      }
      if (i < rows) {
        const size_t o = (((size_t)b * p.S + s0 + i) * p.H + h) * N + tj;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          dCp[o + 16 * k] = cacc[k];
          dBp[o + 16 * k] = bacc[k];
        }
      }
    }
  }

  // dcum, then da (a suffix sum), ddt and this block's term of dA
  if (tid < LC) {
    const int k = tid;
    float row = 0.f, col = 0.f;
    for (int j = 0; j <= k; ++j) row += Es[k * MS + j] * dts[j];
    for (int i = k; i < LC; ++i) col += Es[i * MS + k];
    colG[k] = col;
    dcum[k] = row - dts[k] * col + ecum[k] * uu[k] - wv[k] * vv[k];
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
    float wvsum = 0.f;
    for (int j = 0; j < LC; ++j) wvsum += wv[j] * vv[j];
    dcum[LC - 1] += ecum[LC - 1] * s + wvsum;
    float da = 0.f, dA = 0.f;
    for (int t = LC - 1; t >= 0; --t) {
      da += dcum[t];
      dcum[t] = da;  // now da_t
      dA += dts[t] * da;
    }
    p.dAp[((size_t)b * p.n_sub + sub) * p.H + h] = dA;
  }
  __syncthreads();
  if (tid < rows)
    p.ddt[((size_t)b * p.S + s0 + tid) * p.H + h] =
        colG[tid] + el[tid] * vv[tid] + A * dcum[tid];
}

// ---------------------------------------------------------------------------
// 3. The sums over groups (dB, dC) and over (b, sub) (dA), in index order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(SUM_THREADS) ssd_bwd_sum_kernel(Params p) {
  const int row = blockIdx.x;  // b * S + s, or B * S for dA
  if (row == p.B * p.S) {
    for (int h = threadIdx.x; h < p.H; h += SUM_THREADS) {
      float s = 0.f;
      for (int k = 0; k < p.B * p.n_sub; ++k) s += p.dAp[(size_t)k * p.H + h];
      p.dA[h] = s;
    }
    return;
  }
  T* dB = static_cast<T*>(p.dB);
  T* dC = static_cast<T*>(p.dC);
  for (int n = threadIdx.x; n < p.N; n += SUM_THREADS) {
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < p.groups; ++k) {
      const size_t o = ((size_t)row * p.groups + k) * p.N + n;
      sb += p.dBp[o];
      sc += p.dCp[o];
    }
    dB[(size_t)row * p.N + n] = from_f<T>(sb);
    dC[(size_t)row * p.N + n] = from_f<T>(sc);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the walk and the sub-chunks on the tensor cores
// ---------------------------------------------------------------------------

// Stage rows 0 .. LC - 1 of a bf16 tile `width` wide (a multiple of 8)
// from `src` with `stride` elements between rows into shared rows of `ld`
// elements, by cp.async; rows past `rows` are zero.
template <int THREADS_>
__device__ __forceinline__ void stage_tile(bf16* dst, int ld, const bf16* src,
                                           long long stride, int width,
                                           int rows) {
  const int ch = width / 8;
  for (int i = threadIdx.x; i < LC * ch; i += THREADS_) {
    const int r = i / ch, c = i - r * ch;
    const bool ok = r < rows;
    mma::cp_async16(dst + r * ld + c * 8, ok ? src + r * stride + c * 8 : src,
                    ok);
  }
}

// dt of a sub-chunk's rows (stride H floats), zero past `rows`.
template <int THREADS_>
__device__ __forceinline__ void stage_dt(float* dst, const float* src, int H,
                                         int rows) {
  for (int i = threadIdx.x; i < LC; i += THREADS_)
    mma::cp_async4(dst + i, i < rows ? src + (size_t)i * H : src, i < rows);
}

// One warp: the inclusive prefix sum of a = dt * A over a sub-chunk's
// staged dt (two rows a lane, a shuffle scan over the lanes, as the
// forward), into the warp's own vectors: dt, cum, exp(cum),
// exp(cum_L - cum) and w = exp(cum_L - cum) dt.  Returns exp(cum_L).
__device__ __forceinline__ float warp_scan(const float* dts, float A,
                                           float* vec) {
  const int lane = threadIdx.x & 31;
  const int j0 = 2 * lane, j1 = j0 + 1;
  const float d0 = dts[j0], d1 = dts[j1];
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
  float* dtv = vec;
  float* cum = vec + LC;
  float* ecum = vec + 2 * LC;
  float* el = vec + 3 * LC;
  float* wv = vec + 4 * LC;
  dtv[j0] = d0;
  dtv[j1] = d1;
  cum[j0] = c0;
  cum[j1] = c1;
  ecum[j0] = expf(c0);
  ecum[j1] = expf(c1);
  el[j0] = expf(last - c0);
  el[j1] = expf(last - c1);
  wv[j0] = el[j0] * d0;
  wv[j1] = el[j1] * d1;
  __syncwarp();
  return expf(last);
}
constexpr int VEC = 5 * LC;  // floats of a warp's vectors

// The A fragment (rows m, k = 16 ks + ...) of (s o T)^T for a bf16 tile T
// stored [k][m] (rows k, ld elements), each k row scaled by s[k], as
// three bf16 parts: a[q][part] (the forward's (w o x)^T).
__device__ __forceinline__ void scaled_t_parts(uint32_t (&a)[4][PARTS],
                                               const bf16* T, int ld, int m0,
                                               int ks, const float* s) {
  const int lane = threadIdx.x & 31;
  uint32_t f[4];
  mma::ldmatrix_x4_trans(
      f, T + (16 * ks + ((lane >> 4) << 3) + (lane & 7)) * ld + m0 +
             ((lane >> 3) & 1) * 8);
  const int k = 16 * ks + 2 * (lane & 3);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&f[q]));
    const int kq = k + 8 * (q >> 1);
    mma::split_bf16x2(v.x * s[kq], v.y * s[kq + 1], a[q]);
  }
}

// c[nb] += A . T[k rows 16 ks .., columns n0 + 8 nb ..] for a bf16 tile T
// stored [k][n] (B, C) or its three parts (S_in, dS_out), nb < NB; A as
// `parts` registers a[q][part] (parts = 1: a bf16 operand).
template <int NB, int NPARTS, int APARTS>
__device__ __forceinline__ void mma_rows_kn(float (&c)[NB][4],
                                            const uint32_t (&a)[4][APARTS],
                                            const bf16* T, int plane, int ld,
                                            int ks, int n0) {
  const int lane = threadIdx.x & 31;
  const int off = (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                  (lane >> 4) * 8;
#pragma unroll
  for (int nb2 = 0; nb2 < (NB + 1) / 2; ++nb2) {
#pragma unroll
    for (int k = NPARTS - 1; k >= 0; --k) {
      uint32_t f[4];
      mma::ldmatrix_x4_trans(f, T + k * plane + off + 16 * nb2);
#pragma unroll
      for (int ka = APARTS - 1; ka >= 0; --ka) {
        const uint32_t ak[4] = {a[0][ka], a[1][ka], a[2][ka], a[3][ka]};
        mma::mma_bf16(c[2 * nb2], ak, f[0], f[1]);
        if (2 * nb2 + 1 < NB) mma::mma_bf16(c[2 * nb2 + 1], ak, f[2], f[3]);
      }
    }
  }
}

// The A fragment of rows m0 .., k = 16 ks .. of a bf16 tile stored [m][k].
__device__ __forceinline__ void frag_a(uint32_t (&a)[4][1], const bf16* T,
                                       int ld, int m0, int ks) {
  const int lane = threadIdx.x & 31;
  uint32_t f[4];
  mma::ldmatrix_x4(f, T + (m0 + (lane & 15)) * ld + 16 * ks + (lane >> 4) * 8);
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q][0] = f[q];
}

// ---------------------------------------------------------------------------
// 1. The walk (bf16): dS_out of every sub-chunk, last to first
// ---------------------------------------------------------------------------

template <int N>
constexpr size_t walk_tc_smem_bytes() {
  // two stages of C rows, the dy tile and dt; each warp's vectors
  return 2 * (sizeof(bf16) * LC * ((N + 8) + LDX) + sizeof(float) * LC) +
         sizeof(float) * TC_WARPS * VEC;
}

template <int N>
__global__ void __launch_bounds__(TC_THREADS) ssd_dstate_tc_kernel(Params p) {
  constexpr int LDS = N + 8;
  constexpr int NB = N / 16;  // n8 blocks of a warp's half of N
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // 2 x LC x LDS
  bf16* Ys = Cs + 2 * LC * LDS;                   // 2 x LC x LDX
  float* dts = reinterpret_cast<float*>(Ys + 2 * LC * LDX);  // 2 x LC
  float* vec = dts + 2 * LC + (threadIdx.x / 32) * VEC;      // this warp's

  const bf16* __restrict__ cg = static_cast<const bf16*>(p.Cm);
  const bf16* __restrict__ yg = static_cast<const bf16*>(p.dy);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rq = warp & 3, n0 = (warp >> 2) * (N / 2);
  const int h = blockIdx.x, b = blockIdx.y;
  const float A = p.A[h];
  const bool active = 16 * rq < p.P;  // this warp's state rows exist
  const int r0 = 16 * rq + g;          // its rows r0 and r0 + 8

  auto stage = [&](int sub) {
    const int s0 = sub * LC, rows = min(LC, p.S - s0), buf = sub & 1;
    stage_tile<TC_THREADS>(Cs + buf * LC * LDS, LDS,
                           cg + b * p.c_sb + s0 * p.c_ss, p.c_ss, N, rows);
    stage_tile<TC_THREADS>(Ys + buf * LC * LDX, LDX,
                           yg + (((size_t)b * p.S + s0) * p.H + h) * p.P,
                           (long long)p.H * p.P, p.P, rows);
    stage_dt<TC_THREADS>(dts + buf * LC,
                         p.dt + ((size_t)b * p.S + s0) * p.H + h, p.H, rows);
    mma::cp_async_commit();
  };

  // the carried gradient: rows r0, r0 + 8, columns n0 + 8 nb + 2t, + 1
  float st[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e >> 1), n = n0 + 8 * nb + 2 * t + (e & 1);
      st[nb][e] = p.dstate && active
          ? p.dstate[(((size_t)b * p.H + h) * p.P + row) * N + n]
          : 0.f;
    }
  stage(p.n_sub - 1);
  for (int sub = p.n_sub - 1; sub >= 0; --sub) {
    const int buf = sub & 1;
    mma::cp_async_wait<0>();
    __syncthreads();  // this sub-chunk's tiles are in; the others are free
    if (sub > 0) stage(sub - 1);
    if (active) {  // the gradient of the state leaving this sub-chunk
      float* d = p.dS + ((((size_t)b * p.n_sub + sub) * p.H + h) * p.P + r0) *
                            N + n0 + 2 * t;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        *reinterpret_cast<float2*>(d + 8 * nb) =
            make_float2(st[nb][0], st[nb][1]);
        *reinterpret_cast<float2*>(d + 8 * N + 8 * nb) =
            make_float2(st[nb][2], st[nb][3]);
      }
    }
    const float dec = warp_scan(dts + buf * LC, A, vec);
    if (active) {
      // dS_in = exp(cum_L) dS_out + (exp(cum) o dy)^T C
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nb][e] *= dec;
#pragma unroll
      for (int ks = 0; ks < LC / 16; ++ks) {
        uint32_t ya[4][PARTS];
        scaled_t_parts(ya, Ys + buf * LC * LDX, LDX, 16 * rq, ks,
                       vec + 2 * LC);
        mma_rows_kn<NB, 1, PARTS>(st, ya, Cs + buf * LC * LDS, 0, LDS, ks,
                                  n0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. The sub-chunks (bf16): a group of heads a block
// ---------------------------------------------------------------------------

// Sixteen warps a block (one block an SM: latency, not the tensor cores,
// bounds these products, and more warps hide more of it).  Warp
// w = rq + 4 qn owns rows 16 rq .. + 15 of every L-row output: quarter qn
// of N for dB, dC, q = dy S_in and r = x dS_out; the 16 x 16 block in
// column block qn of the L x L matrices (C.B^T, E, D = dy x^T, G, W) when
// qn <= rq ("D positions": the blocks at or below the diagonal); and of a
// P tile's dx the 8 columns hf = qn % 2, over half kh = qn / 2 of each
// sum (the intra-chunk blocks of one parity, one half of N).  The warp
// with kh = 1 hands its half over in shared memory; after the next
// barrier the one with kh = 0 adds it and stages the finished tile, and
// after the one after, warp STORER writes the tile in 16-byte pieces.
// Warp REDUCER turns a head's row and column sums into dcum, ddt and dA,
// from its copy of the head's vectors, while the others run the next
// tile's products.  Both have no intra-chunk dx terms, the lightest share.
constexpr int CH_WARPS = 16;
constexpr int CH_THREADS = 32 * CH_WARPS;
constexpr int REDUCER = 15;  // rq 3, kh 1
constexpr int STORER = 11;   // rq 3, kh 1

template <int N>
struct ChunkSmem {
  static constexpr int LDS = N + 8;
  static constexpr size_t Bs = 0;                                   // bf16
  static constexpr size_t Cs = Bs + sizeof(bf16) * LC * LDS;        // bf16
  static constexpr size_t Xs = Cs + sizeof(bf16) * LC * LDS;        // 2 x
  static constexpr size_t Ys = Xs + sizeof(bf16) * 2 * LC * LDX;    // 2 x
  static constexpr size_t Mp = Ys + sizeof(bf16) * 2 * LC * LDX;    // parts
  static constexpr size_t Sp = Mp + sizeof(bf16) * PARTS * LC * LDL;
  static constexpr size_t Dp = Sp + sizeof(bf16) * PARTS * PT * LDS;
  static constexpr size_t St = Dp + sizeof(bf16) * PARTS * PT * LDS;  // f32
  // C.B^T and E at each thread's D positions, 8 a thread
  static constexpr size_t CB = St + sizeof(float) * 2 * 2 * PT * N;
  static constexpr size_t E = CB + sizeof(float) * 8 * CH_THREADS;
  // the dx halves of the 8 warps with kh = 1; a finished dx tile
  static constexpr size_t dxp = E + sizeof(float) * 8 * CH_THREADS;
  static constexpr size_t dxs = dxp + sizeof(float) * 8 * 8 * 32;
  static constexpr size_t dt = dxs + sizeof(bf16) * LC * PT;
  static constexpr size_t vec = dt + sizeof(float) * 2 * LC;
  // row sums of G, column sums, u, v (4 partials each), the REDUCER's
  // copy of a head's vectors, the warps' <dS_out, S_in>, A of the heads
  static constexpr size_t red = vec + sizeof(float) * CH_WARPS * VEC;
  // the mbarriers the state tiles of the two stages land on
  static constexpr size_t bar =
      red + sizeof(float) * (16 * LC + VEC + CH_WARPS + GROUP);
  static constexpr size_t bytes = bar + sizeof(uint64_t) * 2;
};

template <int N>
__global__ void __launch_bounds__(CH_THREADS, 1)
    ssd_bwd_chunk_tc_kernel(Params p) {
  using SM = ChunkSmem<N>;
  constexpr int LDS = SM::LDS;
  constexpr int NQ = N >= 32 ? N / 32 : 1;  // n8 blocks of a quarter of N
  constexpr int KS = N / 16, KH = (KS + 1) / 2;  // k-steps over N, a half
  constexpr int SPLANE = PT * LDS, MPLANE = LC * LDL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw + SM::Bs);
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw + SM::Cs);
  bf16* Xs0 = reinterpret_cast<bf16*>(smem_raw + SM::Xs);
  bf16* Ys0 = reinterpret_cast<bf16*>(smem_raw + SM::Ys);
  bf16* Mp = reinterpret_cast<bf16*>(smem_raw + SM::Mp);
  bf16* Sp = reinterpret_cast<bf16*>(smem_raw + SM::Sp);
  bf16* Dp = reinterpret_cast<bf16*>(smem_raw + SM::Dp);
  float* St0 = reinterpret_cast<float*>(smem_raw + SM::St);
  float* CBr = reinterpret_cast<float*>(smem_raw + SM::CB) + threadIdx.x;
  float* Er = reinterpret_cast<float*>(smem_raw + SM::E) + threadIdx.x;
  float* dxp = reinterpret_cast<float*>(smem_raw + SM::dxp);
  bf16* dxs = reinterpret_cast<bf16*>(smem_raw + SM::dxs);  // LC x PT
  float* dts0 = reinterpret_cast<float*>(smem_raw + SM::dt);
  float* vec0 = reinterpret_cast<float*>(smem_raw + SM::vec);
  float* rowp = reinterpret_cast<float*>(smem_raw + SM::red);  // 4 x LC
  float* colp = rowp + 4 * LC;                                 // 4 x LC
  float* up = colp + 4 * LC;                                   // 4 x LC
  float* vp = up + 4 * LC;                                     // 4 x LC
  float* rvec = vp + 4 * LC;                                   // VEC
  float* red = rvec + VEC;                                     // CH_WARPS
  float* As = red + CH_WARPS;                                  // GROUP
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + SM::bar);

  const bf16* __restrict__ xg = static_cast<const bf16*>(p.x);
  const bf16* __restrict__ yg = static_cast<const bf16*>(p.dy);
  bf16* __restrict__ dxg = static_cast<bf16*>(p.dx);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rq = warp & 3, qn = warp >> 2, hf = qn & 1, kh = qn >> 1;
  const int n0 = qn * NQ * 8;
  const bool n_on = n0 < N;    // this warp's quarter of N exists
  const bool d_on = qn <= rq;  // this warp has D positions
  const int i0 = 16 * rq + g, i1 = i0 + 8;  // this thread's rows
  const int sub = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int s0 = sub * LC, rows = min(LC, p.S - s0);
  const int h0 = grp * GROUP, hn = min(GROUP, p.H - h0);
  const int npt = p.P / PT, units = hn * npt;
  float* vec = vec0 + warp * VEC;
  const float* dtv = vec;
  const float* cum = vec + LC;
  const float* ecum = vec + 2 * LC;
  const float* el = vec + 3 * LC;
  const float* wv = vec + 4 * LC;

  auto stage_head = [&](int hi) {  // x, dy and dt of the group's head hi
    const int h = h0 + hi, hb = hi & 1;
    stage_tile<CH_THREADS>(Xs0 + hb * LC * LDX, LDX,
                           xg + b * p.x_sb + s0 * p.x_ss + (long long)h * p.P,
                           p.x_ss, p.P, rows);
    stage_tile<CH_THREADS>(Ys0 + hb * LC * LDX, LDX,
                           yg + (((size_t)b * p.S + s0) * p.H + h) * p.P,
                           (long long)p.H * p.P, p.P, rows);
    stage_dt<CH_THREADS>(dts0 + hb * LC,
                         p.dt + ((size_t)b * p.S + s0) * p.H + h, p.H, rows);
  };
  // S_in and dS_out rows of P tile u (contiguous, 8 KB each at N = 128),
  // by one thread, as two bulk copies that land on stage u % 2's mbarrier
  auto stage_unit = [&](int u) {
    const int hi = u / npt, pt = u - hi * npt;
    const size_t off =
        (((size_t)b * p.n_sub + sub) * p.H + h0 + hi) * (size_t)p.P * N +
        (size_t)pt * PT * N;
    float* dst = St0 + (u & 1) * 2 * PT * N;
    uint64_t* bar = bars + (u & 1);
    hopper::mbar_expect_tx(bar, 2 * PT * N * sizeof(float));
    hopper::bulk_load(dst, p.states + off, PT * N * sizeof(float), bar);
    hopper::bulk_load(dst + PT * N, p.dS + off, PT * N * sizeof(float), bar);
  };

  // dx of a tile: this warp's half of the intra-chunk sum (di) and of the
  // state term (de); kh = 0 keeps its halves until the next barrier
  float di[4], de[4];
  auto finish_dx = [&]() {  // kh = 0: add the other half, stage the tile
    const float* o = dxp + (warp & 7) * 8 * 32 + lane;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int j = hr ? i1 : i0;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * hr + e;
        v[e] = dtv[j] * (di[k] + o[k * 32]) + wv[j] * (de[k] + o[(4 + k) * 32]);
      }
      *reinterpret_cast<uint32_t*>(dxs + j * PT + 8 * hf + 2 * t) =
          mma::pack_bf16x2(v[0], v[1]);
    }
  };
  auto store_dx = [&](int u) {  // STORER: unit u's staged tile
    const int hi = u / npt, pt = u - hi * npt, h = h0 + hi;
#pragma unroll
    for (int k = 0; k < 2 * LC / 32; ++k) {
      const int j = (lane + 32 * k) >> 1, half = lane & 1;
      if (j < rows)
        *reinterpret_cast<uint4*>(dxg + (((size_t)b * p.S + s0 + j) * p.H +
                                         h) * p.P + PT * pt + 8 * half) =
            *reinterpret_cast<const uint4*>(dxs + j * PT + 8 * half);
    }
  };
  // the REDUCER: a head's dcum, then da (a suffix sum), ddt and its term
  // of dA, from the warps' partial sums and its copy of the head's vectors
  auto reduce = [&](int h) {
    const float* dtv = rvec;
    const float* ecum = rvec + 2 * LC;
    const float* el = rvec + 3 * LC;
    const float* wv = rvec + 4 * LC;
    float dc[2], dd[2];
    float wvs = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 2 * lane + e;
      const float row =
          ((rowp[k] + rowp[LC + k]) + rowp[2 * LC + k]) + rowp[3 * LC + k];
      const float col =
          ((colp[k] + colp[LC + k]) + colp[2 * LC + k]) + colp[3 * LC + k];
      const float uk = ((up[k] + up[LC + k]) + up[2 * LC + k]) + up[3 * LC + k];
      const float vk = ((vp[k] + vp[LC + k]) + vp[2 * LC + k]) + vp[3 * LC + k];
      dc[e] = row - dtv[k] * col + ecum[k] * uk - wv[k] * vk;
      wvs += wv[k] * vk;
      dd[e] = col + el[k] * vk;  // ddt but its A da term
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      wvs += __shfl_xor_sync(0xffffffffu, wvs, off);
    if (lane == 31) {
      float s = 0.f;
      for (int w = 0; w < CH_WARPS; ++w) s += red[w];
      dc[1] += ecum[LC - 1] * s + wvs;
    }
    // da_t = sum_{k >= t} dcum_k: a suffix scan over the lanes
    const float pair = dc[0] + dc[1];
    float incl = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += v;
    }
    const float da1 = incl - pair + dc[1], da0 = incl;
    const float Ah = As[h - h0];
    float dAt = dtv[2 * lane] * da0 + dtv[2 * lane + 1] * da1;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      dAt += __shfl_xor_sync(0xffffffffu, dAt, off);
    if (lane == 0) p.dAp[((size_t)b * p.n_sub + sub) * p.H + h] = dAt;
    const int k0 = 2 * lane;
    if (k0 < rows)
      p.ddt[((size_t)b * p.S + s0 + k0) * p.H + h] = dd[0] + Ah * da0;
    if (k0 + 1 < rows)
      p.ddt[((size_t)b * p.S + s0 + k0 + 1) * p.H + h] = dd[1] + Ah * da1;
  };

  stage_tile<CH_THREADS>(Bs, LDS, static_cast<const bf16*>(p.Bm) +
                                      b * p.b_sb + s0 * p.b_ss,
                         p.b_ss, N, rows);
  stage_tile<CH_THREADS>(Cs, LDS, static_cast<const bf16*>(p.Cm) +
                                      b * p.c_sb + s0 * p.c_ss,
                         p.c_ss, N, rows);
  stage_head(0);
  if (tid < hn) mma::cp_async4(As + tid, p.A + h0 + tid, true);
  mma::cp_async_commit();
  if (tid == 0) {
    hopper::mbar_init(bars, 1);
    hopper::mbar_init(bars + 1, 1);
    hopper::fence_barrier_init();
    stage_unit(0);
  }

  // sums over the group's heads: dC and dB (rows i0, i1, columns
  // n0 + 8 nb + 2t, + 1) and W (D positions)
  float dCg[NQ][4] = {}, dBg[NQ][4] = {};
  float wsum[2][4] = {};
  // this head's q = dy S_in and r = x dS_out, and its part of <dS_out, S_in>
  float q[NQ][4], r[NQ][4];
  float sdot = 0.f;

  for (int u = 0; u < units; ++u) {
    const int hi = u / npt, pt = u - hi * npt, h = h0 + hi, hb = hi & 1;
    const bf16* Xs = Xs0 + hb * LC * LDX;
    const bf16* Ys = Ys0 + hb * LC * LDX;
    mma::cp_async_wait<0>();
    __syncthreads();  // unit u's tiles are in; unit u - 1 is done
    if (u + 1 < units) {
      if (tid == 0) stage_unit(u + 1);
      if (pt == 0 && hi + 1 < hn) stage_head(hi + 1);
    }
    mma::cp_async_commit();
    if (u > 0 && kh == 0) finish_dx();  // the last unit's

    if (u == 0 && d_on) {  // C.B^T at the D positions, once per block
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t ca[4][1], bf[4];
        frag_a(ca, Cs, LDS, 16 * rq, ks);
        mma::ldmatrix_x4(bf, Bs + (16 * qn + (lane & 7) + ((lane >> 4) << 3)) *
                                      LDS + 16 * ks + ((lane >> 3) & 1) * 8);
        const uint32_t a4[4] = {ca[0][0], ca[1][0], ca[2][0], ca[3][0]};
        mma::mma_bf16(acc[0], a4, bf[0], bf[1]);
        mma::mma_bf16(acc[1], a4, bf[2], bf[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) CBr[(nb * 4 + e) * CH_THREADS] = acc[nb][e];
    }
    if (pt == 0) {  // a new head: its vectors; E and C.B^T o E in parts
      warp_scan(dts0 + hb * LC, As[hi], vec);
      if (d_on) {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const int j = 16 * qn + 8 * nb + 2 * t;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {  // rows i0, i1
            const int i = hr ? i1 : i0;
            float m[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int slot = (nb * 4 + 2 * hr + e) * CH_THREADS;
              const float ex = j + e <= i ? expf(cum[i] - cum[j + e]) : 0.f;
              Er[slot] = ex;
              m[e] = CBr[slot] * ex;
            }
            uint32_t part[PARTS];
            mma::split_bf16x2(m[0], m[1], part);
#pragma unroll
            for (int k = 0; k < PARTS; ++k)
              *reinterpret_cast<uint32_t*>(Mp + k * MPLANE + i * LDL + j) =
                  part[k];
          }
        }
      }
#pragma unroll
      for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) q[nb][e] = r[nb][e] = 0.f;
      sdot = 0.f;
    }
    hopper::mbar_wait(bars + (u & 1), (u >> 1) & 1);  // the tiles are in
    {  // this unit's S_in and dS_out rows into bf16 parts
      const float* Si = St0 + (u & 1) * 2 * PT * N;
      const float* Sd = Si + PT * N;
      for (int i = tid; i < PT * N / 2; i += CH_THREADS) {
        const int pr = i / (N / 2), n = 2 * (i - pr * (N / 2));
        const float2 sv = *reinterpret_cast<const float2*>(Si + pr * N + n);
        const float2 dv = *reinterpret_cast<const float2*>(Sd + pr * N + n);
        sdot += sv.x * dv.x;
        sdot += sv.y * dv.y;
        uint32_t ps[PARTS], pd[PARTS];
        mma::split_bf16x2(sv.x, sv.y, ps);
        mma::split_bf16x2(dv.x, dv.y, pd);
#pragma unroll
        for (int k = 0; k < PARTS; ++k) {
          *reinterpret_cast<uint32_t*>(Sp + k * SPLANE + pr * LDS + n) = ps[k];
          *reinterpret_cast<uint32_t*>(Dp + k * SPLANE + pr * LDS + n) = pd[k];
        }
      }
    }
    __syncthreads();  // the parts are visible

    if (warp == REDUCER && pt == 0 && u > 0) reduce(h - 1);  // the last head's
    if (warp == STORER && u > 0) store_dx(u - 1);
    if (n_on) {  // q += dy[:, tile] S_in[tile], r += x[:, tile] dS_out[tile]
      uint32_t ya[4][1], xa[4][1];
      frag_a(ya, Ys, LDX, 16 * rq, pt);
      frag_a(xa, Xs, LDX, 16 * rq, pt);
      mma_rows_kn<NQ, PARTS, 1>(q, ya, Sp, SPLANE, LDS, 0, n0);
      mma_rows_kn<NQ, PARTS, 1>(r, xa, Dp, SPLANE, LDS, 0, n0);
    }
    {  // dx_j = dt_j sum_{i>=j} (C.B^T o E)_ij dy_i + w_j (B_j . dS_out),
       // this warp's half of each sum
#pragma unroll
      for (int e = 0; e < 4; ++e) di[e] = de[e] = 0.f;
#pragma unroll
      for (int ib = 0; ib < LC / 16; ++ib) {
        if (ib < rq || ((ib - rq) & 1) != kh) continue;
        uint32_t yf[4];
        mma::ldmatrix_x4_trans(
            yf, Ys + (16 * ib + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                    16 * pt + (lane >> 4) * 8);
        // this warp's 8 columns (a select: a register array indexed by
        // a value known only at run time would live in local memory)
        const uint32_t y0 = hf ? yf[2] : yf[0], y1 = hf ? yf[3] : yf[1];
#pragma unroll
        for (int k = PARTS - 1; k >= 0; --k) {
          uint32_t ma[4];  // (C.B^T o E)^T: rows j, k = i
          mma::ldmatrix_x4_trans(
              ma, Mp + k * MPLANE +
                      (16 * ib + ((lane >> 4) << 3) + (lane & 7)) * LDL +
                      16 * rq + ((lane >> 3) & 1) * 8);
          mma::mma_bf16(di, ma, y0, y1);
        }
      }
#pragma unroll
      for (int kn = 0; kn < KS; ++kn) {
        if (kn < kh * KH || kn >= (kh + 1) * KH) continue;
        uint32_t ba[4][1];
        frag_a(ba, Bs, LDS, 16 * rq, kn);
        const uint32_t a4[4] = {ba[0][0], ba[1][0], ba[2][0], ba[3][0]};
#pragma unroll
        for (int k = PARTS - 1; k >= 0; --k) {
          uint32_t df[4];  // dS_out^T: k = n, columns p of the tile
          mma::ldmatrix_x4(
              df, Dp + k * SPLANE +
                      ((lane & 7) + ((lane >> 4) << 3)) * LDS + 16 * kn +
                      ((lane >> 3) & 1) * 8);
          mma::mma_bf16(de, a4, hf ? df[2] : df[0], hf ? df[3] : df[1]);
        }
      }
      if (kh == 1) {  // hand this half over
        float* o = dxp + (warp & 7) * 8 * 32 + lane;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[e * 32] = di[e];
          o[(4 + e) * 32] = de[e];
        }
      }
    }
    if (pt != npt - 1) continue;

    // the head's end.  With one tile a head the REDUCER may still be
    // reading the last head's sums
    if (npt == 1) __syncthreads();
    // D = dy x^T at the D positions; G = (C.B^T o E) o D and W = D o E o
    // dt_j there; W into the group's sum
    float rs[2] = {0.f, 0.f};       // rows i0, i1: sum_j G_ij dt_j
    float cs[2][2] = {};            // columns: sum over rows i0, i1
    if (d_on) {
      float dacc[2][4] = {};
      for (int ks = 0; ks < npt; ++ks) {
        uint32_t ya[4][1], xf[4];
        frag_a(ya, Ys, LDX, 16 * rq, ks);
        mma::ldmatrix_x4(xf, Xs + (16 * qn + (lane & 7) +
                                   ((lane >> 4) << 3)) * LDX +
                                 16 * ks + ((lane >> 3) & 1) * 8);
        const uint32_t a4[4] = {ya[0][0], ya[1][0], ya[2][0], ya[3][0]};
        mma::mma_bf16(dacc[0], a4, xf[0], xf[1]);
        mma::mma_bf16(dacc[1], a4, xf[2], xf[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 16 * qn + 8 * nb + 2 * t + (e & 1);
          const int slot = (nb * 4 + e) * CH_THREADS;
          const float ed = Er[slot] * dacc[nb][e];  // 0 above the diagonal
          const float gv = CBr[slot] * ed;
          wsum[nb][e] += ed * dtv[j];
          rs[e >> 1] += gv * dtv[j];
          cs[nb][e & 1] += gv;
        }
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // over the eight rows g of the warp
        float v = cs[nb][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) colp[rq * LC + 16 * qn + 8 * nb + 2 * t + e] = v;
      }
    // u_i = C_i . q_i and v_j = B_j . r_j over this warp's quarter of N;
    // the head's state terms into the group's dC and dB
    float uu[2] = {0.f, 0.f}, vv[2] = {0.f, 0.f};
    if (n_on) {
#pragma unroll
      for (int nb = 0; nb < NQ; ++nb) {
        const int n = n0 + 8 * nb + 2 * t;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = hr ? i1 : i0;
          const float2 cv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Cs + i * LDS + n));
          const float2 bv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Bs + i * LDS + n));
          uu[hr] += q[nb][2 * hr] * cv.x + q[nb][2 * hr + 1] * cv.y;
          vv[hr] += r[nb][2 * hr] * bv.x + r[nb][2 * hr + 1] * bv.y;
          dCg[nb][2 * hr] += ecum[i] * q[nb][2 * hr];
          dCg[nb][2 * hr + 1] += ecum[i] * q[nb][2 * hr + 1];
          dBg[nb][2 * hr] += wv[i] * r[nb][2 * hr];
          dBg[nb][2 * hr + 1] += wv[i] * r[nb][2 * hr + 1];
        }
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float rsum = mma::quad_sum(rs[hr]);
      const float usum = mma::quad_sum(uu[hr]);
      const float vsum = mma::quad_sum(vv[hr]);
      if (t == 0) {
        const int i = hr ? i1 : i0;
        rowp[qn * LC + i] = rsum;
        up[qn * LC + i] = usum;
        vp[qn * LC + i] = vsum;
      }
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      sdot += __shfl_xor_sync(0xffffffffu, sdot, off);
    if (lane == 0) red[warp] = sdot;
    if (warp == REDUCER) {  // the head's vectors, for reduce()
      for (int k = lane; k < VEC; k += 32) rvec[k] = vec[k];
    }
  }

  __syncthreads();  // the last hand-overs and sums are visible; Mp is free
  if (kh == 0) finish_dx();
  if (warp == REDUCER) reduce(h0 + hn - 1);
  // the intra-chunk terms of the group: dC += W B, dB += W^T C, with W
  // summed over the heads, in parts
  if (d_on) {
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const int j = 16 * qn + 8 * nb + 2 * t;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = hr ? i1 : i0;
        uint32_t part[PARTS];
        mma::split_bf16x2(wsum[nb][2 * hr], wsum[nb][2 * hr + 1], part);
#pragma unroll
        for (int k = 0; k < PARTS; ++k)
          *reinterpret_cast<uint32_t*>(Mp + k * MPLANE + i * LDL + j) = part[k];
      }
    }
  }
  __syncthreads();
  if (warp == STORER) store_dx(units - 1);
  if (!n_on) return;
#pragma unroll
  for (int jb = 0; jb < LC / 16; ++jb) {  // dC_i += sum_{j<=i} W_ij B_j
    if (jb > rq) continue;
    uint32_t wa[4][PARTS];
#pragma unroll
    for (int k = 0; k < PARTS; ++k) {
      uint32_t f[4];
      mma::ldmatrix_x4(f, Mp + k * MPLANE + (16 * rq + (lane & 15)) * LDL +
                              16 * jb + (lane >> 4) * 8);
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) wa[qq][k] = f[qq];
    }
    mma_rows_kn<NQ, 1, PARTS>(dCg, wa, Bs, 0, LDS, jb, n0);
  }
#pragma unroll
  for (int ib = 0; ib < LC / 16; ++ib) {  // dB_j += sum_{i>=j} W_ij C_i
    if (ib < rq) continue;
    uint32_t wa[4][PARTS];
#pragma unroll
    for (int k = 0; k < PARTS; ++k) {
      uint32_t f[4];
      mma::ldmatrix_x4_trans(
          f, Mp + k * MPLANE + (16 * ib + ((lane >> 4) << 3) + (lane & 7)) *
                                   LDL + 16 * rq + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) wa[qq][k] = f[qq];
    }
    mma_rows_kn<NQ, 1, PARTS>(dBg, wa, Cs, 0, LDS, ib, n0);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = hr ? i1 : i0;
    if (i >= rows) continue;
    const size_t o = (((size_t)b * p.S + s0 + i) * p.groups + grp) * N + n0 +
                     2 * t;
#pragma unroll
    for (int nb = 0; nb < NQ; ++nb) {
      *reinterpret_cast<float2*>(p.dCp + o + 8 * nb) =
          make_float2(dCg[nb][2 * hr], dCg[nb][2 * hr + 1]);
      *reinterpret_cast<float2*>(p.dBp + o + 8 * nb) =
          make_float2(dBg[nb][2 * hr], dBg[nb][2 * hr + 1]);
    }
  }
}

template <int N>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  if (p.P > P_MAX) return cudaErrorInvalidValue;
  constexpr size_t walk_smem = walk_tc_smem_bytes<N>();
  constexpr size_t chunk_smem = ChunkSmem<N>::bytes;
  static size_t walk_done[mma::MAX_DEVICES] = {};
  static size_t chunk_done[mma::MAX_DEVICES] = {};
  cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(ssd_dstate_tc_kernel<N>), walk_smem,
      walk_done);
  if (err != cudaSuccess) return err;
  err = mma::opt_in_smem(
      reinterpret_cast<const void*>(ssd_bwd_chunk_tc_kernel<N>), chunk_smem,
      chunk_done);
  if (err != cudaSuccess) return err;
  ssd_dstate_tc_kernel<N><<<dim3(p.H, p.B), TC_THREADS, walk_smem, stream>>>(
      p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_tc_kernel<N><<<dim3(p.n_sub, p.groups, p.B), CH_THREADS,
                               chunk_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_sum_kernel<bf16><<<p.B * p.S + 1, SUM_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t walk_smem = walk_smem_bytes<N>();
  constexpr size_t chunk_smem = chunk_smem_bytes<N>();
  static size_t walk_done[mma::MAX_DEVICES] = {};
  static size_t chunk_done[mma::MAX_DEVICES] = {};
  cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(ssd_dstate_kernel<N>), walk_smem,
      walk_done);
  if (err != cudaSuccess) return err;
  err = mma::opt_in_smem(
      reinterpret_cast<const void*>(ssd_bwd_chunk_kernel<N>), chunk_smem,
      chunk_done);
  if (err != cudaSuccess) return err;
  ssd_dstate_kernel<N><<<dim3(p.P / PT, p.H, p.B), THREADS, walk_smem,
                            stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<N><<<dim3(p.n_sub, p.H, p.B), THREADS, chunk_smem,
                               stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_sum_kernel<float><<<p.B * p.S + 1, SUM_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_dtype(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<N>(p, stream);
  if (dtype == 1) return launch_bf16<N>(p, stream);
  return cudaErrorInvalidValue;
}

int n_subs(int S) { return (S + LC - 1) / LC; }

// partials of dB and dC a (b, s) row: one a head in float32, one a group
// of GROUP heads in bf16
int n_groups(int H, int dtype) {
  return dtype == 1 ? (H + GROUP - 1) / GROUP : H;
}

}  // namespace

// Floats of each scratch tensor repro_ssd_backward needs for `dtype`, by
// `which`: 0 the forward's states and the walk's dS (each B * n_sub * H *
// P * N), 1 the partial sums of dB and of dC (each B * S * groups * N:
// groups = H in float32, ceil(H / 8) in bf16), 2 the dA partials
// (B * n_sub * H).
extern "C" long long repro_ssd_backward_scratch_floats(int which, int B, int S,
                                                       int H, int P, int N,
                                                       int dtype) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  const long long subs = (long long)B * n_subs(S) * H;
  if (which == 0) return subs * P * N;
  if (which == 1) return (long long)B * S * n_groups(H, dtype) * N;
  if (which == 2) return subs;
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC; head dim at
// most 64).  dy is dense (B, S, H, P); dstate may be null; states is what
// repro_ssd_scan wrote through its `states` pointer for the same inputs.
// Returns the cudaError_t of the first launch that failed, else
// cudaSuccess.
extern "C" int repro_ssd_backward(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dstate, const void* states,
    void* dS, void* dBp, void* dCp, void* dAp, void* dx, void* ddt, void* dA,
    void* dB, void* dC, long long x_sb, long long x_ss, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, int B, int S, int H, int P,
    int N, int dtype, void* stream) {
  if (P % PT || B <= 0 || S <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x,
           static_cast<const float*>(dt),
           static_cast<const float*>(A),
           Bm,
           Cm,
           dy,
           static_cast<const float*>(dstate),
           static_cast<const float*>(states),
           static_cast<float*>(dS),
           static_cast<float*>(dBp),
           static_cast<float*>(dCp),
           static_cast<float*>(dAp),
           dx,
           static_cast<float*>(ddt),
           static_cast<float*>(dA),
           dB,
           dC,
           x_sb, x_ss, b_sb, b_ss, c_sb, c_ss,
           B, S, H, P, N, n_subs(S), n_groups(H, dtype)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 16: err = launch_dtype<16>(p, dtype, s); break;
    case 32: err = launch_dtype<32>(p, dtype, s); break;
    case 64: err = launch_dtype<64>(p, dtype, s); break;
    case 128: err = launch_dtype<128>(p, dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_ssd_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
