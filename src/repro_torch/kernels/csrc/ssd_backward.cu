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
//   1. the walk, grid (P / 16, H, B): each block owns 16 state rows (rows
//      p of the state gradient are independent, as in the forward) and
//      walks the sub-chunks from the last to the first, writing dS_out of
//      each to scratch (B, n_sub, H, P, N);
//   2. the sub-chunks, grid (n_sub, H, B): each block computes dx, ddt
//      and its head's terms of dB and dC for its 64 rows (written to
//      per-head scratch (B, S, H, N)) and its term of dA (scratch
//      (B, n_sub, H));
//   3. the sums: dB and dC over the heads in head order, one block a
//      (b, s) row, and dA over (b, sub) in that order, one more block.
//
// Every product runs on the float32 CUDA cores out of shared memory:
// bf16 operands are widened, so the backward keeps float32 precision, as
// the forward's three-part bf16 products do.  This is the first, simple
// body: the tensor cores are ROADMAP queue 2's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int LC = 64;        // sequence rows per sub-chunk (the forward's)
constexpr int PT = 16;        // state rows per walk block; P tile of pass 2
constexpr int THREADS = 256;  // both passes: a 16 x 16 thread grid
constexpr int SUM_THREADS = 128;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

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
  float* dBp;            // (B, S, H, N) scratch
  float* dCp;            // (B, S, H, N) scratch
  float* dAp;            // (B, n_sub, H) scratch
  void* dx;              // (B, S, H, P) x's dtype
  float* ddt;            // (B, S, H)
  float* dA;             // (H,)
  void* dB;              // (B, S, N) B's dtype
  void* dC;              // (B, S, N)
  long long x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
  int B, S, H, P, N, n_sub;
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

// Rows s0 .. s0 + LC - 1 of B or C (N wide, through the strides), widened
// to float, into shared rows of `ld` floats; rows past `rows` are zero.
template <typename T, int N>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long sb, long long ss, int b,
                                          int s0, int rows) {
  for (int i = threadIdx.x; i < LC * N; i += THREADS) {
    const int r = i / N, n = i % N;
    dst[r * ld + n] =
        r < rows ? to_f(src[b * sb + (long long)(s0 + r) * ss + n]) : 0.f;
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

template <typename T, int N>
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

  const T* __restrict__ cg = static_cast<const T*>(p.Cm);
  const T* __restrict__ yg = static_cast<const T*>(p.dy);
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
    load_rows<T, N>(Cs, NS, cg, p.c_sb, p.c_ss, b, s0, rows);
    __syncthreads();
    for (int i = tid; i < LC * PT; i += THREADS) {
      const int r = i / PT, c = i % PT;
      Ys[i] = r < rows
          ? to_f(yg[(((size_t)b * p.S + s0 + r) * p.H + h) * p.P + p0 + c]) *
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

template <typename T, int N>
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

  const T* __restrict__ xg = static_cast<const T*>(p.x);
  const T* __restrict__ yg = static_cast<const T*>(p.dy);
  T* __restrict__ dxg = static_cast<T*>(p.dx);
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
  load_rows<T, N>(Bs, NS, static_cast<const T*>(p.Bm), p.b_sb, p.b_ss, b, s0,
                  rows);
  load_rows<T, N>(Cs, NS, static_cast<const T*>(p.Cm), p.c_sb, p.c_ss, b, s0,
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
      Xt[i] = ok ? to_f(xg[b * p.x_sb + s * p.x_ss + (long long)h * p.P + pt +
                           c])
                 : 0.f;
      Yt[i] = ok ? to_f(yg[(((size_t)b * p.S + s) * p.H + h) * p.P + pt + c])
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
              from_f<T>(intra * dts[j] + wv[j] * inter);
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
// 3. The sums over heads (dB, dC) and over (b, sub) (dA), in index order
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
    for (int h = 0; h < p.H; ++h) {
      const size_t o = ((size_t)row * p.H + h) * p.N + n;
      sb += p.dBp[o];
      sc += p.dCp[o];
    }
    dB[(size_t)row * p.N + n] = from_f<T>(sb);
    dC[(size_t)row * p.N + n] = from_f<T>(sc);
  }
}

template <typename T, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t walk_smem = walk_smem_bytes<N>();
  constexpr size_t chunk_smem = chunk_smem_bytes<N>();
  static size_t walk_done[mma::MAX_DEVICES] = {};
  static size_t chunk_done[mma::MAX_DEVICES] = {};
  cudaError_t err = mma::opt_in_smem(
      reinterpret_cast<const void*>(ssd_dstate_kernel<T, N>), walk_smem,
      walk_done);
  if (err != cudaSuccess) return err;
  err = mma::opt_in_smem(
      reinterpret_cast<const void*>(ssd_bwd_chunk_kernel<T, N>), chunk_smem,
      chunk_done);
  if (err != cudaSuccess) return err;
  ssd_dstate_kernel<T, N><<<dim3(p.P / PT, p.H, p.B), THREADS, walk_smem,
                            stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<T, N><<<dim3(p.n_sub, p.H, p.B), THREADS, chunk_smem,
                               stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_sum_kernel<T><<<p.B * p.S + 1, SUM_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_dtype(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch<float, N>(p, stream);
  if (dtype == 1) return launch<bf16, N>(p, stream);
  return cudaErrorInvalidValue;
}

int n_subs(int S) { return (S + LC - 1) / LC; }

}  // namespace

// Floats of each scratch tensor repro_ssd_backward needs, by `which`: 0 the
// forward's states and the walk's dS (each B * n_sub * H * P * N), 1 the
// per-head dB and dC partials (each B * S * H * N), 2 the dA partials
// (B * n_sub * H).
extern "C" long long repro_ssd_backward_scratch_floats(int which, int B, int S,
                                                       int H, int P, int N) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  const long long subs = (long long)B * n_subs(S) * H;
  if (which == 0) return subs * P * N;
  if (which == 1) return (long long)B * S * H * N;
  if (which == 2) return subs;
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB, dC).  dy is
// dense (B, S, H, P); dstate may be null; states is what repro_ssd_scan
// wrote through its `states` pointer for the same inputs.  Returns the
// cudaError_t of the first launch that failed, else cudaSuccess.
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
           B, S, H, P, N, n_subs(S)};
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
