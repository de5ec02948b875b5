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
// Design.  The TPU grid walks the chunks of one (b, h) in order and keeps
// the (P, N) state in VMEM scratch; blocks on the card run in no order, so
// the walk over the sequence lives inside one block.  Rows p of the state
// are independent (y[:, p] needs only x[:, p] and state[p, :]), so the
// grid is (P / 16, H, B): each block owns 16 state rows and carries them
// in shared memory, with no combine pass (B=1 and 80 heads give 320
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
// which leaves the state as it is.  Everything accumulates in float32.
//
// What bounds it on the H100.  At B=1, S=512, H=80, P=64, N=128 in bf16
// the scan must move about 13.5 MB (x and y 5.2 MB each, the float32
// state 2.6 MB, dt, B and C) and do about 2 GFLOP (the causal half of
// C.B per chunk, shared by the heads, and per head the intra-chunk,
// inter-chunk and state products): bytes bound it, at about 4 us.  This
// first version is far from that: its products run on the float32 CUDA
// cores from shared memory, and each of the four blocks of a head
// recomputes the same C.B tile.  Tensor cores (wgmma), TMA and sharing
// C.B across heads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LC = 64;          // sequence rows per sub-chunk
constexpr int PT = 16;          // state rows (head-dim columns) per block
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(Params p) {
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

template <typename T, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<N>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(p.P / PT, p.H, p.B);
  ssd_scan_kernel<T, N><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const Params& p, int n, cudaStream_t stream) {
  switch (n) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y).  Returns the
// cudaError_t of the launch.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* state, long long x_sb, long long x_ss,
                              long long b_sb, long long b_ss, long long c_sb,
                              long long c_ss, int B, int S, int H, int P,
                              int N, int dtype, void* stream) {
  if (P % PT) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           Bm, Cm, y, static_cast<float*>(state), x_sb, x_ss, b_sb, b_ss,
           c_sb, c_ss, B, S, H, P};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_n<float>(p, N, s);
  } else if (dtype == 1) {
    err = dispatch_n<__nv_bfloat16>(p, N, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
