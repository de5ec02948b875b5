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
// Design.  One block per (kv head, batch row) holds the T * G query rows
// of that kv head, one warp per row (T * G <= 32).  The loop walks the
// sequence's positions in tiles of 32; each thread looks the page of the
// key it stages up in the block table itself (no gather copy), and K/V
// tiles are staged in shared memory as float32 with 16-byte vector
// loads.  Lane c scores key c of the tile, the warp reduces max and sum
// with shuffles, and each lane accumulates Dh / 32 output columns.  The
// resident K/V is read once for all T rows: the verify pass costs about
// what one decode step does.
//
// What bounds it on the H100: bytes.  Each key is read once and used in
// T * G dot products, a few FLOPs per byte, far below the card's ridge.
// With B * Hkv = 64 blocks on the main path (8 slots x 8 kv heads) the
// grid underfills the 132 SMs and no copy is in flight during compute; a
// split over pages with a combine pass, and cp.async or TMA double
// buffering, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;  // positions per tile: one per lane
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int rows = p.n_tok * (p.Hq / p.Hkv);
  const size_t smem = smem_bytes<DH>(rows);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.Hkv, p.B);
  paged_attention_kernel<T, DH><<<grid, 32 * rows, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const Params& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch<T, 16>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int repro_paged_attention(const void* q, const void* k,
                                     const void* v, const void* block_tables,
                                     const void* lengths, void* o, int B,
                                     int T, int Hq, int Hkv, int Dh, int P,
                                     int ps, int Pmax, int window,
                                     float softcap, float scale, int dtype,
                                     void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || T <= 0 || T * (Hq / Hkv) > 32 ||
      P <= 0 || ps <= 0 || Pmax <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, k, v, static_cast<const int*>(block_tables),
           static_cast<const int*>(lengths), o, B, T, Hq, Hkv, P, ps, Pmax,
           window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_dh<float>(p, Dh, s);
  } else if (dtype == 1) {
    err = dispatch_dh<__nv_bfloat16>(p, Dh, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
