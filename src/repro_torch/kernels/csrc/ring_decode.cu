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
// Design.  One block per (kv head, batch row) holds the G grouped query
// rows, one warp per row.  The loop walks the C ring slots in tiles of
// 32 staged in shared memory as float32 (16-byte vector loads); lane c
// scores slot c of the tile, the warp reduces max and sum with shuffles,
// and each lane accumulates Dh/32 output columns.
//
// What bounds it on the H100: bytes.  One token attends over the whole
// cache, about 1 FLOP per byte of K/V read, far below the card's ridge.
// With B * Hkv = 64 blocks on the main path (8 slots x 8 kv heads) the
// grid underfills the 132 SMs, and each block streams its K/V with no
// copy in flight during compute; a split over C with a combine pass, and
// cp.async or TMA double buffering, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;  // ring slots per tile: one per lane
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
  const int* slot_pos;
  const int* q_pos;
  void* o;
  int B, C, Hq, Hkv;
  int window;     // <= 0: none
  float softcap;  // <= 0: none
  float scale;
};

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
      const int sp = spos[c];
      bool ok = sp >= 0 && sp <= qpos;
      if (p.window > 0) ok = ok && (qpos - sp < p.window);
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
  T* dst = o + ((size_t)b * p.Hq + (size_t)hk * G + warp) * DH;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    if (d < DH) dst[d] = from_f<T>(acc[j] * inv);
  }
}

template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int G = p.Hq / p.Hkv;
  const size_t smem = smem_bytes<DH>(G);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ring_decode_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(p.Hkv, p.B);
  ring_decode_kernel<T, DH><<<grid, 32 * G, smem, stream>>>(p);
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
extern "C" int repro_ring_decode(const void* q, const void* k, const void* v,
                                 const void* slot_pos, const void* q_pos,
                                 void* o, int B, int C, int Hq, int Hkv, int Dh,
                                 int window, float softcap, float scale,
                                 int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 32) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, static_cast<const int*>(slot_pos),
           static_cast<const int*>(q_pos), o, B, C, Hq, Hkv, window, softcap,
           scale};
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

extern "C" const char* repro_ring_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
