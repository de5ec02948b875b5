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
// Design.  One block per (q tile of BQ rows, q head, batch row); four
// threads per query row.  K/V tiles of BK keys are staged in shared
// memory as float32; each thread keeps BK/4 scores and Dh/4 output
// accumulators in registers.  Ragged edges are masked here, so Sq and
// Skv need not be multiples of the tile.  Tiles that lie wholly outside
// every row's valid interval (the causal future, before the window,
// past kv_len; all in positions, so shifted by q_start) are skipped: a fully masked tile after a valid key adds
// exp(-1e30 - m) = 0 and one before it is wiped by alpha = 0, so the
// result is unchanged.  When some row has no valid key at all, the block
// visits every tile, to reproduce the reference's average over V.
//
// What bounds it on the H100.  Causal prefill over S tokens with 32 q and
// 8 kv heads does about 0.4 * S FLOPs per byte it must move, so the
// roofline bound is bytes below S of about 740 (the bf16 tensor-core ridge
// is about 295 FLOPs per byte) and operations above.  This first version
// is far from either: it runs the dot products on the float32 CUDA cores,
// from shared memory, not on the tensor cores.  wgmma and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;                // query rows per block
constexpr int BK = 32;                // keys per K/V tile
constexpr int TPR = 4;                // threads per query row
constexpr int THREADS = BQ * TPR;     // 128
constexpr int KPT = BK / TPR;         // scores per thread per tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T, int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<DH>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<T, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_prefill_kernel<T, DH><<<grid, THREADS, smem, stream>>>(p);
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
  if (dtype == 0) {
    err = dispatch_dh<float>(p, Dh, s);
  } else if (dtype == 1) {
    err = dispatch_dh<__nv_bfloat16>(p, Dh, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* repro_flash_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
