// Warp-level tensor-core and async-copy helpers for Hopper (sm_90a), in
// inline PTX, shared by the bf16 bodies of every kernel in csrc/, and the
// host's per-device opt-in to large dynamic shared memory.
//
// No CUTLASS or CuTe header: every build compiles from scratch, and
// those headers cost minutes of nvcc.
//
// Fragment layouts of mma.sync m16n8k16 (bf16 in, float32 accumulate),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 registers of bf16x2:
//     a0 (row g, cols 2t, 2t+1), a1 (row g+8, cols 2t, 2t+1),
//     a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, k x n), 2 registers: b0 (k 2t, 2t+1; col g),
//     b1 (k 2t+8, 2t+9; col g);
//   C (16 x 8), 4 floats: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// The C layout of S = Q.K^T over two adjacent 8-key blocks is the A
// layout of P for P.V, so P never leaves registers (FlashAttention-2).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from global to shared memory that does not block the
// thread; with pred false it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// The same for one 4-byte word (a strided float32 vector such as dt).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
// Other threads see the copies only after a barrier.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] receives it in the A/B fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed: rows in shared memory become columns
// of the fragment (V stored key-major, read as the k x n B operand).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores (m16n8k16, bf16 x bf16 -> float32).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed; lo takes the low half, the
// element of the lower column in a fragment.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats as a sum of K bf16 pairs, each packed as pack_bf16x2 packs:
// part k holds what rounding to parts 0 .. k-1 lost (each difference is
// exact in float32).  K = 3 carries all 24 bits of a float32; a product
// with an exact bf16 operand then takes K mma_bf16, one a part, smallest
// part first.
template <int K>
__device__ __forceinline__ void split_bf16x2(float a, float b,
                                             uint32_t (&part)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    part[k] = *reinterpret_cast<const uint32_t*>(&h);
    a -= hf.x;
    b -= hf.y;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Host: let `kernel` use `bytes` of dynamic shared memory on the current
// device.  The attribute is per device, so `done` (one static array per
// kernel instantiation, indexed by device) records what each device has
// been given; a launch on a new device sets it again.
constexpr int MAX_DEVICES = 64;

inline cudaError_t opt_in_smem(const void* kernel, size_t bytes,
                               size_t (&done)[MAX_DEVICES]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done[dev] = bytes;
  return err;
}

}  // namespace mma
