// The Hopper instructions fused_step.cu is built from, each behind one small
// inline function: the thread-block cluster's rank and barrier, cp.async
// copies from global to shared memory, and the bf16 tensor-core product
// mma.sync m16n8k16 with f32 accumulation.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// Rank of this block in its cluster.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// Barrier over every thread of every block of the cluster. The arrive is a
// release and the wait an acquire at cluster scope, so what any thread wrote
// before it (shared or global memory) is visible to every thread after it.
// Every thread of the cluster must reach it: call it under conditions that
// are the same in every block only.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Asynchronous copies global -> shared; commit closes a group, wait_all
// waits for every group this thread committed (follow it with
// __syncthreads() before reading what other threads copied).
__device__ __forceinline__ void cp_async4(float* smem_dst, const float* gmem_src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(gmem_src) : "memory");
}

// 16 bytes, both addresses 16-byte aligned; goes through L2 only, so it
// reads what another block of the cluster published with cluster_sync().
__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Waits until at most N of the groups this thread committed are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two floats rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b on the tensor cores: a is 16 x 16 (row), b 16 x 8 (col), bf16
// inputs, f32 accumulation. With g = lane / 4 and tg = lane % 4 a thread
// holds
//   a[0] = A[g][2tg..2tg+1]      a[1] = A[g+8][2tg..2tg+1]
//   a[2] = A[g][2tg+8..2tg+9]    a[3] = A[g+8][2tg+8..2tg+9]
//   b[0] = B[2tg..2tg+1][g]      b[1] = B[2tg+8..2tg+9][g]
//   c[0] = C[g][2tg]  c[1] = C[g][2tg+1]  c[2] = C[g+8][2tg]  c[3] = C[g+8][2tg+1]
// Every thread of the warp must execute it.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
