// The CUDA runtime as the CPU emulation (emu.cpp) needs it: thread and block
// indices per thread, the barriers of a block and a warp, a warp's shuffle.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <memory>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(a, b)
#define __shared__
struct uint3 { unsigned x, y, z; };
struct dim3 { unsigned x, y, z; };
extern thread_local uint3 threadIdx;
extern thread_local uint3 blockIdx;
struct float4 { float x, y, z, w; };
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return float4{a, b, c, d}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return uint4{a, b, c, d}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return uint2{a, b}; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
using std::isfinite;
// per-thread handles to the barriers of its block, its warp and its cluster
struct EmuCtx {
  std::barrier<>* block;
  std::barrier<>* cluster;
  std::barrier<>* warp;
  float* warp_slot;      // 32 floats
  uint32_t* warp_frag;   // 32 x 6 words
};
extern thread_local EmuCtx emu;
inline void __syncthreads() { emu.block->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int lane = threadIdx.x & 31;
  emu.warp_slot[lane] = v;
  emu.warp->arrive_and_wait();
  const float r = emu.warp_slot[lane ^ o];
  emu.warp->arrive_and_wait();
  return r;
}
