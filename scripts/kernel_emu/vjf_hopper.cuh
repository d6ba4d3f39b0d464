// The Hopper instructions of csrc/vjf_hopper.cuh for the CPU emulation: the
// cluster barrier over every thread of every block, cp.async as plain
// copies, bf16 rounding to nearest even, and mma.sync m16n8k16 as an
// exchange of the fragments through the warp's slots.
#pragma once
#include "cuda_runtime.h"
inline int cluster_rank() { return (int)blockIdx.x; }
inline void cluster_sync() { emu.cluster->arrive_and_wait(); }
inline void cp_async4(float* d, const float* s) { *d = *s; }
inline void cp_async16(float* d, const float* s) { std::memcpy(d, s, 16); }
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
template <int N> inline void cp_async_wait_group() {}
inline uint16_t bf16_bits(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return (uint16_t)((u >> 16) | 0x40);
  u += 0x7fff + ((u >> 16) & 1);
  return (uint16_t)(u >> 16);
}
inline float bf16_float(uint16_t b) { uint32_t u = (uint32_t)b << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)bf16_bits(lo) | ((uint32_t)bf16_bits(hi) << 16);
}
inline void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const int lane = threadIdx.x & 31;
  uint32_t* fr = emu.warp_frag;
  for (int i = 0; i < 4; ++i) fr[lane * 6 + i] = a[i];
  fr[lane * 6 + 4] = b[0];
  fr[lane * 6 + 5] = b[1];
  emu.warp->arrive_and_wait();
  float A[16][16], B[16][8];
  for (int L = 0; L < 32; ++L) {
    const int g = L >> 2, tg = L & 3;
    const uint32_t* f = fr + L * 6;
    auto lo = [](uint32_t w) { return bf16_float((uint16_t)(w & 0xffff)); };
    auto hi = [](uint32_t w) { return bf16_float((uint16_t)(w >> 16)); };
    A[g][2 * tg] = lo(f[0]); A[g][2 * tg + 1] = hi(f[0]);
    A[g + 8][2 * tg] = lo(f[1]); A[g + 8][2 * tg + 1] = hi(f[1]);
    A[g][2 * tg + 8] = lo(f[2]); A[g][2 * tg + 9] = hi(f[2]);
    A[g + 8][2 * tg + 8] = lo(f[3]); A[g + 8][2 * tg + 9] = hi(f[3]);
    B[2 * tg][g] = lo(f[4]); B[2 * tg + 1][g] = hi(f[4]);
    B[2 * tg + 8][g] = lo(f[5]); B[2 * tg + 9][g] = hi(f[5]);
  }
  emu.warp->arrive_and_wait();
  const int g = lane >> 2, tg = lane & 3;
  const int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * tg, 2 * tg + 1, 2 * tg, 2 * tg + 1};
  for (int i = 0; i < 4; ++i) {
    float s = c[i];
    for (int k = 0; k < 16; ++k) s += A[rows[i]][k] * B[k][cols[i]];
    c[i] = s;
  }
}
