// CPU emulation of vjf_tpu_torch/csrc/exact_fallback.cu, built beside
// emu.cpp into the same library: the kernel file cut before its "Kernels and
// the C interface" section (emu.py writes the cut as exact_fallback_cut.cu),
// run on pthreads as emu.cpp runs the step kernels (a thread a CUDA thread,
// a std::barrier each __syncthreads, __syncwarp and cluster_sync), with the C
// interface that ops/fused_step.py binds. The members of a launch run one
// cluster after another; each block has its own FbShared, filled with NaN.
#include <pthread.h>
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <limits>
#include <vector>
#include "cuda_runtime.h"
#include "vjf_hopper.cuh"

using std::min;
inline float __ldcg(const float* p) { return *p; }
inline void __syncwarp(unsigned = 0xffffffffu) { emu.warp->arrive_and_wait(); }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __shfl_sync(unsigned, float v, int src) {
  const int lane = threadIdx.x & 31;
  emu.warp_slot[lane] = v;
  emu.warp->arrive_and_wait();
  const float r = emu.warp_slot[src];
  emu.warp->arrive_and_wait();
  return r;
}

#include "exact_fallback_cut.cu"

namespace {

struct FbThread {
  const FallbackArgs* a;
  FbShared* sh;
  int tid, blk, member;
  EmuCtx ctx;
};

void* fb_thread(void* p) {
  const FbThread& t = *static_cast<FbThread*>(p);
  threadIdx = uint3{(unsigned)t.tid, 0, 0};
  blockIdx = uint3{(unsigned)t.blk, (unsigned)t.member, 0};
  emu = t.ctx;
  fb_run(*t.a, *t.sh);
  return nullptr;
}

}  // namespace

extern "C" {
size_t vjf_fallback_args_size(void) { return sizeof(FallbackArgs); }
size_t vjf_fallback_args_tail(void) { return offsetof(FallbackArgs, state_var_cap); }
size_t vjf_fallback_workspace_floats(const FallbackArgs* a) { return fb_work(*a, nullptr).total; }
int vjf_exact_fallback(const FallbackArgs* a, void*) {
  if (a->nfp % FB_TILE != 0 || a->nfp <= 0 || a->xd <= 0) return 1;
  const int members = a->n_members > 1 ? a->n_members : 1;
  for (int m = 0; m < members; ++m) {
    std::barrier<> cluster(NTHREADS * VJF_CLUSTER);
    std::vector<std::unique_ptr<std::barrier<>>> blocks, warps;
    std::vector<float> slots(VJF_CLUSTER * NWARPS * 32);
    std::vector<FbShared> shared(VJF_CLUSTER);
    for (auto& s : shared) {
      float* f = reinterpret_cast<float*>(&s);
      std::fill(f, f + offsetof(FbShared, failed) / sizeof(float),
                std::numeric_limits<float>::quiet_NaN());
    }
    for (int b = 0; b < VJF_CLUSTER; ++b) {
      blocks.emplace_back(new std::barrier<>(NTHREADS));
      for (int w = 0; w < NWARPS; ++w) warps.emplace_back(new std::barrier<>(32));
    }
    std::vector<FbThread> targs(VJF_CLUSTER * NTHREADS);
    std::vector<pthread_t> ths(targs.size());
    pthread_attr_t attr;
    pthread_attr_init(&attr);
    pthread_attr_setstacksize(&attr, 1 << 20);
    for (int b = 0; b < VJF_CLUSTER; ++b)
      for (int t = 0; t < NTHREADS; ++t) {
        const int w = b * NWARPS + t / 32;
        FbThread& ta = targs[b * NTHREADS + t];
        ta = FbThread{a, &shared[b], t, b, m,
                      EmuCtx{blocks[b].get(), &cluster, warps[w].get(), slots.data() + w * 32,
                             nullptr}};
        if (pthread_create(&ths[b * NTHREADS + t], &attr, fb_thread, &ta)) {
          perror("pthread");
          abort();
        }
      }
    for (auto& th : ths) pthread_join(th, nullptr);
  }
  return 0;
}
}
