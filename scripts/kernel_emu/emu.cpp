// CPU emulation of vjf_tpu_torch/csrc/fused_step.cu: the kernel file cut
// before its "Kernels and the C interface" section (emu.py writes the cut
// as fused_step_cut.cu), run on pthreads (a thread a CUDA thread, a
// std::barrier each __syncthreads and cluster_sync, cuda_runtime.h and
// vjf_hopper.cuh of this directory for the CUDA and Hopper calls), with the
// C interface that ops/fused_step.py binds. Each launch runs a cluster at a
// time (the members of an ensemble launch one after another), every block
// with MAX_SMEM_BYTES of its own "shared memory", filled with NaN.
#include <pthread.h>
#include <vector>
#include <cstdio>
#include <cstdlib>
#include <limits>
#include "fused_step_cut.cu"

thread_local uint3 threadIdx;
thread_local uint3 blockIdx;
thread_local EmuCtx emu;

struct ThreadArg {
  const VJFArgs* a;
  float* smem;
  int tid, blk, member;
  EmuCtx ctx;
  bool sums, tiled, big;
};

template <bool TILED, bool BIG>
static void body(const ThreadArg& t) {
  if (t.sums) vjf_sums<TILED, BIG>(*t.a, t.smem);
  else vjf_steps<TILED, BIG>(*t.a, t.smem);
}

static void* thread_main(void* p) {
  const ThreadArg& t = *static_cast<ThreadArg*>(p);
  threadIdx = uint3{(unsigned)t.tid, 0, 0};
  blockIdx = uint3{(unsigned)t.blk, (unsigned)t.member, 0};
  emu = t.ctx;
  if (t.big) body<true, true>(t);
  else if (t.tiled) body<true, false>(t);
  else body<false, false>(t);
  return nullptr;
}

static bool one_pass(const VJFArgs& a) {
  return a.sp == 0 && a.tile >= cdiv(a.B, VJF_CLUSTER) && a.kc == a.nfp;
}

static int launch(bool sums, const VJFArgs& args) {
  const VJFArgs a = plan_tiles(args);
  const size_t smem = carve_smem(a, nullptr).total * sizeof(float);
  if (smem > MAX_SMEM_BYTES || a.nfp % 4 != 0) return 1;
  const int members = a.n_members > 1 ? a.n_members : 1;
  for (int m = 0; m < members; ++m) {
    std::barrier<> cluster(NTHREADS * VJF_CLUSTER);
    std::vector<std::unique_ptr<std::barrier<>>> blocks, warps;
    std::vector<float> slots(VJF_CLUSTER * NWARPS * 32);
    std::vector<uint32_t> frags(VJF_CLUSTER * NWARPS * 32 * 6);
    std::vector<float*> mem(VJF_CLUSTER);
    for (int b = 0; b < VJF_CLUSTER; ++b) {
      blocks.emplace_back(new std::barrier<>(NTHREADS));
      mem[b] = static_cast<float*>(aligned_alloc(128, MAX_SMEM_BYTES));
      for (size_t i = 0; i < MAX_SMEM_BYTES / 4; ++i) mem[b][i] = std::numeric_limits<float>::quiet_NaN();
      for (int w = 0; w < NWARPS; ++w) warps.emplace_back(new std::barrier<>(32));
    }
    std::vector<ThreadArg> targs(VJF_CLUSTER * NTHREADS);
    std::vector<pthread_t> ths(targs.size());
    pthread_attr_t attr;
    pthread_attr_init(&attr);
    pthread_attr_setstacksize(&attr, 1 << 20);
    for (int b = 0; b < VJF_CLUSTER; ++b)
      for (int t = 0; t < NTHREADS; ++t) {
        const int w = b * NWARPS + t / 32;
        ThreadArg& ta = targs[b * NTHREADS + t];
        ta = ThreadArg{&a, mem[b], t, b, m,
                       EmuCtx{blocks[b].get(), &cluster, warps[w].get(), slots.data() + w * 32,
                              frags.data() + (size_t)w * 32 * 6},
                       sums, !one_pass(a), a.sp > 0};
        if (pthread_create(&ths[b * NTHREADS + t], &attr, thread_main, &ta)) { perror("pthread"); abort(); }
      }
    for (auto& th : ths) pthread_join(th, nullptr);
    for (auto p : mem) free(p);
  }
  return 0;
}

extern "C" {
size_t vjf_workspace_floats(const VJFArgs* a) { return carve_global(plan_tiles(*a), nullptr).total; }
size_t vjf_args_size(void) { return sizeof(VJFArgs); }
size_t vjf_args_tail(void) { return offsetof(VJFArgs, inv_b); }
size_t vjf_layer_arg_size(void) { return sizeof(LayerArg); }
size_t emu_header_size(void) { return sizeof(Header); }
size_t emu_layer_size(void) { return sizeof(Layer); }
size_t emu_leaf_size(void) { return sizeof(Leaf); }
size_t vjf_sums_floats(const VJFArgs* a) { return sums_offsets(*a).total; }
size_t vjf_smem_bytes(const VJFArgs* a) { return carve_smem(plan_tiles(*a), nullptr).total * sizeof(float); }
size_t vjf_smem_limit(void) { return MAX_SMEM_BYTES; }
int vjf_cluster_info(const VJFArgs* args, int* out) {
  const VJFArgs a = plan_tiles(*args);
  out[0] = VJF_CLUSTER; out[1] = NTHREADS;
  out[2] = (int)(carve_smem(a, nullptr).total * sizeof(float));
  out[3] = 1; out[4] = 0; out[5] = 0;
  out[6] = a.tile; out[7] = a.kc; out[8] = a.sp;
  return 0;
}
int vjf_fused_step(const VJFArgs* a, void*) { VJFArgs s = *a; s.mega = 0; s.ns_iters = NS_ITERS; return launch(false, s); }
int vjf_mega_epoch(const VJFArgs* a, void*) { VJFArgs m = *a; m.mega = 1; return launch(false, m); }
int vjf_forward_sums(const VJFArgs* a, void*) { return launch(true, *a); }
int vjf_philox_normals(int, int, int, int, float*, float*, float*, void*) { return 1; }
}
