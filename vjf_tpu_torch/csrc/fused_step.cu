// The whole VJF filter-then-learn step as CUDA device functions (phase 1
// step_forward_sums, phase 2 step_apply), with three launchers (and a
// sampler probe), for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of vjf_tpu/ops/pallas/fused_step.py:
//   * vjf_fused_step  <- fused_step_call (:1104, body _make_kernel :1027):
//     one step, NS_ITERS = 3 Newton-Schulz iterations, no tau ceiling; also
//     writes g_vec, xt, xs for the exact-inverse fallback that follows it.
//   * vjf_mega_epoch  <- mega_epoch_call (:1767, body _make_mega_kernel
//     :1632): T steps in one launch. The TPU's sequential grid over time
//     becomes a loop over t inside the block; the base iterations, the
//     escalation (+1 at tau >= 0.05, +2 more at tau >= 0.25) and the skip at
//     tau >= 0.7 follow the TPU kernel.
//   * vjf_forward_sums <- forward_sums_call (:1437, call :1544): phase 1
//     of the exact-sync sharded step alone, on one rank's trials, every
//     batch mean scaled by the GLOBAL 1/B. It writes the flat FusedSums
//     buffer (the layout of ops/fused_step.py:pack_sums, so one all-reduce
//     sums it across ranks) and the q pack, and updates no carry leaf.
//   * philox_pair replaces _box_muller/_box_muller_latents (:997, :1013):
//     a hand-written Philox4x32-10 with the mapping documented in
//     vjf_tpu_torch/ops/rng.py (the plain version), bit for bit.
//
// What bounds it on this card: at the flagship shape (B 256, ydim 200,
// xdim 10, nfp 128, hidden 32) a step is about 20 M multiply-adds, of which
// the Newton-Schulz products (2 x 128^3 per iteration), F V and F^T F are
// most; steps are serial in time. This first version runs the whole segment
// in ONE persistent thread block of 512 threads, so at best it reaches the
// FP32 rate of a single SM (about 1/132 of the card). It reaches far less:
// measured on an H100 SXM at 700 W, a mega step takes about 1.0 ms, and a
// 128^3 product runs at about 24 of the SM's 128 FMA per clock. The tile
// loop below loads each 16-deep slice from L2 with no double buffering, so
// it waits on L2 latency; the skinny products (N = xdim = 10 in a 64-wide
// tile) leave most of each tile idle, and they make the backward pass about
// 30% of a step.
//
// vjf_forward_sums is phase 1 of that step: at the flagship shape about
// 15 M multiply-adds (F V and F^T F are 8 M of them) on about 0.5 MB of
// inputs and outputs, so the card could finish it in well under a
// microsecond; it runs in the same one-block design and product loop, so the
// same latency bounds it. This first version keeps that design on purpose:
// it is the same device function the fused kernels run, so the sharded path
// computes exactly what the single-device one does. Spreading one step over
// many SMs (a block per tile of F V, F^T F and the first layer, the trial
// sums reduced in a second pass or by the all-reduce itself) is later work.
//
// Carry layout: every carry leaf stays where PyTorch allocated it and is
// updated in place; per-step intermediates live in one workspace the
// wrapper allocates (about 1 MB at the flagship shape). Both stay resident
// in the 50 MB L2. Shared memory holds only the tiles of the product being
// computed and the reduction scratch; __syncthreads() separates phases.
// Later work: a thread-block cluster with distributed shared memory holding
// P and V, a cooperative grid, or wgmma for the 128^3 Newton-Schulz
// products.
//
// Numerics: products marked bf16 (activations, gradients, statistics when
// matmul_dtype='bfloat16') round their inputs to bf16 with
// __float2bfloat16 (round to nearest even) and accumulate in f32; the
// feedback chain (P w, every Newton-Schulz product, V g, the RBF cross
// term) stays full f32. No fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define NTHREADS 512
#define NWARPS (NTHREADS / 32)
#define BM 64
#define BN 64
#define BK 16
#define MAX_LAYERS 3

#define NS_ITERS 3
#define NS_TAU_THRESHOLD 0.25f
#define NS_TAU_MAX 0.7f
#define NS_EXTRA_ITERS 2
#define NS_TAU_ESCALATE 0.05f
#define N_SUM_SCALARS 9  // scalar leaves of FusedSums

// Must match vjf_tpu_torch/ops/fused_step.py:_Args field for field.
struct VJFArgs {
  // carry (updated in place)
  float* w_in_y;
  float* w_in_u;
  float* w_in_m;
  float* w_in_lv;
  float* w_hidden[MAX_LAYERS - 1];
  float* b_hidden[MAX_LAYERS];
  float* w_mean;
  float* w_logvar;
  float* b_logvar;
  float* w_dec;
  float* b_dec;
  float* cent_x;
  float* cent_u;
  float* c2;
  float* inv_w2;
  float* p_mat;
  float* v_mat;
  float* w_dyn;
  float* state_logvar;
  float* lik_logvar;
  float* dyn_n;
  float* lik_n;
  int* rng_seed;
  int* rng_count;
  // data
  const float* qs_m;   // (B, xd) posterior entering step 0
  const float* qs_lv;
  const float* y;      // (T, B, yd)
  const float* u;      // (T, B, ud) or null
  const float* eps_s;  // (T, B, xd) or null: in-kernel Philox
  const float* eps_t;
  const float* lr;     // (1,)
  // outputs
  float* q_pack;       // (T, 2, B, xd)
  float* scal;         // (T, 8)
  float* g_vec;        // (nfp, xd) or null (workspace)
  float* xt;           // (B, xd) or null (workspace)
  float* xs;
  float* sums;         // flat FusedSums (vjf_sums_floats() floats) or null
  float* ws;           // vjf_workspace_floats() floats
  // dims
  int T, B, yd, ud, xd, nfp, nf, n_layers;
  int h[MAX_LAYERS];
  // flags
  int sgd, update, warm_up, train_decoder, update_likelihood, update_transition;
  int poisson, trace_quirk, bf16, mega, ns_iters;
  int row0;            // first row of these trials in the whole batch (noise)
  // constants
  float leak, poisson_clamp, logvar_clamp, clip, rls_shrink, chol_jitter;
  float obs_var_cap, state_var_cap;
  float inv_b;         // phase-1 kernel only: the GLOBAL 1/B
};

// Workspace carve-up, shared by the host (size) and the device (pointers).
struct WS {
  float *eps, *xs, *xt, *x2, *feat, *z, *fvf, *ptlv, *pt_m;
  float* hs[MAX_LAYERS];
  float *raw, *py, *g_xt, *g_qm, *g_qlv, *dx, *tmp, *g_h, *g_a;
  float *g_w_in_y, *g_w_in_u, *g_w_in_m, *g_w_in_lv;
  float* g_w_hidden[MAX_LAYERS - 1];
  float* g_b_hidden[MAX_LAYERS];
  float *g_wm, *g_wlv, *g_blv, *g_w_dec, *g_b_dec;
  float *ftf, *fxd, *g_vec, *p_new, *ns_a, *ns_b, *ns_t, *w_new;
  size_t total;
};

struct Carver {
  float* base;
  size_t off;
  size_t align;  // in floats
  __host__ __device__ float* take(size_t n) {
    float* p = base ? base + off : nullptr;
    off += (n + align - 1) / align * align;
    return p;
  }
};

__host__ __device__ static WS carve(const VJFArgs& a, float* base) {
  WS w;
  Carver cv{base, 0, 32};  // 128-byte aligned buffers
  const size_t B = a.B, xd = a.xd, nfp = a.nfp, yd = a.yd;
  int hmax = 0;
  for (int i = 0; i < a.n_layers; ++i) hmax = a.h[i] > hmax ? a.h[i] : hmax;
  const int hl = a.h[a.n_layers - 1];
  w.eps = cv.take(B * 2 * xd);
  w.xs = cv.take(B * xd);
  w.xt = cv.take(B * xd);
  w.x2 = cv.take(B);
  w.feat = cv.take(B * nfp);
  w.z = cv.take(B * nfp);
  w.fvf = cv.take(B);
  w.ptlv = cv.take(B);
  w.pt_m = cv.take(B * xd);
  for (int i = 0; i < MAX_LAYERS; ++i) w.hs[i] = i < a.n_layers ? cv.take(B * a.h[i]) : nullptr;
  w.raw = cv.take(B * xd);
  w.py = cv.take(B * yd);
  w.g_xt = cv.take(B * xd);
  w.g_qm = cv.take(B * xd);
  w.g_qlv = cv.take(B * xd);
  w.dx = cv.take(B * xd);
  w.tmp = cv.take(B * xd);
  w.g_h = cv.take(B * hmax);
  w.g_a = cv.take(B * hmax);
  w.g_w_in_y = cv.take((size_t)a.h[0] * yd);
  w.g_w_in_u = cv.take((size_t)a.h[0] * (a.ud > 0 ? a.ud : 1));
  w.g_w_in_m = cv.take((size_t)a.h[0] * xd);
  w.g_w_in_lv = cv.take((size_t)a.h[0] * xd);
  for (int i = 0; i < MAX_LAYERS - 1; ++i)
    w.g_w_hidden[i] = i + 1 < a.n_layers ? cv.take((size_t)a.h[i + 1] * a.h[i]) : nullptr;
  for (int i = 0; i < MAX_LAYERS; ++i) w.g_b_hidden[i] = i < a.n_layers ? cv.take(a.h[i]) : nullptr;
  w.g_wm = cv.take(xd * hl);
  w.g_wlv = cv.take(xd * hl);
  w.g_blv = cv.take(xd);
  w.g_w_dec = cv.take(yd * xd);
  w.g_b_dec = cv.take(yd);
  w.ftf = cv.take(nfp * nfp);
  w.fxd = cv.take(nfp * xd);
  w.g_vec = cv.take(nfp * xd);
  w.p_new = cv.take(nfp * nfp);
  w.ns_a = cv.take(nfp * nfp);
  w.ns_b = cv.take(nfp * nfp);
  w.ns_t = cv.take(nfp * nfp);
  w.w_new = cv.take(nfp * xd);
  w.total = cv.off;
  return w;
}

// Points w's gradient sums and F^T F, F^T dx into the flat FusedSums buffer
// f, packed in pack_sums's order (ops/fused_step.py: the array leaves in
// field order, then N_SUM_SCALARS scalars); returns its length in floats.
// f == nullptr only counts.
__host__ __device__ static size_t point_sums(const VJFArgs& a, WS& w, float* f) {
  Carver cv{f, 0, 1};
  const size_t xd = a.xd, nfp = a.nfp, yd = a.yd, h0 = a.h[0], hl = a.h[a.n_layers - 1];
  w.g_w_in_y = cv.take(h0 * yd);
  if (a.ud > 0) w.g_w_in_u = cv.take(h0 * a.ud);
  w.g_w_in_m = cv.take(h0 * xd);
  w.g_w_in_lv = cv.take(h0 * xd);
  for (int i = 0; i + 1 < a.n_layers; ++i) w.g_w_hidden[i] = cv.take((size_t)a.h[i + 1] * a.h[i]);
  for (int i = 0; i < a.n_layers; ++i) w.g_b_hidden[i] = cv.take(a.h[i]);
  w.g_wm = cv.take(xd * hl);
  w.g_wlv = cv.take(xd * hl);
  w.g_blv = cv.take(xd);
  w.g_w_dec = cv.take(yd * xd);
  w.g_b_dec = cv.take(yd);
  w.ftf = cv.take(nfp * nfp);
  w.fxd = cv.take(nfp * xd);
  cv.take(N_SUM_SCALARS);
  return cv.off;
}

struct Smem {
  float As[BK][BM + 4];
  float Bs[BK][BN + 4];
  float red[8 * NWARPS];
};

// ---------------------------------------------------------------------------
// Philox4x32-10 and Box-Muller
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform_u1(uint32_t bits) {
  return (float)(int)(bits >> 8) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
}

__device__ __forceinline__ float uniform_u2(uint32_t bits) {
  return (float)(int)(bits >> 8) * 5.9604644775390625e-08f;
}

__device__ __forceinline__ float box_muller(float u1, float u2) {
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf((float)(2.0 * 3.14159265358979) * u2);
}

// Elements 2j and 2j+1 of the row-major draw of step `count`: one Philox
// call with counter (count, j, 0, 0) and key (seed, 0); element 2j takes
// words 0 and 1, element 2j+1 words 2 and 3.
__device__ __forceinline__ void philox_pair(uint32_t seed, uint32_t count, uint32_t j,
                                            float u1[2], float u2[2]) {
  const uint4 w = philox4x32_10(make_uint4(count, j, 0u, 0u), make_uint2(seed, 0u));
  u1[0] = uniform_u1(w.x);
  u2[0] = uniform_u2(w.y);
  u1[1] = uniform_u1(w.z);
  u2[1] = uniform_u2(w.w);
}

// ---------------------------------------------------------------------------
// Block-level building blocks (every thread of the block calls each one)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// NaN-propagating clamps (jnp.clip / torch.clamp semantics)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Mat {
  const float* p;
  int rs, cs;  // element (i, j) at p[i * rs + j * cs]
};

__device__ __forceinline__ Mat rowmaj(const float* p, int ld) { return Mat{p, ld, 1}; }
__device__ __forceinline__ Mat trans(const float* p, int ld) { return Mat{p, 1, ld}; }

// C (M x N, row-major, leading dim ldc) = alpha * A B + beta * C + diag * I.
// Ends with __syncthreads(). C must not alias A or B.
__device__ void gemm(Smem& sm, int M, int N, int K, Mat A, Mat B, float* C, int ldc,
                     float alpha, float beta, float diag, bool bf16) {
  const int tid = threadIdx.x;
  const int tm = tid % 16, tn = tid / 16;  // 4 rows x 2 cols per thread
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  for (int tile = 0; tile < tiles_m * tiles_n; ++tile) {
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int r = 0; r < (BM * BK) / NTHREADS; ++r) {
        const int e = tid + r * NTHREADS;
        int mm, kk;
        if (A.cs == 1) { mm = e / BK; kk = e % BK; } else { kk = e / BM; mm = e % BM; }
        const int gi = m0 + mm, gk = k0 + kk;
        float v = (gi < M && gk < K) ? A.p[(size_t)gi * A.rs + (size_t)gk * A.cs] : 0.f;
        sm.As[kk][mm] = bf16 ? bf16_round(v) : v;
      }
#pragma unroll
      for (int r = 0; r < (BN * BK) / NTHREADS; ++r) {
        const int e = tid + r * NTHREADS;
        int nn, kk;
        if (B.cs == 1) { kk = e / BN; nn = e % BN; } else { nn = e / BK; kk = e % BK; }
        const int gj = n0 + nn, gk = k0 + kk;
        float v = (gj < N && gk < K) ? B.p[(size_t)gk * B.rs + (size_t)gj * B.cs] : 0.f;
        sm.Bs[kk][nn] = bf16 ? bf16_round(v) : v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&sm.As[kk][tm * 4]);
        const float2 bv = *reinterpret_cast<const float2*>(&sm.Bs[kk][tn * 2]);
        acc[0][0] += av.x * bv.x; acc[0][1] += av.x * bv.y;
        acc[1][0] += av.y * bv.x; acc[1][1] += av.y * bv.y;
        acc[2][0] += av.z * bv.x; acc[2][1] += av.z * bv.y;
        acc[3][0] += av.w * bv.x; acc[3][1] += av.w * bv.y;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int gi = m0 + tm * 4 + i, gj = n0 + tn * 2 + j;
        if (gi < M && gj < N) {
          float* c = C + (size_t)gi * ldc + gj;
          float v = alpha * acc[i][j];
          if (beta != 0.f) v += beta * *c;
          if (gi == gj) v += diag;
          *c = v;
        }
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums N per-thread values over the block; every thread gets the totals.
template <int N>
__device__ void block_sum(Smem& sm, float (&v)[N]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float s = warp_sum(v[i]);
    if (lane == 0) sm.red[i * NWARPS + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += sm.red[i * NWARPS + w];
    v[i] = s;
  }
  __syncthreads();
}

// Column sums of an (rows x cols) row-major matrix into out (cols).
__device__ void col_sum(const float* x, int rows, int cols, float* out) {
  for (int j = threadIdx.x; j < cols; j += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += x[(size_t)r * cols + j];
    out[j] = s;
  }
}

__device__ __forceinline__ float sum_of(const float* x, int n) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += NTHREADS) s += x[i];
  return s;
}

__device__ __forceinline__ void sgd_update(float* p, const float* g, int n, float lr,
                                           float clip) {
  for (int i = threadIdx.x; i < n; i += NTHREADS) p[i] = p[i] - lr * clampf(g[i], -clip, clip);
}

__device__ __forceinline__ void copy(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += NTHREADS) dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// One step: step_forward_sums + step_apply (fused_step.py:294, :600)
// ---------------------------------------------------------------------------

// Pointers and carry scalars of step t. The scalars are read here, before
// phase 1's barriers: thread 0 writes lik_logvar and lik_n in step_apply
// with no barrier between the start of that phase and the write.
struct StepIO {
  const float *y, *u, *qs_m, *qs_lv, *eps_s, *eps_t;
  float *qt_m, *qt_lv, *xs, *xt, *g_vec;
  int eps_ld;
  float slv, lik_lv, dyn_n0, lik_n0;
};

// The scalar leaves of FusedSums, in pack_sums's order (N_SUM_SCALARS).
struct StepSums {
  float g_lik_lv_batch, recon_batch, dyn_batch, ent, sq_y, grad_check, fvf_sum, dx_sum,
      dx2_sum;
};

// Step t's pointers, and its noise drawn into the workspace unless it is
// given. Rows [a.row0, a.row0 + B) of the whole batch's draw.
__device__ StepIO step_io(const VJFArgs& a, const WS& w, int t, uint32_t seed,
                          uint32_t count) {
  const int B = a.B, yd = a.yd, ud = a.ud, xd = a.xd;
  StepIO s;
  s.y = a.y + (size_t)t * B * yd;
  s.u = ud > 0 ? a.u + (size_t)t * B * ud : nullptr;
  s.qs_m = t == 0 ? a.qs_m : a.q_pack + (size_t)(t - 1) * 2 * B * xd;
  s.qs_lv = t == 0 ? a.qs_lv : s.qs_m + (size_t)B * xd;
  s.qt_m = a.q_pack + (size_t)t * 2 * B * xd;
  s.qt_lv = s.qt_m + (size_t)B * xd;
  s.xs = a.xs ? a.xs : w.xs;
  s.xt = a.xt ? a.xt : w.xt;
  s.g_vec = a.g_vec ? a.g_vec : w.g_vec;
  if (a.eps_s) {
    s.eps_s = a.eps_s + (size_t)t * B * xd;
    s.eps_t = a.eps_t + (size_t)t * B * xd;
    s.eps_ld = xd;
  } else {
    // the (B, 2 xd) draw: columns [:xd] are eps_s, [xd:] eps_t
    const uint32_t j0 = (uint32_t)a.row0 * (uint32_t)xd;
    for (int j = threadIdx.x; j < B * xd; j += NTHREADS) {
      float u1[2], u2[2];
      philox_pair(seed, count, j0 + (uint32_t)j, u1, u2);
      w.eps[2 * j] = box_muller(u1[0], u2[0]);
      w.eps[2 * j + 1] = box_muller(u1[1], u2[1]);
    }
    s.eps_s = w.eps;
    s.eps_t = w.eps + xd;
    s.eps_ld = 2 * xd;
  }
  s.slv = a.state_logvar[0];
  s.lik_lv = a.lik_logvar[0];
  s.dyn_n0 = a.dyn_n[0];
  s.lik_n0 = a.lik_n[0];
  __syncthreads();
  return s;
}

// Phase 1: forward, ELBO sums, manual backward, RLS raw statistics (F^T F
// and F^T dx only with `stats`) and the gradient check, every batch mean
// scaled by `inv_b` (the GLOBAL 1/B in the sharded step). The gradient
// sums land in w.g_*, F^T F in w.ftf, F^T dx in w.fxd. Updates no carry
// leaf.
__device__ StepSums step_forward_sums(const VJFArgs& a, const WS& w, Smem& sm,
                                      const StepIO& io, float inv_b, bool stats) {
  const int tid = threadIdx.x;
  const int B = a.B, yd = a.yd, ud = a.ud, xd = a.xd, nfp = a.nfp, L = a.n_layers;
  const int h0 = a.h[0], hl = a.h[L - 1];
  const bool bf = a.bf16 != 0;
  const bool rls = a.update && a.update_transition;
  const float *y = io.y, *u = io.u, *qs_m = io.qs_m, *qs_lv = io.qs_lv;
  const float *eps_s = io.eps_s, *eps_t = io.eps_t;
  const int eps_ld = io.eps_ld;
  float *qt_m = io.qt_m, *qt_lv = io.qt_lv, *xs = io.xs, *xt = io.xt;
  const float slv = io.slv, lik_lv = io.lik_lv;

  // ---------------- forward ----------------
  for (int i = tid; i < B * xd; i += NTHREADS) {
    const int b = i / xd, k = i % xd;
    xs[i] = qs_m[i] + eps_s[b * eps_ld + k] * expf(0.5f * qs_lv[i]);
  }
  __syncthreads();
  for (int b = tid; b < B; b += NTHREADS) {
    float s = 0.f;
    for (int k = 0; k < xd; ++k) s += xs[b * xd + k] * xs[b * xd + k];
    if (u) {
      float su = 0.f;
      for (int k = 0; k < ud; ++k) su += u[b * ud + k] * u[b * ud + k];
      s += su;
    }
    w.x2[b] = s;
  }
  __syncthreads();
  // RBF features, cross term in full f32; pad centroids give exact 0
  for (int i = tid; i < B * nfp; i += NTHREADS) {
    const int b = i / nfp, j = i % nfp;
    float cross = 0.f;
    for (int k = 0; k < xd; ++k) cross += xs[b * xd + k] * a.cent_x[j * xd + k];
    if (u) {
      float cu = 0.f;
      for (int k = 0; k < ud; ++k) cu += u[b * ud + k] * a.cent_u[j * ud + k];
      cross += cu;
    }
    float d2 = w.x2[b] + a.c2[j] - 2.0f * cross;
    d2 = d2 < 0.f ? 0.f : d2;
    w.feat[i] = expf(-0.5f * d2 * a.inv_w2[j]);
  }
  __syncthreads();
  gemm(sm, B, nfp, nfp, rowmaj(w.feat, nfp), rowmaj(a.v_mat, nfp), w.z, nfp, 1.f, 0.f, 0.f, bf);
  gemm(sm, B, xd, nfp, rowmaj(w.feat, nfp), rowmaj(a.w_dyn, xd), w.pt_m, xd, 1.f, 0.f, 0.f, bf);
  // first layer, weights split by input segment
  gemm(sm, B, h0, yd, rowmaj(y, yd), trans(a.w_in_y, yd), w.hs[0], h0, 1.f, 0.f, 0.f, bf);
  gemm(sm, B, h0, xd, rowmaj(qs_m, xd), trans(a.w_in_m, xd), w.hs[0], h0, 1.f, 1.f, 0.f, bf);
  gemm(sm, B, h0, xd, rowmaj(qs_lv, xd), trans(a.w_in_lv, xd), w.hs[0], h0, 1.f, 1.f, 0.f, bf);
  if (u) gemm(sm, B, h0, ud, rowmaj(u, ud), trans(a.w_in_u, ud), w.hs[0], h0, 1.f, 1.f, 0.f, bf);
  for (int b = tid; b < B; b += NTHREADS) {
    float s = 0.f;
    for (int j = 0; j < nfp; ++j) s += w.z[b * nfp + j] * w.feat[b * nfp + j];
    s = s < 1e-30f ? 1e-30f : s;
    w.fvf[b] = s;
    w.ptlv[b] = logf(s);
  }
  for (int i = tid; i < B * h0; i += NTHREADS)
    w.hs[0][i] = tanhf(w.hs[0][i] + a.b_hidden[0][i % h0]);
  __syncthreads();
  for (int l = 1; l < L; ++l) {
    const int hi = a.h[l], hp = a.h[l - 1];
    gemm(sm, B, hi, hp, rowmaj(w.hs[l - 1], hp), trans(a.w_hidden[l - 1], hp), w.hs[l], hi,
         1.f, 0.f, 0.f, bf);
    for (int i = tid; i < B * hi; i += NTHREADS)
      w.hs[l][i] = tanhf(w.hs[l][i] + a.b_hidden[l][i % hi]);
    __syncthreads();
  }
  const float* h_last = w.hs[L - 1];
  gemm(sm, B, xd, hl, rowmaj(h_last, hl), trans(a.w_mean, hl), qt_m, xd, 1.f, 0.f, 0.f, bf);
  gemm(sm, B, xd, hl, rowmaj(h_last, hl), trans(a.w_logvar, hl), w.raw, xd, 1.f, 0.f, 0.f, bf);
  for (int i = tid; i < B * xd; i += NTHREADS) {
    const int b = i / xd, k = i % xd;
    const float raw = w.raw[i] + a.b_logvar[k];
    w.raw[i] = raw;
    const float lv = clampf(raw, -a.logvar_clamp, a.logvar_clamp);
    qt_lv[i] = lv;
    xt[i] = qt_m[i] + eps_t[b * eps_ld + k] * expf(0.5f * lv);
    w.pt_m[i] = (1.0f - a.leak) * xs[i] + w.pt_m[i];
  }
  __syncthreads();
  gemm(sm, B, yd, xd, rowmaj(xt, xd), trans(a.w_dec, xd), w.py, yd, 1.f, 0.f, 0.f, bf);
  for (int i = tid; i < B * yd; i += NTHREADS) w.py[i] += a.b_dec[i % yd];
  __syncthreads();

  // ---------------- ELBO batch sums (+ the likelihood gradient) ----------------
  // sums: 0 nll or squared residual, 1 diff^2, 2 trace, 3 qt_lv, 4 dx, 5 dx^2, 6 fvf
  float s[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float inv_sv = expf(-slv);
  for (int i = tid; i < B * yd; i += NTHREADS) {
    const float py = w.py[i], yv = y[i];
    float g;
    if (a.poisson) {
      const float pyc = py > a.poisson_clamp ? a.poisson_clamp : py;
      const float e = expf(pyc);
      s[0] += e - yv * pyc;
      g = (e - yv) * (py < a.poisson_clamp ? 1.f : 0.f) * inv_b;
    } else {
      const float r = yv - py;
      s[0] += r * r;
      g = -r * expf(-lik_lv) * inv_b;
    }
    if (a.sgd) w.py[i] = g;  // py becomes g_py
  }
  for (int i = tid; i < B * xd; i += NTHREADS) {
    const int b = i / xd;
    const float diff = w.pt_m[i] - qt_m[i];
    s[1] += diff * diff;
    s[2] += a.trace_quirk ? expf(w.ptlv[b] + qt_lv[i] - slv)
                          : expf(w.ptlv[b] - slv) + expf(qt_lv[i] - slv);
    s[3] += qt_lv[i];
    const float dx = xt[i] - xs[i];
    w.dx[i] = dx;
    s[4] += dx;
    s[5] += dx * dx;
  }
  for (int b = tid; b < B; b += NTHREADS) s[6] += w.fvf[b];
  block_sum<7>(sm, s);
  StepSums r;
  r.recon_batch = a.poisson ? s[0] * inv_b : 0.f;
  r.sq_y = a.poisson ? 0.f : s[0];
  r.dyn_batch = s[1] * inv_sv * inv_b + s[2] * inv_b;
  r.ent = 0.5f * s[3] * inv_b;
  r.dx_sum = rls ? s[4] : 0.f;
  r.dx2_sum = rls ? s[5] : 0.f;
  r.fvf_sum = rls ? s[6] : 0.f;
  r.g_lik_lv_batch = a.sgd && !a.poisson ? -0.5f * r.sq_y * expf(-lik_lv) * inv_b : 0.f;

  // ---------------- manual backward (gradient batch-sums) ----------------
  const float* g_py = w.py;
  if (a.sgd) {
    gemm(sm, B, xd, yd, rowmaj(g_py, yd), rowmaj(a.w_dec, xd), w.g_xt, xd, 1.f, 0.f, 0.f, bf);
    if (a.train_decoder) {
      gemm(sm, yd, xd, B, trans(g_py, yd), rowmaj(xt, xd), w.g_w_dec, xd, 1.f, 0.f, 0.f, bf);
      col_sum(g_py, B, yd, w.g_b_dec);
    }
    for (int i = tid; i < B * xd; i += NTHREADS) {
      const int b = i / xd, k = i % xd;
      const float lv = qt_lv[i];
      const float gx = w.g_xt[i];
      float gm = gx;
      float glv = gx * eps_t[b * eps_ld + k] * (0.5f * expf(0.5f * lv)) - 0.5f * inv_b;
      if (!a.warm_up) {
        gm = gm - (w.pt_m[i] - qt_m[i]) * (inv_sv * inv_b);
        if (a.trace_quirk)
          glv = glv + 0.5f * expf(w.ptlv[b] + lv - slv) * inv_b;
        else
          glv = glv + 0.5f * expf(lv - slv) * inv_b;
      }
      glv = glv * (fabsf(w.raw[i]) < a.logvar_clamp ? 1.f : 0.f);
      w.g_qm[i] = gm;
      w.g_qlv[i] = glv;
    }
    __syncthreads();
    gemm(sm, xd, hl, B, trans(w.g_qm, xd), rowmaj(h_last, hl), w.g_wm, hl, 1.f, 0.f, 0.f, bf);
    gemm(sm, xd, hl, B, trans(w.g_qlv, xd), rowmaj(h_last, hl), w.g_wlv, hl, 1.f, 0.f, 0.f, bf);
    gemm(sm, B, hl, xd, rowmaj(w.g_qm, xd), rowmaj(a.w_mean, hl), w.g_h, hl, 1.f, 0.f, 0.f, bf);
    gemm(sm, B, hl, xd, rowmaj(w.g_qlv, xd), rowmaj(a.w_logvar, hl), w.g_h, hl, 1.f, 1.f, 0.f, bf);
    col_sum(w.g_qlv, B, xd, w.g_blv);
    for (int l = L - 1; l >= 1; --l) {  // layers n..1
      const int hi = a.h[l], hp = a.h[l - 1];
      for (int i = tid; i < B * hi; i += NTHREADS) {
        const float hv = w.hs[l][i];
        w.g_a[i] = w.g_h[i] * (1.0f - hv * hv);
      }
      __syncthreads();
      gemm(sm, hi, hp, B, trans(w.g_a, hi), rowmaj(w.hs[l - 1], hp), w.g_w_hidden[l - 1], hp,
           1.f, 0.f, 0.f, bf);
      col_sum(w.g_a, B, hi, w.g_b_hidden[l]);
      gemm(sm, B, hp, hi, rowmaj(w.g_a, hi), rowmaj(a.w_hidden[l - 1], hp), w.g_h, hp, 1.f, 0.f,
           0.f, bf);
    }
    for (int i = tid; i < B * h0; i += NTHREADS) {
      const float hv = w.hs[0][i];
      w.g_a[i] = w.g_h[i] * (1.0f - hv * hv);
    }
    __syncthreads();
    col_sum(w.g_a, B, h0, w.g_b_hidden[0]);
    if (u) gemm(sm, h0, ud, B, trans(w.g_a, h0), rowmaj(u, ud), w.g_w_in_u, ud, 1.f, 0.f, 0.f, bf);
    gemm(sm, h0, yd, B, trans(w.g_a, h0), rowmaj(y, yd), w.g_w_in_y, yd, 1.f, 0.f, 0.f, bf);
    gemm(sm, h0, xd, B, trans(w.g_a, h0), rowmaj(qs_m, xd), w.g_w_in_m, xd, 1.f, 0.f, 0.f, bf);
    gemm(sm, h0, xd, B, trans(w.g_a, h0), rowmaj(qs_lv, xd), w.g_w_in_lv, xd, 1.f, 0.f, 0.f, bf);
  }

  // ---------------- RLS raw statistics ----------------
  if (stats) {
    gemm(sm, nfp, nfp, B, trans(w.feat, nfp), rowmaj(w.feat, nfp), w.ftf, nfp, 1.f, 0.f, 0.f, bf);
    gemm(sm, nfp, xd, B, trans(w.feat, nfp), rowmaj(w.dx, xd), w.fxd, xd, 1.f, 0.f, 0.f, bf);
  }

  // grad_check: the sum of every gradient entry is finite iff each one is
  float gc[1] = {0.f};
  if (a.sgd) {
    float v = sum_of(w.g_w_in_y, h0 * yd) + sum_of(w.g_w_in_m, h0 * xd) +
              sum_of(w.g_w_in_lv, h0 * xd) + sum_of(w.g_wm, xd * hl) +
              sum_of(w.g_wlv, xd * hl) + sum_of(w.g_blv, xd);
    if (a.train_decoder) v += sum_of(w.g_w_dec, yd * xd) + sum_of(w.g_b_dec, yd);
    if (u) v += sum_of(w.g_w_in_u, h0 * ud);
    for (int l = 1; l < L; ++l) v += sum_of(w.g_w_hidden[l - 1], a.h[l] * a.h[l - 1]);
    for (int l = 0; l < L; ++l) v += sum_of(w.g_b_hidden[l], a.h[l]);
    gc[0] = v;
  }
  block_sum<1>(sm, gc);
  r.grad_check = a.sgd ? gc[0] + r.g_lik_lv_batch : 0.f;
  return r;
}

// Phase 2 on one device: the ELBO with its constants, clipped SGD, the
// obs-noise running variance, RLS with Newton-Schulz tracking of V and the
// state-noise running variance, all in place; then the scalar row of step t.
// `inv_b` is 1/B.
__device__ void step_apply(const VJFArgs& a, const WS& w, Smem& sm, const StepIO& io,
                           const StepSums& p, int t, float inv_b) {
  const int tid = threadIdx.x;
  const int B = a.B, yd = a.yd, ud = a.ud, xd = a.xd, nfp = a.nfp, L = a.n_layers;
  const int h0 = a.h[0], hl = a.h[L - 1];
  const bool bf = a.bf16 != 0;
  const bool rls = a.update && a.update_transition;
  const float slv = io.slv, lik_lv = io.lik_lv;
  const float lr = a.lr[0];
  float* g_vec = io.g_vec;

  bool sgd_ok = false;
  float l_recon, l_dyn, h_ent, loss;
  {
    // ---------------- ELBO components with their constants ----------------
    float obs_mse = 0.f;
    if (a.poisson) {
      l_recon = p.recon_batch;
    } else {
      l_recon = 0.5f * (p.sq_y * expf(-lik_lv) * inv_b + (float)yd * lik_lv);
      obs_mse = p.sq_y * inv_b / (float)yd;
    }
    l_dyn = 0.5f * (p.dyn_batch + (float)xd * slv);
    h_ent = p.ent;
    bool raw_ok = isfinite(l_recon) && isfinite(h_ent);
    if (!a.warm_up) raw_ok = raw_ok && isfinite(l_dyn);
    l_recon = isfinite(l_recon) ? l_recon : 0.f;
    l_dyn = isfinite(l_dyn) ? l_dyn : 0.f;
    h_ent = isfinite(h_ent) ? h_ent : 0.f;
    loss = l_recon - h_ent + (a.warm_up ? 0.f : l_dyn);

    // ---------------- clipped SGD ----------------
    float lik_lv_new = lik_lv;
    if (a.sgd) {
      sgd_ok = raw_ok && isfinite(p.grad_check);
      if (sgd_ok) {
        const float c = a.clip;
        sgd_update(a.w_in_y, w.g_w_in_y, h0 * yd, lr, c);
        if (io.u) sgd_update(a.w_in_u, w.g_w_in_u, h0 * ud, lr, c);
        sgd_update(a.w_in_m, w.g_w_in_m, h0 * xd, lr, c);
        sgd_update(a.w_in_lv, w.g_w_in_lv, h0 * xd, lr, c);
        for (int l = 1; l < L; ++l)
          sgd_update(a.w_hidden[l - 1], w.g_w_hidden[l - 1], a.h[l] * a.h[l - 1], lr, c);
        for (int l = 0; l < L; ++l) sgd_update(a.b_hidden[l], w.g_b_hidden[l], a.h[l], lr, c);
        sgd_update(a.w_mean, w.g_wm, xd * hl, lr, c);
        sgd_update(a.w_logvar, w.g_wlv, xd * hl, lr, c);
        sgd_update(a.b_logvar, w.g_blv, xd, lr, c);
        if (a.train_decoder) {
          sgd_update(a.w_dec, w.g_w_dec, yd * xd, lr, c);
          sgd_update(a.b_dec, w.g_b_dec, yd, lr, c);
        }
        if (!a.poisson)
          lik_lv_new = lik_lv - lr * clampf(p.g_lik_lv_batch + 0.5f * (float)yd, -c, c);
      }
    }

    // ---------------- obs-noise running variance (Gaussian) ----------------
    float lik_n_new = io.lik_n0;
    if (a.update && !a.poisson && a.update_likelihood) {
      const float n = io.lik_n0 < a.obs_var_cap ? io.lik_n0 : a.obs_var_cap;
      const float tot = n + (float)B;
      const float var = (n / tot) * expf(lik_lv_new) + ((float)B / tot) * obs_mse;
      if (isfinite(var)) {
        lik_lv_new = clampf(logf(var), -a.logvar_clamp, a.logvar_clamp);
        lik_n_new = tot;
      }
    }
    if (tid == 0) {
      a.lik_logvar[0] = lik_lv_new;
      a.lik_n[0] = lik_n_new;
    }
  }

  // ---------------- RLS with Newton-Schulz tracking of V ----------------
  float tau = 0.f;
  if (rls) {
    const bool dyn_ok = isfinite(p.dx_sum);
    if (!a.warm_up) {
      const float lam = a.rls_shrink, jit = a.chol_jitter;
      const float inv_sv_u = expf(-slv);
      for (int i = tid; i < nfp * xd; i += NTHREADS) g_vec[i] = w.fxd[i] * inv_sv_u;
      for (int i = tid; i < nfp * nfp; i += NTHREADS) {
        const int r = i / nfp, c = i % nfp;
        float pv = lam * a.p_mat[i] + w.ftf[i] * inv_sv_u;
        if (lam != 1.0f || jit != 0.0f) {
          const float dg = r == c ? 1.f : 0.f;
          const float pad = r >= a.nf ? dg : 0.f;
          pv = pv + (1.0f - lam) * pad + jit * (dg - pad);
        }
        w.p_new[i] = pv;
      }
      __syncthreads();
      // g = lam P w + F^T dx / sv, full f32
      gemm(sm, nfp, xd, nfp, rowmaj(a.p_mat, nfp), rowmaj(a.w_dyn, xd), g_vec, xd, lam, 1.f, 0.f,
           false);
      tau = p.fvf_sum * inv_sv_u / lam;
      // the mega segment skips the update at tau >= NS_TAU_MAX, so its
      // Newton-Schulz result would be discarded
      bool ns_ok = !(a.mega && !(tau < NS_TAU_MAX));
      if (ns_ok) {
        const float* x = a.v_mat;
        if (lam != 1.0f) {
          for (int i = tid; i < nfp * nfp; i += NTHREADS) w.ns_a[i] = a.v_mat[i] / lam;
          __syncthreads();
          x = w.ns_a;
        }
        int iters = a.ns_iters;
        if (a.mega) {
          if (tau >= NS_TAU_ESCALATE) iters += 1;
          if (tau >= NS_TAU_THRESHOLD) iters += NS_EXTRA_ITERS;
        }
        for (int it = 0; it < iters; ++it) {
          // X <- X (2I - P X), every product full f32
          gemm(sm, nfp, nfp, nfp, rowmaj(w.p_new, nfp), rowmaj(x, nfp), w.ns_t, nfp, -1.f, 0.f,
               2.f, false);
          float* nx = (x == w.ns_a) ? w.ns_b : w.ns_a;
          gemm(sm, nfp, nfp, nfp, rowmaj(x, nfp), rowmaj(w.ns_t, nfp), nx, nfp, 1.f, 0.f, 0.f,
               false);
          x = nx;
        }
        float* v_new = w.ns_t;
        for (int i = tid; i < nfp * nfp; i += NTHREADS) {
          const int r = i / nfp, c = i % nfp;
          v_new[i] = 0.5f * (x[i] + x[c * nfp + r]);
        }
        __syncthreads();
        gemm(sm, nfp, xd, nfp, rowmaj(v_new, nfp), rowmaj(g_vec, xd), w.w_new, xd, 1.f, 0.f, 0.f,
             false);
        float fs[1] = {sum_of(v_new, nfp * nfp) + sum_of(w.w_new, nfp * xd)};
        block_sum<1>(sm, fs);
        ns_ok = isfinite(fs[0]);
        if (a.mega) ns_ok = ns_ok && (tau < NS_TAU_MAX);
      }
      const bool upd_ok = dyn_ok && ns_ok;
      const bool p_keep = a.mega ? upd_ok : dyn_ok;
      if (p_keep) copy(a.p_mat, w.p_new, nfp * nfp);
      if (upd_ok) {
        copy(a.v_mat, w.ns_t, nfp * nfp);
        copy(a.w_dyn, w.w_new, nfp * xd);
      }
      tau = dyn_ok ? (ns_ok ? tau : __int_as_float(0x7f800000)) : 0.f;
      __syncthreads();
    }
    // state-noise running variance from the post-update residual
    gemm(sm, B, xd, nfp, rowmaj(w.feat, nfp), rowmaj(a.w_dyn, xd), w.tmp, xd, 1.f, 0.f, 0.f, bf);
    float ms[1] = {0.f};
    for (int i = tid; i < B * xd; i += NTHREADS) {
      const float r = w.dx[i] - w.tmp[i];
      ms[0] += r * r;
    }
    block_sum<1>(sm, ms);
    const float mse = ms[0] / (float)(B * xd);
    const float n = io.dyn_n0 < a.state_var_cap ? io.dyn_n0 : a.state_var_cap;
    const float tot = n + (float)B;
    const float var = (n / tot) * expf(slv) + ((float)B / tot) * mse;
    if (tid == 0 && isfinite(var)) {
      a.state_logvar[0] = clampf(logf(var), -a.logvar_clamp, a.logvar_clamp);
      a.dyn_n[0] = tot;
    }
  }
  if (!(rls && !a.warm_up)) {
    for (int i = tid; i < nfp * xd; i += NTHREADS) g_vec[i] = 0.f;  // no RLS target
  }

  if (tid == 0) {
    float* row = a.scal + (size_t)t * 8;
    row[0] = loss;
    row[1] = -l_recon;
    row[2] = -l_dyn;
    row[3] = h_ent;
    row[4] = tau;
    row[5] = row[6] = row[7] = 0.f;
  }
  __syncthreads();
}

__device__ void vjf_step(const VJFArgs& a, const WS& w, Smem& sm, int t, uint32_t seed,
                         uint32_t count) {
  const float inv_b = 1.0f / (float)a.B;
  const StepIO io = step_io(a, w, t, seed, count);
  const bool stats = a.update && a.update_transition && !a.warm_up;
  const StepSums p = step_forward_sums(a, w, sm, io, inv_b, stats);
  step_apply(a, w, sm, io, p, t, inv_b);
}

__global__ void __launch_bounds__(NTHREADS, 1) vjf_kernel(VJFArgs a) {
  __shared__ __align__(16) Smem sm;
  const WS w = carve(a, a.ws);
  const uint32_t seed = (uint32_t)a.rng_seed[0];
  const uint32_t count0 = (uint32_t)a.rng_count[0];
  for (int t = 0; t < a.T; ++t) vjf_step(a, w, sm, t, seed, count0 + (uint32_t)t);
  if (threadIdx.x == 0) a.rng_count[0] = (int)(count0 + (uint32_t)a.T);
}

// Phase 1 of the sharded step alone (forward_sums_call): the flat FusedSums
// buffer and the q pack of this rank's B trials, with the caller's global
// inv_b and row offset of the noise. Reads the carry, writes none of it.
__global__ void __launch_bounds__(NTHREADS, 1) vjf_sums_kernel(VJFArgs a) {
  __shared__ __align__(16) Smem sm;
  WS w = carve(a, a.ws);
  const size_t n = point_sums(a, w, a.sums);
  // leaves the flags leave uncomputed (gradients without SGD, the decoder's
  // when it is frozen, the statistics without RLS) are zero
  for (size_t i = threadIdx.x; i < n; i += NTHREADS) a.sums[i] = 0.f;
  const StepIO io = step_io(a, w, 0, (uint32_t)a.rng_seed[0], (uint32_t)a.rng_count[0]);
  const StepSums p = step_forward_sums(a, w, sm, io, a.inv_b, a.update && a.update_transition);
  if (threadIdx.x == 0) {
    float* tail = a.sums + n - N_SUM_SCALARS;
    const float v[N_SUM_SCALARS] = {p.g_lik_lv_batch, p.recon_batch, p.dyn_batch, p.ent,
                                    p.sq_y, p.grad_check, p.fvf_sum, p.dx_sum, p.dx2_sum};
    for (int i = 0; i < N_SUM_SCALARS; ++i) tail[i] = v[i];
  }
}

__global__ void philox_kernel(uint32_t seed, uint32_t count, int n_pairs, float* u1,
                              float* u2, float* eps) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_pairs) return;
  float a1[2], a2[2];
  philox_pair(seed, count, (uint32_t)j, a1, a2);
  for (int e = 0; e < 2; ++e) {
    u1[2 * j + e] = a1[e];
    u2[2 * j + e] = a2[e];
    eps[2 * j + e] = box_muller(a1[e], a2[e]);
  }
}

// ---------------------------------------------------------------------------
// C interface (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

size_t vjf_workspace_floats(const VJFArgs* a) { return carve(*a, nullptr).total; }

size_t vjf_args_size(void) { return sizeof(VJFArgs); }

size_t vjf_sums_floats(const VJFArgs* a) {
  WS w;
  return point_sums(*a, w, nullptr);
}

// The two launchers are the two modes of vjf_kernel; each sets its own.
// One step (fused_step_call): NS_ITERS Newton-Schulz iterations, no
// escalation, no tau ceiling. The caller sets T = 1.
int vjf_fused_step(const VJFArgs* a, void* stream) {
  VJFArgs s = *a;
  s.mega = 0;
  s.ns_iters = NS_ITERS;
  vjf_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(s);
  return (int)cudaGetLastError();
}

// T steps in one launch (mega_epoch_call): the caller's base iterations
// (ns_iters), then the escalation and the NS_TAU_MAX skip.
int vjf_mega_epoch(const VJFArgs* a, void* stream) {
  VJFArgs m = *a;
  m.mega = 1;
  vjf_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(m);
  return (int)cudaGetLastError();
}

// Phase 1 of the sharded step (forward_sums_call): the caller sets T = 1,
// sums, inv_b and row0.
int vjf_forward_sums(const VJFArgs* a, void* stream) {
  vjf_sums_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// The in-kernel sampler alone: (rows, cols) uniforms and normals of one
// step of the stream, rows * cols even.
int vjf_philox_normals(int seed, int count, int rows, int cols, float* u1, float* u2,
                       float* eps, void* stream) {
  const int n_pairs = rows * cols / 2;
  philox_kernel<<<(n_pairs + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (uint32_t)seed, (uint32_t)count, n_pairs, u1, u2, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
