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
//     becomes a loop over t inside the kernel; the base iterations, the
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
// What bounds it on this card: steps are serial in time and a step is small
// (about 20 M multiply-adds at the flagship shape: B 256, ydim 200, xdim 10,
// nfp 128, hidden 32), so a step is a chain of some forty short dependent
// phases. Neither bytes nor operations bound it but latency and instructions: how
// long each phase waits for its operands and its barrier, and how many
// load and convert instructions a block of 16 warps spends per tensor-core
// product (measured on an H100 at 700 W: a mega step in about 97 us, of
// which the Newton-Schulz iterations are about 23 and no other phase over 9).
//
// What the design does about it:
//   * One thread-block cluster of VJF_CLUSTER blocks runs the whole segment.
//     Block r owns a contiguous block of the trials (cluster_rows in
//     ops/fused_step.py mirrors the split) and a contiguous panel of the
//     rows of P, V and w. Phase 1 is per trial except for its batch sums, so
//     each block runs it on its own trials with the global 1/B.
//   * What a block keeps from step to step for each of its trials lives in
//     its shared memory: the posterior carried from step to step, the noise,
//     the 0/1 trial mask column, with the RBF constants (loaded once) and the
//     biases (loaded every step). Phase 1 runs over tiles of R of the block's
//     trials (plan_tiles: all of them where that fits, else the largest
//     multiple of 16 that does): a tile's y, u and channel mask, its
//     features, every layer and every xd-wide leaf live in shared memory
//     that phase 2's scratch overlays. y[t+1], u[t+1] and the noise for tile
//     0 are fetched with cp.async while phase 2 of step t runs; with several
//     tiles the inputs have two buffers, and tile k+1's arrive while tile k
//     computes. Batch sums gather tile by tile, in order, into the block's
//     slab; each tile's features and dx go to L2, where the RLS statistics
//     and the post-update residual read them. Each kernel is compiled twice
//     (template TILED): the launch takes the instantiation without the tile
//     and chunk loops where a block's trials are one tile and the panel
//     operand is staged whole. The weights change every step
//     (SGD) and are read from L2 where they live. The arguments and the
//     layouts sit in the head of the shared memory, one copy a block: in
//     the threads' local memory they fell out of L1 and every pointer came
//     from L2.
//   * The products that matmul_dtype='bfloat16' marks (activations,
//     gradients, statistics) run on the tensor cores: mma.sync m16n8k16,
//     operands rounded to bf16 as they are packed into fragments, four
//     16-deep slices of loads in flight, f32 accumulation; a skinny product
//     (N = xdim) pads to 16 columns, not 64. With matmul_dtype='float32' the
//     same products run an f32 loop.
//   * Batch sums are deterministic: each block writes its partial gradient
//     sums in the flat FusedSums order to its own slab in an L2 workspace;
//     after a cluster barrier, block r adds its slice of every slab in rank
//     order and owns the update of that slice (the clipped SGD of those
//     parameters). The scalars that gate a branch are reduced the same way
//     and read by every block in the same order, so every block takes the
//     same branches. The RLS statistics F^T F and F^T dx are not summed from
//     partials (each block's would have all nfp x nfp entries): every block
//     publishes its trials' features and dx through L2, and block r takes
//     its rows of both over all the trials. No floating-point atomics.
//   * The feedback chain stays full f32, no TF32: P w, V g and the
//     Newton-Schulz products run by row panels. Block r stages the
//     right-hand matrix into shared memory with 16-byte cp.async (whole up
//     to 128 padded features; past that in double-buffered chunks of
//     STAGE_ROWS rows), multiplies its panel with 4 x 4 register tiles split
//     over K, and publishes its rows with a cluster barrier (two per
//     iteration). P_new, the iterate and
//     V_new stay in the block's shared memory; the carry's P, V, w rows are
//     overwritten once, after the barrier behind the last reader.
//   * Past a block's shared memory (the L2 route, plan_tiles sets sp; a third
//     instantiation, BIG): every trial's state (posterior, noise, mask
//     column) lives in the L2 workspace and phase 1 reads it there, the trial
//     mask's row is read where it lies, P_new's and V_new's rows live in L2
//     too, and each Newton-Schulz product stages its left operand in
//     sub-panels of sp rows (cp.async) against the whole right-hand matrix
//     (K split for a sub-panel's tiles, not a panel's).
//   * The carry scalars (state and observation log-variance, their counts)
//     are computed by every block from the same reduced sums, kept in
//     registers from step to step, and written once at the end by block 0.
//
// Shapes: any multiple of 128 padded features, any number of hidden layers
// of any width, any number of trials, as long as a block's shared memory
// fits MAX_SMEM_BYTES at the smallest plan (plan_tiles: on the L2 route
// tiles of 4 trials, chunks and sub-panels of 4 rows). Every number of
// trials fits; at the flagship widths up to 1,792 padded features do; only
// an input or a hidden layer far wider than any configuration of the
// repository (a tile's activations and inputs alone), or hundreds of hidden
// layers (each keeps a tile's activations for the backward), do not. The
// hidden layers come as a table (LayerArg) that each block copies into the
// head of its shared memory (make_header).
//
// wgmma is not used: a block's trials (32 at the flagship) are fewer than
// its 64 rows, and it has no f32 input type for the feedback chain.
//
// Sparse-GP dynamics (cfg.dynamics='sgp', the TPU kernels' FusedCarry.w_white
// and scale2, fused_step.py:172-179, :375-392): the same launchers with two
// more operands. The block's unit SE responses at the inducing points are
// multiplied by w_white = scale^2 W (nfp x nfp, read from L2: at 64 KB it
// does not fit beside the block's shared memory) in full f32, through s.z,
// before they feed F V, F w, the RLS statistics and the state-noise
// residual; the predictive log-variance adds the DTC correction
// max(scale^2 - |phi|^2, 0). The whitening adds B nfp^2 multiply-adds a
// step, about as many as F V, and is bound by the latency of its L2 loads
// (whiten_features keeps 16 in flight; measured on an H100 at 700 W, a mega
// step of the SGP flagship takes 105 us against 96 for RBF; loading one row
// of w_white at a time, 158). With w_white null (RBF) nothing changes.
//
// Ragged trials and missing channels (the TPU kernels' variants with
// has_mask and has_cmask, fused_step.py:1027-1063, :1632-1731, :1449-1533):
// the same launchers with a trial mask (T, B) and a channel mask (T, B, yd),
// each null when not given. A block stages its rows of the channel mask and
// the whole row of the trial mask for step t + 1 by cp.async beside y (at
// the flagship, 26,112 + 1,024 bytes more a block). At the start of a step
// the masked entries of y and u are replaced by 0 (select, channel holes
// first: NaN padding never enters), every block counts the valid trials of
// the step in the same order, and the batch means divide by that count (the
// phase-1 kernel takes the caller's global 1 / count instead). A masked trial
// leaves every sum through a 0/1 weight, its feature row is published as 0
// for the RLS statistics, and its posterior is frozen at its last valid value
// (not in the phase-1 kernel, whose caller freezes it). A step with no valid
// trial leaves the loss at 0 and the recursion, the counters and tau where
// they were. A masked channel leaves the likelihood sum and its gradient, and
// the recognition input sees the decoder's prediction from the previous
// posterior there (one more product, nb x yd x xd); the Gaussian noise
// constant and count run over the observed entries. With both masks null
// every weight is 1 and the unmasked kernel's bits are kept.
//
// Ensembles (fit_ensemble; the TPU kernels under jax.vmap over members,
// vjf_tpu/parallel/ensemble.py:115-144): the step and mega launchers take N
// members in one launch, gridDim (VJF_CLUSTER, N), the cluster at blockIdx.y
// = m running member m. At entry each block moves every carry, data and
// output pointer by m times that leaf's per-member size (to_member), except
// for y and u where a SHARED_* bit marks them as one copy for all members (a
// seed ensemble's data); the masks and lr are always one copy for all. Each member has its own Philox key (rng_seed) and its
// own L2 workspace. The rank inside a cluster is still %cluster_ctarank and
// no cluster waits on another, so a member runs the bits of its solo launch
// and clusters past what the card holds at once run in a later wave.
//
// Numerics: products marked bf16 round their inputs to bf16 (nearest even)
// and accumulate in f32; the feedback chain (P w, every Newton-Schulz
// product, V g, the RBF cross term) and the SGP whitening stay full f32.
// No fast-math.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "vjf_defs.cuh"
#include "vjf_hopper.cuh"

#ifndef MAX_SMEM_BYTES
#define MAX_SMEM_BYTES 232448  // what one block may use on sm_90
#endif
#define TILE_QUANTUM 16  // a smaller trial tile: a multiple of this, or on the L2 route
                         // half or a quarter of it (tile_search)
#define STAGE_ROWS 16    // rows of a staged chunk past 128 padded features
#define SUB_ROWS 16      // rows of a staged sub-panel where the panels live in L2

#define NS_ITERS 3
#define NS_TAU_MAX 0.7f
#define NS_EXTRA_ITERS 2
#define NS_TAU_ESCALATE 0.05f
#define N_SUM_SCALARS 9  // scalar leaves of FusedSums, then cm_sum with a channel mask
#define N_SLAB_SCALARS 16

// One hidden layer as the launch gives it (ops/fused_step.py:_layer_table, a
// (n_layers, 3) int64 tensor on the card): its weights from the layer before
// (h x h_prev, row-major; null for the first layer), its bias, its width.
struct LayerArg {
  float* w;
  float* b;
  long long h;
};

// Must match vjf_tpu_torch/ops/fused_step.py:_Args field for field.
struct VJFArgs {
  // carry (updated in place)
  float* w_in_y;
  float* w_in_u;
  float* w_in_m;
  float* w_in_lv;
  const LayerArg* layers;  // (n_layers) the hidden layers, in device memory
  const int* widths;       // (n_layers) their widths: in host memory at the C interface (the
                           // plan and the size queries), in shared memory inside a block
  float* w_mean;
  float* w_logvar;
  float* b_logvar;
  float* w_dec;
  float* b_dec;
  float* cent_x;
  float* cent_u;
  float* c2;
  float* inv_w2;
  const float* w_white;  // SGP: (nfp, nfp) scale^2 W, zero pad; null for RBF
  const float* scale2;   // SGP: (1,) scale^2; null for RBF
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
  const float* mask;   // (T, B) 0/1 trial mask or null
  const float* cmask;  // (T, B, yd) 0/1 channel mask or null
  const float* lr;     // (1,)
  // outputs
  float* q_pack;       // (T, 2, B, xd)
  float* scal;         // (T, 8)
  float* g_vec;        // (nfp, xd) or null (workspace)
  float* xt;           // (B, xd) or null (not kept)
  float* xs;
  float* sums;         // flat FusedSums (vjf_sums_floats() floats) or null
  float* ws;           // vjf_workspace_floats() floats
  // dims
  int T, B, yd, ud, xd, nfp, nf, n_layers;
  int tile, kc, sp;    // set by plan_tiles: trials a phase-1 tile, rows a staged chunk, rows
                       // a staged sub-panel (0: the panels and the trials' state resident)
  // flags
  int sgd, update, warm_up, train_decoder, update_likelihood, update_transition;
  int poisson, trace_quirk, bf16, mega, ns_iters;
  int row0;            // first row of these trials in the whole batch (noise)
  int n_members;       // ensemble launch: clusters along gridDim.y, one a member (0 or 1: solo)
  int shared;          // SHARED_* bits: data every member reads the same copy of
  // constants
  float leak, poisson_clamp, logvar_clamp, clip, rls_shrink, chol_jitter;
  float obs_var_cap, state_var_cap;
  float inv_b;         // phase-1 kernel only: the GLOBAL 1/B
};

// Ensemble launches (fit_ensemble): member m is the cluster at blockIdx.y = m,
// and every per-member operand is stacked with a leading member axis. These
// bits of VJFArgs.shared mark y or u as one copy that all members read
// (stride 0); the carry, the posterior, the noise, the outputs and the
// workspace are always per member, the masks and the learning rate always
// shared.
enum {
  SHARED_Y = 1,
  SHARED_U = 2
};

// ---------------------------------------------------------------------------
// The split over the cluster, and the three memory layouts
// ---------------------------------------------------------------------------

struct Blk {
  int first, n;
};

__host__ __device__ static inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Block r's contiguous share of `total` rows: ceil(total / VJF_CLUSTER) each,
// the last ones fewer or none.
__host__ __device__ static inline Blk block_of(int total, int r) {
  const int per = cdiv(total, VJF_CLUSTER);
  int first = r * per;
  if (first > total) first = total;
  int n = total - first;
  if (n > per) n = per;
  return Blk{first, n};
}

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

// One hidden layer as a block uses it, in the layer table at the head of its
// shared memory (make_header): the weights and bias of LayerArg (moved to the
// block's member), where its bias (loaded every step) and a tile's
// activations (leading dim ldh) lie in shared memory (carve_smem), and where
// its weight and bias gradients lie in the flat FusedSums buffer
// (sums_offsets). The first layer has no w or gw.
struct Layer {
  float *w, *b;
  float *bs, *hs;
  size_t gw, gb;
  int ldh;
};

// Offsets of the leaves of the flat FusedSums buffer, in pack_sums's order
// (ops/fused_step.py: the array leaves in field order, then N_SUM_SCALARS
// scalars); the hidden layers' weights, then their biases, start at `hidden`
// (each layer's in its Layer). A slab is the gradient part of one such
// buffer (what lies before ftf) followed by N_SLAB_SCALARS raw per-block
// scalars.
struct SumsOff {
  size_t w_in_y, w_in_u, w_in_m, w_in_lv, hidden;
  size_t wm, wlv, blv, w_dec, b_dec, ftf, fxd, scalars, total;
};

// With `ly`, also each layer's gw and gb.
__host__ __device__ static SumsOff sums_offsets(const VJFArgs& a, Layer* ly = nullptr) {
  SumsOff o;
  size_t off = 0;
  const int* h = a.widths;
  const size_t xd = a.xd, nfp = a.nfp, yd = a.yd, h0 = h[0], hl = h[a.n_layers - 1];
  o.w_in_y = off, off += h0 * yd;
  o.w_in_u = off, off += a.ud > 0 ? h0 * a.ud : 0;
  o.w_in_m = off, off += h0 * xd;
  o.w_in_lv = off, off += h0 * xd;
  o.hidden = off;
  for (int i = 1; i < a.n_layers; ++i) {
    if (ly) ly[i].gw = off;
    off += (size_t)h[i] * h[i - 1];
  }
  for (int i = 0; i < a.n_layers; ++i) {
    if (ly) ly[i].gb = off;
    off += h[i];
  }
  o.wm = off, off += xd * hl;
  o.wlv = off, off += xd * hl;
  o.blv = off, off += xd;
  o.w_dec = off, off += yd * xd;
  o.b_dec = off, off += yd;
  o.ftf = off, off += nfp * nfp;
  o.fxd = off, off += nfp * xd;
  o.scalars = off, off += N_SUM_SCALARS + (a.cmask ? 1 : 0);
  o.total = off;
  return o;
}

// Per-block raw scalars at the end of a slab (from offset ftf).
enum { SC_ELBO = 0 /* 7 sums */, SC_GRAD = 7, SC_FINITE = 8, SC_RESID = 9, SC_CM = 10 };

// The L2 workspace: one slab per block, the RLS target, the three
// Newton-Schulz matrices other blocks read rows of, and every trial's
// features and dx for the RLS statistics. Past a block's shared memory
// (plan_tiles sets sp) also the rows of P_new and V_new and every trial's
// state (trials: the noise, the two posterior pairs, the mask column).
struct GWS {
  float* slab;
  size_t slab_stride;
  float *g_vec, *ns_a, *ns_b, *ns_t;
  float *feat, *dx;  // every trial's features (B, nfp) and x_t - x_s (B, xd)
  float *p_new, *v_new, *trials;  // with sp: (nfp, nfp) each, and (B, 6 xd + 1)
  size_t total;
};

__host__ __device__ static GWS carve_global(const VJFArgs& a, float* base) {
  GWS g;
  Carver cv{base, 0, 32};  // 128-byte aligned buffers
  const size_t nfp = a.nfp;
  g.slab_stride = (sums_offsets(a).ftf + N_SLAB_SCALARS + 31) / 32 * 32;
  g.slab = cv.take(g.slab_stride * VJF_CLUSTER);
  g.g_vec = cv.take(nfp * a.xd);
  g.ns_a = cv.take(nfp * nfp);
  g.ns_b = cv.take(nfp * nfp);
  g.ns_t = cv.take(nfp * nfp);
  g.feat = cv.take((size_t)a.B * nfp);
  g.dx = cv.take((size_t)a.B * a.xd);
  g.p_new = a.sp ? cv.take(nfp * nfp) : nullptr;
  g.v_new = a.sp ? cv.take(nfp * nfp) : nullptr;
  g.trials = a.sp ? cv.take((size_t)a.B * (6 * a.xd + 1)) : nullptr;
  g.total = cv.off;
  return g;
}

// How many ways a panel product splits K: enough 4 x 4 tiles for every
// thread, at most 8.
__host__ __device__ static inline int panel_ksplit(int prow, int nfp) {
  const int tiles = cdiv(prow, 4) * (nfp / 4);
  int ks = NTHREADS / (tiles > 0 ? tiles : 1);
  return ks < 1 ? 1 : (ks > 8 ? 8 : ks);
}

// A block's shared memory. The first group lives across both phases and
// from step to step, for every trial of the block; then the inputs of one
// tile of phase 1 (tile 0 of step t + 1 arrives while phase 2 of step t
// runs; with several tiles a second buffer takes tile k + 1 while tile k
// computes); phase 1's temporaries, for one tile, and phase 2's scratch
// overlay each other. The hidden layers' biases and activations are in the
// layer table (Layer.bs, Layer.hs).
struct SM {
  float *eps, *q[2][2], *red, *bc, *esum;  // esum: the ELBO sums over the tiles
  float *mrow, *mcol;                         // the trial mask's row, this block's 0/1 column
  float *cent_x, *cent_u, *c2, *inv_w2;        // the RBF constants (centroids transposed)
  float *b_dec, *b_logvar;                     // the biases, loaded every step
  float *y[2], *u[2], *cm[2];                  // a tile's inputs; [1] with several tiles only
  float *feat, *tmp, *xs, *xt, *x2, *z, *fvf, *ptlv, *pt_m, *raw, *py, *g_xt, *g_qm, *g_qlv;
  float *g_h, *g_a;
  float *stage, *pan_p, *pan_x, *part, *vnew, *wnew, *gown, *small;
  int ldy, ldu, ldf, ldg;
  size_t total;
};

// A parameter leaf SGD updates, by its place in the flat buffer.
struct Leaf {
  float* p;
  int off, len;
};

// The leaves other than the hidden layers' (the layer table holds those):
// w_in_y, w_in_u, w_in_m, w_in_lv, w_mean, w_logvar, b_logvar, w_dec, b_dec.
#define MAX_LEAVES 9

// What a block knows for the whole launch.
struct Ctx {
  SM s;
  GWS g;
  SumsOff so;
  const Layer* ly;  // the layer table, behind the Header
  const Leaf* lv;   // the other leaves SGD updates, behind the layer table
  int n_leaves;
  int rank;
  Blk tr;       // this block's trials
  Blk fr;       // this block's rows of P, V, w
  float* slab;  // this block's slab
  float lr;
  float scale2;  // SGP: scale^2 (0 for RBF)
  uint32_t seed;
};

// The head of a block's shared memory: the arguments and the context, one
// copy a block. In a thread's local memory they would not stay in L1 (512
// threads' copies next to the shared memory a block takes), and every
// pointer the step loads would come from L2.
struct Header {
  VJFArgs a;
  Ctx c;
};

// The head of a block's shared memory takes at least the bytes it took while
// the Header held the hidden layers in arrays of eight, so that every shape
// of up to ten layers keeps the plan and the bits it had then.
#define HEAD_MIN_BYTES 1936

// The head of a block's shared memory: the Header, the layer table (a Layer
// a hidden layer), the other SGD leaves and the widths, 16-byte aligned.
__host__ __device__ static inline size_t head_floats(int n_layers) {
  const size_t bytes = sizeof(Header) + n_layers * sizeof(Layer) + MAX_LEAVES * sizeof(Leaf) +
                       n_layers * sizeof(int);
  return ((bytes > HEAD_MIN_BYTES ? bytes : HEAD_MIN_BYTES) + 15) / 16 * 4;
}

// Mirrored for the tests by tests/torch_tile_plan.py:smem_floats. With sp
// (past a block's shared memory) the trials' state (eps, q, mcol) lives in L2
// (make_header points it at the block's rows of GWS.trials), the trial mask's
// row is read where it lies, and phase 2 keeps one staged sub-panel of sp
// rows: P_new's and V_new's rows live in L2, the iterate's rows and w are read
// there. With `ly`, also each layer's bs, hs and ldh.
__host__ __device__ static SM carve_smem(const VJFArgs& a, float* base, Layer* ly = nullptr) {
  SM s;
  Carver cv{base, 0, 4};  // 16-byte aligned buffers
  cv.take(head_floats(a.n_layers));
  const size_t xd = a.xd, nfp = a.nfp;
  const size_t rows = cdiv(a.B, VJF_CLUSTER), prow = cdiv(a.nfp, VJF_CLUSTER), tile = a.tile;
  const bool big = a.sp > 0;
  const int nbuf = a.tile < (int)rows ? 2 : 1;
  const int* h = a.widths;
  int hmax = 0;
  for (int i = 0; i < a.n_layers; ++i) hmax = h[i] > hmax ? h[i] : hmax;
  // leading dimensions: a multiple of 4 floats (16-byte rows) plus 4, so that
  // the rows of a fragment fall into different banks
  s.ldy = (a.yd + 3) / 4 * 4 + 4;
  s.ldu = (a.ud + 3) / 4 * 4 + 4;
  s.ldf = (a.nfp + 3) / 4 * 4 + 4;
  s.ldg = (hmax + 3) / 4 * 4 + 4;
  s.eps = big ? nullptr : cv.take(rows * 2 * xd);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) s.q[i][j] = big ? nullptr : cv.take(rows * xd);
  s.red = cv.take(8 * NWARPS);
  s.bc = cv.take(32);
  s.esum = cv.take(8);
  s.mrow = a.mask && !big ? cv.take(a.B) : nullptr;
  s.mcol = big ? nullptr : cv.take(rows);
  s.cent_x = cv.take(nfp * xd);
  s.cent_u = a.ud > 0 ? cv.take(nfp * a.ud) : nullptr;
  s.c2 = cv.take(nfp);
  s.inv_w2 = cv.take(nfp);
  s.b_dec = cv.take(a.yd);
  s.b_logvar = cv.take(xd);
  for (int i = 0; i < a.n_layers; ++i) {
    float* bs = cv.take(h[i]);
    if (ly) ly[i].bs = bs;
  }
  for (int i = 0; i < 2; ++i) {
    const bool on = i < nbuf;
    s.y[i] = on ? cv.take(tile * s.ldy) : nullptr;
    s.u[i] = on && a.ud > 0 ? cv.take(tile * s.ldu) : nullptr;
    s.cm[i] = on && a.cmask ? cv.take(tile * s.ldy) : nullptr;
  }
  const size_t mark = cv.off;
  // phase 1, one tile (tmp also takes the post-update residual, behind phase 2)
  s.feat = cv.take(tile * s.ldf);
  s.tmp = cv.take(tile * xd);
  s.xs = cv.take(tile * xd);
  s.xt = cv.take(tile * xd);
  s.x2 = cv.take(tile);
  s.z = cv.take(tile * s.ldf);
  s.fvf = cv.take(tile);
  s.ptlv = cv.take(tile);
  s.pt_m = cv.take(tile * xd);
  s.raw = cv.take(tile * xd);
  s.py = cv.take(tile * s.ldy);
  s.g_xt = cv.take(tile * xd);
  s.g_qm = cv.take(tile * xd);
  s.g_qlv = cv.take(tile * xd);
  s.g_h = cv.take(tile * s.ldg);
  s.g_a = cv.take(tile * s.ldg);
  for (int i = 0; i < a.n_layers; ++i) {
    const int ldh = (h[i] + 3) / 4 * 4 + 4;
    float* hs = cv.take(tile * ldh);
    if (ly) ly[i].ldh = ldh, ly[i].hs = hs;
  }
  const size_t end1 = cv.off;
  // phase 2
  cv.off = mark;
  s.stage = cv.take(a.kc < a.nfp ? 2 * (size_t)a.kc * nfp : nfp * nfp);
  if (big) {
    s.pan_p = cv.take((size_t)a.sp * s.ldf);  // a staged sub-panel of the left operand
    s.pan_x = s.vnew = s.small = nullptr;
    s.part = cv.take((size_t)panel_ksplit(a.sp, a.nfp) * cdiv(a.sp, 4) * 4 * nfp);
  } else {
    s.pan_p = cv.take(prow * s.ldf);
    s.pan_x = cv.take(prow * s.ldf);
    s.part = cv.take((size_t)panel_ksplit((int)prow, a.nfp) * cdiv((int)prow, 4) * 4 * nfp);
    s.vnew = cv.take(prow * nfp);
  }
  s.wnew = cv.take(prow * xd);
  s.gown = cv.take(prow * xd);
  if (!big) s.small = cv.take(nfp * xd);
  s.total = cv.off > end1 ? cv.off : end1;
  return s;
}

static bool smem_fits(const VJFArgs& a) {
  return carve_smem(a, nullptr).total * sizeof(float) <= MAX_SMEM_BYTES;
}

// Every trial of a block in one tile where the block's shared memory then
// fits, else the largest multiple of TILE_QUANTUM that fits, else (on the L2
// route, sp) half the quantum, then a quarter, else the smallest tile.
static VJFArgs tile_search(VJFArgs a) {
  const int rows = cdiv(a.B, VJF_CLUSTER);
  a.tile = rows;
  for (int r = (rows - 1) / TILE_QUANTUM * TILE_QUANTUM; r >= TILE_QUANTUM && !smem_fits(a);
       r -= TILE_QUANTUM)
    a.tile = r;
  for (int r = TILE_QUANTUM / 2; a.sp && r >= TILE_QUANTUM / 4 && r < a.tile && !smem_fits(a);
       r /= 2)
    a.tile = r;
  return a;
}

// The tiles of phase 1 and the staging of phase 2 at these shapes, which
// vjf_smem_bytes and the launch both take. With the trials' state and
// phase 2's panels resident (sp 0): `tile` from tile_search (one tile keeps
// the bits of the kernel before it had tiles), `kc` stages the right-hand
// matrix of a panel product whole up to 128 padded features, in chunks of
// STAGE_ROWS rows past that. Where no tile fits that way, the trials' state
// and the panels move to L2 (sp > 0: sub-panels of SUB_ROWS rows, halved with
// kc, then sp, down to 4, until a tile fits); the smallest plan where none
// fits, which the launch refuses. Mirrored by tests/torch_tile_plan.py:plan_of.
static VJFArgs plan_tiles(VJFArgs a) {
  a.sp = 0;
  a.kc = a.nfp <= 128 ? a.nfp : STAGE_ROWS;
  VJFArgs p = tile_search(a);
  if (smem_fits(p)) return p;
  for (int kc = a.kc; kc >= 4; kc /= 2)
    for (int sp = SUB_ROWS; sp >= 4; sp /= 2) {
      a.kc = kc;
      a.sp = sp;
      p = tile_search(a);
      if (smem_fits(p)) return p;
    }
  return p;
}

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

// The fragments of one 16-deep slice of K for a warp's 16 x 8 tile: rows pa0
// and pa1 of A and column pb of B, already offset to this thread's first k;
// sa and sb are the strides along k. Raw f32 values, packed to bf16 later,
// so that the loads of several slices can be in flight together.
struct Frag {
  float a[8], b[4];
};

__device__ __forceinline__ void load_frag(Frag& f, const float* pa0, const float* pa1,
                                          const float* pb, int sa, int sb) {
  f.a[0] = pa0[0], f.a[1] = pa0[sa], f.a[2] = pa1[0], f.a[3] = pa1[sa];
  f.a[4] = pa0[8 * sa], f.a[5] = pa0[9 * sa], f.a[6] = pa1[8 * sa], f.a[7] = pa1[9 * sa];
  f.b[0] = pb[0], f.b[1] = pb[sb], f.b[2] = pb[8 * sb], f.b[3] = pb[9 * sb];
}

__device__ __forceinline__ void mma_frag(float (&c)[4], const Frag& f) {
  const uint32_t af[4] = {pack_bf16x2(f.a[0], f.a[1]), pack_bf16x2(f.a[2], f.a[3]),
                          pack_bf16x2(f.a[4], f.a[5]), pack_bf16x2(f.a[6], f.a[7])};
  const uint32_t bfr[2] = {pack_bf16x2(f.b[0], f.b[1]), pack_bf16x2(f.b[2], f.b[3])};
  mma_bf16_16816(c, af, bfr);
}

// C (M x N, row-major, leading dim ldc) = A B, or C + A B with `acc`. A, B
// and C may each lie in shared or global memory; C must not alias A or B.
// With `bf16` the product runs on the tensor cores: each warp takes 16 x 8
// tiles of C (tile i goes to warp (w0 + i) % NWARPS, so that skinny
// products started together land on different warps) and walks K in slices
// of 16, four slices' loads in flight at a time, rounding the operands to
// bf16 as it packs them. A ragged tile reads a clamped row or column, whose
// results are not stored; only the ragged end of K reads zeros. Else every
// thread sums whole elements in f32. An element of C belongs to the same
// thread in every call with the same M, N and w0, so calls that accumulate
// into one C need no barrier between them. Ends with __syncthreads() when
// `sync`.
__device__ void mm(int M, int N, int K, Mat A, Mat B, float* C, int ldc, bool acc, bool bf16,
                   bool sync, int w0 = 0) {
  if (bf16) {
    const int lane = threadIdx.x & 31;
    const int warp = ((threadIdx.x >> 5) + NWARPS - w0 % NWARPS) % NWARPS;
    const int g = lane >> 2, tg = lane & 3;
    const int tn = cdiv(N, 8), tiles = cdiv(M, 16) * tn;
    const int sa = A.cs, sb = B.rs;
    const int kfull = K & ~15;
    for (int tile = warp; tile < tiles; tile += NWARPS) {
      const int r0 = (tile / tn) * 16 + g, r1 = r0 + 8;  // rows of A and C
      const int cb = (tile % tn) * 8 + g;                // column of B
      const int c0 = (tile % tn) * 8 + 2 * tg;           // columns c0, c0 + 1 of C
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if (acc) {
        if (r0 < M && c0 < N) c[0] = C[(size_t)r0 * ldc + c0];
        if (r0 < M && c0 + 1 < N) c[1] = C[(size_t)r0 * ldc + c0 + 1];
        if (r1 < M && c0 < N) c[2] = C[(size_t)r1 * ldc + c0];
        if (r1 < M && c0 + 1 < N) c[3] = C[(size_t)r1 * ldc + c0 + 1];
      }
      const float* pa0 = A.p + (size_t)(r0 < M ? r0 : M - 1) * A.rs + (size_t)(2 * tg) * sa;
      const float* pa1 = A.p + (size_t)(r1 < M ? r1 : M - 1) * A.rs + (size_t)(2 * tg) * sa;
      const float* pb = B.p + (size_t)(cb < N ? cb : N - 1) * B.cs + (size_t)(2 * tg) * sb;
      int k0 = 0;
      for (; k0 + 64 <= kfull; k0 += 64) {
        Frag f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_frag(f[i], pa0 + (k0 + 16 * i) * sa, pa1 + (k0 + 16 * i) * sa,
                    pb + (k0 + 16 * i) * sb, sa, sb);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_frag(c, f[i]);
      }
      for (; k0 < kfull; k0 += 16) {
        Frag f;
        load_frag(f, pa0 + k0 * sa, pa1 + k0 * sa, pb + k0 * sb, sa, sb);
        mma_frag(c, f);
      }
      if (k0 < K) {  // the ragged end of K
        const int k = k0 + 2 * tg;
        const int dk[4] = {0, 1, 8, 9};
        Frag f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool in = k + dk[i] < K;
          const int off = k0 + dk[i];
          f.a[(i & 1) + 4 * (i >> 1)] = in ? pa0[off * sa] : 0.f;
          f.a[(i & 1) + 4 * (i >> 1) + 2] = in ? pa1[off * sa] : 0.f;
          f.b[i] = in ? pb[off * sb] : 0.f;
        }
        mma_frag(c, f);
      }
      if (r0 < M && c0 < N) C[(size_t)r0 * ldc + c0] = c[0];
      if (r0 < M && c0 + 1 < N) C[(size_t)r0 * ldc + c0 + 1] = c[1];
      if (r1 < M && c0 < N) C[(size_t)r1 * ldc + c0] = c[2];
      if (r1 < M && c0 + 1 < N) C[(size_t)r1 * ldc + c0 + 1] = c[3];
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += NTHREADS) {
      const int i = idx / N, j = idx % N;
      const float* ap = A.p + (size_t)i * A.rs;
      const float* bp = B.p + (size_t)j * B.cs;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) s += ap[(size_t)k * A.cs] * bp[(size_t)k * B.rs];
      float* c = C + (size_t)i * ldc + j;
      *c = acc ? *c + s : s;
    }
  }
  if (sync) __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums N per-thread values over the block; every thread gets the totals.
template <int N>
__device__ void block_sum(float* red, float (&v)[N]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float s = warp_sum(v[i]);
    if (lane == 0) red[i * NWARPS + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += red[i * NWARPS + w];
    v[i] = s;
  }
  __syncthreads();
}

// Column sums of the first `rows` rows of x (leading dim ld) into out
// (cols), or added to out with `acc`.
__device__ void col_sum(const float* x, int ld, int rows, int cols, float* out, bool acc) {
  for (int j = threadIdx.x; j < cols; j += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += x[(size_t)r * ld + j];
    out[j] = acc ? out[j] + s : s;
  }
}

// A thread's sum of x[tid], x[tid + NTHREADS], ... in that order; four loads
// are in flight ahead of their adds (x may lie in L2), so the order and the
// bits are those of the plain loop.
__device__ __forceinline__ float sum_of(const float* x, size_t n) {
  float s = 0.f;
  size_t i = threadIdx.x;
  for (; i + 3 * NTHREADS < n; i += 4 * NTHREADS) {
    const float v0 = x[i], v1 = x[i + NTHREADS], v2 = x[i + 2 * NTHREADS],
                v3 = x[i + 3 * NTHREADS];
    s += v0;
    s += v1;
    s += v2;
    s += v3;
  }
  for (; i < n; i += NTHREADS) s += x[i];
  return s;
}

// ---------------------------------------------------------------------------
// One step: step_forward_sums + step_apply (fused_step.py:294, :600)
// ---------------------------------------------------------------------------

// The carry scalars, the same in every thread of the cluster.
struct CarryScalars {
  float slv, lik_lv, dyn_n, lik_n;
};

// The scalar leaves of FusedSums, in pack_sums's order (N_SUM_SCALARS, then
// cm_sum, the observed entries under a channel mask), and the step's valid
// trials (B without a trial mask).
struct StepSums {
  float g_lik_lv_batch, recon_batch, dyn_batch, ent, sq_y, grad_check, fvf_sum, dx_sum,
      dx2_sum, cm_sum, count;
};

// Element `off` of the flat buffer summed over the blocks' slabs, in rank
// order.
__device__ __forceinline__ float rank_sum(const Ctx& c, size_t off) {
  float v[VJF_CLUSTER];  // every load in flight before the first add
#pragma unroll
  for (int r = 0; r < VJF_CLUSTER; ++r) v[r] = c.g.slab[(size_t)r * c.g.slab_stride + off];
  float s = v[0];
#pragma unroll
  for (int r = 1; r < VJF_CLUSTER; ++r) s += v[r];
  return s;
}

// Starts the copy of nb rows of yd floats (row-major) into shared memory
// rows of leading dimension ld, 16 bytes at a time where aligned.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src, int nb, int yd) {
  if (yd % 4 == 0 && ((uintptr_t)src & 15) == 0) {
    const int q = yd / 4;
    for (int i = threadIdx.x; i < nb * q; i += NTHREADS) {
      const int r = i / q, cc = (i % q) * 4;
      cp_async16(dst + (size_t)r * ld + cc, src + (size_t)r * yd + cc);
    }
  } else {
    for (int i = threadIdx.x; i < nb * yd; i += NTHREADS)
      cp_async4(dst + (size_t)(i / yd) * ld + i % yd, src + i);
  }
}

// A tile of phase 1: trials [r0, r0 + n) of this block, its inputs in
// buffer `buf`.
struct Tile {
  int r0, n, buf;
};

// TILED: the instantiation of the kernels for shapes whose phase 1 may take
// several tiles or whose panel products stage in chunks; the other one (every
// shape the kernels took before tiles: a block's trials one tile, a panel's
// operand staged whole) folds the tile and chunk loops to one pass
// (one_pass picks it at the launch).
template <bool TILED>
__device__ __forceinline__ Tile tile_of(const VJFArgs& a, const Ctx& c, int k) {
  if (!TILED) return Tile{0, c.tr.n, 0};
  const int r0 = k * a.tile, left = c.tr.n - r0;
  return Tile{r0, left < a.tile ? left : a.tile, k & 1};
}

// The tiles of this block's trials: at least one, so that a block without
// trials still writes its sums (zero).
template <bool TILED>
__device__ __forceinline__ int n_tiles(const VJFArgs& a, const Ctx& c) {
  if (!TILED) return 1;
  const int n = cdiv(c.tr.n, a.tile);
  return n > 0 ? n : 1;
}

// Starts the copy of step t's y, u and channel mask for tile k into its
// buffer (no commit).
__device__ __forceinline__ void fetch_tile(const VJFArgs& a, const Ctx& c, int t, const Tile& k) {
  const int yd = a.yd, ud = a.ud;
  const size_t row = (size_t)t * a.B + c.tr.first + k.r0;
  stage_rows(c.s.y[k.buf], c.s.ldy, a.y + row * yd, k.n, yd);
  if (a.cmask) stage_rows(c.s.cm[k.buf], c.s.ldy, a.cmask + row * yd, k.n, yd);
  if (ud > 0) {
    const float* usrc = a.u + row * ud;
    for (int i = threadIdx.x; i < k.n * ud; i += NTHREADS)
      cp_async4(c.s.u[k.buf] + (size_t)(i / ud) * c.s.ldu + i % ud, usrc + i);
  }
}

// Starts the copy of step t's inputs of tile 0, the trial mask's whole row
// (every block counts the step's valid trials) and the injected noise of
// every trial of this block into shared memory. BIG (the trials' state in
// L2): the mask's row is read where it lies, and the noise is copied into
// the trials' state here.
template <bool TILED, bool BIG>
__device__ __forceinline__ void fetch_inputs(const VJFArgs& a, const Ctx& c, int t) {
  const int nb = c.tr.n, xd = a.xd;
  const size_t row = (size_t)t * a.B + c.tr.first;
  fetch_tile(a, c, t, tile_of<TILED>(a, c, 0));
  if (a.mask && !BIG)
    for (int i = threadIdx.x; i < a.B; i += NTHREADS)
      cp_async4(c.s.mrow + i, a.mask + (size_t)t * a.B + i);
  if (a.eps_s) {
    // the (rows, 2 xd) noise: columns [:xd] are eps_s, [xd:] eps_t
    for (int i = threadIdx.x; i < nb * xd; i += NTHREADS) {
      float* dst = c.s.eps + (size_t)(i / xd) * 2 * xd + i % xd;
      if (BIG) {
        dst[0] = a.eps_s[row * xd + i];
        dst[xd] = a.eps_t[row * xd + i];
      } else {
        cp_async4(dst, a.eps_s + row * xd + i);
        cp_async4(dst + xd, a.eps_t + row * xd + i);
      }
    }
  }
  cp_async_commit();
}

// With masks: tile k's y and u replaced by 0 where masked (channel holes
// first: NaN padding never enters) and its channel mask made 0/1. Reads
// mcol, which a barrier has published.
__device__ __forceinline__ void mask_tile(const VJFArgs& a, const Ctx& c, const Tile& k) {
  const float* mcol = c.s.mcol + k.r0;
  float *y = c.s.y[k.buf], *cm = c.s.cm[k.buf];
  for (int i = threadIdx.x; i < k.n * a.yd; i += NTHREADS) {
    const size_t e = (size_t)(i / a.yd) * c.s.ldy + i % a.yd;
    float v = y[e];
    if (a.cmask) {
      const float cmv = cm[e] > 0.f ? 1.f : 0.f;
      cm[e] = cmv;
      v = cmv > 0.f ? v : 0.f;
    }
    y[e] = mcol[i / a.yd] > 0.f ? v : 0.f;
  }
  if (a.mask)
    for (int i = threadIdx.x; i < k.n * a.ud; i += NTHREADS) {
      float* p = c.s.u[k.buf] + (size_t)(i / a.ud) * c.s.ldu + i % a.ud;
      *p = mcol[i / a.ud] > 0.f ? *p : 0.f;
    }
}

// Waits for step t's inputs; loads the posterior entering step 0; draws the
// noise unless it is given: rows [row0 + first, ...) of the whole batch's
// draw, at counter `count`. `cur` is the buffer that holds the posterior
// entering the step. With masks: this block's 0/1 column of the trial mask,
// tile 0's inputs masked (mask_tile), and the step's valid trials over the
// whole batch, which it returns (B without a trial mask).
template <bool TILED, bool BIG>
__device__ __forceinline__ float step_begin(const VJFArgs& a, const Ctx& c, int t, int cur,
                                            uint32_t count) {
  const int nb = c.tr.n, xd = a.xd;
  cp_async_wait_all();
  if (t == 0) {
    for (int i = threadIdx.x; i < nb * xd; i += NTHREADS) {
      c.s.q[cur][0][i] = a.qs_m[(size_t)c.tr.first * xd + i];
      c.s.q[cur][1][i] = a.qs_lv[(size_t)c.tr.first * xd + i];
    }
  }
  // the biases as the last step's SGD left them, all leaves in one pass (a
  // thread's loads from L2 overlap instead of waiting leaf by leaf)
  int nbias = a.yd + xd;
  for (int l = 0; l < a.n_layers; ++l) nbias += a.widths[l];
  for (int i = threadIdx.x; i < nbias; i += NTHREADS) {
    if (i < a.yd) {
      c.s.b_dec[i] = a.b_dec[i];
    } else if (i < a.yd + xd) {
      c.s.b_logvar[i - a.yd] = a.b_logvar[i - a.yd];
    } else {
      int j = i - a.yd - xd, l = 0;
      while (j >= a.widths[l]) j -= a.widths[l++];
      c.ly[l].bs[j] = c.ly[l].b[j];
    }
  }
  if (!a.eps_s) {
    const uint32_t j0 = (uint32_t)(a.row0 + c.tr.first) * (uint32_t)xd;
    for (int j = threadIdx.x; j < nb * xd; j += NTHREADS) {
      float u1[2], u2[2];
      philox_pair(c.seed, count, j0 + (uint32_t)j, u1, u2);
      c.s.eps[2 * j] = box_muller(u1[0], u2[0]);
      c.s.eps[2 * j + 1] = box_muller(u1[1], u2[1]);
    }
  }
  __syncthreads();
  if (!a.mask && !a.cmask) return (float)a.B;
  float valid[1] = {0.f};
  if (a.mask) {
    // 0/1 sums are exact in any order: every block counts the same number
    const float* mrow = BIG ? a.mask + (size_t)t * a.B : c.s.mrow;
    for (int i = threadIdx.x; i < a.B; i += NTHREADS) valid[0] += mrow[i] > 0.f ? 1.f : 0.f;
    for (int b = threadIdx.x; b < nb; b += NTHREADS)
      c.s.mcol[b] = mrow[c.tr.first + b] > 0.f ? 1.f : 0.f;
    block_sum<1>(c.s.red, valid);  // its barriers publish mcol
  } else {
    valid[0] = (float)a.B;
  }
  mask_tile(a, c, tile_of<TILED>(a, c, 0));
  __syncthreads();
  return valid[0];
}

// SGP whitening of tile rows [first, first + nb) of the whole batch's
// features: s.feat (nb x nfp) times w_white (nfp x nfp, row-major, in L2) in
// full f32, through s.z (free until F V), back into s.feat and, with
// `publish`, into the workspace that the RLS statistics and the residual
// read. A thread owns one column and up to 8 rows of a pass, so a block
// loads each entry of w_white once a pass and a warp reads a row of w_white
// coalesced; the features are broadcast from shared memory, 16-byte loads at
// a time. WHITEN_K rows of w_white are loaded into registers before their
// products, so that their L2 latency overlaps; each sum still runs over k in
// order.
#define WHITEN_K 16
__device__ __forceinline__ void whiten_features(const VJFArgs& a, const Ctx& c, bool publish,
                                                int nb, int first, const float* mcol) {
  const SM& s = c.s;
  const int nfp = a.nfp;
  const int groups = NTHREADS >= nfp ? NTHREADS / nfp : 1;
  const int kfull = nfp - nfp % WHITEN_K;
  for (int idx = threadIdx.x; idx < nfp * groups; idx += NTHREADS) {
    const int j = idx % nfp, g = idx / nfp;
    for (int b0 = g; b0 < nb; b0 += 8 * groups) {
      float acc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = 0.f;
      for (int k0 = 0; k0 < kfull; k0 += WHITEN_K) {
        float w[WHITEN_K];
#pragma unroll
        for (int kk = 0; kk < WHITEN_K; ++kk) w[kk] = a.w_white[(size_t)(k0 + kk) * nfp + j];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (b0 + r * groups < nb) {
            const float4* f =
                reinterpret_cast<const float4*>(s.feat + (size_t)(b0 + r * groups) * s.ldf + k0);
#pragma unroll
            for (int q = 0; q < WHITEN_K / 4; ++q) {
              const float4 v = f[q];
              acc[r] += v.x * w[4 * q];
              acc[r] += v.y * w[4 * q + 1];
              acc[r] += v.z * w[4 * q + 2];
              acc[r] += v.w * w[4 * q + 3];
            }
          }
        }
      }
      for (int k = kfull; k < nfp; ++k) {  // the ragged end of K (nfp % WHITEN_K)
        const float w = a.w_white[(size_t)k * nfp + j];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (b0 + r * groups < nb) acc[r] += s.feat[(size_t)(b0 + r * groups) * s.ldf + k] * w;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int b = b0 + r * groups;
        if (b < nb) s.z[(size_t)b * s.ldf + j] = acc[r];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * nfp; i += NTHREADS) {
    const int b = i / nfp, j = i % nfp;
    const float v = s.z[(size_t)b * s.ldf + j];
    s.feat[(size_t)b * s.ldf + j] = v;
    if (publish) c.g.feat[(size_t)(first + b) * nfp + j] = v * mcol[b];
  }
  __syncthreads();
}

// Phase 1 on tile k of this block's trials (see step_forward_sums): the
// forward, the tile's ELBO sums into s.esum (thread 0 writes them at the
// first tile and adds them at the others), and the manual backward into the
// slab, which the first tile writes and the others add to.
template <bool TILED>
__device__ __forceinline__ void tile_forward_sums(const VJFArgs& a, const Ctx& c,
                                                  const CarryScalars& cs, int t, int cur,
                                                  float inv_b, bool publish, bool freeze,
                                                  const Tile& k) {
  const int tid = threadIdx.x;
  const SM& s = c.s;
  const int nb = k.n, first = c.tr.first + k.r0;
  const bool acc = TILED && k.r0 > 0;
  const int yd = a.yd, ud = a.ud, xd = a.xd, nfp = a.nfp, L = a.n_layers;
  const int h0 = a.widths[0], hl = a.widths[L - 1];
  const Layer* ly = c.ly;
  const bool bf = a.bf16 != 0;
  float* y = s.y[k.buf];
  const float* u = ud > 0 ? s.u[k.buf] : nullptr;
  const float* cm = s.cm[k.buf];
  const float *qs_m = s.q[cur][0] + (size_t)k.r0 * xd, *qs_lv = s.q[cur][1] + (size_t)k.r0 * xd;
  float *qt_m = s.q[1 - cur][0] + (size_t)k.r0 * xd, *qt_lv = s.q[1 - cur][1] + (size_t)k.r0 * xd;
  const float *eps_s = s.eps + (size_t)k.r0 * 2 * xd, *eps_t = eps_s + xd;
  const int eps_ld = 2 * xd;
  const float slv = cs.slv, lik_lv = cs.lik_lv;
  float* slab = c.slab;
  const float* mcol = s.mcol + k.r0;

  if (a.cmask) {
    // the recognition input at a masked channel: the decoder's prediction
    // from the previous posterior mean (the rate for Poisson), into y
    mm(nb, yd, xd, rowmaj(qs_m, xd), trans(a.w_dec, xd), s.py, s.ldy, false, bf, true);
    for (int i = tid; i < nb * yd; i += NTHREADS) {
      const size_t ei = (size_t)(i / yd) * s.ldy + i % yd;
      if (!(cm[ei] > 0.f)) {
        float p = s.py[ei] + s.b_dec[i % yd];
        if (a.poisson) p = expf(p > a.poisson_clamp ? a.poisson_clamp : p);
        y[ei] = p;
      }
    }
  }

  // ---------------- forward ----------------
  for (int i = tid; i < nb * xd; i += NTHREADS) {
    const int b = i / xd, kk = i % xd;
    const float v = qs_m[i] + eps_s[b * eps_ld + kk] * expf(0.5f * qs_lv[i]);
    s.xs[i] = v;
    if (a.xs) a.xs[(size_t)first * xd + i] = v;
  }
  __syncthreads();
  for (int b = tid; b < nb; b += NTHREADS) {
    float v = 0.f;
    for (int kk = 0; kk < xd; ++kk) v += s.xs[b * xd + kk] * s.xs[b * xd + kk];
    if (u) {
      float su = 0.f;
      for (int kk = 0; kk < ud; ++kk) su += u[b * s.ldu + kk] * u[b * s.ldu + kk];
      v += su;
    }
    s.x2[b] = v;
  }
  __syncthreads();
  // RBF features, cross term in full f32; pad centroids give exact 0. A warp
  // per trial, a lane per feature (the centroids lie transposed).
  for (int b = tid >> 5; b < nb; b += NWARPS) {
    for (int j = tid & 31; j < nfp; j += 32) {
      float cross = 0.f;
      for (int kk = 0; kk < xd; ++kk) cross += s.xs[b * xd + kk] * s.cent_x[kk * nfp + j];
      if (u) {
        float cu = 0.f;
        for (int kk = 0; kk < ud; ++kk) cu += u[b * s.ldu + kk] * s.cent_u[kk * nfp + j];
        cross += cu;
      }
      float d2 = s.x2[b] + s.c2[j] - 2.0f * cross;
      d2 = d2 < 0.f ? 0.f : d2;
      const float f = expf(-0.5f * d2 * s.inv_w2[j]);
      s.feat[(size_t)b * s.ldf + j] = f;
      if (publish && !a.w_white) c.g.feat[(size_t)(first + b) * nfp + j] = f * mcol[b];
    }
  }
  __syncthreads();
  if (a.w_white) whiten_features(a, c, publish, nb, first, mcol);
  const Mat feat = rowmaj(s.feat, s.ldf);
  mm(nb, nfp, nfp, feat, rowmaj(a.v_mat, nfp), s.z, s.ldf, false, bf, false);
  mm(nb, xd, nfp, feat, rowmaj(a.w_dyn, xd), s.pt_m, xd, false, bf, false);
  // first layer, weights split by input segment; its tiles start behind F w's
  const int wf = cdiv(nb, 16) * cdiv(xd, 8);
  mm(nb, h0, yd, rowmaj(y, s.ldy), trans(a.w_in_y, yd), ly[0].hs, ly[0].ldh, false, bf, false, wf);
  mm(nb, h0, xd, rowmaj(qs_m, xd), trans(a.w_in_m, xd), ly[0].hs, ly[0].ldh, true, bf, false,
     wf);
  mm(nb, h0, xd, rowmaj(qs_lv, xd), trans(a.w_in_lv, xd), ly[0].hs, ly[0].ldh, true, bf, false,
     wf);
  if (u)
    mm(nb, h0, ud, rowmaj(u, s.ldu), trans(a.w_in_u, ud), ly[0].hs, ly[0].ldh, true, bf, false,
       wf);
  __syncthreads();
  for (int b = tid >> 5; b < nb; b += NWARPS) {  // a warp per trial
    float v = 0.f, ff = 0.f;
    for (int j = tid & 31; j < nfp; j += 32) {
      const float f = s.feat[(size_t)b * s.ldf + j];
      v += s.z[(size_t)b * s.ldf + j] * f;
      ff += f * f;
    }
    v = warp_sum(v);
    v = v < 1e-30f ? 1e-30f : v;
    if (a.w_white) ff = warp_sum(ff);
    if ((tid & 31) == 0) {
      s.fvf[b] = v;  // feeds tau through fvf_sum without the DTC term
      if (a.w_white) {
        const float dtc = c.scale2 - ff;
        s.ptlv[b] = logf(v + (dtc > 0.f ? dtc : 0.f) + 1e-30f);
      } else {
        s.ptlv[b] = logf(v);
      }
    }
  }
  for (int b = tid >> 5; b < nb; b += NWARPS) {
    for (int j = tid & 31; j < h0; j += 32) {
      float* hp = ly[0].hs + (size_t)b * ly[0].ldh + j;
      *hp = tanhf(*hp + ly[0].bs[j]);
    }
  }
  __syncthreads();
  for (int l = 1; l < L; ++l) {
    const int hi = a.widths[l], hp = a.widths[l - 1];
    mm(nb, hi, hp, rowmaj(ly[l - 1].hs, ly[l - 1].ldh), trans(ly[l].w, hp), ly[l].hs, ly[l].ldh,
       false, bf, true);
    for (int b = tid >> 5; b < nb; b += NWARPS) {
      for (int j = tid & 31; j < hi; j += 32) {
        float* p = ly[l].hs + (size_t)b * ly[l].ldh + j;
        *p = tanhf(*p + ly[l].bs[j]);
      }
    }
    __syncthreads();
  }
  const Mat h_last = rowmaj(ly[L - 1].hs, ly[L - 1].ldh);
  mm(nb, xd, hl, h_last, trans(a.w_mean, hl), qt_m, xd, false, bf, false);
  mm(nb, xd, hl, h_last, trans(a.w_logvar, hl), s.raw, xd, false, bf, true, wf);
  {
    float* qp = a.q_pack + (size_t)t * 2 * a.B * xd + (size_t)first * xd;
    for (int i = tid; i < nb * xd; i += NTHREADS) {
      const int b = i / xd, kk = i % xd;
      const float raw = s.raw[i] + s.b_logvar[kk];
      s.raw[i] = raw;
      const float lv = clampf(raw, -a.logvar_clamp, a.logvar_clamp);
      qt_lv[i] = lv;
      const float xt = qt_m[i] + eps_t[b * eps_ld + kk] * expf(0.5f * lv);
      s.xt[i] = xt;
      s.pt_m[i] = (1.0f - a.leak) * s.xs[i] + s.pt_m[i];
      const bool keep = !freeze || mcol[b] > 0.f;
      qp[i] = keep ? qt_m[i] : qs_m[i];
      qp[(size_t)a.B * xd + i] = keep ? lv : qs_lv[i];
      if (a.xt) a.xt[(size_t)first * xd + i] = xt;
    }
  }
  __syncthreads();
  mm(nb, yd, xd, rowmaj(s.xt, xd), trans(a.w_dec, xd), s.py, s.ldy, false, bf, true);

  // ---------------- ELBO batch sums (+ the likelihood gradient) ----------------
  // sums: 0 nll or squared residual, 1 diff^2, 2 trace, 3 qt_lv, 4 dx, 5 dx^2,
  // 6 fvf, 7 the observed entries (channel mask); each entry weighted by its
  // 0/1 mask, which is 1 throughout without masks
  float e[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float inv_sv = expf(-slv);
  const float inv_lik = expf(-lik_lv);
  for (int b = tid >> 5; b < nb; b += NWARPS) {
    float* row = s.py + (size_t)b * s.ldy;
    const float* yrow = y + (size_t)b * s.ldy;
    const float* cmrow = a.cmask ? cm + (size_t)b * s.ldy : nullptr;
    for (int j = tid & 31; j < yd; j += 32) {
      // y holds the recognition input; the likelihood sees 0 at a hole
      const float cmv = cmrow ? cmrow[j] : 1.f;
      const float w = cmv * mcol[b];
      const float py = row[j] + s.b_dec[j], yv = cmv > 0.f ? yrow[j] : 0.f;
      float g;
      if (a.poisson) {
        const float pyc = py > a.poisson_clamp ? a.poisson_clamp : py;
        const float ex = expf(pyc);
        e[0] += (ex - yv * pyc) * w;
        g = (ex - yv) * (py < a.poisson_clamp ? 1.f : 0.f) * inv_b;
      } else {
        const float r = yv - py;
        e[0] += r * r * w;
        g = -r * inv_lik * inv_b;
      }
      e[7] += w;
      row[j] = g * w;  // py becomes g_py
    }
  }
  for (int i = tid; i < nb * xd; i += NTHREADS) {
    const int b = i / xd;
    const float m = mcol[b];
    const float diff = s.pt_m[i] - qt_m[i];
    e[1] += diff * diff * m;
    e[2] += (a.trace_quirk ? expf(s.ptlv[b] + qt_lv[i] - slv)
                           : expf(s.ptlv[b] - slv) + expf(qt_lv[i] - slv)) * m;
    e[3] += qt_lv[i] * m;
    const float dx = s.xt[i] - s.xs[i];
    if (publish) c.g.dx[(size_t)first * xd + i] = dx;
    e[4] += dx * m;
    e[5] += dx * m * dx;
  }
  for (int b = tid; b < nb; b += NTHREADS) e[6] += s.fvf[b] * mcol[b];
  block_sum<8>(s.red, e);  // its barriers publish g_py
  if (tid == 0)
    for (int i = 0; i < 8; ++i) s.esum[i] = acc ? s.esum[i] + e[i] : e[i];

  // ---------------- manual backward (gradient batch-sums) ----------------
  // every product that contracts over the trials writes this block's
  // partial sum straight into its slab (adds to it past the first tile)
  const Mat g_py = rowmaj(s.py, s.ldy);
  if (a.sgd) {
    mm(nb, xd, yd, g_py, rowmaj(a.w_dec, xd), s.g_xt, xd, false, bf, false);
    if (a.train_decoder) {
      mm(yd, xd, nb, trans(s.py, s.ldy), rowmaj(s.xt, xd), slab + c.so.w_dec, xd, acc, bf,
         false, wf);
      col_sum(s.py, s.ldy, nb, yd, slab + c.so.b_dec, acc);
    }
    __syncthreads();
    for (int i = tid; i < nb * xd; i += NTHREADS) {
      const int b = i / xd, kk = i % xd;
      const float lv = qt_lv[i];
      const float gx = s.g_xt[i];
      float gm = gx;
      float glv = gx * eps_t[b * eps_ld + kk] * (0.5f * expf(0.5f * lv)) - 0.5f * inv_b;
      if (!a.warm_up) {
        gm = gm - (s.pt_m[i] - qt_m[i]) * (inv_sv * inv_b);
        if (a.trace_quirk)
          glv = glv + 0.5f * expf(s.ptlv[b] + lv - slv) * inv_b;
        else
          glv = glv + 0.5f * expf(lv - slv) * inv_b;
      }
      glv = glv * (fabsf(s.raw[i]) < a.logvar_clamp ? 1.f : 0.f);
      s.g_qm[i] = gm * mcol[b];
      s.g_qlv[i] = glv * mcol[b];
    }
    __syncthreads();
    const int wh = cdiv(xd, 16) * cdiv(hl, 8);
    mm(xd, hl, nb, trans(s.g_qm, xd), h_last, slab + c.so.wm, hl, acc, bf, false);
    mm(xd, hl, nb, trans(s.g_qlv, xd), h_last, slab + c.so.wlv, hl, acc, bf, false, wh);
    mm(nb, hl, xd, rowmaj(s.g_qm, xd), rowmaj(a.w_mean, hl), s.g_h, s.ldg, false, bf, false,
       2 * wh);
    mm(nb, hl, xd, rowmaj(s.g_qlv, xd), rowmaj(a.w_logvar, hl), s.g_h, s.ldg, true, bf, false,
       2 * wh);
    col_sum(s.g_qlv, xd, nb, xd, slab + c.so.blv, acc);
    __syncthreads();
    for (int l = L - 1; l >= 1; --l) {  // layers n..1
      const int hi = a.widths[l], hp = a.widths[l - 1];
      for (int i = tid; i < nb * hi; i += NTHREADS) {
        const int b = i / hi, j = i % hi;
        const float hv = ly[l].hs[(size_t)b * ly[l].ldh + j];
        s.g_a[(size_t)b * s.ldg + j] = s.g_h[(size_t)b * s.ldg + j] * (1.0f - hv * hv);
      }
      __syncthreads();
      mm(hi, hp, nb, trans(s.g_a, s.ldg), rowmaj(ly[l - 1].hs, ly[l - 1].ldh), slab + ly[l].gw, hp,
         acc, bf, false);
      col_sum(s.g_a, s.ldg, nb, hi, slab + ly[l].gb, acc);
      mm(nb, hp, hi, rowmaj(s.g_a, s.ldg), rowmaj(ly[l].w, hp), s.g_h, s.ldg, false, bf, true);
    }
    for (int i = tid; i < nb * h0; i += NTHREADS) {
      const int b = i / h0, j = i % h0;
      const float hv = ly[0].hs[(size_t)b * ly[0].ldh + j];
      s.g_a[(size_t)b * s.ldg + j] = s.g_h[(size_t)b * s.ldg + j] * (1.0f - hv * hv);
    }
    __syncthreads();
    const Mat g_at = trans(s.g_a, s.ldg);
    col_sum(s.g_a, s.ldg, nb, h0, slab + ly[0].gb, acc);
    if (u) mm(h0, ud, nb, g_at, rowmaj(u, s.ldu), slab + c.so.w_in_u, ud, acc, bf, false);
    mm(h0, yd, nb, g_at, rowmaj(y, s.ldy), slab + c.so.w_in_y, yd, acc, bf, false);
    mm(h0, xd, nb, g_at, rowmaj(qs_m, xd), slab + c.so.w_in_m, xd, acc, bf, false);
    mm(h0, xd, nb, g_at, rowmaj(qs_lv, xd), slab + c.so.w_in_lv, xd, acc, bf, false);
  }
}

// Phase 1 on this block's trials, tile by tile (tile_forward_sums): forward,
// ELBO sums, manual backward, every batch mean scaled by `inv_b` (1 / the
// step's valid trials of the whole batch). The gradient sums land in this
// block's slab in the flat order, its raw scalar sums behind them; with
// `publish` every trial's features (a masked trial's as 0) and dx go to the
// workspace, for stat_rows and the post-update residual. Writes the
// posterior (shared memory buffer 1 - cur, and q_pack; with `freeze` a
// masked trial's is its input) and xs, xt where asked; updates no carry
// leaf. Tile k + 1's inputs are fetched while tile k computes. Ends with the
// prefetch of step t + 1 and a cluster barrier that publishes the slabs.
template <bool TILED, bool BIG>
__device__ __forceinline__ void step_forward_sums(const VJFArgs& a, const Ctx& c,
                                                  const CarryScalars& cs, int t, int cur,
                                                  float inv_b, bool publish, bool freeze) {
  const int tid = threadIdx.x;
  const SM& s = c.s;
  const int nb = c.tr.n, xd = a.xd, tiles = n_tiles<TILED>(a, c);
  for (int k = 0; k < tiles; ++k) {
    const Tile tk = tile_of<TILED>(a, c, k);
    if (k > 0) {  // tile k's inputs, behind every thread's last read of tile k - 2's
      cp_async_wait_all();
      __syncthreads();
      if (a.mask || a.cmask) {
        mask_tile(a, c, tk);
        __syncthreads();
      }
    }
    if (k + 1 < tiles) {
      fetch_tile(a, c, t, tile_of<TILED>(a, c, k + 1));
      cp_async_commit();
    }
    tile_forward_sums<TILED>(a, c, cs, t, cur, inv_b, publish, freeze, tk);
  }
  __syncthreads();

  // the RLS raw statistics F^T F and F^T dx are taken in phase 2 by rows, each
  // block over every trial (stat_rows), from the features and dx published
  // above: as a partial sum, each block's would have all nfp x nfp entries
  if (freeze && a.mask) {
    // the frozen carry: every read of this step's posterior is behind us
    float *qt_m = s.q[1 - cur][0], *qt_lv = s.q[1 - cur][1];
    const float *qs_m = s.q[cur][0], *qs_lv = s.q[cur][1];
    for (int i = tid; i < nb * xd; i += NTHREADS)
      if (!(s.mcol[i / xd] > 0.f)) {
        qt_m[i] = qs_m[i];
        qt_lv[i] = qs_lv[i];
      }
  }

  // grad_check: the sum of every gradient entry is finite iff each one is
  // (the leaves the flags leave uncomputed are 0 in the slab)
  float gc[1] = {a.sgd ? sum_of(c.slab, c.so.ftf) : 0.f};
  block_sum<1>(s.red, gc);
  if (tid == 0) {
    float* sc = c.slab + c.so.ftf;
    for (int i = 0; i < 7; ++i) sc[SC_ELBO + i] = s.esum[i];
    sc[SC_GRAD] = gc[0];
    sc[SC_CM] = s.esum[7];
  }
  if (t + 1 < a.T) fetch_inputs<TILED, BIG>(a, c, t + 1);
  cluster_sync();
}

// The batch scalars from every block's raw sums, in rank order: the same
// bits in every thread of the cluster.
__device__ __forceinline__ StepSums reduce_scalars(const VJFArgs& a, const Ctx& c,
                                                   const CarryScalars& cs, float inv_b,
                                                   float count) {
  const bool rls = a.update && a.update_transition;
  if (threadIdx.x <= SC_CM) c.s.bc[threadIdx.x] = rank_sum(c, c.so.ftf + threadIdx.x);
  __syncthreads();
  float e[SC_CM + 1];
  for (int i = 0; i <= SC_CM; ++i) e[i] = c.s.bc[i];
  __syncthreads();
  StepSums r;
  r.count = count;
  r.cm_sum = a.cmask ? e[SC_CM] : 0.f;
  r.recon_batch = a.poisson ? e[0] * inv_b : 0.f;
  r.sq_y = a.poisson ? 0.f : e[0];
  r.dyn_batch = e[1] * expf(-cs.slv) * inv_b + e[2] * inv_b;
  r.ent = 0.5f * e[3] * inv_b;
  r.dx_sum = rls ? e[4] : 0.f;
  r.dx2_sum = rls ? e[5] : 0.f;
  r.fvf_sum = rls ? e[6] : 0.f;
  r.g_lik_lv_batch = a.sgd && !a.poisson ? -0.5f * r.sq_y * expf(-cs.lik_lv) * inv_b : 0.f;
  r.grad_check = a.sgd ? e[SC_GRAD] + r.g_lik_lv_batch : 0.f;
  return r;
}

// The parameter that element i of the flat buffer's gradient part updates,
// or null (a leaf the flags leave out): a hidden layer's weight or bias from
// the layer table, any other from the leaves.
__device__ __forceinline__ float* leaf_at(const VJFArgs& a, const Ctx& c, int i) {
  if (i >= (int)c.so.hidden && i < (int)c.so.wm) {
    for (int l = 0; l < a.n_layers; ++l) {
      const Layer& y = c.ly[l];
      if (l > 0 && i >= (int)y.gw && i < (int)y.gw + a.widths[l] * a.widths[l - 1])
        return y.w + (i - (int)y.gw);
      if (i >= (int)y.gb && i < (int)y.gb + a.widths[l]) return y.b + (i - (int)y.gb);
    }
    return nullptr;
  }
  for (int l = 0; l < c.n_leaves; ++l)
    if (i >= c.lv[l].off && i < c.lv[l].off + c.lv[l].len) return c.lv[l].p + (i - c.lv[l].off);
  return nullptr;
}

// Clipped SGD of this block's contiguous share of the gradient part of the
// flat buffer: p -= lr * clip(sum over the slabs), whatever leaf an element
// belongs to, so that every load of a thread's elements is in flight at once.
__device__ __forceinline__ void sgd_slice(const VJFArgs& a, const Ctx& c) {
  const Blk b = block_of((int)c.so.ftf, c.rank);
  for (int i = b.first + threadIdx.x; i < b.first + b.n; i += NTHREADS) {
    float* p = leaf_at(a, c, i);
    if (p) *p = *p - c.lr * clampf(rank_sum(c, (size_t)i), -a.clip, a.clip);
  }
}

// One thread's 4 x 4 tile of a panel product over k in [lo, hi), in k order:
// rows r0.. of A (shared, leading dim lda; rows past n read as 0) times the
// staged rows of B, row k at st + k nfp, columns c0..c0 + 3.
__device__ __forceinline__ void panel_tile(float (&acc)[4][4], const float* A, int lda, int n,
                                           const float* st, int nfp, int r0, int c0, int lo,
                                           int hi) {
  for (int k = lo; k < hi; k += 4) {
    float av[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = r0 + i < n ? *reinterpret_cast<const float4*>(A + (size_t)(r0 + i) * lda + k)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      av[i][0] = v.x, av[i][1] = v.y, av[i][2] = v.z, av[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(st + (size_t)(k + kk) * nfp + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] += av[i][kk] * bv.x;
        acc[i][1] += av[i][kk] * bv.y;
        acc[i][2] += av[i][kk] * bv.z;
        acc[i][3] += av[i][kk] * bv.w;
      }
    }
  }
}

// out rows [row0, row0 + n) of alpha * A B + diag * I, all in full f32: A
// is a row panel in shared memory (n x nfp, leading dim lda, at most prow
// rows), B the whole nfp x nfp matrix in global memory. B is staged into
// shared memory with 16-byte cp.async: whole when kc is nfp (up to 128
// padded features), else in chunks of kc rows through two buffers (chunk
// i + 1 arrives while chunk i is multiplied), each thread's tiles in rounds
// when they outnumber the threads. Each thread takes a 4 x 4 tile of the
// panel over one of `ks` slices of K and accumulates it in k order, over the
// chunks too, so the chunking leaves the bits as they are; the slices are
// added in order. The rows go to out_g (global, leading dim nfp) and, if
// given, to out_s (shared, leading dim lda; may be A itself). Ends with
// __syncthreads().
template <bool TILED>
__device__ __forceinline__ void panel_rows(const Ctx& c, int nfp, int kc, int n, int row0,
                                           int prow, const float* A, int lda, const float* B,
                                           float alpha, float diag, float* out_g, float* out_s) {
  const SM& s = c.s;
  const int tiles_c = nfp / 4, tiles = cdiv(prow, 4) * tiles_c;
  const int ks = panel_ksplit(prow, nfp);
  const int kchunk = cdiv(cdiv(nfp, ks), 4) * 4;
  const size_t pstride = (size_t)cdiv(prow, 4) * 4 * nfp;
  const int chunks = TILED ? nfp / kc : 1;
  for (int round = 0; round < tiles * ks; round += NTHREADS) {
    const int item = round + threadIdx.x;
    const bool active = item < tiles * ks;
    const int slice = item / tiles, tile = item % tiles;
    const int r0 = (tile / tiles_c) * 4, c0 = (tile % tiles_c) * 4;
    const int kb = slice * kchunk, ke = kb + kchunk < nfp ? kb + kchunk : nfp;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int i = threadIdx.x; i < kc * nfp / 4; i += NTHREADS)
      cp_async16(s.stage + 4 * (size_t)i, B + 4 * (size_t)i);
    cp_async_commit();
    if (chunks == 1) {  // the whole matrix at once
      cp_async_wait_all();
      __syncthreads();
      if (active) panel_tile(acc, A, lda, n, s.stage, nfp, r0, c0, kb, ke);
    } else {
      for (int ch = 0; ch < chunks; ++ch) {
        const float* stage = s.stage + (size_t)(ch & 1) * kc * nfp;
        if (ch + 1 < chunks) {  // the next chunk into the other buffer
          float* next = s.stage + (size_t)((ch + 1) & 1) * kc * nfp;
          const float* src = B + (size_t)(ch + 1) * kc * nfp;
          for (int i = threadIdx.x; i < kc * nfp / 4; i += NTHREADS)
            cp_async16(next + 4 * (size_t)i, src + 4 * (size_t)i);
          cp_async_commit();
          cp_async_wait_group<1>();
        } else {
          cp_async_wait_all();
        }
        __syncthreads();
        const int k0 = ch * kc, lo = kb > k0 ? kb : k0, hi = ke < k0 + kc ? ke : k0 + kc;
        if (active) panel_tile(acc, A, lda, n, stage - (size_t)k0 * nfp, nfp, r0, c0, lo, hi);
        __syncthreads();  // every read of this buffer is done before its refill
      }
    }
    if (active) {
      float* p = s.part + slice * pstride + (size_t)r0 * nfp + c0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(p + (size_t)i * nfp) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    if (round + NTHREADS < tiles * ks) __syncthreads();  // the stage, before the next round's
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * nfp; idx += NTHREADS) {
    const int il = idx / nfp, col = idx % nfp;
    float v = s.part[idx];
    for (int slice = 1; slice < ks; ++slice) v += s.part[slice * pstride + idx];
    v = alpha * v;
    if (row0 + il == col) v += diag;
    out_g[(size_t)(row0 + il) * nfp + col] = v;
    if (out_s) out_s[(size_t)il * lda + col] = v;
  }
  __syncthreads();
}

// This block's rows [fr.first, fr.first + fr.n) of alpha * A B + diag * I
// (panel_rows), A this block's row panel (leading dim lda). Resident (not
// BIG): A in shared memory, the rows also to out_s. BIG: A's rows in L2,
// taken in sub-panels of sp rows, each staged into s.pan_p with 16-byte
// cp.async (it arrives with B's first chunk) and multiplied against the
// whole of B; the rows go to out_g only. The caller publishes out_g with a
// cluster barrier.
template <bool TILED, bool BIG>
__device__ __forceinline__ void panel_product(const Ctx& c, int nfp, int kc, int sp,
                                              const float* A, int lda, const float* B,
                                              float alpha, float diag, float* out_g,
                                              float* out_s) {
  if (!BIG) {
    panel_rows<TILED>(c, nfp, kc, c.fr.n, c.fr.first, cdiv(nfp, VJF_CLUSTER), A, lda, B, alpha,
                      diag, out_g, out_s);
    return;
  }
  const int q = nfp / 4;
  for (int s0 = 0; s0 < c.fr.n; s0 += sp) {
    const int n = c.fr.n - s0 < sp ? c.fr.n - s0 : sp;
    for (int i = threadIdx.x; i < n * q; i += NTHREADS)
      cp_async16(c.s.pan_p + (size_t)(i / q) * c.s.ldf + 4 * (i % q),
                 A + (size_t)(s0 + i / q) * lda + 4 * (i % q));
    panel_rows<TILED>(c, nfp, kc, n, c.fr.first + s0, sp, c.s.pan_p, c.s.ldf, B, alpha, diag,
                      out_g, nullptr);
  }
}

// This block's rows of the RLS raw statistics over every trial of the launch,
// behind the barrier that ends phase 1: ftf (fr.n x nfp, leading dim ldf) =
// rows of F^T F and fxd (fr.n x xd) = rows of F^T dx.
__device__ __forceinline__ void stat_rows(const VJFArgs& a, const Ctx& c, float* ftf, int ldf,
                                          float* fxd) {
  const Mat ft = Mat{c.g.feat + c.fr.first, 1, a.nfp};  // rows of F^T
  const bool bf = a.bf16 != 0;
  mm(c.fr.n, a.nfp, a.B, ft, rowmaj(c.g.feat, a.nfp), ftf, ldf, false, bf, false);
  mm(c.fr.n, a.xd, a.B, ft, rowmaj(c.g.dx, a.xd), fxd, a.xd, false, bf, true,
     cdiv(c.fr.n, 16) * cdiv(a.nfp, 8));
}

// Phase 2 across the cluster: the ELBO with its constants, clipped SGD,
// the obs-noise running variance, RLS with Newton-Schulz tracking of V and
// the state-noise running variance, all in place; then the scalar row of
// step t. Every block has passed the barrier that ends phase 1. Ends behind
// a cluster barrier: every carry leaf is published for the next step. BIG:
// P_new's and V_new's rows in the L2 workspace, the iterate's rows, P's old
// rows, w and g read where they lie (panel_product stages sub-panels).
template <bool TILED, bool BIG>
__device__ __forceinline__ void step_apply(const VJFArgs& a, const Ctx& c, CarryScalars& cs,
                                           const StepSums& p, int t, float inv_b) {
  const int tid = threadIdx.x;
  const SM& s = c.s;
  const int yd = a.yd, xd = a.xd, nfp = a.nfp;
  const bool bf = a.bf16 != 0;
  const bool rls = a.update && a.update_transition;
  const float slv = cs.slv, lik_lv = cs.lik_lv;
  const int fr0 = c.fr.first, frn = c.fr.n;
  float* g_vec = a.g_vec ? a.g_vec : c.g.g_vec;

  // under a trial mask the step's valid trials replace B (count is B
  // without one); a step without data trains nothing
  const bool masked = a.mask != nullptr, has_cm = a.cmask != nullptr;
  const bool has_data = p.count > 0.f;
  bool sgd_ok = false;
  float l_recon, l_dyn, h_ent, loss;
  {
    // ---------------- ELBO components with their constants ----------------
    float obs_mse = 0.f;
    if (a.poisson) {
      l_recon = p.recon_batch;
    } else if (has_cm) {
      // the log-variance constant and the mse per observed entry
      l_recon = 0.5f * (p.sq_y * expf(-lik_lv) * inv_b + p.cm_sum * inv_b * lik_lv);
      obs_mse = p.sq_y / fmaxf(p.cm_sum, 1.f);
    } else {
      l_recon = 0.5f * (p.sq_y * expf(-lik_lv) * inv_b + (float)yd * lik_lv);
      obs_mse = p.sq_y * inv_b / (float)yd;
    }
    l_dyn = 0.5f * (p.dyn_batch + (float)xd * slv);
    h_ent = p.ent;
    if (masked && !has_data) l_recon = l_dyn = h_ent = 0.f;
    bool raw_ok = isfinite(l_recon) && isfinite(h_ent);
    if (!a.warm_up) raw_ok = raw_ok && isfinite(l_dyn);
    l_recon = isfinite(l_recon) ? l_recon : 0.f;
    l_dyn = isfinite(l_dyn) ? l_dyn : 0.f;
    h_ent = isfinite(h_ent) ? h_ent : 0.f;
    loss = l_recon - h_ent + (a.warm_up ? 0.f : l_dyn);

    // ---------------- clipped SGD, each block its slice of each leaf ----------------
    float lik_lv_new = lik_lv;
    if (a.sgd) {
      sgd_ok = raw_ok && isfinite(p.grad_check);
      if (sgd_ok) {
        sgd_slice(a, c);
        if (!a.poisson) {
          const float g_const = has_cm ? 0.5f * p.cm_sum * inv_b
                                       : (!masked || has_data ? 0.5f * (float)yd : 0.f);
          lik_lv_new = lik_lv - c.lr * clampf(p.g_lik_lv_batch + g_const, -a.clip, a.clip);
        }
      }
    }

    // ---------------- obs-noise running variance (Gaussian) ----------------
    if (a.update && !a.poisson && a.update_likelihood) {
      // the count advances by the valid trials, or the fractional rows of
      // observed entries under a channel mask
      const float adv = has_cm ? p.cm_sum / (float)yd : p.count;
      const float n = cs.lik_n < a.obs_var_cap ? cs.lik_n : a.obs_var_cap;
      const float tot = n + adv;
      const float var = (n / tot) * expf(lik_lv_new) + (adv / tot) * obs_mse;
      if (isfinite(var)) {
        lik_lv_new = clampf(logf(var), -a.logvar_clamp, a.logvar_clamp);
        cs.lik_n = tot;
      }
    }
    cs.lik_lv = lik_lv_new;
  }

  // ---------------- RLS with Newton-Schulz tracking of V ----------------
  float tau = 0.f;
  if (rls) {
    const bool dyn_ok = isfinite(p.dx_sum) && (!masked || has_data);
    if (!a.warm_up) {
      const float lam = a.rls_shrink, jit = a.chol_jitter;
      const float inv_sv_u = expf(-slv);
      // this block's rows of P_new, of F^T dx / sv, and of the iterate V / lam
      float* pan_p = BIG ? c.g.p_new + (size_t)fr0 * nfp : s.pan_p;
      const int ldp = BIG ? nfp : s.ldf;
      float* ftf = BIG ? pan_p : s.part;  // BIG: P_new replaces F^T F in place
      stat_rows(a, c, ftf, nfp, s.gown);
      for (int idx = tid; idx < frn * nfp; idx += NTHREADS) {
        const int il = idx / nfp, col = idx % nfp, r = fr0 + il;
        const size_t gi = (size_t)r * nfp + col;
        // the fused multiply-add spelled out: left to the compiler, which
        // product it fuses changed with unrelated code around it, and with it
        // the last bit of P (and every later bit of V and w)
        float pv = __fmaf_rn(lam, a.p_mat[gi], __fmul_rn(ftf[idx], inv_sv_u));
        if (lam != 1.0f || jit != 0.0f) {
          const float dg = r == col ? 1.f : 0.f;
          const float pad = r >= a.nf ? dg : 0.f;
          pv = pv + (1.0f - lam) * pad + jit * (dg - pad);
        }
        pan_p[(size_t)il * ldp + col] = pv;
        if (!BIG) s.vnew[idx] = a.p_mat[gi];  // the old rows, for P w
        const float x = lam != 1.0f ? a.v_mat[gi] / lam : a.v_mat[gi];
        if (!BIG) s.pan_x[(size_t)il * s.ldf + col] = x;
        if (lam != 1.0f) c.g.ns_a[gi] = x;
      }
      for (int i = tid; i < frn * xd; i += NTHREADS) s.gown[i] = s.gown[i] * inv_sv_u;
      if (!BIG)
        for (int i = tid; i < nfp * xd; i += NTHREADS) s.small[i] = a.w_dyn[i];
      __syncthreads();
      // g = lam P w + F^T dx / sv, full f32
      mm(frn, xd, nfp, rowmaj(BIG ? a.p_mat + (size_t)fr0 * nfp : s.vnew, nfp),
         rowmaj(BIG ? a.w_dyn : s.small, xd), s.wnew, xd, false, false, true);
      for (int i = tid; i < frn * xd; i += NTHREADS)
        g_vec[(size_t)fr0 * xd + i] = lam * s.wnew[i] + s.gown[i];
      tau = p.fvf_sum * inv_sv_u / lam;
      // the mega segment skips the update at tau >= NS_TAU_MAX, so its
      // Newton-Schulz result would be discarded
      bool ns_ok = !(a.mega && !(tau < NS_TAU_MAX));
      float* vnew = BIG ? c.g.v_new + (size_t)fr0 * nfp : s.vnew;
      cluster_sync();  // g_vec and the scaled iterate are whole
      if (ns_ok) {
        const float* x = lam != 1.0f ? c.g.ns_a : a.v_mat;
        int iters = a.ns_iters;
        if (a.mega) {
          if (tau >= NS_TAU_ESCALATE) iters += 1;
          if (tau >= NS_TAU_THRESHOLD) iters += NS_EXTRA_ITERS;
        }
        for (int it = 0; it < iters; ++it) {
          // X <- X (2I - P X), every product full f32
          panel_product<TILED, BIG>(c, nfp, a.kc, a.sp, pan_p, ldp, x, -1.f, 2.f, c.g.ns_t,
                                    nullptr);
          cluster_sync();
          float* nx = (x == c.g.ns_a) ? c.g.ns_b : c.g.ns_a;
          panel_product<TILED, BIG>(c, nfp, a.kc, a.sp, BIG ? x + (size_t)fr0 * nfp : s.pan_x,
                                    BIG ? nfp : s.ldf, c.g.ns_t, 1.f, 0.f, nx, s.pan_x);
          cluster_sync();
          x = nx;
        }
        // this block's rows of V_new = (X + X^T) / 2 and of w_new = V_new g
        for (int idx = tid; idx < frn * nfp; idx += NTHREADS) {
          const int il = idx / nfp, col = idx % nfp;
          const float own = BIG ? x[(size_t)(fr0 + il) * nfp + col]
                                : s.pan_x[(size_t)il * s.ldf + col];
          vnew[idx] = 0.5f * (own + x[(size_t)col * nfp + fr0 + il]);
        }
        if (!BIG)
          for (int i = tid; i < nfp * xd; i += NTHREADS) s.small[i] = g_vec[i];
        __syncthreads();
        mm(frn, xd, nfp, rowmaj(vnew, nfp), rowmaj(BIG ? g_vec : s.small, xd), s.wnew, xd, false,
           false, true);
        float fs[1] = {sum_of(vnew, (size_t)frn * nfp) + sum_of(s.wnew, (size_t)frn * xd)};
        block_sum<1>(s.red, fs);
        if (tid == 0) c.slab[c.so.ftf + SC_FINITE] = fs[0];
        cluster_sync();
        ns_ok = isfinite(rank_sum(c, c.so.ftf + SC_FINITE));
        if (a.mega) ns_ok = ns_ok && (tau < NS_TAU_MAX);
      }
      // every block is past its last read of V and w: overwrite our rows
      const bool upd_ok = dyn_ok && ns_ok;
      const bool p_keep = a.mega ? upd_ok : dyn_ok;
      for (int idx = tid; idx < frn * nfp; idx += NTHREADS) {
        const size_t gi = (size_t)fr0 * nfp + idx;
        if (p_keep) a.p_mat[gi] = pan_p[(size_t)(idx / nfp) * ldp + idx % nfp];
        if (upd_ok) a.v_mat[gi] = vnew[idx];
      }
      if (upd_ok)
        for (int i = tid; i < frn * xd; i += NTHREADS) a.w_dyn[(size_t)fr0 * xd + i] = s.wnew[i];
      tau = dyn_ok ? (ns_ok ? tau : __int_as_float(0x7f800000)) : 0.f;
      cluster_sync();  // the new w is whole
    }
    // state-noise running variance from the post-update residual, tile by
    // tile from the features and dx that phase 1 published
    float ms[1] = {0.f};
    for (int k = 0, tiles = n_tiles<TILED>(a, c); k < tiles; ++k) {
      const Tile tk = tile_of<TILED>(a, c, k);
      const size_t first = (size_t)c.tr.first + tk.r0;
      mm(tk.n, xd, nfp, rowmaj(c.g.feat + first * nfp, nfp), rowmaj(a.w_dyn, xd), s.tmp, xd,
         false, bf, true);
      for (int i = tid; i < tk.n * xd; i += NTHREADS) {
        const float r = c.g.dx[first * xd + i] - s.tmp[i];
        ms[0] += r * r * s.mcol[tk.r0 + i / xd];
      }
      if (k + 1 < tiles) __syncthreads();
    }
    block_sum<1>(s.red, ms);
    if (tid == 0) c.slab[c.so.ftf + SC_RESID] = ms[0];
    cluster_sync();
    const float mse = rank_sum(c, c.so.ftf + SC_RESID) / (fmaxf(p.count, 1.f) * (float)xd);
    const float n = cs.dyn_n < a.state_var_cap ? cs.dyn_n : a.state_var_cap;
    const float tot = n + p.count;
    const float var = (n / tot) * expf(slv) + (p.count / tot) * mse;
    if (isfinite(var)) {
      cs.slv = clampf(logf(var), -a.logvar_clamp, a.logvar_clamp);
      cs.dyn_n = tot;
    }
  } else {
    cluster_sync();  // the SGD updates are whole
  }
  if (!(rls && !a.warm_up)) {
    // no RLS target
    for (int i = tid; i < frn * xd; i += NTHREADS) g_vec[(size_t)fr0 * xd + i] = 0.f;
  }

  if (c.rank == 0 && tid == 0) {
    float* row = a.scal + (size_t)t * 8;
    row[0] = loss;
    row[1] = -l_recon;
    row[2] = -l_dyn;
    row[3] = h_ent;
    row[4] = tau;
    row[5] = row[6] = row[7] = 0.f;
  }
}

template <typename P>
__device__ __forceinline__ void member_shift(P*& p, size_t per_member, int m) {
  if (p) p += (size_t)m * per_member;
}

// Moves every per-member pointer of `a` but the hidden layers' (make_header
// moves those in the layer table) to member m's slice. Each leaf's size
// follows from the dims, so the caller passes only n_members and the shared
// bits. The members never wait on each other: clusters past what the card
// holds at once run in a later wave.
__device__ void to_member(VJFArgs& a, int m) {
  if (m == 0) return;
  const size_t T = a.T, B = a.B, yd = a.yd, ud = a.ud, xd = a.xd, nfp = a.nfp;
  const size_t h0 = a.widths[0], hl = a.widths[a.n_layers - 1];
  member_shift(a.w_in_y, h0 * yd, m);
  member_shift(a.w_in_u, h0 * ud, m);
  member_shift(a.w_in_m, h0 * xd, m);
  member_shift(a.w_in_lv, h0 * xd, m);
  member_shift(a.w_mean, xd * hl, m);
  member_shift(a.w_logvar, xd * hl, m);
  member_shift(a.b_logvar, xd, m);
  member_shift(a.w_dec, yd * xd, m);
  member_shift(a.b_dec, yd, m);
  member_shift(a.cent_x, nfp * xd, m);
  member_shift(a.cent_u, nfp * ud, m);
  member_shift(a.c2, nfp, m);
  member_shift(a.inv_w2, nfp, m);
  member_shift(a.w_white, nfp * nfp, m);
  member_shift(a.scale2, 1, m);
  member_shift(a.p_mat, nfp * nfp, m);
  member_shift(a.v_mat, nfp * nfp, m);
  member_shift(a.w_dyn, nfp * xd, m);
  member_shift(a.state_logvar, 1, m);
  member_shift(a.lik_logvar, 1, m);
  member_shift(a.dyn_n, 1, m);
  member_shift(a.lik_n, 1, m);
  member_shift(a.rng_seed, 1, m);
  member_shift(a.rng_count, 1, m);
  member_shift(a.qs_m, B * xd, m);
  member_shift(a.qs_lv, B * xd, m);
  if (!(a.shared & SHARED_Y)) member_shift(a.y, T * B * yd, m);
  if (!(a.shared & SHARED_U)) member_shift(a.u, T * B * ud, m);
  member_shift(a.eps_s, T * B * xd, m);
  member_shift(a.eps_t, T * B * xd, m);
  member_shift(a.q_pack, T * 2 * B * xd, m);
  member_shift(a.scal, T * 8, m);
  member_shift(a.g_vec, nfp * xd, m);
  member_shift(a.xt, B * xd, m);
  member_shift(a.xs, B * xd, m);
  member_shift(a.sums, sums_offsets(a).total, m);
  member_shift(a.ws, carve_global(a, nullptr).total, m);
}

__device__ __forceinline__ void add_leaf(Leaf* lv, int& n, float* p, size_t off, int len) {
  lv[n++] = Leaf{p, (int)off, len};
}

// What every kernel sets up: the arguments, the context, the layer table, the
// SGD leaves and the widths in the head of the block's shared memory (thread
// 0 writes them; carve_smem's head_floats), this block's slab zeroed (a leaf
// the flags leave uncomputed stays 0), the RBF constants.
__device__ const Header& make_header(const VJFArgs& args, float* smem) {
  Header* h = reinterpret_cast<Header*>(smem);
  const int L = args.n_layers;
  Layer* ly = reinterpret_cast<Layer*>(h + 1);
  Leaf* lv = reinterpret_cast<Leaf*>(ly + L);
  int* widths = reinterpret_cast<int*>(lv + MAX_LEAVES);
  if (threadIdx.x == 0) {
    const int m = blockIdx.y;
    for (int l = 0; l < L; ++l) {
      const LayerArg in = args.layers[l];
      widths[l] = (int)in.h;
      ly[l].w = in.w;
      ly[l].b = in.b;
      if (l > 0) member_shift(ly[l].w, (size_t)widths[l] * widths[l - 1], m);
      member_shift(ly[l].b, (size_t)widths[l], m);
    }
    h->a = args;
    h->a.widths = widths;
    to_member(h->a, m);
    const VJFArgs& a = h->a;
    Ctx& c = h->c;
    c.ly = ly;
    c.lv = lv;
    c.s = carve_smem(a, smem, ly);
    c.g = carve_global(a, a.ws);
    c.so = sums_offsets(a, ly);
    c.rank = cluster_rank();
    c.tr = block_of(a.B, c.rank);
    c.fr = block_of(a.nfp, c.rank);
    if (a.sp) {
      // past the shared memory: this block's trials' state in L2, the
      // (rows, 2 xd) noise, the posterior pairs and the 0/1 mask column
      const size_t B = a.B, xd = a.xd, f = c.tr.first;
      c.s.eps = c.g.trials + f * 2 * xd;
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) c.s.q[i][j] = c.g.trials + (2 + 2 * i + j) * B * xd + f * xd;
      c.s.mcol = c.g.trials + 6 * B * xd + f;
    }
    c.slab = c.g.slab + (size_t)c.rank * c.g.slab_stride;
    c.lr = a.lr ? a.lr[0] : 0.f;
    c.scale2 = a.scale2 ? a.scale2[0] : 0.f;
    c.seed = (uint32_t)a.rng_seed[0];
    const int h0 = widths[0], hl = widths[L - 1];
    int n = 0;
    add_leaf(lv, n, a.w_in_y, c.so.w_in_y, h0 * a.yd);
    if (a.ud > 0) add_leaf(lv, n, a.w_in_u, c.so.w_in_u, h0 * a.ud);
    add_leaf(lv, n, a.w_in_m, c.so.w_in_m, h0 * a.xd);
    add_leaf(lv, n, a.w_in_lv, c.so.w_in_lv, h0 * a.xd);
    add_leaf(lv, n, a.w_mean, c.so.wm, a.xd * hl);
    add_leaf(lv, n, a.w_logvar, c.so.wlv, a.xd * hl);
    add_leaf(lv, n, a.b_logvar, c.so.blv, a.xd);
    if (a.train_decoder) {
      add_leaf(lv, n, a.w_dec, c.so.w_dec, a.yd * a.xd);
      add_leaf(lv, n, a.b_dec, c.so.b_dec, a.yd);
    }
    c.n_leaves = n;
  }
  __syncthreads();
  const VJFArgs& a = h->a;
  const Ctx& c = h->c;
  for (size_t i = threadIdx.x; i < c.so.ftf; i += NTHREADS) c.slab[i] = 0.f;
  // the centroids transposed: (xd, nfp) and (ud, nfp)
  for (int i = threadIdx.x; i < a.nfp * a.xd; i += NTHREADS)
    c.s.cent_x[(i % a.xd) * a.nfp + i / a.xd] = a.cent_x[i];
  for (int i = threadIdx.x; i < a.nfp * a.ud; i += NTHREADS)
    c.s.cent_u[(i % a.ud) * a.nfp + i / a.ud] = a.cent_u[i];
  for (int i = threadIdx.x; i < a.nfp; i += NTHREADS) {
    c.s.c2[i] = a.c2[i];
    c.s.inv_w2[i] = a.inv_w2[i];
  }
  if (!a.mask)  // every trial valid: each weight is 1 for the whole launch
    for (int i = threadIdx.x; i < c.tr.n; i += NTHREADS) c.s.mcol[i] = 1.f;
  __syncthreads();
  return *h;
}

// The fused kernels' body: T steps, the carry updated in place.
template <bool TILED, bool BIG>
__device__ __forceinline__ void vjf_steps(const VJFArgs& args, float* smem) {
  const Header& h = make_header(args, smem);
  const VJFArgs& a = h.a;
  const Ctx& c = h.c;
  CarryScalars cs{a.state_logvar[0], a.lik_logvar[0], a.dyn_n[0], a.lik_n[0]};
  const uint32_t count0 = (uint32_t)a.rng_count[0];
  const bool publish = a.update && a.update_transition;  // RLS: the statistics and the residual
  fetch_inputs<TILED, BIG>(a, c, 0);
  for (int t = 0; t < a.T; ++t) {
    const int cur = t & 1;
    const float valid = step_begin<TILED, BIG>(a, c, t, cur, count0 + (uint32_t)t);
    const float inv_b = 1.0f / fmaxf(valid, 1.0f);  // 1 / B without a trial mask
    step_forward_sums<TILED, BIG>(a, c, cs, t, cur, inv_b, publish, true);
    const StepSums p = reduce_scalars(a, c, cs, inv_b, valid);
    step_apply<TILED, BIG>(a, c, cs, p, t, inv_b);
  }
  // every block read these at its start, before the first barrier
  if (c.rank == 0 && threadIdx.x == 0) {
    a.state_logvar[0] = cs.slv;
    a.lik_logvar[0] = cs.lik_lv;
    a.dyn_n[0] = cs.dyn_n;
    a.lik_n[0] = cs.lik_n;
    a.rng_count[0] = (int)(count0 + (uint32_t)a.T);
  }
}

// Phase 1 of the sharded step alone (forward_sums_call): the flat FusedSums
// buffer and the q pack of this rank's B trials, with the caller's global
// inv_b (under a trial mask, 1 / the global valid count) and row offset of the
// noise; the q pack is not frozen. Reads the carry, writes none of it.
template <bool TILED, bool BIG>
__device__ __forceinline__ void vjf_sums(const VJFArgs& args, float* smem) {
  const Header& h = make_header(args, smem);
  const VJFArgs& a = h.a;
  const Ctx& c = h.c;
  const CarryScalars cs{a.state_logvar[0], a.lik_logvar[0], a.dyn_n[0], a.lik_n[0]};
  fetch_inputs<TILED, BIG>(a, c, 0);
  const float valid = step_begin<TILED, BIG>(a, c, 0, 0, (uint32_t)a.rng_count[0]);
  step_forward_sums<TILED, BIG>(a, c, cs, 0, 0, a.inv_b, a.update && a.update_transition,
                                false);
  const StepSums p = reduce_scalars(a, c, cs, a.inv_b, valid);
  const Blk b = block_of((int)c.so.ftf, c.rank);
  for (int i = b.first + threadIdx.x; i < b.first + b.n; i += NTHREADS)
    a.sums[i] = rank_sum(c, i);
  float* ftf = a.sums + c.so.ftf + (size_t)c.fr.first * a.nfp;
  float* fxd = a.sums + c.so.fxd + (size_t)c.fr.first * a.xd;
  if (a.update && a.update_transition) {
    stat_rows(a, c, ftf, a.nfp, fxd);
  } else {
    for (int i = threadIdx.x; i < c.fr.n * a.nfp; i += NTHREADS) ftf[i] = 0.f;
    for (int i = threadIdx.x; i < c.fr.n * a.xd; i += NTHREADS) fxd[i] = 0.f;
  }
  if (c.rank == 0 && threadIdx.x == 0) {
    float* tail = a.sums + c.so.scalars;
    const float v[N_SUM_SCALARS + 1] = {p.g_lik_lv_batch, p.recon_batch, p.dyn_batch, p.ent,
                                        p.sq_y, p.grad_check, p.fvf_sum, p.dx_sum, p.dx2_sum,
                                        p.cm_sum};
    for (int i = 0; i < N_SUM_SCALARS + (a.cmask ? 1 : 0); ++i) tail[i] = v[i];
  }
}

// ---------------------------------------------------------------------------
// Kernels and the C interface (ctypes)
// ---------------------------------------------------------------------------

extern __shared__ float4 vjf_smem[];

template <bool TILED, bool BIG>
__global__ void __launch_bounds__(NTHREADS, 1) vjf_kernel(VJFArgs a) {
  vjf_steps<TILED, BIG>(a, reinterpret_cast<float*>(vjf_smem));
}

template <bool TILED, bool BIG>
__global__ void __launch_bounds__(NTHREADS, 1) vjf_sums_kernel(VJFArgs a) {
  vjf_sums<TILED, BIG>(a, reinterpret_cast<float*>(vjf_smem));
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

typedef void (*vjf_kernel_t)(VJFArgs);

// A planned launch takes the one-pass instantiation where a block's trials
// are one tile and the panel operand is staged whole, the L2 one (BIG) where
// the trials' state and the panels do not fit in shared memory (sp), else
// the tiled one.
static bool one_pass(const VJFArgs& a) {
  return a.sp == 0 && a.tile >= cdiv(a.B, VJF_CLUSTER) && a.kc == a.nfp;
}

static vjf_kernel_t steps_kernel(const VJFArgs& a) {
  if (a.sp) return vjf_kernel<true, true>;
  return one_pass(a) ? vjf_kernel<false, false> : vjf_kernel<true, false>;
}

static vjf_kernel_t sums_kernel(const VJFArgs& a) {
  if (a.sp) return vjf_sums_kernel<true, true>;
  return one_pass(a) ? vjf_sums_kernel<false, false> : vjf_sums_kernel<true, false>;
}

// One cluster of VJF_CLUSTER blocks a member (n_members clusters along y) with
// the dynamic shared memory the shapes ask for; `a` is planned (plan_tiles).
static cudaError_t launch_config(vjf_kernel_t kernel, const VJFArgs& a, cudaStream_t stream,
                                 cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t smem = carve_smem(a, nullptr).total * sizeof(float);
  if (smem > MAX_SMEM_BYTES || a.nfp % 4 != 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       MAX_SMEM_BYTES);
  if (e != cudaSuccess) return e;
  if (VJF_CLUSTER > 8) {
    e = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(VJF_CLUSTER, a.n_members > 1 ? a.n_members : 1, 1);
  cfg->blockDim = dim3(NTHREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = VJF_CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

static int launch(bool sums, const VJFArgs& args, void* stream) {
  const VJFArgs a = plan_tiles(args);
  const vjf_kernel_t kernel = sums ? sums_kernel(a) : steps_kernel(a);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = launch_config(kernel, a, (cudaStream_t)stream, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" {

// Floats of a member's L2 workspace at the plan of plan_tiles.
size_t vjf_workspace_floats(const VJFArgs* a) {
  return carve_global(plan_tiles(*a), nullptr).total;
}

size_t vjf_args_size(void) { return sizeof(VJFArgs); }

// The bytes of one entry of the layer table (ops/fused_step.py:_layer_table).
size_t vjf_layer_arg_size(void) { return sizeof(LayerArg); }

// The offset of VJFArgs's last field: with the size, what the ctypes mirror
// checks (a field added before it can leave the size as it was).
size_t vjf_args_tail(void) { return offsetof(VJFArgs, inv_b); }

size_t vjf_sums_floats(const VJFArgs* a) { return sums_offsets(*a).total; }

// Bytes of dynamic shared memory a block needs at these shapes, at the
// plan plan_tiles chooses (the smallest where none fits); a launch is
// refused above vjf_smem_limit().
size_t vjf_smem_bytes(const VJFArgs* a) {
  return carve_smem(plan_tiles(*a), nullptr).total * sizeof(float);
}

size_t vjf_smem_limit(void) { return MAX_SMEM_BYTES; }

// How the fused kernel launches at these shapes: out[0] blocks in the
// cluster, [1] threads per block, [2] dynamic shared memory bytes, [3]
// clusters the card can hold at once, [4] registers per thread, [5] bytes of
// local memory per thread (spills), [6] trials a phase-1 tile, [7] rows a
// staged chunk of a panel product, [8] rows a staged sub-panel (0: the
// panels and the trials' state resident). Returns a cudaError.
int vjf_cluster_info(const VJFArgs* args, int* out) {
  const VJFArgs a = plan_tiles(*args);
  const vjf_kernel_t kernel = steps_kernel(a);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = launch_config(kernel, a, nullptr, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, (const void*)kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = VJF_CLUSTER;
  out[1] = NTHREADS;
  out[2] = (int)cfg.dynamicSmemBytes;
  out[3] = clusters;
  out[4] = fa.numRegs;
  out[5] = (int)fa.localSizeBytes;
  out[6] = a.tile;
  out[7] = a.kc;
  out[8] = a.sp;
  return 0;
}

// The two launchers are the two modes of vjf_kernel; each sets its own.
// One step (fused_step_call): NS_ITERS Newton-Schulz iterations, no
// escalation, no tau ceiling. The caller sets T = 1.
int vjf_fused_step(const VJFArgs* a, void* stream) {
  VJFArgs s = *a;
  s.mega = 0;
  s.ns_iters = NS_ITERS;
  return launch(false, s, stream);
}

// T steps in one launch (mega_epoch_call): the caller's base iterations
// (ns_iters), then the escalation and the NS_TAU_MAX skip.
int vjf_mega_epoch(const VJFArgs* a, void* stream) {
  VJFArgs m = *a;
  m.mega = 1;
  return launch(false, m, stream);
}

// Phase 1 of the sharded step (forward_sums_call): the caller sets T = 1,
// sums, inv_b and row0.
int vjf_forward_sums(const VJFArgs* a, void* stream) {
  return launch(true, *a, stream);
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
