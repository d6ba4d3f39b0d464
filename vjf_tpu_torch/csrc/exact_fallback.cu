// The exact-inverse fallback of a prefix step as one CUDA kernel,
// vjf_fallback_kernel, launched by vjf_exact_fallback (ops/fused_step.py:
// exact_v_fallback on CUDA tensors), for Hopper (sm_90a).
//
// Replaces no pallas_call: it is the exact branch of the JAX package's prefix
// step, the lax.cond of vjf_tpu/ops/pallas/fused_step.py:1357 around
// _exact_inverse_repair, which XLA runs on the TPU only where it is taken.
// The port's plain version (exact_v_fallback_plain) computes that branch on
// every prefix step as some 87 small PyTorch launches and selects it with
// torch.where, because a branch on the host would need a sync. Here the
// branch is taken on the device: each cluster reads its member's tau from
// the step's scalar row and returns at once where tau < NS_TAU_THRESHOLD,
// leaving the carry's bits as the step kernel wrote them. Where tau >= 0.25,
// inf or NaN it computes, in full f32 (no TF32, no bf16):
//   * the Cholesky factor L of the new precision P (left-looking, panels of
//     FB_TILE columns; info != 0 where a pivot is not > 0, as LAPACK's);
//   * the triangular inverse X of L by ceil(log2 n) Newton iterations
//     X <- X (2I - L X) from diag(1 / diag L), as ops/linalg.py:
//     tri_inv_newton and benchmark/reference/plain.py:exact_fallback;
//   * V = X^T X and w = V g;
//   * the post-update residual over the batch: the RBF features of xs (with
//     the controls where there are any, masked trials left out), whitened
//     for SGP (through w_white w, one product ahead of the trials), and the
//     state noise's running variance from the pre-step counters, clamped;
// and writes v_mat, w_dyn, state_logvar and dyn_n IN PLACE where the three
// gates of the plain version pass: the factorisation succeeded, V and w are
// finite (their sum), the variance is finite.
//
// What bounds it on this card: skipped, nothing but the launch (one float
// read). Taken, at the flagship's 128 padded features the work is about 11 M
// multiply-adds and some 200 KB of operands (a fraction of a microsecond at
// the card's f32 peak), but it is a chain of some thirty dependent phases
// (the Cholesky's panels, fourteen triangular products, V, w, the residual),
// each of which needs the whole result of the one before: latency, not
// operations or bytes, bounds it.
//
// What the design does about it:
//   * One thread-block cluster of VJF_CLUSTER blocks a member (gridDim.y, as
//     the step and mega kernels lay out an ensemble), so the chain's phases
//     are separated by cluster barriers, not by launches. The factor, the
//     inverse, its two iterates and V live in an L2 workspace (4 n^2 floats
//     a member: 256 KB at 128 padded features) and are read through L2
//     (ld.global.cg) after the barrier that published them.
//   * Every product works on 32 x 32 tiles of the lower triangle only (the
//     factor and both iterates are lower triangular), about a sixth of the
//     dense products' multiply-adds. Each tile of a product belongs to one
//     block (round robin over the lower tiles), which stages the operand
//     tiles in shared memory and sums over k in order: no split sums, no
//     atomics, so two runs give the same bits and member k the bits of its
//     solo launch.
//   * Accuracy where it counts: V's error is the Cholesky factor's times
//     cond(P). The factorisation is left-looking, each entry's sum kept as
//     a Dot2 pair (FbDot2, compensated f32) until the entry is final, so
//     the factor comes out more accurate than a library's f32 one; so do the
//     last Newton iteration, V and w = V g. The earlier Newton iterations
//     run plain f32 FMAs: the iteration corrects their rounding.
//   * The Cholesky: each block computes the Schur complement of the panel's
//     tiles in its tile rows (round robin), every block factors the diagonal
//     tile in its own shared memory (the same bits in each), and the blocks
//     solve their rows of the panel below it: two cluster barriers a panel.
//     A failed pivot ends the factorisation in every block at once, and
//     nothing is written.
//   * The residual runs a trial a warp, the lanes over the features, each
//     feature computed on the fly and multiplied into the xd columns of w
//     (or of w_white w): nothing of B x nfp is stored.
// It is its own kernel, not a mode of vjf_kernel: the rare dense
// factorisation does not compete for the recurrence's registers or shared
// memory, and the step and mega kernels are compiled as they were.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "vjf_defs.cuh"
#include "vjf_hopper.cuh"

#define FB_TILE 32                                 // rows and columns of a tile
#define FB_PER (FB_TILE * FB_TILE / NTHREADS)      // elements of a tile a thread sums
#define FB_JC 16                                   // columns of w a trial's pass sums
#define FB_RED 4                                   // partial sums a block publishes

// Must match vjf_tpu_torch/ops/fused_step.py:_FallbackArgs field for field.
// Every per-member operand is stacked with a leading member axis; mask (and
// u with shared_u) is one copy for all members.
struct FallbackArgs {
  // the carry after the step, written in place where the branch is taken
  float* v_mat;              // (nfp, nfp)
  float* w_dyn;              // (nfp, xd)
  float* state_logvar;       // (1,)
  float* dyn_n;              // (1,)
  // read
  const float* p_mat;        // (nfp, nfp) the step's new precision
  const float* g_vec;        // (nfp, xd)
  const float* xs;           // (B, xd)
  const float* xt;           // (B, xd)
  const float* u;            // (B, ud) or null
  const float* mask;         // (B,) 0/1 trial mask or null
  const float* cent_x;       // (nfp, xd)
  const float* cent_u;       // (nfp, ud) or null
  const float* c2;           // (nfp,)
  const float* inv_w2;       // (nfp,)
  const float* w_white;      // SGP: (nfp, nfp); null for RBF
  const float* prev_slv;     // (1,) the state log-variance before the step
  const float* prev_dyn_n;   // (1,) its count before the step
  const float* scal;         // (8,) the step's scalar row: tau at 4
  float* ws;                 // vjf_fallback_workspace_floats() floats a member
  int B, xd, ud, nfp, n_members, shared_u;
  float logvar_clamp, state_var_cap;
};

static_assert(NTHREADS % 32 == 0 && (FB_TILE * FB_TILE) % NTHREADS == 0,
              "a tile's elements split evenly over the block's threads");

// The member's workspace: the factor, the inverse's two iterates, the Newton
// product, w, w_white w, and each block's partial sums.
struct FbWork {
  float *l, *x, *y, *m, *w, *w2, *red;
  size_t total;
};

__host__ __device__ static inline FbWork fb_work(const FallbackArgs& a, float* base) {
  // nfp is a multiple of 128, so every piece starts 16-byte aligned
  const size_t n2 = (size_t)a.nfp * a.nfp, nx = (size_t)a.nfp * a.xd;
  const size_t off[7] = {0, n2, 2 * n2, 3 * n2, 4 * n2, 4 * n2 + nx, 4 * n2 + 2 * nx};
  FbWork k;
  float** piece[7] = {&k.l, &k.x, &k.y, &k.m, &k.w, &k.w2, &k.red};
  for (int i = 0; i < 7; ++i) *piece[i] = base ? base + off[i] : nullptr;
  k.total = off[6] + (size_t)VJF_CLUSTER * FB_RED;
  return k;
}

template <typename P>
static __device__ __forceinline__ void fb_shift(P*& p, size_t per, int m) {
  if (p) p += (size_t)m * per;
}

// Member m's slice of every per-member operand.
static __device__ void fb_member(FallbackArgs& a, int m) {
  if (m == 0) return;
  const size_t n = a.nfp, B = a.B, xd = a.xd, ud = a.ud;
  fb_shift(a.v_mat, n * n, m);
  fb_shift(a.w_dyn, n * xd, m);
  fb_shift(a.state_logvar, 1, m);
  fb_shift(a.dyn_n, 1, m);
  fb_shift(a.p_mat, n * n, m);
  fb_shift(a.g_vec, n * xd, m);
  fb_shift(a.xs, B * xd, m);
  fb_shift(a.xt, B * xd, m);
  if (!a.shared_u) fb_shift(a.u, B * ud, m);
  fb_shift(a.cent_x, n * xd, m);
  fb_shift(a.cent_u, n * ud, m);
  fb_shift(a.c2, n, m);
  fb_shift(a.inv_w2, n, m);
  fb_shift(a.w_white, n * n, m);
  fb_shift(a.prev_slv, 1, m);
  fb_shift(a.prev_dyn_n, 1, m);
  fb_shift(a.scal, 8, m);
  fb_shift(a.ws, fb_work(a, nullptr).total, m);
}

// Block r's contiguous share of `total` rows (ceil(total / VJF_CLUSTER) each).
static __device__ __forceinline__ void fb_rows(int total, int r, int& first, int& count) {
  const int per = (total + VJF_CLUSTER - 1) / VJF_CLUSTER;
  first = min(r * per, total);
  count = min(per, total - first);
}

static __device__ __forceinline__ float fb_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// FB_RED per-thread values summed over the block, in warp order; every
// thread gets the totals.
static __device__ void fb_block_sum(float* red, float (&v)[FB_RED]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < FB_RED; ++i) {
    const float s = fb_warp_sum(v[i]);
    if (lane == 0) red[i * NWARPS + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < FB_RED; ++i) {
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += red[i * NWARPS + w];
    v[i] = s;
  }
  __syncthreads();
}

// A sum of products kept as an unevaluated pair hi + lo of floats: each
// product's rounding error (an FMA) and each addition's (TwoSum) gather in
// lo, so the sum comes out about as accurate as one carried in twice the
// precision and rounded once (Ogita, Rump and Oishi's Dot2). The Cholesky
// takes its sums so: its factor's error sets V's, and a sum rounded to f32
// at every step, as LAPACK's and cuSOLVER's f32 factorisations take it,
// loses in the Schur complement what cond(P) then multiplies. The _rn
// intrinsics keep the compiler from fusing what the error terms undo.
struct FbDot2 {
  float hi, lo;
  __device__ __forceinline__ void add(float a, float b) {
    const float p = __fmul_rn(a, b);
    const float pe = fmaf(a, b, -p);
    const float s = __fadd_rn(hi, p);
    const float z = __fsub_rn(s, hi);
    const float se = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, z)), __fsub_rn(p, z));
    hi = s;
    lo = __fadd_rn(lo, __fadd_rn(pe, se));
  }
  __device__ __forceinline__ float value() const { return __fadd_rn(hi, lo); }
};

struct FbShared {
  float a[FB_TILE][FB_TILE + 1];  // a staged left operand tile
  float b[FB_TILE][FB_TILE + 1];  // a staged right operand tile
  float d[FB_TILE][FB_TILE + 1];  // the factored diagonal tile of the panel
  float red[FB_RED * NWARPS];
  int failed;
};

// Element (r, k) of the left tile (q, kt) of an n x n row-major matrix, or of
// its transpose, into s.a; element (k, c) of the right tile (kt, s) into s.b.
template <bool TA, bool TB>
static __device__ __forceinline__ void fb_stage(FbShared& sh, const float* A, const float* B, int n,
                                         int q, int kt, int s) {
  for (int e = threadIdx.x; e < FB_TILE * FB_TILE; e += NTHREADS) {
    const int i = e / FB_TILE, j = e % FB_TILE;
    if (TA) sh.a[j][i] = __ldcg(A + (size_t)(kt * FB_TILE + i) * n + q * FB_TILE + j);
    else sh.a[i][j] = __ldcg(A + (size_t)(q * FB_TILE + i) * n + kt * FB_TILE + j);
    if (TB) sh.b[j][i] = __ldcg(B + (size_t)(s * FB_TILE + i) * n + kt * FB_TILE + j);
    else sh.b[i][j] = __ldcg(B + (size_t)(kt * FB_TILE + i) * n + s * FB_TILE + j);
  }
  __syncthreads();
}

// acc (a thread's FB_PER elements of the output tile, element
// threadIdx.x + i NTHREADS) += sign times the staged a times b, k in order:
// Dot2 sums with `dot2`, else plain f32 FMAs into acc's hi.
static __device__ __forceinline__ void fb_mac(const FbShared& sh, FbDot2 (&acc)[FB_PER],
                                              float sign, bool dot2) {
#pragma unroll
  for (int i = 0; i < FB_PER; ++i) {
    const int e = threadIdx.x + i * NTHREADS, r = e / FB_TILE, c = e % FB_TILE;
    if (dot2) {
#pragma unroll 8
      for (int k = 0; k < FB_TILE; ++k) acc[i].add(sign * sh.a[r][k], sh.b[k][c]);
    } else {
      float h = acc[i].hi;
#pragma unroll 8
      for (int k = 0; k < FB_TILE; ++k) h = fmaf(sign * sh.a[r][k], sh.b[k][c], h);
      acc[i].hi = h;
    }
  }
  __syncthreads();
}

// acc += sign times the sum over kt in [k_lo, k_hi] of the left tile (q, kt)
// times the right tile (kt, s), in kt order.
template <bool TA, bool TB>
static __device__ void fb_tile_sum(FbShared& sh, FbDot2 (&acc)[FB_PER], const float* A,
                                   const float* B, int n, int q, int s, int k_lo, int k_hi,
                                   float sign = 1.f, bool dot2 = true) {
  for (int kt = k_lo; kt <= k_hi; ++kt) {
    fb_stage<TA, TB>(sh, A, B, n, q, kt, s);
    fb_mac(sh, acc, sign, dot2);
  }
}

static __device__ __forceinline__ float* fb_at(float* base, int n, int q, int s, int e) {
  return base + (size_t)(q * FB_TILE + e / FB_TILE) * n + s * FB_TILE + e % FB_TILE;
}

// The lower tile (q, s) of linear index t = q (q + 1) / 2 + s.
static __device__ __forceinline__ void fb_tile_of(int t, int& q, int& s) {
  q = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
  while (q * (q + 1) / 2 > t) --q;
  while ((q + 1) * (q + 2) / 2 <= t) ++q;
  s = t - q * (q + 1) / 2;
}

// Factors the panel's diagonal tile of the Schur complement in place, its
// lower triangle given as the Dot2 pairs sh.d (hi) and sh.a (lo), with the
// whole block, right-looking: column j's entries, then each entry (r, c)
// with j < c <= r takes its term -L(r, j) L(c, j) (a thread an entry, in
// column order: the sums of the left-looking form, term for term). Zeroes
// the strict upper triangle; sh.failed is set where a pivot is not > 0 (NaN
// included).
static __device__ void fb_factor_diag(FbShared& sh) {
  if (threadIdx.x == 0) sh.failed = 0;
  for (int j = 0; j < FB_TILE; ++j) {
    const float piv = __fadd_rn(sh.d[j][j], sh.a[j][j]);
    const float root = sqrtf(piv);
    for (int r = j + 1 + threadIdx.x; r < FB_TILE; r += NTHREADS)
      sh.d[r][j] = __fadd_rn(sh.d[r][j], sh.a[r][j]) / root;
    __syncthreads();
    if (threadIdx.x == 0) {
      sh.d[j][j] = root;
      if (!(piv > 0.f)) sh.failed = 1;
    }
    for (int e = threadIdx.x; e < FB_TILE * FB_TILE; e += NTHREADS) {
      const int r = e / FB_TILE, c = e % FB_TILE;
      if (c > j && c <= r) {
        FbDot2 t{sh.d[r][c], sh.a[r][c]};
        t.add(-sh.d[r][j], sh.d[c][j]);
        sh.d[r][c] = t.hi;
        sh.a[r][c] = t.lo;
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < FB_TILE * FB_TILE; e += NTHREADS)
    if (e % FB_TILE > e / FB_TILE) sh.d[e / FB_TILE][e % FB_TILE] = 0.f;
  __syncthreads();
}

// The Cholesky factor of P into work.l (its lower tiles; the strict upper
// triangle of each diagonal tile zeroed), left-looking by panels of FB_TILE
// columns. Tile row q belongs to block q % VJF_CLUSTER. For panel kp each
// block computes the Schur complement of its tiles (q, kp), q >= kp: P(q, kp)
// less the sum over the panels before of L(q, kt) L(kp, kt)^T, in one Dot2
// sum an element; then every block factors the diagonal tile (the same bits
// in each) and solves its rows of the panel below it. Returns whether a
// pivot failed (the same in every block).
static __device__ bool fb_cholesky(const FallbackArgs& a, const FbWork& k, FbShared& sh,
                                   int rank) {
  const int n = a.nfp, nt = n / FB_TILE;
  for (int kp = 0; kp < nt; ++kp) {
    // the block's first tile row at or below the panel
    const int first = kp + ((rank - kp % VJF_CLUSTER) + VJF_CLUSTER) % VJF_CLUSTER;
    for (int q = first; q < nt; q += VJF_CLUSTER) {
      FbDot2 acc[FB_PER];
#pragma unroll
      for (int i = 0; i < FB_PER; ++i)
        acc[i] = FbDot2{*fb_at(const_cast<float*>(a.p_mat), n, q, kp, threadIdx.x + i * NTHREADS),
                        0.f};
      fb_tile_sum<false, true>(sh, acc, k.l, k.l, n, q, kp, 0, kp - 1, -1.f);
#pragma unroll
      for (int i = 0; i < FB_PER; ++i) {
        *fb_at(k.l, n, q, kp, threadIdx.x + i * NTHREADS) = acc[i].hi;
        *fb_at(k.m, n, q, kp, threadIdx.x + i * NTHREADS) = acc[i].lo;
      }
    }
    cluster_sync();
    for (int e = threadIdx.x; e < FB_TILE * FB_TILE; e += NTHREADS) {
      sh.d[e / FB_TILE][e % FB_TILE] = __ldcg(fb_at(k.l, n, kp, kp, e));
      sh.a[e / FB_TILE][e % FB_TILE] = __ldcg(fb_at(k.m, n, kp, kp, e));
    }
    __syncthreads();
    fb_factor_diag(sh);
    if (sh.failed) return true;
    // the panel below: each owned row solves l D^T = s, a row a thread
    const int below = first + (first == kp ? VJF_CLUSTER : 0);
    const int owned = below < nt ? (nt - 1 - below) / VJF_CLUSTER + 1 : 0;
    for (int r = threadIdx.x; r < owned * FB_TILE; r += NTHREADS) {
      const int q = below + (r / FB_TILE) * VJF_CLUSTER;
      const size_t at = (size_t)(q * FB_TILE + r % FB_TILE) * n + kp * FB_TILE;
      float* row = k.l + at;
      float x[FB_TILE];
#pragma unroll
      for (int j = 0; j < FB_TILE; ++j) {
        FbDot2 t{__ldcg(row + j), __ldcg(k.m + at + j)};
#pragma unroll
        for (int c = 0; c < j; ++c) t.add(-x[c], sh.d[j][c]);
        x[j] = t.value() / sh.d[j][j];
      }
#pragma unroll
      for (int j = 0; j < FB_TILE; ++j) row[j] = x[j];
    }
    cluster_sync();
    // every block has read the diagonal tile's Schur complement: its owner
    // stores the factor (no later panel reads it before the inverse does)
    if (kp % VJF_CLUSTER == rank)
      for (int e = threadIdx.x; e < FB_TILE * FB_TILE; e += NTHREADS)
        *fb_at(k.l, n, kp, kp, e) = sh.d[e / FB_TILE][e % FB_TILE];
  }
  __syncthreads();
  return false;
}

// X <- X (2I - L X), ceil(log2 n) times from diag(1 / diag L); returns the
// buffer that holds the inverse. The iteration corrects its own rounding
// quadratically, so only the last one's products stay as rounded: those take
// Dot2 sums, the others plain f32 FMAs.
static __device__ float* fb_tri_inverse(const FallbackArgs& a, const FbWork& k, FbShared& sh,
                                 int rank) {
  const int n = a.nfp, nt = n / FB_TILE, tiles = nt * (nt + 1) / 2;
  for (int q = rank; q < nt; q += VJF_CLUSTER)
    for (int e = threadIdx.x; e < (q + 1) * FB_TILE * FB_TILE; e += NTHREADS) {
      const int s = e / (FB_TILE * FB_TILE), f = e % (FB_TILE * FB_TILE);
      const int i = f / FB_TILE, j = f % FB_TILE;
      *fb_at(k.x, n, q, s, f) =
          (s == q && i == j) ? 1.0f / __ldcg(fb_at(k.l, n, q, q, f)) : 0.f;
    }
  cluster_sync();
  int iters = 0;
  while ((1 << iters) < n) ++iters;
  if (iters < 1) iters = 1;
  float *x = k.x, *y = k.y;
  for (int it = 0; it < iters; ++it) {
    for (int t = rank; t < tiles; t += VJF_CLUSTER) {
      int q, s;
      fb_tile_of(t, q, s);
      FbDot2 acc[FB_PER];
#pragma unroll
      for (int i = 0; i < FB_PER; ++i) {
        const int e = threadIdx.x + i * NTHREADS;
        acc[i] = FbDot2{q == s && e / FB_TILE == e % FB_TILE ? 2.0f : 0.f, 0.f};
      }
      fb_tile_sum<false, false>(sh, acc, k.l, x, n, q, s, s, q, -1.f, it == iters - 1);
#pragma unroll
      for (int i = 0; i < FB_PER; ++i)
        *fb_at(k.m, n, q, s, threadIdx.x + i * NTHREADS) = acc[i].value();
    }
    cluster_sync();
    for (int t = rank; t < tiles; t += VJF_CLUSTER) {
      int q, s;
      fb_tile_of(t, q, s);
      FbDot2 acc[FB_PER] = {};
      fb_tile_sum<false, false>(sh, acc, x, k.m, n, q, s, s, q, 1.f, it == iters - 1);
#pragma unroll
      for (int i = 0; i < FB_PER; ++i)
        *fb_at(y, n, q, s, threadIdx.x + i * NTHREADS) = acc[i].value();
    }
    cluster_sync();
    float* swap = x;
    x = y;
    y = swap;
  }
  return x;
}

// The kernel's body: one member's fallback, the whole cluster.
static __device__ void fb_run(const FallbackArgs& args, FbShared& sh) {
  FallbackArgs a = args;
  fb_member(a, blockIdx.y);
  if (a.scal[4] < NS_TAU_THRESHOLD) return;  // Newton-Schulz contracted: keep the step's V
  const int rank = cluster_rank(), n = a.nfp, nt = n / FB_TILE, xd = a.xd, ud = a.ud;
  const FbWork k = fb_work(a, a.ws);
  if (fb_cholesky(a, k, sh, rank)) return;  // info != 0: the step's leaves stay
  const float* x = fb_tri_inverse(a, k, sh, rank);

  // V = X^T X: lower tile (q, s) = sum over kt >= q of X(kt, q)^T X(kt, s),
  // mirrored into (s, q); V overwrites the factor
  float* v = k.l;
  for (int t = rank; t < nt * (nt + 1) / 2; t += VJF_CLUSTER) {
    int q, s;
    fb_tile_of(t, q, s);
    FbDot2 acc[FB_PER] = {};
    fb_tile_sum<true, false>(sh, acc, x, x, n, q, s, q, nt - 1);
#pragma unroll
    for (int i = 0; i < FB_PER; ++i) {
      const int e = threadIdx.x + i * NTHREADS;
      const float vv = acc[i].value();
      *fb_at(v, n, q, s, e) = vv;
      if (q != s) *fb_at(v, n, s, q, (e % FB_TILE) * FB_TILE + e / FB_TILE) = vv;
    }
  }
  cluster_sync();

  // w = V g on this block's rows, and the sums that say whether V and w are
  // finite: red[1] over its rows of V, red[2] over its rows of w
  int r0, rn;
  fb_rows(n, rank, r0, rn);
  float part[FB_RED] = {0.f, 0.f, 0.f, 0.f};
  for (int e = threadIdx.x; e < rn * xd; e += NTHREADS) {
    const int i = r0 + e / xd, j = e % xd;
    const float* vi = v + (size_t)i * n;
    FbDot2 s{0.f, 0.f};
    for (int c = 0; c < n; ++c) s.add(vi[c], a.g_vec[(size_t)c * xd + j]);
    k.w[(size_t)i * xd + j] = s.value();
    part[2] += s.value();
  }
  for (size_t e = threadIdx.x; e < (size_t)rn * n; e += NTHREADS)
    part[1] += __ldcg(v + (size_t)r0 * n + e);
  cluster_sync();

  // SGP: w_white w on this block's rows, so a trial's whitened features
  // need not be stored
  const float* wp = k.w;
  if (a.w_white) {
    for (int e = threadIdx.x; e < rn * xd; e += NTHREADS) {
      const int i = r0 + e / xd, j = e % xd;
      const float* wi = a.w_white + (size_t)i * n;
      float s = 0.f;
      for (int c = 0; c < n; ++c) s = fmaf(wi[c], k.w[(size_t)c * xd + j], s);
      k.w2[(size_t)i * xd + j] = s;
    }
    cluster_sync();
    wp = k.w2;
  }

  // the residual over this block's trials, a trial a warp (its lanes split
  // the features, then each column is summed over the warp): red[0] the
  // squared residuals, red[3] the valid trials. w (or w_white w) is read
  // with plain loads, cached: the barrier's acquire has published it
  int b0, bn;
  fb_rows(a.B, rank, b0, bn);
  const int lane = threadIdx.x & 31;
  for (int b = b0 + (threadIdx.x >> 5); b < b0 + bn; b += NWARPS) {
    if (a.mask && !(a.mask[b] > 0.f)) continue;
    if (lane == 0) part[3] += 1.f;
    const float* xs = a.xs + (size_t)b * xd;
    const float* xt = a.xt + (size_t)b * xd;
    const float* u = a.u ? a.u + (size_t)b * ud : nullptr;
    float x2 = 0.f, u2 = 0.f;
    for (int d = 0; d < xd; ++d) x2 = fmaf(xs[d], xs[d], x2);
    for (int d = 0; d < ud; ++d) u2 = fmaf(u[d], u[d], u2);
    if (ud > 0) x2 += u2;
    for (int j0 = 0; j0 < xd; j0 += FB_JC) {
      float acc[FB_JC];
#pragma unroll
      for (int j = 0; j < FB_JC; ++j) acc[j] = 0.f;
      for (int c = lane; c < n; c += 32) {
        float cross = 0.f;
        for (int d = 0; d < xd; ++d) cross = fmaf(xs[d], a.cent_x[(size_t)c * xd + d], cross);
        if (ud > 0) {
          float cu = 0.f;
          for (int d = 0; d < ud; ++d) cu = fmaf(u[d], a.cent_u[(size_t)c * ud + d], cu);
          cross += cu;
        }
        float d2 = (x2 + a.c2[c]) - 2.0f * cross;
        d2 = d2 < 0.f ? 0.f : d2;
        const float f = expf(-0.5f * d2 * a.inv_w2[c]);
        const float* wc = wp + (size_t)c * xd + j0;
#pragma unroll
        for (int j = 0; j < FB_JC; ++j)
          if (j0 + j < xd) acc[j] = fmaf(f, wc[j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < FB_JC; ++j)
        if (j0 + j < xd) {
          const float pred = fb_warp_sum(acc[j]);
          const float r = (xt[j0 + j] - xs[j0 + j]) - pred;
          if (lane == 0) part[0] = fmaf(r, r, part[0]);
        }
    }
  }
  fb_block_sum(sh.red, part);
  if (threadIdx.x == 0)
    for (int i = 0; i < FB_RED; ++i) k.red[rank * FB_RED + i] = part[i];
  cluster_sync();

  // the gates, the same in every block (the partial sums in rank order)
  float tot[FB_RED] = {0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < VJF_CLUSTER; ++r)
    for (int i = 0; i < FB_RED; ++i) tot[i] += __ldcg(k.red + r * FB_RED + i);
  const float b = a.mask ? tot[3] : (float)a.B;
  const float mse = a.mask ? tot[0] / (fmaxf(b, 1.f) * (float)xd) : tot[0] / ((float)a.B * xd);
  float dn = a.prev_dyn_n[0];
  dn = dn > a.state_var_cap ? a.state_var_cap : dn;
  const float total = dn + b;
  const float var = (dn / total) * expf(a.prev_slv[0]) + (b / total) * mse;
  float slv = logf(var);
  slv = slv < -a.logvar_clamp ? -a.logvar_clamp : (slv > a.logvar_clamp ? a.logvar_clamp : slv);
  if (!(isfinite(tot[1] + tot[2]) && isfinite(var))) return;
  for (size_t e = threadIdx.x; e < (size_t)rn * n; e += NTHREADS)
    a.v_mat[(size_t)r0 * n + e] = __ldcg(v + (size_t)r0 * n + e);
  for (int e = threadIdx.x; e < rn * xd; e += NTHREADS)
    a.w_dyn[(size_t)r0 * xd + e] = k.w[(size_t)r0 * xd + e];
  if (rank == 0 && threadIdx.x == 0) {
    a.state_logvar[0] = slv;
    a.dyn_n[0] = total;
  }
}

// ---------------------------------------------------------------------------
// Kernels and the C interface (ctypes)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS, 1) vjf_fallback_kernel(FallbackArgs a) {
  __shared__ FbShared sh;
  fb_run(a, sh);
}

extern "C" {

size_t vjf_fallback_args_size(void) { return sizeof(FallbackArgs); }

// The offset of FallbackArgs's last field (the ctypes mirror checks it).
size_t vjf_fallback_args_tail(void) { return offsetof(FallbackArgs, state_var_cap); }

// Floats of a member's workspace.
size_t vjf_fallback_workspace_floats(const FallbackArgs* a) {
  return fb_work(*a, nullptr).total;
}

// One cluster of VJF_CLUSTER blocks a member, on `stream`. Returns a
// cudaError.
int vjf_exact_fallback(const FallbackArgs* a, void* stream) {
  if (a->nfp % FB_TILE != 0 || a->nfp <= 0 || a->xd <= 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(VJF_CLUSTER, a->n_members > 1 ? a->n_members : 1, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = VJF_CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (VJF_CLUSTER > 8) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)vjf_fallback_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, vjf_fallback_kernel, *a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
