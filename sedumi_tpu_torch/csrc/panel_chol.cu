// K14: one block column of the distributed block-cyclic Cholesky
// (parallel/panels.dist_cholesky).
//
// Replaces the per-block-column body of the reference's
// sedumi_tpu/parallel/panels.py:dist_cholesky (:75-87): given the block
// column j gathered from every rank in natural block order, C [nb, bs, bs],
//   Ljj     = chol(C[j])                     (lower; NaN if not PD)
//   Lcol[k] = C[k] Ljj^-T  for k > j,  Ljj for k = j,  0 for k < j,
// and NaN from block j on when C[j] is not positive definite (a pivot not
// in (0, inf): the event at which LAPACK's potrf stops and
// jnp.linalg.cholesky returns NaN).  The reference multiplies by an
// explicit inverse; K14 solves against Ljj, which rounds otherwise (within
// 1e-12 of max|L| of the plain version; chip_smoke.PANEL_TOL).  The
// trailing GEMM update and the strict-upper zeroing stay torch.
//
// Bound on the card: latency.  At OH's shapes (bs = 128, nb = 8) a column
// moves ~2 MiB (0.6 us at 3.35 TB/s) and does ~2.7 Mflop per block; what
// sets the time is the chain of bs dependent pivots (a square root, a
// reciprocal and a quotient each) and each panel's hand-offs.
//
// Design: one launch a column, panel_column_kernel.
// Every CTA factors Ljj itself (the same code, so the same bits) beside a
// chunk of COL_ROWS rows of the blocks below, so no CTA waits for another
// and there is no second launch: the rows below follow Ljj's columns as
// they are published inside the CTA.  The grid is at most one wave (the
// CTAs resident at once): a CTA with more chunks than its first solves
// the later ones against the Ljj it has factored (rows_solve), so Ljj is
// factored once a CTA, not once a chunk.  Per panel of 32 columns:
//  (1) warp 0 factors the panel's triangle right-looking in registers, a
//      lane a row, a run-time loop over the columns (the row shifts down a
//      register a step, so the code stays small: fully unrolled forms ran
//      slower, out of the instruction cache): the pivot by shuffle, its
//      square root and reciprocal in every lane, each lane's quotient by
//      Div (div_rn.cuh: one reciprocal and two fma corrections), then the
//      lane's later entries updated with the column's values by shuffle.
//      The next pivot is formed first, by its own lane, so the chain of a
//      column is a quotient, a product and a difference, one shuffle, a
//      square root and a reciprocal.  The columns go to shared memory with
//      the pivots' reciprocals, and a progress counter (a release store
//      every eight columns) hands them on;
//  (2) meanwhile warps 1-7, a thread a row (Ljj's rows below the panel,
//      then the CTA's rows), solve their row's panel entries right-looking
//      in registers, column t once the counter shows it, with the
//      published reciprocal: no division on their chain either;
//  (3) before (2), also while warp 0 runs the triangle, warps 1-7 apply
//      the previous panel's products to the columns past this panel
//      (look-ahead), so no trailing update waits between the triangles;
//  (4) after one barrier, this panel's products in the next panel's
//      columns only (every row below), and one more barrier.
// Div's quotients are the IEEE ones where its range holds (Markstein's
// theorem); each thread records whether it held for its quotients, and a
// CTA where it did not runs the column again with the division (SAFE).
// So every entry still receives its updates one product at a time in k
// order, then its quotient (the division's bits) or square root, as
// tests/panel_emulation.py runs them, bit for bit.  NaN from block j on
// when a pivot fails; bs <= 128.
//
// The kernel is a template over the element type: the f64 build is K14,
// the f32 build K14-f32 (the f32 phase of the precision ladder under a
// mesh), the same order.  Shared memory is sized by sizeof(Real) (bs +
// COL_ROWS rows of LD: 82 KB in f32, 165 KB in f64), cp.async copies one
// element at a time, the pivot test compares with the type's own
// infinity, and square roots and reciprocals are IEEE-rounded in both
// types (nvcc's default -prec-div and -prec-sqrt, no fast math).

#include <algorithm>

#include "div_rn.cuh"
#include "tri_factor.cuh"

namespace {

using namespace dense;

__device__ __forceinline__ double nan_t(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}
__device__ __forceinline__ float nan_t(float) {
  return __int_as_float(0x7fc00000);
}

constexpr int COL_THREADS = 256;
constexpr int COL_ROWS = 32;   // rows below the diagonal block a CTA

// The progress counter in shared memory: a release store after the
// column's stores (by one lane, after __syncwarp), an acquire load by the
// readers (lighter than __threadfence_block's sequentially consistent
// fence on every step).
__device__ __forceinline__ void release_cta(int *p, int v) {
  asm volatile("st.release.cta.shared.s32 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(p)),
               "r"(v)
               : "memory");
}
__device__ __forceinline__ int acquire_cta(const int *p) {
  int v;
  asm volatile("ld.acquire.cta.shared.s32 %0, [%1];"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

__device__ __forceinline__ float inf_t(float) { return INFINITY; }
__device__ __forceinline__ double inf_t(double) { return (double)INFINITY; }

// Shared state of a column's factor.
template <typename Real>
struct ColumnSmem {
  Real *A, *X;      // Ljj (rows of stride LD), the CTA's rows below
  Real *d, *y;      // the published pivots and their reciprocals
  int *prog, *bad;  // columns of the panel published; a failed pivot
};

// x / d: Div's fast quotient (its range recorded in `slow`), or with SAFE
// the division.
template <bool SAFE, typename Real>
__device__ __forceinline__ Real quot(const Div<Real> &dv, Real x,
                                     bool &slow) {
  if (SAFE) return div_pos(x, dv.d);
  slow |= dv.slow(x);
  return dv.fast(x);
}

// Entries (r, t) of the rows below e, Ljj's (its lower triangle) and
// then the CTA's, in the columns [c0, c1): a -= L[r][k] L[t][k] for k in
// [k0, k1), one product at a time in k order.  Warps w0 .. w0 + nw - 1 take
// items of (32 rows, 8 columns) in turn, a lane a row (its row read with
// the row stride LD, L[t][k] read by the whole warp at once).
template <typename Real>
__device__ void update_block(Real *A, Real *X, int bs, int R, int e, int c0,
                             int c1, int k0, int k1, int w0, int nw) {
  const int lane = threadIdx.x & 31, w = (int)(threadIdx.x >> 5) - w0;
  const int nrb = (bs - e + 31) / 32, ng = (c1 - c0 + 7) / 8;
  for (int it = w; it < (nrb + 1) * ng; it += nw) {
    const int rb = it / ng, t0 = c0 + 8 * (it % ng);
    const bool off = rb == nrb;
    if (!off && t0 > e + 32 * rb + 31) continue;   // above the diagonal
    const int r = off ? lane : e + 32 * rb + lane;
    if (off ? r >= R : r >= bs) continue;
    Real *Ar = (off ? X : A) + r * LD;
    Real acc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = t0 + u;
      acc[u] = (t < c1 && (off || t <= r)) ? Ar[t] : Real(0);
    }
    for (int k = k0; k < k1; ++k) {
      const Real lr = Ar[k];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        acc[u] = acc[u] - lr * (t0 + u < c1 ? A[(t0 + u) * LD + k] : Real(0));
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = t0 + u;
      if (t < c1 && (off || t <= r)) Ar[t] = acc[u];
    }
  }
}

// The column's factor in shared memory, steps (1)-(4) above; returns
// whether a pivot failed (the same in every thread).  Without SAFE the
// quotients are Div's fast ones and `slow` records whether Div's range
// failed for one of this thread's; the caller then runs it again, SAFE,
// with the division.
template <bool SAFE, typename Real>
__device__ bool column_factor(const ColumnSmem<Real> &sm, int bs, int R,
                              bool &slow) {
  Real *A = sm.A, *X = sm.X;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p0 = 0; p0 < bs; p0 += PANEL) {
    const int P = min(PANEL, bs - p0), e = p0 + P;
    if (warp == 0) {
      // (1) lane i holds row p0 + i of the triangle: a[s] is its entry in
      // column c + s at step c (the row shifts down a register a step, so
      // the loop over c runs at run time and its code stays small)
      Real *Ai = A + (p0 + min(lane, P - 1)) * LD + p0;
      Real a[PANEL];
#pragma unroll
      for (int s = 0; s < PANEL; ++s)
        a[s] = (lane < P && s <= lane && s < P) ? Ai[s] : Real(0);
      bool good = true;
      Real piv = __shfl_sync(FULL, a[0], 0);
      for (int c = 0; c < P; ++c) {
        good = good && piv > Real(0) && piv < inf_t(Real(0));
        const Real ljj = sqrt_t(piv);
        const Div<Real> dv(ljj);
        bool sl = false;
        const Real q = quot<SAFE>(dv, a[0], sl);
        const bool below = lane > c && lane < P;
        slow |= below & sl;
        const Real lc = lane == c ? ljj : (below ? q : Real(0));
        // the next pivot first, from its own lane's values
        piv = __shfl_sync(FULL, a[1] - lc * lc, c + 1);
        if (lane >= c && lane < P) Ai[c] = lc;
        if (lane == 0) {
          sm.d[p0 + c] = ljj;
          sm.y[p0 + c] = dv.y;
        }
        // column c + 1 + s takes lc L[c + 1 + s][c] (entries right of a
        // lane's diagonal take products too, and are never read; a source
        // lane past 31 wraps, for columns past the panel, never read)
#pragma unroll
        for (int s = 0; s < PANEL - 1; ++s)
          a[s] = a[s + 1] - lc * __shfl_sync(FULL, lc, c + 1 + s);
        a[PANEL - 1] = Real(0);
        // published eight columns at a time (a fence each)
        if ((c & 7) == 7 || c + 1 == P) {
          __syncwarp();
          if (lane == 0) release_cta(sm.prog, c + 1);
        }
      }
      if (lane == 0) *sm.bad = !good;
    } else {
      // (3) first, while warp 0 runs the triangle: the previous panel's
      // products in the columns past this panel (look-ahead: the columns
      // of this panel took them after the previous panel, before its
      // barrier)
      if (p0 > 0) update_block(A, X, bs, R, e, e, bs, p0 - PANEL, p0, 1, 7);
      // (2) thread t: Ljj's row e + t, then the CTA's row t - (bs - e);
      // a[s] is the row's entry in column c + s at step c, as in (1)
      const int t = (int)threadIdx.x - 32, nl = bs - e;
      Real *row = t < nl ? A + (e + t) * LD + p0
                         : (t - nl < R ? X + (t - nl) * LD + p0 : nullptr);
      if (row) {
        Real a[PANEL];
#pragma unroll
        for (int s = 0; s < PANEL; ++s) a[s] = s < P ? row[s] : Real(0);
        for (int c = 0; c < P; ++c) {
          while (acquire_cta(sm.prog) <= c) {
          }
          const Div<Real> dv(sm.d[p0 + c], sm.y[p0 + c]);
          const Real x = quot<SAFE>(dv, a[0], slow);
          row[c] = x;
          const Real *Lc = A + (p0 + c + 1) * LD + p0 + c;   // column c
#pragma unroll
          for (int s = 0; s < PANEL - 1; ++s)
            a[s] = a[s + 1] - x * (c + 1 + s < P ? Lc[s * LD] : Real(0));
          a[PANEL - 1] = Real(0);
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) *sm.prog = 0;   // read by nobody until the barrier
    if (*sm.bad) return true;
    if (e >= bs) break;
    // (4) this panel's products in the next panel's columns, for every
    // row below (so the next triangle and row solves may start)
    update_block(A, X, bs, R, e, e, min(e + PANEL, bs), p0, e, 0,
                 COL_THREADS / 32);
    __syncthreads();
  }
  return false;
}

// The CTA's rows X against the finished Ljj (A, with its pivots and their
// reciprocals in sm.d, sm.y), for a CTA's chunks after its first: per
// panel of 32 columns, warp 0 (a lane a row) solves the panel right-looking
// in registers, then every warp applies the panel's products to the
// later columns (update_block).  Every entry still receives its products
// in k order, then its quotient: the bits of column_factor's rows.
template <bool SAFE, typename Real>
__device__ void rows_solve(const ColumnSmem<Real> &sm, int bs, int R,
                           bool &slow) {
  Real *A = sm.A, *X = sm.X;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p0 = 0; p0 < bs; p0 += PANEL) {
    const int P = min(PANEL, bs - p0), e = p0 + P;
    if (warp == 0 && lane < R) {
      Real *row = X + lane * LD + p0;
      Real a[PANEL];
#pragma unroll
      for (int s = 0; s < PANEL; ++s) a[s] = s < P ? row[s] : Real(0);
      for (int c = 0; c < P; ++c) {
        const Div<Real> dv(sm.d[p0 + c], sm.y[p0 + c]);
        const Real x = quot<SAFE>(dv, a[0], slow);
        row[c] = x;
        const Real *Lc = A + (p0 + c + 1) * LD + p0 + c;   // column c
#pragma unroll
        for (int s = 0; s < PANEL - 1; ++s)
          a[s] = a[s + 1] - x * (c + 1 + s < P ? Lc[s * LD] : Real(0));
        a[PANEL - 1] = Real(0);
      }
    }
    __syncthreads();
    if (e >= bs) break;
    update_block(A, X, bs, R, bs, e, bs, p0, e, 0, COL_THREADS / 32);
    __syncthreads();
  }
}

template <typename Real>
__global__ void __launch_bounds__(COL_THREADS)
panel_column_kernel(const Real *__restrict__ C, int nb, int bs, int j,
                    Real *__restrict__ Lcol) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Real s_d[MAXB], s_y[MAXB];
  __shared__ int s_prog, s_bad;
  const ColumnSmem<Real> sm{reinterpret_cast<Real *>(smem),
                            reinterpret_cast<Real *>(smem) + bs * LD, s_d,
                            s_y, &s_prog, &s_bad};
  Real *A = sm.A, *X = sm.X;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t BB = (size_t)bs * bs;
  const int rows = (nb - 1 - j) * bs;
  const int nchunk = max(1, (rows + COL_ROWS - 1) / COL_ROWS);
  const Real nan = nan_t(Real(0));
  // blocks above j are 0 (every CTA a share)
  for (size_t t = (size_t)blockIdx.x * COL_THREADS + threadIdx.x;
       t < (size_t)j * BB; t += (size_t)gridDim.x * COL_THREADS)
    Lcol[t] = Real(0);
  bool bad = false;
  // chunk q: rows q0 .. q0 + R - 1 of the blocks below block j
  for (int q = blockIdx.x; q < nchunk; q += gridDim.x) {
    const int q0 = q * COL_ROWS;
    const int R = max(0, min(COL_ROWS, rows - q0));
    const Real *Cb = C + (size_t)(j + 1) * BB + (size_t)q0 * bs;
    auto stage_rows = [&]() {
      stage(Cb, bs, R, X, [](int r) { return r * LD; },
            [=](int) { return bs; });
    };
    bool slow = false;
    if (q == (int)blockIdx.x) {
      // the first chunk beside Ljj's own factor
      auto load = [&]() {
        load_lower(C + j * BB, A, bs);
        stage_rows();
        if (threadIdx.x == 0) s_prog = s_bad = 0;
        __syncthreads();
      };
      load();
      bad = column_factor<false>(sm, bs, R, slow);
      if (__syncthreads_or(slow)) {
        // Div's range failed for a quotient of this CTA: again, with the
        // division (rare: a pivot or an entry beyond 2^+-120 in f32)
        __syncthreads();
        load();
        bad = column_factor<true>(sm, bs, R, slow);
      }
      if (blockIdx.x == 0) {
        Real *out = Lcol + j * BB;
        for (int r = warp; r < bs; r += COL_THREADS / 32)
          for (int c = lane; c < bs; c += 32)
            out[r * bs + c] = bad ? nan : (c <= r ? A[r * LD + c] : Real(0));
      }
    } else if (!bad) {
      // a later chunk (a grid smaller than the chunks): against the Ljj
      // this CTA factored, without factoring it again
      __syncthreads();   // the previous chunk's rows are written out
      stage_rows();
      __syncthreads();
      rows_solve<false>(sm, bs, R, slow);
      if (__syncthreads_or(slow)) {
        stage_rows();
        __syncthreads();
        rows_solve<true>(sm, bs, R, slow);
      }
    }
    Real *out = Lcol + (size_t)(j + 1) * BB + (size_t)q0 * bs;
    for (int r = warp; r < R; r += COL_THREADS / 32)
      for (int c = lane; c < bs; c += 32)
        out[(size_t)r * bs + c] = bad ? nan : X[r * LD + c];
  }
}

// CTAs of panel_column_kernel resident at once on this card for bs (its
// shared memory), at least 1; per process and bs.
template <typename Real>
int resident_ctas(int bs) {
  static int got[MAXB + 1] = {0};
  if (!got[bs]) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, panel_column_kernel<Real>, COL_THREADS,
        sizeof(Real) * (bs + COL_ROWS) * LD);
    got[bs] = std::max(1, per * sms);
  }
  return got[bs];
}

// ncta: the grid (<= 0: one wave, every chunk its own CTA up to the CTAs
// resident at once; the result does not depend on it).
template <typename Real>
int column_launch(const Real *C, Real *Lcol, int nb, int bs, int j,
                  int ncta, cudaStream_t stream) {
  static bool raised = false;
  if (bs < 1 || bs > MAXB || j < 0 || j >= nb)
    return (int)cudaErrorInvalidValue;
  int err = raise_smem_once((const void *)panel_column_kernel<Real>, raised);
  if (err) return err;
  const int rows = (nb - 1 - j) * bs;
  const int nchunk = std::max(1, (rows + COL_ROWS - 1) / COL_ROWS);
  const int grid =
      std::min(nchunk, ncta > 0 ? ncta : resident_ctas<Real>(bs));
  panel_column_kernel<Real><<<grid, COL_THREADS,
                              sizeof(Real) * (bs + COL_ROWS) * LD, stream>>>(
      C, nb, bs, j, Lcol);
  return (int)cudaGetLastError();
}

}  // namespace

// C [nb, bs, bs] (natural block order), column j -> Lcol [nb, bs, bs];
// ncta: the grid (<= 0: one wave).  Returns cudaGetLastError().
extern "C" int panel_chol_launch(const double *C, double *Lcol, int nb,
                                 int bs, int j, int ncta,
                                 cudaStream_t stream) {
  return column_launch(C, Lcol, nb, bs, j, ncta, stream);
}

// The f32 build (K14-f32, the f32 phase under a mesh), the same order.
extern "C" int panel_chol_launch_f32(const float *C, float *Lcol, int nb,
                                     int bs, int j, int ncta,
                                     cudaStream_t stream) {
  return column_launch(C, Lcol, nb, bs, j, ncta, stream);
}
