// Tile Cholesky of one elimination-tree level: kernel K8, two entry points.
//
// Replaces the diagonal and off-tile part of the reference's
// sedumi_tpu/sparse_chol.py:469 factor_tiles_ur (:489-513; the same maths
// as factor_tiles :208 and factor_tiles_lv :264).  Tile storage is
// [nslot, B, B], row-major tiles; a diagonal tile holds its matrix in
// the lower triangle (the upper one carries partial trailing updates and
// is ignored).
//
// Both kernels are templates: the f64 build is K8, the f32 build K8-f32,
// which runs on the f32 tile storage of the precision ladder's f32 and
// hybrid phases.  Every constant is rounded to the storage type first, as
// the reference's f32 trace rounds it: reg and canceltol to T, the lift
// max(reg, canceltol dmax) + (T)1e-300 in T (so in f32 the 1e-300 rounds
// to 0), and dmax + 1 in T.
//
// Both are blocked in panels of 32 columns (fewer at the end when B is not
// a multiple of 32), and both keep the order of operations of a scalar
// right-looking factor: every entry receives its updates one product at a
// time, k = 0, 1, ..., then its division (or square root).  So the
// blocking changes no bit of the result (tests/tile_emulation.py repeats
// it step for step).
//
//  (a) tile_diag: one block of 256 threads per column of the level.  The
//      block stages the lower triangle of D into shared memory (cp.async;
//      row stride 129: 132 KB at B = 128 in f64, 66 KB in f32), forms
//      dmax = max|diag D| by a warp reduction that keeps a NaN, and the
//      lift max(reg, canceltol dmax) + 1e-300.  Per panel: its columns one
//      by one over every row below (a square root, the column's divisions
//      a thread a row, then the column's products into the panel's later
//      columns, lane = column and the warps splitting the rows: two block
//      barriers a column), then the panel's rank-32 update of the trailing
//      lower triangle (SYRK, 16 x 16 threads on strided blocks of entries
//      held in registers, the blocks above the diagonal skipped).  On a
//      pivot that is <= 0 or not finite (the event at which LAPACK's potrf
//      stops and the reference finds a NaN factor) it restarts from the
//      stored tile with +(dmax + 1) I; on a second failure it writes the
//      diagonal sqrt(|D_ii + lift| + dmax + 1).  It writes L_D (zeros above
//      the diagonal) over the tile and the rung it took (0, 1, 2) into
//      status.
//  (b) tile_off: one block of 128 threads per (off tile, 32-row chunk):
//      X = T L_D^-T for those rows.  L_D is packed by rows in shared
//      memory (66 KB at B = 128 in f64, 33 KB in f32), the chunk of X in an
//      array of its own (33 KB, 17 KB in f32), so two blocks (four in f32)
//      share an SM.  Rows are independent, so each warp takes eight rows
//      and meets no other warp: per panel, column by column, the column's
//      divisions (a lane a row), then its products into the panel's later
//      columns (a lane a column); then the panel's products into the
//      remaining columns (GEMM, a lane three columns, in registers).
//      Masked slots are not in the level's list and are never written.
//
// Divisions go through div_pos: the card's double division takes a slow
// path for a zero numerator, and sparse tiles hold many zeros.  The SYRK
// and (b)'s solve are tri_factor.cuh's.
//
// Bound on the card: (a) does B^3/3 flops per diagonal tile, (b) B^3 per
// off tile; both read and write each tile once.  At B = 128 a tile is
// 2.1 Mflop against 128 KB (64 KB in f32), near the card's balance point;
// the chain of 128 dependent pivots (square root, division, update) per
// tile sets the kernels' time.

#include "tri_factor.cuh"

namespace {

using namespace dense;

constexpr int DIAG_THREADS = FACTOR_THREADS;

// max that keeps a NaN from either side (jnp.max / jnp.maximum)
template <typename Real>
__device__ __forceinline__ Real nanmax(Real a, Real b) {
  return (a > b || isnan(a)) ? a : b;
}

// Right-looking blocked Cholesky of the B x B matrix in A's lower triangle
// (row stride LD), in place.  Returns false, uniformly over the block (all
// threads read the same pivot), at the first pivot that is not in
// (0, inf).  Per panel of 32 columns: (1) the panel's columns one by one
// over every row below them (a square root, the column's divisions, then
// its products into the panel's later columns: lane = column, warps split
// the rows), two block barriers a column; (2) the trailing update (SYRK).
template <typename Real>
__device__ bool chol_blocked(Real *A, int B) {
  __shared__ Real colj[MAXB];   // column j of L, apart from A
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int NW = DIAG_THREADS / 32;
  for (int p0 = 0; p0 < B; p0 += PANEL) {
    const int e = min(p0 + PANEL, B);
    for (int j = p0; j < e; ++j) {
      const Real piv = A[j * LD + j];
      if (!(piv > (Real)0 && piv < (Real)INFINITY)) return false;
      const Real ljj = sqrt_t(piv);
      for (int i = j + 1 + threadIdx.x; i < B; i += DIAG_THREADS) {
        const Real l = div_pos(A[i * LD + j], ljj);
        A[i * LD + j] = l;
        colj[i] = l;
      }
      __syncthreads();
      if (threadIdx.x == 0) A[j * LD + j] = ljj;
      const int t = j + 1 + lane;
      if (t < e) {
        const Real ltj = colj[t];
        Real *At = A + (j + 1 + warp) * LD + t;   // rows j + 1 + warp + NW k
        const int nk = (B - j - 1 - warp + NW - 1) / NW;
#pragma unroll 4
        for (int k = 0; k < nk; ++k) {
          const int i = j + 1 + warp + NW * k;
          if (i >= t) At[NW * k * LD] = At[NW * k * LD] - colj[i] * ltj;
        }
      }
      __syncthreads();
    }
    // (2) the trailing update (at most 96 rows: 6 strips of 16)
    if (e >= B) break;
    trailing_syrk(A, B, p0, e);
    __syncthreads();
  }
  return true;
}

template <typename Real>
__global__ void __launch_bounds__(DIAG_THREADS)
tile_diag_kernel(Real *__restrict__ st, const long long *__restrict__ dslot,
                 int *__restrict__ status, int B, double reg,
                 double canceltol) {
  extern __shared__ __align__(16) unsigned char smem[];
  Real *A = reinterpret_cast<Real *>(smem);
  __shared__ Real s_dmax, s_lift;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Real *tile = st + dslot[blockIdx.x] * (long long)B * B;
  load_lower(tile, A, B);
  __syncthreads();
  if (warp == 0) {
    Real dmax = 0;
    for (int i = lane; i < B; i += 32)
      dmax = nanmax(dmax, fabs_t(A[i * LD + i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dmax = nanmax(dmax, __shfl_down_sync(FULL, dmax, off));
    if (lane == 0) {
      s_dmax = dmax;
      s_lift = nanmax((Real)reg, (Real)canceltol * dmax) + (Real)1e-300;
    }
  }
  __syncthreads();
  const Real dmax = s_dmax, lift = s_lift;
  // rung 0: + lift; rung 1: the stored tile again, + lift + (dmax + 1);
  // rung 2: both failed (one loop, so the factor's code appears once)
  int rung = 0;
  for (;; ++rung) {
    for (int i = threadIdx.x; i < B; i += blockDim.x)
      A[i * LD + i] = rung ? (A[i * LD + i] + lift) + (dmax + (Real)1)
                           : A[i * LD + i] + lift;
    __syncthreads();
    if (chol_blocked(A, B)) break;
    if (rung == 1) {
      rung = 2;
      break;
    }
    __syncthreads();
    load_lower(tile, A, B);
    __syncthreads();
  }
  const bool ok = rung < 2;
  __syncthreads();
  for (int r = warp; r < B; r += blockDim.x / 32)
    for (int c = lane; c < B; c += 32) {
      Real v = 0;
      if (ok) {
        if (r >= c) v = A[r * LD + c];
      } else if (r == c) {
        v = sqrt_t(fabs_t(tile[r * B + c] + lift) + (dmax + (Real)1));
      }
      tile[r * B + c] = v;
    }
  if (threadIdx.x == 0) status[blockIdx.x] = rung;
}

template <typename Real>
__global__ void __launch_bounds__(OFF_THREADS)
tile_off_kernel(Real *__restrict__ st, const long long *__restrict__ off_slot,
                const long long *__restrict__ off_dslot, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  Real *Lp = reinterpret_cast<Real *>(smem);   // L_D[c][k] at tri(c) + k
  // the rows' chunk of X, an array of its own (its stores do not hold up
  // the loads of L_D)
  __shared__ Real X[OFF_ROWS * LD];             // X[r][c] at r LD + c
  const int nq = (B + OFF_ROWS - 1) / OFF_ROWS;
  const long long BB = (long long)B * B;
  const long long o = blockIdx.x / nq;
  const int r0 = (int)(blockIdx.x % nq) * OFF_ROWS;
  const int R = min(OFF_ROWS, B - r0);
  const Real *Ld = st + off_dslot[o] * BB;
  Real *T = st + off_slot[o] * BB + (long long)r0 * B;
  stage(Ld, B, B, Lp, [](int r) { return tri(r); },
        [](int r) { return r + 1; });
  stage(T, B, R, X, [](int r) { return r * LD; }, [=](int) { return B; });
  __syncthreads();
  off_rows(Lp, X, B, R, T, B);
}

int raise_smem(const void *fn, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename Real>
int diag_launch(Real *st, const long long *dslot, int *status, int nc, int B,
                double reg, double canceltol, void *stream) {
  if (B < 1 || B > MAXB) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Real) * B * LD;
  int err = raise_smem((const void *)tile_diag_kernel<Real>, smem);
  if (err) return err;
  if (nc > 0)
    tile_diag_kernel<Real><<<nc, DIAG_THREADS, smem, (cudaStream_t)stream>>>(
        st, dslot, status, B, reg, canceltol);
  return (int)cudaGetLastError();
}

template <typename Real>
int off_launch(Real *st, const long long *off_slot,
               const long long *off_dslot, int no, int B, void *stream) {
  if (B < 1 || B > MAXB) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Real) * tri(B);
  int err = raise_smem((const void *)tile_off_kernel<Real>, smem);
  if (err) return err;
  const int nq = (B + OFF_ROWS - 1) / OFF_ROWS;
  if (no > 0)
    tile_off_kernel<Real><<<no * nq, OFF_THREADS, smem,
                            (cudaStream_t)stream>>>(st, off_slot, off_dslot,
                                                    B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tile_diag_launch(double *st, const long long *dslot,
                                int *status, int nc, int B, double reg,
                                double canceltol, void *stream) {
  return diag_launch(st, dslot, status, nc, B, reg, canceltol, stream);
}

extern "C" int tile_off_launch(double *st, const long long *off_slot,
                               const long long *off_dslot, int no, int B,
                               void *stream) {
  return off_launch(st, off_slot, off_dslot, no, B, stream);
}

extern "C" int tile_diag_f32_launch(float *st, const long long *dslot,
                                    int *status, int nc, int B, double reg,
                                    double canceltol, void *stream) {
  return diag_launch(st, dslot, status, nc, B, reg, canceltol, stream);
}

extern "C" int tile_off_f32_launch(float *st, const long long *off_slot,
                                   const long long *off_dslot, int no, int B,
                                   void *stream) {
  return off_launch(st, off_slot, off_dslot, no, B, stream);
}
