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
// path for a zero numerator, and sparse tiles hold many zeros.
//
// Bound on the card: (a) does B^3/3 flops per diagonal tile, (b) B^3 per
// off tile; both read and write each tile once.  At B = 128 a tile is
// 2.1 Mflop against 128 KB (64 KB in f32), near the card's balance point;
// the chain of 128 dependent pivots (square root, division, update) per
// tile sets the kernels' time.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DIAG_THREADS = 256;
constexpr int OFF_THREADS = 128;
constexpr int PANEL = 32;
constexpr int OFF_ROWS = 32;
constexpr int MAXB = 128;
constexpr int LD = MAXB + 1;   // row stride of a tile in shared memory
constexpr unsigned FULL = 0xffffffffu;

// max that keeps a NaN from either side (jnp.max / jnp.maximum)
template <typename Real>
__device__ __forceinline__ Real nanmax(Real a, Real b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double fabs_t(double a) { return fabs(a); }
__device__ __forceinline__ float fabs_t(float a) { return fabsf(a); }

__host__ __device__ __forceinline__ int tri(int r) {
  return r * (r + 1) / 2;
}

// The value, hidden from the compiler, so that a division of it is not
// rewritten into a division of a zero.
__device__ __forceinline__ double opaque(double v) {
  asm volatile("" : "+d"(v));
  return v;
}
__device__ __forceinline__ float opaque(float v) {
  asm volatile("" : "+f"(v));
  return v;
}

// x / d for a pivot d in (0, inf).  A zero x divides d instead and keeps
// itself (what IEEE division gives, signed zero included): the card's
// division takes a slow path for a zero numerator (and for a literal 1,
// a reciprocal), and the sparse tiles hold many zeros.
template <typename Real>
__device__ __forceinline__ Real div_pos(Real x, Real d) {
  const Real q = opaque(x == Real(0) ? d : x) / d;
  return x == Real(0) ? x : q;
}

// Copy rows [0, nr) of a row-major tile with B columns into shared memory,
// row r to dst + off(r), only its first len(r) entries; asynchronous
// (cp.async, every copy in flight at once), waited for here.
template <typename Real, typename Off, typename Len>
__device__ void stage(const Real *src, int B, int nr, Real *dst, Off off,
                      Len len) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < nr; r += nwarps)
    for (int c = lane; c < len(r); c += 32)
      __pipeline_memcpy_async(dst + off(r) + c, src + r * B + c,
                              sizeof(Real));
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// The lower triangle of a row-major tile into A (row stride LD).
template <typename Real>
__device__ void load_lower(const Real *tile, Real *A, int B) {
  stage(tile, B, B, A, [](int r) { return r * LD; },
        [](int r) { return r + 1; });
}

// The trailing update of one panel on the lower triangle of A[q0:, q0:]:
// A[i][j] -= L[i][k] L[j][k] over the panel's columns k = p0, p0 + 1, ...
// in order.  Thread (ti, tj) of 16 x 16 owns i = q0 + ti + 16 u and
// j = q0 + tj + 16 v, v <= u (every block v > u lies above the diagonal),
// u, v < NG = ceil((B - q0) / 16), held in registers over the k loop.
template <int NG, typename Real>
__device__ void syrk(Real *A, int B, int p0, int P, int q0) {
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  Real acc[NG][NG];
#pragma unroll
  for (int u = 0; u < NG; ++u)
#pragma unroll
    for (int v = 0; v <= u; ++v) {
      const int i = q0 + ti + 16 * u, j = q0 + tj + 16 * v;
      acc[u][v] = (i < B && j <= i) ? A[i * LD + j] : Real(0);
    }
  for (int k = p0; k < p0 + P; ++k) {
    Real li[NG], lj[NG];
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      const int i = q0 + ti + 16 * u, j = q0 + tj + 16 * u;
      li[u] = i < B ? A[i * LD + k] : Real(0);
      lj[u] = j < B ? A[j * LD + k] : Real(0);
    }
#pragma unroll
    for (int u = 0; u < NG; ++u)
#pragma unroll
      for (int v = 0; v <= u; ++v) acc[u][v] = acc[u][v] - li[u] * lj[v];
  }
#pragma unroll
  for (int u = 0; u < NG; ++u)
#pragma unroll
    for (int v = 0; v <= u; ++v) {
      const int i = q0 + ti + 16 * u, j = q0 + tj + 16 * v;
      if (i < B && j <= i) A[i * LD + j] = acc[u][v];
    }
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
    const int n = B - e;
    if (n <= 0) break;
    switch ((n + 15) / 16) {
      case 1: syrk<1>(A, B, p0, e - p0, e); break;
      case 2: syrk<2>(A, B, p0, e - p0, e); break;
      case 3: syrk<3>(A, B, p0, e - p0, e); break;
      case 4: syrk<4>(A, B, p0, e - p0, e); break;
      case 5: syrk<5>(A, B, p0, e - p0, e); break;
      default: syrk<6>(A, B, p0, e - p0, e); break;
    }
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
  // the rows' chunk of X and each warp's current column of it, arrays of
  // their own (their stores do not hold up the loads of L_D)
  __shared__ Real X[OFF_ROWS * LD];             // X[r][c] at r LD + c
  constexpr int NW = OFF_THREADS / 32, RW = OFF_ROWS / NW;
  __shared__ Real colw[NW][RW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
  // rows are independent: warp w owns rows w RW ... w RW + RW - 1 and
  // meets no other warp
  const int rb = warp * RW, nr = max(0, min(RW, R - rb));
  Real *Xw = X + rb * LD;
  for (int p0 = 0; p0 < B; p0 += PANEL) {
    const int e = min(p0 + PANEL, B);
    // (1) the panel's columns one by one: the column's divisions (a lane a
    // row), then its products into the panel's later columns (a lane a
    // column)
    for (int c = p0; c < e; ++c) {
      if (lane < nr) {
        const Real xc = div_pos(Xw[lane * LD + c], Lp[tri(c) + c]);
        Xw[lane * LD + c] = xc;
        colw[warp][lane] = xc;
      }
      __syncwarp();
      const int t = c + 1 + lane;
      if (t < e) {
        const Real ltc = Lp[tri(t) + c];
        Real x[RW], xc[RW];   // every load first, then the products
#pragma unroll
        for (int k = 0; k < RW; ++k) {
          x[k] = k < nr ? Xw[k * LD + t] : Real(0);
          xc[k] = colw[warp][k];
        }
#pragma unroll
        for (int k = 0; k < RW; ++k)
          if (k < nr) Xw[k * LD + t] = x[k] - xc[k] * ltc;
      }
      __syncwarp();
    }
    // (2) the remaining columns j = e + lane + 32 m: X[r][j] -= X[r][k]
    // L[j][k], k in the panel in order
    if (e >= B) break;
    constexpr int NM = (MAXB - PANEL) / 32;   // 3
    Real acc[RW][NM];
#pragma unroll
    for (int k = 0; k < RW; ++k)
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int j = e + lane + 32 * m;
        acc[k][m] = (k < nr && j < B) ? Xw[k * LD + j] : Real(0);
      }
    for (int c = p0; c < e; ++c) {
      Real xk[RW], lj[NM];
#pragma unroll
      for (int k = 0; k < RW; ++k) xk[k] = Xw[k * LD + c];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int j = e + lane + 32 * m;
        lj[m] = j < B ? Lp[tri(j) + c] : Real(0);
      }
#pragma unroll
      for (int k = 0; k < RW; ++k)
#pragma unroll
        for (int m = 0; m < NM; ++m) acc[k][m] = acc[k][m] - xk[k] * lj[m];
    }
#pragma unroll
    for (int k = 0; k < RW; ++k)
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int j = e + lane + 32 * m;
        if (k < nr && j < B) Xw[k * LD + j] = acc[k][m];
      }
    __syncwarp();
  }
  for (int k = 0; k < nr; ++k)
    for (int c = lane; c < B; c += 32) T[(rb + k) * B + c] = Xw[k * LD + c];
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
