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
//  (a) tile_diag: one block per column of the level.  The block loads the
//      lower triangle of D into dynamic shared memory as a symmetric tile
//      (B = 128: 128 KB in f64, 64 KB in f32, both above the 48 KB
//      default, so each instance's launch raises its own limit), forms
//      dmax = max|diag D| and the lift max(reg, canceltol dmax) + 1e-300,
//      and runs a right-looking Cholesky in shared memory.  On a pivot
//      that is <= 0 or not finite (the event at which LAPACK's potrf stops
//      and the reference finds a NaN factor) it restarts from the stored
//      tile with +(dmax + 1) I; on a second failure it writes the diagonal
//      sqrt(|D_ii + lift| + dmax + 1).  It writes L_D (zeros above the
//      diagonal) over the tile and the rung it took (0, 1, 2) into status.
//      Working layout: T[c][r] = A(r, c) for r >= c, so column k of L is
//      row k of T and every update reads and writes contiguous rows.
//  (b) tile_off: one block per valid (column, off tile): X = T L_D^-T,
//      i.e. forward substitution X[r, :] L_D' = T[r, :] row by row, one
//      thread per row.  L_D is packed by rows in shared memory (66 KB at
//      B = 128 in f64, 33 KB in f32) and read as a broadcast; X is held
//      transposed (128 KB, 64 KB in f32) so the threads' accesses are
//      contiguous.  Masked slots are not in the
//      level's list and are never written.
//
// Bound on the card: (a) does B^3/3 flops per diagonal tile, (b) B^3 per
// off tile; both read and write each tile once.  At B = 128 a tile is
// 2.1 Mflop against 128 KB (64 KB in f32), so the kernels sit near the
// card's balance point; this first version is latency-bound instead (one
// block per tile, a barrier per column in (a), a sequential substitution
// per thread in (b)).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DIAG_THREADS = 512;
constexpr int OFF_THREADS = 128;

// max that keeps a NaN from either side (jnp.max / jnp.maximum)
template <typename Real>
__device__ __forceinline__ Real nanmax(Real a, Real b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double fabs_t(double a) { return fabs(a); }
__device__ __forceinline__ float fabs_t(float a) { return fabsf(a); }

// Right-looking Cholesky of the B x B matrix held as T[c*B + r], r >= c.
// Returns false, uniformly over the block, at the first pivot that is not
// in (0, inf).
template <typename Real>
__device__ bool chol_rows(Real *T, int B) {
  for (int k = 0; k < B; ++k) {
    __syncthreads();
    const Real piv = T[k * B + k];
    if (!(piv > (Real)0 && piv < (Real)INFINITY)) return false;
    const Real lkk = sqrt_t(piv);
    __syncthreads();
    for (int i = k + threadIdx.x; i < B; i += blockDim.x)
      T[k * B + i] = (i == k) ? lkk : T[k * B + i] / lkk;
    __syncthreads();
    const int n = B - k - 1;
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
      const int j = k + 1 + idx / n, i = k + 1 + idx % n;
      if (i >= j) T[j * B + i] -= T[k * B + j] * T[k * B + i];
    }
  }
  __syncthreads();
  return true;
}

template <typename Real>
__device__ void load_lower(const Real *tile, Real *T, int B) {
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) {
    const int r = idx / B, c = idx % B;
    if (r >= c) T[c * B + r] = tile[idx];
  }
}

template <typename Real>
__global__ void tile_diag_kernel(Real *__restrict__ st,
                                 const long long *__restrict__ dslot,
                                 int *__restrict__ status, int B, double reg,
                                 double canceltol) {
  extern __shared__ __align__(16) unsigned char smem[];
  Real *T = reinterpret_cast<Real *>(smem);
  __shared__ Real s_dmax, s_lift;
  Real *tile = st + dslot[blockIdx.x] * (long long)B * B;
  load_lower(tile, T, B);
  __syncthreads();
  if (threadIdx.x == 0) {
    Real dmax = 0;
    for (int i = 0; i < B; ++i) dmax = nanmax(dmax, fabs_t(T[i * B + i]));
    s_dmax = dmax;
    s_lift = nanmax((Real)reg, (Real)canceltol * dmax) + (Real)1e-300;
  }
  __syncthreads();
  const Real dmax = s_dmax, lift = s_lift;
  for (int i = threadIdx.x; i < B; i += blockDim.x) T[i * B + i] += lift;
  bool ok = chol_rows(T, B);
  int rung = 0;
  if (!ok) {
    __syncthreads();
    load_lower(tile, T, B);
    __syncthreads();
    for (int i = threadIdx.x; i < B; i += blockDim.x)
      T[i * B + i] = (T[i * B + i] + lift) + (dmax + (Real)1);
    ok = chol_rows(T, B);
    rung = ok ? 1 : 2;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) {
    const int r = idx / B, c = idx % B;
    Real v = 0;
    if (ok) {
      if (r >= c) v = T[c * B + r];
    } else if (r == c) {
      v = sqrt_t(fabs_t(tile[idx] + lift) + (dmax + (Real)1));
    }
    tile[idx] = v;
  }
  if (threadIdx.x == 0) status[blockIdx.x] = rung;
}

template <typename Real>
__global__ void tile_off_kernel(Real *__restrict__ st,
                                const long long *__restrict__ off_slot,
                                const long long *__restrict__ off_dslot,
                                int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  Real *Lp = reinterpret_cast<Real *>(smem);  // L_D[c][k] at c(c+1)/2 + k
  Real *X = Lp + B * (B + 1) / 2;             // X[c * B + r] = T[r][c]
  const long long BB = (long long)B * B;
  const Real *Ld = st + off_dslot[blockIdx.x] * BB;
  Real *Tt = st + off_slot[blockIdx.x] * BB;
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) {
    const int r = idx / B, c = idx % B;
    if (c <= r) Lp[r * (r + 1) / 2 + c] = Ld[idx];
    X[c * B + r] = Tt[idx];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < B; r += blockDim.x) {
    for (int c = 0; c < B; ++c) {
      const Real *Lc = Lp + c * (c + 1) / 2;
      Real s = X[c * B + r];
      for (int k = 0; k < c; ++k) s -= Lc[k] * X[k * B + r];
      X[c * B + r] = s / Lc[c];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) {
    const int r = idx / B, c = idx % B;
    Tt[idx] = X[c * B + r];
  }
}

int raise_smem(const void *fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename Real>
int diag_launch(Real *st, const long long *dslot, int *status, int nc, int B,
                double reg, double canceltol, void *stream) {
  const size_t smem = sizeof(Real) * B * B;
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
  const size_t smem = sizeof(Real) * (B * (B + 1) / 2 + B * B);
  int err = raise_smem((const void *)tile_off_kernel<Real>, smem);
  if (err) return err;
  if (no > 0)
    tile_off_kernel<Real><<<no, OFF_THREADS, smem, (cudaStream_t)stream>>>(
        st, off_slot, off_dslot, B);
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
