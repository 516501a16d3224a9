// K14: one block column of the distributed block-cyclic Cholesky
// (parallel/panels.dist_cholesky, f64).
//
// Replaces the per-block-column body of the reference's
// sedumi_tpu/parallel/panels.py:dist_cholesky (:79-87): given the block
// column j gathered from every rank in natural block order, C [nb, bs, bs],
//   Ljj     = chol(C[j])                     (lower; NaN if not PD)
//   Linv    = Ljj^-1                          (formed explicitly, :83-85)
//   Lcol[k] = C[k] Linv'  for k > j,  Ljj for k = j,  0 for k < j.
// The trailing GEMM update and the strict-upper zeroing stay torch.
//
// Design.  Launch 1 (panel_diag): one block factors C[j] in shared memory
// (right-looking, one column per step, the diagonal block's lower triangle
// only) and writes Ljj; then thread c forms column c of Linv by forward
// substitution on e_c, reading Ljj from shared memory (every thread reads
// the same entry at a time: a broadcast).  A pivot that is not > 0 (or not
// finite) sets a flag, and Ljj and Linv are then written as NaN, as
// jnp.linalg.cholesky returns NaN for a matrix that is not PD; the kernel
// never traps.  bs <= 128: the bs x bs f64 tile is 128 KB of the 227 KB a
// block may take (dynamic shared memory above 48 KB), so Ljj and its
// inverse do not both fit and Linv goes to device memory (L2-resident).
// Launch 2 (panel_col): a grid of (nb, bs/16, bs/16) blocks of 16 x 16
// threads; blocks of column blocks k > j run a shared-memory tiled product
// C[k] Linv' (Linv read from L2), k = j copies Ljj, k < j writes 0.
//
// Bound on the card: latency.  At OH's shapes (bs = 128, nb = 8) a column
// moves ~2 MiB (0.6 us at 3.35 TB/s) and does <= 3e7 flops; launch 1 is bs
// sequential steps with two barriers each plus a bs^2/2-long substitution
// per thread.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int DIAG_THREADS = 256;
constexpr int TILE = 16;

__global__ void panel_diag_kernel(const double *__restrict__ C, int bs, int j,
                                  double *__restrict__ Ljj,
                                  double *__restrict__ Linv) {
  extern __shared__ double A[];  // bs x bs, row-major
  __shared__ int bad;
  const double *Cj = C + (size_t)j * bs * bs;
  for (int t = threadIdx.x; t < bs * bs; t += blockDim.x) A[t] = Cj[t];
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  for (int k = 0; k < bs; ++k) {
    if (threadIdx.x == 0) {
      const double p = A[k * bs + k];
      if (!(p > 0.0) || isinf(p)) bad = 1;
      A[k * bs + k] = sqrt(p);
    }
    __syncthreads();
    const double d = A[k * bs + k];
    for (int i = k + 1 + threadIdx.x; i < bs; i += blockDim.x)
      A[i * bs + k] = A[i * bs + k] / d;
    __syncthreads();
    const int n = bs - k - 1;
    for (int t = threadIdx.x; t < n * n; t += blockDim.x) {
      const int i = k + 1 + t / n, l = k + 1 + t % n;
      if (l <= i)
        A[i * bs + l] = A[i * bs + l] - A[i * bs + k] * A[l * bs + k];
    }
    __syncthreads();
  }
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  const bool failed = bad != 0;
  for (int t = threadIdx.x; t < bs * bs; t += blockDim.x) {
    const int i = t / bs, l = t % bs;
    Ljj[t] = failed ? nan : (l <= i ? A[t] : 0.0);
  }
  // column c of Ljj^-1: X[i, c] = (delta_ic - sum_{c<=k<i} L[i,k] X[k,c])
  // / L[i,i] for i >= c, zero above; X kept in Linv (row-major)
  const int c = threadIdx.x;
  if (c < bs) {
    for (int i = 0; i < bs; ++i) {
      double acc = (i == c) ? 1.0 : 0.0;
      for (int k = 0; k < i; ++k)
        if (k >= c) acc = acc - A[i * bs + k] * Linv[(size_t)k * bs + c];
      Linv[(size_t)i * bs + c] =
          failed ? nan : (i >= c ? acc / A[i * bs + i] : 0.0);
    }
  }
}

__global__ void panel_col_kernel(const double *__restrict__ C,
                                 const double *__restrict__ Ljj,
                                 const double *__restrict__ Linv, int bs,
                                 int j, double *__restrict__ Lcol) {
  __shared__ double As[TILE][TILE + 1];
  __shared__ double Bs[TILE][TILE + 1];
  const int k = blockIdx.x;
  const int a = blockIdx.y * TILE + threadIdx.y;  // row of the block
  const int c = blockIdx.z * TILE + threadIdx.x;  // column of the block
  const size_t off = (size_t)k * bs * bs;
  if (k <= j) {
    if (a < bs && c < bs)
      Lcol[off + (size_t)a * bs + c] = k == j ? Ljj[(size_t)a * bs + c] : 0.0;
    return;
  }
  // Lcol[k][a][c] = sum_b C[k][a][b] Linv[c][b]
  const int cb = blockIdx.z * TILE + threadIdx.y;  // Linv row for the tile
  double acc = 0.0;
  for (int b0 = 0; b0 < bs; b0 += TILE) {
    const int b = b0 + threadIdx.x;
    As[threadIdx.y][threadIdx.x] =
        (a < bs && b < bs) ? C[off + (size_t)a * bs + b] : 0.0;
    Bs[threadIdx.y][threadIdx.x] =
        (cb < bs && b < bs) ? Linv[(size_t)cb * bs + b] : 0.0;
    __syncthreads();
    for (int t = 0; t < TILE; ++t)
      acc = acc + As[threadIdx.y][t] * Bs[threadIdx.x][t];
    __syncthreads();
  }
  if (a < bs && c < bs) Lcol[off + (size_t)a * bs + c] = acc;
}

}  // namespace

// C [nb, bs, bs] (natural block order), column j; Ljj and Linv [bs, bs]
// scratch, Lcol [nb, bs, bs] out.  Returns cudaGetLastError().
extern "C" int panel_chol_launch(const double *C, double *Ljj, double *Linv,
                                 double *Lcol, int nb, int bs, int j,
                                 cudaStream_t stream) {
  if (bs < 1 || bs > 128 || j < 0 || j >= nb) return cudaErrorInvalidValue;
  const size_t smem = (size_t)bs * bs * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      panel_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  panel_diag_kernel<<<1, DIAG_THREADS, smem, stream>>>(C, bs, j, Ljj, Linv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (bs + TILE - 1) / TILE;
  panel_col_kernel<<<dim3(nb, tiles, tiles), dim3(TILE, TILE), 0, stream>>>(
      C, Ljj, Linv, bs, j, Lcol);
  return cudaGetLastError();
}
