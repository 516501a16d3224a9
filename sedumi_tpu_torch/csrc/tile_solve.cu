// Level-scheduled triangular solves with the tile factor: kernel K10,
// three entry points launched per level.
//
// Replaces the reference's sedumi_tpu/sparse_chol.py:525 solve_tiles_ur
// (the same maths as solve_tiles_lv :322 and solve_tiles :368): L y = b
// level by level from the leaves, then L' x = y from the root.  y is the
// padded right-hand side as [ntc, B], updated in place.
//
//  (a) tile_fwd_diag: one block per column j of the level,
//      y_j <- L_D^-1 y_j.  L_D is packed by columns in shared memory
//      (66 KB at B = 128), y_j too; column k is finished by one thread,
//      then every thread i > k subtracts L[i][k] y_k, so y_i sees its terms
//      in the order k = 0, 1, ... as a forward substitution does.
//  (b) tile_fwd_scatter: one block per destination row tile r of the
//      level's off tiles: y_r -= sum T y_col over the tiles (T, col) that
//      the host's CSR lists for r, in plan order.  A warp owns a row of T
//      (lanes over its columns, coalesced), reduces by shuffles and adds
//      into a per-row sum; y_r is written once.  No atomics.
//  (c) tile_bwd: one block per column j, y_j <- L_D^-T (y_j - sum_o T_o'
//      y[orow_o]).  The correction is a gather only (thread b sums column b
//      of each T_o against y[orow_o] in shared memory); then the backward
//      substitution with L_D packed by rows.
//
// The kernels are templates: the f64 build is K10, the f32 build K10-f32
// (the f32 phases' tile factor; shared memory halves: 33 KB for a packed
// L_D at B = 128).
//
// Bound on the card: each L tile is read once per solve (2 B^2 flops per
// 8 B^2 bytes, 4 B^2 in f32), so bytes bound it.  This first version is
// latency-bound instead: a barrier per row of every diagonal tile, and
// three launches per level.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int SCATTER_THREADS = 256;
constexpr int MAXB = 128;

__host__ __device__ __forceinline__ int col_start(int k, int B) {
  return k * B - k * (k - 1) / 2;   // packed-by-columns offset of L[k][k]
}

template <typename Real>
__global__ void tile_fwd_diag_kernel(const Real *__restrict__ L,
                                     Real *__restrict__ y,
                                     const long long *__restrict__ dslot,
                                     const long long *__restrict__ cols,
                                     int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  Real *Lc = reinterpret_cast<Real *>(smem);  // L[i][k], col_start(k) + i - k
  __shared__ Real ys[MAXB];
  const Real *Ld = L + dslot[blockIdx.x] * (long long)B * B;
  Real *yj = y + cols[blockIdx.x] * (long long)B;
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) {
    const int r = idx / B, c = idx % B;
    if (r >= c) Lc[col_start(c, B) + r - c] = Ld[idx];
  }
  for (int i = threadIdx.x; i < B; i += blockDim.x) ys[i] = yj[i];
  __syncthreads();
  for (int k = 0; k < B; ++k) {
    const int ck = col_start(k, B);
    if (threadIdx.x == 0) ys[k] = ys[k] / Lc[ck];
    __syncthreads();
    const Real yk = ys[k];
    for (int i = k + 1 + threadIdx.x; i < B; i += blockDim.x)
      ys[i] -= Lc[ck + i - k] * yk;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < B; i += blockDim.x) yj[i] = ys[i];
}

template <typename Real>
__global__ void tile_fwd_scatter_kernel(const Real *__restrict__ L,
                                        Real *__restrict__ y,
                                        const long long *__restrict__ fs_row,
                                        const long long *__restrict__ fs_ptr,
                                        const long long *__restrict__ fs_slot,
                                        const long long *__restrict__ fs_col,
                                        int B) {
  __shared__ Real yv[MAXB];
  __shared__ Real acc[MAXB];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const long long BB = (long long)B * B;
  for (int a = threadIdx.x; a < B; a += blockDim.x) acc[a] = 0;
  for (long long p = fs_ptr[blockIdx.x]; p < fs_ptr[blockIdx.x + 1]; ++p) {
    __syncthreads();
    for (int b = threadIdx.x; b < B; b += blockDim.x)
      yv[b] = y[fs_col[p] * B + b];
    __syncthreads();
    const Real *T = L + fs_slot[p] * BB;
    for (int a = warp; a < B; a += nwarps) {
      Real s = 0;
      for (int b = lane; b < B; b += 32) s += T[(long long)a * B + b] * yv[b];
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) acc[a] += s;
    }
  }
  __syncthreads();
  Real *yr = y + fs_row[blockIdx.x] * B;
  for (int a = threadIdx.x; a < B; a += blockDim.x) yr[a] -= acc[a];
}

template <typename Real>
__global__ void tile_bwd_kernel(const Real *__restrict__ L,
                                Real *__restrict__ y,
                                const long long *__restrict__ dslot,
                                const long long *__restrict__ cols,
                                const long long *__restrict__ off_ptr,
                                const long long *__restrict__ off_slot,
                                const long long *__restrict__ off_row,
                                int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  Real *Lr = reinterpret_cast<Real *>(smem);  // L[c][i] at c (c + 1) / 2 + i
  __shared__ Real yr[MAXB];
  __shared__ Real z[MAXB];
  const long long BB = (long long)B * B;
  const Real *Ld = L + dslot[blockIdx.x] * BB;
  Real *yj = y + cols[blockIdx.x] * (long long)B;
  for (int idx = threadIdx.x; idx < B * B; idx += blockDim.x) {
    const int r = idx / B, c = idx % B;
    if (c <= r) Lr[r * (r + 1) / 2 + c] = Ld[idx];
  }
  // thread b owns column b (B <= MAXB = THREADS)
  const int b = threadIdx.x;
  Real corr = 0;
  for (long long o = off_ptr[blockIdx.x]; o < off_ptr[blockIdx.x + 1]; ++o) {
    __syncthreads();
    for (int a = threadIdx.x; a < B; a += blockDim.x)
      yr[a] = y[off_row[o] * B + a];
    __syncthreads();
    const Real *T = L + off_slot[o] * BB;
    if (b < B)
      for (int a = 0; a < B; ++a) corr += T[(long long)a * B + b] * yr[a];
  }
  if (b < B) z[b] = yj[b] - corr;
  __syncthreads();
  for (int c = B - 1; c >= 0; --c) {
    const int rc = c * (c + 1) / 2;
    if (threadIdx.x == 0) z[c] = z[c] / Lr[rc + c];
    __syncthreads();
    const Real zc = z[c];
    for (int i = threadIdx.x; i < c; i += blockDim.x) z[i] -= Lr[rc + i] * zc;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < B; i += blockDim.x) yj[i] = z[i];
}

int raise_smem(const void *fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename Real>
int fwd_diag_launch(const Real *L, Real *y, const long long *dslot,
                    const long long *cols, int nc, int B, void *stream) {
  if (B > MAXB) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Real) * (B * (B + 1) / 2);
  int err = raise_smem((const void *)tile_fwd_diag_kernel<Real>, smem);
  if (err) return err;
  if (nc > 0)
    tile_fwd_diag_kernel<Real><<<nc, THREADS, smem, (cudaStream_t)stream>>>(
        L, y, dslot, cols, B);
  return (int)cudaGetLastError();
}

template <typename Real>
int fwd_scatter_launch(const Real *L, Real *y, const long long *fs_row,
                       const long long *fs_ptr, const long long *fs_slot,
                       const long long *fs_col, int nr, int B, void *stream) {
  if (B > MAXB) return (int)cudaErrorInvalidValue;
  if (nr > 0)
    tile_fwd_scatter_kernel<Real><<<nr, SCATTER_THREADS, 0,
                                    (cudaStream_t)stream>>>(
        L, y, fs_row, fs_ptr, fs_slot, fs_col, B);
  return (int)cudaGetLastError();
}

template <typename Real>
int bwd_launch(const Real *L, Real *y, const long long *dslot,
               const long long *cols, const long long *off_ptr,
               const long long *off_slot, const long long *off_row, int nc,
               int B, void *stream) {
  if (B > MAXB) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Real) * (B * (B + 1) / 2);
  int err = raise_smem((const void *)tile_bwd_kernel<Real>, smem);
  if (err) return err;
  if (nc > 0)
    tile_bwd_kernel<Real><<<nc, THREADS, smem, (cudaStream_t)stream>>>(
        L, y, dslot, cols, off_ptr, off_slot, off_row, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tile_fwd_diag_launch(const double *L, double *y,
                                    const long long *dslot,
                                    const long long *cols, int nc, int B,
                                    void *stream) {
  return fwd_diag_launch(L, y, dslot, cols, nc, B, stream);
}

extern "C" int tile_fwd_scatter_launch(const double *L, double *y,
                                       const long long *fs_row,
                                       const long long *fs_ptr,
                                       const long long *fs_slot,
                                       const long long *fs_col, int nr,
                                       int B, void *stream) {
  return fwd_scatter_launch(L, y, fs_row, fs_ptr, fs_slot, fs_col, nr, B,
                            stream);
}

extern "C" int tile_bwd_launch(const double *L, double *y,
                               const long long *dslot, const long long *cols,
                               const long long *off_ptr,
                               const long long *off_slot,
                               const long long *off_row, int nc, int B,
                               void *stream) {
  return bwd_launch(L, y, dslot, cols, off_ptr, off_slot, off_row, nc, B,
                    stream);
}

extern "C" int tile_fwd_diag_f32_launch(const float *L, float *y,
                                        const long long *dslot,
                                        const long long *cols, int nc, int B,
                                        void *stream) {
  return fwd_diag_launch(L, y, dslot, cols, nc, B, stream);
}

extern "C" int tile_fwd_scatter_f32_launch(const float *L, float *y,
                                           const long long *fs_row,
                                           const long long *fs_ptr,
                                           const long long *fs_slot,
                                           const long long *fs_col, int nr,
                                           int B, void *stream) {
  return fwd_scatter_launch(L, y, fs_row, fs_ptr, fs_slot, fs_col, nr, B,
                            stream);
}

extern "C" int tile_bwd_f32_launch(const float *L, float *y,
                                   const long long *dslot,
                                   const long long *cols,
                                   const long long *off_ptr,
                                   const long long *off_slot,
                                   const long long *off_row, int nc, int B,
                                   void *stream) {
  return bwd_launch(L, y, dslot, cols, off_ptr, off_slot, off_row, nc, B,
                    stream);
}
