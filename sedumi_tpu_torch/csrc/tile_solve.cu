// Level-scheduled triangular solves with the tile factor: kernel K10, one
// persistent cooperative kernel per pass (two launches per solve).
//
// Replaces the reference's sedumi_tpu/sparse_chol.py:525 solve_tiles_ur
// (the same maths as solve_tiles_lv :322 and solve_tiles :368): L y = b
// level by level from the leaves, then L' x = y from the root.  y is the
// padded right-hand side as [ntc, B], updated in place.  The levels come
// flattened once per plan (sparse_chol.flatten_levels): per-level offsets
// into one list of columns, one list of off tiles (grouped by column) and
// one CSR of off tiles by destination row.
//
// Each pass walks every level inside one kernel; its blocks (one per SM by
// default, all resident: cooperative launch, checked against the
// occupancy first) take the items of a phase in turn and meet at a grid
// barrier after it.  Forward, per level:
//  (F1) one item per column j: y_j <- L_D^-1 y_j;
//  (F2) one item per (destination row tile r, 32-row chunk):
//       y_r -= sum_p T_p y_col(p) over r's off tiles in plan (CSR) order.
//       A warp owns rows of the chunk, lanes its columns (coalesced), and
//       reduces each tile's row by shuffles into a per-row sum; no atomics.
// Backward, per level from the root:
//  (B1) one item per (off tile o, 32-column chunk): the partial
//       part_o = T_o' y[orow_o] into a buffer (8 warps split the rows,
//       their sums added in warp order);
//  (B2) one item per column j: y_j <- L_D^-T (y_j - sum_o part_o), the
//       column's partials added in plan order.
// Every sum has a fixed order, so two calls on the same inputs agree bit
// for bit whatever the grid.
//
// The diagonal solves are blocked: L_D is packed by rows in shared memory
// (66 KB at B = 128 in f64), staged by cp.async, and a block fetches its
// tile of the next level while the grid meets at the barriers; panels of
// 32 rows (fewer at the end when B is not a multiple of 32).  Warp 0
// solves the panel's triangle with shuffles (one quotient per row, as a
// substitution does; no inverse: the IEEE quotient by div_rn.cuh's
// reciprocal rule, the panel run again with the division where the rule's
// range fails), then every thread updates one row below (above, backward)
// with the panel's values.  Warp 0 updates the next panel's rows itself,
// so it can go on without waiting: one block barrier per panel.  The
// fetch and both triangle solves are tri_solve.cuh's, shared with K15
// (panel_solve.cu).
//
// The kernels are templates: the f64 build is K10, the f32 build K10-f32
// (the f32 phases' tile factor; 33 KB for a packed L_D at B = 128).
//
// Bound on the card: each L tile is read once per pass (2 B^2 flops per
// 8 B^2 bytes, 4 B^2 in f32), so bytes bound it; but the levels form a
// chain of 2 x levels dependent steps, each a 128-long substitution, and
// a grid barrier between phases.  The design spends one
// launch per pass and one barrier per phase on it.

#include "tri_solve.cuh"

namespace {

using namespace dense;

// Grid barrier for a cooperative launch.  bar[0] counts arrivals and is
// reset by the last one, bar[1] is the generation the others wait on; the
// pair is zero before the first launch and stays reusable.
__device__ __forceinline__ void grid_sync(unsigned *bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned *gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(20);
    }
    __threadfence();
  }
  __syncthreads();
}

// Fetch this block's first diagonal tile of the level's columns
// [c0, c0 + nc), if it has one: a block takes columns blockIdx.x,
// blockIdx.x + gridDim.x, ...
template <typename Real>
__device__ void prefetch_first(const Real *L, const long long *dslot,
                               long long c0, long long nc, Real *Lp, int B) {
  if (blockIdx.x < nc)
    fetch_packed(L + dslot[c0 + blockIdx.x] * (long long)B * B, B, Lp,
                 B);
}

struct FwdPlan {
  const long long *lev_cols, *cols, *dslot;   // F1
  const long long *lev_fs, *fs_row, *fs_ptr, *fs_slot, *fs_col;  // F2
  int nlev;
};

struct BwdPlan {
  const long long *lev_cols, *cols, *dslot, *col_off;   // B2
  const long long *lev_off, *off_slot, *off_row;        // B1
  int nlev;
};

template <typename Real>
__global__ void __launch_bounds__(THREADS)
tile_solve_fwd_kernel(const Real *__restrict__ L, Real *y, FwdPlan p,
                      unsigned *bar, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  Real *Lp = reinterpret_cast<Real *>(smem);
  __shared__ Real ys[MAXB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long BB = (long long)B * B;
  const int nq = (B + 31) / 32;
  prefetch_first(L, p.dslot, 0, p.lev_cols[1], Lp, B);
  for (int l = 0; l < p.nlev; ++l) {
    // (F1) the level's diagonal solves; the first tile was fetched during
    // the previous level
    const long long c0 = p.lev_cols[l], nc = p.lev_cols[l + 1] - c0;
    for (long long it = blockIdx.x; it < nc; it += gridDim.x) {
      if (it != blockIdx.x)
        fetch_packed(L + p.dslot[c0 + it] * BB, B, Lp, B);
      __pipeline_wait_prior(0);
      Real *yj = y + p.cols[c0 + it] * B;
      for (int i = threadIdx.x; i < B; i += THREADS) ys[i] = __ldcg(yj + i);
      __syncthreads();
      fwd_diag(Lp, ys, B);
      for (int i = threadIdx.x; i < B; i += THREADS) __stcg(yj + i, ys[i]);
      __syncthreads();
    }
    if (l + 1 < p.nlev)
      prefetch_first(L, p.dslot, p.lev_cols[l + 1],
                     p.lev_cols[l + 2] - p.lev_cols[l + 1], Lp, B);
    const long long f0 = p.lev_fs[l], nr = p.lev_fs[l + 1] - f0;
    if (nr == 0) continue;
    grid_sync(bar);
    // (F2) the level's scatter, by destination row tile and row chunk
    for (long long it = blockIdx.x; it < nr * nq; it += gridDim.x) {
      const long long d = f0 + it / nq;
      const int a0 = (int)(it % nq) * 32;
      Real acc[4] = {0, 0, 0, 0};
      for (long long q = p.fs_ptr[d]; q < p.fs_ptr[d + 1]; ++q) {
        const Real *T = L + p.fs_slot[q] * BB;
        const Real *yc = y + p.fs_col[q] * B;
        Real yv[MAXB / 32];
#pragma unroll
        for (int t = 0; t < MAXB / 32; ++t)
          yv[t] = lane + 32 * t < B ? __ldcg(yc + lane + 32 * t) : Real(0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int a = a0 + warp + NWARPS * i;
          if (a >= min(a0 + 32, B)) continue;
          Real s = 0;
#pragma unroll
          for (int t = 0; t < MAXB / 32; ++t)
            if (lane + 32 * t < B)
              s = s + __ldg(T + (long long)a * B + lane + 32 * t) * yv[t];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            s = s + __shfl_down_sync(FULL, s, off);
          acc[i] = acc[i] + s;
        }
      }
      Real *yr = y + p.fs_row[d] * B;
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int a = a0 + warp + NWARPS * i;
          if (a < min(a0 + 32, B)) __stcg(yr + a, __ldcg(yr + a) - acc[i]);
        }
      }
    }
    grid_sync(bar);
  }
}

template <typename Real>
__global__ void __launch_bounds__(THREADS)
tile_solve_bwd_kernel(const Real *__restrict__ L, Real *y, Real *part,
                      BwdPlan p, unsigned *bar, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  Real *Lp = reinterpret_cast<Real *>(smem);
  __shared__ Real zs[MAXB];
  __shared__ Real red[NWARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long BB = (long long)B * B;
  const int nq = (B + 31) / 32;
  prefetch_first(L, p.dslot, p.lev_cols[p.nlev - 1],
                 p.lev_cols[p.nlev] - p.lev_cols[p.nlev - 1], Lp, B);
  for (int l = p.nlev - 1; l >= 0; --l) {
    // (B1) partials T_o' y[orow_o], by off tile and column chunk
    const long long o0 = p.lev_off[l], no = p.lev_off[l + 1] - o0;
    if (no > 0) {
      for (long long it = blockIdx.x; it < no * nq; it += gridDim.x) {
        const long long o = o0 + it / nq;
        const int b = (int)(it % nq) * 32 + lane;
        const Real *T = L + p.off_slot[o] * BB;
        const Real *yr = y + p.off_row[o] * B;
        Real s = 0;
        if (b < B)
          for (int a = warp; a < B; a += NWARPS)
            s = s + __ldg(T + (long long)a * B + b) * __ldcg(yr + a);
        red[warp][lane] = s;
        __syncthreads();
        if (warp == 0 && b < B) {
          Real t = red[0][lane];
#pragma unroll
          for (int w = 1; w < NWARPS; ++w) t = t + red[w][lane];
          __stcg(part + o * B + b, t);
        }
        __syncthreads();
      }
      grid_sync(bar);
    }
    // (B2) the level's columns: gather the partials, then L_D^-T; the
    // first tile was fetched during the level above
    const long long c0 = p.lev_cols[l], nc = p.lev_cols[l + 1] - c0;
    for (long long it = blockIdx.x; it < nc; it += gridDim.x) {
      const long long j = c0 + it;
      if (it != blockIdx.x) fetch_packed(L + p.dslot[j] * BB, B, Lp, B);
      __pipeline_wait_prior(0);
      Real *yj = y + p.cols[j] * B;
      for (int i = threadIdx.x; i < B; i += THREADS) {
        // the partials in plan order, loaded eight at a time
        Real corr = 0;
        long long o = p.col_off[j];
        const long long oe = p.col_off[j + 1];
        for (; o + 8 <= oe; o += 8) {
          Real v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = __ldcg(part + (o + u) * B + i);
#pragma unroll
          for (int u = 0; u < 8; ++u) corr = corr + v[u];
        }
        for (; o < oe; ++o) corr = corr + __ldcg(part + o * B + i);
        zs[i] = __ldcg(yj + i) - corr;
      }
      __syncthreads();
      bwd_diag(Lp, zs, B);
      for (int i = threadIdx.x; i < B; i += THREADS) __stcg(yj + i, zs[i]);
      __syncthreads();
    }
    if (l > 0) {
      prefetch_first(L, p.dslot, p.lev_cols[l - 1], c0 - p.lev_cols[l - 1],
                     Lp, B);
      grid_sync(bar);
    }
  }
}

// Launch `kernel` cooperatively on `grid` blocks (<= 0: one per SM).
// Refuses (cudaErrorCooperativeLaunchTooLarge) a grid that the card cannot
// hold resident at this kernel's shared memory and threads.
template <typename K>
int cooperative(K kernel, int grid, size_t smem, void **args, void *stream) {
  int dev = 0, nsm = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(
      &nsm, cudaDevAttrMultiProcessorCount, dev);
  if (!err && smem > 48 * 1024)
    err = (int)cudaFuncSetAttribute(
        (const void *)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, THREADS, smem);
  if (err) return err;
  if (grid <= 0) grid = nsm;
  if (grid > per_sm * nsm) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = (int)cudaLaunchCooperativeKernel((const void *)kernel, grid, THREADS,
                                         args, smem, (cudaStream_t)stream);
  return err ? err : (int)cudaGetLastError();
}

template <typename Real>
int fwd_launch(const Real *L, Real *y, const long long *lev_cols,
               const long long *cols, const long long *dslot,
               const long long *lev_fs, const long long *fs_row,
               const long long *fs_ptr, const long long *fs_slot,
               const long long *fs_col, unsigned *bar, int nlev, int B,
               int grid, void *stream) {
  if (B < 1 || B > MAXB) return (int)cudaErrorInvalidValue;
  if (nlev <= 0) return 0;
  FwdPlan p{lev_cols, cols, dslot, lev_fs, fs_row, fs_ptr, fs_slot, fs_col,
            nlev};
  void *args[] = {(void *)&L, (void *)&y, (void *)&p, (void *)&bar,
                  (void *)&B};
  return cooperative(tile_solve_fwd_kernel<Real>, grid,
                     sizeof(Real) * tri(B), args, stream);
}

template <typename Real>
int bwd_launch(const Real *L, Real *y, Real *part, const long long *lev_cols,
               const long long *cols, const long long *dslot,
               const long long *col_off, const long long *lev_off,
               const long long *off_slot, const long long *off_row,
               unsigned *bar, int nlev, int B, int grid, void *stream) {
  if (B < 1 || B > MAXB) return (int)cudaErrorInvalidValue;
  if (nlev <= 0) return 0;
  BwdPlan p{lev_cols, cols, dslot, col_off, lev_off, off_slot, off_row,
            nlev};
  void *args[] = {(void *)&L, (void *)&y, (void *)&part, (void *)&p,
                  (void *)&bar, (void *)&B};
  return cooperative(tile_solve_bwd_kernel<Real>, grid,
                     sizeof(Real) * tri(B), args, stream);
}

}  // namespace

#define TILE_SOLVE_ENTRIES(SFX, Real)                                        \
  extern "C" int tile_solve_fwd##SFX##_launch(                              \
      const Real *L, Real *y, const long long *lev_cols,                    \
      const long long *cols, const long long *dslot,                        \
      const long long *lev_fs, const long long *fs_row,                     \
      const long long *fs_ptr, const long long *fs_slot,                    \
      const long long *fs_col, unsigned *bar, int nlev, int B, int grid,    \
      void *stream) {                                                       \
    return fwd_launch(L, y, lev_cols, cols, dslot, lev_fs, fs_row, fs_ptr,  \
                      fs_slot, fs_col, bar, nlev, B, grid, stream);         \
  }                                                                         \
  extern "C" int tile_solve_bwd##SFX##_launch(                              \
      const Real *L, Real *y, Real *part, const long long *lev_cols,        \
      const long long *cols, const long long *dslot,                        \
      const long long *col_off, const long long *lev_off,                   \
      const long long *off_slot, const long long *off_row, unsigned *bar,   \
      int nlev, int B, int grid, void *stream) {                            \
    return bwd_launch(L, y, part, lev_cols, cols, dslot, col_off, lev_off,  \
                      off_slot, off_row, bar, nlev, B, grid, stream);       \
  }

TILE_SOLVE_ENTRIES(, double)
TILE_SOLVE_ENTRIES(_f32, float)
