// K15: the per-step bodies of the distributed block substitution
// (parallel/panels._dist_trisolve, f64).
//
// Replaces the reference's sedumi_tpu/parallel/panels.py:_dist_trisolve
// (:117-178), whose fori_loop steps become three launches:
//   (a) panel_fwd_step, on the owner of block row j (:135-146):
//       xj = Ljj^-1 (bj - row x), row = L's block row j [bs, mp] (the
//       owner's contiguous panel), x zero at and beyond block j, so only
//       its first j*bs columns are read; the row-panel product and the
//       bs-triangle substitution are fused in one block;
//   (b) panel_bwd_contrib, on every rank (:156-162):
//       contrib = sum over local block rows g > j of L[g, j]' x_g;
//   (c) panel_bwd_solve, after the psum of [contrib; Ljj] (:170-171):
//       xj = Ljj^-T (bj - contrib).
// The per-step psum stays in the collective helper (parallel/mesh.py).
//
// Design.  One block of 256 threads per launch: the steps are sequential
// in j, and each is a few microseconds of work.  (a) each warp reduces rows
// of the row-panel product with lanes on neighbouring columns and a
// shuffle sum, then the substitution runs column by column over the
// residual held in shared memory, one barrier per column (every thread
// recomputes x_c = r_c / L_cc from the finished r_c).  (b) thread t sums
// column t % bs over a slice of the local rows, and the slices are summed
// in shared memory.  (c) as (a)'s substitution with Ljj' (back
// substitution).  bs <= 128.
//
// Bound on the card: latency.  At OH's shapes (bs = 128, mp = 1024) a
// forward step reads at most the 1 MiB row panel (0.31 us at 3.35 TB/s);
// the substitution is bs barrier-separated columns.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BS = 128;

// r[0:bs] holds the right-hand side; on return r[c] = x_c * L_cc and
// x[c] (shared) the solution of L x = r (lower) or L' x = r (upper, the
// transpose of the row-major lower L); L has row stride ld
__device__ void substitute(const double *__restrict__ L, int ld, int bs,
                           bool transpose, double *r, double *x) {
  for (int s = 0; s < bs; ++s) {
    const int c = transpose ? bs - 1 - s : s;
    const double xc = r[c] / L[(size_t)c * ld + c];
    for (int i = threadIdx.x; i < bs; i += blockDim.x) {
      const bool after = transpose ? i < c : i > c;
      if (after) {
        const double lic = transpose ? L[(size_t)c * ld + i]
                                     : L[(size_t)i * ld + c];
        r[i] = r[i] - lic * xc;
      }
    }
    if (threadIdx.x == 0) x[c] = xc;
    __syncthreads();
  }
}

__global__ void panel_fwd_step_kernel(const double *__restrict__ row,
                                      const double *__restrict__ x,
                                      const double *__restrict__ bj, int bs,
                                      int mp, int j,
                                      double *__restrict__ xj) {
  __shared__ double r[MAX_BS];
  __shared__ double xs[MAX_BS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32, kmax = j * bs;
  for (int i = warp; i < bs; i += nw) {
    const double *ri = row + (size_t)i * mp;
    double acc = 0.0;
    for (int k = lane; k < kmax; k += 32) acc = acc + ri[k] * x[k];
    for (int o = 16; o > 0; o >>= 1)
      acc = acc + __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) r[i] = bj[i] - acc;
  }
  __syncthreads();
  substitute(row + kmax, mp, bs, false, r, xs);
  for (int i = threadIdx.x; i < bs; i += blockDim.x) xj[i] = xs[i];
}

__global__ void panel_bwd_contrib_kernel(const double *__restrict__ L3,
                                         const double *__restrict__ x,
                                         int bs, int mp, int nb_loc, int g0,
                                         int j,
                                         double *__restrict__ contrib) {
  __shared__ double part[THREADS];
  const int b = threadIdx.x % bs, slice = threadIdx.x / bs;
  const int nslice = blockDim.x / bs;
  double acc = 0.0;
  if (slice < nslice) {
    // local rows (r, a) with natural block g0 + r > j
    const int r0 = j - g0 + 1 > 0 ? j - g0 + 1 : 0;
    for (int t = r0 * bs + slice; t < nb_loc * bs; t += nslice) {
      const int r = t / bs, a = t % bs;
      acc = acc + L3[(size_t)t * mp + (size_t)j * bs + b] *
                      x[(size_t)(g0 + r) * bs + a];
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < bs) {
    double s = 0.0;
    for (int q = 0; q < nslice; ++q) s = s + part[q * bs + threadIdx.x];
    contrib[threadIdx.x] = s;
  }
}

__global__ void panel_bwd_solve_kernel(const double *__restrict__ Ljj,
                                       const double *__restrict__ bj,
                                       const double *__restrict__ contrib,
                                       int bs, double *__restrict__ xj) {
  __shared__ double r[MAX_BS];
  __shared__ double xs[MAX_BS];
  for (int i = threadIdx.x; i < bs; i += blockDim.x)
    r[i] = bj[i] - contrib[i];
  __syncthreads();
  substitute(Ljj, bs, bs, true, r, xs);
  for (int i = threadIdx.x; i < bs; i += blockDim.x) xj[i] = xs[i];
}

}  // namespace

// row [bs, mp] (block row j of L), x [mp], bj [bs] -> xj [bs]
extern "C" int panel_fwd_step_launch(const double *row, const double *x,
                                     const double *bj, double *xj, int bs,
                                     int mp, int j, cudaStream_t stream) {
  if (bs < 1 || bs > MAX_BS || (j + 1) * bs > mp) return cudaErrorInvalidValue;
  panel_fwd_step_kernel<<<1, THREADS, 0, stream>>>(row, x, bj, bs, mp, j, xj);
  return cudaGetLastError();
}

// L3 [nb_loc * bs, mp] (this rank's contiguous panel, first natural block
// g0), x [mp] -> contrib [bs]
extern "C" int panel_bwd_contrib_launch(const double *L3, const double *x,
                                        double *contrib, int bs, int mp,
                                        int nb_loc, int g0, int j,
                                        cudaStream_t stream) {
  if (bs < 1 || bs > MAX_BS) return cudaErrorInvalidValue;
  panel_bwd_contrib_kernel<<<1, THREADS, 0, stream>>>(L3, x, bs, mp, nb_loc,
                                                      g0, j, contrib);
  return cudaGetLastError();
}

// Ljj [bs, bs], bj, contrib [bs] -> xj [bs]
extern "C" int panel_bwd_solve_launch(const double *Ljj, const double *bj,
                                      const double *contrib, double *xj,
                                      int bs, cudaStream_t stream) {
  if (bs < 1 || bs > MAX_BS) return cudaErrorInvalidValue;
  panel_bwd_solve_kernel<<<1, THREADS, 0, stream>>>(Ljj, bj, contrib, bs, xj);
  return cudaGetLastError();
}
