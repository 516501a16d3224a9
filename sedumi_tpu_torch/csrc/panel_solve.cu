// K15: the per-step bodies of the distributed block substitution
// (parallel/panels._dist_trisolve).
//
// Replaces the step bodies of the reference's sedumi_tpu/parallel/
// panels.py:_dist_trisolve (:117), whose fori_loop steps become three
// launches:
//   (a) panel_fwd_step, on the owner of block row j (:135-146):
//       xj = Ljj^-1 (bj - row x), row = L's block row j [bs, mp] (the
//       owner's contiguous panel), x zero at and beyond block j, so only
//       its first j*bs columns are read;
//   (b) panel_bwd_contrib, on every rank (:156-162):
//       contrib = sum over local block rows g > j of L[g, j]' x_g;
//   (c) panel_bwd_solve, after the psum of [contrib; Ljj] (:170-171):
//       xj = Ljj^-T (bj - contrib).
// The per-step psum stays in the collective helper (parallel/mesh.py).
//
// Bound on the card: latency.  At OH's shapes (bs = 128, mp = 1024) a
// forward step reads at most the 1 MiB row panel (0.31 us at 3.35 TB/s),
// a contribution 512 KB; what sets the time is the triangle's chain of
// bs dependent quotients and the launch.
//
// Design.  The triangles are K10's (tri_solve.cuh): Ljj packed by rows in
// shared memory by cp.async, warp 0 solving each 32-row panel while the
// other warps update the rows below (above): one block barrier per panel,
// no device-memory load in the chain.  Warp 0 runs a panel as a run-time
// loop (small code), each lane's quotient by one reciprocal of its
// diagonal entry, formed before the panel, and two fma corrections
// (div_rn.cuh): a product and four fmas on the chain in place of a
// division's ~125 cycles; a lane keeps the value it divided, and if Div's
// range failed for one, the warp runs the panel again with the division.
//   (a) a thread-block cluster of up to 8 CTAs splits the row product by
//       column groups of FWD_GROUP: CTA q takes groups q, q + C, ...; a
//       warp a row at a time, lanes on neighbouring columns (coalesced),
//       a shuffle tree per row, one partial per (group, row) in the CTA's
//       shared memory.  The leader, whose Ljj fetch was in flight
//       meanwhile, adds the partials group by group from the cluster's
//       shared memory, r = bj - sum, then solves the triangle.
//   (b) one cluster per chunk of the block column: in f64 a lane reads
//       two columns in one 16-byte load (chunks of 64 columns; L3 must be
//       16-byte aligned and mp, bs even, else the launch is refused), in
//       f32 a lane one column (chunks of 32: the 16-byte form, four f32
//       columns a lane, ran slower there, PERF.md §6); its CTAs take the
//       local rows in groups of BWD_GROUP (as K10's partials: eight warps
//       split the group's rows, in the f64 form each warp's loads all in
//       flight before its sums, the warps' sums added in warp order); the
//       leader adds the groups' partials in group order.  No atomics.
//   (c) one block: the fetch, bj - contrib, the triangle.
// Every sum's order is fixed by the group sizes, not by the cluster's
// size, so two calls agree bit for bit whatever the grid, and
// tests/panel_emulation.py repeats the kernels bit for bit.  bs <= 128.
// The kernels are templates over the element type (but for (b)'s two
// forms, one a type): the f64 builds are K15, the f32 builds K15-f32 (the
// f32 phase of the precision ladder under a mesh), with the same groups,
// so the same order; each kernel sizes its
// shared memory by sizeof(Real), and its quotients are the IEEE ones in
// either type.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "tri_solve.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dense;

constexpr int FWD_GROUP = 128;   // columns of the row product a partial
constexpr int BWD_GROUP = 64;    // rows of the contribution a partial
constexpr int MAX_CLUSTER = 8;   // the portable cluster size

template <typename Real>
__global__ void __launch_bounds__(THREADS)
panel_fwd_kernel(const Real *__restrict__ row, const Real *__restrict__ x,
                 const Real *__restrict__ bj, int bs, int mp, int j,
                 Real *__restrict__ xj) {
  // part: this CTA's partials [slot][bs]; then the leader's packed Ljj
  extern __shared__ __align__(16) unsigned char smem[];
  Real *part = reinterpret_cast<Real *>(smem);
  __shared__ Real ys[MAXB];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = j * bs, ng = (k0 + FWD_GROUP - 1) / FWD_GROUP;
  Real *Lp = part + ((ng + nc - 1) / nc) * bs;
  if (q == 0) fetch_packed(row + k0, mp, Lp, bs);
  for (int g = q, s = 0; g < ng; g += nc, ++s) {
    const int c0 = g * FWD_GROUP, c1 = min(c0 + FWD_GROUP, k0);
    constexpr int NT = FWD_GROUP / 32;
    Real xv[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t)
      xv[t] = c0 + 32 * t + lane < c1 ? x[c0 + 32 * t + lane] : Real(0);
    for (int i = warp; i < bs; i += NWARPS) {
      const Real *ri = row + (size_t)i * mp + c0 + lane;
      Real v = 0;
#pragma unroll
      for (int t = 0; t < NT; ++t)
        if (c0 + 32 * t + lane < c1) v = v + ri[32 * t] * xv[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = v + __shfl_down_sync(FULL, v, off);
      if (lane == 0) part[s * bs + i] = v;
    }
  }
  cluster.sync();   // every partial written, visible to the cluster
  if (q == 0)
    for (int i = threadIdx.x; i < bs; i += THREADS) {
      Real v = 0;
      for (int g = 0; g < ng; ++g) {
        const Real p =
            cluster.map_shared_rank(part, g % nc)[(g / nc) * bs + i];
        v = g ? v + p : p;
      }
      ys[i] = bj[i] - v;
    }
  cluster.sync();   // the leader has read them: the others may leave
  if (q != 0) return;
  __pipeline_wait_prior(0);
  __syncthreads();
  fwd_diag(Lp, ys, bs);
  for (int i = threadIdx.x; i < bs; i += THREADS) xj[i] = ys[i];
}

template <typename Real>
__global__ void __launch_bounds__(THREADS)
panel_contrib_kernel(const Real *__restrict__ L3, const Real *__restrict__ x,
                     int bs, int mp, int nb_loc, int g0, int j,
                     Real *__restrict__ contrib) {
  extern __shared__ __align__(16) unsigned char smem[];
  Real *part = reinterpret_cast<Real *>(smem);   // [slot][32]
  __shared__ Real red[NWARPS][32];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y * 32 + lane;   // column of the block column
  // the local rows of natural blocks > j: t0 on, nrow of them
  const int r0 = max(j - g0 + 1, 0);
  const int t0 = r0 * bs, nrow = max(nb_loc - r0, 0) * bs;
  const int ng = (nrow + BWD_GROUP - 1) / BWD_GROUP;
  const Real *T = L3 + (size_t)t0 * mp + (size_t)j * bs + b;
  const Real *v = x + (size_t)(g0 + r0) * bs;
  for (int g = q, s = 0; g < ng; g += nc, ++s) {
    const int a0 = g * BWD_GROUP, a1 = min(a0 + BWD_GROUP, nrow);
    Real acc = 0;
    if (b < bs)
      for (int a = a0 + warp; a < a1; a += NWARPS)
        acc = acc + T[(size_t)a * mp] * v[a];
    red[warp][lane] = acc;
    __syncthreads();
    if (warp == 0) {
      Real t = red[0][lane];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) t = t + red[w][lane];
      part[s * 32 + lane] = t;
    }
    __syncthreads();
  }
  cluster.sync();
  if (q == 0 && warp == 0 && b < bs) {
    Real sum = 0;
    for (int g = 0; g < ng; ++g) {
      const Real p =
          cluster.map_shared_rank(part, g % nc)[(g / nc) * 32 + lane];
      sum = g ? sum + p : p;
    }
    contrib[b] = sum;
  }
  cluster.sync();
}

// (b) in f64, with 16-byte loads: a lane reads two neighbouring columns
// at once, so a warp covers 64 columns of a row; the rows, the warps' sums
// and the groups keep panel_contrib_kernel's order.  Needs L3 and the
// block column 16-byte aligned (mp and bs even).
__global__ void __launch_bounds__(THREADS)
panel_contrib_vec_kernel(const double *__restrict__ L3,
                         const double *__restrict__ x, int bs, int mp,
                         int nb_loc, int g0, int j,
                         double *__restrict__ contrib) {
  constexpr int VEC = 2, W = 32 * VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  double *part = reinterpret_cast<double *>(smem);   // [slot][W]
  __shared__ __align__(16) double red[NWARPS][W];
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * W + VEC * lane;   // this lane's first column
  const bool in = b0 < bs;
  const int r0 = max(j - g0 + 1, 0);
  const int t0 = r0 * bs, nrow = max(nb_loc - r0, 0) * bs;
  const int ng = (nrow + BWD_GROUP - 1) / BWD_GROUP;
  const double *T = L3 + (size_t)t0 * mp + (size_t)j * bs + b0;
  const double *v = x + (size_t)(g0 + r0) * bs;
  constexpr int RPW = BWD_GROUP / NWARPS;   // a warp's rows of a group
  for (int g = q, s = 0; g < ng; g += nc, ++s) {
    const int a0 = g * BWD_GROUP, a1 = min(a0 + BWD_GROUP, nrow);
    double acc[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = 0;
    if (in) {
      // every load of the warp's rows in flight, then the sums in order
      double2 t[RPW];
      double va[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int a = a0 + warp + NWARPS * i;
        if (a < a1) {
          t[i] = *reinterpret_cast<const double2 *>(T + (size_t)a * mp);
          va[i] = v[a];
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        if (a0 + warp + NWARPS * i < a1) {
          acc[0] = acc[0] + t[i].x * va[i];
          acc[1] = acc[1] + t[i].y * va[i];
        }
    }
#pragma unroll
    for (int u = 0; u < VEC; ++u) red[warp][VEC * lane + u] = acc[u];
    __syncthreads();
    for (int c = threadIdx.x; c < W; c += THREADS) {
      double t = red[0][c];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) t = t + red[w][c];
      part[s * W + c] = t;
    }
    __syncthreads();
  }
  cluster.sync();
  if (q == 0)
    for (int c = threadIdx.x; c < W; c += THREADS) {
      const int b = blockIdx.y * W + c;
      if (b >= bs) continue;
      double sum = 0;
      for (int g = 0; g < ng; ++g) {
        const double p =
            cluster.map_shared_rank(part, g % nc)[(g / nc) * W + c];
        sum = g ? sum + p : p;
      }
      contrib[b] = sum;
    }
  cluster.sync();
}

template <typename Real>
__global__ void __launch_bounds__(THREADS)
panel_bwd_solve_kernel(const Real *__restrict__ Ljj,
                       const Real *__restrict__ bj,
                       const Real *__restrict__ contrib, int bs,
                       Real *__restrict__ xj) {
  extern __shared__ __align__(16) unsigned char smem[];
  Real *Lp = reinterpret_cast<Real *>(smem);
  __shared__ Real zs[MAXB];
  fetch_packed(Ljj, bs, Lp, bs);
  for (int i = threadIdx.x; i < bs; i += THREADS) zs[i] = bj[i] - contrib[i];
  __pipeline_wait_prior(0);
  __syncthreads();
  bwd_diag(Lp, zs, bs);
  for (int i = threadIdx.x; i < bs; i += THREADS) xj[i] = zs[i];
}

// Launch a cluster of nc CTAs (of THREADS threads) along x.
template <typename... Exp, typename... Act>
int cluster_launch(void (*kernel)(Exp...), dim3 grid, int nc, size_t smem,
                   cudaStream_t stream, Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  return err ? err : (int)cudaGetLastError();
}

// The cluster size: ncta, or (ncta <= 0) one CTA a group up to
// MAX_CLUSTER; 0 when it is out of range.
int cluster_size(int ncta, int ng) {
  if (ncta <= 0) return std::min(MAX_CLUSTER, std::max(1, ng));
  return ncta <= MAX_CLUSTER ? ncta : 0;
}

template <typename Real>
int fwd_launch(const Real *row, const Real *x, const Real *bj, Real *xj,
               int bs, int mp, int j, int ncta, cudaStream_t stream) {
  static bool raised = false;
  if (bs < 1 || bs > MAXB || j < 0 || (j + 1) * bs > mp)
    return (int)cudaErrorInvalidValue;
  const int ng = (j * bs + FWD_GROUP - 1) / FWD_GROUP;
  const int nc = cluster_size(ncta, ng);
  if (!nc) return (int)cudaErrorInvalidValue;
  int err = raise_smem_once((const void *)panel_fwd_kernel<Real>, raised);
  if (err) return err;
  const size_t smem = sizeof(Real) * (((ng + nc - 1) / nc) * bs + tri(bs));
  return cluster_launch(panel_fwd_kernel<Real>, dim3(nc), nc, smem, stream,
                        row, x, bj, bs, mp, j, xj);
}

template <typename Real>
int contrib_launch(const Real *L3, const Real *x, Real *contrib, int bs,
                   int mp, int nb_loc, int g0, int j, int ncta,
                   cudaStream_t stream) {
  if (bs < 1 || bs > MAXB || nb_loc < 0 || (j + 1) * bs > mp)
    return (int)cudaErrorInvalidValue;
  const int nrow = std::max(nb_loc - std::max(j - g0 + 1, 0), 0) * bs;
  const int ng = (nrow + BWD_GROUP - 1) / BWD_GROUP;
  const int nc = cluster_size(ncta, ng);
  if (!nc) return (int)cudaErrorInvalidValue;
  const int slots = std::max((ng + nc - 1) / nc, 1);
  if constexpr (std::is_same<Real, double>::value) {
    if ((uintptr_t)L3 % 16 || mp % 2 || bs % 2)
      return (int)cudaErrorInvalidValue;
    return cluster_launch(panel_contrib_vec_kernel, dim3(nc, (bs + 63) / 64),
                          nc, sizeof(double) * slots * 64, stream, L3, x, bs,
                          mp, nb_loc, g0, j, contrib);
  } else {
    return cluster_launch(panel_contrib_kernel<Real>,
                          dim3(nc, (bs + 31) / 32), nc,
                          sizeof(Real) * slots * 32, stream, L3, x, bs, mp,
                          nb_loc, g0, j, contrib);
  }
}

template <typename Real>
int bwd_solve_launch(const Real *Ljj, const Real *bj, const Real *contrib,
                     Real *xj, int bs, cudaStream_t stream) {
  static bool raised = false;
  if (bs < 1 || bs > MAXB) return (int)cudaErrorInvalidValue;
  int err = raise_smem_once((const void *)panel_bwd_solve_kernel<Real>,
                            raised);
  if (err) return err;
  panel_bwd_solve_kernel<Real><<<1, THREADS, sizeof(Real) * tri(bs),
                                 stream>>>(Ljj, bj, contrib, bs, xj);
  return (int)cudaGetLastError();
}

}  // namespace

// row [bs, mp] (block row j of L), x [mp], bj [bs] -> xj [bs]; ncta: the
// cluster's size (<= 0: one CTA a column group, at most 8)
extern "C" int panel_fwd_step_launch(const double *row, const double *x,
                                     const double *bj, double *xj, int bs,
                                     int mp, int j, int ncta,
                                     cudaStream_t stream) {
  return fwd_launch(row, x, bj, xj, bs, mp, j, ncta, stream);
}

// L3 [nb_loc * bs, mp] (this rank's contiguous panel, first natural block
// g0; 16-byte aligned, mp and bs even), x [mp] -> contrib [bs]; ncta as
// above, per row group
extern "C" int panel_bwd_contrib_launch(const double *L3, const double *x,
                                        double *contrib, int bs, int mp,
                                        int nb_loc, int g0, int j, int ncta,
                                        cudaStream_t stream) {
  return contrib_launch(L3, x, contrib, bs, mp, nb_loc, g0, j, ncta, stream);
}

// Ljj [bs, bs], bj, contrib [bs] -> xj [bs]
extern "C" int panel_bwd_solve_launch(const double *Ljj, const double *bj,
                                      const double *contrib, double *xj,
                                      int bs, cudaStream_t stream) {
  return bwd_solve_launch(Ljj, bj, contrib, xj, bs, stream);
}

// The f32 builds (K15-f32, the f32 phase under a mesh): the same steps and
// the same order, with the arguments of the f64 entry points above.
extern "C" int panel_fwd_step_launch_f32(const float *row, const float *x,
                                         const float *bj, float *xj, int bs,
                                         int mp, int j, int ncta,
                                         cudaStream_t stream) {
  return fwd_launch(row, x, bj, xj, bs, mp, j, ncta, stream);
}

extern "C" int panel_bwd_contrib_launch_f32(const float *L3, const float *x,
                                            float *contrib, int bs, int mp,
                                            int nb_loc, int g0, int j,
                                            int ncta, cudaStream_t stream) {
  return contrib_launch(L3, x, contrib, bs, mp, nb_loc, g0, j, ncta, stream);
}

extern "C" int panel_bwd_solve_launch_f32(const float *Ljj, const float *bj,
                                          const float *contrib, float *xj,
                                          int bs, cudaStream_t stream) {
  return bwd_solve_launch(Ljj, bj, contrib, xj, bs, stream);
}
