// Double-double matrix-vector product y = (Ah + Al)(xh + xl)
// (ddlinalg.dd_gemv, kernel K6) and the whole dd triangular pair of
// ddlinalg.dd_chol_solve in one launch (kernel "K6 solve").
//
// Replaces the reference's sedumi_tpu/ddlinalg.py:130 dd_gemv, which runs
// an Ozaki dd_gemm on a one-column matrix on the host, and its
// dd_chol_solve (:210), which calls it panel by panel.  One warp owns one
// output y_i: each lane walks j = lane, lane + 32, ... in ascending order
// and forms
//   p + e = Ah_ij xh_j exactly (e = fma(a, b, -p)),
//   c     = Ah_ij xl_j + Al_ij xh_j      (in f64; Al xl is below eps^2),
// sums the p with TwoSum into (s, comp) and the e and c into lo; the 32
// lane partials merge by a TwoSum tree, and (s, comp + lo) is normalised.
// The order of summation differs from the Ozaki route's, the error bound
// does not: |y - y_exact| <= c eps^2 sum_j |A_ij| |x_j|, c = O(n) (the
// tests derive c).  tests/dd_emulation.py repeats this order step for
// step.
//
// Element (i, j) of A lives at A[i * si + j * sj], so dd_chol_solve's
// panels L[p0:p1, :p0] (si = ld, sj = 1), their transposes L[p1:, p0:p1]'
// (si = 1, sj = ld) and the transposed panel inverses run without a copy.
// Each lane loads U steps of A, Al and x ahead of its TwoSum chain, so U
// loads are in flight a lane instead of one.
//
// dd_chol_solve_kernel: one launch runs L y = b and then L' z = y, panel
// by panel, with today's arithmetic: per panel the product of its rows
// with the finished part of the solution, the dd_sub of that product
// from the right-hand side (dd_elem.cu's dd_add expression, negated), and
// the product of the panel's diagonal inverse with the difference.  Each
// product row is summed exactly as dd_gemv_kernel sums it, so z is bit
// for bit the composition of K6 and K5 launches
// (ddlinalg.dd_chol_solve_panels).  A thread-block cluster of 16 CTAs
// splits each panel's rows, a row a warp; each warp streams its row of
// the factor through its own ring of shared-memory stages by cp.async,
// ahead of its sums across the panels' barriers (the factor does not
// depend on the solution), and every CTA keeps the whole solution in its
// shared memory, filled by the rows' owners through distributed shared
// memory.  Two cluster barriers a panel each way replace 6P - 4
// launches.

// Bound on the card.  dd_gemv: memory, 16 bytes per matrix element (Ah
// and Al): 7.1 MB at m = 666 (2.1 us).  The solve: its bytes (the factor
// twice, forward and backward, h and l: 7.1 MB at m = 666) take 2.1 us at
// the card's memory rate; its ~14 f64 operations per element and pass
// (6.2 M at m = 666) 0.09 us at the card's f64 rate.  Latency sets its
// time: a chain of 4P dependent phases (56 at m = 666), each a row's
// steps, its shuffle tree, a dd_sub and a cluster barrier (PERF.md
// section 6).

// Build with --fmad=false: TwoSum and the cross terms must round as
// written.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int GEMV_UNROLL = 8;
// the fused solve: columns a chunk (two steps a lane), the widest panel
constexpr int CHUNK_COLS = 64;
constexpr int MAX_NB = 64;
// CTAs of the solve's cluster (the fastest of 2-16 at control07's and
// arch0's orders), a warp a row of a CTA's share of a panel, and each
// warp's ring of shared-memory stages
constexpr int SOLVE_CLUSTER = 16;
constexpr int MAX_ROWS = (MAX_NB + SOLVE_CLUSTER - 1) / SOLVE_CLUSTER;
constexpr int SOLVE_STAGES = 16;
// shared memory a CTA of the solve may take (of the card's 227 KB)
constexpr size_t SOLVE_SMEM = 220 * 1024;

__device__ __forceinline__ void two_sum(double a, double b, double &s,
                                        double &e) {
  s = a + b;
  const double v = s - a;
  e = (a - (s - v)) + (b - v);
}

// One lane's running sum of a product row.
struct Acc {
  double s, comp, lo;
};

__device__ __forceinline__ void acc_step(Acc &acc, double a, double al,
                                         double b, double bl) {
  const double p = a * b;
  const double e = fma(a, b, -p);
  double t, err;
  two_sum(acc.s, p, t, err);
  acc.s = t;
  acc.comp += err;
  acc.lo += e + (a * bl + al * b);
}

// The lanes' partials into lane 0's, by the shuffle tree; then (h, l).
__device__ __forceinline__ void acc_finish(Acc &acc, double &h, double &l) {
  for (int off = 16; off > 0; off >>= 1) {
    const double s2 = __shfl_down_sync(0xffffffffu, acc.s, off);
    const double c2 = __shfl_down_sync(0xffffffffu, acc.comp, off);
    const double l2 = __shfl_down_sync(0xffffffffu, acc.lo, off);
    double t, err;
    two_sum(acc.s, s2, t, err);
    acc.s = t;
    acc.comp = (acc.comp + c2) + err;
    acc.lo += l2;
  }
  two_sum(acc.s, acc.comp + acc.lo, h, l);
}

__global__ void dd_gemv_kernel(const double *__restrict__ Ah,
                               const double *__restrict__ Al, long long si,
                               long long sj, const double *__restrict__ xh,
                               const double *__restrict__ xl, int m, int n,
                               double *__restrict__ yh,
                               double *__restrict__ yl) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;  // the whole warp leaves together
  const double *ah = Ah + row * si, *al = Al + row * si;
  Acc acc{0.0, 0.0, 0.0};
  // lane's j = lane mod 32 ascending; GEMV_UNROLL steps of loads ahead of
  // the chain
  for (int j0 = lane; j0 < n; j0 += 32 * GEMV_UNROLL) {
    double a[GEMV_UNROLL], a2[GEMV_UNROLL], b[GEMV_UNROLL], b2[GEMV_UNROLL];
#pragma unroll
    for (int u = 0; u < GEMV_UNROLL; ++u) {
      const int j = j0 + 32 * u;
      if (j < n) {
        a[u] = ah[j * sj];
        a2[u] = al[j * sj];
        b[u] = xh[j];
        b2[u] = xl[j];
      }
    }
#pragma unroll
    for (int u = 0; u < GEMV_UNROLL; ++u)
      if (j0 + 32 * u < n) acc_step(acc, a[u], a2[u], b[u], b2[u]);
  }
  double h, l;
  acc_finish(acc, h, l);
  if (lane == 0) {
    yh[row] = h;
    yl[row] = l;
  }
}

// (ah + al) - (bh + bl), dd_elem.cu's add_kernel with negate_b
__device__ __forceinline__ void dd_sub(double ah, double al, double bh,
                                       double bl, double &h, double &l) {
  double sh, se;
  two_sum(ah, -bh, sh, se);
  two_sum(sh, (se + al) + -bl, h, l);
}

// ------------------------------------------------------- the fused solve

__device__ __forceinline__ void cp_async8(void *smem, const void *gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The solve's fixed sequence of matrix pieces: per direction (forward,
// then backward) and panel (ascending, then descending), the strip of
// the panel's product (forward L[p0:p1, :p0], backward L[p1:, p0:p1]', in
// chunks of CHUNK_COLS columns j) when it is not empty, then the panel's
// diagonal inverse (one chunk: w <= MAX_NB = CHUNK_COLS).  Element (i, j) of a
// piece is at base[i * si + j * sj].  Every CTA walks the same sequence,
// for its own rows of each panel.
struct Piece {
  int dir, k, inv, col0;  // dir 0 forward, 1 backward; inv: the inverse
  bool done;
};

struct SolveShape {
  const double *Lh, *Ll, *Ih, *Il;
  long long ld;
  int m, nb, npan;

  __device__ int p0(int k) const { return k * nb; }
  __device__ int width(int k) const {
    return m - k * nb < nb ? m - k * nb : nb;
  }
  // columns of piece's matrix (the strip's n, or w)
  __device__ int cols(const Piece &q) const {
    const int w = width(q.k);
    if (q.inv) return w;
    return q.dir == 0 ? p0(q.k) : m - p0(q.k) - w;
  }
  __device__ Piece first() const { return start(0, 0); }
  __device__ Piece start(int dir, int k) const {
    Piece q{dir, k, 0, 0, false};
    if (cols(q) == 0) q.inv = 1;
    return q;
  }
  __device__ Piece next(Piece q) const {
    if (!q.inv) {
      q.col0 += CHUNK_COLS;
      if (q.col0 >= cols(q)) {
        q.inv = 1;
        q.col0 = 0;
      }
      return q;
    }
    if (q.dir == 0)
      return q.k + 1 < npan ? start(0, q.k + 1) : start(1, npan - 1);
    if (q.k > 0) return start(1, q.k - 1);
    q.done = true;
    return q;
  }
  // base and strides of the piece's matrix, h or l
  __device__ const double *base(const Piece &q, bool lo, long long &si,
                                long long &sj) const {
    const int a = p0(q.k), w = width(q.k);
    const long long nn = (long long)nb * nb;
    if (q.inv) {
      si = q.dir == 0 ? nb : 1;
      sj = q.dir == 0 ? 1 : nb;
      return (lo ? Il : Ih) + q.k * nn;
    }
    si = q.dir == 0 ? ld : 1;
    sj = q.dir == 0 ? 1 : ld;
    return (lo ? Ll : Lh) + (q.dir == 0 ? a * ld : (a + w) * ld + a);
  }
};

// rows [lo, hi) of a w-row panel belong to CTA `rank` of the cluster
__device__ __forceinline__ int row_lo(int w, int rank) {
  return rank * w / SOLVE_CLUSTER;
}

// One warp's copies of its row `row` of a piece's chunk (up to
// CHUNK_COLS columns) into its stage [2][CHUNK_COLS] (h, then l): lane l
// copies columns l and l + 32, so a forward piece's row is read
// coalesced (a backward piece's, a column of L, a double a row of L).
__device__ __forceinline__ void load_chunk(const SolveShape &sh,
                                           const Piece &q, int row,
                                           double *stage, int lane) {
  const int nc0 = sh.cols(q) - q.col0;
  const int nc = nc0 < CHUNK_COLS ? nc0 : CHUNK_COLS;
  long long si, sj;
  const double *bh = sh.base(q, false, si, sj);
  const double *bl = sh.base(q, true, si, sj);
  const long long off = row * si + q.col0 * sj;
#pragma unroll
  for (int u = 0; u < CHUNK_COLS / 32; ++u) {
    const int jj = lane + 32 * u;
    if (jj < nc) {
      cp_async8(stage + jj, bh + off + jj * sj);
      cp_async8(stage + CHUNK_COLS + jj, bl + off + jj * sj);
    }
  }
}

// lane c < 16 stores v at offset i of CTA c's copy of array a
__device__ __forceinline__ void broadcast(cg::cluster_group &cluster,
                                          double *a, int i, double v,
                                          int lane) {
  if (lane < SOLVE_CLUSTER) cluster.map_shared_rank(a, lane)[i] = v;
}

// L L' z = b by a cluster of C = 16 CTAs: CTA c owns rows [c w / C,
// (c+1) w / C) of every panel, a row a warp (a row's chain of steps, its
// shuffle tree and its dd_sub are the latency each phase pays, so a warp
// with two rows pays two).  Each warp streams its row of the solve's
// pieces through its own ring of S = 16 shared-memory stages by
// cp.async, S - 1 chunks ahead of its sums (the factor does not depend on
// the solution, so the loads run ahead across the panels' barriers), and
// waits for them alone (no block barrier per chunk).  Every CTA keeps the
// whole solution y, z (h and l) in its shared memory: the owner of a
// solution row stores it into every CTA's copy (distributed shared
// memory), so the sums read x_j locally.  Per panel: the strip's sums, r
// = rhs - sum, stored into every CTA's r; a cluster barrier; the
// inverse's sums over r, the panel's solution rows stored everywhere
// (and z to device memory); a cluster barrier.  A panel with no strip
// takes r = rhs, which every CTA has.  No CTA stores into another's
// shared memory before every CTA of the cluster has started (the
// entry's cluster barrier, whose wait comes after the rings' first
// loads are issued), and none leaves before the others' last stores into
// it (the last panel's barrier).
__global__ void __launch_bounds__(32 * MAX_ROWS)
    dd_chol_solve_kernel(SolveShape sh, const double *__restrict__ bh,
                         const double *__restrict__ bl, double *zh,
                         double *zl) {
  constexpr int S = SOLVE_STAGES;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  extern __shared__ __align__(16) double smem[];
  const int m = sh.m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int stage_len = 2 * CHUNK_COLS;
  double *ring = smem + warp * S * stage_len;
  double *ys = smem + nwarps * S * stage_len;  // y h, y l, z h, z l
  double *yls = ys + m, *zs = yls + m, *zls = zs + m;
  double *rh = zls + m, *rl = rh + MAX_NB;

  // this warp's row of q's panel, if the CTA's share has one
  auto row_of = [&](const Piece &q, int &row) {
    const int w = sh.width(q.k);
    row = row_lo(w, rank) + warp;
    return !q.done && row < row_lo(w, rank + 1);
  };
  Piece ahead = sh.first();
#pragma unroll 1
  for (int s = 0; s < S - 1; ++s) {
    int row;
    if (row_of(ahead, row))
      load_chunk(sh, ahead, row, ring + s * stage_len, lane);
    cp_commit();
    ahead = sh.next(ahead);
  }
  // every CTA has started: its shared memory may be stored into
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  Acc acc{0.0, 0.0, 0.0};
  double vh = 0.0, vl = 0.0;
  int slot = 0;
  for (Piece q = sh.first(); !q.done; q = sh.next(q)) {
    const int a = sh.p0(q.k), w = sh.width(q.k);
    int row;
    const bool mine = row_of(q, row);
    const bool fwd = q.dir == 0;
    if (q.inv && sh.cols(Piece{q.dir, q.k, 0, 0, false}) == 0) {
      // no strip: r = rhs (b forward, y backward), every row, in every CTA
      for (int i = threadIdx.x; i < w; i += blockDim.x) {
        rh[i] = fwd ? bh[a + i] : ys[a + i];
        rl[i] = fwd ? (bl ? bl[a + i] : 0.0) : yls[a + i];
      }
      __syncthreads();
    }
    // chunk q has landed in this warp's copies; its stage slot - 1 is
    // free
    cp_wait<S - 2>();
    __syncwarp();
    {
      int r;
      if (row_of(ahead, r))
        load_chunk(sh, ahead, r, ring + ((slot + S - 1) % S) * stage_len,
                   lane);
      cp_commit();
      ahead = sh.next(ahead);
    }
    const double *th = ring + slot * stage_len, *tl = th + CHUNK_COLS;
    slot = slot + 1 == S ? 0 : slot + 1;
    const int n = sh.cols(q);
    if (q.col0 == 0) {
      acc = Acc{0.0, 0.0, 0.0};
      // a strip's right-hand side, loaded ahead of its finish
      const int i = a + (mine ? row : 0);
      vh = fwd ? bh[i] : ys[i];
      vl = fwd ? (bl ? bl[i] : 0.0) : yls[i];
    }
    if (mine) {
      // x_j: the solution (forward y[j], backward z[p1 + j]) or r
      const double *xh = q.inv ? rh : (fwd ? ys : zs + a + w);
      const double *xl = q.inv ? rl : (fwd ? yls : zls + a + w);
      double b[CHUNK_COLS / 32], b2[CHUNK_COLS / 32];
      double t[CHUNK_COLS / 32], t2[CHUNK_COLS / 32];
#pragma unroll
      for (int u = 0; u < CHUNK_COLS / 32; ++u) {
        const int jj = lane + 32 * u, j = q.col0 + jj;
        if (j < n) {
          b[u] = xh[j];
          b2[u] = xl[j];
          t[u] = th[jj];
          t2[u] = tl[jj];
        }
      }
#pragma unroll
      for (int u = 0; u < CHUNK_COLS / 32; ++u)
        if (q.col0 + lane + 32 * u < n)
          acc_step(acc, t[u], t2[u], b[u], b2[u]);
    }
    if (!q.inv && q.col0 + CHUNK_COLS < n) continue;
    if (mine) {
      double h, l;
      acc_finish(acc, h, l);
      h = __shfl_sync(0xffffffffu, h, 0);
      l = __shfl_sync(0xffffffffu, l, 0);
      if (q.inv) {
        broadcast(cluster, fwd ? ys : zs, a + row, h, lane);
        broadcast(cluster, fwd ? yls : zls, a + row, l, lane);
        if (!fwd && lane == 0) {
          zh[a + row] = h;
          zl[a + row] = l;
        }
      } else {
        double dh, dl;
        dd_sub(vh, vl, h, l, dh, dl);
        broadcast(cluster, rh, row, dh, lane);
        broadcast(cluster, rl, row, dl, lane);
      }
    }
    // r, or the panel's solution rows, complete in every CTA
    cluster.sync();
  }
  cp_wait<0>();
}

// a warp a row of the CTA's share of a panel (R rows at most)
size_t solve_smem(int R, int m) {
  return ((size_t)R * SOLVE_STAGES * 2 * CHUNK_COLS + 4 * (size_t)m
          + 2 * MAX_NB) * sizeof(double);
}

// The kernel's attributes, set once: the most dynamic shared memory a
// solve may take, and a cluster of 16 (beyond the portable 8).
int set_attributes_once() {
  static bool done = false;
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      dd_chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SOLVE_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dd_chol_solve_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = err == cudaSuccess;
  return (int)err;
}

int launch_solve(const SolveShape &sh, const double *bh, const double *bl,
                 double *zh, double *zl, cudaStream_t stream) {
  const int R = (sh.nb + SOLVE_CLUSTER - 1) / SOLVE_CLUSTER;
  const size_t smem = solve_smem(R, sh.m);
  int e = set_attributes_once();
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)SOLVE_CLUSTER);
  cfg.blockDim = dim3(32 * R);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)SOLVE_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster that cannot be resident is refused, never run otherwise;
  // residency holds for less shared memory than a size once checked, so
  // each R keeps the largest size that passed
  static size_t resident[MAX_ROWS + 1] = {};
  if (smem > resident[R]) {
    int active = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveClusters(
        &active, (const void *)dd_chol_solve_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (active < 1) return (int)cudaErrorInvalidConfiguration;
    resident[R] = smem;
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, dd_chol_solve_kernel, sh, bh,
                                       bl, zh, zl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dd_gemv_launch(const double *Ah, const double *Al,
                              long long si, long long sj, const double *xh,
                              const double *xl, int m, int n, double *yh,
                              double *yl, void *stream) {
  const int rows_per_block = THREADS / 32;
  const int blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks > 0)
    dd_gemv_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        Ah, Al, si, sj, xh, xl, m, n, yh, yl);
  return (int)cudaGetLastError();
}

// a cluster of 16 CTAs, 16 stages a warp; an order whose solution
// copies do not fit SOLVE_SMEM beside the rings (m > 5472 at nb = 48) is
// refused
extern "C" int dd_chol_solve_launch(const double *Lh, const double *Ll,
                                    long long ld, const double *Ih,
                                    const double *Il, const double *bh,
                                    const double *bl, int m, int nb,
                                    double *zh, double *zl, void *stream) {
  if (m < 1 || nb < 1 || nb > MAX_NB || ld < m)
    return (int)cudaErrorInvalidValue;
  const int R = (nb + SOLVE_CLUSTER - 1) / SOLVE_CLUSTER;
  if (solve_smem(R, m) > SOLVE_SMEM) return (int)cudaErrorInvalidValue;
  const SolveShape sh{Lh, Ll, Ih, Il, ld, m, nb, (m + nb - 1) / nb};
  return launch_solve(sh, bh, bl, zh, zl, (cudaStream_t)stream);
}
