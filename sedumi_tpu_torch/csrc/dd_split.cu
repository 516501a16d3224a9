// Ozaki error-free split of an f64 matrix into three slices
// (ddlinalg._ozaki_split).
//
// Replaces the reference's sedumi_tpu/ddlinalg.py:86 _ozaki_split, numpy
// on the host: for each line (a row for axis = -1, a column for axis = 0)
// two rounds of
//   mu    = max |R|                    over the line
//   sigma = 2^(ceil(log2 mu) + 53 - t)  (mu <= 0 or non-finite: 2^(53 - t))
//   S     = (R + sigma) - sigma,   R <- R - S
// give slices S0, S1 of t bits each relative to the line's scale, and the
// remainder S2 = R.  With t = floor((53 - ceil(log2 k)) / 2) every slice
// product S_i S_j' summed over k terms is exact in f64, so a dd GEMM is
// nine exact cuBLAS DGEMMs plus two cross terms (ddlinalg.dd_gemm).
//
// ceil(log2 mu) comes from frexp: mu = f 2^e with f in [0.5, 1), so it is
// e, or e - 1 when f == 0.5 (mu a power of two).  A log2 that is one ulp
// off at a power of two would double sigma and break the slices'
// exactness; frexp is exact.  sigma = ldexp(1, .) is exact.  The max is
// order-independent and a NaN in a line makes mu non-finite (numpy's max
// propagates it), so the slices match the plain version bit for bit.
//
// Bound on the card: memory.  It reads A once and writes three slices:
// 32 bytes per element (349 MB for control07's 667 x 16384 Gram operand,
// 0.104 ms at 3.35 TB/s), with ~10 flops per element.  So a line is read
// once, kept on the chip between the two rounds, and each slice written
// once:
//  * split_warp (lines of at most 1024 elements: the congruence's A_k and
//    T', dd_chol's trailing panels, R_k' rows): one warp per line, the
//    line in registers, both maxima by shuffles, no block barrier.
//  * split_cluster (1024 < C <= 65536: the Gram's operand): a cluster of
//    up to 8 CTAs of 256 threads per line, 8 pairs a thread (16 beyond
//    32768 elements), the line in registers, each round's maximum over
//    the cluster read by one warp through distributed shared memory (a
//    NaN counts as +inf in the max: sigma_of treats both alike).
//  * split_rows: one block per row, A read twice and S1 re-read (the
//    first design), kept for lines beyond the registers and for fewer
//    than 128 short lines, where a block's threads end a line sooner.
//  * split_cols (axis = 0 on a row-major matrix, launch-bound): one block
//    per 32 columns, 8 row phases; reads coalesce along the row.
// The row kernels read 16-byte pairs: a row off the 16-byte boundary
// peels its first element (head) and an odd remainder its last (tail);
// the slices' stores are pairs where their own address is aligned.
//
// Build with --fmad=false: (R + sigma) - sigma must round twice.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ROW_THREADS = 256;
constexpr int COL_TILE = 32;
constexpr int COL_PHASES = 8;

__device__ __forceinline__ double sigma_of(double mu, int nan, int t) {
  int expo = 0;
  if (!nan && mu > 0.0 && isfinite(mu)) {
    int e;
    const double f = frexp(mu, &e);
    expo = (f == 0.5) ? e - 1 : e;
  }
  return ldexp(1.0, expo + 53 - t);
}

// block-wide max of |x| and NaN flag over ROW_THREADS threads
__device__ __forceinline__ void block_max(double &mx, int &nan, double *s_mx,
                                          int *s_nan) {
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmax(mx, __shfl_down_sync(0xffffffffu, mx, off));
    nan |= __shfl_down_sync(0xffffffffu, nan, off);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    s_mx[wid] = mx;
    s_nan[wid] = nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double m = 0.0;
    int n = 0;
    for (int w = 0; w < ROW_THREADS / 32; ++w) {
      m = fmax(m, s_mx[w]);
      n |= s_nan[w];
    }
    s_mx[0] = m;
    s_nan[0] = n;
  }
  __syncthreads();
  mx = s_mx[0];
  nan = s_nan[0];
  __syncthreads();  // s_mx is reused by the next round
}

__global__ void split_rows(const double *__restrict__ A, long long ld, int C,
                           int t, double *__restrict__ S0,
                           double *__restrict__ S1, double *__restrict__ S2) {
  __shared__ double s_mx[ROW_THREADS / 32];
  __shared__ int s_nan[ROW_THREADS / 32];
  const long long row = blockIdx.x;
  const double *a = A + row * ld;
  const long long o = row * C;
  // round 1: S0 = top slice, S1 holds the remainder R1 for now
  double mx = 0.0;
  int nan = 0;
  for (int j = threadIdx.x; j < C; j += ROW_THREADS) {
    const double x = a[j];
    if (x != x) nan = 1;
    mx = fmax(mx, fabs(x));
  }
  block_max(mx, nan, s_mx, s_nan);
  double sigma = sigma_of(mx, nan, t);
  for (int j = threadIdx.x; j < C; j += ROW_THREADS) {
    const double r = a[j];
    const double s = (r + sigma) - sigma;
    S0[o + j] = s;
    S1[o + j] = r - s;
  }
  // round 2 on R1
  mx = 0.0;
  nan = 0;
  for (int j = threadIdx.x; j < C; j += ROW_THREADS) {
    const double x = S1[o + j];
    if (x != x) nan = 1;
    mx = fmax(mx, fabs(x));
  }
  block_max(mx, nan, s_mx, s_nan);
  sigma = sigma_of(mx, nan, t);
  for (int j = threadIdx.x; j < C; j += ROW_THREADS) {
    const double r = S1[o + j];
    const double s = (r + sigma) - sigma;
    S1[o + j] = s;
    S2[o + j] = r - s;
  }
}

// column max over COL_PHASES row phases of one tile of COL_TILE columns
__device__ __forceinline__ void tile_max(double &mx, int &nan,
                                         double (*s_mx)[COL_TILE],
                                         int (*s_nan)[COL_TILE]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  s_mx[ty][tx] = mx;
  s_nan[ty][tx] = nan;
  __syncthreads();
  double m = 0.0;
  int n = 0;
  for (int p = 0; p < COL_PHASES; ++p) {
    m = fmax(m, s_mx[p][tx]);
    n |= s_nan[p][tx];
  }
  mx = m;
  nan = n;
  __syncthreads();  // the arrays are reused by the next round
}

__global__ void split_cols(const double *__restrict__ A, long long ld, int R,
                           int C, int t, double *__restrict__ S0,
                           double *__restrict__ S1, double *__restrict__ S2) {
  __shared__ double s_mx[COL_PHASES][COL_TILE];
  __shared__ int s_nan[COL_PHASES][COL_TILE];
  const int col = blockIdx.x * COL_TILE + threadIdx.x;
  const bool live = col < C;
  double mx = 0.0;
  int nan = 0;
  if (live)
    for (long long i = threadIdx.y; i < R; i += COL_PHASES) {
      const double x = A[i * ld + col];
      if (x != x) nan = 1;
      mx = fmax(mx, fabs(x));
    }
  tile_max(mx, nan, s_mx, s_nan);
  double sigma = sigma_of(mx, nan, t);
  if (live)
    for (long long i = threadIdx.y; i < R; i += COL_PHASES) {
      const double r = A[i * ld + col];
      const double s = (r + sigma) - sigma;
      S0[i * C + col] = s;
      S1[i * C + col] = r - s;
    }
  mx = 0.0;
  nan = 0;
  if (live)
    for (long long i = threadIdx.y; i < R; i += COL_PHASES) {
      const double x = S1[i * C + col];
      if (x != x) nan = 1;
      mx = fmax(mx, fabs(x));
    }
  tile_max(mx, nan, s_mx, s_nan);
  sigma = sigma_of(mx, nan, t);
  if (live)
    for (long long i = threadIdx.y; i < R; i += COL_PHASES) {
      const double r = S1[i * C + col];
      const double s = (r + sigma) - sigma;
      S1[i * C + col] = s;
      S2[i * C + col] = r - s;
    }
}

// |x|, with a NaN as +inf: a line's maximum is then non-finite exactly when
// the line holds a NaN or an inf, and sigma_of treats both alike
__device__ __forceinline__ void upd(double x, double &mx) {
  mx = fmax(mx, x != x ? INFINITY : fabs(x));
}

__device__ __forceinline__ double warp_max(double mx) {
  for (int off = 16; off > 0; off >>= 1)
    mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  return mx;
}

// one round on a held element: S = (r + sigma) - sigma, r <- r - S
__device__ __forceinline__ double cut(double &r, double sigma) {
  const double s = (r + sigma) - sigma;
  r = r - s;
  return s;
}

// a line of C elements at a: head h (0 or 1: a off the 16-byte boundary),
// np 16-byte pairs from a + h, tail tl (0 or 1) at C - 1
struct Line {
  int h, np, tl;
  __device__ Line(const double *a, int C) {
    h = min((int)((reinterpret_cast<uintptr_t>(a) >> 3) & 1), C);
    np = (C - h) >> 1;
    tl = (C - h) & 1;
  }
};

__device__ __forceinline__ void store2(double *p, bool vec, double x,
                                       double y) {
  if (vec) {
    *reinterpret_cast<double2 *>(p) = make_double2(x, y);
  } else {
    p[0] = x;
    p[1] = y;
  }
}

// The per-thread part of a line: pairs k = first + stride * s (s < S), the
// head and tail by the thread with `edge` set.  Cuts one round on every
// held element and stores the slice into `out` (row base), the remainder
// kept in place.
template <int S>
struct Held {
  double2 v[S];
  double hv, tv;
  __device__ void load(const double *a, const Line &ln, int first,
                       int stride, bool edge) {
    const double2 *a2 = reinterpret_cast<const double2 *>(a + ln.h);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = first + stride * s;
      v[s] = k < ln.np ? a2[k] : make_double2(0.0, 0.0);
    }
    hv = (edge && ln.h) ? a[0] : 0.0;
    tv = (edge && ln.tl) ? a[ln.h + 2 * ln.np] : 0.0;
  }
  __device__ double max(const Line &ln, int first, int stride,
                        bool edge) const {
    double mx = 0.0;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (first + stride * s < ln.np) {
        upd(v[s].x, mx);
        upd(v[s].y, mx);
      }
    if (edge && ln.h) upd(hv, mx);
    if (edge && ln.tl) upd(tv, mx);
    return mx;
  }
  __device__ void cut_store(double *out, const Line &ln, int first,
                            int stride, bool edge, double sigma) {
    const bool vec = ((reinterpret_cast<uintptr_t>(out + ln.h) & 15) == 0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = first + stride * s;
      if (k < ln.np) {
        const double x = cut(v[s].x, sigma), y = cut(v[s].y, sigma);
        store2(out + ln.h + 2 * k, vec, x, y);
      }
    }
    if (edge && ln.h) out[0] = cut(hv, sigma);
    if (edge && ln.tl) out[ln.h + 2 * ln.np] = cut(tv, sigma);
  }
  __device__ void store(double *out, const Line &ln, int first, int stride,
                        bool edge) const {
    const bool vec = ((reinterpret_cast<uintptr_t>(out + ln.h) & 15) == 0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = first + stride * s;
      if (k < ln.np) store2(out + ln.h + 2 * k, vec, v[s].x, v[s].y);
    }
    if (edge && ln.h) out[0] = hv;
    if (edge && ln.tl) out[ln.h + 2 * ln.np] = tv;
  }
};

constexpr int WARP_LINES = 8;   // at most, warps (lines) per block

// one warp per line of C <= 64 S + 1 elements
template <int S>
__global__ void __launch_bounds__(32 * WARP_LINES)
    split_warp(const double *__restrict__ A, long long ld, int R, int C,
               int t, double *__restrict__ S0, double *__restrict__ S1,
               double *__restrict__ S2) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp
  const double *a = A + row * ld;
  const Line ln(a, C);
  const long long o = row * C;
  const bool edge = lane == 0;
  Held<S> h;
  h.load(a, ln, lane, 32, edge);
  h.cut_store(S0 + o, ln, lane, 32, edge,
              sigma_of(warp_max(h.max(ln, lane, 32, edge)), 0, t));
  h.cut_store(S1 + o, ln, lane, 32, edge,
              sigma_of(warp_max(h.max(ln, lane, 32, edge)), 0, t));
  h.store(S2 + o, ln, lane, 32, edge);
}

constexpr int CL_THREADS = 256;  // at most, threads per CTA

// the maximum over the cluster's CTAs of a round (slot: the round, so no
// buffer is rewritten while a peer may read it): the warps' maxima, the
// CTA's by warp 0, the peers' read by warp 0's first lanes
__device__ __forceinline__ double cluster_max(double mx, int slot,
                                              double (*w_mx)[CL_THREADS / 32],
                                              double *c_mx, double *all) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  mx = warp_max(mx);
  if (lane == 0) w_mx[slot][wid] = mx;
  __syncthreads();
  if (wid == 0) {
    mx = lane < (int)(blockDim.x >> 5) ? w_mx[slot][lane] : 0.0;
    mx = warp_max(mx);
    if (lane == 0) c_mx[slot] = mx;
  }
  cl.sync();  // every CTA's c_mx[slot] is written
  if (wid == 0) {
    mx = lane < (int)cl.num_blocks() ? *cl.map_shared_rank(&c_mx[slot], lane)
                                     : 0.0;
    mx = warp_max(mx);
    if (lane == 0) all[slot] = mx;
  }
  __syncthreads();
  return all[slot];
}

// a cluster of CTAs per row; the row's pairs k go to the cluster's threads
// in turn (k = rank * blockDim + tid + nc * blockDim * s)
template <int S>
__global__ void __launch_bounds__(CL_THREADS)
    split_cluster(const double *__restrict__ A, long long ld, int C, int t,
                  double *__restrict__ S0, double *__restrict__ S1,
                  double *__restrict__ S2) {
  namespace cg = cooperative_groups;
  __shared__ double w_mx[2][CL_THREADS / 32];
  __shared__ double c_mx[2], all[2];
  cg::cluster_group cl = cg::this_cluster();
  const int nc = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const long long row = blockIdx.x / nc;
  const double *a = A + row * ld;
  const Line ln(a, C);
  const long long o = row * C;
  const int first = rank * blockDim.x + threadIdx.x;
  const int stride = nc * blockDim.x;
  const bool edge = first == 0;
  Held<S> h;
  h.load(a, ln, first, stride, edge);
  double mx = cluster_max(h.max(ln, first, stride, edge), 0, w_mx, c_mx,
                          all);
  h.cut_store(S0 + o, ln, first, stride, edge, sigma_of(mx, 0, t));
  mx = cluster_max(h.max(ln, first, stride, edge), 1, w_mx, c_mx, all);
  h.cut_store(S1 + o, ln, first, stride, edge, sigma_of(mx, 0, t));
  h.store(S2 + o, ln, first, stride, edge);
  cl.sync();  // no CTA leaves while another reads its shared memory
}

template <int S>
int launch_warp(const double *A, long long ld, int R, int C, int t,
                double *S0, double *S1, double *S2, int lines,
                cudaStream_t st) {
  const int grid = (R + lines - 1) / lines;
  split_warp<S><<<grid, 32 * lines, 0, st>>>(A, ld, R, C, t, S0, S1, S2);
  return (int)cudaGetLastError();
}

template <int S>
int launch_cluster(const double *A, long long ld, int R, int C, int t,
                   double *S0, double *S1, double *S2, int nc, int threads,
                   cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)R * nc);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, split_cluster<S>, A, ld, C, t, S0, S1, S2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// pairs a thread holds in split_cluster, and the CTAs per line; below
// WARP_MIN_ROWS short lines take a block each (split_rows: fewer lines than
// SMs, where a block's threads finish a line sooner than a warp)
constexpr int CL_PAIRS = 8;
constexpr int CL_MAX = 8;
constexpr int WARP_MIN_ROWS = 128;

}  // namespace

// axis = 1: scale per row; axis = 0: scale per column.  A is R x C
// row-major with leading dimension ld >= C; S0..S2 are R x C contiguous.
extern "C" int ozaki_split_launch(const double *A, long long ld, int R, int C,
                                  int axis, int t, double *S0, double *S1,
                                  double *S2, void *stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (R <= 0 || C <= 0) return (int)cudaGetLastError();
  if (axis == 0) {
    const dim3 block(COL_TILE, COL_PHASES);
    const int grid = (C + COL_TILE - 1) / COL_TILE;
    split_cols<<<grid, block, 0, st>>>(A, ld, R, C, t, S0, S1, S2);
    return (int)cudaGetLastError();
  }
  // a line holds at most C / 2 pairs
  const int np = C / 2;
  if (np <= 32 * 16 && R < WARP_MIN_ROWS) {  // launch-bound: a block a row
    split_rows<<<R, ROW_THREADS, 0, st>>>(A, ld, C, t, S0, S1, S2);
    return (int)cudaGetLastError();
  }
  if (np <= 32 * 16) {
    // lines per block: fewer for few lines, so they spread over the SMs
    const int lines = max(1, min(WARP_LINES, R / 264));
    if (np <= 32 * 1)
      return launch_warp<1>(A, ld, R, C, t, S0, S1, S2, lines, st);
    if (np <= 32 * 2)
      return launch_warp<2>(A, ld, R, C, t, S0, S1, S2, lines, st);
    if (np <= 32 * 4)
      return launch_warp<4>(A, ld, R, C, t, S0, S1, S2, lines, st);
    if (np <= 32 * 8)
      return launch_warp<8>(A, ld, R, C, t, S0, S1, S2, lines, st);
    return launch_warp<16>(A, ld, R, C, t, S0, S1, S2, lines, st);
  }
  const int per_cta = CL_THREADS * CL_PAIRS;
  const int nc = (np + per_cta - 1) / per_cta;
  if (nc <= CL_MAX)
    return launch_cluster<CL_PAIRS>(A, ld, R, C, t, S0, S1, S2, nc,
                                    CL_THREADS, st);
  if (nc <= 2 * CL_MAX)  // twice the pairs a thread, up to 65536 elements
    return launch_cluster<2 * CL_PAIRS>(A, ld, R, C, t, S0, S1, S2,
                                        (nc + 1) / 2, CL_THREADS, st);
  split_rows<<<R, ROW_THREADS, 0, st>>>(A, ld, C, t, S0, S1, S2);
  return (int)cudaGetLastError();
}
