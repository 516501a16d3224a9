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
// Two layouts, both reading row-major input with leading dimension ld:
//  * split_rows: one block per row, threads stride along the row.
//  * split_cols: one block per 32 columns, 8 row phases; reads coalesce
//    along the row.
// Each thread re-reads only the elements it wrote itself between rounds,
// so the only barriers are the block reductions.
//
// Bound on the card: memory.  It reads A once and writes three slices:
// 32 bytes per element (349 MB for control07's 667 x 16384 Gram operand,
// 0.10 ms at 3.35 TB/s), with ~10 flops per element.
//
// Build with --fmad=false: (R + sigma) - sigma must round twice.

#include <cuda_runtime.h>

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

}  // namespace

// axis = 1: scale per row; axis = 0: scale per column.  A is R x C
// row-major with leading dimension ld >= C; S0..S2 are R x C contiguous.
extern "C" int ozaki_split_launch(const double *A, long long ld, int R, int C,
                                  int axis, int t, double *S0, double *S1,
                                  double *S2, void *stream) {
  if (R > 0 && C > 0) {
    if (axis == 1) {
      split_rows<<<R, ROW_THREADS, 0, (cudaStream_t)stream>>>(A, ld, C, t,
                                                              S0, S1, S2);
    } else {
      const dim3 block(COL_TILE, COL_PHASES);
      const int grid = (C + COL_TILE - 1) / COL_TILE;
      split_cols<<<grid, block, 0, (cudaStream_t)stream>>>(A, ld, R, C, t,
                                                           S0, S1, S2);
    }
  }
  return (int)cudaGetLastError();
}
