// Masked LDL' with SeDuMi's pivot add/skip semantics (chol.ldl_masked).
//
// Replaces the reference's sedumi_tpu/chol.py:95 ldl_masked, a
// lax.fori_loop over columns with masked arithmetic (blkchol2.c
// semantics).  Column j:
//   lb   = canceltol * absd_j + abstol
//   d_j  = lb if a_jj < lb (cancellation add, diagadd_j = lb - a_jj)
//   col  = A[j+1:, j] / d_j
//   skip = skip_pivots && max|col| > maxu   -> col = 0, d_j = inf
//   A[r, c] -= d_j * (col_r * col_c)  (r, c > j),  absd_r += d_j col_r^2
// One persistent block walks the columns in order with __syncthreads()
// between phases; the working matrix lives in device memory (m <= ~1000,
// so it stays in L2).  Every entry's update depends only on itself and the
// column, so only the lower triangle (c <= r) is updated: the entries the
// algorithm reads are bit-identical to the full update's.  The arithmetic
// (one division, the product association d_j * (col_r * col_c), no fused
// multiply-add under --fmad=false) matches the plain version, so the skip
// and add masks agree bit for bit.  max|col| propagates NaN like jnp.max:
// a NaN in the column means no skip.
//
// The f64 build is K3; the f32 build, K3-f32, is the f32 phase's fallback
// (reference ipm.py:127-132 with an f32 Schur complement): the same
// template, with canceltol, maxu and abstol rounded to T first, as the
// reference's weakly typed scalars are.
//
// Bound on the card: latency.  m sequential columns, each a block-wide
// reduction and an O((m-j)^2 / 2) update: ~m^3/6 element updates.  It runs
// only when the plain Cholesky of the Schur complement fails.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 1024;

template <typename T>
__global__ void ldl_masked_kernel(T *__restrict__ A, T *__restrict__ L,
                                  T *__restrict__ dvec,
                                  unsigned char *__restrict__ skip,
                                  T *__restrict__ diagadd,
                                  T *__restrict__ absd, T *__restrict__ col,
                                  int m, T canceltol, T maxu, T abstol,
                                  int skip_pivots) {
  __shared__ T s_dj;
  __shared__ int s_skip;
  __shared__ T s_max[THREADS / 32];
  __shared__ int s_nan[THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const long long mm = m;

  for (int j = 0; j < m; ++j) {
    if (tid == 0) {
      const T ajj = A[j * mm + j];
      const T lbj = canceltol * absd[j] + abstol;
      const bool cancelled = ajj < lbj;
      s_dj = cancelled ? lbj : ajj;
      diagadd[j] = cancelled ? lbj - ajj : T(0);
    }
    __syncthreads();
    const T dj = s_dj;
    T mx = 0;
    int nan = 0;
    for (int i = j + 1 + tid; i < m; i += THREADS) {
      const T c = A[i * mm + j] / dj;
      col[i] = c;
      const T ac = fabs(c);
      if (ac != ac)
        nan = 1;
      else
        mx = fmax(mx, ac);
    }
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmax(mx, __shfl_down_sync(0xffffffffu, mx, off));
      nan |= __shfl_down_sync(0xffffffffu, nan, off);
    }
    if (lane == 0) {
      s_max[wid] = mx;
      s_nan[wid] = nan;
    }
    __syncthreads();
    if (tid == 0) {
      T bm = 0;
      int bn = 0;
      for (int w = 0; w < THREADS / 32; ++w) {
        bm = fmax(bm, s_max[w]);
        bn |= s_nan[w];
      }
      const int do_skip = skip_pivots && !bn && bm > maxu;
      s_skip = do_skip;
      skip[j] = (unsigned char)do_skip;
      dvec[j] = do_skip ? T(CUDART_INF) : dj;
      L[j * mm + j] = T(1);
    }
    __syncthreads();
    if (!s_skip) {
      // a non-finite pivot contributes no update (reference: where(isfinite))
      const T djf = isfinite(dj) ? dj : T(0);
      for (int i = j + 1 + tid; i < m; i += THREADS) {
        const T c = col[i];
        L[i * mm + j] = c;
        absd[i] = absd[i] + djf * (c * c);
      }
      const long long n = m - j - 1;
      const long long ntri = n * (n + 1) / 2;
      for (long long idx = tid; idx < ntri; idx += THREADS) {
        // idx -> (r, c) with 0 <= c <= r < n, row-major lower triangle
        long long r = (long long)((sqrt(8.0 * (double)idx + 1.0) - 1.0) / 2.0);
        while (r * (r + 1) / 2 > idx) --r;
        while ((r + 1) * (r + 2) / 2 <= idx) ++r;
        const long long c = idx - r * (r + 1) / 2;
        const long long rr = j + 1 + r, cc = j + 1 + c;
        A[rr * mm + cc] = A[rr * mm + cc] - djf * (col[rr] * col[cc]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(T *A, T *L, T *d, unsigned char *skip, T *diagadd, T *absd,
           T *col, int m, double canceltol, double maxu, double abstol,
           int skip_pivots, void *stream) {
  if (m > 0)
    ldl_masked_kernel<T><<<1, THREADS, 0, (cudaStream_t)stream>>>(
        A, L, d, skip, diagadd, absd, col, m, (T)canceltol, (T)maxu,
        (T)abstol, skip_pivots);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ldl_masked_launch(double *A, double *L, double *d,
                                 unsigned char *skip, double *diagadd,
                                 double *absd, double *col, int m,
                                 double canceltol, double maxu, double abstol,
                                 int skip_pivots, void *stream) {
  return launch<double>(A, L, d, skip, diagadd, absd, col, m, canceltol,
                        maxu, abstol, skip_pivots, stream);
}

extern "C" int ldl_masked_f32_launch(float *A, float *L, float *d,
                                     unsigned char *skip, float *diagadd,
                                     float *absd, float *col, int m,
                                     double canceltol, double maxu,
                                     double abstol, int skip_pivots,
                                     void *stream) {
  return launch<float>(A, L, d, skip, diagadd, absd, col, m, canceltol,
                       maxu, abstol, skip_pivots, stream);
}
