// Double-double matrix-vector product y = (Ah + Al)(xh + xl)
// (ddlinalg.dd_gemv).
//
// Replaces the reference's sedumi_tpu/ddlinalg.py:130 dd_gemv, which runs
// an Ozaki dd_gemm on a one-column matrix on the host.  Here one warp owns
// one output y_i: each lane walks j with stride 32 and forms
//   p + e = Ah_ij xh_j exactly (e = fma(a, b, -p)),
//   c     = Ah_ij xl_j + Al_ij xh_j      (in f64; Al xl is below eps^2),
// sums the p with TwoSum into (s, comp) and the e and c into lo; the 32
// lane partials merge by a TwoSum tree, and (s, comp + lo) is normalised.
// The order of summation differs from the Ozaki route's, the error bound
// does not: |y - y_exact| <= c eps^2 sum_j |A_ij| |x_j|, c = O(n) (the
// tests derive c).
//
// Element (i, j) of A lives at A[i * si + j * sj], so dd_chol_solve's
// panels L[p0:p1, :p0] (si = ld, sj = 1), their transposes L[p1:, p0:p1]'
// (si = 1, sj = ld) and the transposed panel inverses run without a copy.
//
// Bound on the card: memory, 16 bytes per matrix element (Ah and Al):
// 7.1 MB at m = 666 (2.1 us); the panels of dd_chol_solve are 48 rows
// wide, so there a launch costs far more than its bytes.
//
// Build with --fmad=false: TwoSum and the cross terms must round as
// written.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void two_sum(double a, double b, double &s,
                                        double &e) {
  s = a + b;
  const double v = s - a;
  e = (a - (s - v)) + (b - v);
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
  const long long base = row * si;
  double s = 0.0, comp = 0.0, lo = 0.0;
  for (int j = lane; j < n; j += 32) {
    const long long at = base + j * sj;
    const double a = Ah[at], al = Al[at];
    const double b = xh[j], bl = xl[j];
    const double p = a * b;
    const double e = fma(a, b, -p);
    double t, err;
    two_sum(s, p, t, err);
    s = t;
    comp += err;
    lo += e + (a * bl + al * b);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double s2 = __shfl_down_sync(0xffffffffu, s, off);
    const double c2 = __shfl_down_sync(0xffffffffu, comp, off);
    const double l2 = __shfl_down_sync(0xffffffffu, lo, off);
    double t, err;
    two_sum(s, s2, t, err);
    s = t;
    comp = (comp + c2) + err;
    lo += l2;
  }
  if (lane == 0) {
    double h, l;
    two_sum(s, comp + lo, h, l);
    yh[row] = h;
    yl[row] = l;
  }
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
