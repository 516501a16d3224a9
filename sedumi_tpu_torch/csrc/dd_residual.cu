// Compensated residual r = rhs - M v (pcg.dd_matvec_residual).
//
// Replaces the reference's sedumi_tpu/pcg.py:56 dd_matvec_residual, a
// lax.fori_loop over columns that splits every product M_ij v_j with
// Dekker's TwoProd and sums the high parts with TwoSum.  Here one warp owns
// one row: each lane walks the row with stride 32, forms p + e = M_ij v_j
// exactly (e = fma(a, b, -p), the same e as Dekker's split), accumulates p
// with TwoSum and the TwoSum errors and the e terms separately; the 32
// lane partials are merged by a TwoSum tree.  The order of summation
// differs from the reference's sequential one, the error bound does not:
// |r - r_exact| <~ eps |r| + O(n eps^2) sum_j |M_ij v_j|.
//
// Bound on the card: memory.  It reads M once (8 m n bytes; 3.5 MB at
// m = n = 666) and does ~20 flops per element, far below the f64 rate, so
// at solver sizes a launch costs more than the bytes (a few us).
//
// Build with --fmad=false: nvcc would otherwise contract the TwoSum
// sequence into fused multiply-adds and lose its error-free property.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void two_sum(double a, double b, double &s,
                                        double &e) {
  s = a + b;
  double v = s - a;
  e = (a - (s - v)) + (b - v);
}

__global__ void dd_residual_kernel(const double *__restrict__ M,
                                   const double *__restrict__ v,
                                   const double *__restrict__ rhs,
                                   double *__restrict__ out, int m, int n) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;  // the whole warp leaves together
  const double *Mr = M + (size_t)row * n;
  double s = 0.0, comp = 0.0, elo = 0.0;
  for (int j = lane; j < n; j += 32) {
    const double a = Mr[j], b = v[j];
    const double p = a * b;
    const double e = fma(a, b, -p);  // exact: a*b = p + e
    double t, err;
    two_sum(s, p, t, err);
    s = t;
    comp += err;
    elo += e;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double s2 = __shfl_down_sync(0xffffffffu, s, off);
    const double c2 = __shfl_down_sync(0xffffffffu, comp, off);
    const double e2 = __shfl_down_sync(0xffffffffu, elo, off);
    double t, err;
    two_sum(s, s2, t, err);
    s = t;
    comp = (comp + c2) + err;
    elo += e2;
  }
  if (lane == 0) {
    const double total_lo = comp + elo;
    double d, derr;
    two_sum(rhs[row], -s, d, derr);
    out[row] = d + (derr - total_lo);
  }
}

}  // namespace

extern "C" int dd_matvec_residual_launch(const double *M, const double *v,
                                         const double *rhs, double *out,
                                         int m, int n, void *stream) {
  const int threads = 256;  // 8 rows per block
  const int rows_per_block = threads / 32;
  const int blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks > 0)
    dd_residual_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        M, v, rhs, out, m, n);
  return (int)cudaGetLastError();
}
