// Compensated residual r = rhs - M v (pcg.dd_matvec_residual), f64 and f32.
//
// Replaces the reference's sedumi_tpu/pcg.py:56 dd_matvec_residual, a
// lax.fori_loop over columns that splits every product M_ij v_j with
// Dekker's TwoProd and sums the high parts with TwoSum.  Here one warp owns
// one row: each lane walks the row with stride 32, forms p + e = M_ij v_j
// exactly (e = fma(a, b, -p), the same e as Dekker's split with the
// dtype's Veltkamp constant, 2^27 + 1 for f64 and 4097 for f32),
// accumulates p with TwoSum and the TwoSum errors and the e terms
// separately; the 32 lane partials are merged by a TwoSum tree.  The order
// of summation differs from the reference's sequential one, the error
// bound does not: |r - r_exact| <~ u |r| + O(n u^2) sum_j |M_ij v_j|, with
// u the unit roundoff of T.
//
// The f64 build is K1 (the f64 phases' refinement residual), the f32 build
// K1-f32 (the f32 phase's refine_solve_dd, reference ipm.py:186): the same
// template, with fmaf for f32.
//
// Bound on the card: memory.  It reads M once (sizeof(T) m n bytes; 3.5 MB
// at m = n = 666 in f64) and does ~20 flops per element, far below the
// card's rate, so at solver sizes a launch costs more than the bytes.
//
// Build with --fmad=false: nvcc would otherwise contract the TwoSum
// sequence into fused multiply-adds and lose its error-free property.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T &s, T &e) {
  s = a + b;
  T v = s - a;
  e = (a - (s - v)) + (b - v);
}

template <typename T>
__global__ void dd_residual_kernel(const T *__restrict__ M,
                                   const T *__restrict__ v,
                                   const T *__restrict__ rhs,
                                   T *__restrict__ out, int m, int n) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;  // the whole warp leaves together
  const T *Mr = M + (size_t)row * n;
  T s = 0, comp = 0, elo = 0;
  for (int j = lane; j < n; j += 32) {
    const T a = Mr[j], b = v[j];
    const T p = a * b;
    const T e = fma_t(a, b, -p);  // exact: a*b = p + e
    T t, err;
    two_sum(s, p, t, err);
    s = t;
    comp += err;
    elo += e;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const T s2 = __shfl_down_sync(0xffffffffu, s, off);
    const T c2 = __shfl_down_sync(0xffffffffu, comp, off);
    const T e2 = __shfl_down_sync(0xffffffffu, elo, off);
    T t, err;
    two_sum(s, s2, t, err);
    s = t;
    comp = (comp + c2) + err;
    elo += e2;
  }
  if (lane == 0) {
    const T total_lo = comp + elo;
    T d, derr;
    two_sum(rhs[row], -s, d, derr);
    out[row] = d + (derr - total_lo);
  }
}

template <typename T>
int launch(const T *M, const T *v, const T *rhs, T *out, int m, int n,
           void *stream) {
  const int threads = 256;  // 8 rows per block
  const int rows_per_block = threads / 32;
  const int blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks > 0)
    dd_residual_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        M, v, rhs, out, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dd_matvec_residual_launch(const double *M, const double *v,
                                         const double *rhs, double *out,
                                         int m, int n, void *stream) {
  return launch<double>(M, v, rhs, out, m, n, stream);
}

extern "C" int dd_matvec_residual_f32_launch(const float *M, const float *v,
                                             const float *rhs, float *out,
                                             int m, int n, void *stream) {
  return launch<float>(M, v, rhs, out, m, n, stream);
}
