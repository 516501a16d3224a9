// Elementwise double-double passes (ddlinalg.dd_accumulate, dd_add,
// two_prod_cols).
//
// Replaces the element arithmetic of the reference's dd pipeline, numpy on
// the host: the TwoSum accumulation of dd_gemm's partial products and its
// final normalise (sedumi_tpu/ddlinalg.py:113-127), dd_add / dd_sub
// (:54-60) and the LP term's two_prod(Al, d_l) (sedumi_tpu/ddengine.py:53).
// Three entry points, one thread per element:
//  * accumulate: (Sh, Sl) <- TwoSum(Sh, P), Sl += e, in place; with
//    normalize, then (Sh, Sl) <- TwoSum(Sh, Sl).
//  * add: (oh, ol) = TwoSum(ah, sb bh) normalised with
//    (se + al) + sb bl, sb = +1 (dd_add) or -1 (dd_sub); bl may be absent
//    (0.0, added all the same so signed zeros match).
//  * two_prod_cols: p = a v_col, e = fma(a, v_col, -p), which is the same
//    exact (p, e) as Dekker's split whenever the split does not overflow.
// Every operation and association is the reference's, so the results
// match the plain version bit for bit.
//
// Bound on the card: memory.  accumulate reads three and writes two
// doubles per element (40 bytes; control07's 667 x 667 Gram: 18 MB,
// 5.3 us), add reads four and writes two.
//
// Build with --fmad=false: nvcc would otherwise contract TwoSum's and
// the normalise's a*b+c patterns into fused multiply-adds.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void two_sum(double a, double b, double &s,
                                        double &e) {
  s = a + b;
  const double v = s - a;
  e = (a - (s - v)) + (b - v);
}

__global__ void accumulate_kernel(double *__restrict__ Sh,
                                  double *__restrict__ Sl,
                                  const double *__restrict__ P, long long n,
                                  int normalize) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  double s, e;
  two_sum(Sh[i], P[i], s, e);
  double l = Sl[i] + e;
  if (normalize) {
    double s2;
    two_sum(s, l, s2, l);
    s = s2;
  }
  Sh[i] = s;
  Sl[i] = l;
}

__global__ void add_kernel(const double *__restrict__ ah,
                           const double *__restrict__ al,
                           const double *__restrict__ bh,
                           const double *__restrict__ bl, int negate_b,
                           double *__restrict__ oh, double *__restrict__ ol,
                           long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  double b_h = bh[i];
  double b_l = bl ? bl[i] : 0.0;
  if (negate_b) {
    b_h = -b_h;
    b_l = -b_l;
  }
  double sh, se;
  two_sum(ah[i], b_h, sh, se);
  double h, l;
  two_sum(sh, (se + al[i]) + b_l, h, l);
  oh[i] = h;
  ol[i] = l;
}

__global__ void two_prod_cols_kernel(const double *__restrict__ A,
                                     const double *__restrict__ v, int C,
                                     double *__restrict__ P,
                                     double *__restrict__ E, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const double a = A[i], b = v[i % C];
  const double p = a * b;
  P[i] = p;
  E[i] = fma(a, b, -p);
}

inline int blocks_for(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int dd_accumulate_launch(double *Sh, double *Sl, const double *P,
                                    long long n, int normalize,
                                    void *stream) {
  if (n > 0)
    accumulate_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        Sh, Sl, P, n, normalize);
  return (int)cudaGetLastError();
}

extern "C" int dd_add_launch(const double *ah, const double *al,
                             const double *bh, const double *bl,
                             int negate_b, double *oh, double *ol,
                             long long n, void *stream) {
  if (n > 0)
    add_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        ah, al, bh, bl, negate_b, oh, ol, n);
  return (int)cudaGetLastError();
}

extern "C" int two_prod_cols_launch(const double *A, const double *v, int C,
                                    double *P, double *E, long long n,
                                    void *stream) {
  if (n > 0)
    two_prod_cols_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        A, v, C, P, E, n);
  return (int)cudaGetLastError();
}
