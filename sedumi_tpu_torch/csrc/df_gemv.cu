// Double-float (two-f32) compensated GEMV and GEMV-transpose (df.py, K11).
//
// Replaces the reference's sedumi_tpu/df.py:94 df_matvec and :127
// df_vecmat (the products of DfAOp, :161): elementwise error-free f32
// TwoProd over n-chunks of 16384 and a pairwise TwoSum tree.  A df number
// is an unevaluated sum hi + lo of two f32 (resolution ~2^-48); the
// operator is stored as hi/lo pairs A = Ah + Al, the vector as x = xh + xl.
// Per element both entry points form
//   p + e = Ah_j xh_j exactly (e = fmaf(Ah, xh, -p); --fmad=false keeps
//           every other product and sum rounded on its own),
//   c     = (e + Ah_j xl_j) + Al_j xh_j   (Al xl, below 2^-48, dropped),
// and add (p, c) into a running df sum (s, t): TwoSum(s, p) = s1 + err,
// t += err + c, then TwoSum(s1, t) renormalises so |t| <= ulp(s)/2.
//
//  * df_matvec: [rows, n] x [n] -> [rows].  One warp per row; each lane
//    walks the row with stride 32 (coalesced), four loads in flight, and
//    the 32 lane sums merge by a shuffle tree of df additions.
//  * df_vecmat: [rows] x [rows, n] -> [n].  One thread per column, so the
//    warp's reads coalesce along a row; a sequential df sum over the rows.
//
// Error: against the exact sum of (Ah + Al)(xh + xl) each step adds at
// most ~(3 S + 2 |a_j x_j|) u^2 (S = sum_j |a_j x_j|, u = 2^-24), so a sum
// of L terms is within (3 L + 30) u^2 S (L = ceil(n/32) for df_matvec plus
// its 5 tree levels, L = rows for df_vecmat); the reference's tree is
// within ((D + c)(D + c + 2) + 7) u^2 S for a tree of depth D over c
// chunks.  The summation order differs from the reference's; the bound is
// what holds the two together.
//
// Bound on the card: memory.  Each product reads the 8 bytes of a hi/lo
// pair once and does ~25 f32 operations on it (the card's f32 rate is
// 67 TFLOP/s, its memory 3.35 TB/s: 3.1 operations per byte would be the
// balance), so the floor is 8 rows n bytes over 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void two_sum(float a, float b, float &s,
                                        float &e) {
  s = a + b;
  float v = s - a;
  e = (a - (s - v)) + (b - v);
}

// (s, t) += a * x in df, a = ah + al, x = xh + xl
__device__ __forceinline__ void df_madd(float ah, float al, float xh,
                                        float xl, float &s, float &t) {
  const float p = ah * xh;
  const float e = fmaf(ah, xh, -p);  // exact: ah*xh = p + e
  const float c = (e + ah * xl) + al * xh;
  float s1, err;
  two_sum(s, p, s1, err);
  t = t + (err + c);
  two_sum(s1, t, s, t);
}

// (s, t) += (s2, t2) in df
__device__ __forceinline__ void df_add(float s2, float t2, float &s,
                                       float &t) {
  float h, err;
  two_sum(s, s2, h, err);
  t = (t + t2) + err;
  two_sum(h, t, s, t);
}

constexpr int MV_THREADS = 256;   // 8 rows per block
constexpr int VM_THREADS = 256;

__global__ void df_matvec_kernel(const float *__restrict__ Ah,
                                 const float *__restrict__ Al,
                                 const float *__restrict__ xh,
                                 const float *__restrict__ xl,
                                 float *__restrict__ yh,
                                 float *__restrict__ yl, int rows, int n) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const float *ah_r = Ah + (size_t)row * n;
  const float *al_r = Al + (size_t)row * n;
  float s = 0.f, t = 0.f;
  int j = lane;
  for (; j + 96 < n; j += 128) {
    float a[4], b[4], u[4], w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = ah_r[j + 32 * k];
      b[k] = al_r[j + 32 * k];
      u[k] = xh[j + 32 * k];
      w[k] = xl[j + 32 * k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) df_madd(a[k], b[k], u[k], w[k], s, t);
  }
  for (; j < n; j += 32) df_madd(ah_r[j], al_r[j], xh[j], xl[j], s, t);
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_down_sync(0xffffffffu, s, off);
    const float t2 = __shfl_down_sync(0xffffffffu, t, off);
    df_add(s2, t2, s, t);
  }
  if (lane == 0) {
    yh[row] = s;
    yl[row] = t;
  }
}

__global__ void df_vecmat_kernel(const float *__restrict__ xh,
                                 const float *__restrict__ xl,
                                 const float *__restrict__ Ah,
                                 const float *__restrict__ Al,
                                 float *__restrict__ yh,
                                 float *__restrict__ yl, int rows, int n) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  float s = 0.f, t = 0.f;
  for (int i = 0; i < rows; ++i) {
    const size_t at = (size_t)i * n + col;
    df_madd(Ah[at], Al[at], xh[i], xl[i], s, t);
  }
  yh[col] = s;
  yl[col] = t;
}

}  // namespace

extern "C" int df_matvec_launch(const float *Ah, const float *Al,
                                const float *xh, const float *xl, float *yh,
                                float *yl, int rows, int n, void *stream) {
  const int per_block = MV_THREADS / 32;
  const int blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0)
    df_matvec_kernel<<<blocks, MV_THREADS, 0, (cudaStream_t)stream>>>(
        Ah, Al, xh, xl, yh, yl, rows, n);
  return (int)cudaGetLastError();
}

extern "C" int df_vecmat_launch(const float *xh, const float *xl,
                                const float *Ah, const float *Al, float *yh,
                                float *yl, int rows, int n, void *stream) {
  const int blocks = (n + VM_THREADS - 1) / VM_THREADS;
  if (blocks > 0)
    df_vecmat_kernel<<<blocks, VM_THREADS, 0, (cudaStream_t)stream>>>(
        xh, xl, Ah, Al, yh, yl, rows, n);
  return (int)cudaGetLastError();
}
