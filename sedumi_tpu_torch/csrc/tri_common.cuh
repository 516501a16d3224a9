// Pieces shared by the dense triangular kernels: K8 (tile_chol.cu), K10
// (tile_solve.cu), K14 (panel_chol.cu) and K15 (panel_solve.cu).
//
// Tiles are at most MAXB x MAXB, row-major in device memory; in shared
// memory a tile's rows sit LD apart (one more than MAXB, so a thread per
// row touches distinct banks) or a lower triangle is packed by rows (row
// r at tri(r)).  Factors and solves go in panels of PANEL columns (fewer
// at the end when the order is not a multiple of PANEL).  Templates over
// the element type: each kernel instantiates the types it builds.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace dense {

constexpr int PANEL = 32;
constexpr int MAXB = 128;
constexpr int LD = MAXB + 1;   // row stride of a tile in shared memory
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ int tri(int r) {
  return r * (r + 1) / 2;
}

__device__ __forceinline__ double sqrt_t(double a) { return sqrt(a); }
__device__ __forceinline__ float sqrt_t(float a) { return sqrtf(a); }
__device__ __forceinline__ double fabs_t(double a) { return fabs(a); }
__device__ __forceinline__ float fabs_t(float a) { return fabsf(a); }

// The value, hidden from the compiler, so that a division of it is not
// rewritten into a division of a zero.
__device__ __forceinline__ double opaque(double v) {
  asm volatile("" : "+d"(v));
  return v;
}
__device__ __forceinline__ float opaque(float v) {
  asm volatile("" : "+f"(v));
  return v;
}

// x / d for a pivot d in (0, inf).  A zero x divides d instead and keeps
// itself (what IEEE division gives, signed zero included): the card's
// division takes a slow path for a zero numerator (and for a literal 1,
// a reciprocal), and the sparse tiles hold many zeros.
template <typename Real>
__device__ __forceinline__ Real div_pos(Real x, Real d) {
  const Real q = opaque(x == Real(0) ? d : x) / d;
  return x == Real(0) ? x : q;
}

// Lane c's x / d, d a diagonal entry of the factor (in (0, inf)); every
// other lane divides 1 by 1, so the warp does not diverge, and a zero x
// divides d instead and keeps itself, as in div_pos.
template <typename Real>
__device__ __forceinline__ Real div_lane(Real x, Real d, bool mine) {
  const bool use = mine && x != Real(0);
  const Real den = mine ? d : Real(1);
  const Real q = opaque(use ? x : den) / den;
  return use ? q : x;
}

// Copy rows [0, nr) of a row-major matrix with row stride ld into shared
// memory, row r to dst + off(r), only its first len(r) entries;
// asynchronous (cp.async, every copy in flight at once), waited for here.
template <typename Real, typename Off, typename Len>
__device__ void stage(const Real *src, int ld, int nr, Real *dst, Off off,
                      Len len) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < nr; r += nwarps)
    for (int c = lane; c < len(r); c += 32)
      __pipeline_memcpy_async(dst + off(r) + c, src + r * ld + c,
                              sizeof(Real));
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Lets `kernel` take dynamic shared memory above 48 KB, up to what the card
// leaves beside its static shared memory; done once per process (`done`).
inline int raise_smem_once(const void *kernel, bool &done) {
  if (done) return 0;
  int dev = 0, most = 0;
  cudaFuncAttributes fa;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err) err = (int)cudaFuncGetAttributes(&fa, kernel);
  if (!err)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        most - (int)fa.sharedSizeBytes);
  done = err == 0;
  return err;
}

}  // namespace dense
