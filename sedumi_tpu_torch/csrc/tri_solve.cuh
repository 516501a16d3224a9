// The triangle solves of K10 (tile_solve.cu) and K15 (panel_solve.cu):
// y <- L^-1 y and z <- L^-T z for a lower L of order B <= MAXB packed by
// rows in shared memory, the vector in shared memory too, by one block of
// THREADS threads.
//
// Panels of 32 rows.  Warp 0 solves a panel's triangle with shuffles, its
// rows in registers (one division per row, as a substitution does; no
// inverse), then every thread updates one row below (above, backward)
// with the panel's values.  Warp 0 updates the next panel's rows itself,
// so it can go on without waiting: one block barrier per panel.
// Per entry: the panel's products summed from 0 one at a time in order,
// then one subtraction (tests/tile_emulation.py: fwd_diag, bwd_diag).

#pragma once

#include "tri_common.cuh"

namespace dense {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;

// Start copying the lower triangle of the B x B matrix at Ld (row stride
// ld) packed by rows (row r at tri(r)): asynchronous copies (cp.async, all
// in flight at once); __pipeline_wait_prior(0) and a block barrier finish
// them.
template <typename Real>
__device__ void fetch_packed(const Real *__restrict__ Ld, int ld, Real *Lp,
                             int B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < B; r += NWARPS)
    for (int c = lane; c <= r; c += 32)
      __pipeline_memcpy_async(Lp + tri(r) + c, Ld + r * ld + c,
                              sizeof(Real));
  __pipeline_commit();
}

// ys <- L^-1 ys in shared memory.
template <typename Real>
__device__ void fwd_diag(const Real *Lp, Real *ys, int B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p0 = 0; p0 < B; p0 += PANEL) {
    const int P = min(PANEL, B - p0);
    if (warp == 0) {
      // lane i holds row p0 + i of the panel's triangle in registers
      const Real *Lr = Lp + tri(p0 + min(lane, P - 1)) + p0;
      Real l[PANEL];
#pragma unroll
      for (int c = 0; c < PANEL; ++c)
        l[c] = (c < P && c <= lane) ? Lr[c] : Real(0);
      Real v = lane < P ? ys[p0 + lane] : Real(0);
#pragma unroll
      for (int c = 0; c < PANEL; ++c) {
        if (c < P) {
          v = div_lane(v, l[c], lane == c);
          const Real yc = __shfl_sync(FULL, v, c);
          if (lane > c && lane < P) v = v - l[c] * yc;
        }
      }
      if (lane < P) ys[p0 + lane] = v;
    }
    __syncthreads();
    // rows below: warp 0 the next panel's, the other warps the rest
    const int q0 = p0 + P, Pn = min(PANEL, B - q0);
    const int r = warp == 0 ? (lane < Pn ? q0 + lane : B)
                            : q0 + max(Pn, 0) + (int)threadIdx.x - 32;
    if (r < B) {
      const Real *Lr = Lp + tri(r) + p0;
      Real s = 0;
      for (int c = 0; c < P; ++c) s = s + Lr[c] * ys[p0 + c];
      ys[r] = ys[r] - s;
    }
  }
}

// zs <- L^-T zs in shared memory, panels from the bottom.
template <typename Real>
__device__ void bwd_diag(const Real *Lp, Real *zs, int B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = (B - 1) / PANEL; k >= 0; --k) {
    const int p0 = k * PANEL, P = min(PANEL, B - p0);
    if (warp == 0) {
      // lane i holds column p0 + i of the panel's triangle in registers
      Real l[PANEL];
#pragma unroll
      for (int c = 0; c < PANEL; ++c)
        l[c] = (c < P && c >= lane) ? Lp[tri(p0 + c) + p0 + lane] : Real(0);
      Real v = lane < P ? zs[p0 + lane] : Real(0);
#pragma unroll
      for (int c = PANEL - 1; c >= 0; --c) {
        if (c < P) {
          v = div_lane(v, l[c], lane == c);
          const Real xc = __shfl_sync(FULL, v, c);
          if (lane < c) v = v - l[c] * xc;
        }
      }
      if (lane < P) zs[p0 + lane] = v;
    }
    __syncthreads();
    // rows above: warp 0 the previous panel's, the other warps the rest
    const int r = warp == 0 ? (k > 0 ? p0 - PANEL + lane : -1)
                            : ((int)threadIdx.x - 32 < p0 - PANEL
                                   ? (int)threadIdx.x - 32 : -1);
    if (r >= 0) {
      Real s = 0;
      for (int c = 0; c < P; ++c) s = s + Lp[tri(p0 + c) + r] * zs[p0 + c];
      zs[r] = zs[r] - s;
    }
  }
}

}  // namespace dense
