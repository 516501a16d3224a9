// The triangle solves of K10 (tile_solve.cu) and K15 (panel_solve.cu):
// y <- L^-1 y and z <- L^-T z for a lower L of order B <= MAXB packed by
// rows in shared memory, the vector in shared memory too, by one block of
// THREADS threads.
//
// Panels of 32 rows.  Warp 0 solves a panel's triangle with shuffles (one
// quotient per row, as a substitution does; no inverse), then every thread
// updates one row below (above, backward) with the panel's values.  Warp 0
// updates the next panel's rows itself, so it can go on without waiting:
// one block barrier per panel.  Per entry: the panel's products summed
// from 0 one at a time in order, then one subtraction
// (tests/tile_emulation.py: fwd_diag, bwd_diag).  A row's quotient is
// Div's reciprocal rule (div_rn.cuh: each lane forms the reciprocal of its
// own diagonal entry before the panel, then its quotient is a product and
// four fmas on the chain), the IEEE quotient bit for bit.

#pragma once

#include "div_rn.cuh"
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

// One panel's triangle by warp 0 with Div's quotients, a run-time loop
// over the columns (small code; each lane's entry of the next column
// loaded a step ahead).  Lane c keeps its fast quotient, and nothing but
// the quotient sits on the chain: each lane keeps the value it divided,
// and after the panel checks Div's range for it; if a lane's failed, the
// warp runs the panel again from its first values with the division
// (SAFE), the same bits as the fast quotients where they hold.  FWD: lane
// i holds row p0 + i (Lr: the row, entry c at Lr[c]), columns in rising
// order; otherwise column p0 + i (Lr: the column, entry c at
// Lr[tri(p0 + c)]), columns from the last.
template <bool FWD, bool SAFE, typename Real>
__device__ __forceinline__ Real tri_panel_rn(const Real *Lr, Real v,
                                             const Div<Real> &dv, int p0,
                                             int P, int lane, Real &xm) {
  auto at = [&](int c) { return FWD ? Lr[c] : Lr[tri(p0 + c)]; };
  int c = FWD ? 0 : P - 1;
  Real ln = at(c);
  for (int n = 0; n < P; ++n, c += FWD ? 1 : -1) {
    const Real lc = ln;
    if (n + 1 < P) ln = at(FWD ? c + 1 : c - 1);
    const bool mine = lane == c;
    if (SAFE) {
      v = div_lane(v, dv.d, mine);
    } else {
      xm = mine ? v : xm;
      const Real q = dv.fast(v);
      v = mine ? q : v;
    }
    const Real vc = __shfl_sync(FULL, v, c);
    if (FWD ? (lane > c && lane < P) : lane < c) v = v - lc * vc;
  }
  return v;
}

template <bool FWD, typename Real>
__device__ __forceinline__ Real tri_panel_rn(const Real *Lr, Real v,
                                             const Div<Real> &dv, int p0,
                                             int P, int lane) {
  Real xm = 0;
  const Real w = tri_panel_rn<FWD, false>(Lr, v, dv, p0, P, lane, xm);
  if (!__any_sync(FULL, lane < P && dv.slow(xm))) return w;
  return tri_panel_rn<FWD, true>(Lr, v, dv, p0, P, lane, xm);
}

// ys <- L^-1 ys in shared memory.
template <typename Real>
__device__ void fwd_diag(const Real *Lp, Real *ys, int B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p0 = 0; p0 < B; p0 += PANEL) {
    const int P = min(PANEL, B - p0);
    if (warp == 0) {
      // lane i holds row p0 + i; a run-time loop over the columns (small
      // code), each lane's entry of the next column loaded a step ahead
      const Real *Lr = Lp + tri(p0 + min(lane, P - 1)) + p0;
      const Real v = lane < P ? ys[p0 + lane] : Real(0);
      const Div<Real> dv = lane < P ? Div<Real>(Lr[lane]) : Div<Real>();
      const Real w = tri_panel_rn<true>(Lr, v, dv, p0, P, lane);
      if (lane < P) ys[p0 + lane] = w;
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
      // lane i holds column p0 + i; a run-time loop, as fwd_diag's
      const Real *Lc = Lp + p0 + min(lane, P - 1);   // L[r][p0 + i] at tri(r)
      const Real v = lane < P ? zs[p0 + lane] : Real(0);
      const Div<Real> dv = lane < P ? Div<Real>(Lc[tri(p0 + lane)])
                                    : Div<Real>();
      const Real w = tri_panel_rn<false>(Lc, v, dv, p0, P, lane);
      if (lane < P) zs[p0 + lane] = w;
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
