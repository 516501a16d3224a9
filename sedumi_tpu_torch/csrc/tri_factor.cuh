// The factor pieces of K8 (tile_chol.cu): the trailing update (SYRK) of a
// right-looking Cholesky blocked in panels of PANEL columns, and the solve
// X = T L^-T of row chunks of a tile against a factored diagonal block
// (K14, panel_chol.cu, shares only load_lower).  Both keep the order of
// operations of a scalar right-looking factor: every entry receives its
// updates one product at a time, k = 0, 1, ..., then its division (or
// square root); tests/tile_emulation.py (chol_blocked, off_solve)
// repeats it.

#pragma once

#include "tri_common.cuh"

namespace dense {

constexpr int FACTOR_THREADS = 256;   // a block that factors a tile
constexpr int OFF_THREADS = 128;      // a block that solves a row chunk
constexpr int OFF_ROWS = 32;          // rows of a chunk

// The lower triangle of a row-major B x B tile into A (row stride LD).
template <typename Real>
__device__ void load_lower(const Real *tile, Real *A, int B) {
  stage(tile, B, B, A, [](int r) { return r * LD; },
        [](int r) { return r + 1; });
}

// The trailing update of one panel on the lower triangle of A[q0:, q0:]:
// A[i][j] -= L[i][k] L[j][k] over the panel's columns k = p0, p0 + 1, ...
// in order.  Thread (ti, tj) of 16 x 16 owns i = q0 + ti + 16 u and
// j = q0 + tj + 16 v, v <= u (every block v > u lies above the diagonal),
// u, v < NG = ceil((B - q0) / 16), held in registers over the k loop.
template <int NG, typename Real>
__device__ void syrk(Real *A, int B, int p0, int P, int q0) {
  const int ti = threadIdx.x / 16, tj = threadIdx.x % 16;
  Real acc[NG][NG];
#pragma unroll
  for (int u = 0; u < NG; ++u)
#pragma unroll
    for (int v = 0; v <= u; ++v) {
      const int i = q0 + ti + 16 * u, j = q0 + tj + 16 * v;
      acc[u][v] = (i < B && j <= i) ? A[i * LD + j] : Real(0);
    }
  for (int k = p0; k < p0 + P; ++k) {
    Real li[NG], lj[NG];
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      const int i = q0 + ti + 16 * u, j = q0 + tj + 16 * u;
      li[u] = i < B ? A[i * LD + k] : Real(0);
      lj[u] = j < B ? A[j * LD + k] : Real(0);
    }
#pragma unroll
    for (int u = 0; u < NG; ++u)
#pragma unroll
      for (int v = 0; v <= u; ++v) acc[u][v] = acc[u][v] - li[u] * lj[v];
  }
#pragma unroll
  for (int u = 0; u < NG; ++u)
#pragma unroll
    for (int v = 0; v <= u; ++v) {
      const int i = q0 + ti + 16 * u, j = q0 + tj + 16 * v;
      if (i < B && j <= i) A[i * LD + j] = acc[u][v];
    }
}

// The rank-(e - p0) update of the rows and columns from e on (at most 96:
// 6 strips of 16), by FACTOR_THREADS threads; a block barrier follows it.
template <typename Real>
__device__ void trailing_syrk(Real *A, int B, int p0, int e) {
  switch ((B - e + 15) / 16) {
    case 1: syrk<1>(A, B, p0, e - p0, e); break;
    case 2: syrk<2>(A, B, p0, e - p0, e); break;
    case 3: syrk<3>(A, B, p0, e - p0, e); break;
    case 4: syrk<4>(A, B, p0, e - p0, e); break;
    case 5: syrk<5>(A, B, p0, e - p0, e); break;
    default: syrk<6>(A, B, p0, e - p0, e); break;
  }
}

// X = T L^-T for a chunk of R <= OFF_ROWS rows of T, by OFF_THREADS
// threads.  Lp: L's lower triangle packed by rows; X: the chunk in shared
// memory (row stride LD), solved in place and then written to out (row
// stride ldo).  Rows are independent, so each warp takes eight rows and
// meets no other warp: per panel, column by column, the column's
// divisions (a lane a row), then its products into the panel's later
// columns (a lane a column); then the panel's products into the remaining
// columns (GEMM, a lane three columns, in registers).
template <typename Real>
__device__ void off_rows(const Real *Lp, Real *X, int B, int R, Real *out,
                         int ldo) {
  // each warp's current column, an array of its own (its stores do not
  // hold up the loads of L)
  constexpr int NW = OFF_THREADS / 32, RW = OFF_ROWS / NW;
  __shared__ Real colw[NW][RW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // warp w owns rows w RW ... w RW + RW - 1
  const int rb = warp * RW, nr = max(0, min(RW, R - rb));
  Real *Xw = X + rb * LD;
  for (int p0 = 0; p0 < B; p0 += PANEL) {
    const int e = min(p0 + PANEL, B);
    // (1) the panel's columns one by one: the column's divisions (a lane a
    // row), then its products into the panel's later columns (a lane a
    // column)
    for (int c = p0; c < e; ++c) {
      if (lane < nr) {
        const Real xc = div_pos(Xw[lane * LD + c], Lp[tri(c) + c]);
        Xw[lane * LD + c] = xc;
        colw[warp][lane] = xc;
      }
      __syncwarp();
      const int t = c + 1 + lane;
      if (t < e) {
        const Real ltc = Lp[tri(t) + c];
        Real x[RW], xc[RW];   // every load first, then the products
#pragma unroll
        for (int k = 0; k < RW; ++k) {
          x[k] = k < nr ? Xw[k * LD + t] : Real(0);
          xc[k] = colw[warp][k];
        }
#pragma unroll
        for (int k = 0; k < RW; ++k)
          if (k < nr) Xw[k * LD + t] = x[k] - xc[k] * ltc;
      }
      __syncwarp();
    }
    // (2) the remaining columns j = e + lane + 32 m: X[r][j] -= X[r][k]
    // L[j][k], k in the panel in order
    if (e >= B) break;
    constexpr int NM = (MAXB - PANEL) / 32;   // 3
    Real acc[RW][NM];
#pragma unroll
    for (int k = 0; k < RW; ++k)
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int j = e + lane + 32 * m;
        acc[k][m] = (k < nr && j < B) ? Xw[k * LD + j] : Real(0);
      }
    for (int c = p0; c < e; ++c) {
      Real xk[RW], lj[NM];
#pragma unroll
      for (int k = 0; k < RW; ++k) xk[k] = Xw[k * LD + c];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int j = e + lane + 32 * m;
        lj[m] = j < B ? Lp[tri(j) + c] : Real(0);
      }
#pragma unroll
      for (int k = 0; k < RW; ++k)
#pragma unroll
        for (int m = 0; m < NM; ++m) acc[k][m] = acc[k][m] - xk[k] * lj[m];
    }
#pragma unroll
    for (int k = 0; k < RW; ++k)
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int j = e + lane + 32 * m;
        if (k < nr && j < B) Xw[k * LD + j] = acc[k][m];
      }
    __syncwarp();
  }
  for (int k = 0; k < nr; ++k)
    for (int c = lane; c < B; c += 32)
      out[(rb + k) * ldo + c] = Xw[k * LD + c];
}

}  // namespace dense
