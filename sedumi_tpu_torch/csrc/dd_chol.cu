// One panel of the double-double Cholesky, and the dd inverse of its
// diagonal block (ddlinalg.dd_panel_chol): kernel K7.
//
// Replaces the reference's sedumi_tpu/ddlinalg.py:166-183 (dd_chol's
// column loop over one nb-wide panel, numpy on the host) and :186-206 (the
// dd inverse of the panel's diagonal block).  Input: the panel S [nr, w]
// (row stride ld) after the left-looking trailing update, as a dd pair.
// Column j:
//   d   = S_jj; if not (d_h > 0): d = (max(|d_h|, 1e-300), 0), ok = 0
//         (NaN stays NaN, as Python's max keeps it)
//   s   = dd_sqrt(d);  L_rj = dd_div(S_rj, s)  (r >= j)
//   S_rc -= L_rj L_cj in dd (r > j, j < c < w): TwoProd of the highs,
//           lows (pe + a_h b_l) + a_l b_h, then dd_sub.
// The inverse rows of L11 follow by dd forward substitution on E = I:
//   q_j = dd_div(E_j, L_jj);  E_r -= L_rj q_j  (r > j).
//
// Bound on the card: the chain, not bytes or flops.  Each column waits for
// the previous one's pivot: dd_sqrt, dd_div of the next diagonal entry, its
// update, the next dd_sqrt -- w dependent steps for the factor and w for
// the inverse, each some hundreds of cycles of dependent f64 operations
// (~1.1 us a factor step on an H100, the inverse and the rows a step
// behind it, so a panel takes ~w steps whatever its rows).
//
// Design.  Every block holds the panel's w x w diagonal block in shared
// memory and factors it with its first four warps (a warp group: one named
// barrier after each column's divisions and one after its trailing update;
// the pivot's dd_sqrt is computed by every thread of the group, so nothing
// waits for a broadcast).  After the divisions of column j the group
// publishes column j of L11 and the pivot through a progress counter in
// shared memory; the block's other eight warps follow it a column behind
// with no block barrier:
//   * a row warp owns two rows below the diagonal block, loaded coalesced
//     into registers (lane l holds columns l and l + 32).  At step j the
//     lane owning column j divides, the quotient L_rj is broadcast by
//     shuffle, and the lanes of columns c > j apply their update with L_cj
//     from shared memory: w steps of (div, shuffle, update) per row, the
//     two rows interleaved;
//   * an inverse warp owns one column c of E (lane l rows l and l + 32):
//     at step j the lane owning row j divides, the quotient q_jc is
//     broadcast, and the lanes of rows r > j update E_rc.
// Block 0 also writes L11 and the ok flag.  The eight warps of the first
// ceil(w / 8) blocks take the inverse's columns, the others two rows each
// (a panel of 666 rows: 6 + 39 blocks of 384 threads).  Lanes
// that only carry a shuffle divide 1 by 1, and a zero numerator gets its
// signed zero without the card's slow division (qdiv): every operation of
// the plain version still runs, on the same values in the same order (j
// ascending for every entry), so L, the inverse and ok match
// dd_panel_chol_plain bit for bit.  TwoProd is fma(a, b, -p), the same
// exact (p, e) as the reference's Dekker split; division and sqrt are
// correctly rounded.
//
// Build with --fmad=false: TwoSum and the dd products must round as
// written.

#include <cuda_runtime.h>

namespace {

constexpr int FW = 4;                    // warps of the factor group
constexpr int WK = 8;                    // row and inverse warps a block
constexpr int THREADS = 32 * (FW + WK);
constexpr int RPW = 2;                   // rows a row warp
constexpr int UPD = 4;                   // trailing updates in flight
constexpr int MAXW = 64;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double opaque(double v) {
  asm volatile("" : "+d"(v));
  return v;
}

// x / d as IEEE division gives it.  A zero x over a d that is neither zero
// nor NaN gives its signed zero without dividing: the card's division
// takes a slow path for a zero numerator.
__device__ __forceinline__ double qdiv(double x, double d) {
  const bool z = x == 0.0 && d != 0.0 && d == d;
  const double q = opaque(z ? 1.0 : x) / opaque(z ? 1.0 : d);
  const long long sign = (__double_as_longlong(x) ^ __double_as_longlong(d))
                         & (long long)0x8000000000000000ULL;
  return z ? __longlong_as_double(sign) : q;
}

__device__ __forceinline__ void two_sum(double a, double b, double &s,
                                        double &e) {
  s = a + b;
  const double v = s - a;
  e = (a - (s - v)) + (b - v);
}

__device__ __forceinline__ void two_prod(double a, double b, double &p,
                                         double &e) {
  p = a * b;
  e = fma(a, b, -p);
}

// numpy.maximum(a, b) for a constant b that is not NaN: NaN in a wins
__device__ __forceinline__ double np_max(double a, double b) {
  return (a > b || a != a) ? a : b;
}

// dd_add(ah, al, -bh, -bl): the reference's dd_sub
__device__ __forceinline__ void dd_sub(double ah, double al, double bh,
                                       double bl, double &h, double &l) {
  double sh, se;
  two_sum(ah, -bh, sh, se);
  two_sum(sh, (se + al) + (-bl), h, l);
}

// dd_mul(q1, 0, bh, bl) as dd_div calls it
__device__ __forceinline__ void dd_mul_hi(double q1, double bh, double bl,
                                          double &h, double &l) {
  double ph, pe;
  two_prod(q1, bh, ph, pe);
  two_sum(ph, (pe + q1 * bl) + 0.0 * bh, h, l);
}

__device__ __forceinline__ void dd_div(double ah, double al, double bh,
                                       double bl, double &h, double &l) {
  const double q1 = qdiv(ah, bh);
  double ph, pl, rh, rl;
  dd_mul_hi(q1, bh, bl, ph, pl);
  dd_sub(ah, al, ph, pl, rh, rl);
  const double q2 = qdiv(rh + rl, bh);
  two_sum(q1, q2, h, l);
}

// dd_div in the lane that owns the operands; the others divide 1 by 1
__device__ __forceinline__ void dd_div_lane(double ah, double al, double bh,
                                            double bl, bool mine, double &h,
                                            double &l) {
  dd_div(mine ? ah : 1.0, mine ? al : 0.0, mine ? bh : 1.0, mine ? bl : 0.0,
         h, l);
}

__device__ __forceinline__ void dd_sqrt(double ah, double al, double &h,
                                        double &l) {
  const double s = sqrt(np_max(ah, 0.0));
  double ph, pl, rh, rl;
  two_prod(s, s, ph, pl);
  dd_sub(ah, al, ph, pl, rh, rl);
  const double e = qdiv(rh + rl, np_max(2.0 * s, 1e-300));
  two_sum(s, e, h, l);
}

// S -= a b in dd, a = L_rj (or L_rj), b = L_cj (or q_jc)
__device__ __forceinline__ void dd_update(double &sh, double &sl, double ah,
                                          double al, double bh, double bl) {
  double ph, pe;
  two_prod(ah, bh, ph, pe);
  const double pl = (pe + ah * bl) + al * bh;
  dd_sub(sh, sl, ph, pl, sh, sl);
}

__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(FW * 32) : "memory");
}

__device__ __forceinline__ void wait_for(volatile int *prog, int j) {
  while (*prog <= j) {
  }
  __threadfence_block();
}

struct Panel {
  const double *Sh, *Sl;
  double *Lh, *Ll, *Ih, *Il;
  int *ok;
  int ld, nr, w;
};

// The factor group: L11 in place in Dh/Dl (stride ldd), pivots in ph/pl,
// column j published by *prog = j + 1.  Returns whether a pivot was
// replaced (in every thread of the group).
__device__ bool factor_diag(double *Dh, double *Dl, int ldd, double *ph,
                            double *pl, const unsigned short *tri,
                            volatile int *prog, int w) {
  const int t = threadIdx.x;
  bool bad = false;
  for (int j = 0; j < w; ++j) {
    double dh = Dh[j * ldd + j], dl = Dl[j * ldd + j];
    if (!(dh > 0.0)) {
      const double v = fabs(dh);
      dh = (1e-300 > v) ? 1e-300 : v;
      dl = 0.0;
      bad = true;
    }
    double sh, sl;
    dd_sqrt(dh, dl, sh, sl);
    if (t == 0) {
      ph[j] = sh;
      pl[j] = sl;
    }
    if (t < w - j) {
      const int r = j + t;
      dd_div(Dh[r * ldd + j], Dl[r * ldd + j], sh, sl, Dh[r * ldd + j],
             Dl[r * ldd + j]);
    }
    group_sync();
    if (t == 0) {
      __threadfence_block();
      *prog = j + 1;
    }
    // the trailing triangle j < c <= r < w, packed by rows: UPD entries a
    // thread at once, their loads before their stores (independent chains)
    const int n = w - j - 1, cnt = n * (n + 1) / 2;
    for (int i0 = t; i0 < cnt; i0 += UPD * FW * 32) {
      int at[UPD];
      double xh[UPD], xl[UPD], ah[UPD], al[UPD], bh[UPD], bl[UPD];
#pragma unroll
      for (int u = 0; u < UPD; ++u) {
        const int i = min(i0 + u * FW * 32, cnt - 1);
        const int r = j + 1 + (tri[i] >> 8), c = j + 1 + (tri[i] & 255);
        at[u] = i0 + u * FW * 32 < cnt ? r * ldd + c : -1;
        xh[u] = Dh[r * ldd + c];
        xl[u] = Dl[r * ldd + c];
        ah[u] = Dh[r * ldd + j];
        al[u] = Dl[r * ldd + j];
        bh[u] = Dh[c * ldd + j];
        bl[u] = Dl[c * ldd + j];
      }
#pragma unroll
      for (int u = 0; u < UPD; ++u)
        dd_update(xh[u], xl[u], ah[u], al[u], bh[u], bl[u]);
#pragma unroll
      for (int u = 0; u < UPD; ++u)
        if (at[u] >= 0) {
          Dh[at[u]] = xh[u];
          Dl[at[u]] = xl[u];
        }
    }
    group_sync();
  }
  return bad;
}

// Two rows r0, r0 + 1 (>= w) of L, lanes over columns.
__device__ void row_warp(const Panel &p, const double *Dh, const double *Dl,
                         int ldd, const double *ph, const double *pl,
                         volatile int *prog, int r0) {
  const int lane = threadIdx.x & 31, w = p.w;
  double xh[RPW][2], xl[RPW][2];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = min(r0 + k, p.nr - 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int c = lane + 32 * s;
      xh[k][s] = c < w ? p.Sh[(long long)r * p.ld + c] : 0.0;
      xl[k][s] = c < w ? p.Sl[(long long)r * p.ld + c] : 0.0;
    }
  }
  for (int j = 0; j < w; ++j) {
    wait_for(prog, j);
    const double sh = ph[j], sl = pl[j];
    const bool own = lane == (j & 31), hi = j >= 32;
    double bh[2], bl[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int c = lane + 32 * s;
      bh[s] = c > j && c < w ? Dh[c * ldd + j] : 0.0;
      bl[s] = c > j && c < w ? Dl[c * ldd + j] : 0.0;
    }
    double qh[RPW], ql[RPW];
#pragma unroll
    for (int k = 0; k < RPW; ++k)
      dd_div_lane(hi ? xh[k][1] : xh[k][0], hi ? xl[k][1] : xl[k][0], sh, sl,
                  own, qh[k], ql[k]);
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      qh[k] = __shfl_sync(FULL, qh[k], j & 31);
      ql[k] = __shfl_sync(FULL, ql[k], j & 31);
      if (own && hi) {
        xh[k][1] = qh[k];
        xl[k][1] = ql[k];
      } else if (own) {
        xh[k][0] = qh[k];
        xl[k][0] = ql[k];
      }
    }
#pragma unroll
    for (int k = 0; k < RPW; ++k)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int c = lane + 32 * s;
        if (c > j && c < w)
          dd_update(xh[k][s], xl[k][s], qh[k], ql[k], bh[s], bl[s]);
      }
  }
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = r0 + k;
    if (r >= p.nr) continue;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int c = lane + 32 * s;
      if (c < w) {
        p.Lh[(long long)r * w + c] = xh[k][s];
        p.Ll[(long long)r * w + c] = xl[k][s];
      }
    }
  }
}

// Column c of the inverse of L11, lanes over rows.
__device__ void inverse_warp(const Panel &p, const double *Dh,
                             const double *Dl, int ldd, volatile int *prog,
                             int c) {
  const int lane = threadIdx.x & 31, w = p.w;
  double eh[2], el[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    eh[s] = lane + 32 * s == c ? 1.0 : 0.0;
    el[s] = 0.0;
  }
  for (int j = 0; j < w; ++j) {
    wait_for(prog, j);
    const bool own = lane == (j & 31), hi = j >= 32;
    double qh, ql;
    dd_div_lane(hi ? eh[1] : eh[0], hi ? el[1] : el[0], Dh[j * ldd + j],
                Dl[j * ldd + j], own, qh, ql);
    qh = __shfl_sync(FULL, qh, j & 31);
    ql = __shfl_sync(FULL, ql, j & 31);
    if (own && hi) {
      eh[1] = qh;
      el[1] = ql;
    } else if (own) {
      eh[0] = qh;
      el[0] = ql;
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int r = lane + 32 * s;
      if (r > j && r < w)
        dd_update(eh[s], el[s], Dh[r * ldd + j], Dl[r * ldd + j], qh, ql);
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = lane + 32 * s;
    if (r < w) {
      p.Ih[r * w + c] = eh[s];
      p.Il[r * w + c] = el[s];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    dd_panel_chol_kernel(Panel p, int inv_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = p.w, ldd = w | 1;  // odd stride: a column's reads spread
  double *Dh = reinterpret_cast<double *>(smem_raw);  // [w][ldd]
  double *Dl = Dh + w * ldd;
  double *ph = Dl + w * ldd;                          // [w] pivots
  double *pl = ph + w;
  unsigned short *tri = reinterpret_cast<unsigned short *>(pl + w);
  __shared__ volatile int s_prog;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < w * w; i += THREADS) {
    const int r = i / w, c = i % w;
    Dh[r * ldd + c] = p.Sh[(long long)r * p.ld + c];
    Dl[r * ldd + c] = p.Sl[(long long)r * p.ld + c];
  }
  for (int r = warp; r < w - 1; r += FW + WK)
    for (int c = threadIdx.x & 31; c <= r; c += 32)
      tri[r * (r + 1) / 2 + c] = (unsigned short)(r << 8 | c);
  if (threadIdx.x == 0) s_prog = 0;
  __syncthreads();  // the only block barrier

  if (warp < FW) {
    const bool bad = factor_diag(Dh, Dl, ldd, ph, pl, tri, &s_prog, w);
    if (blockIdx.x != 0) return;
    if (threadIdx.x == 0) p.ok[0] = bad ? 0 : 1;
    for (int i = threadIdx.x; i < w * w; i += FW * 32) {
      const int r = i / w, c = i % w;
      p.Lh[i] = c <= r ? Dh[r * ldd + c] : 0.0;
      p.Ll[i] = c <= r ? Dl[r * ldd + c] : 0.0;
    }
    return;
  }
  const int unit = blockIdx.x * WK + warp - FW;
  if (blockIdx.x < inv_blocks) {
    if (unit < w) inverse_warp(p, Dh, Dl, ldd, &s_prog, unit);
    return;
  }
  const int r0 = w + (unit - inv_blocks * WK) * RPW;
  if (r0 < p.nr) row_warp(p, Dh, Dl, ldd, ph, pl, &s_prog, r0);
}

}  // namespace

// S [nr, w] with row stride ld (read only), L [nr, w] (written whole, zero
// above the diagonal), I [w, w], ok int[1]; nr >= w, w <= 64.
extern "C" int dd_panel_chol_launch(const double *Sh, const double *Sl,
                                    int ld, int nr, int w, double *Lh,
                                    double *Ll, double *Ih, double *Il,
                                    int *ok, void *stream) {
  static bool configured = false;
  if (nr < w || w <= 0 || w > MAXW || ld < w)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)MAXW * (MAXW | 1) * sizeof(double) +
                      2 * (size_t)MAXW * sizeof(double) +
                      (size_t)MAXW * (MAXW - 1) / 2 * sizeof(unsigned short);
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        dd_panel_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int inv_blocks = (w + WK - 1) / WK;
  const int row_units = (nr - w + RPW - 1) / RPW;
  const int grid = inv_blocks + (row_units + WK - 1) / WK;
  dd_panel_chol_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      Panel{Sh, Sl, Lh, Ll, Ih, Il, ok, ld, nr, w}, inv_blocks);
  return (int)cudaGetLastError();
}
