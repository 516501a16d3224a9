// One panel of the double-double Cholesky, and the dd inverse of its
// diagonal block (ddlinalg.dd_panel_chol).
//
// Replaces the reference's sedumi_tpu/ddlinalg.py:166-183 (dd_chol's
// column loop over one nb-wide panel, numpy on the host) and :186-206 (the
// dd inverse of the panel's diagonal block).  Input: the panel S [nr, w]
// after the left-looking trailing update, as a dd pair.  Column j:
//   d   = S_jj; if not (d_h > 0): d = (max(|d_h|, 1e-300), 0), ok = 0
//         (NaN stays NaN, as Python's max keeps it)
//   s   = dd_sqrt(d);  L_rj = dd_div(S_rj, s)  (r >= j)
//   S_rc -= L_rj L_cj in dd (r > j, j < c < w): TwoProd of the highs,
//           lows (pe + a_h b_l) + a_l b_h, then dd_sub.
// The inverse rows of L11 follow by dd forward substitution on E = I.
//
// Design.  The w x w diagonal block (48 x 48 dd = 36 KB) is factored in
// shared memory by every block of the grid, so each block holds L11 and
// the pivots without waiting for another one (the redundant work is
// ~w^3/6 dd updates per block, a few blocks per panel).  Block 0 writes
// L11 and computes the inverse in shared memory; blocks 1.. give one
// thread to each row below the diagonal block, which runs the same j loop
// against L11 on its own row in device memory.  Only the lower triangle of
// the diagonal block is updated: an entry's update reads only its own row's
// and column's multipliers, so the upper entries never reach L.  TwoProd
// is fma(a, b, -p), the same exact (p, e) as the reference's Dekker split;
// division and sqrt are correctly rounded; every other operation and its
// association is the reference's, so L and the inverse match the plain
// version bit for bit.
//
// Bound on the card: latency.  w sequential columns with three barriers
// each; ~nr w^2 / 2 dd updates (1.4e6 at nr = 1200), far below the f64
// rate and bytes.
//
// Build with --fmad=false: TwoSum and the dd products must round as
// written.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // rows below the diagonal block per block

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
  const double q1 = ah / bh;
  double ph, pl, rh, rl;
  dd_mul_hi(q1, bh, bl, ph, pl);
  dd_sub(ah, al, ph, pl, rh, rl);
  const double q2 = (rh + rl) / bh;
  two_sum(q1, q2, h, l);
}

__device__ __forceinline__ void dd_sqrt(double ah, double al, double &h,
                                        double &l) {
  const double s = sqrt(np_max(ah, 0.0));
  double ph, pl, rh, rl;
  two_prod(s, s, ph, pl);
  dd_sub(ah, al, ph, pl, rh, rl);
  const double e = (rh + rl) / np_max(2.0 * s, 1e-300);
  two_sum(s, e, h, l);
}

// S_rc -= a b in dd, a = L_rj, b = L_cj
__device__ __forceinline__ void dd_update(double &sh, double &sl, double ah,
                                          double al, double bh, double bl) {
  double ph, pe;
  two_prod(ah, bh, ph, pe);
  const double pl = (pe + ah * bl) + al * bh;
  dd_sub(sh, sl, ph, pl, sh, sl);
}

__global__ void dd_panel_chol_kernel(double *__restrict__ Sh,
                                     double *__restrict__ Sl, int nr, int w,
                                     double *__restrict__ Lh,
                                     double *__restrict__ Ll,
                                     double *__restrict__ Ih,
                                     double *__restrict__ Il,
                                     int *__restrict__ ok) {
  extern __shared__ double smem[];
  double *Dh = smem;          // [w][w] diagonal block -> L11 (lower)
  double *Dl = Dh + w * w;
  double *ph = Dl + w * w;    // [w] dd sqrt of the pivots
  double *pl = ph + w;
  double *Eh = pl + w;        // [w][w] inverse work (block 0)
  double *El = Eh + w * w;
  __shared__ int s_bad;
  const int tid = threadIdx.x;

  for (int i = tid; i < w * w; i += THREADS) {
    Dh[i] = Sh[i];
    Dl[i] = Sl[i];
  }
  if (tid == 0) s_bad = 0;
  __syncthreads();
  for (int j = 0; j < w; ++j) {
    if (tid == 0) {
      double dh = Dh[j * w + j], dl = Dl[j * w + j];
      if (!(dh > 0.0)) {
        const double v = fabs(dh);
        dh = (1e-300 > v) ? 1e-300 : v;
        dl = 0.0;
        s_bad = 1;
      }
      dd_sqrt(dh, dl, ph[j], pl[j]);
    }
    __syncthreads();
    for (int r = j + tid; r < w; r += THREADS)
      dd_div(Dh[r * w + j], Dl[r * w + j], ph[j], pl[j], Dh[r * w + j],
             Dl[r * w + j]);
    __syncthreads();
    const int n = w - j - 1;
    for (int idx = tid; idx < n * n; idx += THREADS) {
      const int r = j + 1 + idx / n, c = j + 1 + idx % n;
      if (c <= r)
        dd_update(Dh[r * w + c], Dl[r * w + c], Dh[r * w + j],
                  Dl[r * w + j], Dh[c * w + j], Dl[c * w + j]);
    }
    __syncthreads();
  }

  if (blockIdx.x == 0) {
    if (tid == 0 && s_bad) ok[0] = 0;
    for (int i = tid; i < w * w; i += THREADS) {
      const int r = i / w, c = i % w;
      if (c <= r) {
        Lh[i] = Dh[i];
        Ll[i] = Dl[i];
      }
      Eh[i] = (r == c) ? 1.0 : 0.0;
      El[i] = 0.0;
    }
    __syncthreads();
    for (int j = 0; j < w; ++j) {
      for (int c = tid; c < w; c += THREADS)
        dd_div(Eh[j * w + c], El[j * w + c], Dh[j * w + j], Dl[j * w + j],
               Eh[j * w + c], El[j * w + c]);
      __syncthreads();
      for (int idx = tid; idx < (w - j - 1) * w; idx += THREADS) {
        const int r = j + 1 + idx / w, c = idx % w;
        dd_update(Eh[r * w + c], El[r * w + c], Dh[r * w + j], Dl[r * w + j],
                  Eh[j * w + c], El[j * w + c]);
      }
      __syncthreads();
    }
    for (int i = tid; i < w * w; i += THREADS) {
      Ih[i] = Eh[i];
      Il[i] = El[i];
    }
    return;
  }

  const int r = w + (blockIdx.x - 1) * THREADS + tid;
  if (r >= nr) return;
  double *srh = Sh + (long long)r * w;
  double *srl = Sl + (long long)r * w;
  double *lrh = Lh + (long long)r * w;
  double *lrl = Ll + (long long)r * w;
  for (int j = 0; j < w; ++j) {
    double ah, al;
    dd_div(srh[j], srl[j], ph[j], pl[j], ah, al);
    lrh[j] = ah;
    lrl[j] = al;
    for (int c = j + 1; c < w; ++c) {
      double sh = srh[c], sl = srl[c];
      dd_update(sh, sl, ah, al, Dh[c * w + j], Dl[c * w + j]);
      srh[c] = sh;
      srl[c] = sl;
    }
  }
}

}  // namespace

// S [nr, w] (overwritten), L [nr, w] (zero above the diagonal on entry),
// I [w, w], ok int[1] (1 on entry); w <= 64.
extern "C" int dd_panel_chol_launch(double *Sh, double *Sl, int nr, int w,
                                    double *Lh, double *Ll, double *Ih,
                                    double *Il, int *ok, void *stream) {
  static size_t configured = 0;
  if (nr <= 0 || w <= 0) return (int)cudaGetLastError();
  const size_t smem = (4 * (size_t)w * w + 2 * (size_t)w) * sizeof(double);
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        dd_panel_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  const int below = nr > w ? nr - w : 0;
  const int grid = 1 + (below + THREADS - 1) / THREADS;
  dd_panel_chol_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      Sh, Sl, nr, w, Lh, Ll, Ih, Il, ok);
  return (int)cudaGetLastError();
}
