// Masked LDL' with SeDuMi's pivot add/skip semantics (chol.ldl_masked).
//
// Replaces the reference's sedumi_tpu/chol.py:95 ldl_masked, a
// lax.fori_loop over columns with masked arithmetic (blkchol2.c
// semantics).  Column j:
//   lb   = canceltol * absd_j + abstol
//   d_j  = lb if a_jj < lb (cancellation add, diagadd_j = lb - a_jj)
//   col  = A[j+1:, j] / d_j
//   skip = skip_pivots && max|col| > maxu   -> col = 0, d_j = inf
//   A[r, c] -= d_j * (col_r * col_c)  (r >= c > j),  absd_r += d_j col_r^2
// (a non-finite d_j updates with 0; max|col| propagates NaN like jnp.max,
// so a NaN in the column means no skip).  The f64 build is K3; the f32
// build, K3-f32, is the f32 phase's fallback (reference ipm.py:127-132
// with an f32 Schur complement): the same template, with canceltol, maxu
// and abstol rounded to T first, as the reference's weakly typed scalars
// are.
//
// Bound on the card: the column chain.  The work is ~m^3/6 updates (under
// 10 us of one SM's f64 rate at m = 174), but column j + 1's pivot waits
// for column j's last update, pivot, quotients, maximum and skip decision:
// m dependent steps of ~0.6-0.9 us on an H100 (parent_bench.py --cases
// ldl; PERF.md).
//
// The bits.  Each trailing entry (r, c) receives its updates j = 0, 1, ...,
// c - 1 in that order, each as a - w_j * (col_r * col_c) (no fused
// multiply-add under --fmad=false), and column j is divided only after all
// of its own updates.  Any schedule that keeps this gives the plain
// version's L, d, skip and diagadd bit for bit.  w_j is d_j, 0 for a
// non-finite d_j, and 0 with col = 0 for a skipped column, whose update
// the plain version applies as a - 0 * (0 * 0): an exact no-op, so no
// update branches on the skip.  Every quotient is RN(x / d_j), by the
// division or by Div's reciprocal rule (Markstein's theorem, in its safe
// range); max|col| is RN(max|x| / |d_j|) (rounding is monotone; d_j = 0
// takes the quotients' own maximum), the maxima taken over bit patterns
// (|x| orders as an unsigned integer, NaN above +inf), so NaN still means
// no skip.
//
// Design: left-looking, a column a warp at a time; no block barrier sits
// on a column's chain.  Column c belongs to warp c mod nw (nw warps in
// all).  The warp loads column c of M into registers (lane l the rows r
// = l mod 32; the absd sum in every lane), applies each published column
// j < c to it as soon as a progress counter shows it (all that are out in
// one batch: loads of col_r only, the column's entries never leave the
// registers), and once column c - 1 is in, finalizes it: the pivot and
// the add rule (the diagonal by shuffle), the largest |x| by an integer
// reduction (redux.sync) while the reciprocal is formed, every quotient
// of the lane at once, the skip; it writes col and w_c into
// column c of a packed lower triangle (column c at c m - c (c-1)/2,
// integer offsets, w_c in the diagonal slot) and bumps the counter.  L is
// written out from the triangle, with zeros above and a unit diagonal,
// once every column is published.  The kernel reads M through its row
// stride and never writes it.  Variants (chol.ldl_plan):
//   * warp (m <= 32): one warp, lane r holds row r in registers and the
//     columns pass by shuffle; no shared memory and no barrier;
//   * shared: one block, the triangle in shared memory (f64 up to m = 240,
//     f32 up to 340: one register chunk of a column covers it);
//   * device: a cooperative grid, the triangle in a device-memory scratch
//     (read and written through L2: __ldcg/__stcg), the counter in device
//     memory; a column longer than one register chunk keeps its entries in
//     the warp's shared memory between batches.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "div_rn.cuh"

namespace {

using dense::Div;   // quotients by Div's reciprocal rule (div_rn.cuh)

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;  // shared memory a block may use

template <typename T>
struct Bits;

template <>
struct Bits<double> {
  using U = unsigned long long;
  static constexpr int RC = 8;    // row slots of a register chunk
  static __device__ __forceinline__ U abs_bits(double x) {
    return (U)__double_as_longlong(fabs(x));
  }
  static __device__ __forceinline__ double value(U u) {
    return __longlong_as_double((long long)u);
  }
  static __device__ __forceinline__ U warp_max(U u) {
    const unsigned hi = (unsigned)(u >> 32);
    const unsigned hm = __reduce_max_sync(FULL, hi);
    const unsigned lm = __reduce_max_sync(FULL, hi == hm ? (unsigned)u : 0u);
    return ((U)hm << 32) | lm;
  }
  static __device__ __forceinline__ double inf() { return CUDART_INF; }
};

template <>
struct Bits<float> {
  using U = unsigned;
  static constexpr int RC = 11;
  static __device__ __forceinline__ U abs_bits(float x) {
    return __float_as_uint(fabsf(x));
  }
  static __device__ __forceinline__ float value(U u) {
    return __uint_as_float(u);
  }
  static __device__ __forceinline__ U warp_max(U u) {
    return __reduce_max_sync(FULL, u);
  }
  static __device__ __forceinline__ float inf() { return CUDART_INF_F; }
};

template <typename T>
struct Args {
  const T *M;        // read through its row stride ld, never written
  long long ld;
  T *L, *d, *diagadd;
  unsigned char *skip;
  T *tri;            // device variant: the packed triangle's scratch
  int *prog;         // device variant: the progress counter, zero at launch
  int m, skip_pivots;
  T canceltol, maxu, abstol;
};

// the triangle in shared memory, or in device memory through L2
struct SharedMem {
  template <typename T>
  static __device__ __forceinline__ T ld(const T *p) { return *p; }
  template <typename T>
  static __device__ __forceinline__ void st(T *p, T v) { *p = v; }
  static __device__ __forceinline__ void fence() { __threadfence_block(); }
};

struct DeviceMem {
  template <typename T>
  static __device__ __forceinline__ T ld(const T *p) { return __ldcg(p); }
  template <typename T>
  static __device__ __forceinline__ void st(T *p, T v) { __stcg(p, v); }
  static __device__ __forceinline__ void fence() { __threadfence(); }
};

// column c of the packed triangle, indexed by row (rows c .. m-1); 32-bit
// offsets (m < 65536)
template <typename T>
__device__ __forceinline__ T *column(T *tri, int c, int m) {
  const unsigned u = c;
  return tri + (u * m - u * (u - 1) / 2 - u);
}

// Published columns [j0, j1) applied, in order, to the rows 32 (s + i) +
// lane (i < RC, below m) of column c held in x; ab takes the absd terms
// when `diag` (once a column).
template <typename T, typename Mem, int RC>
__device__ __forceinline__ void apply(const T *tri, T (&x)[RC], T &ab,
                                      bool diag, int s, int c, int j0,
                                      int j1, int m, int lane) {
#pragma unroll 2
  for (int j = j0; j < j1; ++j) {
    const T *colj = column(tri, j, m);
    const T w = Mem::ld(colj + j), lc = Mem::ld(colj + c);
    if (diag) ab = ab + w * (lc * lc);
    T l[RC];
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const int r = 32 * (s + i) + lane;
      l[i] = r < m ? Mem::ld(colj + r) : T(0);
    }
#pragma unroll
    for (int i = 0; i < RC; ++i) x[i] = x[i] - w * (l[i] * lc);
  }
}

// Wait until more than j columns are published; the count, the same in
// every lane, each lane having read at least it and fenced.
template <typename Mem>
__device__ __forceinline__ int wait_past(volatile int *prog, int j) {
  int p;
  while ((p = *prog) <= j) {
  }
  p = __reduce_min_sync(FULL, p);
  Mem::fence();
  return p;
}

// The pivot of column c from its updated diagonal acc and absd ab: d_j and
// the add.
template <typename T>
struct Pivot {
  T dj, add;
  __device__ __forceinline__ Pivot(const Args<T> &a, T acc, T ab) {
    const T lb = a.canceltol * ab + a.abstol;
    const bool canc = acc < lb;
    dj = canc ? lb : acc;
    add = canc ? lb - acc : T(0);
  }
};

// Publish column c (its col already stored): w_c in the diagonal slot,
// the counter, then d, skip and diagadd.
template <typename T, typename Mem>
__device__ __forceinline__ void publish(const Args<T> &a, T *colc,
                                        volatile int *prog, int c,
                                        const Pivot<T> &pv, bool sk,
                                        int lane) {
  if (lane == 0)
    Mem::st(colc + c, sk ? T(0) : (isfinite(pv.dj) ? pv.dj : T(0)));
  Mem::fence();
  __syncwarp();
  if (lane == 0) {
    *prog = c + 1;
    a.d[c] = sk ? Bits<T>::inf() : pv.dj;
    a.skip[c] = (unsigned char)sk;
    a.diagadd[c] = pv.add;
  }
}

// Column c by this warp, held in registers: NL row slots from 32 (c / 32)
// cover its rows.
template <typename T, typename Mem, int NL>
__device__ __forceinline__ void build_column(const Args<T> &a, T *tri,
                                             volatile int *prog, int c,
                                             int lane) {
  using B = Bits<T>;
  const int m = a.m, s = c >> 5;
  T x[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int r = 32 * (s + i) + lane;
    x[i] = r >= c && r < m ? a.M[r * a.ld + c] : T(0);
  }
  T ab = fabs(a.M[c * a.ld + c]);
  for (int j = 0; j < c;) {
    const int p = min(wait_past<Mem>(prog, j), c);
    apply<T, Mem, NL>(tri, x, ab, true, s, c, j, p, m, lane);
    j = p;
  }
  const Pivot<T> pv(a, __shfl_sync(FULL, x[0], c & 31), ab);   // row c
  // the lane's largest and least nonzero |x| (bit patterns: NaN above
  // +inf); the column's largest by a reduction that overlaps the
  // reciprocal
  typename B::U mx = 0, mn = B::abs_bits(B::inf());
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int r = 32 * (s + i) + lane;
    const typename B::U b = B::abs_bits(x[i]);
    if (r > c && r < m) {
      mx = max(mx, b);
      if (b) mn = min(mn, b);
    }
  }
  const Div<T> div(pv.dj);
  const bool fast = __all_sync(FULL, div.fast_for(B::value(mn),
                                                  B::value(mx)));
  const T xmax = B::value(B::warp_max(mx));
  // max|col| = RN(max|x| / |d|): rounding is monotone, so for d != 0 the
  // largest |quotient| is that of the largest |x| (NaN and inf come out
  // the same); for d == 0 (0 / 0 = NaN may sit below it) the quotients'
  T q[NL], qmax;
  if (fast) {
#pragma unroll
    for (int i = 0; i < NL; ++i) q[i] = div.fast(x[i]);
    qmax = fabs(div.fast(xmax));
  } else {
#pragma unroll
    for (int i = 0; i < NL; ++i) q[i] = x[i] / pv.dj;
    qmax = fabs(xmax / pv.dj);
    if (pv.dj == T(0)) {
      typename B::U mq = 0;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int r = 32 * (s + i) + lane;
        if (r > c && r < m) mq = max(mq, B::abs_bits(q[i]));
      }
      qmax = B::value(B::warp_max(mq));
    }
  }
  const bool sk = a.skip_pivots && qmax > a.maxu;
  T *colc = column(tri, c, m);
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int r = 32 * (s + i) + lane;
    if (r > c && r < m) Mem::st(colc + r, sk ? T(0) : q[i]);
  }
  publish<T, Mem>(a, colc, prog, c, pv, sk, lane);
}

// build_column with NL = the slots column c needs (1 .. RC)
template <typename T, typename Mem, int NL = Bits<T>::RC>
__device__ __forceinline__ void build_column_fit(const Args<T> &a, T *tri,
                                                 volatile int *prog, int c,
                                                 int lane, int nl) {
  if constexpr (NL > 1) {
    if (nl < NL) {
      build_column_fit<T, Mem, NL - 1>(a, tri, prog, c, lane, nl);
      return;
    }
  }
  build_column<T, Mem, NL>(a, tri, prog, c, lane);
}

// Column c by this warp in register chunks of RC row slots, its entries
// kept in buf (m entries of the warp's shared memory) between batches.
template <typename T, typename Mem>
__device__ __forceinline__ void build_column_chunked(const Args<T> &a,
                                                     T *tri, T *buf,
                                                     volatile int *prog,
                                                     int c, int lane) {
  using B = Bits<T>;
  constexpr int RC = B::RC;
  const int m = a.m, s0 = c >> 5, R = (m + 31) >> 5;
  for (int r0 = 32 * s0; r0 < m; r0 += 32) {
    const int r = r0 + lane;
    if (r >= c && r < m) buf[r] = a.M[r * a.ld + c];
  }
  T ab = fabs(a.M[c * a.ld + c]);
  for (int j = 0; j < c;) {
    const int p = min(wait_past<Mem>(prog, j), c);
    for (int s = s0; s < R; s += RC) {
      T x[RC];
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        const int r = 32 * (s + i) + lane;
        x[i] = r >= c && r < m ? buf[r] : T(0);
      }
      apply<T, Mem, RC>(tri, x, ab, s == s0, s, c, j, p, m, lane);
#pragma unroll
      for (int i = 0; i < RC; ++i) {
        const int r = 32 * (s + i) + lane;
        if (r >= c && r < m) buf[r] = x[i];
      }
    }
    j = p;
  }
  __syncwarp();
  const Pivot<T> pv(a, buf[c], ab);
  const Div<T> div(pv.dj);
  T *colc = column(tri, c, m);
  typename B::U mx = 0;
  for (int r0 = 32 * s0; r0 < m; r0 += 32) {
    const int r = r0 + lane;
    if (r > c && r < m) {
      const T q = div(buf[r]);
      Mem::st(colc + r, q);
      mx = max(mx, B::abs_bits(q));
    }
  }
  const bool sk = a.skip_pivots && B::value(B::warp_max(mx)) > a.maxu;
  if (sk)
    for (int r0 = 32 * s0; r0 < m; r0 += 32) {
      const int r = r0 + lane;
      if (r > c && r < m) Mem::st(colc + r, T(0));
    }
  publish<T, Mem>(a, colc, prog, c, pv, sk, lane);
}

// rows g, g + nw, ... of L from the finished triangle
template <typename T, typename Mem>
__device__ __forceinline__ void write_l(const Args<T> &a, T *tri, int g,
                                        int nw, int lane) {
  const int m = a.m;
  for (int r = g; r < m; r += nw)
    for (int c = lane; c < m; c += 32)
      a.L[(long long)r * m + c] =
          c < r ? Mem::ld(column(tri, c, m) + r) : T(c == r ? 1 : 0);
}

template <typename T>
__global__ void __launch_bounds__(32) ldl_warp_kernel(Args<T> a) {
  using B = Bits<T>;
  const int r = threadIdx.x, m = a.m;
  const bool live = r < m;
  T row[32];
#pragma unroll
  for (int c = 0; c < 32; ++c)
    row[c] = (live && c <= r) ? a.M[r * a.ld + c] : T(0);
  T ab = live ? fabs(a.M[r * a.ld + r]) : T(0);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j >= m) break;
    const T ajj = __shfl_sync(FULL, row[j], j);
    const T abj = __shfl_sync(FULL, ab, j);
    const T lb = a.canceltol * abj + a.abstol;
    const bool canc = ajj < lb;
    const T dj = canc ? lb : ajj;
    const bool below = live && r > j;
    T q = below ? row[j] / dj : T(0);
    const typename B::U mx = B::warp_max(below ? B::abs_bits(q) : 0);
    const bool sk = a.skip_pivots && B::value(mx) > a.maxu;
    if (r == 0) {
      a.d[j] = sk ? B::inf() : dj;
      a.skip[j] = (unsigned char)sk;
      a.diagadd[j] = canc ? lb - ajj : T(0);
    }
    if (sk) {
      q = T(0);
    } else {
      const T djf = isfinite(dj) ? dj : T(0);
      if (below) ab = ab + djf * (q * q);
#pragma unroll
      for (int c = j + 1; c < 32; ++c) {
        if (c >= m) break;
        row[c] = row[c] - djf * (q * __shfl_sync(FULL, q, c));
      }
    }
    if (below) row[j] = q;
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < 32; ++c)
      if (c < m) a.L[r * m + c] = c < r ? row[c] : T(c == r ? 1 : 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(512, 1) ldl_shared_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = a.m;
  T *tri = reinterpret_cast<T *>(smem);
  volatile int *prog =
      reinterpret_cast<volatile int *>(tri + (long long)m * (m + 1) / 2);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (threadIdx.x == 0) *prog = 0;
  __syncthreads();
  for (int c = w; c < m; c += nw)
    build_column_fit<T, SharedMem>(a, tri, prog, c, lane,
                                   ((m + 31) >> 5) - (c >> 5));
  __syncthreads();
  write_l<T, SharedMem>(a, tri, w, nw, lane);
}

template <typename T>
__global__ void __launch_bounds__(256, 1) ldl_device_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = a.m;
  const int lane = threadIdx.x & 31, wb = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int nw = gridDim.x * wb, g = blockIdx.x * wb + w;
  T *buf = reinterpret_cast<T *>(smem) + (long long)w * m;
  volatile int *prog = a.prog;
  for (int c = g; c < m; c += nw) {
    const int nl = ((m + 31) >> 5) - (c >> 5);   // the column's row slots
    if (nl <= Bits<T>::RC)
      build_column_fit<T, DeviceMem>(a, a.tri, prog, c, lane, nl);
    else
      build_column_chunked<T, DeviceMem>(a, a.tri, buf, prog, c, lane);
  }
  while (*prog < m) __nanosleep(200);
  __threadfence();
  write_l<T, DeviceMem>(a, a.tri, g, nw, lane);
}

// lift a kernel's dynamic shared memory limit, once per (T, variant)
template <typename T, int V>
int allow_smem(const void *kernel) {
  static bool done = false;
  if (!done) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  return 0;
}

// variant: 0 warp, 1 shared, 2 device (chol.LDL_VARIANTS)
template <typename T>
int launch(const T *M, long long ld, T *L, T *d, unsigned char *skip,
           T *diagadd, T *tri, int *prog, int m, double canceltol,
           double maxu, double abstol, int skip_pivots, int variant,
           int blocks, int warps, void *stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  Args<T> a{M, ld, L, d, diagadd, skip, tri, prog, m, skip_pivots,
            (T)canceltol, (T)maxu, (T)abstol};
  if (m < 1 || m >= 65536 || blocks < 1 || warps < 1)
    return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    if (m > 32 || blocks != 1 || warps != 1)
      return (int)cudaErrorInvalidValue;
    ldl_warp_kernel<T><<<1, 32, 0, s>>>(a);
  } else if (variant == 1) {
    // one register chunk must hold a column
    if (blocks != 1 || m > 32 * Bits<T>::RC)
      return (int)cudaErrorInvalidValue;
    const int e = allow_smem<T, 1>((const void *)ldl_shared_kernel<T>);
    if (e) return e;
    const size_t bytes = sizeof(T) * ((size_t)m * (m + 1) / 2) + sizeof(int);
    ldl_shared_kernel<T><<<1, 32 * warps, bytes, s>>>(a);
  } else if (variant == 2) {
    if (!tri || !prog) return (int)cudaErrorInvalidValue;
    const int e = allow_smem<T, 2>((const void *)ldl_device_kernel<T>);
    if (e) return e;
    void *args[] = {&a};
    const cudaError_t e2 = cudaLaunchCooperativeKernel(
        (const void *)ldl_device_kernel<T>, dim3(blocks), dim3(32 * warps),
        args, sizeof(T) * (size_t)m * warps, s);
    const cudaError_t last = cudaGetLastError();   // a refusal is not kept
    return (int)(e2 != cudaSuccess ? e2 : last);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ldl_masked_launch(const double *M, long long ld, double *L,
                                 double *d, unsigned char *skip,
                                 double *diagadd, double *tri, int *prog,
                                 int m, double canceltol, double maxu,
                                 double abstol, int skip_pivots, int variant,
                                 int blocks, int warps, void *stream) {
  return launch<double>(M, ld, L, d, skip, diagadd, tri, prog, m, canceltol,
                        maxu, abstol, skip_pivots, variant, blocks, warps,
                        stream);
}

extern "C" int ldl_masked_f32_launch(const float *M, long long ld, float *L,
                                     float *d, unsigned char *skip,
                                     float *diagadd, float *tri, int *prog,
                                     int m, double canceltol, double maxu,
                                     double abstol, int skip_pivots,
                                     int variant, int blocks, int warps,
                                     void *stream) {
  return launch<float>(M, ld, L, d, skip, diagadd, tri, prog, m, canceltol,
                       maxu, abstol, skip_pivots, variant, blocks, warps,
                       stream);
}
