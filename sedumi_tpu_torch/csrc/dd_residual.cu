// Compensated residual r = rhs - M v (pcg.dd_matvec_residual), f64 and f32,
// and the refinement's fused form r = (rhs - M v) - M lo.
//
// Replaces the reference's sedumi_tpu/pcg.py:56 dd_matvec_residual, a
// lax.fori_loop over columns that splits every product M_ij v_j with
// Dekker's TwoProd and sums the high parts with TwoSum, and, with `lo`,
// the line after it in refine_solve_dd (pcg.py:96-97, r - M @ lo).
//
// Order (tests/gemv_emulation.py repeats it step for step).  A row is cut
// into `parts` parts (a power of two from 32 to 256).  A row starts `mis`
// elements past a 16-byte boundary (any storage offset, any row stride):
// its first h = (W - mis) mod W elements (at most n) are the head, then
// nv vectors of W = 16 / sizeof(T) elements read by 16-byte loads
// (double2, float4), then a tail of tl < W elements.  Part t adds head
// element t (t < h), then body vectors t, t + parts, ... in ascending
// order, each vector's elements in order, then tail element t (t < tl).
// Each element forms p + e = M_ij v_j exactly (e = fma(a, b, -p), the
// same e as Dekker's split with the dtype's Veltkamp constant), TwoSums p
// into s, sums the TwoSum errors into comp and the e terms into elo, and
// with `lo` adds the rounded M_ij lo_j into q.  The parts merge in groups
// of 32 by a shuffle tree (part l takes part l + off, off = 16 ... 1) and
// then the groups by a tree (group g takes group g + off, off = parts/64
// ... 1): a fixed order, so two calls on the same inputs give the same
// bits.  Last, d + derr = TwoSum(rhs_i, -s) and r_i = d + (derr - (comp +
// elo)), and with `lo`, r_i - q.
//
// Mapping: Q warps own a row (the fewest, up to parts / 32, that leave a
// lane at most LOADS vectors: its loads go out at once) and each lane VL =
// parts / (32 Q) parts, each a register accumulator: lane l of the row's
// warp q plays parts 32 g + j + G w (G = 32 / VL lanes a group of 32
// parts, g = q VL + l / G, j = l mod G, w < VL).  So the first log2 VL
// levels of a group's tree run in registers and the rest by shuffles;
// the groups' tree runs by shuffles in one warp, after one exchange
// through shared memory where Q > 1.  A lane issues the loads of up to
// LOADS vectors (of M, v and lo) before it sums them.  On the H100 (700
// W) two warps a row beat one where a lane would hold two batches (f64 at
// 666 and 948), one beat two where it holds one (f32 there, with lo).
// The mapping does not change the order: a part count is an order, not a
// thread count, and pcg.residual_parts picks it (the order decides where
// some solves land).
//
// Error: a part's chain holds L <= h + W ceil(nv / parts) + 1 terms and
// the tree log2(parts) levels, so |r - r_exact| <~ u |r| + O((L +
// log2 parts) u^2) sum_j |M_ij v_j| (u the unit roundoff of T), the
// reference's bound with a shorter chain; the `lo` term adds at most
// ~(L + log2 parts) u sum_j |M_ij lo_j|, as the reference's M @ lo does
// in its own order.
//
// The f64 build is K1 (the f64 phases' refinement residual), the f32 build
// K1-f32 (the f32 phase's refine_solve_dd, reference ipm.py:186).
//
// Bound on the card: memory.  It reads M once (sizeof(T) m n bytes; 3.5 MB
// at m = n = 666 in f64) and does ~11 operations per element, far below
// the card's rate; at the solver's orders one launch is ~1 us of bytes,
// so the design is about latency: every SM holds rows, every lane has
// its loads in flight at once.
//
// Build with --fmad=false: nvcc would otherwise contract the TwoSum
// sequence into fused multiply-adds and lose its error-free property.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 8 rows a block, a warp a row
constexpr int LOADS = 8;      // 16-byte vectors a lane loads at once
constexpr unsigned FULL = 0xffffffffu;

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

template <typename T> struct Vec;
template <> struct Vec<double> {
  using type = double2;
  static constexpr int W = 2;
  __device__ static double get(const double2 &x, int c) {
    return c == 0 ? x.x : x.y;
  }
};
template <> struct Vec<float> {
  using type = float4;
  static constexpr int W = 4;
  __device__ static float get(const float4 &x, int c) {
    return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
  }
};

// W elements from p: one 16-byte load where p is aligned, else W loads
template <typename T>
__device__ __forceinline__ void load_w(const T *p, bool vec,
                                       T (&out)[Vec<T>::W]) {
  if (vec) {
    const auto x = *reinterpret_cast<const typename Vec<T>::type *>(p);
#pragma unroll
    for (int c = 0; c < Vec<T>::W; ++c) out[c] = Vec<T>::get(x, c);
  } else {
#pragma unroll
    for (int c = 0; c < Vec<T>::W; ++c) out[c] = p[c];
  }
}

template <typename T>
struct Acc {
  T s, comp, elo, q;
};

template <typename T, bool LO>
__device__ __forceinline__ void add(Acc<T> &a, T m, T v, T l) {
  const T p = m * v;
  const T e = fma_t(m, v, -p);  // exact: m*v = p + e
  T t, err;
  two_sum(a.s, p, t, err);
  a.s = t;
  a.comp += err;
  a.elo += e;
  if (LO) a.q += m * l;
}

template <typename T, bool LO>
__device__ __forceinline__ void merge(Acc<T> &a, const Acc<T> &b) {
  T t, err;
  two_sum(a.s, b.s, t, err);
  a.s = t;
  a.comp = (a.comp + b.comp) + err;
  a.elo += b.elo;
  if (LO) a.q += b.q;
}

template <typename T, bool LO>
__device__ __forceinline__ void shfl_merge(Acc<T> &a, int off) {
  Acc<T> b;
  b.s = __shfl_down_sync(FULL, a.s, off);
  b.comp = __shfl_down_sync(FULL, a.comp, off);
  b.elo = __shfl_down_sync(FULL, a.elo, off);
  b.q = LO ? __shfl_down_sync(FULL, a.q, off) : T(0);
  merge<T, LO>(a, b);
}

template <typename T, bool LO, int V, int Q>
__global__ void __launch_bounds__(THREADS)
    dd_residual_kernel(const T *__restrict__ M, long long lda,
                       const T *__restrict__ v, const T *__restrict__ rhs,
                       const T *__restrict__ lo, T *__restrict__ out, int m,
                       int n) {
  using Vt = typename Vec<T>::type;
  constexpr int W = Vec<T>::W;
  constexpr int PARTS = 32 * V;
  constexpr int VL = V / Q;                        // parts a lane
  constexpr int G = 32 / VL;                       // lanes a group
  constexpr int R = VL >= LOADS ? 1 : LOADS / VL;  // rounds loaded together
  __shared__ Acc<T> red[Q > 1 ? THREADS / 32 * VL : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = warp % Q;
  const int row = blockIdx.x * (THREADS / 32 / Q) + warp / Q;
  // lane l of the row's warp q plays parts 32 g + j + G w (g = q VL + l /
  // G, j = l mod G, w < VL)
  const int p0 = 32 * (q * VL + lane / G) + lane % G;
  Acc<T> a[VL];
#pragma unroll
  for (int w = 0; w < VL; ++w) a[w] = {T(0), T(0), T(0), T(0)};
  if (row < m) {
    const T *Mr = M + (long long)row * lda;
    const int mis =
        (int)((reinterpret_cast<uintptr_t>(Mr) / sizeof(T)) & (W - 1));
    const int h = min((W - mis) & (W - 1), n);
    const int nv = (n - h) / W;
    const int tl = n - h - nv * W;
#pragma unroll
    for (int w = 0; w < VL; ++w) {
      const int t = p0 + G * w;
      if (t < h) add<T, LO>(a[w], Mr[t], v[t], LO ? lo[t] : T(0));
    }
    const Vt *Mv = reinterpret_cast<const Vt *>(Mr + h);
    const bool vv = (reinterpret_cast<uintptr_t>(v + h) & 15) == 0;
    const bool lv = LO && (reinterpret_cast<uintptr_t>(lo + h) & 15) == 0;
    // part t takes vectors t, t + PARTS, ...: R rounds of the lane's VL
    // parts are loaded before they are summed
    for (int k0 = p0; k0 < nv; k0 += R * PARTS) {
      Vt x[R][VL];
      T b[R][VL][W], l[R][VL][W];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int w = 0; w < VL; ++w) {
          const int k = k0 + r * PARTS + G * w;
          if (k < nv) {
            x[r][w] = Mv[k];
            load_w<T>(v + h + k * W, vv, b[r][w]);
            if (LO) load_w<T>(lo + h + k * W, lv, l[r][w]);
          }
        }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int w = 0; w < VL; ++w) {
          if (k0 + r * PARTS + G * w < nv) {
#pragma unroll
            for (int c = 0; c < W; ++c)
              add<T, LO>(a[w], Vec<T>::get(x[r][w], c), b[r][w][c],
                         LO ? l[r][w][c] : T(0));
          }
        }
    }
#pragma unroll
    for (int w = 0; w < VL; ++w) {
      const int t = p0 + G * w;
      if (t < tl) {
        const int j = h + nv * W + t;
        add<T, LO>(a[w], Mr[j], v[j], LO ? lo[j] : T(0));
      }
    }
  }
  // The tree of each group of 32 parts: part i takes part i + off, off =
  // 16 ... 1.  Where off >= G both are the lane's own (w and w + off / G),
  // below G the lane takes lane + off.  Then group g takes group g + off,
  // off = V / 2 ... 1: G off lanes away in one warp; with Q warps the
  // groups' sums meet in shared memory, group g in lane g of the row's
  // first warp.  Lane 0 of that warp ends with the row's sum.
#pragma unroll
  for (int off = 16; off >= G; off >>= 1) {
#pragma unroll
    for (int w = 0; w < off / G; ++w) merge<T, LO>(a[w], a[w + off / G]);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) shfl_merge<T, LO>(a[0], off);
  int step = G;
  if constexpr (Q > 1) {
    if (lane % G == 0) red[warp * VL + lane / G] = a[0];
    __syncthreads();
    if (q != 0) return;
    a[0] = lane < V ? red[(warp / Q) * V + lane]
                    : Acc<T>{T(0), T(0), T(0), T(0)};
    step = 1;
  }
#pragma unroll
  for (int off = V / 2; off > 0; off >>= 1)
    shfl_merge<T, LO>(a[0], step * off);
  if (lane == 0 && row < m) {
    T d, derr;
    two_sum(rhs[row], -a[0].s, d, derr);
    T r = d + (derr - (a[0].comp + a[0].elo));
    if (LO) r = r - a[0].q;
    out[row] = r;
  }
}

template <typename T, bool LO, int V, int Q>
void launch_vq(const T *M, long long lda, const T *v, const T *rhs,
               const T *lo, T *out, int m, int n, cudaStream_t stream) {
  constexpr int rows = THREADS / 32 / Q;
  dd_residual_kernel<T, LO, V, Q><<<(m + rows - 1) / rows, THREADS, 0,
                                    stream>>>(M, lda, v, rhs, lo, out, m, n);
}

template <typename T, bool LO, int V>
void launch_v(const T *M, long long lda, const T *v, const T *rhs,
              const T *lo, T *out, int m, int n, int q,
              cudaStream_t stream) {
  if constexpr (V >= 8)
    if (q >= 8) return launch_vq<T, LO, V, 8>(M, lda, v, rhs, lo, out, m, n,
                                              stream);
  if constexpr (V >= 4)
    if (q >= 4) return launch_vq<T, LO, V, 4>(M, lda, v, rhs, lo, out, m, n,
                                              stream);
  if constexpr (V >= 2)
    if (q >= 2) return launch_vq<T, LO, V, 2>(M, lda, v, rhs, lo, out, m, n,
                                              stream);
  launch_vq<T, LO, V, 1>(M, lda, v, rhs, lo, out, m, n, stream);
}

template <typename T, bool LO>
void launch_lo(const T *M, long long lda, const T *v, const T *rhs,
               const T *lo, T *out, int m, int n, int parts, int q,
               cudaStream_t stream) {
  switch (parts) {
    case 32:
      return launch_v<T, LO, 1>(M, lda, v, rhs, lo, out, m, n, q, stream);
    case 64:
      return launch_v<T, LO, 2>(M, lda, v, rhs, lo, out, m, n, q, stream);
    case 128:
      return launch_v<T, LO, 4>(M, lda, v, rhs, lo, out, m, n, q, stream);
    default:
      return launch_v<T, LO, 8>(M, lda, v, rhs, lo, out, m, n, q, stream);
  }
}

template <typename T>
int launch(const T *M, long long lda, const T *v, const T *rhs, const T *lo,
           T *out, int m, int n, int parts, void *stream) {
  if (parts < 32 || parts > 256 || (parts & (parts - 1)))
    return (int)cudaErrorInvalidValue;
  // warps a row: the fewest (up to parts / 32) that leave a lane at most
  // LOADS vectors, so that its loads go out at once
  const int vecs = n / Vec<T>::W;
  int q = 1;
  while (32 * q < parts && (vecs + 32 * q - 1) / (32 * q) > LOADS) q *= 2;
  if (m > 0) {
    if (lo)
      launch_lo<T, true>(M, lda, v, rhs, lo, out, m, n, parts, q,
                         (cudaStream_t)stream);
    else
      launch_lo<T, false>(M, lda, v, rhs, lo, out, m, n, parts, q,
                          (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dd_matvec_residual_launch(const double *M, long long lda,
                                         const double *v, const double *rhs,
                                         const double *lo, double *out, int m,
                                         int n, int parts, void *stream) {
  return launch<double>(M, lda, v, rhs, lo, out, m, n, parts, stream);
}

extern "C" int dd_matvec_residual_f32_launch(const float *M, long long lda,
                                             const float *v, const float *rhs,
                                             const float *lo, float *out,
                                             int m, int n, int parts,
                                             void *stream) {
  return launch<float>(M, lda, v, rhs, lo, out, m, n, parts, stream);
}
