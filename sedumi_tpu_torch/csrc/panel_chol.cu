// K14: one block column of the distributed block-cyclic Cholesky
// (parallel/panels.dist_cholesky).
//
// Replaces the per-block-column body of the reference's
// sedumi_tpu/parallel/panels.py:dist_cholesky (:75-87): given the block
// column j gathered from every rank in natural block order, C [nb, bs, bs],
//   Ljj     = chol(C[j])                     (lower; NaN if not PD)
//   Lcol[k] = C[k] Ljj^-T  for k > j,  Ljj for k = j,  0 for k < j,
// and NaN from block j on when C[j] is not positive definite (a pivot not
// in (0, inf): the event at which LAPACK's potrf stops and
// jnp.linalg.cholesky returns NaN).  The reference multiplies by an
// explicit inverse; K14 solves against Ljj, which rounds otherwise (within
// 1e-12 of max|L| of the plain version; chip_smoke.PANEL_TOL).  The
// trailing GEMM update and the strict-upper zeroing stay torch.
//
// Bound on the card: latency.  At OH's shapes (bs = 128, nb = 8) a column
// moves ~2 MiB (0.6 us at 3.35 TB/s) and does ~2.7 Mflop per block; what
// sets the time is the chain of bs dependent pivots (a square root and a
// division each) and, below the diagonal, each row's chain of bs
// dependent divisions, plus the barriers between the steps.
//
// Design: two launches a column, K8's pieces (tri_factor.cuh) without
// its escalation rungs.
//  (a) panel_diag: one block of 256 threads factors C[j]'s lower triangle
//      in shared memory (cp.async), in panels of 32 columns with two block
//      barriers a panel and none inside it (chol_panels): warp 0 factors
//      the panel's triangle while three warps, a thread a row, solve the
//      rows below against it a column behind (a progress counter in shared
//      memory), then the rank-32 update of the trailing triangle (SYRK, 16
//      x 16 threads on strided register blocks).  It writes Lcol[j] (zeros
//      above the diagonal), or all NaN when a pivot failed.
//  (b) panel_off: one block of 128 threads per (block k, 32-row chunk):
//      k > j solves X = C[k] Ljj^-T for the chunk as K8's off tiles are
//      solved (Ljj packed by rows in shared memory, a warp per eight rows,
//      no barrier between warps); k < j writes 0; k = j is (a)'s; a NaN
//      Ljj (a failed block) makes the chunk NaN.
// Every entry receives its updates one product at a time in k order, then
// its division or square root: tests/panel_emulation.py repeats the
// kernels bit for bit.  Divisions go through div_pos (a zero numerator
// takes the card's slow path).  bs <= 128.  On the card a dependent
// division costs ~125 cycles and a square root ~90 (clock64 probes), and a
// pivot of (a) ~1100 with its dot product and the hand-off: (a)'s four
// 32-pivot chains and (b)'s 128-column chain set K14's time.
//
// Both kernels are templates over the element type: the f64 build is K14,
// the f32 build K14-f32 (the f32 phase of the precision ladder under a
// mesh).  Nothing in them is fixed for double: the shared memory is sized
// by sizeof(Real) (half in f32; bs <= 128 fits either way), cp.async
// copies one element at a time (4 bytes in f32, which it takes), the
// pivot test compares with the type's own infinity, and division and
// square root are IEEE-rounded in both types (nvcc's default -prec-div
// and -prec-sqrt, no fast math), so the emulation run in float32 repeats
// K14-f32 bit for bit.

#include "tri_factor.cuh"

namespace {

using namespace dense;

// Blocked Cholesky of the B x B lower triangle of A (row stride LD), in
// place, by FACTOR_THREADS threads.  Returns false, uniformly over the
// block, when a pivot of a panel was not in (0, inf).  Per panel of 32
// columns (entries left of it updated by the earlier panels' SYRKs):
//  (1) warp 0 factors the panel's triangle, left-looking, a lane a row:
//      for column c every lane i >= c forms A[i][c] - L[i][k] L[c][k]
//      over k < c in order, lane c's value is the pivot (its square root
//      L[c][c]), the lanes below divide by it; then it publishes the
//      column (s_prog = c + 1);
//  (2) meanwhile warps 1-3, a thread a row below the panel, solve their
//      rows against the triangle left-looking, column t once s_prog > t,
//      so they follow warp 0 a column behind with no block barrier;
//  (3) after one barrier, the rank-32 update of the trailing triangle.
// Every entry gets its products one at a time in k order, then its
// division or square root: the order of a scalar right-looking factor.
// The column loops run at run time on shared memory, each dot product
// unrolled over the panel (its loads all in flight before its chain of
// subtractions): the code stays small enough for the instruction cache
// (fully unrolled register forms of (1) and (2) evicted each other and
// ran slower).
template <typename Real>
__device__ bool chol_panels(Real *A, int B) {
  __shared__ int s_bad;
  __shared__ volatile int s_prog;   // columns of the panel published
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_prog = 0;
  __syncthreads();
  for (int p0 = 0; p0 < B; p0 += PANEL) {
    const int P = min(PANEL, B - p0), e = p0 + P;
    const int i = warp == 0 ? p0 + lane : e + (int)threadIdx.x - 32;
    Real *Ai = A + i * LD + p0;       // this thread's row of the panel
    if (warp == 0) {
      const bool mine = lane < P;
      bool good = true;
      for (int c = 0; c < P; ++c) {
        const Real *Lc = A + (p0 + c) * LD + p0;
        Real v = 0;
        if (mine && lane >= c) {
          v = Ai[c];
#pragma unroll
          for (int k = 0; k < PANEL; ++k)
            if (k < c) v = v - Ai[k] * Lc[k];
        }
        const Real piv = __shfl_sync(FULL, v, c);
        good = good && piv > Real(0) && piv < (Real)INFINITY;
        const Real ljj = sqrt_t(piv);
        if (mine && lane >= c) Ai[c] = lane == c ? ljj : div_pos(v, ljj);
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          s_prog = c + 1;
        }
      }
      if (lane == 0) s_bad = !good;
    } else if (warp <= 3 && i < B) {
      const Real *Lt = A + p0 * LD + p0;   // L[p0 + t][p0 + c] at t LD + c
      for (int t = 0; t < P; ++t) {
        while (s_prog <= t) {
        }
        __threadfence_block();
        Real v = Ai[t];
#pragma unroll
        for (int c = 0; c < PANEL; ++c)
          if (c < t) v = v - Ai[c] * Lt[t * LD + c];
        Ai[t] = div_pos(v, Lt[t * LD + t]);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) s_prog = 0;   // read by nobody until the barrier
    if (s_bad) return false;
    if (e >= B) break;
    trailing_syrk(A, B, p0, e);
    __syncthreads();
  }
  return true;
}

__device__ __forceinline__ double nan_t(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}
__device__ __forceinline__ float nan_t(float) {
  return __int_as_float(0x7fc00000);
}

template <typename Real>
__global__ void __launch_bounds__(FACTOR_THREADS)
panel_diag_kernel(const Real *__restrict__ C, int bs, int j,
                  Real *__restrict__ Lcol) {
  extern __shared__ __align__(16) unsigned char smem[];
  Real *A = reinterpret_cast<Real *>(smem);   // bs rows of stride LD
  const size_t BB = (size_t)bs * bs;
  load_lower(C + j * BB, A, bs);
  __syncthreads();
  const bool ok = chol_panels(A, bs);
  Real *out = Lcol + j * BB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < bs; r += FACTOR_THREADS / 32)
    for (int c = lane; c < bs; c += 32)
      out[r * bs + c] = ok ? (c <= r ? A[r * LD + c] : Real(0))
                           : nan_t(Real(0));
}

template <typename Real>
__global__ void __launch_bounds__(OFF_THREADS)
panel_off_kernel(const Real *__restrict__ C, int bs, int j,
                 Real *__restrict__ Lcol) {
  extern __shared__ __align__(16) unsigned char smem[];
  Real *Lp = reinterpret_cast<Real *>(smem);   // Ljj[c][k] at tri(c) + k
  __shared__ Real X[OFF_ROWS * LD];             // X[r][c] at r LD + c
  const int nq = (bs + OFF_ROWS - 1) / OFF_ROWS;
  const int k = blockIdx.x / nq, r0 = (blockIdx.x % nq) * OFF_ROWS;
  const int R = min(OFF_ROWS, bs - r0);
  const size_t BB = (size_t)bs * bs;
  Real *out = Lcol + k * BB + (size_t)r0 * bs;
  if (k == j) return;
  const Real *Ld = Lcol + j * BB;
  // a failed diagonal block is all NaN; a factored one starts with a
  // pivot's square root
  if (k < j || isnan(Ld[0])) {
    const Real v = k < j ? Real(0) : nan_t(Real(0));
    for (int t = threadIdx.x; t < R * bs; t += OFF_THREADS) out[t] = v;
    return;
  }
  stage(Ld, bs, bs, Lp, [](int r) { return tri(r); },
        [](int r) { return r + 1; });
  stage(C + k * BB + (size_t)r0 * bs, bs, R, X,
        [](int r) { return r * LD; }, [=](int) { return bs; });
  __syncthreads();
  off_rows(Lp, X, bs, R, out, bs);
}

template <typename Real>
int chol_launch(const Real *C, Real *Lcol, int nb, int bs, int j,
                cudaStream_t stream) {
  static bool raised_diag = false, raised_off = false;
  if (bs < 1 || bs > MAXB || j < 0 || j >= nb)
    return (int)cudaErrorInvalidValue;
  int err = raise_smem_once((const void *)panel_diag_kernel<Real>,
                            raised_diag);
  if (!err)
    err = raise_smem_once((const void *)panel_off_kernel<Real>, raised_off);
  if (err) return err;
  panel_diag_kernel<Real><<<1, FACTOR_THREADS, sizeof(Real) * bs * LD,
                            stream>>>(C, bs, j, Lcol);
  if ((err = (int)cudaGetLastError())) return err;
  const int nq = (bs + OFF_ROWS - 1) / OFF_ROWS;
  panel_off_kernel<Real><<<nb * nq, OFF_THREADS, sizeof(Real) * tri(bs),
                           stream>>>(C, bs, j, Lcol);
  return (int)cudaGetLastError();
}

}  // namespace

// C [nb, bs, bs] (natural block order), column j -> Lcol [nb, bs, bs].
// Returns cudaGetLastError().
extern "C" int panel_chol_launch(const double *C, double *Lcol, int nb,
                                 int bs, int j, cudaStream_t stream) {
  return chol_launch(C, Lcol, nb, bs, j, stream);
}

// The f32 build (K14-f32, the f32 phase under a mesh), the same order.
extern "C" int panel_chol_launch_f32(const float *C, float *Lcol, int nb,
                                     int bs, int j, cudaStream_t stream) {
  return chol_launch(C, Lcol, nb, bs, j, stream);
}
