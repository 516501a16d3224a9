// K12: batched round-robin cyclic Jacobi eigh/eigvalsh of real symmetric
// matrices (lax_eigh.py), f64 and f32 builds, with and without vectors.
//
// Replaces the reference's sedumi_tpu/lax_eigh.py:49 _jacobi (through
// jacobi_eigh :308 and jacobi_eigvalsh :315), which the reference runs for
// every eigh/eigvalsh on its accelerator: the NT scaling's batched eigh,
// the line-search spectra at the coarse budget, the Gondzio clip and the
// recenter's eigenvalues.  The rotations are the reference's, in its
// round order (jacobi_common.cuh):
//   small = |a_pq| <= eps/4 (|a_pp| + |a_qq|),
//   theta = (a_qq - a_pp) / (2 a_pq), clamped to [-1/eps, 1/eps],
//   t = sign(theta) / (|theta| + sqrt(1 + theta^2)), t = 1 if theta == 0,
//   c = 1 / sqrt(1 + t^2), s = t c  (c = 1, s = 0 if small);
//   rows p, q <- c A_p - s A_q, s A_p + c A_q; then the columns and V's.
//
// Bound on the card: latency.  A sweep is n-1 dependent rounds of three
// barrier-separated steps, each moving O(n) elements per thread group;
// the operations (~6 n^3 per sweep with vectors, 4 n^3 without, plus the
// rotations) are far below the card's rate at these orders, and the bytes
// (read A once, write w and V) far below its memory rate.  One block per
// matrix keeps each round's data in shared memory (or in L2 above 227 KB)
// and the batch fills the SMs; the early exit costs one tiny kernel per
// sweep and no host synchronisation.

#include "jacobi_common.cuh"

namespace {

template <typename T>
struct RealTraits {
  using E = T;
  using R = T;
  static __device__ __forceinline__ R re(E x) { return x; }
  static __device__ __forceinline__ R abs2(E x) { return x * x; }
  static __device__ __forceinline__ void rotation(E app, E aqq, E apq,
                                                  R quarter_eps, R inv_eps,
                                                  E &c, E &s) {
    jacobi::angle<R>(app, aqq, apq, quarter_eps, inv_eps, c, s);
  }
  // (x_p, x_q) <- (c x_p - s x_q, s x_p + c x_q): rows and columns alike
  static __device__ __forceinline__ void row_update(E c, E s, E &xp, E &xq) {
    const E p = xp, q = xq;
    xp = c * p - s * q;
    xq = s * p + c * q;
  }
  static __device__ __forceinline__ void col_update(E c, E s, E &xp, E &xq) {
    row_update(c, s, xp, xq);
  }
};

}  // namespace

extern "C" int jacobi_eigh_f64_launch(void *A, void *V, const int *sched,
                                      void *ratio, int *done, int *nsw,
                                      int batch, int groups, int n,
                                      int sweeps, int vectors, double eps,
                                      int smem, void *stream) {
  return jacobi::launch<RealTraits<double>>(A, V, sched, ratio, done, nsw,
                                            batch, groups, n, sweeps,
                                            vectors, eps, smem, stream);
}

extern "C" int jacobi_eigh_f32_launch(void *A, void *V, const int *sched,
                                      void *ratio, int *done, int *nsw,
                                      int batch, int groups, int n,
                                      int sweeps, int vectors, double eps,
                                      int smem, void *stream) {
  return jacobi::launch<RealTraits<float>>(A, V, sched, ratio, done, nsw,
                                           batch, groups, n, sweeps, vectors,
                                           eps, smem, stream);
}
