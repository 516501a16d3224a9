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
// The fused step (jacobi_fused.cuh, shared with K13).  A round's n/2
// pairs are disjoint, so its A <- G' A G splits into (n/2)^2 independent
// 2 x 2 blocks {p_k, q_k} x {p_l, q_l}: rotating one block's rows by
// rotation k and then its columns by rotation l, with the plain version's
// expressions, rounds exactly as the plain version's row step followed by
// its column step.  V takes only the column rotations, so each of its
// rows is independent.  Each element is read and written once a round.
// The round's pivot pairs come from the closed form of the round-robin
// table.
//
// Three variants; lax_eigh.jacobi_plan picks one from the order, the
// dtype and the batch:
//
// * block: one block of up to 1024 threads per matrix, A and V in its
//   shared memory (rows padded to n + 1), updated in place.  A round is
//   two barriers: the rotations (thread k < n/2 computes pair k's), then
//   the (n/2)^2 A blocks and the n x n/2 V column pairs.  Bound: one
//   SM's issue rate (a load, a store and three products and sums per
//   element a round), so it serves the batches that fill the card and
//   the orders below lax_eigh.CLUSTER_MIN_N (100 in f32, 80 in f64),
//   where the cluster's barrier costs more than it spreads, and the
//   batches whose cluster would have fewer than CLUSTER_MIN_CTAS CTAs.
//   Holds f32 with vectors up to order 168, f64 up to 118.
// * cluster: a thread-block cluster of C = 2-16 CTAs per matrix (see
//   cluster_sweep): CTA c owns a range of the round's pairs and holds
//   their rows, so every load is local; the column rotations are applied
//   a round late, from the rotations every CTA broadcasts into every
//   other's shared memory; rows move to the next pair's owner by DSMEM
//   stores (two rows a CTA a round).  One cluster barrier a round.
//   Bound: latency, a few microseconds a round (PERF.md section 6): the
//   cluster barrier, the pivots and angle of each pair in one thread,
//   then the CTA's share of the updates.  The cluster spreads a matrix's
//   rounds over up to 16 SMs where one block would leave the rest of the
//   card idle (a batch of one NT bucket).  Holds f32 with vectors up to
//   order 544 and f64 up to 384.
// * device: the sweep of jacobi_common.cuh on A and V in device memory
//   (L2), for orders beyond the largest cluster's capacity; no solve on
//   the card reaches it.
//
// Every product and sum rounds on its own (--fmad=false), so each
// rotation rounds as the plain version's elementwise expressions do, and
// w, V and the sweeps run are bit-equal to lax_eigh._jacobi_plain.  Each
// launch runs one sweep and writes ||offdiag|| / ||diag|| of each matrix
// (per warp over its rows, the warps in order, then the cluster's CTAs
// in order); jacobi::check_kernel then sets each group's done flag on
// the card, so the host never synchronises.

#include "jacobi_fused.cuh"

namespace {

template <typename T>
struct RealTraits {
  using E = T;
  using R = T;
  static __device__ __forceinline__ R re(E x) { return x; }
  static __device__ __forceinline__ R abs2(E x) { return x * x; }
  static __device__ __forceinline__ E cosine(R c) { return c; }
  static __device__ __forceinline__ void rotation(E app, E aqq, E apq,
                                                  R quarter_eps, R inv_eps,
                                                  R &c, E &s) {
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
                                      int variant, int cluster,
                                      void *stream) {
  return jacobi::launch_any<RealTraits<double>>(
      A, V, sched, ratio, done, nsw, batch, groups, n, sweeps, vectors, eps,
      variant, cluster, stream);
}

extern "C" int jacobi_eigh_f32_launch(void *A, void *V, const int *sched,
                                      void *ratio, int *done, int *nsw,
                                      int batch, int groups, int n,
                                      int sweeps, int vectors, double eps,
                                      int variant, int cluster,
                                      void *stream) {
  return jacobi::launch_any<RealTraits<float>>(
      A, V, sched, ratio, done, nsw, batch, groups, n, sweeps, vectors, eps,
      variant, cluster, stream);
}
