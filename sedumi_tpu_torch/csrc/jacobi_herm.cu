// K13: batched round-robin cyclic Jacobi eigh of complex Hermitian
// matrices (lax_eigh.py), complex128 and complex64 builds.
//
// Replaces the reference's sedumi_tpu/lax_eigh.py:187 _jacobi_herm
// (through jacobi_eigh_herm :286 and linalg_ops.eigh_herm_multi): the
// native complex path of the NT scaling's Hermitian buckets.  The
// rotation is the real one with the pivot's phase u = a_pq / |a_pq|
// folded into the sine (HermTraits below):
//   small, c, s from (re a_pp, re a_qq, |a_pq|) as in K12 (|.| = hypot),
//   u = a_pq / |a_pq| (each part divided by the real |a_pq|; 1 if small),
//   su = s u;  G = [[c, su], [-conj(su), c]],  A <- G^H A G:
//   rows p, q <- c A_p - su A_q, conj(su) A_p + c A_q;
//   columns p, q (and V's) <- c A_p - conj(su) A_q, su A_p + c A_q.
// Complex products are (a c - b d, a d + b c) with each product and sum
// rounded on its own (--fmad=false).
//
// The variants are K12's (jacobi_fused.cuh; lax_eigh.jacobi_plan picks
// one from the order, the dtype and the batch): one fused two-sided step
// a round over the round's 2 x 2 blocks, in one block per matrix (with
// vectors up to order 84 in complex128, 118 in complex64) or in a
// thread-block cluster of 2-16 CTAs (up to 262 and 384), and beyond the
// largest cluster the three-step sweep of jacobi_common.cuh in device
// memory.  Each element takes its row rotation and then its column
// rotation with the same expressions in every variant, so the fused
// variants are bit-equal to the device-memory one in w, V and the sweeps
// run.  A rotation in shared memory is the real cosine and the complex
// s u: 32 bytes in complex128, 16 in complex64.
//
// Bound on the card: latency, as K12's (n-1 dependent rounds a sweep,
// two barriers a round in one block, one cluster barrier in a cluster);
// the angle of each pair is a chain of divisions and square roots in one
// thread.  Its operations are 4x K12's per element, still far below the
// card's rate at these orders.

#include "jacobi_fused.cuh"

namespace {

template <typename R>
struct Cplx;
template <>
struct Cplx<float> {
  using type = float2;
};
template <>
struct Cplx<double> {
  using type = double2;
};

template <typename T>
struct HermTraits {
  using E = typename Cplx<T>::type;
  using R = T;
  static __device__ __forceinline__ E mk(R re, R im) {
    E e;
    e.x = re;
    e.y = im;
    return e;
  }
  static __device__ __forceinline__ E mul(E a, E b) {
    return mk(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
  }
  static __device__ __forceinline__ E conj(E a) { return mk(a.x, -a.y); }
  static __device__ __forceinline__ E add(E a, E b) {
    return mk(a.x + b.x, a.y + b.y);
  }
  static __device__ __forceinline__ E sub(E a, E b) {
    return mk(a.x - b.x, a.y - b.y);
  }
  static __device__ __forceinline__ R re(E x) { return x.x; }
  static __device__ __forceinline__ E cosine(R c) { return mk(c, (R)0); }
  static __device__ __forceinline__ R abs2(E x) {
    const R h = hypot(x.x, x.y);
    return h * h;
  }
  static __device__ __forceinline__ void rotation(E app, E aqq, E apq,
                                                  R quarter_eps, R inv_eps,
                                                  R &c, E &su) {
    const R mag = hypot(apq.x, apq.y);
    R sr;
    const bool small =
        jacobi::angle<R>(app.x, aqq.x, mag, quarter_eps, inv_eps, c, sr);
    const R m1 = small ? (R)1 : mag;
    const E u = small ? mk((R)1, (R)0) : mk(apq.x / m1, apq.y / m1);
    su = mul(mk(sr, (R)0), u);
  }
  static __device__ __forceinline__ void row_update(E c, E su, E &xp,
                                                    E &xq) {
    const E p = xp, q = xq;
    xp = sub(mul(c, p), mul(su, q));
    xq = add(mul(conj(su), p), mul(c, q));
  }
  static __device__ __forceinline__ void col_update(E c, E su, E &xp,
                                                    E &xq) {
    const E p = xp, q = xq;
    xp = sub(mul(c, p), mul(conj(su), q));
    xq = add(mul(su, p), mul(c, q));
  }
};

}  // namespace

extern "C" int jacobi_herm_c128_launch(void *A, void *V, const int *sched,
                                       void *ratio, int *done, int *nsw,
                                       int batch, int groups, int n,
                                       int sweeps, int vectors, double eps,
                                       int variant, int cluster,
                                       void *stream) {
  return jacobi::launch_any<HermTraits<double>>(
      A, V, sched, ratio, done, nsw, batch, groups, n, sweeps, vectors, eps,
      variant, cluster, stream);
}

extern "C" int jacobi_herm_c64_launch(void *A, void *V, const int *sched,
                                      void *ratio, int *done, int *nsw,
                                      int batch, int groups, int n,
                                      int sweeps, int vectors, double eps,
                                      int variant, int cluster,
                                      void *stream) {
  return jacobi::launch_any<HermTraits<float>>(
      A, V, sched, ratio, done, nsw, batch, groups, n, sweeps, vectors, eps,
      variant, cluster, stream);
}
