// K13: batched round-robin cyclic Jacobi eigh of complex Hermitian
// matrices (lax_eigh.py), complex128 and complex64 builds.
//
// Replaces the reference's sedumi_tpu/lax_eigh.py:187 _jacobi_herm
// (through jacobi_eigh_herm :286 and linalg_ops.eigh_herm_multi): the
// native complex path of the NT scaling's Hermitian buckets.  The
// rotation is the real one with the pivot's phase u = a_pq / |a_pq|
// folded into the sine (jacobi_common.cuh):
//   small, c, s from (re a_pp, re a_qq, |a_pq|) as in K12 (|.| = hypot),
//   u = a_pq / |a_pq| (each part divided by the real |a_pq|; 1 if small),
//   su = s u;  G = [[c, su], [-conj(su), c]],  A <- G^H A G:
//   rows p, q <- c A_p - su A_q, conj(su) A_p + c A_q;
//   columns p, q (and V's) <- c A_p - conj(su) A_q, su A_p + c A_q.
// Complex products are (a c - b d, a d + b c) with each product and sum
// rounded on its own (--fmad=false).
//
// Bound on the card: latency, as K12 (n-1 dependent rounds a sweep, each
// of three barrier-separated steps); its operations are 4x K12's per
// element, still far below the card's rate at these orders.

#include "jacobi_common.cuh"

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
  static __device__ __forceinline__ R abs2(E x) {
    const R h = hypot(x.x, x.y);
    return h * h;
  }
  static __device__ __forceinline__ void rotation(E app, E aqq, E apq,
                                                  R quarter_eps, R inv_eps,
                                                  E &c, E &su) {
    const R mag = hypot(apq.x, apq.y);
    R cr, sr;
    const bool small =
        jacobi::angle<R>(app.x, aqq.x, mag, quarter_eps, inv_eps, cr, sr);
    const R m1 = small ? (R)1 : mag;
    const E u = small ? mk((R)1, (R)0) : mk(apq.x / m1, apq.y / m1);
    c = mk(cr, (R)0);
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
                                       int smem, void *stream) {
  return jacobi::launch<HermTraits<double>>(A, V, sched, ratio, done, nsw,
                                            batch, groups, n, sweeps,
                                            vectors, eps, smem, stream);
}

extern "C" int jacobi_herm_c64_launch(void *A, void *V, const int *sched,
                                      void *ratio, int *done, int *nsw,
                                      int batch, int groups, int n,
                                      int sweeps, int vectors, double eps,
                                      int smem, void *stream) {
  return jacobi::launch<HermTraits<float>>(A, V, sched, ratio, done, nsw,
                                           batch, groups, n, sweeps, vectors,
                                           eps, smem, stream);
}
