// The fused round-robin Jacobi sweeps shared by K12 (jacobi_eigh.cu, real
// symmetric, RealTraits) and K13 (jacobi_herm.cu, complex Hermitian,
// HermTraits): one two-sided step a round, in one block or in a
// thread-block cluster of 2-16 CTAs per matrix.  lax_eigh.jacobi_plan
// picks the variant; the device-memory sweep of jacobi_common.cuh serves
// the orders beyond the largest cluster.
//
// The fused step.  A round's n/2 pairs are disjoint, so its A <- G^H A G
// splits into (n/2)^2 independent 2 x 2 blocks {p_k, q_k} x {p_l, q_l}:
// rotating one block's rows by rotation k and then its columns by
// rotation l, with the traits' row and column expressions, rounds exactly
// as the three-step round (all rows, then all columns) of
// jacobi_common.cuh and the plain version.  V takes only the column
// rotations, so each of its rows is independent.  Each element is read
// and written once a round.  The round's pivot pairs come from the closed
// form of the round-robin table (player/slot/pair_of below;
// lax_eigh.closed_form_schedule holds it against _round_robin_schedule).
// A thread keeps one column pair l for the round and walks the rows.
//
// * block: one block of up to 1024 threads per matrix, A and V in its
//   shared memory (rows padded to n + 1), updated in place.  A round is
//   two barriers: the rotations (thread k < n/2 computes pair k's), then
//   the (n/2)^2 A blocks and the n x n/2 V column pairs.
// * cluster: a thread-block cluster of C = 2-16 CTAs per matrix (see
//   cluster_sweep): CTA c owns a range of the round's pairs and holds
//   their rows, so every load is local; the column rotations are applied
//   a round late, from the rotations every CTA broadcasts into every
//   other's shared memory; rows move to the next pair's owner by DSMEM
//   stores (two rows a CTA a round).  One cluster barrier a round.
//
// Each launch runs one sweep and writes ||offdiag|| / ||diag|| of each
// matrix (per warp over its rows, the warps in order, then the cluster's
// CTAs in order); jacobi::check_kernel then sets each group's done flag
// on the card, so the host never synchronises.
//
// Traits provide, beyond jacobi_common.cuh's: rotation(app, aqq, apq,
// quarter_eps, inv_eps, R &c, E &s) (the cosine is real) and
// cosine(R c), the element the updates multiply by.

#pragma once

#include <cooperative_groups.h>

#include "jacobi_common.cuh"

namespace jacobi {

namespace cg = cooperative_groups;

constexpr int FUSED_THREADS = 1024;
constexpr int MAX_CLUSTER = 16;

// variants, as lax_eigh.VARIANTS numbers them
constexpr int VARIANT_DEVICE = 0;
constexpr int VARIANT_BLOCK = 1;
constexpr int VARIANT_CLUSTER = 2;

// One rotation: the real cosine and the traits' element sine, 2
// sizeof(E) bytes (8 in f32, 16 in f64 and complex64, 32 in complex128).
template <typename Tr>
struct alignas(2 * sizeof(typename Tr::E) > 16
                   ? 16 : 2 * sizeof(typename Tr::E)) Rot {
  typename Tr::R c;
  typename Tr::E s;
};

// Player at slot s of round r (0 <= r < n-1) of lax_eigh.
// _round_robin_schedule(n): slot 0 holds player 0, and the tail 1..n-1
// turns right by one each round, so slot s >= 1 holds (s-1-r) mod (n-1)
// + 1.  No division: s - r lies in (1 - (n-1), n-1].
__device__ __forceinline__ int player(int r, int s, int n) {
  const int d = s - r;
  return s == 0 ? 0 : (d >= 1 ? d : d + n - 1);
}

// Slot of player x in round r (the inverse of player()); r = n-1 is
// round 0 again (the schedule's period).
__device__ __forceinline__ int slot(int r, int x, int n) {
  const int d = x + r;
  return x == 0 ? 0 : (d <= n - 1 ? d : d - (n - 1));
}

// Pair k of round r, packed p | q << 16 (p < q): slots k and n-1-k.
__device__ __forceinline__ int pair_of(int r, int k, int n) {
  const int a = player(r, k, n), b = player(r, n - 1 - k, n);
  return a < b ? a | (b << 16) : b | (a << 16);
}

// Threads of a fused sweep: `groups` threads for each of the h column
// pairs (thread t takes pair l = t % h and the rows t / h + j groups),
// no more groups than there are rows, at least a warp, whole warps.
__host__ __device__ inline int fused_groups(int h, int rows) {
  int g = FUSED_THREADS / h;
  const int need = rows > (32 + h - 1) / h ? rows : (32 + h - 1) / h;
  return g < need ? g : need;
}

__host__ __device__ inline int fused_threads(int h, int rows) {
  return (h * fused_groups(h, rows) + 31) / 32 * 32;
}

template <typename Tr>
__device__ __forceinline__ void rotate_rows(const Rot<Tr> &r,
                                            typename Tr::E &xp,
                                            typename Tr::E &xq) {
  Tr::row_update(Tr::cosine(r.c), r.s, xp, xq);
}

template <typename Tr>
__device__ __forceinline__ void rotate_cols(const Rot<Tr> &r,
                                            typename Tr::E &xp,
                                            typename Tr::E &xq) {
  Tr::col_update(Tr::cosine(r.c), r.s, xp, xq);
}

// ||diag||^2 and ||offdiag||^2 terms of element e at (i, j)
template <typename Tr>
__device__ __forceinline__ void add_norms(typename Tr::E e, bool diag,
                                          typename Tr::R &off,
                                          typename Tr::R &dg) {
  if (diag) {
    const typename Tr::R d = Tr::re(e);
    dg += d * d;
  } else {
    off += Tr::abs2(e);
  }
}

template <typename T>
__device__ __forceinline__ void reduce_ratio_parts(T &off, T &dg, T *red,
                                                   int lane, int warp,
                                                   int nwarps, T &so,
                                                   T &sd) {
  for (int o = 16; o > 0; o >>= 1) {
    off += __shfl_down_sync(0xffffffffu, off, o);
    dg += __shfl_down_sync(0xffffffffu, dg, o);
  }
  if (lane == 0) {
    red[warp] = off;
    red[32 + warp] = dg;
  }
  __syncthreads();
  so = 0;
  sd = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < nwarps; ++w) {
      so += red[w];
      sd += red[32 + w];
    }
}

template <typename T>
__device__ __forceinline__ T ratio_of(T so, T sd) {
  const T dn = sqrt(sd);
  return sqrt(so) / (dn > (T)1e-30 ? dn : (T)1e-30);
}

// ---------------------------------------------------------------- block

// Shared memory: A (and V), rows padded to n + 1; the round's rotations
// (max(h, 32) of them: the reduction's 64 reals reuse them); its pivot
// pairs (h ints).  lax_eigh.smem_bytes is the same sum.
template <typename Tr, bool VEC>
__global__ void __launch_bounds__(FUSED_THREADS)
    block_sweep(typename Tr::E *__restrict__ gA,
                typename Tr::E *__restrict__ gV,
                typename Tr::R *__restrict__ ratio,
                const int *__restrict__ done, int per_group, int n,
                typename Tr::R quarter_eps, typename Tr::R inv_eps) {
  using E = typename Tr::E;
  using R = typename Tr::R;
  const int b = blockIdx.x;
  if (done[b / per_group]) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E *a = reinterpret_cast<E *>(smem_raw);
  const int ld = n + 1;
  const int h = n / 2;
  E *v = a + (size_t)n * ld;
  Rot<Tr> *rot =
      reinterpret_cast<Rot<Tr> *>(a + (VEC ? 2 : 1) * (size_t)n * ld);
  int *pq = reinterpret_cast<int *>(rot + (h > 32 ? h : 32));
  const size_t nn = (size_t)n * n;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  // this thread's column pair and first row; the groups step the rows
  const int groups = fused_groups(h, VEC ? n : h);
  const int l = tid % h, g0 = tid / h;
  {
    const E *ga = gA + b * nn, *gv = gV + b * nn;
    for (int i = warp; i < n; i += nwarps)
      for (int j = lane; j < n; j += 32) {
        a[i * ld + j] = ga[(size_t)i * n + j];
        if (VEC) v[i * ld + j] = gv[(size_t)i * n + j];
      }
  }

  for (int r = 0; r < n - 1; ++r) {
    __syncthreads();
    for (int k = tid; k < h; k += nthreads) {
      const int pk = pair_of(r, k, n);
      const int p = pk & 0xffff, q = pk >> 16;
      pq[k] = pk;
      Rot<Tr> rk;
      Tr::rotation(a[p * ld + p], a[q * ld + q], a[p * ld + q], quarter_eps,
                   inv_eps, rk.c, rk.s);
      rot[k] = rk;
    }
    __syncthreads();
    if (g0 < groups) {
      const Rot<Tr> rl = rot[l];
      const int pql = pq[l];
      const int pl = pql & 0xffff, ql = pql >> 16;
      // the 2 x 2 blocks {p_k, q_k} x {p_l, q_l}: rows by rotation k,
      // then columns by rotation l
      for (int k = g0; k < h; k += groups) {
        const int pqk = pq[k];
        const Rot<Tr> rk = rot[k];
        E *xp = a + (pqk & 0xffff) * ld, *xq = a + (pqk >> 16) * ld;
        E pp = xp[pl], pv = xp[ql], qp = xq[pl], qq = xq[ql];
        rotate_rows(rk, pp, qp);
        rotate_rows(rk, pv, qq);
        rotate_cols(rl, pp, pv);
        rotate_cols(rl, qp, qq);
        xp[pl] = pp;
        xp[ql] = pv;
        xq[pl] = qp;
        xq[ql] = qq;
      }
      if (VEC)
        for (int i = g0; i < n; i += groups) {
          E *x = v + i * ld;
          E vp = x[pl], vq = x[ql];
          rotate_cols(rl, vp, vq);
          x[pl] = vp;
          x[ql] = vq;
        }
    }
  }
  __syncthreads();

  R off = 0, dg = 0;
  for (int i = warp; i < n; i += nwarps)
    for (int j = lane; j < n; j += 32)
      add_norms<Tr>(a[i * ld + j], i == j, off, dg);
  R so, sd;
  reduce_ratio_parts(off, dg, reinterpret_cast<R *>(rot), lane, warp, nwarps,
                     so, sd);
  if (tid == 0) ratio[b] = ratio_of(so, sd);
  E *ga = gA + b * nn, *gv = gV + b * nn;
  for (int i = warp; i < n; i += nwarps)
    for (int j = lane; j < n; j += 32) {
      ga[(size_t)i * n + j] = a[i * ld + j];
      if (VEC) gv[(size_t)i * n + j] = v[i * ld + j];
    }
}

// -------------------------------------------------------------- cluster

// The cluster variant.  CTA c owns the round's pairs [c h / C, (c+1) h /
// C) (at most P = ceil(h / C)) and holds both rows of each at positions
// 2 (k - c h / C) + side (side 0: the player at slot k, side 1: at slot
// n-1-k), and V's rows [c n / C, (c+1) n / C) (at most S = ceil(n / C)).
// It keeps A' = A with the round's rows rotated and its columns not yet:
// round r applies the column rotations of round r - 1 (every pair's,
// broadcast into every CTA's shared memory during round r - 1) and then
// its own row rotations, to its own rows only, so every load is local.
// A row's pair index moves by one a round (slot s -> s + 1), so it is
// written to the position of its next pair, in this CTA or (at the edge
// of the range) the next or previous one: DSMEM carries stores only, two
// rows and h rotations per CTA a round.  One cluster barrier a round.

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) / 16 * 16; }

// Shared memory of one CTA, each part on 16 bytes, es = sizeof(E): A'
// twice (read one copy, write the other), 2 P rows padded to n + 1, and
// V's S rows; the rotations of two rounds (2 max(h, 32) of 2 es bytes:
// the reduction's 64 reals reuse one); per own row its next position's
// address (2 P pointers); per own pair whether the slot-k row is its p
// (P ints); the cluster's partial sums (2 MAX_CLUSTER values).
// lax_eigh.cluster_smem_bytes is the same.
struct ClusterLayout {
  size_t rot, dst, side, part, total;
  __host__ __device__ ClusterLayout(int n, int C, bool vec, size_t es) {
    const int h = n / 2, P = (h + C - 1) / C, S = (n + C - 1) / C;
    rot = up16((4 * (size_t)P + (vec ? S : 0)) * (n + 1) * es);
    dst = up16(rot + 2 * (size_t)(h > 32 ? h : 32) * 2 * es);
    side = up16(dst + 16 * (size_t)P);
    part = up16(side + 4 * (size_t)P);
    total = part + 2 * MAX_CLUSTER * es;
  }
};

// A'[row, j] with its column rotated by round rr's rotations: j's pair
// l of round rr holds (p_l, q_l) and j is one of them
template <typename Tr>
__device__ __forceinline__ typename Tr::E col_rot_at(
    const typename Tr::E *row, int j, int rr, int n, const Rot<Tr> *rots) {
  const int t = slot(rr, j, n);
  const int l = t < n - 1 - t ? t : n - 1 - t;
  const int pk = pair_of(rr, l, n);
  typename Tr::E xp = row[pk & 0xffff], xq = row[pk >> 16];
  rotate_cols(rots[l], xp, xq);
  return j == (pk & 0xffff) ? xp : xq;
}

template <typename Tr, bool VEC>
__global__ void __launch_bounds__(FUSED_THREADS)
    cluster_sweep(typename Tr::E *__restrict__ gA,
                  typename Tr::E *__restrict__ gV,
                  typename Tr::R *__restrict__ ratio,
                  const int *__restrict__ done, int per_group, int n,
                  typename Tr::R quarter_eps, typename Tr::R inv_eps) {
  using E = typename Tr::E;
  using R = typename Tr::R;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  // the flag is read by every CTA of the cluster alike: all return or none
  if (done[b / per_group]) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ClusterLayout lay(n, C, VEC, sizeof(E));
  const int ld = n + 1;
  const int h = n / 2, hm = h > 32 ? h : 32;
  const int P = (h + C - 1) / C, S = (n + C - 1) / C;
  // CTA c owns pairs [c h / C, (c+1) h / C) and V's rows [c n / C, ...)
  const int k0 = rank * h / C, npairs = (rank + 1) * h / C - k0;
  const int v0 = rank * n / C, nv = (rank + 1) * n / C - v0;
  E *abuf = reinterpret_cast<E *>(smem_raw);  // two copies of 2 P rows
  E *v = abuf + 4 * (size_t)P * ld;
  Rot<Tr> *rotb = reinterpret_cast<Rot<Tr> *>(smem_raw + lay.rot);
  E **dst = reinterpret_cast<E **>(smem_raw + lay.dst);
  int *aisp = reinterpret_cast<int *>(smem_raw + lay.side);
  R *part = reinterpret_cast<R *>(smem_raw + lay.part);
  const size_t nn = (size_t)n * n;
  const size_t cbuf = 2 * (size_t)P * ld;  // offset of the second copy
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int groups = fused_groups(h, VEC ? S : P);
  const int l = tid % h, g0 = tid / h;

  {
    // round 0 puts pair k's rows k and n-1-k at positions 2k, 2k + 1
    const E *ga = gA + b * nn;
    for (int i = warp; i < 2 * npairs; i += nwarps) {
      const int k = k0 + i / 2, x = i & 1 ? n - 1 - k : k;
      for (int j = lane; j < n; j += 32)
        abuf[i * ld + j] = ga[(size_t)x * n + j];
    }
    if (VEC)
      for (int i = warp; i < nv; i += nwarps)
        for (int j = lane; j < n; j += 32)
          v[i * ld + j] = gV[b * nn + (size_t)(v0 + i) * n + j];
  }
  // every CTA has started before any writes into another's memory
  cluster.sync();

  int cur = 0;
  for (int r = 0; r < n - 1; ++r) {
    const E *acur = abuf + (cur ? cbuf : 0);
    const size_t nxt = cur ? 0 : cbuf;
    Rot<Tr> *rnow = rotb + (r & 1) * hm;
    const Rot<Tr> *rprev = rotb + ((r + 1) & 1) * hm;
    // own pairs: pivots (columns rotated by round r - 1), the rotation,
    // broadcast to every CTA; where each row goes next round
    for (int kl = tid; kl < npairs; kl += nthreads) {
      const int k = k0 + kl;
      const int a = player(r, k, n), bb = player(r, n - 1 - k, n);
      const E *ra = acur + 2 * kl * ld, *rb = ra + ld;
      const int p = a < bb ? a : bb, q = a < bb ? bb : a;
      const E *rp = a < bb ? ra : rb, *rq = a < bb ? rb : ra;
      E app, aqq, apq;
      if (r == 0) {
        app = rp[p];
        aqq = rq[q];
        apq = rp[q];
      } else {
        app = col_rot_at(rp, p, r - 1, n, rprev);
        aqq = col_rot_at(rq, q, r - 1, n, rprev);
        apq = col_rot_at(rp, q, r - 1, n, rprev);
      }
      Rot<Tr> rk;
      Tr::rotation(app, aqq, apq, quarter_eps, inv_eps, rk.c, rk.s);
      for (int c = 0; c < C; ++c) cluster.map_shared_rank(rnow, c)[k] = rk;
    }
    // meanwhile the last threads: which own row is the pair's p, and the
    // address of each own row's position next round
    for (int i = nthreads - 1 - tid; i < 2 * npairs; i += nthreads) {
      const int k = k0 + i / 2;
      const int a = player(r, k, n), bb = player(r, n - 1 - k, n);
      if (!(i & 1)) aisp[i / 2] = a < bb;
      const int t = slot(r + 1, i & 1 ? bb : a, n);
      const int k1 = t < n - 1 - t ? t : n - 1 - t;
      const int c1 = ((k1 + 1) * C - 1) / h;  // the owner of pair k1
      dst[i] = cluster.map_shared_rank(abuf, c1) + nxt
               + (size_t)(2 * (k1 - c1 * h / C) + (t > n - 1 - t)) * ld;
    }
    __syncthreads();
    if (g0 < groups) {
      // this thread's column pair: round r - 1's (whose rotation is
      // applied now), or any partition in round 0
      const int pk = pair_of(r == 0 ? 0 : r - 1, l, n);
      const int pl = pk & 0xffff, ql = pk >> 16;
      const Rot<Tr> rl = rprev[l];
      for (int kl = g0; kl < npairs; kl += groups) {
        const Rot<Tr> rk = rnow[k0 + kl];
        const E *ra = acur + 2 * kl * ld, *rb = ra + ld;
        E ap = ra[pl], aq = ra[ql], bp = rb[pl], bq = rb[ql];
        if (r > 0) {
          rotate_cols(rl, ap, aq);
          rotate_cols(rl, bp, bq);
        }
        // rows p, q by rotation k
        if (aisp[kl]) {
          rotate_rows(rk, ap, bp);
          rotate_rows(rk, aq, bq);
        } else {
          rotate_rows(rk, bp, ap);
          rotate_rows(rk, bq, aq);
        }
        E *da = dst[2 * kl], *db = dst[2 * kl + 1];
        da[pl] = ap;
        da[ql] = aq;
        db[pl] = bp;
        db[ql] = bq;
      }
      if (VEC && r > 0)
        for (int i = g0; i < nv; i += groups) {
          E *x = v + i * ld;
          E vp = x[pl], vq = x[ql];
          rotate_cols(rl, vp, vq);
          x[pl] = vp;
          x[ql] = vq;
        }
    }
    // the new copy and the rotations are complete everywhere before any
    // CTA reads them
    cluster.sync();
    cur ^= 1;
  }

  // the last round's column rotations, in place; rows are back at their
  // round-0 positions (the schedule has period n - 1)
  E *afin = abuf + (cur ? cbuf : 0);
  const Rot<Tr> *rlast = rotb + ((n - 2) & 1) * hm;
  if (g0 < groups) {
    const int pk = pair_of(n - 2, l, n);
    const int pl = pk & 0xffff, ql = pk >> 16;
    const Rot<Tr> rl = rlast[l];
    for (int i = g0; i < 2 * npairs; i += groups) {
      E *x = afin + i * ld;
      E xp = x[pl], xq = x[ql];
      rotate_cols(rl, xp, xq);
      x[pl] = xp;
      x[ql] = xq;
    }
    if (VEC)
      for (int i = g0; i < nv; i += groups) {
        E *x = v + i * ld;
        E vp = x[pl], vq = x[ql];
        rotate_cols(rl, vp, vq);
        x[pl] = vp;
        x[ql] = vq;
      }
  }
  __syncthreads();

  R off = 0, dg = 0;
  for (int i = warp; i < 2 * npairs; i += nwarps) {
    const int k = k0 + i / 2, x = i & 1 ? n - 1 - k : k;
    for (int j = lane; j < n; j += 32)
      add_norms<Tr>(afin[i * ld + j], x == j, off, dg);
  }
  R so, sd;
  reduce_ratio_parts(off, dg,
                     reinterpret_cast<R *>(rotb + ((n - 1) & 1) * hm), lane,
                     warp, nwarps, so, sd);
  if (tid == 0) {
    R *d = cluster.map_shared_rank(part, 0);
    d[2 * rank] = so;
    d[2 * rank + 1] = sd;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    R so_all = 0, sd_all = 0;
    for (int c = 0; c < C; ++c) {
      so_all += part[2 * c];
      sd_all += part[2 * c + 1];
    }
    ratio[b] = ratio_of(so_all, sd_all);
  }
  E *ga = gA + b * nn;
  for (int i = warp; i < 2 * npairs; i += nwarps) {
    const int k = k0 + i / 2, x = i & 1 ? n - 1 - k : k;
    for (int j = lane; j < n; j += 32)
      ga[(size_t)x * n + j] = afin[i * ld + j];
  }
  if (VEC)
    for (int i = warp; i < nv; i += nwarps)
      for (int j = lane; j < n; j += 32)
        gV[b * nn + (size_t)(v0 + i) * n + j] = v[i * ld + j];
}

// ------------------------------------------------------------------ host

inline size_t block_smem(int n, size_t esize, bool vec) {
  const int h = n / 2;
  return (vec ? 2 : 1) * (size_t)n * (n + 1) * esize
         + (size_t)(h > 32 ? h : 32) * 2 * esize + 4 * (size_t)h;
}

template <typename Tr, bool VEC>
int launch_fused(typename Tr::E *A, typename Tr::E *V,
                 typename Tr::R *ratio, int *done, int *nsw, int batch,
                 int groups, int n, int sweeps, double eps, int variant,
                 int C, cudaStream_t stream) {
  using E = typename Tr::E;
  using R = typename Tr::R;
  const int per_group = batch / groups;
  const int h = n / 2;
  const R thresh = (R)(8.0 * eps * sqrt((double)n));
  const R qeps = (R)(0.25 * eps), ieps = (R)(1.0 / eps);
  cudaError_t err;
  if (variant == VARIANT_BLOCK) {
    const size_t smem = block_smem(n, sizeof(E), VEC);
    auto kern = block_sweep<Tr, VEC>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = fused_threads(h, VEC ? n : h);
    for (int i = 0; i < sweeps; ++i) {
      kern<<<batch, threads, smem, stream>>>(A, V, ratio, done, per_group, n,
                                             qeps, ieps);
      check_kernel<R><<<groups, CHECK_THREADS, 0, stream>>>(
          ratio, done, nsw, per_group, i, thresh);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
  }
  if (C < 2 || C > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  // every CTA owns at least one pair
  if (C > h) return (int)cudaErrorInvalidValue;
  const size_t smem = ClusterLayout(n, C, VEC, sizeof(E)).total;
  auto kern = cluster_sweep<Tr, VEC>;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * C));
  cfg.blockDim = dim3(fused_threads(h, VEC ? (n + C - 1) / C
                                              : (h + C - 1) / C));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster that cannot be resident is refused, never run otherwise
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, (const void *)kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  for (int i = 0; i < sweeps; ++i) {
    err = cudaLaunchKernelEx(&cfg, kern, A, V, ratio, (const int *)done,
                             per_group, n, qeps, ieps);
    if (err != cudaSuccess) return (int)err;
    check_kernel<R><<<groups, CHECK_THREADS, 0, stream>>>(
        ratio, done, nsw, per_group, i, thresh);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// One build's entry point: the device-memory sweep (jacobi_common.cuh)
// or a fused variant with C CTAs.
template <typename Tr>
int launch_any(void *A, void *V, const int *sched, void *ratio, int *done,
               int *nsw, int batch, int groups, int n, int sweeps,
               int vectors, double eps, int variant, int cluster,
               void *stream) {
  using E = typename Tr::E;
  using R = typename Tr::R;
  if (variant == VARIANT_DEVICE)
    return launch<Tr>(A, V, sched, ratio, done, nsw, batch, groups, n,
                      sweeps, vectors, eps, stream);
  if (n < 2 || n % 2 || n > 2 * FUSED_THREADS || groups < 1
      || batch % groups
      || (variant != VARIANT_BLOCK && variant != VARIANT_CLUSTER))
    return (int)cudaErrorInvalidValue;
  E *a = static_cast<E *>(A), *v = static_cast<E *>(V);
  R *rt = static_cast<R *>(ratio);
  cudaStream_t s = (cudaStream_t)stream;
  return vectors ? launch_fused<Tr, true>(a, v, rt, done, nsw, batch, groups,
                                          n, sweeps, eps, variant, cluster,
                                          s)
                 : launch_fused<Tr, false>(a, v, rt, done, nsw, batch,
                                           groups, n, sweeps, eps, variant,
                                           cluster, s);
}

}  // namespace jacobi
