// The batched round-robin cyclic Jacobi sweep in device memory, shared by
// K12 (jacobi_eigh.cu, real symmetric) and K13 (jacobi_herm.cu, complex
// Hermitian); see lax_eigh.py for the algorithm and its plain version.
// Both run their fused block and cluster sweeps (jacobi_fused.cuh) and
// take this variant only beyond the largest cluster's capacity.
//
// One block per matrix, one launch per sweep.  A round is three steps
// between barriers: the threads k < n/2 compute the rotation of pair k
// of the round's row of the schedule table (loaded a round ahead); then
// the row updates of all n/2 disjoint pairs, one warp per pair with its
// lanes along the row; then the column updates (and V's), one warp per
// pair with its lanes down the column.  The pairs of a round are
// disjoint, so no two threads touch one element in a step.
// After the n-1 rounds each block writes ||offdiag|| / ||diag|| of its
// matrix, and a second kernel takes the max over each group's blocks
// (NaN wins, as jnp.max) and sets the group's done flag: the reference's
// while_loop condition, evaluated on the card, so that the host issues
// `sweeps` launch pairs without waiting.  A launch whose group is done
// returns at once.
//
// A and V stay in device memory (at the orders this variant serves they
// stay in the 50 MB L2).  The round's rotations (n elements, which the
// final reduction's 64 reals reuse) and pivot pairs (n int16) are in
// shared memory.
//
// Every product and sum rounds on its own (--fmad=false), so each
// rotation rounds as the plain version's elementwise expressions do.
//
// Traits provide: E (element), R (real type), R re(E), the rotation from
// (a_pp, a_qq, a_pq) as a real cosine c and an element sine s, E
// cosine(R c) (the element the updates multiply by), the row and column
// updates of a pair, and |e|^2.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace jacobi {

constexpr int MAX_THREADS = 512;
constexpr int CHECK_THREADS = 256;

template <typename R>
__device__ __forceinline__ R sgn(R x) {
  return (R)((x > (R)0) - (x < (R)0));
}

// clamp that keeps NaN (fmin/fmax would drop it)
template <typename R>
__device__ __forceinline__ R clampv(R x, R lo, R hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// (small, c, s) of the reference's rotation for pivot value `mag`: theta
// clamped at 1/eps, t = 1 when theta == 0.  For the real kernel mag is
// a_pq itself, for the Hermitian one |a_pq|.
template <typename R>
__device__ __forceinline__ bool angle(R app, R aqq, R mag, R quarter_eps,
                                      R inv_eps, R &c, R &s) {
  const bool small = fabs(mag) <= quarter_eps * (fabs(app) + fabs(aqq));
  const R den = (R)2 * (small ? (R)1 : mag);
  const R theta = (aqq - app) / den;
  const R tc = clampv(theta, -inv_eps, inv_eps);
  const R root = sqrt((R)1 + tc * tc);
  R t = sgn(tc) / (fabs(tc) + root);
  if (theta == (R)0) t = (R)1;
  const R cc = (R)1 / sqrt((R)1 + t * t);
  const R ss = t * cc;
  c = small ? (R)1 : cc;
  s = small ? (R)0 : ss;
  return small;
}

// NaN-sticky max (jnp.max propagates NaN)
template <typename R>
__device__ __forceinline__ R nanmax(R a, R b) {
  if (a != a) return a;
  return (b != b || b > a) ? b : a;
}

template <typename Tr, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
    sweep_kernel(typename Tr::E *__restrict__ gA,
                 typename Tr::E *__restrict__ gV,
                 const int *__restrict__ sched,
                 typename Tr::R *__restrict__ ratio,
                 const int *__restrict__ done, int per_group, int n,
                 typename Tr::R quarter_eps, typename Tr::R inv_eps) {
  using E = typename Tr::E;
  using R = typename Tr::R;
  const int b = blockIdx.x;
  if (done[b / per_group]) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E *sm = reinterpret_cast<E *>(smem_raw);
  const size_t nn = (size_t)n * n;
  const int half = n / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int ld = n;
  E *a = gA + b * nn;
  E *v = gV + b * nn;
  E *cs = sm;  // c[0, half), s[half, n); then the reduction
  const int cs_len = (int)((n * sizeof(E) > 64 * sizeof(R))
                               ? n : (64 * sizeof(R) + sizeof(E) - 1)
                                         / sizeof(E));
  short *pq = reinterpret_cast<short *>(cs + cs_len);
  // this thread's pair (k = tid) of the coming round, loaded a round
  // ahead so that the table's latency hides behind the updates
  int p_next = 0, q_next = 0;
  if (tid < half) {
    p_next = sched[tid * 2];
    q_next = sched[tid * 2 + 1];
  }
  __syncthreads();

  for (int r = 0; r < n - 1; ++r) {
    for (int k = tid; k < half; k += blockDim.x) {
      int p, q;
      if (k == tid) {
        p = p_next;
        q = q_next;
        if (r + 1 < n - 1) {
          p_next = sched[((r + 1) * half + k) * 2];
          q_next = sched[((r + 1) * half + k) * 2 + 1];
        }
      } else {
        p = sched[(r * half + k) * 2];
        q = sched[(r * half + k) * 2 + 1];
      }
      pq[k] = (short)p;
      pq[half + k] = (short)q;
      R c;
      Tr::rotation(a[(size_t)p * ld + p], a[(size_t)q * ld + q],
                   a[(size_t)p * ld + q], quarter_eps, inv_eps, c,
                   cs[half + k]);
      cs[k] = Tr::cosine(c);
    }
    __syncthreads();
    // rows: A <- G' A; one warp per pair, its lanes along the row
    for (int k = warp; k < half; k += nwarps) {
      const E c = cs[k], sn = cs[half + k];
      E *xp = a + (size_t)pq[k] * ld;
      E *xq = a + (size_t)pq[half + k] * ld;
      for (int j = lane; j < n; j += 32) Tr::row_update(c, sn, xp[j], xq[j]);
    }
    __syncthreads();
    // columns: A <- A G, V <- V G; one warp per pair, lanes down the rows
    for (int k = warp; k < half; k += nwarps) {
      const E c = cs[k], sn = cs[half + k];
      const int p = pq[k], q = pq[half + k];
      for (int i = lane; i < n; i += 32) {
        Tr::col_update(c, sn, a[(size_t)i * ld + p], a[(size_t)i * ld + q]);
        if (VEC)
          Tr::col_update(c, sn, v[(size_t)i * ld + p],
                         v[(size_t)i * ld + q]);
      }
    }
    __syncthreads();
  }

  // ||offdiag(A)||^2 and ||diag(A)||^2 of this matrix
  R off = 0, dg = 0;
  for (int i = warp; i < n; i += nwarps)
    for (int j = lane; j < n; j += 32) {
      const E e = a[(size_t)i * ld + j];
      if (i == j) {
        const R d = Tr::re(e);
        dg += d * d;
      } else {
        off += Tr::abs2(e);
      }
    }
  for (int o = 16; o > 0; o >>= 1) {
    off += __shfl_down_sync(0xffffffffu, off, o);
    dg += __shfl_down_sync(0xffffffffu, dg, o);
  }
  R *red = reinterpret_cast<R *>(cs);
  if (lane == 0) {
    red[warp] = off;
    red[32 + warp] = dg;
  }
  __syncthreads();
  if (tid == 0) {
    R so = 0, sd = 0;
    for (int w = 0; w < nwarps; ++w) {
      so += red[w];
      sd += red[32 + w];
    }
    const R dn = sqrt(sd);
    ratio[b] = sqrt(so) / (dn > (R)1e-30 ? dn : (R)1e-30);
  }
}

// After sweep `sweep` (0-based): the group's max ratio; the group is done
// when the next sweep would not run (sweep + 1 >= 2 and not ratio > thresh;
// a NaN ratio ends it).  nsw counts the sweeps each group ran.
template <typename R>
__global__ void check_kernel(const R *__restrict__ ratio, int *done,
                             int *nsw, int per_group, int sweep, R thresh) {
  const int g = blockIdx.x;
  if (done[g]) return;
  __shared__ R part[CHECK_THREADS / 32];
  R m = (R)0;
  for (int i = threadIdx.x; i < per_group; i += blockDim.x)
    m = nanmax(m, ratio[(size_t)g * per_group + i]);
  for (int o = 16; o > 0; o >>= 1)
    m = nanmax(m, __shfl_down_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x / 32); ++w) m = nanmax(m, part[w]);
    nsw[g] += 1;
    if (sweep + 1 >= 2 && !(m > thresh)) done[g] = 1;
  }
}

template <typename Tr, bool VEC>
int launch_variant(typename Tr::E *A, typename Tr::E *V, const int *sched,
                   typename Tr::R *ratio, int *done, int *nsw, int batch,
                   int groups, int n, int sweeps, double eps,
                   cudaStream_t stream) {
  using E = typename Tr::E;
  using R = typename Tr::R;
  const size_t cs_bytes = n * sizeof(E) > 64 * sizeof(R)
                              ? n * sizeof(E)
                              : ((64 * sizeof(R) + sizeof(E) - 1) / sizeof(E))
                                    * sizeof(E);
  const size_t smem = cs_bytes + 2 * (size_t)n;
  auto kern = sweep_kernel<Tr, VEC>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  // one warp per pair of a round, at most MAX_THREADS
  int threads = 32 * (n / 2);
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const int per_group = batch / groups;
  const R thresh = (R)(8.0 * eps * sqrt((double)n));
  for (int i = 0; i < sweeps; ++i) {
    kern<<<batch, threads, smem, stream>>>(A, V, sched, ratio, done,
                                           per_group, n, (R)(0.25 * eps),
                                           (R)(1.0 / eps));
    check_kernel<R><<<groups, CHECK_THREADS, 0, stream>>>(
        ratio, done, nsw, per_group, i, thresh);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename Tr>
int launch(void *A, void *V, const int *sched, void *ratio, int *done,
           int *nsw, int batch, int groups, int n, int sweeps, int vectors,
           double eps, void *stream) {
  using E = typename Tr::E;
  using R = typename Tr::R;
  E *a = static_cast<E *>(A);
  E *v = static_cast<E *>(V);
  R *rt = static_cast<R *>(ratio);
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 2 || n % 2 || n > 32767 || groups < 1 || batch % groups)
    return (int)cudaErrorInvalidValue;
  return vectors ? launch_variant<Tr, true>(a, v, sched, rt, done, nsw,
                                            batch, groups, n, sweeps, eps, s)
                 : launch_variant<Tr, false>(a, v, sched, rt, done, nsw,
                                             batch, groups, n, sweeps, eps,
                                             s);
}

}  // namespace jacobi
