// Sparse PSD Schur contribution (schur._psd_contrib_coo) and the sparse
// engine's PSD pair values (schur.psd_pair_values), f64 (K2) and f32
// (K2-f32) from one template.
//
// Replaces the reference's sedumi_tpu/schur.py:60 _psd_contrib_coo, which
// builds whole blocks B~[row*k + blk] = W_blk A_row^blk W_blk as batched
// [pad2, d] x [pad2, d] outer-product GEMMs (the TPU wanted dense batched
// GEMMs), then gathers M[i, j] = sum_{t in row i} b_val_t B~[j][b_loc_t].
// The gather reads B~ only at the distinct locations U of b_loc (arch0:
// 2811 of 25921, trto3: 3193 of 103041), so on this card only those are
// formed, as SeDuMi's getada3.c forms only what the pattern needs:
//
//  * psd_schur: one block per row slot j of M (grid mp1).  U is cut on the
//    host (opA.needed_entries) into chunks (at most UC entries of one
//    block: whole rows a while they fit) and items (a row's segment of at
//    most R entries, so a thread loads W[p_t, a] once for R products).
//    For each chunk the block stages, in t-slabs that fit STAGE elements,
//    gv_t W[p_t, a] for the chunk's rows a and W[q_t, :] of the group
//    (row j, blk) in shared memory (a warp a row t, coalesced), and forms
//    B~_j at the chunk's entries into shared memory (zeros where row j has
//    no group in blk).  The formation is bound by shared-memory traffic,
//    and a warp's loads of W[q_t, e] at scattered columns share banks:
//    the items run by (segment, row), so a warp's threads take
//    neighbouring rows' same segment, whose columns lie close together in
//    a banded pattern, and each item's slots are rotated (on the host) so
//    that one slot's loads over a half-warp (f64) or a warp (f32) rarely
//    meet in a bank.  Then the gather: with one chunk (arch0, trto3) the
//    products b_val_t B~_j[loc_t] of all CSR entries, coalesced into
//    shared memory, and each thread's rows summed from there in order;
//    with several (OH) each row's entries in the chunk, found by
//    bisection, summed from device memory.  Nothing of B~ reaches device
//    memory; one launch.
//  * psd_pair: the sparse engine needs B~_g at its pair list's (group,
//    location) entries only (sparse_engine.ada_values), times sp_val:
//    one thread per pair, W read through L1, written straight into the
//    vector the segment sum takes.
//
// Bits: each entry is formed as the earlier full-block build formed it:
// pa = W[p_t, a] * gv_t rounded, then acc = fma(pa, W[q_t, e], acc) for t
// ascending from 0 over the padded group (padded slots have gv = 0,
// p = q = 0 and still execute), kept across t-slabs in shared memory;
// and M[i, j] gathered as acc += B * b_val with t ascending over the row,
// carried through M from chunk to chunk (the chunks cut a row's entries in
// order, since b_uidx ascends in a row).
// Built with --fmad=false, so the gather rounds the product before the
// add.  The f32 build uses fmaf.
//
// Bound on the card: 2 sum_g pad2_g |U_blk(g)| + 2 T mp1 flops (arch0
// 3.7e7 f64 flops against 3.3e8 for whole blocks); bytes: W, the group
// and entry arrays once, M.  The formation is bound by shared-memory
// traffic (one W[p_t, a] and R W[q_t, e] loads per R fmas).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int R = 4;            // entries of U per item (opA.ITEM_ENTRIES)
constexpr int UC = 4096;        // entries of U per chunk (opA.CHUNK_ENTRIES)
constexpr int STAGE = 6144;     // staged W elements (48 KB in f64)

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

// first index in [lo, hi) with x[index] >= v (x ascending there)
__device__ __forceinline__ long long lower_bound(const int *__restrict__ x,
                                                 long long lo, long long hi,
                                                 int v) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (x[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) psd_schur_kernel(
    const T *__restrict__ W, const int *__restrict__ g_of,
    const long long *__restrict__ gp, const long long *__restrict__ gq,
    const T *__restrict__ gv, const int *__restrict__ u_e,
    const int *__restrict__ it, const int *__restrict__ ch, int nch,
    const long long *__restrict__ rowptr, const int *__restrict__ b_uidx,
    const T *__restrict__ b_val, T *__restrict__ M, int mp1, int k, int d,
    int pad2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T *vals = reinterpret_cast<T *>(smem_raw);  // B~_j on the chunk, [UC]
  T *stage = vals + UC;                         // [STAGE]
  const int j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long dd = (long long)d * d;
  const long long nnz = rowptr[mp1];
  for (int i = tid; i < mp1; i += THREADS) M[(long long)i * mp1 + j] = T(0);
  for (int c = 0; c < nch; ++c) {
    const int i0 = ch[4 * c], u0 = ch[4 * c + 1], a_lo = ch[4 * c + 2];
    const int na = ch[4 * c + 3] - a_lo + 1;
    const int i1 = ch[4 * c + 4], u1 = ch[4 * c + 5];
    const int blk = it[3 * i0] / d;
    const int g = g_of[(long long)j * k + blk];
    if (g < 0) {
      for (int u = u0 + tid; u < u1; u += THREADS) vals[u - u0] = T(0);
    } else {
      const T *Wb = W + blk * dd;
      const long long *gpg = gp + (long long)g * pad2;
      const long long *gqg = gq + (long long)g * pad2;
      const T *gvg = gv + (long long)g * pad2;
      const int tc = min(pad2, STAGE / (na + d));
      T *sP = stage;            // [tc][na]: gv_t W[p_t, a_lo + x]
      T *sQ = stage + tc * na;  // [tc][d]:  W[q_t, x]
      for (int t0 = 0; t0 < pad2; t0 += tc) {
        const int tn = min(tc, pad2 - t0);
        for (int tt = tid >> 5; tt < tn; tt += THREADS / 32) {
          const T *wp = Wb + gpg[t0 + tt] * d + a_lo;
          const T *wq = Wb + gqg[t0 + tt] * d;
          const T gvt = gvg[t0 + tt];
#pragma unroll 4
          for (int x = lane; x < na; x += 32) sP[tt * na + x] = wp[x] * gvt;
#pragma unroll 4
          for (int x = lane; x < d; x += 32) sQ[tt * d + x] = wq[x];
        }
        __syncthreads();
        for (int x = i0 + tid; x < i1; x += THREADS) {
          const int a = it[3 * x] % d - a_lo;
          const int ua = it[3 * x + 1] - u0;
          const int n = it[3 * x + 2] & 15, rot = it[3 * x + 2] >> 4;
          int e[R], s[R];  // slot r: the item's entry s[r] (< n) or none
          T acc[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            s[r] = (r + rot) % R;
            e[r] = s[r] < n ? u_e[u0 + ua + s[r]] : 0;
            acc[r] = (t0 > 0 && s[r] < n) ? vals[ua + s[r]] : T(0);
          }
#pragma unroll 4
          for (int tt = 0; tt < tn; ++tt) {
            const T pa = sP[tt * na + a];
            const T *q = sQ + tt * d;
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] = fma_t(pa, q[e[r]], acc[r]);
          }
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (s[r] < n) vals[ua + s[r]] = acc[r];
        }
        __syncthreads();
      }
    }
    __syncthreads();
    // M[i, j] += b_val_t B~_j[b_loc_t] over the CSR entries in the chunk
    if (nch > 1) {
      // each row's entries in the chunk, found by bisection (b_uidx
      // ascends in a row), summed in order from device memory
      for (int i = tid; i < mp1; i += THREADS) {
        long long t = lower_bound(b_uidx, rowptr[i], rowptr[i + 1], u0);
        const long long te = lower_bound(b_uidx, t, rowptr[i + 1], u1);
        if (t >= te) continue;
        T *out = M + (long long)i * mp1 + j;
        T acc = *out;
        for (; t < te; ++t) acc += vals[b_uidx[t] - u0] * b_val[t];
        *out = acc;
      }
      __syncthreads();  // vals is refilled by the next chunk
      continue;
    }
    // one chunk: the products in STAGE-sized slabs, coalesced, then each
    // row's sum in its order from shared memory
    T *prod = stage;
    for (long long e0 = 0; e0 < nnz; e0 += STAGE) {
      const long long e1 = min(e0 + STAGE, nnz);
#pragma unroll 4
      for (long long t = e0 + tid; t < e1; t += THREADS) {
        const int u = b_uidx[t];
        prod[t - e0] = vals[u - u0] * b_val[t];
      }
      __syncthreads();
      for (int i = tid; i < mp1; i += THREADS) {
        const long long ts = max(rowptr[i], e0);
        const long long te = min(rowptr[i + 1], e1);
        if (ts >= te) continue;
        T *out = M + (long long)i * mp1 + j;
        T acc = *out;
        for (long long t = ts; t < te; ++t) acc += prod[t - e0];
        *out = acc;
      }
      __syncthreads();  // prod is refilled by the next slab
    }
  }
}

template <typename T>
__global__ void psd_pair_kernel(const T *__restrict__ W,
                                const long long *__restrict__ g_blk,
                                const long long *__restrict__ gp,
                                const long long *__restrict__ gq,
                                const T *__restrict__ gv,
                                const long long *__restrict__ sp_g,
                                const long long *__restrict__ sp_loc,
                                const T *__restrict__ sp_val,
                                T *__restrict__ out, long long n, int pad2,
                                int d) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long g = sp_g[idx], loc = sp_loc[idx];
  const long long a = loc / d, e = loc - a * d;
  const T *Wb = W + g_blk[g] * ((long long)d * d);
  const long long *gpg = gp + g * pad2;
  const long long *gqg = gq + g * pad2;
  const T *gvg = gv + g * pad2;
  T acc = T(0);
  for (int t = 0; t < pad2; ++t) {
    const T pa = Wb[gpg[t] * d + a] * gvg[t];
    acc = fma_t(pa, Wb[gqg[t] * d + e], acc);
  }
  out[idx] = acc * sp_val[idx];
}

template <typename T>
int schur(const T *W, const int *g_of, const long long *gp,
          const long long *gq, const T *gv, const int *u_e, const int *it,
          const int *ch, int nch, const long long *rowptr,
          const int *b_uidx, const T *b_val, T *M, int mp1, int k, int d,
          int pad2, void *stream) {
  // the dynamic shared memory is set once, outside any graph capture
  static bool ready = false;
  const int smem = (UC + STAGE) * (int)sizeof(T);
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        psd_schur_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  if (mp1 > 0 && nch > 0) {
    psd_schur_kernel<T><<<mp1, THREADS, smem, (cudaStream_t)stream>>>(
        W, g_of, gp, gq, gv, u_e, it, ch, nch, rowptr, b_uidx, b_val, M, mp1,
        k, d, pad2);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int pair(const T *W, const long long *g_blk, const long long *gp,
         const long long *gq, const T *gv, const long long *sp_g,
         const long long *sp_loc, const T *sp_val, T *out, long long n,
         int pad2, int d, void *stream) {
  if (n > 0) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    psd_pair_kernel<T><<<(unsigned)blocks, THREADS, 0,
                         (cudaStream_t)stream>>>(
        W, g_blk, gp, gq, gv, sp_g, sp_loc, sp_val, out, n, pad2, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psd_schur_launch(const double *W, const int *g_of,
                                const long long *gp, const long long *gq,
                                const double *gv, const int *u_e,
                                const int *it, const int *ch, int nch,
                                const long long *rowptr, const int *b_uidx,
                                const double *b_val, double *M, int mp1,
                                int k, int d, int pad2, void *stream) {
  return schur<double>(W, g_of, gp, gq, gv, u_e, it, ch, nch, rowptr,
                       b_uidx, b_val, M, mp1, k, d, pad2, stream);
}

extern "C" int psd_schur_f32_launch(const float *W, const int *g_of,
                                    const long long *gp, const long long *gq,
                                    const float *gv, const int *u_e,
                                    const int *it, const int *ch, int nch,
                                    const long long *rowptr,
                                    const int *b_uidx, const float *b_val,
                                    float *M, int mp1, int k, int d,
                                    int pad2, void *stream) {
  return schur<float>(W, g_of, gp, gq, gv, u_e, it, ch, nch, rowptr,
                      b_uidx, b_val, M, mp1, k, d, pad2, stream);
}

extern "C" int psd_pair_launch(const double *W, const long long *g_blk,
                               const long long *gp, const long long *gq,
                               const double *gv, const long long *sp_g,
                               const long long *sp_loc, const double *sp_val,
                               double *out, long long n, int pad2, int d,
                               void *stream) {
  return pair<double>(W, g_blk, gp, gq, gv, sp_g, sp_loc, sp_val, out, n,
                      pad2, d, stream);
}

extern "C" int psd_pair_f32_launch(const float *W, const long long *g_blk,
                                   const long long *gp, const long long *gq,
                                   const float *gv, const long long *sp_g,
                                   const long long *sp_loc,
                                   const float *sp_val, float *out,
                                   long long n, int pad2, int d,
                                   void *stream) {
  return pair<float>(W, g_blk, gp, gq, gv, sp_g, sp_loc, sp_val, out, n,
                     pad2, d, stream);
}
