// Sparse PSD Schur contribution (schur._psd_contrib_coo), two kernels.
//
// Replaces the reference's sedumi_tpu/schur.py:60 _psd_contrib_coo, which
// builds B~[row*k + blk] = W_blk A_row^blk W_blk as host-chunked batched
// [pad2, d] x [pad2, d] outer-product GEMMs plus a scatter-add, then
// gathers M[i, j] = sum_{t in row i} b_val_t B~[j][b_loc_t] with a
// segment-sum.  With W = R R' symmetric:
//
//  (a) psd_coo_outer: grid (groups, output tiles).  A block computes one
//      64 x 64 tile of B~[g_slot] = sum_t gv_t W[:, p_t] W[q_t, :] for one
//      (row, block) group, streaming t through shared memory in
//      chunks of 16 (2 x 16 x 64 doubles = 16 KB), so pad2 is unbounded
//      (OH: pad2 = 128).  Each of the 256 threads keeps a 4 x 4 register
//      tile.  The caller's output slots are unique (the dense-engine path
//      passes g_row*k + g_blk, the sparse engine's B~ build, the
//      reference's sparse_engine.py:209-228, passes 0..G-1), so tiles are
//      written, not added: no atomics.  Padded slots have gv = 0 and
//      p = q = 0.
//      W[a, p] is read as W[p, a] (W symmetric) so loads coalesce.
//  (b) psd_coo_gather: grid (rows i, column blocks).  Thread j sums
//      b_val_t * B~[j, b_loc_t] over the CSR range of row i in t order.
//
// Both kernels are templates: the f64 build is K2, the f32 build K2-f32,
// the f32 and hybrid phases' formation on COO buckets (T = float, fmaf in
// the accumulation).
//
// Bound on the card: (a) does 2 G pad2 d^2 flops (arch0: 3.3e8) and
// writes B~ once, (b) reads (m+1) T entries of B~; at solver sizes the
// work is a fraction of a millisecond of f64 throughput and B~ traffic.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int TC = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

template <typename T>
__global__ void psd_coo_outer_kernel(
    const T *__restrict__ W, const long long *__restrict__ g_slot,
    const long long *__restrict__ g_blk, const long long *__restrict__ gp,
    const long long *__restrict__ gq, const T *__restrict__ gv,
    T *__restrict__ btf, int pad2, int d, int tiles) {
  __shared__ T sp[TC][TILE];  // gv_t * W[p_t, a0 + c]
  __shared__ T sq[TC][TILE];  // W[q_t, e0 + c]
  const int g = blockIdx.x;
  const int a0 = (blockIdx.y / tiles) * TILE;
  const int e0 = (blockIdx.y % tiles) * TILE;
  const long long blk = g_blk[g];
  const long long dd = (long long)d * d;
  const T *Wb = W + blk * dd;
  T *out = btf + g_slot[g] * dd;
  const long long *gpg = gp + (long long)g * pad2;
  const long long *gqg = gq + (long long)g * pad2;
  const T *gvg = gv + (long long)g * pad2;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int t0 = 0; t0 < pad2; t0 += TC) {
    for (int idx = threadIdx.x; idx < TC * TILE; idx += THREADS) {
      const int tt = idx / TILE, c = idx % TILE;
      const int t = t0 + tt;
      T wp = 0, wq = 0;
      if (t < pad2) {
        const int a = a0 + c, e = e0 + c;
        if (a < d) wp = Wb[gpg[t] * d + a] * gvg[t];
        if (e < d) wq = Wb[gqg[t] * d + e];
      }
      sp[tt][c] = wp;
      sq[tt][c] = wq;
    }
    __syncthreads();
    const int tn = min(TC, pad2 - t0);
    for (int tt = 0; tt < tn; ++tt) {
      T pa[4], qe[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sp[tt][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) qe[j] = sq[tt][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fma_t(pa[i], qe[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty + 16 * i;
    if (a >= d) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx + 16 * j;
      if (e < d) out[(long long)a * d + e] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void psd_coo_gather_kernel(const T *__restrict__ btf,
                                      const long long *__restrict__ rowptr,
                                      const long long *__restrict__ b_loc,
                                      const T *__restrict__ b_val,
                                      T *__restrict__ M, int mp1,
                                      long long kdd) {
  const int i = blockIdx.x;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= mp1) return;
  const T *bj = btf + (long long)j * kdd;
  T acc = 0;
  for (long long t = rowptr[i]; t < rowptr[i + 1]; ++t)
    acc += bj[b_loc[t]] * b_val[t];
  M[(long long)i * mp1 + j] = acc;
}

template <typename T>
int outer(const T *W, const long long *g_slot, const long long *g_blk,
          const long long *gp, const long long *gq, const T *gv, T *btf,
          int G, int pad2, int d, void *stream) {
  const int tiles = (d + TILE - 1) / TILE;
  if (G > 0) {
    dim3 grid(G, tiles * tiles);
    psd_coo_outer_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        W, g_slot, g_blk, gp, gq, gv, btf, pad2, d, tiles);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int gather(const T *btf, const long long *rowptr, const long long *b_loc,
           const T *b_val, T *M, int mp1, long long kdd, void *stream) {
  if (mp1 > 0) {
    dim3 grid(mp1, (mp1 + THREADS - 1) / THREADS);
    psd_coo_gather_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        btf, rowptr, b_loc, b_val, M, mp1, kdd);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int psd_coo_outer_launch(const double *W, const long long *g_slot,
                                    const long long *g_blk,
                                    const long long *gp, const long long *gq,
                                    const double *gv, double *btf, int G,
                                    int pad2, int d, void *stream) {
  return outer<double>(W, g_slot, g_blk, gp, gq, gv, btf, G, pad2, d,
                       stream);
}

extern "C" int psd_coo_gather_launch(const double *btf,
                                     const long long *rowptr,
                                     const long long *b_loc,
                                     const double *b_val, double *M, int mp1,
                                     long long kdd, void *stream) {
  return gather<double>(btf, rowptr, b_loc, b_val, M, mp1, kdd, stream);
}

extern "C" int psd_coo_outer_f32_launch(const float *W,
                                        const long long *g_slot,
                                        const long long *g_blk,
                                        const long long *gp,
                                        const long long *gq, const float *gv,
                                        float *btf, int G, int pad2, int d,
                                        void *stream) {
  return outer<float>(W, g_slot, g_blk, gp, gq, gv, btf, G, pad2, d,
                      stream);
}

extern "C" int psd_coo_gather_f32_launch(const float *btf,
                                         const long long *rowptr,
                                         const long long *b_loc,
                                         const float *b_val, float *M,
                                         int mp1, long long kdd,
                                         void *stream) {
  return gather<float>(btf, rowptr, b_loc, b_val, M, mp1, kdd, stream);
}
