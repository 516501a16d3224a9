// Trailing update of one elimination-tree level: kernel K9.
//
// Replaces the update part of the reference's sedumi_tpu/sparse_chol.py:469
// factor_tiles_ur (:514-521; the same maths as factor_tiles :208 and
// factor_tiles_lv :264): st[pdst] -= st[pa] st[pb]' over the level's valid
// update pairs, which the reference gathers, multiplies as a batched einsum
// and scatter-adds.
//
// Grid (destination slot, 64 x 64 sub-tile of the B x B tile).  A block
// walks its destination's pairs in plan order through the level's CSR
// (pair_ptr, built on the host), streams 16-wide slabs of A's rows and B's
// rows through shared memory (2 x 16 x 64 doubles = 16 KB), keeps a 4 x 4
// register tile per thread (256 threads), and subtracts the accumulated
// sum from the destination once.  No two blocks write the same element,
// so there are no atomics and two runs give the same factor.  Within a
// level no pair reads a tile that another pair writes: sources lie in the
// level's own columns, destinations in their ancestors' columns.
//
// The kernel is a template: the f64 build is K9, the f32 build K9-f32
// (the f32 tile storage of the precision ladder's f32 and hybrid phases;
// fmaf in the accumulation, 8 KB of slabs).
//
// Bound on the card: 2 B^3 flops per pair against three tile reads and one
// write per destination; at B = 128 the f64 (f32) rate bounds it.

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

template <typename Real>
__global__ void tile_update_kernel(Real *__restrict__ st,
                                   const long long *__restrict__ pair_dst,
                                   const long long *__restrict__ pair_ptr,
                                   const long long *__restrict__ pair_a,
                                   const long long *__restrict__ pair_b,
                                   int B, int tiles) {
  __shared__ Real sa[TC][TILE];  // A[a0 + c][t0 + tt]
  __shared__ Real sb[TC][TILE];  // Bm[e0 + c][t0 + tt]
  const int dst = blockIdx.x;
  const int a0 = (blockIdx.y / tiles) * TILE;
  const int e0 = (blockIdx.y % tiles) * TILE;
  const long long BB = (long long)B * B;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  Real acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (long long p = pair_ptr[dst]; p < pair_ptr[dst + 1]; ++p) {
    const Real *A = st + pair_a[p] * BB;
    const Real *Bm = st + pair_b[p] * BB;
    for (int t0 = 0; t0 < B; t0 += TC) {
      for (int idx = threadIdx.x; idx < TC * TILE; idx += THREADS) {
        const int c = idx / TC, tt = idx % TC;
        const int t = t0 + tt;
        Real va = 0, vb = 0;
        if (t < B) {
          if (a0 + c < B) va = A[(long long)(a0 + c) * B + t];
          if (e0 + c < B) vb = Bm[(long long)(e0 + c) * B + t];
        }
        sa[tt][c] = va;
        sb[tt][c] = vb;
      }
      __syncthreads();
      const int tn = min(TC, B - t0);
      for (int tt = 0; tt < tn; ++tt) {
        Real pa[4], qe[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = sa[tt][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) qe[j] = sb[tt][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fma_t(pa[i], qe[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  Real *D = st + pair_dst[dst] * BB;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty + 16 * i;
    if (a >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx + 16 * j;
      if (e < B) D[(long long)a * B + e] -= acc[i][j];
    }
  }
}

template <typename Real>
int update_launch(Real *st, const long long *pair_dst,
                  const long long *pair_ptr, const long long *pair_a,
                  const long long *pair_b, int nd, int B, void *stream) {
  const int tiles = (B + TILE - 1) / TILE;
  if (nd > 0) {
    dim3 grid(nd, tiles * tiles);
    tile_update_kernel<Real><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        st, pair_dst, pair_ptr, pair_a, pair_b, B, tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tile_update_launch(double *st, const long long *pair_dst,
                                  const long long *pair_ptr,
                                  const long long *pair_a,
                                  const long long *pair_b, int nd, int B,
                                  void *stream) {
  return update_launch(st, pair_dst, pair_ptr, pair_a, pair_b, nd, B, stream);
}

extern "C" int tile_update_f32_launch(float *st, const long long *pair_dst,
                                      const long long *pair_ptr,
                                      const long long *pair_a,
                                      const long long *pair_b, int nd, int B,
                                      void *stream) {
  return update_launch(st, pair_dst, pair_ptr, pair_a, pair_b, nd, B, stream);
}
