// Trailing update of one elimination-tree level: kernel K9.
//
// Replaces the update part of the reference's sedumi_tpu/sparse_chol.py:469
// factor_tiles_ur (:514-521; the same maths as factor_tiles :208 and
// factor_tiles_lv :264): st[pdst] -= st[pa] st[pb]' over the level's valid
// update pairs, which the reference gathers, multiplies as a batched einsum
// and scatter-adds.
//
// Bound on the card: 2 B^3 flops per pair against three tile reads and one
// write per destination; at B = 128 the f64 (f32) rate bounds it, and the
// f64 rate exists only on the tensor cores.  What holds it back on an H100
// is streaming the tiles from L2: a block moves 128 KB a pair for 1 MFLOP
// (64 x 64 of B x B, both operands' 64 rows), ~6 us a pair for one block
// alone on an SM, where its tensor-core work takes ~3 us (measured with
// clock stamps and a compute-only copy; TMA bulk copies in place of
// cp.async, more stages and a later issue of the next loads changed
// nothing).
//
// Work list.  The host splits each destination's pairs (CSR by destination,
// plan order) into chunks of at most ceil(pairs / destinations) pairs
// (sparse_chol.level_maps: chunk_ptr, chunk_dst, dst_chunk, dst_part,
// part_chunk).  The plans' levels give almost every destination one pair;
// a destination with more than the level's mean is split, so no block walks
// a long pair list while the others idle.  Grid (chunk, 64 x 64 sub-tile of
// the B x B tile, B <= 128).
//
// A block streams its chunk's pairs through a ring of three shared-memory
// stages by cp.async: each stage holds a 32-wide k slab of A's 64 rows and
// of B's 64 rows, as they lie in memory (rows t-contiguous), padded to a
// row stride of 36 so that the fragment loads hit distinct banks.  Tails
// (B not a multiple of 64 or 32) are zero-filled by the copy.
//
// f64 (K9): four warps, each a 32 x 32 accumulator in registers, multiply
// on the f64 tensor cores with mma.sync m16n8k16 (A row-major and B's rows
// are exactly the .row.col operands, so nothing is transposed; m8n8k4 runs
// at half the rate on the H100).  f32 (K9-f32): the same ring, 128 threads
// each an 8 x 4 register tile of fmaf on the CUDA cores, float4 loads of
// four k at a time; no TF32, which would round the f32 phase differently.
//
// A destination of one chunk subtracts its sum from the tile directly (all
// of a thread's loads of the tile before its stores).  The
// chunks of a split destination write their sums to scratch (`part`, slots
// in chunk order); the last block to arrive, counted by an atomic ticket per
// (destination, sub-tile), adds the slots in chunk order, subtracts the sum
// once and resets the ticket.  No value is added atomically and no two
// blocks write one element of st, so two runs give the same bits.  Within a
// level no pair reads a tile that another pair writes: sources lie in the
// level's own columns, destinations in their ancestors' columns.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;     // sub-tile of the destination per block
constexpr int KS = 32;       // k slab per stage
constexpr int LDS = KS + 4;  // slab row stride in shared memory
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int MAX_SUB = 4;   // sub-tiles per destination at B <= 128

__device__ __forceinline__ unsigned smem_addr(const void *p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// `bytes` (4, 8 or 16) from src into shared dst; zeros when !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(void *dst, const void *src,
                                         bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage: k slab [t0, t0 + KS) of rows r0.. r0 + 63 of tile `src` into
// dst[TILE][LDS]; VEC elements a copy when the rows allow it.
template <typename Real>
__device__ __forceinline__ void load_slab(Real *dst, const Real *src, int r0,
                                          int t0, int B, bool vec) {
  constexpr int VEC = 16 / sizeof(Real);
  if (vec) {
    for (int i = threadIdx.x; i < TILE * KS / VEC; i += THREADS) {
      const int r = i / (KS / VEC), c = (i % (KS / VEC)) * VEC;
      const bool ok = r0 + r < B && t0 + c < B;
      cp_async<16>(dst + r * LDS + c,
                   ok ? src + (long long)(r0 + r) * B + t0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * KS; i += THREADS) {
      const int r = i / KS, c = i % KS;
      const bool ok = r0 + r < B && t0 + c < B;
      cp_async<sizeof(Real)>(dst + r * LDS + c,
                             ok ? src + (long long)(r0 + r) * B + t0 + c : src,
                             ok);
    }
  }
}

__device__ __forceinline__ void mma16816(double *d, const double *a,
                                         const double *b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Per-thread accumulator: f64 a warp's 32 x 32 as 2 x 4 m16n8 fragments,
// f32 an 8 x 4 tile (rows ty + 8 i, columns tx + 16 j).
template <typename Real>
struct Acc;

template <>
struct Acc<double> {
  double c[2][4][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) c[i][j][r] = 0.0;
  }
  // one k slab: A rows sa[TILE][LDS], B rows sb[TILE][LDS], 16 k an mma
  __device__ void step(const double *sa, const double *sb) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = (warp >> 1) * 32, n0 = (warp & 1) * 32;
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += 16) {
      double a[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          a[i][q] = sa[(m0 + 16 * i + g + 8 * (q & 1)) * LDS + k0 + t +
                       4 * (q >> 1)];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        double b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          b[q] = sb[(n0 + 8 * j + g) * LDS + k0 + t + 4 * q];
#pragma unroll
        for (int i = 0; i < 2; ++i) mma16816(c[i][j], a[i], b);
      }
    }
  }
  static constexpr int N = 32;
  // visit (k, row, column, value) of the N elements this thread holds
  template <typename F>
  __device__ void each(F f) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = (warp >> 1) * 32, n0 = (warp & 1) * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          f(16 * i + 4 * j + r, m0 + 16 * i + g + 8 * (r >> 1),
            n0 + 8 * j + 2 * t + (r & 1), c[i][j][r]);
  }
};

template <>
struct Acc<float> {
  float c[8][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
  }
  __device__ void step(const float *sa, const float *sb) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int k4 = 0; k4 < KS; k4 += 4) {
      float4 a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4 *>(sa + (ty + 8 * i) * LDS + k4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4 *>(sb + (tx + 16 * j) * LDS + k4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
          c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
          c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
          c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
        }
    }
  }
  static constexpr int N = 32;
  template <typename F>
  __device__ void each(F f) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(4 * i + j, ty + 8 * i, tx + 16 * j, c[i][j]);
  }
};

struct WorkList {
  const long long *pair_dst, *pair_a, *pair_b;
  const long long *chunk_ptr, *chunk_dst, *dst_chunk, *dst_part;
  int *ticket;
};

template <typename Real>
__global__ void __launch_bounds__(THREADS)
    tile_update_kernel(Real *__restrict__ st, WorkList w,
                       Real *__restrict__ part, int B, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Real *sa = reinterpret_cast<Real *>(smem_raw);    // [STAGES][TILE][LDS]
  Real *sb = sa + STAGES * TILE * LDS;
  __shared__ int s_last;
  const int chunk = blockIdx.x, sub = blockIdx.y, nsub = gridDim.y;
  const int tiles = (B + TILE - 1) / TILE;
  const int a0 = (sub / tiles) * TILE, e0 = (sub % tiles) * TILE;
  const long long BB = (long long)B * B;
  const long long p0 = w.chunk_ptr[chunk], p1 = w.chunk_ptr[chunk + 1];
  const int nslab = (B + KS - 1) / KS;
  const int steps = (int)(p1 - p0) * nslab;

  auto issue = [&](int s) {
    if (s < steps) {
      const long long p = p0 + s / nslab;
      const int t0 = (s % nslab) * KS, stage = s % STAGES;
      load_slab(sa + stage * TILE * LDS, st + w.pair_a[p] * BB, a0, t0, B,
                vec);
      load_slab(sb + stage * TILE * LDS, st + w.pair_b[p] * BB, e0, t0, B,
                vec);
    }
    cp_commit();
  };

  Acc<Real> acc;
  acc.zero();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; stage s - 1 is free to refill
    issue(s + STAGES - 1);
    const int stage = s % STAGES;
    acc.step(sa + stage * TILE * LDS, sb + stage * TILE * LDS);
  }
  cp_wait<0>();

  const long long d = w.chunk_dst[chunk];
  Real *D = st + w.pair_dst[d] * BB;
  const long long slot0 = w.dst_part[d];
  if (slot0 < 0) {  // the destination's only chunk: every load of D
    Real dv[Acc<Real>::N];  // before any store, so none waits for another
    acc.each([&](int k, int r, int c, Real) {
      if (a0 + r < B && e0 + c < B)
        dv[k] = D[(long long)(a0 + r) * B + e0 + c];
    });
    acc.each([&](int k, int r, int c, Real v) {
      if (a0 + r < B && e0 + c < B)
        D[(long long)(a0 + r) * B + e0 + c] = dv[k] - v;
    });
    return;
  }
  const long long first = w.dst_chunk[d];
  const int n = (int)(w.dst_chunk[d + 1] - first);
  Real *mine = part + ((slot0 + chunk - first) * nsub + sub) * TILE * TILE;
  acc.each([&](int, int r, int c, Real v) { mine[r * TILE + c] = v; });
  __threadfence();
  __syncthreads();
  int *ticket = w.ticket + d * MAX_SUB + sub;
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == n - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the chunks' sums in chunk order, RED elements a thread at once: every
  // load of a batch before its stores, so the loads overlap
  constexpr int RED = 8;
  for (int i0 = threadIdx.x; i0 < TILE * TILE; i0 += RED * THREADS) {
    Real v[RED], dv[RED];
    long long at[RED];
#pragma unroll
    for (int u = 0; u < RED; ++u) {
      const int i = i0 + u * THREADS, r = i / TILE, c = i % TILE;
      at[u] = a0 + r < B && e0 + c < B ? (long long)(a0 + r) * B + e0 + c
                                       : -1;
      v[u] = __ldcg(part + (slot0 * nsub + sub) * TILE * TILE + i);
    }
    for (int k = 1; k < n; ++k)
#pragma unroll
      for (int u = 0; u < RED; ++u)
        v[u] += __ldcg(part + ((slot0 + k) * nsub + sub) * TILE * TILE + i0 +
                       u * THREADS);
#pragma unroll
    for (int u = 0; u < RED; ++u)
      if (at[u] >= 0) dv[u] = D[at[u]];
#pragma unroll
    for (int u = 0; u < RED; ++u)
      if (at[u] >= 0) D[at[u]] = dv[u] - v[u];
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <typename Real>
int update_launch(Real *st, WorkList w, Real *part, int nchunk, int B,
                  void *stream) {
  static bool configured = false;
  const size_t smem = 2 * (size_t)STAGES * TILE * LDS * sizeof(Real);
  if (B <= 0 || B > MAX_SUB / 2 * TILE) return (int)cudaErrorInvalidValue;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_update_kernel<Real>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tile_update_kernel<Real>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int tiles = (B + TILE - 1) / TILE;
  constexpr int VEC = 16 / sizeof(Real);
  const int vec = B % VEC == 0 && (unsigned long long)st % 16 == 0;
  if (nchunk > 0) {
    dim3 grid(nchunk, tiles * tiles);
    tile_update_kernel<Real><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        st, w, part, B, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// st [nslot, B, B]; pair_dst [ndst]; pair_a, pair_b [npairs] (plan order);
// chunk_ptr [nchunk + 1], chunk_dst [nchunk]; dst_chunk [ndst + 1],
// dst_part [ndst]; ticket int[4 ndst], zero on entry and on exit; part
// scratch of (split chunks) x (sub-tiles) x 64 x 64; B <= 128.
extern "C" int tile_update_launch(double *st, const long long *pair_dst,
                                  const long long *pair_a,
                                  const long long *pair_b,
                                  const long long *chunk_ptr,
                                  const long long *chunk_dst,
                                  const long long *dst_chunk,
                                  const long long *dst_part, int *ticket,
                                  double *part, int nchunk, int B,
                                  void *stream) {
  return update_launch(st,
                       WorkList{pair_dst, pair_a, pair_b, chunk_ptr, chunk_dst,
                                dst_chunk, dst_part, ticket},
                       part, nchunk, B, stream);
}

extern "C" int tile_update_f32_launch(float *st, const long long *pair_dst,
                                      const long long *pair_a,
                                      const long long *pair_b,
                                      const long long *chunk_ptr,
                                      const long long *chunk_dst,
                                      const long long *dst_chunk,
                                      const long long *dst_part, int *ticket,
                                      float *part, int nchunk, int B,
                                      void *stream) {
  return update_launch(st,
                       WorkList{pair_dst, pair_a, pair_b, chunk_ptr, chunk_dst,
                                dst_chunk, dst_part, ticket},
                       part, nchunk, B, stream);
}
