// Double-float (two-f32) compensated GEMV and GEMV-transpose (df.py, K11).
//
// Replaces the reference's sedumi_tpu/df.py:94 df_matvec and :127
// df_vecmat (the products of DfAOp, :161): elementwise error-free f32
// TwoProd over n-chunks of 16384 and a pairwise TwoSum tree.  A df number
// is an unevaluated sum hi + lo of two f32 (resolution ~2^-48); the
// operator is stored as hi/lo pairs A = Ah + Al, the vector as x = xh + xl.
// Per element both entry points form
//   p + e = Ah_j xh_j exactly (e = fmaf(Ah, xh, -p); --fmad=false keeps
//           every other product and sum rounded on its own),
//   c     = (e + Ah_j xl_j) + Al_j xh_j   (Al xl, below 2^-48, dropped),
// and add (p, c) into a running df sum (s, t): TwoSum(s, p) = s1 + err,
// t += err + c, then TwoSum(s1, t) renormalises so |t| <= ulp(s)/2.
//
// Order (tests/gemv_emulation.py repeats it step for step):
//
//  * df_matvec: [rows, n] x [n] -> [rows].  A row starts mis floats past a
//    16-byte boundary: its first h = (4 - mis) mod 4 elements (at most n)
//    are the head, then nv float4 vectors, then a tail of tl < 4.  The
//    body is cut into nslab slabs of vps vectors, and a warp owns a (row,
//    slab): lane l takes the slab's vectors l, l + 32, ... in ascending
//    order (each vector's four elements in order), slab 0 also head element
//    l (l < h) first, the last slab tail element l (l < tl) last.  A lane
//    issues MV_UNROLL vectors' loads of Ah, Al, xh and xl before it sums
//    them.  The lanes merge by a shuffle tree of df additions (lane l
//    takes lane l + off, off = 16 ... 1).  With one slab lane 0 writes y;
//    else it writes its (s, t) partial to scratch, and the last warp to
//    reach the row (a ticket counted with atomicAdd after a fence) merges
//    the row's partials in ascending slab order (the first partial, then
//    df_add of each next) and resets the ticket to 0, so a second call or
//    a graph replay finds it at 0 again.
//  * df_vecmat: [rows] x [rows, n] -> [n].  A thread owns VM_C = 4
//    adjacent columns, a block of 128 threads 512; the rows are cut into
//    nslab slabs of rps rows (blockIdx.y), each summed in ascending row
//    order, the next VM_UNROLL rows' loads issued before the current
//    ones' sums.  Rows that all start on 16-byte boundaries are read as
//    float4, others by scalar loads of the same columns (the same values,
//    the same order).  The partials merge as df_matvec's, by the last
//    block to reach the column block, VM_MERGE slabs' loads at a time.
//
// Error: against the exact sum of (Ah + Al)(xh + xl) each step adds at
// most ~(3 S + 2 |a_j x_j|) u^2 (S = sum_j |a_j x_j|, u = 2^-24), so a sum
// over a chain of L steps is within (3 L + 30) u^2 S: for df_matvec L = 4
// ceil(vps / 32) + 2 terms a lane, 5 tree levels and nslab - 1 merges;
// for df_vecmat L = rps + nslab - 1.  The reference's tree is within
// ((D + c)(D + c + 2) + 7) u^2 S for a tree of depth D over c chunks.  The
// orders differ; the bounds hold the two together.
//
// Bound on the card: memory.  Each product reads the 8 bytes of a hi/lo
// pair once and does ~25 f32 operations on it (the card's f32 rate is
// 67 TFLOP/s, its memory 3.35 TB/s: 3.1 operations per byte would be the
// balance), so the floor is 8 rows n bytes over 3.35 TB/s.  The slabs give
// the card enough warps and bytes in flight to reach it at a thousand rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MV_THREADS = 256;  // 8 (row, slab) warps a block
constexpr int MV_UNROLL = 4;
constexpr int VM_THREADS = 128;
constexpr int VM_C = 4;       // adjacent columns a thread owns: a float4
constexpr int VM_UNROLL = 4;
constexpr int VM_MERGE = 32 / VM_C;  // slab partials loaded at once

__device__ __forceinline__ void two_sum(float a, float b, float &s,
                                        float &e) {
  s = a + b;
  float v = s - a;
  e = (a - (s - v)) + (b - v);
}

// (s, t) += a * x in df, a = ah + al, x = xh + xl
__device__ __forceinline__ void df_madd(float ah, float al, float xh,
                                        float xl, float &s, float &t) {
  const float p = ah * xh;
  const float e = fmaf(ah, xh, -p);  // exact: ah*xh = p + e
  const float c = (e + ah * xl) + al * xh;
  float s1, err;
  two_sum(s, p, s1, err);
  t = t + (err + c);
  two_sum(s1, t, s, t);
}

// (s, t) += (s2, t2) in df
__device__ __forceinline__ void df_add(float s2, float t2, float &s,
                                       float &t) {
  float h, err;
  two_sum(s, s2, h, err);
  t = (t + t2) + err;
  two_sum(h, t, s, t);
}

__device__ __forceinline__ float get(const float4 &x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

// four floats from p: one 16-byte load where p is aligned, else four
__device__ __forceinline__ float4 ld4(const float *p, bool vec) {
  if (vec) return *reinterpret_cast<const float4 *>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

bool aligned16(const void *p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(MV_THREADS)
    df_matvec_kernel(const float *__restrict__ Ah,
                     const float *__restrict__ Al, long long lda,
                     const float *__restrict__ xh,
                     const float *__restrict__ xl, float *__restrict__ yh,
                     float *__restrict__ yl, float *__restrict__ part,
                     int *__restrict__ tickets, int rows, int n, int nslab,
                     int vps) {
  const long long g =
      ((long long)blockIdx.x * MV_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int row = (int)(g / nslab), slab = (int)(g % nslab);
  if (row >= rows) return;  // the whole warp leaves together
  const float *ah = Ah + (long long)row * lda;
  const float *al = Al + (long long)row * lda;
  const int mis = (int)((reinterpret_cast<uintptr_t>(ah) >> 2) & 3);
  const int h = min((4 - mis) & 3, n);
  const int nv = (n - h) >> 2;
  const int tl = n - h - 4 * nv;
  float s = 0.f, t = 0.f;
  if (slab == 0 && lane < h)
    df_madd(ah[lane], al[lane], xh[lane], xl[lane], s, t);
  const bool lvec = ((reinterpret_cast<uintptr_t>(al + h)) & 15) == 0;
  const bool xvec = ((reinterpret_cast<uintptr_t>(xh + h) |
                      reinterpret_cast<uintptr_t>(xl + h)) & 15) == 0;
  const float4 *a4 = reinterpret_cast<const float4 *>(ah + h);
  const int v0 = slab * vps, v1 = min(v0 + vps, nv);
  for (int k0 = v0 + lane; k0 < v1; k0 += 32 * MV_UNROLL) {
    float4 a[MV_UNROLL], b[MV_UNROLL], u[MV_UNROLL], w[MV_UNROLL];
#pragma unroll
    for (int q = 0; q < MV_UNROLL; ++q) {
      const int k = k0 + 32 * q;
      if (k < v1) {
        a[q] = a4[k];
        b[q] = ld4(al + h + 4 * k, lvec);
        u[q] = ld4(xh + h + 4 * k, xvec);
        w[q] = ld4(xl + h + 4 * k, xvec);
      }
    }
#pragma unroll
    for (int q = 0; q < MV_UNROLL; ++q) {
      if (k0 + 32 * q < v1) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          df_madd(get(a[q], c), get(b[q], c), get(u[q], c), get(w[q], c),
                  s, t);
      }
    }
  }
  if (slab == nslab - 1 && lane < tl) {
    const int j = h + 4 * nv + lane;
    df_madd(ah[j], al[j], xh[j], xl[j], s, t);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_down_sync(FULL, s, off);
    const float t2 = __shfl_down_sync(FULL, t, off);
    df_add(s2, t2, s, t);
  }
  if (nslab == 1) {
    if (lane == 0) {
      yh[row] = s;
      yl[row] = t;
    }
    return;
  }
  float *p = part + 2LL * row * nslab;
  int last = 0;
  if (lane == 0) {
    p[2 * slab] = s;
    p[2 * slab + 1] = t;
    __threadfence();
    last = atomicAdd(&tickets[row], 1) == nslab - 1;
  }
  if (!__shfl_sync(FULL, last, 0)) return;
  __threadfence();
  float ms = 0.f, mt = 0.f;
  for (int b0 = 0; b0 < nslab; b0 += 32) {
    float ps = 0.f, pt = 0.f;
    if (b0 + lane < nslab) {
      ps = __ldcg(p + 2 * (b0 + lane));
      pt = __ldcg(p + 2 * (b0 + lane) + 1);
    }
    const int cnt = min(32, nslab - b0);
    for (int k = 0; k < cnt; ++k) {
      const float s2 = __shfl_sync(FULL, ps, k);
      const float t2 = __shfl_sync(FULL, pt, k);
      if (b0 + k == 0) {
        ms = s2;
        mt = t2;
      } else {
        df_add(s2, t2, ms, mt);
      }
    }
  }
  if (lane == 0) {
    yh[row] = ms;
    yl[row] = mt;
    tickets[row] = 0;
  }
}

__global__ void __launch_bounds__(VM_THREADS)
    df_vecmat_kernel(const float *__restrict__ xh,
                     const float *__restrict__ xl,
                     const float *__restrict__ Ah,
                     const float *__restrict__ Al, long long lda,
                     float *__restrict__ yh, float *__restrict__ yl,
                     float *__restrict__ part, int *__restrict__ tickets,
                     int rows, int n, int nslab, int rps, int vec) {
  __shared__ int last;
  const int j = (blockIdx.x * VM_THREADS + threadIdx.x) * VM_C;
  const int slab = blockIdx.y;
  const int r0 = slab * rps, r1 = min(rows, r0 + rps);
  const int ncol = min(VM_C, n - j);  // <= 0 past the last column
  float s[VM_C], t[VM_C];
#pragma unroll
  for (int c = 0; c < VM_C; ++c) s[c] = t[c] = 0.f;
  if (ncol > 0) {
    const bool full = vec && ncol == VM_C;
    // the next VM_UNROLL rows' loads are issued before this step's sums
    float4 a[VM_UNROLL], b[VM_UNROLL];
    float u[VM_UNROLL], w[VM_UNROLL];
    auto load = [&](int i0) {
#pragma unroll
      for (int q = 0; q < VM_UNROLL; ++q) {
        const int i = i0 + q;
        if (i < r1) {
          const float *ph = Ah + (long long)i * lda + j;
          const float *pl = Al + (long long)i * lda + j;
          if (full) {
            a[q] = *reinterpret_cast<const float4 *>(ph);
            b[q] = *reinterpret_cast<const float4 *>(pl);
          } else {
            a[q] = make_float4(ph[0], 1 < ncol ? ph[1] : 0.f,
                               2 < ncol ? ph[2] : 0.f, 3 < ncol ? ph[3] : 0.f);
            b[q] = make_float4(pl[0], 1 < ncol ? pl[1] : 0.f,
                               2 < ncol ? pl[2] : 0.f, 3 < ncol ? pl[3] : 0.f);
          }
          u[q] = xh[i];
          w[q] = xl[i];
        }
      }
    };
    load(r0);
    for (int i0 = r0; i0 < r1; i0 += VM_UNROLL) {
      float4 ca[VM_UNROLL], cb[VM_UNROLL];
      float cu[VM_UNROLL], cw[VM_UNROLL];
#pragma unroll
      for (int q = 0; q < VM_UNROLL; ++q) {
        ca[q] = a[q];
        cb[q] = b[q];
        cu[q] = u[q];
        cw[q] = w[q];
      }
      load(i0 + VM_UNROLL);
#pragma unroll
      for (int q = 0; q < VM_UNROLL; ++q) {
        if (i0 + q < r1) {
#pragma unroll
          for (int c = 0; c < VM_C; ++c)
            if (c < ncol)
              df_madd(get(ca[q], c), get(cb[q], c), cu[q], cw[q], s[c],
                      t[c]);
        }
      }
    }
  }
  if (nslab == 1) {
#pragma unroll
    for (int c = 0; c < VM_C; ++c)
      if (c < ncol) {
        yh[j + c] = s[c];
        yl[j + c] = t[c];
      }
    return;
  }
  float *ph = part, *pl = part + (long long)nslab * n;
#pragma unroll
  for (int c = 0; c < VM_C; ++c)
    if (c < ncol) {
      ph[(long long)slab * n + j + c] = s[c];
      pl[(long long)slab * n + j + c] = t[c];
    }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[blockIdx.x], 1) == nslab - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (ncol > 0) {
    float ms[VM_C], mt[VM_C];
#pragma unroll
    for (int c = 0; c < VM_C; ++c) {
      ms[c] = c < ncol ? __ldcg(ph + j + c) : 0.f;
      mt[c] = c < ncol ? __ldcg(pl + j + c) : 0.f;
    }
    // VM_MERGE slabs' loads in flight before their additions
    for (int k0 = 1; k0 < nslab; k0 += VM_MERGE) {
      float qs[VM_MERGE][VM_C], qt[VM_MERGE][VM_C];
#pragma unroll
      for (int q = 0; q < VM_MERGE; ++q)
#pragma unroll
        for (int c = 0; c < VM_C; ++c) {
          const bool live = k0 + q < nslab && c < ncol;
          const long long at = (long long)(k0 + q) * n + j + c;
          qs[q][c] = live ? __ldcg(ph + at) : 0.f;
          qt[q][c] = live ? __ldcg(pl + at) : 0.f;
        }
#pragma unroll
      for (int q = 0; q < VM_MERGE; ++q)
        if (k0 + q < nslab) {
#pragma unroll
          for (int c = 0; c < VM_C; ++c)
            df_add(qs[q][c], qt[q][c], ms[c], mt[c]);
        }
    }
#pragma unroll
    for (int c = 0; c < VM_C; ++c)
      if (c < ncol) {
        yh[j + c] = ms[c];
        yl[j + c] = mt[c];
      }
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
}

}  // namespace

// part: 2 rows nslab floats of scratch (unused with one slab); tickets:
// rows int32 zeros, left at zero
extern "C" int df_matvec_launch(const float *Ah, const float *Al,
                                long long lda, const float *xh,
                                const float *xl, float *yh, float *yl,
                                float *part, int *tickets, int rows, int n,
                                int nslab, int vps, void *stream) {
  if (nslab < 1 || (long long)nslab * vps < (long long)(n / 4))
    return (int)cudaErrorInvalidValue;
  const long long warps = (long long)rows * nslab;
  const long long blocks = (warps + MV_THREADS / 32 - 1) / (MV_THREADS / 32);
  if (blocks > 0)
    df_matvec_kernel<<<(unsigned)blocks, MV_THREADS, 0,
                       (cudaStream_t)stream>>>(Ah, Al, lda, xh, xl, yh, yl,
                                               part, tickets, rows, n, nslab,
                                               vps);
  return (int)cudaGetLastError();
}

// part: 2 nslab n floats of scratch (unused with one slab); tickets:
// ceil(n / (VM_C VM_THREADS)) = ceil(n / 512) int32 zeros, left at zero
extern "C" int df_vecmat_launch(const float *xh, const float *xl,
                                const float *Ah, const float *Al,
                                long long lda, float *yh, float *yl,
                                float *part, int *tickets, int rows, int n,
                                int nslab, int rps, void *stream) {
  if (nslab < 1 || rps < 1 || (long long)nslab * rps < rows ||
      nslab > 65535)
    return (int)cudaErrorInvalidValue;
  const int cols = (n + VM_C * VM_THREADS - 1) / (VM_C * VM_THREADS);
  const int vec = aligned16(Ah) && aligned16(Al) && (lda & 3) == 0;
  if (cols > 0)
    df_vecmat_kernel<<<dim3(cols, nslab), VM_THREADS, 0,
                       (cudaStream_t)stream>>>(xh, xl, Ah, Al, lda, yh, yl,
                                               part, tickets, rows, n, nslab,
                                               rps, vec);
  return (int)cudaGetLastError();
}
