// Factor-softmax routing as an edge sweep over the mask rows, shared by
// routed_mm.cu and routed_rowsum.cu.
//
// For every factor f, row n and column m of the routed adjacency
//   P_f[n, m] = exp(base + q_f[n] . k_f[m]) / sum_g exp(base + q_g[n] . k_g[m])
//               * mask[n, m]
// the two functions compute
//   routed_mm      out_f[n] = sum_m P_f[n, m] x_f[m]   (GATHER: an x row an edge)
//   routed_rowsum  d_f[n]   = sum_m P_f[n, m]          (x_f = 1: no gather)
// with one per-edge body, so that the two softmaxes cannot drift apart.
// q [F, NQ, r], k [F, M, r] f32, mask [N, M] int8 or bool (one byte a pair;
// multiplied by its value, as the Pallas kernels multiply p * m_tile),
// x [F, M, dx] f32; F <= 4, r <= 128, dx <= 16.  The mask's rows are rows
// row0 .. row0 + N of the whole (a rank's rows under a mesh, or all of them
// with row0 = 0 and N = NQ): row n reads q row row0 + n and writes out row
// n of [F, N, dx] (or [F, N]), so a rank's rows land in its part of a send
// buffer without a copy.  The softmax runs over the F
// factors of one (n, m) pair and has no max subtraction: the callers' scores
// are bounded (DGCF: |S| <= 1 + number of routing iterations), so exp
// cannot overflow.
//
// Design (mask_rows.cuh): wpr warps own a row n; its q rows (F x r floats)
// are staged once in shared memory.  A warp works 8 edges (n, m) at a time,
// 4 lanes an edge, lane f taking factor f: it forms s_f = q_f[n] . k_f[m]
// alone (r / 4 float4 loads of its k row and of q from shared memory, four
// partial sums), e_f = exp(base + s_f), two shuffles sum e over the
// factors, and it adds e_f * mask / sum_g e_g (times x_f[m], dx floats, if
// GATHER) to its own accumulators (dx of them, or one).  So a warp keeps 8
// edges' gathers in flight, and a heavy row (a tag row of 5,691 edges)
// takes 8 x 8 at a time.  At the row's end three shuffles sum the warp's 8
// lane groups, the row's warps meet once in shared memory, and each output
// row is written once, without atomics; a row with no edge gets 0.  Rows of
// k and x are read as float4 where r and dx are multiples of 4 and k and x
// lie on 16-byte boundaries (VEC), else one float at a time.  A column whose
// mask byte is 0 is never read, so a non-finite k or x there does not reach
// the row (a dense sweep gives NaN there, as the plain versions do).  There
// is no shared tile for the tensor cores: each edge is F dots of r against
// its own k rows, so the kernels are CUDA-core float32 and their effort goes
// into keeping the mask stream and the gathers in flight.

#pragma once

#include "mask_rows.cuh"

namespace routed {

using mask_rows::FULL;
using mask_rows::G;
using mask_rows::NT;
using mask_rows::WARPS;

constexpr int MAXF = G;      // one lane a factor
constexpr int MAXR = 128;
constexpr int MAXDX = 16;
constexpr int MAXQS = MAXR + 4;  // the widest stride of a staged q row

// The stride of a staged q row: a multiple of 4 floats (float4 reads) whose
// four factor rows start in four different bank quads.
__device__ __forceinline__ int q_stride(int r) { return ((r + 7) & ~7) + 4; }

// q_f[n] . k_f[m] over r columns.
template <bool VEC>
__device__ __forceinline__ float dot(const float* qf,
                                     const float* __restrict__ krow, int r) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (VEC) {
#pragma unroll 4
    for (int c = 0; c < r; c += 4) {
      const float4 a = *(const float4*)(qf + c);
      const float4 b = __ldg((const float4*)(krow + c));
      s[0] = fmaf(a.x, b.x, s[0]);
      s[1] = fmaf(a.y, b.y, s[1]);
      s[2] = fmaf(a.z, b.z, s[2]);
      s[3] = fmaf(a.w, b.w, s[3]);
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < r; ++c) s[0] = fmaf(qf[c], __ldg(krow + c), s[0]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// The body of both kernels: out [F, N, dx] (GATHER) or [F, N] (dx = 1, x
// unused).  Every thread of the block calls it.
template <bool VEC, bool GATHER>
__device__ __forceinline__ void sweep(const float* __restrict__ q,
                                      const float* __restrict__ k,
                                      const int8_t* __restrict__ mask,
                                      const float* __restrict__ x,
                                      float* __restrict__ out, int F, int N,
                                      int M, int r, int dx, int row0, int NQ,
                                      float base, int wpr) {
  constexpr int ACC = GATHER ? MAXDX : 1;  // accumulators a lane
  __shared__ mask_rows::Warp ws[WARPS];
  __shared__ __align__(16) float qs[WARPS * MAXF * MAXQS];
  __shared__ float part[WARPS][MAXF * ACC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / wpr, p = warp % wpr;
  const int n = blockIdx.x * (WARPS / wpr) + slot;
  const int f = lane % G;
  const bool fok = f < F;
  const int stride = q_stride(r);
  float* qrow = qs + slot * MAXF * stride;
  if (n < N)  // the row's warps stage its q rows
    for (int e = p * 32 + lane; e < F * r; e += wpr * 32) {
      const int ff = e / r, c = e - ff * r;
      qrow[ff * stride + c] = q[((size_t)ff * NQ + row0 + n) * r + c];
    }
  __syncthreads();

  float acc[ACC];
#pragma unroll
  for (int d = 0; d < ACC; ++d) acc[d] = 0.f;
  if (n < N) {  // uniform over the row's warps
    const float* qf = qrow + f * stride;
    const float* kf = k + (size_t)(fok ? f : 0) * M * r;
    const float* xf = GATHER ? x + (size_t)(fok ? f : 0) * M * dx : nullptr;
    auto work = [&](int m, float val, bool valid) {
      const bool on = valid && fok;
      const float s = on ? dot<VEC>(qf, kf + (size_t)m * r, r) : 0.f;
      float xv[ACC];
      if constexpr (GATHER) {
        const float* xrow = xf + (size_t)m * dx;
#pragma unroll
        for (int d = 0; d < MAXDX; d += 4) {
          if (VEC) {
            const float4 v = on && d < dx ? __ldg((const float4*)(xrow + d))
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
            xv[d] = v.x;
            xv[d + 1] = v.y;
            xv[d + 2] = v.z;
            xv[d + 3] = v.w;
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              xv[d + u] = on && d + u < dx ? __ldg(xrow + d + u) : 0.f;
          }
        }
      } else {
        xv[0] = 1.f;
      }
      const float ex = on ? expf(base + s) : 0.f;
      float den = ex + __shfl_xor_sync(FULL, ex, 1);
      den += __shfl_xor_sync(FULL, den, 2);
      const float w = on ? ex * (val / den) : 0.f;
#pragma unroll
      for (int d = 0; d < ACC; ++d) acc[d] = fmaf(w, xv[d], acc[d]);
    };
    mask_rows::sweep_row<false>(mask + (size_t)n * M, M, p, wpr, ws[warp],
                                work);
  }
  // the warp's 8 lane groups, then the row's warps
#pragma unroll
  for (int d = 0; d < ACC; ++d)
#pragma unroll
    for (int off = G; off < 32; off <<= 1)
      acc[d] += __shfl_xor_sync(FULL, acc[d], off);
  if (lane < G)
#pragma unroll
    for (int d = 0; d < ACC; ++d) part[warp][lane * ACC + d] = acc[d];
  __syncthreads();
  if (n < N && p == 0)
    for (int o = lane; o < F * dx; o += 32) {
      const int ff = o / dx, d = o - ff * dx;
      float sum = 0.f;
      for (int w = 0; w < wpr; ++w) sum += part[warp + w][ff * ACC + d];
      out[((size_t)ff * N + n) * dx + d] = sum;
    }
}

// The shapes both kernels take (0 = ok), as cudaError_t.
inline int check_shapes(int F, int N, int M, int r, int dx, int row0,
                        int NQ) {
  return F < 1 || F > MAXF || r < 1 || r > MAXR || dx < 0 || dx > MAXDX ||
                 M < 0 || M >= mask_rows::MAX_COLS || row0 < 0 ||
                 N > NQ - row0
             ? (int)cudaErrorInvalidValue
             : 0;
}

}  // namespace routed
