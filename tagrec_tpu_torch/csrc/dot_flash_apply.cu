// dot_flash_apply: out = P @ x for the masked two-segment row softmax P.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_attention.py::
// _dot_apply_kernel (launched by dot_flash_apply through _dot_apply).
// q2 [2, NsAll, dq], k [Nd, dq], x [Nd, dx] f32 (dq, dx <= 64), mask
// [Ns, Nd] int8 (0/1: rows row0 .. row0 + Ns of the whole, dot_flash.cuh),
// m, z [NsAll] f32 from dot_flash_stats, split (any column offset) -> out
// [Ns, dx] f32, where for each edge (i, j) (mask > 0)
//   S = q2[p(j)][i] . k[j],  p(j) = (j >= split),
//   P = exp(S - max(m[i], NEG)) * mask / (z[i] == 0 ? 1 : z[i])
// (dot_flash.cuh's rule); a row with no edge gives 0.  The row max and sum
// come from the stats, so P is known per edge without a pass over the row.
//
// Bound on an H100 (SXM, 700 W): bytes.  At KGAT's hetrec shapes the three
// row types' masks (2048 x 13312, 10240 x 5120, 3072 x 12288: 117 MB, about
// 0.035 ms a pass at 3.35 TB/s) are 0.46-1.49% dense, and each edge needs
// 2*dq + 3 + 2*dx float32 operations (about 0.004 ms a pass at 67 TFLOP/s)
// and a gathered k row and x row from the L2 (at most 3.4 MB each).  Each
// edge is one dot of dq against its own k row: there is no shared tile for
// the tensor cores, so the kernel is CUDA-core float32 and its effort goes
// into keeping the mask stream and the gathers in flight.
//
// Design (mask_rows.cuh): a row-streamed edge sweep.  wpr warps own a row i
// (up to 8: the user and tag row types run 2048 and 3072 blocks), and its
// two q rows are staged once in shared memory.  A warp works 8 edges (i, j)
// at a time, 4 lanes an edge: lane l takes the columns c = 4l + 16t (as
// float4 where dq and dx are multiples of 4 and k and x lie on 16-byte
// boundaries, VEC) or c = l + 4t (one float at a time), forms its part of S
// against the plane of the edge's segment (chosen per edge, so the split
// needs no alignment), two shuffles sum the 4 parts, and it adds P times
// its columns of x[j] to its accumulators.  At the row's end three shuffles
// sum the warp's 8 lane groups, the row's warps meet once in shared memory,
// and each output row is written once, without atomics.  A column off the
// row's edges is never read, so a non-finite k or x there does not reach
// the row (the plain version multiplies P = 0 by it).

#include "dot_flash.cuh"

namespace dot_flash {

template <bool VEC>
__global__ void __launch_bounds__(mask_rows::NT)
apply_kernel(const float* __restrict__ q2, const float* __restrict__ k,
             const int8_t* __restrict__ mask, const float* __restrict__ ms,
             const float* __restrict__ zs, const float* __restrict__ x,
             float* __restrict__ out, int Ns, int Nd, int dq, int dx,
             int split, int row0, int NsAll, int wpr) {
  using mask_rows::FULL;
  using mask_rows::G;
  using mask_rows::WARPS;
  __shared__ mask_rows::Warp ws[WARPS];
  __shared__ __align__(16) float qs[WARPS * 2 * QS2];
  __shared__ float part[WARPS][MAXD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / wpr, p = warp % wpr;
  const int i = blockIdx.x * (WARPS / wpr) + slot;
  const int l = lane % G;
  float* qrow = qs + slot * 2 * QS2;
  if (i < Ns)  // the row's warps stage its two q rows
    for (int e = p * 32 + lane; e < 2 * dq; e += wpr * 32) {
      const int pl = e / dq, c = e - pl * dq;
      qrow[pl * QS2 + c] = q2[((size_t)pl * NsAll + row0 + i) * dq + c];
    }
  __syncthreads();

  float acc[CL];
#pragma unroll
  for (int t = 0; t < CL; ++t) acc[t] = 0.f;
  if (i < Ns) {  // uniform over the row's warps
    float mc, iz;
    row_consts(mc, iz, ms, zs, row0 + i, NsAll);
    auto work = [&](int j, float v, bool valid) {
      const bool on = valid && v > 0.f;
      const float* qp = qrow + (j >= split ? QS2 : 0);
      const float* krow = k + (size_t)j * dq;
      const float* xrow = x + (size_t)j * dx;
      float s = 0.f, xv[CL];
#pragma unroll
      for (int t = 0; t < CL; t += 4) {
        const int c = col_of<VEC>(l, t);
        if (VEC) {
          if (on && c < dq) {
            const float4 a = *(const float4*)(qp + c);
            const float4 b = __ldg((const float4*)(krow + c));
            s = fmaf(a.x, b.x, s);
            s = fmaf(a.y, b.y, s);
            s = fmaf(a.z, b.z, s);
            s = fmaf(a.w, b.w, s);
          }
          const float4 xq = on && c < dx ? __ldg((const float4*)(xrow + c))
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
          xv[t] = xq.x;
          xv[t + 1] = xq.y;
          xv[t + 2] = xq.z;
          xv[t + 3] = xq.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int cu = col_of<VEC>(l, t + u);
            if (on && cu < dq) s = fmaf(qp[cu], __ldg(krow + cu), s);
            xv[t + u] = on && cu < dx ? __ldg(xrow + cu) : 0.f;
          }
        }
      }
      s += __shfl_xor_sync(FULL, s, 1);
      s += __shfl_xor_sync(FULL, s, 2);
      const float pv = on ? expf(s - mc) * v * iz : 0.f;
#pragma unroll
      for (int t = 0; t < CL; ++t) acc[t] = fmaf(pv, xv[t], acc[t]);
    };
    mask_rows::sweep_row<true>(mask + (size_t)i * Nd, Nd, p, wpr, ws[warp],
                               work);
  }
  // the warp's 8 lane groups, then the row's warps
#pragma unroll
  for (int t = 0; t < CL; ++t) {
#pragma unroll
    for (int off = G; off < 32; off <<= 1)
      acc[t] += __shfl_xor_sync(FULL, acc[t], off);
    if (lane < G) part[warp][col_of<VEC>(l, t)] = acc[t];
  }
  __syncthreads();
  if (i < Ns && p == 0)
    for (int d = lane; d < dx; d += 32) {
      float sum = 0.f;
      for (int w = 0; w < wpr; ++w) sum += part[warp + w][d];
      out[(size_t)i * dx + d] = sum;
    }
}

}  // namespace dot_flash

// Launches one apply sweep on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int dot_flash_apply_f32(const float* q2, const float* k,
                                   const int8_t* mask, const float* m,
                                   const float* z, const float* x, float* out,
                                   int Ns, int Nd, int dq, int dx, int split,
                                   int row0, int NsAll, void* stream) {
  using namespace dot_flash;
  if (dq < 1 || dq > MAXD || dx < 0 || dx > MAXD || Nd < 0 ||
      Nd >= mask_rows::MAX_COLS || row0 < 0 || Ns > NsAll - row0)
    return (int)cudaErrorInvalidValue;
  if (Ns <= 0) return 0;
  const int wpr = mask_rows::warps_per_row(Nd);
  const int blocks = mask_rows::blocks_for(Ns, wpr);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = dq % 4 == 0 && dx % 4 == 0 && (uintptr_t)k % 16 == 0 &&
                   (uintptr_t)x % 16 == 0;
  if (vec)
    apply_kernel<true><<<blocks, mask_rows::NT, 0, st>>>(
        q2, k, mask, m, z, x, out, Ns, Nd, dq, dx, split, row0, NsAll, wpr);
  else
    apply_kernel<false><<<blocks, mask_rows::NT, 0, st>>>(
        q2, k, mask, m, z, x, out, Ns, Nd, dq, dx, split, row0, NsAll, wpr);
  return (int)cudaGetLastError();
}
