// dot_flash_bwd_row: dq2 of dot_flash_apply's backward, row by row.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_attention.py::
// _dot_bwd_row_kernel (launched by _dot_bwd_row).  q2 [2, NsAll, dq],
// k [Nd, dq], x [Nd, dx], g [NsAll, dx] (the cotangent of out) f32 (dq, dx
// <= 64), mask [Ns, Nd] int8 (0/1: rows row0 .. row0 + Ns of the whole,
// dot_flash.cuh), m, z, delta [NsAll] f32 (delta = rowsum(g * out)), split
// (any column offset) -> dq2 [2, Ns, dq] f32 (the mask's rows):
//   dS = P * (g x^T - delta),  dq2[0] = dS[:, :split] @ k[:split],
//                              dq2[1] = dS[:, split:] @ k[split:],
// with P per edge from the stats (dot_flash.cuh's rule).  Every row and both
// planes are written: a row with no edge, and a plane whose segment holds
// none of the row's edges, get exact zeros.
//
// Bound on an H100 (SXM, 700 W): bytes.  At KGAT's hetrec shapes the three
// row types' masks (117 MB, about 0.035 ms a pass at 3.35 TB/s) are
// 0.46-1.49% dense, and each edge needs 4*dq + 2*dx + 5 float32 operations
// (its score, exponential, g . x product and dq multiply-adds: about
// 0.005 ms a pass at 67 TFLOP/s) and a gathered k row and x row from the L2
// (at most 3.4 MB each).  Each edge's products are against its own k and x
// rows: there is no shared tile for the tensor cores, so the kernel is
// CUDA-core float32 and its effort goes into keeping the mask stream and
// the gathers in flight.
//
// Design (mask_rows.cuh), as dot_flash_apply.cu: a row-streamed edge sweep.
// wpr warps own a row i, and its two q rows and its g row are staged once
// in shared memory; the row's constants (max(m, NEG), 1 / z, delta) sit in
// registers.  A warp works 8 edges (i, j) at a time, 4 lanes an edge: lane
// l takes the columns col_of(l, t) of k and x (as float4 where dq and dx
// are multiples of 4 and k and x lie on 16-byte boundaries, VEC), forms its
// parts of s = q2[p(j)][i] . k[j] (the plane chosen per edge, so the split
// needs no alignment) and of dp = g[i] . x[j], shuffles sum both, and it
// adds ds = P * (dp - delta) times the k values it loaded for s (kept in
// registers, not read again) to its 16 accumulators.  These hold one plane
// at a time: a warp's edges come in column order (the row's last bytes
// first), so the planes change at most three times a warp, and at each
// change, and at the row's end, three shuffles a value sum the warp's 8
// lane groups into the warp's part of shared memory for that plane (both
// planes' 32 accumulators spilled under the 128 registers a thread has at
// two blocks an SM).  The row's warps meet once in shared memory, and each
// plane's row is written once, without atomics.  A column off the row's
// edges is never read, so a non-finite k or x there does not reach the row
// (the plain version multiplies P = 0 by it), and an edge adds only to its
// own plane.

#include "dot_flash.cuh"

namespace dot_flash {

template <bool VEC>
__global__ void __launch_bounds__(mask_rows::NT, 2)
bwd_row_kernel(const float* __restrict__ q2, const float* __restrict__ k,
               const int8_t* __restrict__ mask, const float* __restrict__ ms,
               const float* __restrict__ zs, const float* __restrict__ x,
               const float* __restrict__ g, const float* __restrict__ delta,
               float* __restrict__ dq2, int Ns, int Nd, int dq, int dx,
               int split, int row0, int NsAll, int wpr) {
  using mask_rows::FULL;
  using mask_rows::G;
  using mask_rows::WARPS;
  __shared__ mask_rows::Warp ws[WARPS];
  __shared__ __align__(16) float rs[WARPS * 3 * QS2];  // q planes 0, 1; g
  __shared__ float part[WARPS][2 * MAXD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / wpr, p = warp % wpr;
  const int i = blockIdx.x * (WARPS / wpr) + slot;
  const int l = lane % G;
  float* row = rs + slot * 3 * QS2;
  if (i < Ns)  // the row's warps stage its two q rows and its g row
    for (int e = p * 32 + lane; e < 2 * dq + dx; e += wpr * 32) {
      if (e < 2 * dq) {
        const int pl = e / dq, c = e - pl * dq;
        row[pl * QS2 + c] = q2[((size_t)pl * NsAll + row0 + i) * dq + c];
      } else {
        row[2 * QS2 + e - 2 * dq] = g[(size_t)(row0 + i) * dx + e - 2 * dq];
      }
    }
  __syncthreads();

  // The lane's columns of plane `hi` (warp-uniform) of the row's dq2; the
  // warp adds them to its part of shared memory whenever a step of 8 edges
  // holds an edge of the other plane, and at the row's end.
  float acc[CL];
  bool hi = false;
#pragma unroll
  for (int t = 0; t < CL; ++t) acc[t] = 0.f;
  for (int c = lane; c < 2 * MAXD; c += 32) part[warp][c] = 0.f;
  __syncwarp();
  auto flush = [&]() {  // the warp's 8 lane groups into part, acc cleared
#pragma unroll
    for (int t = 0; t < CL; ++t) {
#pragma unroll
      for (int off = G; off < 32; off <<= 1)
        acc[t] += __shfl_xor_sync(FULL, acc[t], off);
      if (lane < G) part[warp][(hi ? MAXD : 0) + col_of<VEC>(l, t)] += acc[t];
      acc[t] = 0.f;
    }
  };
  if (i < Ns) {  // uniform over the row's warps
    float mc, iz;
    row_consts(mc, iz, ms, zs, row0 + i, NsAll);
    const float dl = delta[row0 + i];
    const float* gr = row + 2 * QS2;
    auto work = [&](int j, float v, bool valid) {
      const bool on = valid && v > 0.f;
      const bool mine = j >= split;  // this edge's plane
      const float* qp = row + (mine ? QS2 : 0);
      const float* krow = k + (size_t)j * dq;
      const float* xrow = x + (size_t)j * dx;
      float s = 0.f, dp = 0.f, kv[CL];
#pragma unroll
      for (int t = 0; t < CL; t += 4) {
        const int c = col_of<VEC>(l, t);
        if (VEC) {
          const bool kin = on && c < dq, xin = on && c < dx;
          const float4 b = kin ? __ldg((const float4*)(krow + c))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          kv[t] = b.x;
          kv[t + 1] = b.y;
          kv[t + 2] = b.z;
          kv[t + 3] = b.w;
          if (kin) {
            const float4 a = *(const float4*)(qp + c);
            s = fmaf(a.x, b.x, s);
            s = fmaf(a.y, b.y, s);
            s = fmaf(a.z, b.z, s);
            s = fmaf(a.w, b.w, s);
          }
          if (xin) {
            const float4 xq = __ldg((const float4*)(xrow + c));
            const float4 gq = *(const float4*)(gr + c);
            dp = fmaf(gq.x, xq.x, dp);
            dp = fmaf(gq.y, xq.y, dp);
            dp = fmaf(gq.z, xq.z, dp);
            dp = fmaf(gq.w, xq.w, dp);
          }
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int cu = col_of<VEC>(l, t + u);
            kv[t + u] = on && cu < dq ? __ldg(krow + cu) : 0.f;
            if (on && cu < dq) s = fmaf(qp[cu], kv[t + u], s);
            if (on && cu < dx) dp = fmaf(gr[cu], __ldg(xrow + cu), dp);
          }
        }
      }
      s += __shfl_xor_sync(FULL, s, 1);
      s += __shfl_xor_sync(FULL, s, 2);
      dp += __shfl_xor_sync(FULL, dp, 1);
      dp += __shfl_xor_sync(FULL, dp, 2);
      // 0 off the edges, where kv is 0 too
      const float ds = on ? expf(s - mc) * v * iz * (dp - dl) : 0.f;
      const bool other = on && mine != hi;
      if (__any_sync(FULL, other)) {  // an edge of the other plane: change
        if (!other)
#pragma unroll
          for (int t = 0; t < CL; ++t) acc[t] = fmaf(ds, kv[t], acc[t]);
        flush();
        hi = !hi;
        if (other)
#pragma unroll
          for (int t = 0; t < CL; ++t) acc[t] = fmaf(ds, kv[t], acc[t]);
      } else {
#pragma unroll
        for (int t = 0; t < CL; ++t) acc[t] = fmaf(ds, kv[t], acc[t]);
      }
    };
    mask_rows::sweep_row<true>(mask + (size_t)i * Nd, Nd, p, wpr, ws[warp],
                               work);
    flush();
  }
  __syncthreads();
  if (i < Ns && p == 0)
    for (int o = lane; o < 2 * dq; o += 32) {
      const int pl = o / dq, c = o - pl * dq;
      float sum = 0.f;
      for (int w = 0; w < wpr; ++w) sum += part[warp + w][pl * MAXD + c];
      dq2[((size_t)pl * Ns + i) * dq + c] = sum;
    }
}

}  // namespace dot_flash

// Launches one row-backward sweep on `stream`; returns cudaGetLastError().
extern "C" int dot_flash_bwd_row_f32(const float* q2, const float* k,
                                     const int8_t* mask, const float* m,
                                     const float* z, const float* x,
                                     const float* g, const float* delta,
                                     float* dq2, int Ns, int Nd, int dq,
                                     int dx, int split, int row0, int NsAll,
                                     void* stream) {
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
    bwd_row_kernel<true><<<blocks, mask_rows::NT, 0, st>>>(
        q2, k, mask, m, z, x, g, delta, dq2, Ns, Nd, dq, dx, split, row0,
        NsAll, wpr);
  else
    bwd_row_kernel<false><<<blocks, mask_rows::NT, 0, st>>>(
        q2, k, mask, m, z, x, g, delta, dq2, Ns, Nd, dq, dx, split, row0,
        NsAll, wpr);
  return (int)cudaGetLastError();
}
