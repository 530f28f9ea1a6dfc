// dot_flash_bwd_col: dk and dx of dot_flash_apply's backward, column by
// column, as an edge sweep over the mask's transpose.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_attention.py::
// _dot_bwd_col_kernel (launched by _dot_bwd_col).  q2 [2, Ns, dq],
// k [NdAll, dq], x [NdAll, dx], g [Ns, dx] (the cotangent of out) f32 (dq,
// dx <= 64), mask_t [Nd, Ns] int8 (0/1: rows row0 .. row0 + Nd of the
// attention mask's contiguous transpose, dot_flash.cuh), m, z, delta [Ns]
// f32, split (any column offset of the whole) -> dk [Nd, dq], dx [Nd, dx]
// f32 (the block's columns):
//   dS = P * (g x^T - delta),  dk[j] = sum_i dS[i, j] q2[p(j)][i],
//                              dx[j] = sum_i P[i, j] g[i],
// with P per edge from the stats (dot_flash.cuh's rule).  Every column is
// written: a column with no edge gets exact zeros.
//
// Bound on an H100 (SXM, 700 W): bytes.  At KGAT's hetrec shapes the three
// row types' transposed masks (117 MB, about 0.035 ms a pass at 3.35 TB/s)
// are 0.46-1.49% dense, and each edge needs 4*dq + 4*dx + 5 float32
// operations (its score, exponential, g . x product and the dk and dx
// multiply-adds: about 0.006 ms a pass at 67 TFLOP/s) and a gathered q row
// and g row from the L2 (at most 5.2 and 2.6 MB).  Each edge's products are
// against its own q and g rows: there is no shared tile for the tensor
// cores, so the kernel is CUDA-core float32 and its effort goes into keeping
// the mask stream and the gathers in flight.
//
// Design (mask_rows.cuh), as dot_flash_bwd_row.cu with rows and columns
// exchanged: a row-streamed edge sweep over mask_t.  Row j of the block is
// column J = row0 + j of the attention, so its q plane p(J) = (J >= split)
// is fixed for the whole row, a block may lie either side of the split or
// across it, and the split needs no alignment.  wpr warps own a column j
// (warps_per_row: one warp per 2 KB of row, so 1, 8 and 2 at the three row
// types), and its k row and x row are staged once in shared memory.  A warp works 8
// edges (j, i) at a time, 4 lanes an edge: lane l gathers the columns
// col_of(l, t) of q2[p(j)][i] and g[i] (as float4 where dq and dx are
// multiples of 4 and q2 and g lie on 16-byte boundaries, VEC) and row i's
// m, z and delta, forms its parts of s = q . k[j] and dp = g[i] . x[j],
// shuffles sum both, and adds dS times the q values and P times the g
// values it loaded (kept in registers, not read again) to its 16 + 16
// accumulators.  At the column's end three shuffles a value sum the warp's 8
// lane groups, the column's warps meet once in shared memory, and each dk
// and dx row is written once, without atomics.  A row off the column's
// edges is never read, so a non-finite q2 or g there does not reach the
// column (the plain version multiplies P = 0 by it).

#include "dot_flash.cuh"

namespace dot_flash {

template <bool VEC>
__global__ void __launch_bounds__(mask_rows::NT, 2)
bwd_col_kernel(const float* __restrict__ q2, const float* __restrict__ k,
               const int8_t* __restrict__ mask_t, const float* __restrict__ ms,
               const float* __restrict__ zs, const float* __restrict__ x,
               const float* __restrict__ g, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dxo, int Ns, int Nd,
               int dq, int dx, int split, int row0, int wpr) {
  using mask_rows::FULL;
  using mask_rows::G;
  using mask_rows::WARPS;
  __shared__ mask_rows::Warp ws[WARPS];
  __shared__ __align__(16) float rs[WARPS * 2 * QS2];  // k row, x row
  __shared__ float part[WARPS][2 * MAXD];              // dk, dx
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / wpr, p = warp % wpr;
  const int j = blockIdx.x * (WARPS / wpr) + slot;
  const size_t J = (size_t)row0 + j;  // the attention's column
  const int l = lane % G;
  float* kr = rs + slot * 2 * QS2;
  float* xr = kr + QS2;
  if (j < Nd)  // the column's warps stage its k row and its x row
    for (int e = p * 32 + lane; e < dq + dx; e += wpr * 32) {
      if (e < dq)
        kr[e] = k[J * dq + e];
      else
        xr[e - dq] = x[J * dx + e - dq];
    }
  __syncthreads();

  float acck[CL], accx[CL];
#pragma unroll
  for (int t = 0; t < CL; ++t) {
    acck[t] = 0.f;
    accx[t] = 0.f;
  }
  if (j < Nd) {  // uniform over the column's warps
    const float* qp = q2 + (J >= (size_t)split ? (size_t)Ns * dq : 0);
    auto work = [&](int i, float v, bool valid) {
      const bool on = valid && v > 0.f;
      const float* qrow = qp + (size_t)i * dq;
      const float* grow = g + (size_t)i * dx;
      float mc, iz;
      row_consts(mc, iz, ms, zs, i, Ns);  // i = 0 off the edges: in range
      const float dl = delta[i];
      float s = 0.f, dp = 0.f, qv[CL], gv[CL];
#pragma unroll
      for (int t = 0; t < CL; t += 4) {
        const int c = col_of<VEC>(l, t);
        if (VEC) {
          const bool qin = on && c < dq, gin = on && c < dx;
          const float4 a = qin ? __ldg((const float4*)(qrow + c))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          qv[t] = a.x;
          qv[t + 1] = a.y;
          qv[t + 2] = a.z;
          qv[t + 3] = a.w;
          if (qin) {
            const float4 b = *(const float4*)(kr + c);
            s = fmaf(a.x, b.x, s);
            s = fmaf(a.y, b.y, s);
            s = fmaf(a.z, b.z, s);
            s = fmaf(a.w, b.w, s);
          }
          const float4 gq = gin ? __ldg((const float4*)(grow + c))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          gv[t] = gq.x;
          gv[t + 1] = gq.y;
          gv[t + 2] = gq.z;
          gv[t + 3] = gq.w;
          if (gin) {
            const float4 xq = *(const float4*)(xr + c);
            dp = fmaf(gq.x, xq.x, dp);
            dp = fmaf(gq.y, xq.y, dp);
            dp = fmaf(gq.z, xq.z, dp);
            dp = fmaf(gq.w, xq.w, dp);
          }
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int cu = col_of<VEC>(l, t + u);
            qv[t + u] = on && cu < dq ? __ldg(qrow + cu) : 0.f;
            gv[t + u] = on && cu < dx ? __ldg(grow + cu) : 0.f;
            if (on && cu < dq) s = fmaf(qv[t + u], kr[cu], s);
            if (on && cu < dx) dp = fmaf(gv[t + u], xr[cu], dp);
          }
        }
      }
      s += __shfl_xor_sync(FULL, s, 1);
      s += __shfl_xor_sync(FULL, s, 2);
      dp += __shfl_xor_sync(FULL, dp, 1);
      dp += __shfl_xor_sync(FULL, dp, 2);
      // 0 off the edges, where qv and gv are 0 too
      const float pv = on ? expf(s - mc) * v * iz : 0.f;
      const float ds = pv * (dp - dl);
#pragma unroll
      for (int t = 0; t < CL; ++t) {
        acck[t] = fmaf(ds, qv[t], acck[t]);
        accx[t] = fmaf(pv, gv[t], accx[t]);
      }
    };
    mask_rows::sweep_row<true>(mask_t + (size_t)j * Ns, Ns, p, wpr, ws[warp],
                               work);
  }
  // the warp's 8 lane groups, then the column's warps
#pragma unroll
  for (int t = 0; t < CL; ++t) {
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
      acck[t] += __shfl_xor_sync(FULL, acck[t], off);
      accx[t] += __shfl_xor_sync(FULL, accx[t], off);
    }
    if (lane < G) {
      part[warp][col_of<VEC>(l, t)] = acck[t];
      part[warp][MAXD + col_of<VEC>(l, t)] = accx[t];
    }
  }
  __syncthreads();
  if (j < Nd && p == 0)
    for (int o = lane; o < dq + dx; o += 32) {
      const bool isk = o < dq;
      const int c = isk ? o : o - dq;
      float sum = 0.f;
      for (int w = 0; w < wpr; ++w) sum += part[warp + w][(isk ? 0 : MAXD) + c];
      if (isk)
        dk[(size_t)j * dq + c] = sum;
      else
        dxo[(size_t)j * dx + c] = sum;
    }
}

}  // namespace dot_flash

// Launches one column-backward sweep on `stream`; returns cudaGetLastError().
extern "C" int dot_flash_bwd_col_f32(const float* q2, const float* k,
                                     const int8_t* mask_t, const float* m,
                                     const float* z, const float* x,
                                     const float* g, const float* delta,
                                     float* dk, float* dx_out, int Ns, int Nd,
                                     int dq, int dx, int split, int row0,
                                     void* stream) {
  using namespace dot_flash;
  if (dq < 1 || dq > MAXD || dx < 0 || dx > MAXD || Ns < 0 ||
      Ns >= mask_rows::MAX_COLS || row0 < 0)
    return (int)cudaErrorInvalidValue;
  if (Nd <= 0) return 0;
  const int wpr = mask_rows::warps_per_row(Ns);
  const int blocks = mask_rows::blocks_for(Nd, wpr);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = dq % 4 == 0 && dx % 4 == 0 && (uintptr_t)q2 % 16 == 0 &&
                   (uintptr_t)g % 16 == 0;
  if (vec)
    bwd_col_kernel<true><<<blocks, mask_rows::NT, 0, st>>>(
        q2, k, mask_t, m, z, x, g, delta, dk, dx_out, Ns, Nd, dq, dx, split,
        row0, wpr);
  else
    bwd_col_kernel<false><<<blocks, mask_rows::NT, 0, st>>>(
        q2, k, mask_t, m, z, x, g, delta, dk, dx_out, Ns, Nd, dq, dx, split,
        row0, wpr);
  return (int)cudaGetLastError();
}
