// dot_flash_bwd_row: dq2 of dot_flash_apply's backward, row by row.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_attention.py::
// _dot_bwd_row_kernel (launched by _dot_bwd_row).  q2 [2, Ns, dq],
// k [Nd, dq], x [Nd, dx], g [Ns, dx] (the cotangent of out) f32, mask
// [Ns, Nd] int8 (0/1), m, z, delta [Ns] f32 (delta = rowsum(g * out)),
// split (a column offset, a multiple of 64) -> dq2 [2, Ns, dq] f32:
//   dS = P * (g x^T - delta),  dq2[0] = dS[:, :split] @ k[:split],
//                              dq2[1] = dS[:, split:] @ k[split:].
//
// Bound on an H100 (SXM, 700 W): the function needs each edge's score,
// exponential, g . x product and dq multiply-adds, (2*dq + 2*dx + 2*dq + 5)
// operations an edge, and one read of the mask; at KGAT's hetrec shapes it
// is bytes-bound.  The kernel computes every pair of every tile, so it is
// bound by the dense sweep's float32 arithmetic.  Design: one block per 64
// rows holds its g rows in shared memory and walks the column tiles of plane
// 0, then of plane 1 (the split is a prefix), so one register accumulator of
// 4 rows x 4 q columns a thread serves both planes and each plane is written
// once.  See dot_flash.cuh.

#include "dot_flash.cuh"

namespace dot_flash {

__global__ void __launch_bounds__(NT)
bwd_row_kernel(const float* __restrict__ q2, const float* __restrict__ k,
               const int8_t* __restrict__ mask, const float* __restrict__ ms,
               const float* __restrict__ zs, const float* __restrict__ x,
               const float* __restrict__ g, const float* __restrict__ delta,
               float* __restrict__ dq2, int Ns, int Nd, int dq, int dx,
               int split) {
  extern __shared__ float smem[];
  float* qT = smem;
  float* kT = qT + TILE;
  float* xT = kT + TILE;
  float* gT = xT + TILE;
  float* ds = gT + TILE;  // [BI][SS]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = blockIdx.x * BI;
  const int nb = (dq + 15) / 16;  // output column slots in use

  float mc[R], iz[R], dl[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = i0 + ty + 16 * a;
    row_consts(mc[a], iz[a], ms, zs, i, Ns);
    dl[a] = i < Ns ? delta[i] : 0.f;
  }
  load_t(gT, g, i0, Ns, dx);  // read after the first barrier below

  for (int p = 0; p < 2; ++p) {
    float acc[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) acc[a][b] = 0.f;
    const int lo = range_lo(p, split), hi = range_hi(p, split, Nd);
    if (lo < hi) {  // block-uniform
      __syncthreads();
      load_t(qT, q2 + (size_t)p * Ns * dq, i0, Ns, dq);
      for (int j0 = lo; j0 < hi; j0 += BJ) {
        __syncthreads();  // the previous tile's reads of kT, xT and ds are done
        load_t(kT, k, j0, Nd, dq);
        load_t(xT, x, j0, Nd, dx);
        __syncthreads();
        float s[R][R], dp[R][R], mk[R][R];
        tile_dot(s, qT, kT, dq, ty, tx);
        tile_dot(dp, gT, xT, dx, ty, tx);
        mask_tile(mk, mask, i0, j0, Ns, Nd, ty, tx);
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int b = 0; b < R; ++b)
            ds[(ty + 16 * a) * SS + tx + 16 * b] =
                p_of(s[a][b], mk[a][b], mc[a], iz[a]) * (dp[a][b] - dl[a]);
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < BJ; ++j) {
          float dv[R], kv[R];
#pragma unroll
          for (int a = 0; a < R; ++a) dv[a] = ds[(ty + 16 * a) * SS + j];
#pragma unroll
          for (int b = 0; b < R; ++b) kv[b] = kT[(tx + 16 * b) * SS + j];
#pragma unroll
          for (int a = 0; a < R; ++a)
#pragma unroll
            for (int b = 0; b < R; ++b)
              if (b < nb) acc[a][b] = fmaf(dv[a], kv[b], acc[a][b]);
        }
      }
    }
    float* dst = dq2 + (size_t)p * Ns * dq;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const int i = i0 + ty + 16 * a, c = tx + 16 * b;
        if (i < Ns && c < dq) dst[(size_t)i * dq + c] = acc[a][b];
      }
  }
}

}  // namespace dot_flash

// Launches one row-backward sweep on `stream`; returns cudaGetLastError().
extern "C" int dot_flash_bwd_row_f32(const float* q2, const float* k,
                                     const int8_t* mask, const float* m,
                                     const float* z, const float* x,
                                     const float* g, const float* delta,
                                     float* dq2, int Ns, int Nd, int dq,
                                     int dx, int split, void* stream) {
  using namespace dot_flash;
  const size_t smem = smem_bwd_row();
  const int err = prepare(bwd_row_kernel, smem);
  if (err) return err;
  bwd_row_kernel<<<(Ns + BI - 1) / BI, NT, smem, (cudaStream_t)stream>>>(
      q2, k, mask, m, z, x, g, delta, dq2, Ns, Nd, dq, dx, split);
  return (int)cudaGetLastError();
}
