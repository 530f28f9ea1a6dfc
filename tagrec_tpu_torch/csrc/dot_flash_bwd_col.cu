// dot_flash_bwd_col: dk and dx of dot_flash_apply's backward, column by
// column.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_attention.py::
// _dot_bwd_col_kernel (launched by _dot_bwd_col).  Same inputs as
// dot_flash_bwd_row -> dk [Nd, dq], dx [Nd, dx] f32:
//   dS = P * (g x^T - delta),  dk[j] = sum_i dS[i, j] q2[p(j)][i],
//                              dx[j] = sum_i P[i, j] g[i].
//
// Bound on an H100 (SXM, 700 W): (2*dq + 2*dx + 2*dq + 2*dx + 5) operations
// an edge and one read of the mask; at KGAT's hetrec shapes it is
// bytes-bound.  The kernel computes every pair of every tile, so it is bound
// by the dense sweep's float32 arithmetic.  Design: one block per 64 columns
// (the column tile fixes the q plane for the whole block) holds its k and x
// columns in shared memory and walks every row tile, staging P and dS
// tiles in shared memory; dk and dx accumulate in registers (4 columns x 4
// widths a thread each) and are written once, with no atomics.  See
// dot_flash.cuh.

#include "dot_flash.cuh"

namespace dot_flash {

__global__ void __launch_bounds__(NT)
bwd_col_kernel(const float* __restrict__ q2, const float* __restrict__ k,
               const int8_t* __restrict__ mask, const float* __restrict__ ms,
               const float* __restrict__ zs, const float* __restrict__ x,
               const float* __restrict__ g, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dxo, int Ns, int Nd,
               int dq, int dx, int split) {
  extern __shared__ float smem[];
  float* kT = smem;
  float* xT = kT + TILE;
  float* qT = xT + TILE;
  float* gT = qT + TILE;
  float* ps = gT + TILE;    // [BI][SS]
  float* ds = ps + BI * SS; // [BI][SS]
  float* mcs = ds + BI * SS;
  float* izs = mcs + BI;
  float* dls = izs + BI;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int j0 = blockIdx.x * BJ;
  const float* qp = q2 + (size_t)(j0 >= split ? 1 : 0) * Ns * dq;
  const int nbq = (dq + 15) / 16, nbx = (dx + 15) / 16;

  load_t(kT, k, j0, Nd, dq);  // read after the first barrier below
  load_t(xT, x, j0, Nd, dx);
  float acck[R][R], accx[R][R];  // columns ty + 16a, widths tx + 16b
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) {
      acck[a][b] = 0.f;
      accx[a][b] = 0.f;
    }

  for (int i0 = 0; i0 < Ns; i0 += BI) {
    __syncthreads();  // the previous tile's reads of qT, gT, ps and ds are done
    load_t(qT, qp, i0, Ns, dq);
    load_t(gT, g, i0, Ns, dx);
    for (int t = threadIdx.x; t < BI; t += NT) {
      row_consts(mcs[t], izs[t], ms, zs, i0 + t, Ns);
      dls[t] = i0 + t < Ns ? delta[i0 + t] : 0.f;
    }
    __syncthreads();
    float s[R][R], dp[R][R], mk[R][R];
    tile_dot(s, qT, kT, dq, ty, tx);   // rows ty + 16a, columns tx + 16b
    tile_dot(dp, gT, xT, dx, ty, tx);
    mask_tile(mk, mask, i0, j0, Ns, Nd, ty, tx);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int il = ty + 16 * a;
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float pv = p_of(s[a][b], mk[a][b], mcs[il], izs[il]);
        ps[il * SS + tx + 16 * b] = pv;
        ds[il * SS + tx + 16 * b] = pv * (dp[a][b] - dls[il]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BI; ++i) {
      float pj[R], dj[R], qv[R], gv[R];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        pj[a] = ps[i * SS + ty + 16 * a];
        dj[a] = ds[i * SS + ty + 16 * a];
      }
#pragma unroll
      for (int b = 0; b < R; ++b) {
        qv[b] = qT[(tx + 16 * b) * SS + i];
        gv[b] = gT[(tx + 16 * b) * SS + i];
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) {
          if (b < nbq) acck[a][b] = fmaf(dj[a], qv[b], acck[a][b]);
          if (b < nbx) accx[a][b] = fmaf(pj[a], gv[b], accx[a][b]);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int j = j0 + ty + 16 * a, c = tx + 16 * b;
      if (j >= Nd) continue;
      if (c < dq) dk[(size_t)j * dq + c] = acck[a][b];
      if (c < dx) dxo[(size_t)j * dx + c] = accx[a][b];
    }
}

}  // namespace dot_flash

// Launches one column-backward sweep on `stream`; returns cudaGetLastError().
extern "C" int dot_flash_bwd_col_f32(const float* q2, const float* k,
                                     const int8_t* mask, const float* m,
                                     const float* z, const float* x,
                                     const float* g, const float* delta,
                                     float* dk, float* dx_out, int Ns, int Nd,
                                     int dq, int dx, int split, void* stream) {
  using namespace dot_flash;
  const size_t smem = smem_bwd_col();
  const int err = prepare(bwd_col_kernel, smem);
  if (err) return err;
  bwd_col_kernel<<<(Nd + BJ - 1) / BJ, NT, smem, (cudaStream_t)stream>>>(
      q2, k, mask, m, z, x, g, delta, dk, dx_out, Ns, Nd, dq, dx, split);
  return (int)cudaGetLastError();
}
