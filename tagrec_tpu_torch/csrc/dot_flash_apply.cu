// dot_flash_apply: out = P @ x for the masked two-segment row softmax P.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_attention.py::
// _dot_apply_kernel (launched by dot_flash_apply through _dot_apply).
// q2 [2, Ns, dq], k [Nd, dq], x [Nd, dx] f32, mask [Ns, Nd] int8 (0/1),
// m, z [Ns] f32 from dot_flash_stats, split (a column offset, a multiple of
// 64) -> out [Ns, dx] f32.  P is rebuilt tile by tile from q2, k and the
// stats; the [Ns, Nd] plane never reaches device memory.
//
// Bound on an H100 (SXM, 700 W): the function reads the mask once and needs
// each edge's score, exponential and dx multiply-adds, (2*dq + 4 + 2*dx)
// operations an edge; at KGAT's hetrec shapes that is bytes-bound (the mask
// read).  The kernel does that work for every pair of every tile, so it is
// bound by the dense sweep's float32 arithmetic.  Design: one block per 64
// rows walks every column tile (plane 0 left of the split, plane 1 right of
// it), stages the 64 x 64 P tile in shared memory and accumulates P @ x in
// registers (4 rows x 4 output columns a thread); out is written once.  See
// dot_flash.cuh.

#include "dot_flash.cuh"

namespace dot_flash {

__global__ void __launch_bounds__(NT)
apply_kernel(const float* __restrict__ q2, const float* __restrict__ k,
             const int8_t* __restrict__ mask, const float* __restrict__ ms,
             const float* __restrict__ zs, const float* __restrict__ x,
             float* __restrict__ out, int Ns, int Nd, int dq, int dx,
             int split) {
  extern __shared__ float smem[];
  float* qT = smem;
  float* kT = qT + TILE;
  float* xT = kT + TILE;
  float* ps = xT + TILE;  // [BI][SS]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = blockIdx.x * BI;
  const int nb = (dx + 15) / 16;  // output column slots in use

  float mc[R], iz[R];
#pragma unroll
  for (int a = 0; a < R; ++a) row_consts(mc[a], iz[a], ms, zs, i0 + ty + 16 * a, Ns);
  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = 0.f;

  for (int p = 0; p < 2; ++p) {
    const int lo = range_lo(p, split), hi = range_hi(p, split, Nd);
    if (lo >= hi) continue;  // block-uniform
    __syncthreads();
    load_t(qT, q2 + (size_t)p * Ns * dq, i0, Ns, dq);
    for (int j0 = lo; j0 < hi; j0 += BJ) {
      __syncthreads();  // the previous tile's reads of kT, xT and ps are done
      load_t(kT, k, j0, Nd, dq);
      load_t(xT, x, j0, Nd, dx);
      __syncthreads();
      float s[R][R], mk[R][R];
      tile_dot(s, qT, kT, dq, ty, tx);
      mask_tile(mk, mask, i0, j0, Ns, Nd, ty, tx);
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b)
          ps[(ty + 16 * a) * SS + tx + 16 * b] =
              p_of(s[a][b], mk[a][b], mc[a], iz[a]);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < BJ; ++j) {
        float pv[R], xv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) pv[a] = ps[(ty + 16 * a) * SS + j];
#pragma unroll
        for (int b = 0; b < R; ++b) xv[b] = xT[(tx + 16 * b) * SS + j];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int b = 0; b < R; ++b)
            if (b < nb) acc[a][b] = fmaf(pv[a], xv[b], acc[a][b]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int i = i0 + ty + 16 * a, d = tx + 16 * b;
      if (i < Ns && d < dx) out[(size_t)i * dx + d] = acc[a][b];
    }
}

}  // namespace dot_flash

// Launches one apply sweep on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int dot_flash_apply_f32(const float* q2, const float* k,
                                   const int8_t* mask, const float* m,
                                   const float* z, const float* x, float* out,
                                   int Ns, int Nd, int dq, int dx, int split,
                                   void* stream) {
  using namespace dot_flash;
  const size_t smem = smem_apply();
  const int err = prepare(apply_kernel, smem);
  if (err) return err;
  apply_kernel<<<(Ns + BI - 1) / BI, NT, smem, (cudaStream_t)stream>>>(
      q2, k, mask, m, z, x, out, Ns, Nd, dq, dx, split);
  return (int)cudaGetLastError();
}
