// dot_flash_stats: per-row max m and sum z of the masked two-segment scores.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_attention.py::
// _dot_stats_kernel (launched by dot_flash_stats through _dot_stats).
// q2 [2, Ns, dq], k [Nd, dq] f32, mask [Ns, Nd] int8 (0/1), split (a column
// offset, a multiple of 64) -> m [Ns], z [Ns] f32: m = max over the row's
// edges of S (NEG for a row with none), z = sum over them of exp(S - m).
//
// Bound on an H100 (SXM, 700 W): the function reads the mask once (1 byte a
// pair) and needs the scores of the mask's edges only, 2*dq + 3 operations
// each; at KGAT's hetrec shapes that is bytes-bound (27 MB of mask for the
// user rows, about 8 us at 3.35 TB/s).  The kernel computes every pair of
// the tile (the edges are spread over nearly every 64 x 64 tile, so no tile
// can be skipped), 2*dq FMAs-worth of operations a pair on the CUDA cores,
// so it is bound by the dense sweep's arithmetic.  Design: one block per 64
// rows walks every column tile; each thread keeps its own online (m, z) for
// its 4 rows over its 4 columns of each tile, and the 16 column lanes of a
// row are merged once at the end with warp shuffles, so a tile needs no
// reduction and no barrier beyond the k tile's load.  See dot_flash.cuh.

#include "dot_flash.cuh"

namespace dot_flash {

__global__ void __launch_bounds__(NT)
stats_kernel(const float* __restrict__ q2, const float* __restrict__ k,
             const int8_t* __restrict__ mask, float* __restrict__ mout,
             float* __restrict__ zout, int Ns, int Nd, int dq, int split) {
  extern __shared__ float smem[];
  float* qT = smem;
  float* kT = qT + TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = blockIdx.x * BI;

  float m[R], z[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    m[a] = NEG;
    z[a] = 0.f;
  }
  for (int p = 0; p < 2; ++p) {
    const int lo = range_lo(p, split), hi = range_hi(p, split, Nd);
    if (lo >= hi) continue;  // block-uniform
    __syncthreads();         // the previous range's reads of qT are done
    load_t(qT, q2 + (size_t)p * Ns * dq, i0, Ns, dq);
    for (int j0 = lo; j0 < hi; j0 += BJ) {
      __syncthreads();  // the previous tile's reads of kT are done
      load_t(kT, k, j0, Nd, dq);
      __syncthreads();
      float s[R][R], mk[R][R];
      tile_dot(s, qT, kT, dq, ty, tx);
      mask_tile(mk, mask, i0, j0, Ns, Nd, ty, tx);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        float mt = NEG;
#pragma unroll
        for (int b = 0; b < R; ++b)
          if (mk[a][b] > 0.f) mt = fmaxf(mt, s[a][b]);
        const float mn = fmaxf(m[a], mt);
        float acc = z[a] * expf(m[a] - mn);
#pragma unroll
        for (int b = 0; b < R; ++b)
          if (mk[a][b] > 0.f) acc += expf(s[a][b] - mn) * mk[a][b];
        z[a] = acc;
        m[a] = mn;
      }
    }
  }
  // merge the 16 column lanes of each row (lanes differ in tx only)
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[a], off);
      const float zo = __shfl_xor_sync(0xffffffffu, z[a], off);
      const float mn = fmaxf(m[a], mo);
      z[a] = z[a] * expf(m[a] - mn) + zo * expf(mo - mn);
      m[a] = mn;
    }
    const int i = i0 + ty + 16 * a;
    if (tx == 0 && i < Ns) {
      mout[i] = m[a];
      zout[i] = z[a];
    }
  }
}

}  // namespace dot_flash

// Launches one stats sweep on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int dot_flash_stats_f32(const float* q2, const float* k,
                                   const int8_t* mask, float* m, float* z,
                                   int Ns, int Nd, int dq, int split,
                                   void* stream) {
  using namespace dot_flash;
  const size_t smem = smem_stats();
  const int err = prepare(stats_kernel, smem);
  if (err) return err;
  stats_kernel<<<(Ns + BI - 1) / BI, NT, smem, (cudaStream_t)stream>>>(
      q2, k, mask, m, z, Ns, Nd, dq, split);
  return (int)cudaGetLastError();
}
