// Two-segment dot-score flash attention, shared by its four kernels, all
// edge sweeps over the rows of a mask (mask_rows.cuh): dot_flash_stats.cu,
// dot_flash_apply.cu and dot_flash_bwd_row.cu over the mask's rows,
// dot_flash_bwd_col.cu over the rows of its transpose.  This header holds
// the softmax rule (NEG, row_consts), the widths (MAXD) and the edge lanes'
// columns (CL, QS2, col_of).
//
// For one row type of KGAT's attention, rows i < Ns score columns j < Nd as
//   S[i, j] = q2[p(j)][i] . k[j],   p(j) = (j >= split) ? 1 : 0
// where the two q planes hold the row type's head projections under the two
// relations of its column segments.  The row softmax spans both segments and
// is masked by the 0/1 int8 edge mask:
//   masked score  = mask > 0 ? S : NEG                   (NEG = -1e30)
//   m[i], z[i]    = max and sum of exp(S - m) * mask over the row (stats)
//   P[i, j]       = exp(S - max(m, NEG)) * mask / (z == 0 ? 1 : z)
// so a row with no edge (padding rows included) gives P = 0 everywhere.
// Each kernel works an edge on G = 4 lanes, chooses the plane per edge (or
// per column, bwd_col), so the split needs no alignment, and never reads a
// column off the edges.  Widths dq and dx are at most MAXD = 64.  Plain
// float32 FMAs on the CUDA cores; no tensor cores.
//
// A launch sweeps rows row0 .. row0 + R of its mask (a rank's rows under a
// mesh; row0 = 0 and every row otherwise): row i of the block is row
// row0 + i of the attention (bwd_col: column row0 + i), whose q, g, m, z
// and delta (bwd_col: k, x and the plane row0 + i >= split) the kernel
// reads at that global row, and whose results it writes at row i of its
// [R, ...] outputs, so a rank's rows land in its part of a send buffer
// without a copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mask_rows.cuh"

namespace dot_flash {

constexpr int MAXD = 64;  // widest q/k/x/g row
constexpr float NEG = -1e30f;

// The 4 lanes of an edge take CL columns each of q, k, x and g, and a row's
// staged rows (q planes, g) lie QS2 floats apart, so that the two planes
// start in other banks.
constexpr int CL = MAXD / mask_rows::G;
constexpr int QS2 = MAXD + 16;

// Column of slot t of lane l: 4l + 16(t / 4) + t % 4 (VEC: float4 reads) or
// l + 4t.
template <bool VEC>
__device__ __forceinline__ int col_of(int l, int t) {
  return VEC ? 4 * l + 16 * (t / 4) + t % 4 : l + 4 * t;
}

// Per-row softmax constants from the stats: max(m, NEG) and 1 / z (z == 0
// -> 1) of the global row i; rows past Ns get (NEG, 0), which makes their P
// zero.
__device__ __forceinline__ void row_consts(float& mc, float& iz,
                                           const float* __restrict__ ms,
                                           const float* __restrict__ zs, int i,
                                           int Ns) {
  if (i < Ns) {
    mc = fmaxf(ms[i], NEG);
    const float z = zs[i];
    iz = 1.f / (z == 0.f ? 1.f : z);
  } else {
    mc = NEG;
    iz = 0.f;
  }
}

}  // namespace dot_flash

extern "C" const char* dot_flash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
