// Two-segment dot-score flash attention, shared by dot_flash_stats.cu (the
// 64 x 64 tile sweep that remains), and by dot_flash_apply.cu,
// dot_flash_bwd_row.cu (edge sweeps over the mask rows, mask_rows.cuh) and
// dot_flash_bwd_col.cu (an edge sweep over the rows of the mask's
// transpose) for the softmax rule (row_consts, NEG) and the edge lanes'
// columns (col_of).
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
//
// Tiling of the tile sweep: BI x BJ = 64 x 64 score tiles, 256 threads as
// a 16 x 16 grid; a thread holds R x R = 4 x 4 (row, column) pairs, rows
// ty + 16a and columns tx + 16b, so the products read shared memory without
// bank conflicts (stride SS = 65 on every transposed tile).  stats runs one
// block per row tile and walks every column tile, and writes every output
// once, without atomics.  A column tile never straddles the split: the
// wrapper requires split % BJ == 0 for it.  The ragged edges (Ns, Nd not
// multiples of 64) are masked here.  Widths dq and dx are at most MAXD = 64.
// Plain float32 FMAs on the CUDA cores; no tensor cores, no async copies.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mask_rows.cuh"

namespace dot_flash {

constexpr int BI = 64;      // rows per tile
constexpr int BJ = 64;      // columns per tile
constexpr int NT = 256;     // threads per block
constexpr int R = 4;        // rows (and columns) per thread: BI / 16
constexpr int SS = 65;      // padded stride of a transposed tile
constexpr int MAXD = 64;    // widest q/k/x/g row
constexpr int TILE = MAXD * SS;  // floats in one transposed [MAXD][SS] tile
constexpr float NEG = -1e30f;

static_assert(BI == 16 * R && BJ == 16 * R, "a 16 x 16 thread grid of R x R");

// The edge sweeps: the 4 lanes of an edge take CL columns each of q, k, x
// and g, and a row's staged rows (q planes, g) lie QS2 floats apart, so
// that the two planes start in other banks.
constexpr int CL = MAXD / mask_rows::G;
constexpr int QS2 = MAXD + 16;

// Column of slot t of lane l: 4l + 16(t / 4) + t % 4 (VEC: float4 reads) or
// l + 4t.
template <bool VEC>
__device__ __forceinline__ int col_of(int l, int t) {
  return VEC ? 4 * l + 16 * (t / 4) + t % 4 : l + 4 * t;
}

// dst[c * SS + t] = src[(r0 + t) * w + c] for t < 64, c < MAXD; zero beyond
// the n rows of src and beyond its width w (so a 16-wide output slot that
// runs past w reads zeros).
__device__ __forceinline__ void load_t(float* dst, const float* __restrict__ src,
                                       int r0, int n, int w) {
  for (int e = threadIdx.x; e < BI * MAXD; e += NT) {
    const int t = e / MAXD, c = e - t * MAXD;
    const int r = r0 + t;
    dst[c * SS + t] = (r < n && c < w) ? src[(size_t)r * w + c] : 0.f;
  }
}

// s[a][b] = sum_c aT[c][ty + 16a] * bT[c][tx + 16b] over c < d.
__device__ __forceinline__ void tile_dot(float s[R][R], const float* aT,
                                         const float* bT, int d, int ty,
                                         int tx) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    float av[R], bv[R];
#pragma unroll
    for (int a = 0; a < R; ++a) av[a] = aT[c * SS + ty + 16 * a];
#pragma unroll
    for (int b = 0; b < R; ++b) bv[b] = bT[c * SS + tx + 16 * b];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) s[a][b] = fmaf(av[a], bv[b], s[a][b]);
  }
}

// The thread's mask values for the tile at (i0, j0); 0 outside [Ns, Nd).
__device__ __forceinline__ void mask_tile(float mk[R][R],
                                          const int8_t* __restrict__ mask,
                                          int i0, int j0, int Ns, int Nd,
                                          int ty, int tx) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int i = i0 + ty + 16 * a, j = j0 + tx + 16 * b;
      mk[a][b] = (i < Ns && j < Nd) ? (float)mask[(size_t)i * Nd + j] : 0.f;
    }
}

// Per-row softmax constants from the stats: max(m, NEG) and 1 / z (z == 0
// -> 1); rows past Ns get (NEG, 0), which makes their P zero.
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

// The two column ranges of a row sweep: plane 0 over [0, min(split, Nd)),
// plane 1 over [split, Nd).
__device__ __forceinline__ int range_lo(int p, int split) {
  return p == 0 ? 0 : split;
}
__device__ __forceinline__ int range_hi(int p, int split, int Nd) {
  return p == 0 ? min(split, Nd) : Nd;
}

// Dynamic shared memory of the tile sweep, in bytes (ops/flash_attention.py
// mirrors it to check the limit before a launch).
inline size_t smem_stats() { return sizeof(float) * 2 * TILE; }

template <typename Kernel>
inline int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace dot_flash

extern "C" const char* dot_flash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
