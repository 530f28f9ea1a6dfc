// Factor-softmax routing tile sweep of routed_rowsum.cu.
//
// Computes, for every factor f, row n and column m of the routed adjacency
//   P_f[n, m] = exp(base + q_f[n] . k_f[m]) / sum_g exp(base + q_g[n] . k_g[m])
//               * mask[n, m]
// and keeps its row sums sum_m P_f[n, m].  The [F, N, M] plane never
// reaches device memory.  The softmax runs over the F factors (not over
// columns) and has no max subtraction: the callers' scores are bounded
// (DGCF: |S| <= 1 + number of routing iterations, unit-normalized update
// dots), so exp cannot overflow.  The mask multiplies after normalization.
//
// Layout: one block of 256 threads per tile of TI = 32 rows, covering all F
// factors (the softmax needs them together).  The block loops over column
// tiles of TJ = 32 inside itself: blocks share nothing and run in any order.
// Per column tile:
//   1. the k tile goes to shared memory, transposed so that the score loop
//      reads consecutive columns from consecutive banks;
//   2. each thread computes a 2 x 2 block of (row, column) pairs for every
//      factor in registers, exponentiates, normalizes over F, applies the
//      mask and stages P in shared memory;
//   3. one owner thread per (factor, row) adds the tile's P row into a
//      register.
// A column tile whose mask bytes are all zero contributes exactly zero for
// finite scores, and the block skips it (__syncthreads_or is block-uniform).
// Plain float32 on the CUDA cores; the ragged edges (N, M not multiples of
// the tiles) are masked here, so the wrapper pads nothing.  (routed_mm is
// an edge sweep over the mask rows instead: mask_rows.cuh.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace routing {

constexpr int TI = 32;       // rows per block
constexpr int TJ = 32;       // columns per tile
constexpr int NT = 256;      // threads per block, a 16 x 16 grid of 2 x 2 pairs
constexpr int QS = TI + 1;   // padded shared-memory strides: conflict-free
constexpr int KS = TJ + 1;   //   transposed stores and row-wise P reads
constexpr int PS = TJ + 1;

// Dynamic shared memory in floats: qT [F][r][QS], kT [F][r][KS],
// p [F][TI][PS].
inline size_t smem_bytes(int F, int r) {
  return sizeof(float) * ((size_t)F * r * QS + (size_t)F * r * KS +
                          (size_t)F * TI * PS);
}

__global__ void __launch_bounds__(NT)
rowsum_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const int8_t* __restrict__ mask, float* __restrict__ out, int F,
              int N, int M, int r, float base) {
  extern __shared__ float smem[];
  float* qT = smem;
  float* kT = qT + (size_t)F * r * QS;
  float* ps = kT + (size_t)F * r * KS;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TI;

  // this block's q rows, once: qT[f][c][i] = q[f][n0 + i][c]
  for (int e = tid; e < F * TI * r; e += NT) {
    const int f = e / (TI * r), rem = e - f * TI * r;
    const int i = rem / r, c = rem - i * r;
    const int n = n0 + i;
    qT[(f * r + c) * QS + i] = n < N ? q[((size_t)f * N + n) * r + c] : 0.f;
  }

  // Output ownership: thread tid owns row slot (f, i) = (tid / TI, tid % TI)
  const bool owner = tid < F * TI;
  const int of = owner ? tid / TI : 0, oi = owner ? tid % TI : 0;
  float acc = 0.f;

  for (int m0 = 0; m0 < M; m0 += TJ) {
    float mk[2][2];
    int any = 0;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int n = n0 + ty + 16 * a, m = m0 + tx + 16 * b;
        mk[a][b] = (n < N && m < M) ? (float)mask[(size_t)n * M + m] : 0.f;
        any |= mk[a][b] != 0.f;
      }
    // also the barrier that ends the previous tile's reads of kT and ps
    if (!__syncthreads_or(any)) continue;

    for (int e = tid; e < F * TJ * r; e += NT) {
      const int f = e / (TJ * r), rem = e - f * TJ * r;
      const int j = rem / r, c = rem - j * r;
      const int m = m0 + j;
      kT[(f * r + c) * KS + j] = m < M ? k[((size_t)f * M + m) * r + c] : 0.f;
    }
    __syncthreads();

    // scores -> exp for every factor, denominators over F in registers
    float den[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int f = 0; f < F; ++f) {
      const float* qf = qT + (size_t)f * r * QS;
      const float* kf = kT + (size_t)f * r * KS;
      float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
      for (int c = 0; c < r; ++c) {
        const float q0 = qf[c * QS + ty], q1 = qf[c * QS + ty + 16];
        const float k0 = kf[c * KS + tx], k1 = kf[c * KS + tx + 16];
        s[0][0] = fmaf(q0, k0, s[0][0]);
        s[0][1] = fmaf(q0, k1, s[0][1]);
        s[1][0] = fmaf(q1, k0, s[1][0]);
        s[1][1] = fmaf(q1, k1, s[1][1]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float e = expf(base + s[a][b]);
          den[a][b] += e;
          ps[(f * TI + ty + 16 * a) * PS + tx + 16 * b] = e;
        }
    }
    // normalize over F, then mask (each thread rescales its own entries)
    float w[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) w[a][b] = mk[a][b] / den[a][b];
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          ps[(f * TI + ty + 16 * a) * PS + tx + 16 * b] *= w[a][b];
    __syncthreads();

    if (owner) {
      const float* prow = ps + (of * TI + oi) * PS;
      for (int j = 0; j < TJ; ++j) acc += prow[j];
    }
  }

  const int n = n0 + oi;
  if (owner && n < N) out[(size_t)of * N + n] = acc;
}

// Launches one sweep on `stream`; returns cudaGetLastError() (0 = launched).
inline int launch_rowsum(const float* q, const float* k, const int8_t* mask,
                         float* out, int F, int N, int M, int r, float base,
                         void* stream) {
  const size_t smem = smem_bytes(F, r);
  cudaError_t err = cudaFuncSetAttribute(
      rowsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rowsum_kernel<<<(N + TI - 1) / TI, NT, smem, (cudaStream_t)stream>>>(
      q, k, mask, out, F, N, M, r, base);
  return (int)cudaGetLastError();
}

}  // namespace routing

extern "C" const char* routed_rowsum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
