// dot_flash_stats: per-row max m and sum z of the masked two-segment scores.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_attention.py::
// _dot_stats_kernel (launched by dot_flash_stats through _dot_stats).
// q2 [2, NsAll, dq], k [Nd, dq] f32 (dq <= 64), mask [Ns, Nd] int8 (0/1:
// rows row0 .. row0 + Ns of the whole, dot_flash.cuh), split (any column
// offset) -> m [Ns], z [Ns] f32, where over the row's edges (i, j)
// (mask > 0)
//   S = q2[p(j)][i] . k[j],  p(j) = (j >= split),
//   m[i] = max(NEG, max S),  z[i] = sum exp(S - m[i]) * mask
// (the mask byte is the weight, as JAX multiplies by it); a row with no
// edge gives exactly (NEG, 0).
//
// Bound on an H100 (SXM, 700 W): bytes.  At KGAT's hetrec shapes the three
// row types' masks (117 MB, about 0.035 ms a pass at 3.35 TB/s) are
// 0.46-1.49% dense, and each edge needs 2*dq + 4 float32 operations (its
// score and one online-softmax step: about 0.002 ms a pass at 67 TFLOP/s)
// and a gathered k row from the L2 (at most 3.4 MB).  Each edge's dot is
// against its own k row: there is no shared tile for the tensor cores, so
// the kernel is CUDA-core float32 and its effort goes into keeping the mask
// stream and the gathers in flight.
//
// Design (mask_rows.cuh), as dot_flash_apply.cu: a row-streamed edge sweep.
// wpr warps own a row i, and its two q rows are staged once in shared
// memory.  A warp works 8 edges at a time, 4 lanes an edge: lane l takes
// the columns col_of(l, t) of k (as float4 where dq is a multiple of 4 and
// k lies on a 16-byte boundary, VEC), forms its part of S against the plane
// of the edge's segment (chosen per edge, so the split needs no alignment),
// and two shuffles sum the 4 parts.  Each lane group keeps its own online
// (m, z) from (NEG, 0): an edge above m rescales z by exp(m - S) and adds
// its byte, any other adds exp(S - m) times its byte, one exponential an
// edge.  At the row's end three shuffles merge the warp's 8 lane groups by
// the same rule (from the finite NEG, so two empty groups give exp(0) * 0,
// never inf - inf), the row's warps meet once in shared memory, and m[i]
// and z[i] are written once, without atomics.  A column off the row's
// edges is never read (the plain version masks its score to NEG).

#include "dot_flash.cuh"

namespace dot_flash {

// (m, z) <- the merge of (m, z) and (mo, zo), two online row statistics.
__device__ __forceinline__ void merge_stats(float& m, float& z, float mo,
                                            float zo) {
  const float mn = fmaxf(m, mo);
  z = z * expf(m - mn) + zo * expf(mo - mn);
  m = mn;
}

template <bool VEC>
__global__ void __launch_bounds__(mask_rows::NT)
stats_kernel(const float* __restrict__ q2, const float* __restrict__ k,
             const int8_t* __restrict__ mask, float* __restrict__ mout,
             float* __restrict__ zout, int Ns, int Nd, int dq, int split,
             int row0, int NsAll, int wpr) {
  using mask_rows::FULL;
  using mask_rows::G;
  using mask_rows::WARPS;
  __shared__ mask_rows::Warp ws[WARPS];
  __shared__ __align__(16) float qs[WARPS * 2 * QS2];
  __shared__ float part[WARPS][2];
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

  float m = NEG, z = 0.f;  // the lane group's online statistics
  if (i < Ns) {            // uniform over the row's warps
    auto work = [&](int j, float v, bool valid) {
      const bool on = valid && v > 0.f;
      const float* qp = qrow + (j >= split ? QS2 : 0);
      const float* krow = k + (size_t)j * dq;
      float s = 0.f;
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
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int cu = col_of<VEC>(l, t + u);
            if (on && cu < dq) s = fmaf(qp[cu], __ldg(krow + cu), s);
          }
        }
      }
      s += __shfl_xor_sync(FULL, s, 1);
      s += __shfl_xor_sync(FULL, s, 2);
      if (on) {
        if (s > m) {
          z = z * expf(m - s) + v;
          m = s;
        } else {
          z += expf(s - m) * v;
        }
      }
    };
    mask_rows::sweep_row<true>(mask + (size_t)i * Nd, Nd, p, wpr, ws[warp],
                               work);
  }
  // the warp's 8 lane groups, then the row's warps
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
    merge_stats(m, z, __shfl_xor_sync(FULL, m, off),
                __shfl_xor_sync(FULL, z, off));
  if (lane == 0) {
    part[warp][0] = m;
    part[warp][1] = z;
  }
  __syncthreads();
  if (i < Ns && p == 0 && lane == 0) {
    for (int w = 1; w < wpr; ++w)
      merge_stats(m, z, part[warp + w][0], part[warp + w][1]);
    mout[i] = m;
    zout[i] = z;
  }
}

}  // namespace dot_flash

// Launches one stats sweep on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int dot_flash_stats_f32(const float* q2, const float* k,
                                   const int8_t* mask, float* m, float* z,
                                   int Ns, int Nd, int dq, int split,
                                   int row0, int NsAll, void* stream) {
  using namespace dot_flash;
  if (dq < 1 || dq > MAXD || Nd < 0 || Nd >= mask_rows::MAX_COLS ||
      row0 < 0 || Ns > NsAll - row0)
    return (int)cudaErrorInvalidValue;
  if (Ns <= 0) return 0;
  const int wpr = mask_rows::warps_per_row(Nd);
  const int blocks = mask_rows::blocks_for(Ns, wpr);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dq % 4 == 0 && (uintptr_t)k % 16 == 0)
    stats_kernel<true><<<blocks, mask_rows::NT, 0, st>>>(
        q2, k, mask, m, z, Ns, Nd, dq, split, row0, NsAll, wpr);
  else
    stats_kernel<false><<<blocks, mask_rows::NT, 0, st>>>(
        q2, k, mask, m, z, Ns, Nd, dq, split, row0, NsAll, wpr);
  return (int)cudaGetLastError();
}
