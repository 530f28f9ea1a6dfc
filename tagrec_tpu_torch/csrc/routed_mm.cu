// routed_mm: out_f = (softmax_F(base + q_f k_f^T) * mask) @ x_f, forward only.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_routing.py::_mm_kernel
// (launched by routed_mm through _mm_call).  q [F, N, r], k [F, M, r] f32,
// mask [N, M] int8 or bool (one byte a pair; multiplied by its value, as the
// Pallas kernel multiplies p * m_tile), x [F, M, dx] f32 -> out [F, N, dx]
// f32.  F <= 4, r <= 128, dx <= 16.  The softmax runs over the F factors of
// one (n, m) pair and has no max subtraction: the callers' scores are
// bounded (DGCF: |S| <= 1 + number of routing iterations), so exp cannot
// overflow.  The backward of the JAX routed_mm is this same function over
// mask^T with q and k swapped.
//
// Bound on an H100 (SXM, 700 W): bytes.  At the DGCF hetrec shapes (F = 4,
// N = M = 15,000, r = 80, dx = 16) the mask is 225 MB, 0.067 ms at
// 3.35 TB/s, and its 986,300 edges (0.44%) need F (2r + 2dx + 3) float32
// operations each, 0.005 ms at 67 TFLOP/s.  Each edge also gathers F rows of
// k and of x, 1,536 bytes, from the L2 (k is 19.2 MB, x 3.8 MB).  There is
// no shared tile for the tensor cores: each edge is F dots of r against its
// own k rows, so the kernel is CUDA-core float32 and its effort goes into
// keeping the mask stream and the gathers in flight.
//
// Design (mask_rows.cuh): a row-streamed edge sweep.  wpr warps own a row
// n; its q rows (F x r floats) are staged once in shared memory.  A warp
// works 8 edges (n, m) at a time, 4 lanes an edge, lane f taking factor f:
// it forms s_f = q_f[n] . k_f[m] alone (r / 4 float4 loads of its k row and
// of q from shared memory, four partial sums), e_f = exp(base + s_f), two
// shuffles sum e over the factors, and it adds e_f * mask / sum_g e_g times
// x_f[m] (dx floats) to its own dx accumulators.  So a warp keeps 8 edges'
// gathers in flight, and a heavy row (a tag row of 5,691 edges) takes
// 8 x 8 at a time.  At the row's end three shuffles sum the warp's 8 lane
// groups, the row's warps meet once in shared memory, and each output row is
// written once, without atomics.  Rows of k and x are read as float4 where
// r and dx are multiples of 4 and k and x lie on 16-byte boundaries (VEC),
// else one float at a time.  A column whose mask byte is 0 is never read,
// so a non-finite k or x there does not reach the row (a dense sweep gives
// NaN there, as the plain version does).

#include "mask_rows.cuh"

namespace routed_mm {

using mask_rows::FULL;
using mask_rows::G;
using mask_rows::NT;
using mask_rows::WARPS;

constexpr int MAXF = G;      // one lane a factor
constexpr int MAXR = 128;
constexpr int MAXDX = 16;
constexpr int MAXQS = MAXR + 4;  // the widest stride of a staged q row

// The stride of a staged q row: a multiple of 4 floats (float4 reads) whose
// four factor rows start in four different bank quads.
__device__ __forceinline__ int q_stride(int r) { return ((r + 7) & ~7) + 4; }

// q_f[n] . k_f[m] over r columns.
template <bool VEC>
__device__ __forceinline__ float dot(const float* qf,
                                     const float* __restrict__ krow, int r) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (VEC) {
#pragma unroll 4
    for (int c = 0; c < r; c += 4) {
      const float4 a = *(const float4*)(qf + c);
      const float4 b = __ldg((const float4*)(krow + c));
      s[0] = fmaf(a.x, b.x, s[0]);
      s[1] = fmaf(a.y, b.y, s[1]);
      s[2] = fmaf(a.z, b.z, s[2]);
      s[3] = fmaf(a.w, b.w, s[3]);
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < r; ++c) s[0] = fmaf(qf[c], __ldg(krow + c), s[0]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 3)
mm_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const int8_t* __restrict__ mask, const float* __restrict__ x,
          float* __restrict__ out, int F, int N, int M, int r, int dx,
          float base, int wpr) {
  __shared__ mask_rows::Warp ws[WARPS];
  __shared__ __align__(16) float qs[WARPS * MAXF * MAXQS];
  __shared__ float part[WARPS][MAXF * MAXDX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / wpr, p = warp % wpr;
  const int n = blockIdx.x * (WARPS / wpr) + slot;
  const int f = lane % G;
  const bool fok = f < F;
  const int stride = q_stride(r);
  float* qrow = qs + slot * MAXF * stride;
  if (n < N)  // the row's warps stage its q rows
    for (int e = p * 32 + lane; e < F * r; e += wpr * 32) {
      const int ff = e / r, c = e - ff * r;
      qrow[ff * stride + c] = q[((size_t)ff * N + n) * r + c];
    }
  __syncthreads();

  float acc[MAXDX];
#pragma unroll
  for (int d = 0; d < MAXDX; ++d) acc[d] = 0.f;
  if (n < N) {  // uniform over the row's warps
    const float* qf = qrow + f * stride;
    const float* kf = k + (size_t)(fok ? f : 0) * M * r;
    const float* xf = x + (size_t)(fok ? f : 0) * M * dx;
    auto work = [&](int m, float val, bool valid) {
      const bool on = valid && fok;
      const float s = on ? dot<VEC>(qf, kf + (size_t)m * r, r) : 0.f;
      float xv[MAXDX];
      const float* xrow = xf + (size_t)m * dx;
#pragma unroll
      for (int d = 0; d < MAXDX; d += 4) {
        if (VEC) {
          const float4 v = on && d < dx ? __ldg((const float4*)(xrow + d))
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
          xv[d] = v.x;
          xv[d + 1] = v.y;
          xv[d + 2] = v.z;
          xv[d + 3] = v.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            xv[d + u] = on && d + u < dx ? __ldg(xrow + d + u) : 0.f;
        }
      }
      const float ex = on ? expf(base + s) : 0.f;
      float den = ex + __shfl_xor_sync(FULL, ex, 1);
      den += __shfl_xor_sync(FULL, den, 2);
      const float w = on ? ex * (val / den) : 0.f;
#pragma unroll
      for (int d = 0; d < MAXDX; ++d) acc[d] = fmaf(w, xv[d], acc[d]);
    };
    mask_rows::sweep_row<false>(mask + (size_t)n * M, M, p, wpr, ws[warp],
                                work);
  }
  // the warp's 8 lane groups, then the row's warps
#pragma unroll
  for (int d = 0; d < MAXDX; ++d)
#pragma unroll
    for (int off = G; off < 32; off <<= 1)
      acc[d] += __shfl_xor_sync(FULL, acc[d], off);
  if (lane < G)
#pragma unroll
    for (int d = 0; d < MAXDX; ++d) part[warp][lane * MAXDX + d] = acc[d];
  __syncthreads();
  if (n < N && p == 0)
    for (int o = lane; o < F * dx; o += 32) {
      const int ff = o / dx, d = o - ff * dx;
      float sum = 0.f;
      for (int w = 0; w < wpr; ++w) sum += part[warp + w][ff * MAXDX + d];
      out[((size_t)ff * N + n) * dx + d] = sum;
    }
}

template <bool VEC>
int launch(const float* q, const float* k, const int8_t* mask,
           const float* x, float* out, int F, int N, int M, int r, int dx,
           float base, cudaStream_t stream) {
  const int wpr = mask_rows::warps_per_row(M);
  mm_kernel<VEC><<<mask_rows::blocks_for(N, wpr), NT, 0, stream>>>(
      q, k, mask, x, out, F, N, M, r, dx, base, wpr);
  return (int)cudaGetLastError();
}

}  // namespace routed_mm

// Launches one routed_mm on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int routed_mm_f32(const float* q, const float* k,
                             const int8_t* mask, const float* x, float* out,
                             int F, int N, int M, int r, int dx, float base,
                             void* stream) {
  using namespace routed_mm;
  if (F < 1 || F > MAXF || r < 1 || r > MAXR || dx < 0 || dx > MAXDX ||
      M < 0 || M >= mask_rows::MAX_COLS)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = r % 4 == 0 && dx % 4 == 0 && (uintptr_t)k % 16 == 0 &&
                   (uintptr_t)x % 16 == 0;
  return vec ? launch<true>(q, k, mask, x, out, F, N, M, r, dx, base, st)
             : launch<false>(q, k, mask, x, out, F, N, M, r, dx, base, st);
}

extern "C" const char* routed_mm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
