// gather_rows: out[r, :] = x[idx[r], :], a row copy.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/dma_gather.py::
// _gather_kernel (launched by gather_rows), which issues one DMA per row
// from the scalar core.  x [M, D] f32, idx [R] int32 -> out [R, D] f32, bit
// for bit.  LightGCN's hybrid SpMM runs it twice: to restore row order
// after the degree buckets (R = N over the [N, D] bucket outputs) and to
// take the hub columns' rows (R = H hub columns).
//
// Bound on an H100 (SXM, 700 W): bytes.  Each id is read once and each row
// read once and written once, (4 R + 8 R D) bytes over 3.35 TB/s: at the
// 10x graph's reassembly (R = 150,000, D = 64) 77 MB, about 23 us; there is
// no arithmetic.  Design: one thread per float4 of the output, so a warp
// moves two 256-byte rows with every access coalesced; the block count
// covers the whole output (a grid-stride loop beyond 2^20 blocks).  The
// wrapper (ops/dma_gather.py) passes only rows of a multiple of 4 floats
// on 16-byte boundaries.

#include "gather.cuh"

namespace gather {

__global__ void __launch_bounds__(NT)
rows_kernel(const float4* __restrict__ x, const int* __restrict__ idx,
            float4* __restrict__ out, int64_t total, int width) {
  for (int64_t t = (int64_t)blockIdx.x * NT + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * NT) {
    const int64_t r = t / width;
    const int c = (int)(t - r * width);
    out[t] = x[(int64_t)__ldg(idx + r) * width + c];
  }
}

}  // namespace gather

// Launches one gather on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int gather_rows_f32(const float* x, const int* idx, float* out,
                               int R, int D, void* stream) {
  using namespace gather;
  if (R <= 0 || D <= 0) return 0;
  const int width = D / 4;
  const int64_t total = (int64_t)R * width;
  const int64_t blocks = (total + NT - 1) / NT;
  rows_kernel<<<(unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)), NT, 0,
                (cudaStream_t)stream>>>((const float4*)x, idx, (float4*)out,
                                        total, width);
  return (int)cudaGetLastError();
}
