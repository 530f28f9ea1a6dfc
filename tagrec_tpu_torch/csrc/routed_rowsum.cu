// routed_rowsum: d_f[n] = sum_m (softmax_F(base + q_f k_f^T) * mask)[n, m].
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_routing.py::
// _rowsum_kernel (launched by routed_rowsum).  q [F, NQ, r], k [F, M, r] f32,
// mask [N, M] int8 or bool (rows row0 .. row0 + N of the whole, routed.cuh)
// -> d [F, N] f32: the degree vector of DGCF's
// routed adjacency, which the model feeds only to detached paths.  F <= 4,
// r <= 128, the limits of routed_mm, which DGCF runs on the same q and k.
//
// Bound on an H100 (SXM, 700 W): bytes.  At the DGCF hetrec shapes (F = 4,
// N = M = 15,000, r = 80) the 225 MB mask and the 38.4 MB of q and k take
// 0.079 ms at 3.35 TB/s; the 986,300 edges (0.44%) need F (2r + 4) float32
// operations each, 0.005 ms at 67 TFLOP/s.  Each edge also gathers F rows of
// k, 1,280 bytes, from the L2.  A dense sweep would do those operations for
// all 225 M pairs (about 2.2 ms of the CUDA cores' peak, and far more once
// each tile waits on its loads).
//
// Design: the row-streamed edge sweep of routed.cuh, the same per-edge
// factor softmax as routed_mm without the x gather: each lane adds its
// factor's weight to one register, and the row's sum is written once.

#include "routed.cuh"

namespace routed_rowsum {

template <bool VEC>
__global__ void __launch_bounds__(routed::NT, 3)
rowsum_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const int8_t* __restrict__ mask, float* __restrict__ out, int F,
              int N, int M, int r, int row0, int NQ, float base, int wpr) {
  routed::sweep<VEC, false>(q, k, mask, nullptr, out, F, N, M, r, 1, row0, NQ,
                            base, wpr);
}

}  // namespace routed_rowsum

// Launches one routed_rowsum on `stream`; returns cudaGetLastError().
extern "C" int routed_rowsum_f32(const float* q, const float* k,
                                 const int8_t* mask, float* out, int F, int N,
                                 int M, int r, int row0, int NQ, float base,
                                 void* stream) {
  const int bad = routed::check_shapes(F, N, M, r, 1, row0, NQ);
  if (bad) return bad;
  if (N <= 0) return 0;
  const int wpr = mask_rows::warps_per_row(M);
  const int blocks = mask_rows::blocks_for(N, wpr);
  const cudaStream_t st = (cudaStream_t)stream;
  if (r % 4 == 0 && (uintptr_t)k % 16 == 0)
    routed_rowsum::rowsum_kernel<true><<<blocks, routed::NT, 0, st>>>(
        q, k, mask, out, F, N, M, r, row0, NQ, base, wpr);
  else
    routed_rowsum::rowsum_kernel<false><<<blocks, routed::NT, 0, st>>>(
        q, k, mask, out, F, N, M, r, row0, NQ, base, wpr);
  return (int)cudaGetLastError();
}

extern "C" const char* routed_rowsum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
