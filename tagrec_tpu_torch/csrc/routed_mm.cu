// routed_mm: out_f = (softmax_F(base + q_f k_f^T) * mask) @ x_f.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_routing.py::_mm_kernel
// (launched by routed_mm through _mm_call, and by its backward
// _routed_mm_bwd).  q [F, NQ, r], k [F, M, r] f32, mask [N, M] int8 or bool
// (rows row0 .. row0 + N of the whole, routed.cuh), x [F, M, dx] f32 ->
// out [F, N, dx] f32.  F <= 4, r <= 128, dx <= 16.  The
// backward (ops/flash_routing.py::routed_mm_bwd) is this same launch over
// the rows of mask^T with q and k swapped and x = the output's gradient:
// dx_f = P_f^T g_f, at the forward's r and dx.
//
// Bound on an H100 (SXM, 700 W): bytes.  At the DGCF hetrec shapes (F = 4,
// N = M = 15,000, r = 80, dx = 16) the mask is 225 MB, 0.067 ms at
// 3.35 TB/s, and its 986,300 edges (0.44%) need F (2r + 2dx + 3) float32
// operations each, 0.005 ms at 67 TFLOP/s.  Each edge also gathers F rows of
// k and of x, 1,536 bytes, from the L2 (k is 19.2 MB, x 3.8 MB).
//
// Design: the row-streamed edge sweep of routed.cuh (shared with
// routed_rowsum.cu), each edge's x_f[m] times its factor-softmax weight
// added to dx accumulators of its factor's lane.

#include "routed.cuh"

namespace routed_mm {

template <bool VEC>
__global__ void __launch_bounds__(routed::NT, 3)
mm_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const int8_t* __restrict__ mask, const float* __restrict__ x,
          float* __restrict__ out, int F, int N, int M, int r, int dx,
          int row0, int NQ, float base, int wpr) {
  routed::sweep<VEC, true>(q, k, mask, x, out, F, N, M, r, dx, row0, NQ,
                           base, wpr);
}

}  // namespace routed_mm

// Launches one routed_mm on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int routed_mm_f32(const float* q, const float* k,
                             const int8_t* mask, const float* x, float* out,
                             int F, int N, int M, int r, int dx, int row0,
                             int NQ, float base, void* stream) {
  const int bad = routed::check_shapes(F, N, M, r, dx, row0, NQ);
  if (bad) return bad;
  if (N <= 0) return 0;
  const int wpr = mask_rows::warps_per_row(M);
  const int blocks = mask_rows::blocks_for(N, wpr);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = r % 4 == 0 && dx % 4 == 0 && (uintptr_t)k % 16 == 0 &&
                   (uintptr_t)x % 16 == 0;
  if (vec)
    routed_mm::mm_kernel<true><<<blocks, routed::NT, 0, st>>>(
        q, k, mask, x, out, F, N, M, r, dx, row0, NQ, base, wpr);
  else
    routed_mm::mm_kernel<false><<<blocks, routed::NT, 0, st>>>(
        q, k, mask, x, out, F, N, M, r, dx, row0, NQ, base, wpr);
  return (int)cudaGetLastError();
}

extern "C" const char* routed_mm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
