// routed_rowsum: d_f[n] = sum_m (softmax_F(base + q_f k_f^T) * mask)[n, m].
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_routing.py::
// _rowsum_kernel (launched by routed_rowsum).  q [F, N, r], k [F, M, r] f32,
// mask [N, M] int8 (0/1) -> d [F, N] f32: the degree vector of DGCF's routed
// adjacency, which the model feeds only to detached paths.
//
// Bound on an H100 (SXM, 700 W): computed densely, the sweep does
// F*N*M*(2r + 1) float32 operations plus F*N*M exps on the CUDA cores
// (67 TFLOP/s): at the DGCF hetrec shapes (F=4, N=M=15000, r=80) 1.4e11
// operations, about 2.2 ms, against 0.07 ms to read the 225 MB mask at
// 3.35 TB/s.  Only the edges are needed (the mask is 0.44% dense), so
// the function's least time is the mask read.  Design (routing.cuh): no
// [F, N, M] plane in device memory, all-zero mask tiles skipped,
// register-blocked score FMAs; the row sums are reduced by one owner thread
// per (factor, row) from the staged P tile.  routed_mm's edge sweep
// (mask_rows.cuh) is the form this kernel's redesign would take.

#include "routing.cuh"

extern "C" int routed_rowsum_f32(const float* q, const float* k,
                                 const int8_t* mask, float* out, int F, int N,
                                 int M, int r, float base, void* stream) {
  return routing::launch_rowsum(q, k, mask, out, F, N, M, r, base, stream);
}
