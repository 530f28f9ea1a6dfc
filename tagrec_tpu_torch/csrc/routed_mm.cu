// routed_mm: out_f = (softmax_F(base + q_f k_f^T) * mask) @ x_f.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_routing.py::_mm_kernel
// (launched by routed_mm through _mm_call, and by its backward
// _routed_mm_bwd), which is unchanged.  q [F, NQ, r], k [F, M, r] f32, the
// mask's rows row0 .. row0 + N as a routing edge list (entries, segments,
// splits; routed.cuh), x [F, M, dx] f32 -> out [F, N, dx] f32.  F <= 4,
// r <= 128, dx <= 16.  The backward (ops/flash_routing.py::routed_mm_bwd)
// is this same launch over the edge list of mask^T with q and k swapped
// and x = the output's gradient: dx_f = P_f^T g_f, at the forward's r and
// dx.
//
// Bound on an H100 (SXM, 700 W): bytes.  At the DGCF hetrec shapes (F = 4,
// N = M = 15,000, r = 80, dx = 16) the 986,300 edges are 3.9 MB of entries
// and 0.3 MB of row offsets and segments (the dense mask they replace was
// 225 MB), q, k, x and out 50 MB read or written once: 0.016 ms at
// 3.35 TB/s; the edges need F (2r + 2dx + 3) float32 operations each,
// 0.005 ms at 67 TFLOP/s.  Each edge also gathers F rows of k and of x,
// 1,536 bytes, from the L2 (k is 19.2 MB, x 3.8 MB): 1.5 GB a launch at
// r = 80, the part of the time that grows with r.
//
// Design: the segment sweep of routed.cuh (shared with routed_rowsum.cu):
// the edges cut into segments of at most L edges, longest first, a warp a
// segment, each edge's x_f[m] times its factor-softmax weight added to dx
// accumulators of its factor's lane; a row cut into several segments gets
// its sums from scratch slots in a second, ordered launch (combine).

#include "routed.cuh"

namespace routed_mm {

template <bool VEC>
__global__ void __launch_bounds__(routed::NT, 3)
mm_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const unsigned* __restrict__ entries, const int4* __restrict__ segs,
          int S, const float* __restrict__ x, float* __restrict__ out,
          float* __restrict__ scratch, int F, int N, int M, int r, int dx,
          int row0, int NQ, float base) {
  routed::sweep<VEC, true>(q, k, entries, segs, S, x, out, scratch, F, N, M,
                           r, dx, row0, NQ, base);
}

}  // namespace routed_mm

// Launches one routed_mm on `stream` (the segment sweep, then combine where
// a row is split); returns cudaGetLastError() (0 = ok).  segs [S, 4] and
// splits [K, 3] int32, scratch [slots, F, dx] (unused where K = 0).
extern "C" int routed_mm_f32(const float* q, const float* k,
                             const unsigned* entries, const int* segs,
                             const int* splits, const float* x, float* out,
                             float* scratch, int F, int N, int M, int r,
                             int dx, int row0, int NQ, int S, int K,
                             float base, void* stream) {
  const int bad = routed::check_shapes(F, N, M, r, dx, row0, NQ, S, K);
  if (bad) return bad;
  if (N <= 0 || S <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = r % 4 == 0 && dx % 4 == 0 && (uintptr_t)k % 16 == 0 &&
                   (uintptr_t)x % 16 == 0;
  const int blocks = routed::blocks_for(S);
  if (vec)
    routed_mm::mm_kernel<true><<<blocks, routed::NT, 0, st>>>(
        q, k, entries, (const int4*)segs, S, x, out, scratch, F, N, M, r, dx,
        row0, NQ, base);
  else
    routed_mm::mm_kernel<false><<<blocks, routed::NT, 0, st>>>(
        q, k, entries, (const int4*)segs, S, x, out, scratch, F, N, M, r, dx,
        row0, NQ, base);
  routed::combine(scratch, splits, K, out, F, N, dx, st);
  return (int)cudaGetLastError();
}

extern "C" const char* routed_mm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
