// routed_rowsum: d_f[n] = sum_m (softmax_F(base + q_f k_f^T) * mask)[n, m].
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/flash_routing.py::
// _rowsum_kernel (launched by routed_rowsum), which is unchanged.
// q [F, NQ, r], k [F, M, r] f32, the mask's rows row0 .. row0 + N as a
// routing edge list (entries, segments, splits; routed.cuh) -> d [F, N]
// f32: the degree vector of DGCF's routed adjacency, which the model feeds
// only to detached paths.  F <= 4, r <= 128, the limits of routed_mm, which
// DGCF runs on the same q, k and edges.
//
// Bound on an H100 (SXM, 700 W): bytes.  At the DGCF hetrec shapes (F = 4,
// N = M = 15,000, r = 80) the 986,300 edges are 3.9 MB of entries and
// 0.3 MB of row offsets and segments (the dense mask they replace was
// 225 MB), with the 38.4 MB of q and k: 0.013 ms at 3.35 TB/s; the edges
// need F (2r + 4) float32 operations each, 0.005 ms at 67 TFLOP/s.  Each
// edge also gathers F rows of k, 1,280 bytes, from the L2: 1.3 GB a launch
// at r = 80, the part of the time that grows with r.
//
// Design: the segment sweep of routed.cuh, the same per-edge factor
// softmax as routed_mm without the x gather: each lane adds its factor's
// weight to one register; a segment's sum is written once, to the output
// or to its scratch slot, and combine adds a split row's slots in order.

#include "routed.cuh"

namespace routed_rowsum {

template <bool VEC>
__global__ void __launch_bounds__(routed::NT, 3)
rowsum_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const unsigned* __restrict__ entries,
              const int4* __restrict__ segs, int S, float* __restrict__ out,
              float* __restrict__ scratch, int F, int N, int M, int r,
              int row0, int NQ, float base) {
  routed::sweep<VEC, false>(q, k, entries, segs, S, nullptr, out, scratch, F,
                            N, M, r, 1, row0, NQ, base);
}

}  // namespace routed_rowsum

// Launches one routed_rowsum on `stream` (the segment sweep, then combine
// where a row is split); returns cudaGetLastError().  segs [S, 4] and
// splits [K, 3] int32, scratch [slots, F] (unused where K = 0).
extern "C" int routed_rowsum_f32(const float* q, const float* k,
                                 const unsigned* entries, const int* segs,
                                 const int* splits, float* out,
                                 float* scratch, int F, int N, int M, int r,
                                 int row0, int NQ, int S, int K, float base,
                                 void* stream) {
  const int bad = routed::check_shapes(F, N, M, r, 1, row0, NQ, S, K);
  if (bad) return bad;
  if (N <= 0 || S <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = routed::blocks_for(S);
  if (r % 4 == 0 && (uintptr_t)k % 16 == 0)
    routed_rowsum::rowsum_kernel<true><<<blocks, routed::NT, 0, st>>>(
        q, k, entries, (const int4*)segs, S, out, scratch, F, N, M, r, row0,
        NQ, base);
  else
    routed_rowsum::rowsum_kernel<false><<<blocks, routed::NT, 0, st>>>(
        q, k, entries, (const int4*)segs, S, out, scratch, F, N, M, r, row0,
        NQ, base);
  routed::combine(scratch, splits, K, out, F, N, 1, st);
  return (int)cudaGetLastError();
}

extern "C" const char* routed_rowsum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
