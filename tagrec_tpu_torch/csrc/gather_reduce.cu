// gather_reduce: out[n, :] = sum_k val[n, k] * x[idx[n, k], :] over the
// slots k < end(n), the fused ELL SpMM.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/dma_gather.py::
// _reduce_kernel (launched by gather_reduce), which DMAs every slot's row
// into a VMEM staging buffer from the scalar core and then reduces on the
// VPU.  x [M, D] f32 (D a multiple of 4, at most 128), idx [N, K] int32,
// val [N, K] f32, deg [N] int32 or null -> out [N, D] f32.  With deg, row n
// sums its slots [0, deg[n]) only (clamped to [0, K]): the ELL builders put
// every edge there and every pad after it, so the pad slots are never read.
// Without it, every one of the K slots is summed, a pad (id 0, value 0)
// like any slot, as on the TPU, where a pad may sit anywhere.  LightGCN's
// hybrid SpMM runs it once per degree bucket, forward and backward, with
// the bucket's deg.
//
// Bound on an H100 (SXM, 700 W): bytes.  One SpMM's launches read each real
// edge's id and value once (8 bytes an edge), deg (4 bytes a row), x once
// (the launches run back to back and x fits the 50 MB L2) and write each
// output row once: (8 E + 4 sum(N) + 4 M D + 4 sum(N) D) bytes over
// 3.35 TB/s.  At the 10x graph (M = 150,000, D = 64) the seven buckets hold
// 8.03M edges: 64 MB of ids and values, 38 MB of x, 38 MB of output, about
// 0.042 ms; the float32 operations take a tenth of that at 67 TFLOP/s.  The
// gathered rows (E * D * 4 bytes, 2.05 GB an SpMM) come from the L2.
//
// Design: a row of x is G lanes x float4 (G = 16 at D = 64), so a warp
// gathers 32 / G slots a step; it loads 32 slots' ids and values with one
// coalesced access each, a chunk ahead of the chunk it gathers, and hands
// them out with shuffles; a full chunk of 32 slots is unrolled so that its
// 32 / (32 / G) row loads are in flight together.  Each lane keeps its
// float4 of the sum in registers; the slot lanes are summed with shuffles.
// Rows of up to 256 slots take one warp each (8 rows a block).  Wider rows
// take a block of 8 warps for every `span` slots (grid N x ceil(K / span));
// a block whose first slot is at or past end(n) exits at once, so the host
// needs no per-row plan.  A row of one active block writes its output row
// itself; the active blocks of a longer row each leave their partial sum in
// `part`, count themselves in `count` (an integer atomic), and the last adds
// the partials in span order: every output row is written once, with no
// float atomics, and the result does not depend on the blocks' order.

#include "gather.cuh"

namespace gather {

// The slots [0, end) a row sums: [0, deg[n]) clamped to the row, or all K.
__device__ __forceinline__ int row_end(const int* __restrict__ deg,
                                       int64_t n, int K) {
  return deg ? min(max(__ldg(deg + n), 0), K) : K;
}

// Adds val[k] * x[idx[k]] over the slots k0, k0 + 1, ... < end of one row,
// 32 slots a chunk, chunks `stride` apart, into this lane's float4 of the
// sum.  Lane = s * G + c: slot lane s, column c (clamped to the row, so the
// lanes past a width that is no power of two repeat the last column and are
// never stored).  Warp-uniform.
template <int G>
__device__ __forceinline__ void add_slots(const float4* __restrict__ x,
                                          const int* __restrict__ irow,
                                          const float* __restrict__ vrow,
                                          int k0, int end, int stride, int D4,
                                          int lane, float4& acc) {
  constexpr int S = 32 / G;
  const int s = lane / G;
  const int c = min(lane % G, D4 - 1);
  int kk = k0 + lane;
  int next_i = kk < end ? __ldg(irow + kk) : 0;
  float next_v = kk < end ? __ldg(vrow + kk) : 0.f;
  for (; k0 < end; k0 += stride) {
    const int my_i = next_i;
    const float my_v = next_v;
    kk = k0 + stride + lane;  // the next chunk's, before this one's gathers
    next_i = kk < end ? __ldg(irow + kk) : 0;
    next_v = kk < end ? __ldg(vrow + kk) : 0.f;
    if (k0 + 32 <= end) {
#pragma unroll
      for (int j = 0; j < 32; j += S) {
        const int i = __shfl_sync(FULL, my_i, j + s);
        const float w = __shfl_sync(FULL, my_v, j + s);
        fma4(acc, w, __ldg(x + (int64_t)i * D4 + c));
      }
    } else {
      const int cnt = end - k0;
      for (int j = 0; j < cnt; j += S) {
        const int i = __shfl_sync(FULL, my_i, j + s);
        const float w = __shfl_sync(FULL, my_v, j + s);
        if (j + s < cnt) fma4(acc, w, __ldg(x + (int64_t)i * D4 + c));
      }
    }
  }
}

// The sum over a warp's slot lanes: every lane ends with its column's sum.
template <int G>
__device__ __forceinline__ float4 sum_slot_lanes(float4 acc) {
#pragma unroll
  for (int off = G; off < 32; off <<= 1) acc = add4(acc, shfl_xor4(acc, off));
  return acc;
}

// One warp per row, WARPS rows a block.
template <int G>
__global__ void __launch_bounds__(NT)
reduce_warp_kernel(const float4* __restrict__ x, const int* __restrict__ idx,
                   const float* __restrict__ val, const int* __restrict__ deg,
                   float4* __restrict__ out, int N, int K, int D4) {
  const int lane = threadIdx.x & 31;
  const int64_t n = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves together
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  add_slots<G>(x, idx + n * K, val + n * K, 0, row_end(deg, n, K), 32, D4,
               lane, acc);
  acc = sum_slot_lanes<G>(acc);
  if (lane < D4) out[n * D4 + lane] = acc;
}

// Block (n, b) sums the slots [b * span, (b + 1) * span) of row n below its
// end: warp w takes the chunks w, w + WARPS, ... of 32 slots.  `part` holds
// gridDim.y partial rows a row, `count` one zeroed int a row (both unused,
// and may be null, when gridDim.y == 1).
template <int G>
__global__ void __launch_bounds__(NT)
reduce_block_kernel(const float4* __restrict__ x, const int* __restrict__ idx,
                    const float* __restrict__ val, const int* __restrict__ deg,
                    float4* __restrict__ out, float4* part,
                    int* __restrict__ count, int N, int K, int D4, int span) {
  __shared__ float4 sums[WARPS][MAX_D4];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = blockIdx.x;
  const int b = blockIdx.y;
  const int end = row_end(deg, n, K);
  const int active = end > 0 ? (end - 1) / span + 1 : 1;  // the row's blocks
  if (b >= active) return;  // the whole block leaves together
  const int k0 = b * span;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  add_slots<G>(x, idx + n * K, val + n * K, k0 + warp * 32,
               min(k0 + span, end), NT, D4, lane, acc);
  acc = sum_slot_lanes<G>(acc);
  if (lane < D4) sums[warp][lane] = acc;
  __syncthreads();
  const int t = threadIdx.x;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t < D4) {
    sum = sums[0][t];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum = add4(sum, sums[w][t]);
  }
  if (active == 1) {
    if (t < D4) out[n * D4 + t] = sum;
    return;
  }
  float4* prow = part + n * gridDim.y * D4;
  if (t < D4) {
    prow[b * D4 + t] = sum;
    __threadfence();  // the partial is visible before the count says so
  }
  __syncthreads();
  if (t == 0) last = atomicAdd(count + n, 1) == active - 1;
  __syncthreads();
  if (last && t < D4) {  // every partial has landed: add them in span order
    float4 tot = __ldcg(prow + t);
    for (int r = 1; r < active; ++r) tot = add4(tot, __ldcg(prow + r * D4 + t));
    out[n * D4 + t] = tot;
  }
}

template <int G>
int launch_reduce(const float* x, const int* idx, const float* val,
                  const int* deg, float* out, float* part, int* count, int N,
                  int K, int D4, int span, cudaStream_t stream) {
  const float4* x4 = (const float4*)x;
  float4* o4 = (float4*)out;
  if (span > 0) {
    const dim3 grid(N, K > span ? (int)(((int64_t)K + span - 1) / span) : 1);
    reduce_block_kernel<G><<<grid, NT, 0, stream>>>(
        x4, idx, val, deg, o4, (float4*)part, count, N, K, D4, span);
  } else {
    reduce_warp_kernel<G><<<(N + WARPS - 1) / WARPS, NT, 0, stream>>>(
        x4, idx, val, deg, o4, N, K, D4);
  }
  return (int)cudaGetLastError();
}

}  // namespace gather

// Launches one gather-reduce on `stream`: one warp per row if span == 0,
// else blocks of `span` slots, ceil(K / span) a row (part [N, that, D] and
// count [N], zeroed, needed when that exceeds 1); deg may be null (every
// slot).  Returns cudaGetLastError() (0 = ok).  x, out and part must lie on
// 16-byte boundaries.
extern "C" int gather_reduce_f32(const float* x, const int* idx,
                                 const float* val, const int* deg, float* out,
                                 float* part, int* count, int N, int K, int D,
                                 int span, void* stream) {
  using namespace gather;
  const int64_t blocks = span > 0 ? ((int64_t)K + span - 1) / span : 1;
  if (D < 4 || D % 4 || D > 4 * MAX_D4 || K < 0 || span < 0 ||
      blocks > 65535 || (uintptr_t)x % 16 || (uintptr_t)out % 16 ||
      (blocks > 1 && (!part || !count || (uintptr_t)part % 16)))
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const int D4 = D / 4;
  const cudaStream_t st = (cudaStream_t)stream;
  // G: the lanes of one row, the least power of two >= D4
  if (D4 <= 1)
    return launch_reduce<1>(x, idx, val, deg, out, part, count, N, K, D4,
                            span, st);
  if (D4 <= 2)
    return launch_reduce<2>(x, idx, val, deg, out, part, count, N, K, D4,
                            span, st);
  if (D4 <= 4)
    return launch_reduce<4>(x, idx, val, deg, out, part, count, N, K, D4,
                            span, st);
  if (D4 <= 8)
    return launch_reduce<8>(x, idx, val, deg, out, part, count, N, K, D4,
                            span, st);
  if (D4 <= 16)
    return launch_reduce<16>(x, idx, val, deg, out, part, count, N, K, D4,
                             span, st);
  return launch_reduce<32>(x, idx, val, deg, out, part, count, N, K, D4, span,
                           st);
}
