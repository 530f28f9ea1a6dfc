// gather_reduce: out[n, :] = sum_k val[n, k] * x[idx[n, k], :], the fused
// ELL SpMM.
//
// Replaces the Pallas TPU kernel tagrec_tpu/ops/dma_gather.py::
// _reduce_kernel (launched by gather_reduce), which DMAs every slot's row
// into a VMEM staging buffer from the scalar core and then reduces on the
// VPU.  x [M, D] f32 (D a multiple of 4, at most 128), idx [N, K] int32,
// val [N, K] f32 -> out [N, D] f32.  Pad slots hold id 0 and value 0 and
// are computed like any slot (0 times a real row), as on the TPU, so a
// non-finite row of x gives the same result as the plain version.
// LightGCN's hybrid SpMM runs it once per degree bucket, forward and
// backward.
//
// Bound on an H100 (SXM, 700 W): bytes.  One SpMM's launches read every
// slot's id and value once (8 bytes a slot), x once (the launches run back
// to back and x fits the 50 MB L2) and write each output row once:
// (8 sum(N K) + 4 M D + 4 sum(N) D) bytes over 3.35 TB/s.  At the 10x graph
// (M = 150,000, D = 64) the seven buckets hold 43.2M slots: 345 MB of ids
// and values, 38 MB of x, 38 MB of output, about 0.126 ms; the float32
// operations over the real edges take a tenth of that at 67 TFLOP/s.  So
// the device-memory stream is ids and values, and the gathered rows mostly
// come from L2.  Design: a row of x is
// G lanes x float4 (G = 16 at D = 64), so a warp gathers 32 / G slots a
// step; it loads 32 slots' ids and values with one coalesced access each
// and hands them out with shuffles; a full chunk of 32 slots is unrolled
// so that its 32 / (32 / G) row loads are in flight together.  Each lane
// keeps its float4 of the sum in registers; the slot lanes are summed with
// shuffles and each output row is written once, without atomics.  Rows of
// up to 256 slots take one warp each (8 rows a block).  Wider rows take a
// block each: 8 warps split the row's chunks and meet in shared memory, so
// the 10x graph's widest bucket (750 rows of 43,904 slots) runs as 750
// blocks, not 750 warps.  The wrapper picks the variant by K.

#include "gather.cuh"

namespace gather {

// Adds val[k] * x[idx[k]] over the slots k0 .. k0 + 31 of one row (fewer at
// the row's end) into this lane's float4 of the sum.  Lane = s * G + c:
// slot lane s, column c (clamped to the row, so the lanes past a width that
// is no power of two repeat the last column and are never stored).
template <int G>
__device__ __forceinline__ void add_chunk(const float4* __restrict__ x,
                                          const int* __restrict__ irow,
                                          const float* __restrict__ vrow,
                                          int k0, int K, int D4, int lane,
                                          float4& acc) {
  constexpr int S = 32 / G;
  const int s = lane / G;
  const int c = min(lane % G, D4 - 1);
  const int kk = k0 + lane;
  const int my_i = kk < K ? __ldg(irow + kk) : 0;
  const float my_v = kk < K ? __ldg(vrow + kk) : 0.f;
  if (k0 + 32 <= K) {
#pragma unroll
    for (int j = 0; j < 32; j += S) {
      const int i = __shfl_sync(FULL, my_i, j + s);
      const float w = __shfl_sync(FULL, my_v, j + s);
      fma4(acc, w, __ldg(x + (int64_t)i * D4 + c));
    }
  } else {
    const int cnt = K - k0;
    for (int j = 0; j < cnt; j += S) {
      const int i = __shfl_sync(FULL, my_i, j + s);
      const float w = __shfl_sync(FULL, my_v, j + s);
      if (j + s < cnt) fma4(acc, w, __ldg(x + (int64_t)i * D4 + c));
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
                   const float* __restrict__ val, float4* __restrict__ out,
                   int N, int K, int D4) {
  const int lane = threadIdx.x & 31;
  const int64_t n = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp leaves together
  const int* irow = idx + n * K;
  const float* vrow = val + n * K;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += 32)
    add_chunk<G>(x, irow, vrow, k0, K, D4, lane, acc);
  acc = sum_slot_lanes<G>(acc);
  if (lane < D4) out[n * D4 + lane] = acc;
}

// One block per row: warp w takes the chunks w, w + WARPS, ... of 32 slots.
template <int G>
__global__ void __launch_bounds__(NT)
reduce_block_kernel(const float4* __restrict__ x, const int* __restrict__ idx,
                    const float* __restrict__ val, float4* __restrict__ out,
                    int N, int K, int D4) {
  __shared__ float4 part[WARPS][MAX_D4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = blockIdx.x;
  const int* irow = idx + n * K;
  const float* vrow = val + n * K;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = warp * 32; k0 < K; k0 += NT)
    add_chunk<G>(x, irow, vrow, k0, K, D4, lane, acc);
  acc = sum_slot_lanes<G>(acc);
  if (lane < D4) part[warp][lane] = acc;
  __syncthreads();
  if (threadIdx.x < D4) {
    float4 sum = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum = add4(sum, part[w][threadIdx.x]);
    out[n * D4 + threadIdx.x] = sum;
  }
}

template <int G>
int launch_reduce(const float* x, const int* idx, const float* val,
                  float* out, int N, int K, int D4, int wide,
                  cudaStream_t stream) {
  const float4* x4 = (const float4*)x;
  float4* o4 = (float4*)out;
  if (wide)
    reduce_block_kernel<G><<<N, NT, 0, stream>>>(x4, idx, val, o4, N, K, D4);
  else
    reduce_warp_kernel<G><<<(N + WARPS - 1) / WARPS, NT, 0, stream>>>(
        x4, idx, val, o4, N, K, D4);
  return (int)cudaGetLastError();
}

}  // namespace gather

// Launches one gather-reduce on `stream` (`wide`: one block per row, else
// one warp per row); returns cudaGetLastError() (0 = ok).  x and out must
// lie on 16-byte boundaries.
extern "C" int gather_reduce_f32(const float* x, const int* idx,
                                 const float* val, float* out, int N, int K,
                                 int D, int wide, void* stream) {
  using namespace gather;
  if (D < 4 || D % 4 || D > 4 * MAX_D4 || K < 0 ||
      (uintptr_t)x % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const int D4 = D / 4;
  const cudaStream_t st = (cudaStream_t)stream;
  // G: the lanes of one row, the least power of two >= D4
  if (D4 <= 1) return launch_reduce<1>(x, idx, val, out, N, K, D4, wide, st);
  if (D4 <= 2) return launch_reduce<2>(x, idx, val, out, N, K, D4, wide, st);
  if (D4 <= 4) return launch_reduce<4>(x, idx, val, out, N, K, D4, wide, st);
  if (D4 <= 8) return launch_reduce<8>(x, idx, val, out, N, K, D4, wide, st);
  if (D4 <= 16)
    return launch_reduce<16>(x, idx, val, out, N, K, D4, wide, st);
  return launch_reduce<32>(x, idx, val, out, N, K, D4, wide, st);
}
