// Row gathers over a float32 table, shared by gather_rows.cu and
// gather_reduce.cu.
//
// A table x is [M, D] float32, row-major.  Rows are moved as float4, so a
// row of D = 64 floats is 16 lanes x 16 bytes, and neighbouring lanes read
// neighbouring addresses.  Row ids are int32 and must lie in [0, M): the
// builders check them once on the host (tagrec_tpu_torch/ops/ell.py
// to_device), and the kernels do not check them again.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gather {

constexpr int NT = 256;          // threads per block
constexpr int WARPS = NT / 32;   // warps per block
constexpr int MAX_D4 = 32;       // widest row: 32 float4 = 128 floats
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void fma4(float4& acc, float w, const float4 v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

__device__ __forceinline__ float4 add4(const float4 a, const float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl_xor4(const float4 v, int off) {
  return make_float4(__shfl_xor_sync(FULL, v.x, off),
                     __shfl_xor_sync(FULL, v.y, off),
                     __shfl_xor_sync(FULL, v.z, off),
                     __shfl_xor_sync(FULL, v.w, off));
}

}  // namespace gather

extern "C" const char* gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
