// Factor-softmax routing as a sweep over a compressed row list of the mask's
// edges, shared by routed_mm.cu and routed_rowsum.cu.
//
// For every factor f, row n and column m of the routed adjacency
//   P_f[n, m] = exp(base + q_f[n] . k_f[m]) / sum_g exp(base + q_g[n] . k_g[m])
//               * mask[n, m]
// the two functions compute
//   routed_mm      out_f[n] = sum_m P_f[n, m] x_f[m]   (GATHER: an x row an edge)
//   routed_rowsum  d_f[n]   = sum_m P_f[n, m]          (x_f = 1: no gather)
// with one per-edge body (edge), so that the two softmaxes cannot drift
// apart.  q [F, NQ, r], k [F, M, r] f32, x [F, M, dx] f32; F <= 4, r <= 128,
// dx <= 16.  The mask comes as its edges (ops/flash_routing.py
// RoutingEdges, built once on the host): one 32-bit entry an edge, column |
// mask byte << 24, row by row in column order, so an int8 mask's value
// still multiplies the weight.  Its rows are rows row0 .. row0 + N of the
// whole (a rank's rows under a mesh, or all of them with row0 = 0 and N =
// NQ): row n reads q row row0 + n and writes out row n of [F, N, dx] (or
// [F, N]), so a rank's rows land in its part of a send buffer without a
// copy.  The softmax runs over the F factors of one (n, m) pair and has no
// max subtraction: the callers' scores are bounded (DGCF: |S| <= 1 + number
// of routing iterations), so exp cannot overflow.
//
// Design: the host cuts each row's entries into segments of at most L
// edges (L from the list's edge count and the card's SM count) and orders
// the segments longest first, so the card's warps take equal shares and a
// tag row of 5,691 edges is many warps' work, not one block's.  A warp
// works one segment: it stages its row's q rows (F x r floats) in shared
// memory, then walks the segment 8 edges at a time, 4 lanes an edge, lane
// f taking factor f: it forms s_f = q_f[n] . k_f[m] alone (r / 4 float4
// loads of its k row and of q from shared memory, four partial sums),
// e_f = exp(base + s_f), two shuffles sum e over the factors, and it adds
// e_f * val / sum_g e_g (times x_f[m], dx floats, if GATHER) to its own
// accumulators (dx of them, or one).  Three shuffles sum the warp's 8 lane
// groups.  A row of one segment is written directly; a row of several
// writes each segment's sums to a scratch slot of its own, and a second
// launch (combine) adds a row's slots in slot order into its output row.
// No atomics: two launches on the same inputs give the same bits.  An
// empty row is one empty segment and gets 0.  Rows of k and x are read as
// float4 where r and dx are multiples of 4 and k and x lie on 16-byte
// boundaries (VEC), else one float at a time.  No byte of the dense mask
// is read, nor a row of k or x off the edges, nor q of a row without one,
// so a non-finite value there does not reach the output (a dense product
// gives NaN there, as the plain versions do).  There is no shared tile for
// the tensor cores: each edge is F dots of r against its own k rows, so the
// kernels are CUDA-core float32 and their effort goes into keeping the
// gathers in flight.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace routed {

constexpr int NT = 256;         // threads per block
constexpr int WARPS = NT / 32;  // warps per block, one segment each
constexpr int G = 4;            // lanes an edge
constexpr int E = 32 / G;       // edges a warp works at once
constexpr int MAXF = G;         // one lane a factor
constexpr int MAXR = 128;
constexpr int MAXDX = 16;
constexpr int MAXQS = MAXR + 4;     // the widest stride of a staged q row
constexpr int MAX_COLS = 1 << 24;   // an entry keeps 24 bits of column
constexpr int COMBINE_NT = 256;     // threads per block of combine
constexpr unsigned FULL = 0xffffffffu;

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

// The per-edge body of both kernels, called by every lane of the warp: the
// lane's edge (column m, mask value val; valid false for an idle lane
// group) adds its factor's weight, times x_f[m] if GATHER, to acc.
template <bool VEC, bool GATHER>
__device__ __forceinline__ void edge(const float* qf,
                                     const float* __restrict__ kf,
                                     const float* __restrict__ xf, int r,
                                     int dx, float base, bool fok, int m,
                                     float val, bool valid,
                                     float (&acc)[GATHER ? MAXDX : 1]) {
  constexpr int ACC = GATHER ? MAXDX : 1;
  const bool on = valid && fok;
  const float s = on ? dot<VEC>(qf, kf + (size_t)m * r, r) : 0.f;
  float xv[ACC];
  if constexpr (GATHER) {
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
  } else {
    xv[0] = 1.f;
  }
  const float ex = on ? expf(base + s) : 0.f;
  float den = ex + __shfl_xor_sync(FULL, ex, 1);
  den += __shfl_xor_sync(FULL, den, 2);
  const float w = on ? ex * (val / den) : 0.f;
#pragma unroll
  for (int d = 0; d < ACC; ++d) acc[d] = fmaf(w, xv[d], acc[d]);
}

// The body of both kernels: warp `warp` of the block works segment
// blockIdx.x * WARPS + warp of `segs` (row, first entry, end entry, scratch
// slot or -1 for the output row itself), writing [F, dx] sums (dx = 1 and
// x unused without GATHER) into out [F, N, dx] or scratch [slots, F, dx].
template <bool VEC, bool GATHER>
__device__ __forceinline__ void sweep(const float* __restrict__ q,
                                      const float* __restrict__ k,
                                      const unsigned* __restrict__ entries,
                                      const int4* __restrict__ segs, int S,
                                      const float* __restrict__ x,
                                      float* __restrict__ out,
                                      float* __restrict__ scratch, int F,
                                      int N, int M, int r, int dx, int row0,
                                      int NQ, float base) {
  constexpr int ACC = GATHER ? MAXDX : 1;  // accumulators a lane
  __shared__ __align__(16) float qs[WARPS * MAXF * MAXQS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x * WARPS + warp;
  if (s >= S) return;  // warp-uniform; the block meets at no barrier
  const int4 sg = __ldg(segs + s);
  const int n = sg.x, first = sg.y, end = sg.z;
  const int f = lane % G, g = lane / G;
  const bool fok = f < F;
  const int stride = q_stride(r);
  float* qrow = qs + warp * MAXF * stride;
  if (first < end)  // the warp stages its row's q rows
    for (int e = lane; e < F * r; e += 32) {
      const int ff = e / r, c = e - ff * r;
      qrow[ff * stride + c] = q[((size_t)ff * NQ + row0 + n) * r + c];
    }
  __syncwarp();

  float acc[ACC];
#pragma unroll
  for (int d = 0; d < ACC; ++d) acc[d] = 0.f;
  const float* qf = qrow + f * stride;
  const float* kf = k + (size_t)(fok ? f : 0) * M * r;
  const float* xf = GATHER ? x + (size_t)(fok ? f : 0) * M * dx : nullptr;
  // lane group g works entries first + g, first + g + E, ...; the next
  // step's entry is loaded a step ahead
  unsigned e = first + g < end ? __ldg(entries + first + g) : 0u;
  for (int i = first; i < end; i += E) {  // warp-uniform
    const int j = i + E + g;
    const unsigned next = j < end ? __ldg(entries + j) : 0u;
    edge<VEC, GATHER>(qf, kf, xf, r, dx, base, fok, (int)(e & (MAX_COLS - 1)),
                      (float)(int8_t)(e >> 24), i + g < end, acc);
    e = next;
  }
  // the warp's 8 lane groups: every lane then holds its factor's sums
#pragma unroll
  for (int d = 0; d < ACC; ++d)
#pragma unroll
    for (int off = G; off < 32; off <<= 1)
      acc[d] += __shfl_xor_sync(FULL, acc[d], off);
  if (!fok) return;
  float* dst = sg.w < 0 ? out + ((size_t)f * N + n) * dx
                        : scratch + ((size_t)sg.w * F + f) * dx;
#pragma unroll
  for (int d = 0; d < ACC; ++d)  // lane group g writes d = g, g + E
    if (d % E == g && d < dx) dst[d] = acc[d];
}

// Each split row's output: its slots' sums added in slot order.  splits
// [K, 3]: row, first slot, slots; scratch [slots, F, dx]; out [F, N, dx].
__global__ void __launch_bounds__(COMBINE_NT)
combine_kernel(const float* __restrict__ scratch,
               const int* __restrict__ splits, int K, float* __restrict__ out,
               int F, int N, int dx) {
  const int width = F * dx;
  const long t = (long)blockIdx.x * COMBINE_NT + threadIdx.x;
  if (t >= (long)K * width) return;
  const int i = (int)(t / width), o = (int)(t - (long)i * width);
  const int row = __ldg(splits + 3 * i), slot0 = __ldg(splits + 3 * i + 1),
            slots = __ldg(splits + 3 * i + 2);
  float sum = 0.f;
  for (int j = 0; j < slots; ++j)
    sum += __ldg(scratch + (size_t)(slot0 + j) * width + o);
  const int ff = o / dx, d = o - ff * dx;
  out[((size_t)ff * N + row) * dx + d] = sum;
}

// Launches combine over K split rows (none if K = 0) on `st`.
inline void combine(const float* scratch, const int* splits, int K,
                    float* out, int F, int N, int dx, cudaStream_t st) {
  if (K <= 0) return;
  const long threads = (long)K * F * dx;
  const int blocks = (int)((threads + COMBINE_NT - 1) / COMBINE_NT);
  combine_kernel<<<blocks, COMBINE_NT, 0, st>>>(scratch, splits, K, out, F, N,
                                                dx);
}

inline int blocks_for(int S) { return (S + WARPS - 1) / WARPS; }

// The shapes both kernels take (0 = ok), as cudaError_t.
inline int check_shapes(int F, int N, int M, int r, int dx, int row0, int NQ,
                        int S, int K) {
  return F < 1 || F > MAXF || r < 1 || r > MAXR || dx < 0 || dx > MAXDX ||
                 M < 0 || M >= MAX_COLS || row0 < 0 || N > NQ - row0 ||
                 S < 0 || K < 0
             ? (int)cudaErrorInvalidValue
             : 0;
}

}  // namespace routed
