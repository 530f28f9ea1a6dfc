// Row-streamed edge sweep over a dense [N, M] byte mask, shared by
// routed_mm.cu, routed_rowsum.cu, dot_flash_apply.cu, dot_flash_bwd_row.cu
// and dot_flash_bwd_col.cu (which sweeps the mask's transpose).
//
// The functions are sparse: their callers' masks are 0.4-1.5% dense, and
// every term they sum is known per edge without a pass over the row.  So a
// kernel reads the mask once, row by row, turns each chunk of bytes into a
// short list of edges, and works only those.  What bounds it is bytes: the
// mask stream from device memory (what the functions' bound counts) and the
// gathered rows of k and x per edge, which sit in the 50 MB L2.
//
// Layout: a block of WARPS = 8 warps owns 8 / wpr rows, wpr warps a row
// (warps_per_row: about one warp per 2 KB of row, at most 8).  Warp `part`
// of a row streams the row's 512-byte chunks part, part + wpr, ...: each
// lane copies one 16-byte word of a chunk into the warp's ring of STAGES
// shared-memory slots with cp.async, STAGES - 1 chunks ahead of the one
// being worked, so the stream stays in flight while edges are worked.  The
// copies carry an L2 evict-first policy: the mask passes through once and
// must not push k and x out of the L2.  A lane reads back only the word it
// copied, so the ring needs no barrier.  Rows need not start on a 16-byte
// boundary (DGCF's are 15,000 bytes): the bytes before the first and after
// the last aligned word (fewer than 16 each, or the whole of a row shorter
// than 32 bytes) are read one per lane by the row's first warp.
//
// Edges: each lane turns its 16 bytes into a 16-bit set of edge bytes
// (nonzero, or positive as int8); a warp-wide prefix sum of their counts
// gives each lane its place in the warp's edge queue in shared memory, one
// 32-bit entry an edge (column | byte << 24).  Whenever the queue holds E = 8
// edges the warp works them at once, G = 4 lanes an edge: the caller's
// functor fn(col, val, valid) is called by every lane, lane group g = lane /
// G getting the queue's edge g.  Edges left over (fewer than 8) wait for the
// next chunk, so a sparse row still fills the warp's steps; the row's last
// step may hold fewer, and its idle lane groups get valid = false.  Columns
// outside the edges are never read: a non-finite value of k or x there does
// not reach the row, where a dense sweep would carry it through 0 * NaN.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mask_rows {

constexpr int NT = 256;          // threads per block
constexpr int WARPS = NT / 32;   // warps per block
constexpr int STAGES = 3;        // ring slots per warp, one chunk each
constexpr int G = 4;             // lanes an edge
constexpr int E = 32 / G;        // edges a warp works at once
constexpr int QUEUE = 32 * 16 + E - 1;  // a chunk's edges and the carried ones
constexpr int MAX_COLS = 1 << 24;       // an entry keeps 24 bits of column
constexpr int WARP_ROW_BYTES = 2048;  // row bytes per warp, before the cap
constexpr unsigned FULL = 0xffffffffu;

// One warp's shared memory: its ring of mask chunks and its edge queue.
struct Warp {
  uint4 ring[STAGES * 32];
  unsigned queue[QUEUE];
};

// Warps per row: the least power of two w <= WARPS with w * 2 KB >= M.
inline int warps_per_row(int M) {
  int w = 1;
  while (w < WARPS && w * WARP_ROW_BYTES < M) w *= 2;
  return w;
}

inline int blocks_for(int N, int wpr) {
  const int rows = WARPS / wpr;
  return (N + rows - 1) / rows;
}

// An L2 policy that evicts the streamed mask first.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           uint64_t pol) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(dst),
      "l"(gmem), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// 4 bits, one per byte of w: the edge bytes (nonzero, or > 0 as int8 if POS).
template <bool POS>
__device__ __forceinline__ unsigned edge_bits4(unsigned w) {
  const unsigned m = POS ? __vcmpgts4(w, 0u) : __vcmpne4(w, 0u);
  return ((m >> 7) & 1u) | ((m >> 14) & 2u) | ((m >> 21) & 4u) |
         ((m >> 28) & 8u);
}

template <bool POS>
__device__ __forceinline__ unsigned edge_bits(const uint4 v) {
  return edge_bits4<POS>(v.x) | edge_bits4<POS>(v.y) << 4 |
         edge_bits4<POS>(v.z) << 8 | edge_bits4<POS>(v.w) << 12;
}

// Byte b (0..15) of v.
__device__ __forceinline__ unsigned byte_of(const uint4 v, int b) {
  const unsigned w = (b & 8) ? ((b & 4) ? v.w : v.z) : ((b & 4) ? v.y : v.x);
  return (w >> ((b & 3) * 8)) & 0xffu;
}

// A warp's queue of edges, worked E at a time by fn (see the note above).
template <class Fn>
struct Queue {
  unsigned* q;
  Fn& fn;
  int have = 0;  // edges waiting, at q[0 .. have)

  __device__ __forceinline__ Queue(unsigned* queue, Fn& f) : q(queue), fn(f) {}

  // Lane group g works edge q[i + g] if g < n.
  __device__ __forceinline__ void work(int i, int n) {
    const int g = (threadIdx.x & 31) / G;
    const unsigned e = g < n ? q[i + g] : 0u;
    fn((int)(e & (MAX_COLS - 1)), (float)(int8_t)(e >> 24), g < n);
  }

  // Queues this lane's edges (the `bits` of the 16 bytes v at columns
  // c0 .. c0 + 15), then works every full step of E.
  __device__ __forceinline__ void add(unsigned bits, const uint4 v, int c0) {
    const int lane = threadIdx.x & 31;
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    if (total == 0) return;
    int pos = have + incl - cnt;
    while (bits) {
      const int b = __ffs(bits) - 1;
      q[pos++] = (unsigned)(c0 + b) | byte_of(v, b) << 24;
      bits &= bits - 1;
    }
    __syncwarp();
    have += total;
    int i = 0;
    for (; i + E <= have; i += E) work(i, E);
    if (i > 0) {  // move the rest (fewer than E) to the front
      const int rest = have - i;
      const unsigned e = lane < rest ? q[i + lane] : 0u;
      __syncwarp();
      if (lane < rest) q[lane] = e;
      __syncwarp();
      have = rest;
    }
  }

  __device__ __forceinline__ void flush() {
    if (have) work(0, have);
    have = 0;
  }
};

// Hands warp `part` of `wpr`'s share of one mask row (M bytes at `mrow`,
// M < MAX_COLS) to fn, E edges at a time, through the warp's shared memory
// `ws`.  Warp-uniform: every lane of the warp calls it.
template <bool POS, class Fn>
__device__ __forceinline__ void sweep_row(const int8_t* __restrict__ mrow,
                                          int M, int part, int wpr,
                                          Warp& ws, Fn& fn) {
  const int lane = threadIdx.x & 31;
  uint4* ring = ws.ring;
  const uint64_t pol = evict_first_policy();
  Queue<Fn> queue(ws.queue, fn);
  const uintptr_t rs = (uintptr_t)mrow, re = rs + (uintptr_t)M;
  uintptr_t a0 = re, a1 = re;  // the aligned body [a0, a1)
  if (M >= 32) {
    a0 = (rs + 15) & ~(uintptr_t)15;
    a1 = re & ~(uintptr_t)15;
  }
  if (part == 0) {  // head [rs, a0) and tail [a1, re), one byte a lane
    const int hl = (int)(a0 - rs), tl = (int)(re - a1);
    const int off = lane < hl ? lane
                    : lane - hl < tl ? (int)(a1 - rs) + lane - hl
                                     : -1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (off >= 0) v.x = (unsigned char)mrow[off];
    queue.add(edge_bits<POS>(v) & 1u, v, off);
  }
  const uint4* body = (const uint4*)a0;
  const int nw = (int)((a1 - a0) >> 4);        // aligned words
  const int nc = (nw + 31) >> 5;               // chunks of 32 words
  const int mine = nc > part ? (nc - part + wpr - 1) / wpr : 0;
  // chunk j of this warp is chunk part + j * wpr of the row, in slot j % S
  auto issue = [&](int j) {
    const int w = (part + j * wpr) * 32 + lane;
    if (j < mine && w < nw) cp_async16(ring + (j % STAGES) * 32 + lane,
                                       body + w, pol);
    cp_async_commit();  // an empty group keeps the count uniform
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) issue(j);
  for (int j = 0; j < mine; ++j) {
    issue(j + STAGES - 1);        // into the slot read at j - 1
    cp_async_wait<STAGES - 1>();  // chunk j has landed
    const int w = (part + j * wpr) * 32 + lane;
    const uint4 v = w < nw ? ring[(j % STAGES) * 32 + lane]
                           : make_uint4(0u, 0u, 0u, 0u);
    queue.add(edge_bits<POS>(v), v, (int)(a0 - rs) + 16 * w);
  }
  queue.flush();
}

}  // namespace mask_rows
