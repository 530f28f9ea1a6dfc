// Host-side TGCN neighbour-table sampling, the port's copy of the
// ``neighbor_sample`` entry of tagrec_tpu/runtime/native.cpp: one
// std::mt19937_64 stream from the seed, slot lo + rng() % deg, so both
// packages draw the same tables from one seed.  Host only, exposed through
// a C ABI and bound with ctypes (tagrec_tpu_torch/runtime/__init__.py).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 native.cpp -o libtagrec_native.so

#include <cstdint>
#include <random>

extern "C" {

// For each row of a CSR adjacency, draw k neighbours with replacement
// (ids + 1; a row without neighbours stays all zero, the pad row) and
// their integer weights.
void neighbor_sample(const int64_t* indptr, const int64_t* cols,
                     const float* vals, int64_t n_rows, int64_t k,
                     uint64_t seed, int32_t* out_idx, int32_t* out_w) {
  std::mt19937_64 rng(seed);
  for (int64_t r = 0; r < n_rows; r++) {
    int64_t lo = indptr[r], hi = indptr[r + 1];
    int64_t deg = hi - lo;
    if (deg == 0) continue;  // leave zeros
    for (int64_t j = 0; j < k; j++) {
      int64_t e = lo + (int64_t)(rng() % (uint64_t)deg);
      out_idx[r * k + j] = (int32_t)(cols[e] + 1);
      out_w[r * k + j] = (int32_t)vals[e];
    }
  }
}

}  // extern "C"
