// Split-key flash-decode, the part shared by the decode kernels: each CTA
// of a group (one row tile of one kv head of one sequence) attends one
// chunk of the group's keys and leaves a partial (m, l, acc) of its rows in
// a float32 workspace; the last CTA of the group to finish merges the
// partials and writes the output, so a call is one launch.
//
// Workspace, per group g and split s: kRows (m, l) pairs at
// ml[(g * n_splits + s) * kRows + r] and kRows x D accumulators at
// acc[((g * n_splits + s) * kRows + r) * D + c]. A split whose chunk held no
// visible key of row r leaves l = 0 there (and m = -inf when the whole
// chunk was empty); the merge weighs only the partials with l > 0, so it
// never forms exp(-inf - (-inf)), and a row no split saw comes out 0, as
// the reference's acc / max(l, 1e-30).
//
// Tickets: ``counters`` holds one unsigned per group, zero between calls.
// Each CTA fences its partial and takes a ticket; the CTA that draws
// n_splits - 1 is the last, resets the counter to 0 (every CTA of its group
// has drawn by then) and merges. The reset keeps the counters valid for the
// next call and inside captured CUDA graphs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>

namespace split_merge {

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The rows of a tile in a (B, W, H, D) tensor: tile row r is row r0 + r =
// w * G + g of kv head h, query head h * G + g at position w of sequence b.
struct Rows {
  int b, W, H, h, G, r0;
  // offset of tile row r, in units of D elements
  __device__ __forceinline__ size_t at(int r) const {
    const int w = (r0 + r) / G, g = (r0 + r) % G;
    return ((size_t)b * W + w) * H + (size_t)h * G + g;
  }
};

// true in every thread of the CTA that finished its group last
__device__ __forceinline__ bool last_of_group(unsigned* counters, int group,
                                              int n_splits) {
  __shared__ bool s_last;
  __threadfence();                 // this CTA's partial, visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned ticket = atomicAdd(&counters[group], 1u);
    s_last = ticket == static_cast<unsigned>(n_splits - 1);
    if (s_last) counters[group] = 0;
  }
  __syncthreads();
  const bool last = s_last;
  if (last) __threadfence();       // the partials are read after the ticket
  return last;
}

// Merges the n_splits partials of the first ``n_rows`` rows of group
// ``group`` into out (rows placed by ``rows``), in out's type. ``scratch``
// is shared memory for 2 * (n_splits + 1) * kRows floats. All (m, l) of
// the group are read at once into shared memory; each row's weights
// exp(m_s - m) (0 where l_s = 0) and 1 / sum_s w_s l_s follow there; then
// each thread sums its kRows * D / kThreads outputs over the splits, the
// loads of eight splits in flight together.
template <int D, int kRows, int kThreads, typename T>
__device__ __forceinline__ void merge(const float* acc, const float2* ml,
                                      int group, int n_splits, int n_rows,
                                      const Rows& rows, T* out,
                                      float* scratch) {
  constexpr int kPer = kRows * D / kThreads;   // outputs per thread
  static_assert(kPer * kThreads == kRows * D, "rows x D over the threads");
  const size_t base = (size_t)group * n_splits;
  float* sm = scratch;                          // [n_splits][kRows] m
  float* sw = sm + n_splits * kRows;            // [n_splits][kRows] l, w
  float* sinv = sw + n_splits * kRows;          // [kRows] 1 / L
  for (int i = threadIdx.x; i < n_splits * kRows; i += kThreads) {
    const float2 p = __ldcg(&ml[base * kRows + i]);
    sm[i] = p.x;
    sw[i] = p.y;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    float m = -INFINITY;
    for (int s = 0; s < n_splits; ++s)
      if (sw[s * kRows + r] > 0.f) m = fmaxf(m, sm[s * kRows + r]);
    float l = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float ls = sw[s * kRows + r];
      const float w = r < n_rows && ls > 0.f ? expf(sm[s * kRows + r] - m)
                                             : 0.f;
      l += w * ls;
      sw[s * kRows + r] = w;
    }
    sinv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  float o[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) o[k] = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads, r = i / D, c = i % D;
      const float w = sw[s * kRows + r];
      const float a =
          w > 0.f ? __ldcg(&acc[((base + s) * kRows + r) * D + c]) : 0.f;
      o[k] = fmaf(w, a, o[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads, r = i / D, c = i % D;
    if (r < n_rows) out[rows.at(r) * D + c] = from_f<T>(o[k] * sinv[r]);
  }
}

}  // namespace split_merge
