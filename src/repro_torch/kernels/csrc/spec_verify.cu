// Fused Gumbel-max verify: out[r] = argmax_v(logits[r, v] + eps[r, v]).
//
// Replaces: src/repro/kernels/spec_verify/kernel.py : spec_verify_kernel
// (_verify_kernel), the vocab-tiled running (max, argmax) Pallas kernel.
//
// Bound on the H100: memory. Each call reads 2 * R * V float32 values once
// and does one add and one compare per value, far below the card's
// arithmetic rate, so the least time is 8 * R * V bytes over the memory
// rate. R = B * W is small (16-64 on the serving path) and V is large
// (151,936), so one block per row would leave most of the 132 SMs idle and
// the loads too few to cover the memory latency.
//
// Design: pass 1 splits every row into `nsplit` contiguous vocab chunks,
// one block of 256 threads per (chunk, row), so the grid has a few hundred
// blocks; each thread streams its strided share (16-byte loads where the
// row allows it) keeping a running (value, index) pair. Pass 2 reduces the
// nsplit partials of a row in one warp. Every reduction takes a candidate
// when its value is larger, or equal with a smaller index, so the lowest
// index wins ties across threads, warps and blocks, as the reference's
// strict `>` over vocab tiles and `jnp.argmax` do. The float32 add is the
// same single rounding as the plain version's, so on finite inputs the
// result is bitwise `torch.argmax(logits + eps, -1)`. A row holding NaN
// gets an unspecified but in-range index (the engine quarantines such rows
// through its nonfinite column).
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, v, off);
    int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
spec_verify_partial(const float* __restrict__ logits,
                    const float* __restrict__ eps, float* __restrict__ pv,
                    int* __restrict__ pi, int V, int chunk, int nsplit) {
  const int row = blockIdx.y;
  const int split = blockIdx.x;
  const int lo = split * chunk;
  const int hi = min(V, lo + chunk);
  const float* lr = logits + (size_t)row * V;
  const float* er = eps + (size_t)row * V;
  // (-inf, lo): a row chunk of -inf and NaN reports its first index, so
  // every output stays inside [0, V)
  float bv = -INFINITY;
  int bi = lo;
  if (kVec4) {
    // lo and hi are multiples of 4 here (chunk % 4 == 0, V % 4 == 0)
    for (int j = lo + 4 * threadIdx.x; j < hi; j += 4 * kThreads) {
      const float4 a = *reinterpret_cast<const float4*>(lr + j);
      const float4 b = *reinterpret_cast<const float4*>(er + j);
      const float x0 = a.x + b.x, x1 = a.y + b.y, x2 = a.z + b.z,
                  x3 = a.w + b.w;
      if (x0 > bv) { bv = x0; bi = j; }
      if (x1 > bv) { bv = x1; bi = j + 1; }
      if (x2 > bv) { bv = x2; bi = j + 2; }
      if (x3 > bv) { bv = x3; bi = j + 3; }
    }
  } else {
    for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
      const float x = lr[j] + er[j];
      if (x > bv) { bv = x; bi = j; }
    }
  }
  warp_argmax(bv, bi);
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kThreads / 32 ? sv[lane] : -INFINITY;
    bi = lane < kThreads / 32 ? si[lane] : INT_MAX;
    warp_argmax(bv, bi);
    if (lane == 0) {
      pv[(size_t)row * nsplit + split] = bv;
      pi[(size_t)row * nsplit + split] = bi;
    }
  }
}

__global__ void spec_verify_final(const float* __restrict__ pv,
                                  const int* __restrict__ pi,
                                  int* __restrict__ out, int nsplit) {
  const int row = blockIdx.x;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int s = threadIdx.x; s < nsplit; s += 32) {
    const float v = pv[(size_t)row * nsplit + s];
    const int i = pi[(size_t)row * nsplit + s];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  warp_argmax(bv, bi);
  if (threadIdx.x == 0) out[row] = bi;
}

}  // namespace

extern "C" int spec_verify_launch(const float* logits, const float* eps,
                                  float* pv, int* pi, int* out, int R, int V,
                                  int chunk, int nsplit, int vec4,
                                  cudaStream_t stream) {
  dim3 grid(nsplit, R);
  if (vec4) {
    spec_verify_partial<true><<<grid, kThreads, 0, stream>>>(
        logits, eps, pv, pi, V, chunk, nsplit);
  } else {
    spec_verify_partial<false><<<grid, kThreads, 0, stream>>>(
        logits, eps, pv, pi, V, chunk, nsplit);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  spec_verify_final<<<R, 32, 0, stream>>>(pv, pi, out, nsplit);
  return static_cast<int>(cudaGetLastError());
}
