// Dense flash-decode for grouped-query attention: W window queries against
// a dense per-sequence KV cache.
//
// Replaces: src/repro/kernels/decode_attention/kernel.py :
// decode_attention_kernel (_decode_kernel).
//
// Computes, for each sequence b and kv head h, the attention of the W*G
// grouped query rows (row r = w*G + g, query head h*G + g at position
// lengths[b] + w) over the dense cache k, v (B, S, KV, d), read in place
// at kv head h (the reference repeats the cache G times first). Masks:
// causal k_pos <= q_pos, k_pos < S (the ragged tail of the cache is never
// read) and, with window > 0, k_pos > q_pos - window. The window's own K/V
// rows are already written into the cache by the caller, as in the
// reference.
//
// Bound on the H100: memory at the verify shapes. Per (b, h) a call must
// read the visible K and V rows once (2 * visible * d elements) and the
// query rows, and write the output; the arithmetic (4 * G * W * visible
// * d flops) is a small fraction of the card's rate even in float32.
//
// Design (simple first): the paged decode kernel (paged_decode.cu) without
// block tables or the fused writeback. One block per (tile of kRows query
// rows, kv head, sequence): W is not small here (the solo sampler prefills
// the whole prompt through one call, W up to 255, where the TPU kernel held
// W <= 16 queries in one block), so the rows are tiled; rows are w-major,
// so a tile holds neighbouring positions and the causal bound of its last
// row ends its key loop. Keys are taken 16 at a time into shared memory as
// float32, then the scores of the tile's rows, an online-softmax update of
// the running max and sum per row, and the rescaled accumulation of p @ V.
// The query rows, accumulator and softmax state stay in shared memory in
// float32 for the whole sweep.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 16;          // keys per shared-memory tile
constexpr int kRows = 16;          // query rows per block
constexpr float kNeg = -1.0e30f;   // running-max start, as the reference

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int window) {
  return kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

template <int D>
constexpr size_t smem_floats() {
  return 2 * (size_t)kRows * D + kKeys * (D + 1) + kKeys * D +
         (size_t)kRows * kKeys + 3 * (size_t)kRows;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int KV, int R, int G, int S, int window,
                        float scale) {
  const int r0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int nr = min(kRows, R - r0);
  extern __shared__ float smem[];
  float* q_s = smem;                       // kRows x D query rows
  float* acc_s = q_s + kRows * D;          // kRows x D running p @ V
  float* k_s = acc_s + kRows * D;          // kKeys x (D + 1), padded
  float* v_s = k_s + kKeys * (D + 1);      // kKeys x D
  float* p_s = v_s + kKeys * D;            // kRows x kKeys scores, then p
  float* m_s = p_s + kRows * kKeys;        // kRows running max
  float* l_s = m_s + kRows;                // kRows running sum
  float* a_s = l_s + kRows;                // kRows rescale of this tile

  const int base = lengths[b];
  const T* qb = q + (((size_t)b * KV + h) * R + r0) * D;
  for (int i = tid; i < kRows * D; i += kThreads) {
    q_s[i] = i < nr * D ? to_f(qb[i]) : 0.f;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  // the keys some row of this tile sees: [first_vis, last_pos]
  const int last_pos = min(base + (r0 + nr - 1) / G, S - 1);
  const int first_vis = window > 0 ? max(0, base + r0 / G - window + 1) : 0;
  const size_t kv_row = (size_t)KV * D;              // stride of a position
  const T* kb = k + (size_t)b * S * kv_row + (size_t)h * D;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)h * D;
  __syncthreads();

  for (int k0 = (first_vis / kKeys) * kKeys; k0 <= last_pos; k0 += kKeys) {
    const int nk = min(kKeys, S - k0);
    for (int i = tid; i < nk * D; i += kThreads) {
      const int t = i / D, c = i % D;
      const size_t off = (size_t)(k0 + t) * kv_row + c;
      k_s[t * (D + 1) + c] = to_f(kb[off]);
      v_s[t * D + c] = to_f(vb[off]);
    }
    __syncthreads();
    // scores of the tile's rows against the 16 keys
    for (int i = tid; i < kRows * kKeys; i += kThreads) {
      const int r = i / kKeys, t = i % kKeys;
      const int qpos = base + (r0 + r) / G;
      float sc = kNeg;
      if (r < nr && t < nk && visible(k0 + t, qpos, window)) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + t * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) dot += qr[c] * kr[c];
        sc = dot * scale;
      }
      p_s[i] = sc;
    }
    __syncthreads();
    // online softmax: new running max, rescale factor, probabilities
    for (int r = tid; r < kRows; r += kThreads) {
      const int qpos = base + (r0 + r) / G;
      float* pr = p_s + r * kKeys;
      float mc = kNeg;
      for (int t = 0; t < nk; ++t)
        if (visible(k0 + t, qpos, window)) mc = fmaxf(mc, pr[t]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mc);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < kKeys; ++t) {
        const bool vis = r < nr && t < nk && visible(k0 + t, qpos, window);
        const float p = vis ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const float* pr = p_s + r * kKeys;
      float a = acc_s[i] * a_s[r];
      for (int t = 0; t < nk; ++t) a += pr[t] * v_s[t * D + c];
      acc_s[i] = a;
    }
    __syncthreads();
  }
  T* ob = out + (((size_t)b * KV + h) * R + r0) * D;
  for (int i = tid; i < nr * D; i += kThreads) {
    const int r = i / D;
    ob[i] = from_f<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int KV, int R, int G, int S, int window,
           float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  auto kern = decode_attention_kernel<T, D>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  dim3 grid((R + kRows - 1) / kRows, KV, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), KV, R, G, S,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D must be 64 or 128. q and out are
// (B, KV, R = W * G, D), rows w-major; k and v (B, S, KV, D).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       void* out, int B, int KV, int R,
                                       int G, int D, int S, int window,
                                       float scale, int dtype,
                                       cudaStream_t stream) {
  if (R < 1 || G < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, lengths, out, B, KV, R, G, S, window,
                             scale, stream);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, lengths, out, B, KV, R, G, S, window,
                              scale, stream);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, lengths, out, B, KV, R, G, S,
                                     window, scale, stream);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, lengths, out, B, KV, R, G, S,
                                      window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
