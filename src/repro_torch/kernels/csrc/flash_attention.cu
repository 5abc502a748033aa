// Causal flash attention (optional sliding window) over whole sequences,
// the forward of the training path.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py :
// flash_attention_kernel (_flash_kernel).
//
// Computes, for each sequence b, query head h and position i < T,
//   o[b, i, h] = sum_j p_ij v[b, j, h / G],  p = softmax_j(s_ij),
//   s_ij = (q[b, i, h] . k[b, j, h / G]) * scale,
// over the keys j <= i (and j > i - window when window > 0), with the
// scores and the online softmax in float32, masked probabilities exactly 0,
// and the output rounded once to q's dtype. It also writes each row's
// log-sum-exp lse[b, h, i] = m_i + log(l_i) in float32: the residual the
// gradient needs. G = H / KV query heads share one kv head, read in place
// (the reference expands K and V with jnp.repeat first); head h reads kv
// head h / G, the head order of the reference's _sdpa.
//
// Bound on the H100: operations. At qwen3-1.7b's training shape (B = 2,
// T = 2048, 16 query heads of width 128) the causal work is 34.4 GFLOP
// against ~50 MB of q, k, v, o and lse: about 35 us at the bf16 tensor-core
// rate, 15 us at the memory rate. This kernel runs its products on the
// CUDA cores in float32 (67 TFLOP/s peak), so 0.51 ms is its own floor;
// tensor cores (mma / wgmma), TMA and warp specialisation are the later
// redesign.
//
// Design (simple first): one CTA of 256 threads per (64-row query tile,
// query head, sequence); the reference's sequential grid axis over key
// tiles becomes a loop inside the CTA, from the first tile the sliding
// window can reach to the tile holding the last query row, so tiles wholly
// above the diagonal or below the window are never visited. The CTAs of
// the longest rows are issued first. Per 64-key tile: K and V are staged in
// shared memory as float32; each thread computes a 4 x 4 block of the
// 64 x 64 scores (rows ty + 16i, keys tx + 16j, so a warp reads conflict-
// free rows of the padded tiles); four threads per row update its running
// max and sum and turn the scores into probabilities; each thread then
// rescales and accumulates 4 rows x 8 columns of p @ V in registers. The
// ragged tail (T not a multiple of 64) is handled in the kernel: rows and
// keys past T are staged as zeros, masked, and never written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kD = 128;            // head width, compiled in
constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // keys per shared-memory tile
constexpr int kThreads = 256;
constexpr int kQP = kD + 1;        // padded row of the Q and K tiles
constexpr int kPP = kBK + 1;       // padded row of the score tile
constexpr float kNeg = -1.0e30f;   // running-max start, as the reference

constexpr size_t kSmemFloats =
    (size_t)kBQ * kQP + (size_t)kBK * kQP + (size_t)kBK * kD +
    (size_t)kBQ * kPP + 3 * kBQ;

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

__device__ __forceinline__ bool visible(int kpos, int qpos, int T,
                                        int window) {
  return kpos <= qpos && kpos < T && (window <= 0 || kpos > qpos - window);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int Tn, int H, int KV,
                       int window, float scale) {
  // the last query tile (the most keys) first
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = tile * kBQ;

  extern __shared__ float smem[];
  float* q_s = smem;                          // kBQ x kQP
  float* k_s = q_s + (size_t)kBQ * kQP;       // kBK x kQP
  float* v_s = k_s + (size_t)kBK * kQP;       // kBK x kD
  float* p_s = v_s + (size_t)kBK * kD;        // kBQ x kPP scores, then p
  float* m_s = p_s + (size_t)kBQ * kPP;       // running max per row
  float* l_s = m_s + kBQ;                     // running sum per row
  float* a_s = l_s + kBQ;                     // this tile's rescale factor

  const size_t q_stride = (size_t)H * kD;     // between positions
  const size_t kv_stride = (size_t)KV * kD;
  const T* qb = q + ((size_t)b * Tn * H + h) * kD;
  const T* kb = k + ((size_t)b * Tn * KV + hk) * kD;
  const T* vb = v + ((size_t)b * Tn * KV + hk) * kD;

  for (int i = tid; i < kBQ * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    const int pos = q0 + r;
    q_s[r * kQP + c] = pos < Tn ? to_f(qb[pos * q_stride + c]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + kBQ - 1, Tn - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_lo = k_first / kBK;
  const int kt_hi = q_last / kBK;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();      // the previous tile's k_s, v_s, p_s are consumed
    for (int i = tid; i < kBK * kD; i += kThreads) {
      const int r = i / kD, c = i % kD;
      const int pos = k0 + r;
      const bool in = pos < Tn;
      k_s[r * kQP + c] = in ? to_f(kb[pos * kv_stride + c]) : 0.f;
      v_s[r * kD + c] = in ? to_f(vb[pos * kv_stride + c]) : 0.f;
    }
    __syncthreads();
    // scores of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < kD; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * kQP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = k_s[(tx + 16 * j) * kQP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(ty + 16 * i) * kPP + tx + 16 * j] = s[i][j] * scale;
    __syncthreads();
    // online softmax: four threads per row, 16 keys each
    {
      const int r = tid / 4, part = tid % 4;
      const int qpos = q0 + r;
      float* pr = p_s + r * kPP;
      float mc = kNeg;
      for (int t = part; t < kBK; t += 4)
        if (visible(k0 + t, qpos, Tn, window)) mc = fmaxf(mc, pr[t]);
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mc);
      float sum = 0.f;
      for (int t = part; t < kBK; t += 4) {
        const float p =
            visible(k0 + t, qpos, Tn, window) ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p @ V, rows ty + 16i, columns tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kPP + t];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = v_s[t * kD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  // l_s and m_s were last written before the final __syncthreads
  T* ob = o + ((size_t)b * Tn * H + h) * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int pos = q0 + r;
    if (pos >= Tn) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      ob[pos * q_stride + tx + 16 * j] = from_f<T>(acc[i][j] * inv_l);
  }
  if (tid < kBQ && q0 + tid < Tn)
    lse[((size_t)b * H + h) * Tn + q0 + tid] =
        m_s[tid] + logf(l_s[tid]);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Tn, int H, int KV, int window, float scale,
           cudaStream_t stream) {
  const size_t bytes = kSmemFloats * sizeof(float);
  auto kern = flash_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  dim3 grid((Tn + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Tn, H, KV, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, T, H, D); k, v: (B, T, KV, D); lse: (B, H, T) float32; all
// contiguous. dtype: 0 = float32, 1 = bfloat16. D must be 128 and H a
// multiple of KV.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int Tn, int H, int KV, int D,
                                      int window, float scale, int dtype,
                                      cudaStream_t stream) {
  if (D != kD || KV <= 0 || H % KV != 0 || Tn <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, o, lse, B, Tn, H, KV, window, scale,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, B, Tn, H, KV, window,
                                 scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
