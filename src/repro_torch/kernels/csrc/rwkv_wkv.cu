// RWKV-6 WKV recurrence, from a zero or a given initial state.
//
// Replaces: src/repro/kernels/rwkv_wkv/kernel.py : rwkv_wkv_kernel
// (_wkv_kernel), and the model's scan RWKV6TimeMix._wkv_scan
// (src/repro/models/ssm.py) that the verify window runs.
//
// Computes, for each sequence b and head h, over t = 0 .. T-1:
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
// on the model's layout: r, k, v, w (B, T, H, hd), u (H, hd), S (hd, hd)
// with rows i over the key width and columns j over the value width.
// Three forms, chosen by `mode`:
//   0  the TPU kernel's: zero initial state, y only;
//   1  the verify window's: initial state s0 (B, H, hd, hd), y and the
//      state after every position, s_out (B, T, H, hd, hd);
//   2  prefill's: initial state s0 (or zero), y and only the state after
//      the last position, s_out (B, H, hd, hd).
// r, k, v, w, u and y are in the model's dtype; the state is float32 in
// and out and inside, so a sequence split over launches gives what one
// launch over it gives (rounded to bf16 between launches the state would
// lose the decay: 1 - w is near 2^-9, below half a bf16 ulp of S).
//
// Bound on the H100: at the serving shapes, bytes. Form 1 at B = 2, W = 8,
// H = 64, hd = 64 must write 8 per-position float32 states of 2 MB each
// (16.8 of its 18.5 MB); form 2 at a 64-token chunk reads 4 x 64 x 4096
// inputs and one state. Form 0 at T = 1024 and B = 1 is a chain of 1024
// dependent steps on 64 heads: the chain, not the 42 MB it moves, sets
// its time (7 hd^2 flops a step per head are far below the card's rate).
//
// Design (simple first): one block of hd threads per (head, sequence).
// Thread j keeps column j of S in hd float32 registers, so a step needs
// no exchange between threads: y_j = sum_i r_i (S_ij + u_i k_i v_j) and
// S_ij <- w_i S_ij + k_i v_j. The r, k, v, w rows of kChunk steps are
// staged into shared memory as float32 by one coalesced pass (thread j
// loads element j of every row), so the chunk's steps run with no global
// load and no barrier between them. The TPU kernel pads T to its chunk
// with w = 1; here the last chunk is short and positions past T are never
// read or written. The per-position state stores of form 1 are coalesced:
// thread j writes column j, so a warp's stores of one row i are adjacent.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;         // time steps staged per shared-memory load

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

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
rwkv_wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const T* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ y, float* __restrict__ s_out, int T_len,
                int H, int mode) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  __shared__ __align__(16) float r_s[kChunk][HD];
  __shared__ __align__(16) float k_s[kChunk][HD];
  __shared__ __align__(16) float w_s[kChunk][HD];
  __shared__ float v_s[kChunk][HD];
  __shared__ __align__(16) float u_s[HD];

  constexpr int HD2 = HD * HD;
  float S[HD];
  if (s0 != nullptr) {
    const float* sb = s0 + ((size_t)b * H + h) * HD2;
#pragma unroll
    for (int i = 0; i < HD; ++i) S[i] = sb[i * HD + j];
  } else {
#pragma unroll
    for (int i = 0; i < HD; ++i) S[i] = 0.f;
  }
  u_s[j] = to_f(u[h * HD + j]);

  const size_t row = (size_t)H * HD;               // stride of t
  const size_t base = (size_t)b * T_len * row + (size_t)h * HD;
  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int n = min(kChunk, T_len - t0);
    __syncthreads();                 // the previous chunk is consumed
    for (int c = 0; c < n; ++c) {
      const size_t off = base + (size_t)(t0 + c) * row + j;
      r_s[c][j] = to_f(r[off]);
      k_s[c][j] = to_f(k[off]);
      v_s[c][j] = to_f(v[off]);
      w_s[c][j] = to_f(w[off]);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = v_s[c][j];
      const float4* r4 = reinterpret_cast<const float4*>(r_s[c]);
      const float4* k4 = reinterpret_cast<const float4*>(k_s[c]);
      const float4* w4 = reinterpret_cast<const float4*>(w_s[c]);
      const float4* u4 = reinterpret_cast<const float4*>(u_s);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < HD / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
        const int i = 4 * q;
        float kv = kq.x * vj;
        a0 += rq.x * (S[i] + uq.x * kv);
        S[i] = wq.x * S[i] + kv;
        kv = kq.y * vj;
        a1 += rq.y * (S[i + 1] + uq.y * kv);
        S[i + 1] = wq.y * S[i + 1] + kv;
        kv = kq.z * vj;
        a2 += rq.z * (S[i + 2] + uq.z * kv);
        S[i + 2] = wq.z * S[i + 2] + kv;
        kv = kq.w * vj;
        a3 += rq.w * (S[i + 3] + uq.w * kv);
        S[i + 3] = wq.w * S[i + 3] + kv;
      }
      const int t = t0 + c;
      y[base + (size_t)t * row + j] = from_f<T>((a0 + a1) + (a2 + a3));
      if (mode == 1) {
        float* so = s_out + (((size_t)b * T_len + t) * H + h) * HD2;
#pragma unroll
        for (int i = 0; i < HD; ++i) so[i * HD + j] = S[i];
      }
    }
  }
  if (mode == 2) {
    float* so = s_out + ((size_t)b * H + h) * HD2;
#pragma unroll
    for (int i = 0; i < HD; ++i) so[i * HD + j] = S[i];
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int B,
           int T_len, int H, int mode, cudaStream_t stream) {
  dim3 grid(H, B);
  rwkv_wkv_kernel<T, HD><<<grid, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), T_len, H, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of r, k, v, w, u, y): 0 = float32, 1 = bfloat16; s0 and s_out are
// float32. hd must be 32 or 64. mode 0 writes no state; modes 1 and 2 want
// s_out. s0 may be null (zeros).
extern "C" int rwkv_wkv_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               void* y, void* s_out, int B, int T_len, int H,
                               int hd, int mode, int dtype,
                               cudaStream_t stream) {
  if (T_len < 1 || mode < 0 || mode > 2 || (mode != 0 && s_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(r, k, v, w, u, s0, y, s_out, B, T_len, H, mode,
                             stream);
  if (dtype == 0 && hd == 32)
    return launch<float, 32>(r, k, v, w, u, s0, y, s_out, B, T_len, H, mode,
                             stream);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(r, k, v, w, u, s0, y, s_out, B, T_len,
                                     H, mode, stream);
  if (dtype == 1 && hd == 32)
    return launch<__nv_bfloat16, 32>(r, k, v, w, u, s0, y, s_out, B, T_len,
                                     H, mode, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
