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
// Bound on the H100: at the serving shapes, bytes; in practice the step
// arithmetic. Form 1 at B = 2, W = 8, H = 64, hd = 64 must write 8
// per-position float32 states of 2 MB each (16.8 of its 19.5 MB); form 2
// at a 64-token chunk reads 4 x 64 x 4096 inputs and one state and writes
// one (4.7 MB, 1.4 us); form 0 at T = 1024 and B = 1 moves 42 MB
// (12.5 us). Every step is 4 instructions per state element (k v,
// u k v + S, r times it into y, w S + k v), 64 x 4096 elements at
// rwkv6-7b's width, none waiting on another element's: the chain that
// bounds the time is one element's, 1 fused multiply-add a step.
//
// Forms 0 and 2 (prefill, training's zero state): the state is spread
// over the card. The columns of S are independent (column j needs only
// v_j), so a head's 64 columns go to two CTAs of 32 (grid (hd / 32, H,
// B): 128 CTAs at B = 1); within a CTA, warp g owns rows 8 g .. 8 g + 7 and
// lane c column c, so a thread keeps 8 elements of S in registers and a
// step is 8 independent updates with the same S <- w S + k v fused
// multiply-add per element as the single-thread-per-column design it
// replaces (S is bitwise the same where the compiler keeps the FMA). Each
// thread's 8-row partial of y_t goes to shared memory; y never feeds S, so
// the sums over the warps are taken once per 16-step chunk, off the step
// chain, and y is written coalesced. The chunk's r, k, w (all rows) and v
// (the CTA's columns) are copied one chunk ahead by 16-byte cp.async,
// each thread its own words, while the current chunk's steps run; after
// the steps each thread waits for its own copies and converts them to
// float32 into the other of two shared chunk buffers, so a chunk needs
// one barrier (a converting pass over all the words would need two more).
// Every load of a step is then a warp-wide broadcast (r, k, w of the
// warp's rows) or 32 consecutive words (v). The TPU kernel pads T to its
// chunk with w = 1; here the last chunk is short and positions past T are
// never read or written.
//
// Form 1 (verify): one block of hd threads per (head, sequence); thread j
// keeps column j of S in hd float32 registers and writes it after every
// position (a warp's stores of one row i adjacent); the r, k, v, w rows of
// 32 steps are staged as float32 by one pass. Its 16.8 MB of state stores
// keep it within 20% of its byte bound, so it stays as it was.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "flash_decode.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// Forms 0 and 2: the state spread over warps (rows) and CTAs (columns)
// ---------------------------------------------------------------------------
namespace spread {

constexpr int kSteps = 16;         // time steps a chunk
constexpr int kCols = 32;          // state columns per CTA, one per lane
constexpr int kRowsPer = 8;        // state rows per warp

template <typename T, int HD>
struct Layout {
  static constexpr int kWarps = HD / kRowsPer;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStep = 3 * HD + kCols;   // r, k, w rows, v columns
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kRowWords = HD / kVec;    // 16-byte words of a row
  static constexpr int kStepWords = 3 * kRowWords + kCols / kVec;
  // 16-byte words of a chunk each thread copies
  static constexpr int kLoads =
      (kSteps * kStepWords + kThreads - 1) / kThreads;
  static constexpr int kCvFloats = kSteps * kStep;            // a chunk
  static constexpr int kYpFloats = kWarps * kSteps * kCols;   // its y parts
  static constexpr size_t kRawBytes = (size_t)kThreads * kLoads * 16;
  static constexpr size_t kSmem =
      kRawBytes + 2 * (size_t)(kCvFloats + kYpFloats) * 4;
};

// A chunk's 16-byte words, word i of steps t0 .. t0 + n - 1 step-major in
// the order r, k, w (all rows of head h), v (columns col0 ..), for
// i = threadIdx.x + j * blockDim.x: ``load`` starts their cp.async into
// slot i of ``raw``, the thread's own; ``store`` waits for them and writes
// them as float32 into a chunk buffer, at the same element offsets. A
// thread reads back only the words it copied itself, so no barrier is
// needed between the two.
template <typename T, int HD>
struct Chunk {
  using L = Layout<T, HD>;
  uint8_t* raw;

  __device__ __forceinline__ void load(
      const T* __restrict__ r, const T* __restrict__ k,
      const T* __restrict__ w, const T* __restrict__ v, size_t row0,
      size_t row, int col0, int n) {
#pragma unroll
    for (int j = 0; j < L::kLoads; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i >= n * L::kStepWords) break;
      const int t = i / L::kStepWords, wd = i % L::kStepWords;
      const int a = wd / L::kRowWords;           // 0 r, 1 k, 2 w, 3 v
      const T* src = a == 0 ? r : a == 1 ? k : a == 2 ? w : v;
      const size_t off = row0 + t * row +
                         (a < 3 ? (wd - a * L::kRowWords) * L::kVec
                                : col0 + (wd - 3 * L::kRowWords) * L::kVec);
      flash_decode::cp_async16(raw + (size_t)i * 16, src + off);
    }
    flash_decode::cp_async_commit();
  }

  __device__ __forceinline__ void store(float* cv, int n) const {
    flash_decode::cp_async_wait_all();
#pragma unroll
    for (int j = 0; j < L::kLoads; ++j) {
      const int i = threadIdx.x + j * blockDim.x;
      if (i >= n * L::kStepWords) break;
      float f[L::kVec];
      flash_decode::unpack<T>(
          *reinterpret_cast<const uint4*>(raw + (size_t)i * 16), f);
      float4* dst = reinterpret_cast<float4*>(cv + i * L::kVec);
#pragma unroll
      for (int e = 0; e < L::kVec / 4; ++e)
        dst[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2],
                             f[4 * e + 3]);
    }
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(HD / kRowsPer * 32)
rwkv_wkv_spread_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ w,
                       const T* __restrict__ u, const float* __restrict__ s0,
                       T* __restrict__ y, float* __restrict__ s_out,
                       int T_len, int H) {
  using L = Layout<T, HD>;
  const int col0 = blockIdx.x * kCols;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = threadIdx.x / 32, c = threadIdx.x % 32;
  extern __shared__ __align__(16) float wkv_smem[];
  float* cv = wkv_smem;                        // two chunks, float32
  float* yp = cv + 2 * L::kCvFloats;           // two [warp][step][column]

  const size_t row = (size_t)H * HD;           // stride of t
  const size_t base = (size_t)b * T_len * row + (size_t)h * HD;
  Chunk<T, HD> next{reinterpret_cast<uint8_t*>(yp + 2 * L::kYpFloats)};
  next.load(r, k, w, v, base, row, col0, min(kSteps, T_len));

  // this thread's elements S[8 g + m][col0 + c], m = 0 .. 7
  float S[kRowsPer], uu[kRowsPer];
  const size_t sb = ((size_t)b * H + h) * HD * HD + col0 + c;
#pragma unroll
  for (int m = 0; m < kRowsPer; ++m) {
    const int i = g * kRowsPer + m;
    S[m] = s0 != nullptr ? s0[sb + (size_t)i * HD] : 0.f;
    uu[m] = to_f(u[h * HD + i]);
  }
  next.store(cv, min(kSteps, T_len));
  __syncthreads();

  for (int ci = 0, t0 = 0; t0 < T_len; ++ci, t0 += kSteps) {
    const int n = min(kSteps, T_len - t0);
    const bool more = t0 + kSteps < T_len;
    // the next chunk's loads are in flight while this chunk's steps run
    if (more)
      next.load(r, k, w, v, base + (size_t)(t0 + kSteps) * row, row, col0,
                min(kSteps, T_len - t0 - kSteps));
    const float* cc = cv + (ci & 1) * L::kCvFloats;
    float* yc = yp + (ci & 1) * L::kYpFloats;
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float* st = cc + t * L::kStep + g * kRowsPer;
      const float4 r0 = *reinterpret_cast<const float4*>(st);
      const float4 r1 = *reinterpret_cast<const float4*>(st + 4);
      const float4 k0 = *reinterpret_cast<const float4*>(st + HD);
      const float4 k1 = *reinterpret_cast<const float4*>(st + HD + 4);
      const float4 w0 = *reinterpret_cast<const float4*>(st + 2 * HD);
      const float4 w1 = *reinterpret_cast<const float4*>(st + 2 * HD + 4);
      const float rr[kRowsPer] = {r0.x, r0.y, r0.z, r0.w,
                                  r1.x, r1.y, r1.z, r1.w};
      const float kk[kRowsPer] = {k0.x, k0.y, k0.z, k0.w,
                                  k1.x, k1.y, k1.z, k1.w};
      const float ww[kRowsPer] = {w0.x, w0.y, w0.z, w0.w,
                                  w1.x, w1.y, w1.z, w1.w};
      const float vj = cc[t * L::kStep + 3 * HD + c];
      float ya = 0.f, yb = 0.f;
#pragma unroll
      for (int m = 0; m < kRowsPer; m += 2) {
        const float kv0 = kk[m] * vj, kv1 = kk[m + 1] * vj;
        ya = fmaf(rr[m], fmaf(uu[m], kv0, S[m]), ya);
        yb = fmaf(rr[m + 1], fmaf(uu[m + 1], kv1, S[m + 1]), yb);
        S[m] = fmaf(ww[m], S[m], kv0);
        S[m + 1] = fmaf(ww[m + 1], S[m + 1], kv1);
      }
      yc[(g * kSteps + t) * kCols + c] = ya + yb;
    }
    if (more) next.store(cv + ((ci + 1) & 1) * L::kCvFloats,
                         min(kSteps, T_len - t0 - kSteps));
    // the next chunk is converted and this chunk's partials written; the
    // one barrier a chunk (each buffer is written again two chunks on)
    __syncthreads();
    for (int i = threadIdx.x; i < n * kCols; i += blockDim.x) {
      const int t = i / kCols, j = i % kCols;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < L::kWarps; ++q)
        sum += yc[(q * kSteps + t) * kCols + j];
      y[base + (size_t)(t0 + t) * row + col0 + j] = from_f<T>(sum);
    }
  }
  if (s_out != nullptr) {
#pragma unroll
    for (int m = 0; m < kRowsPer; ++m)
      s_out[sb + (size_t)(g * kRowsPer + m) * HD] = S[m];
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int B,
           int T_len, int H, cudaStream_t stream) {
  using L = Layout<T, HD>;
  auto kern = rwkv_wkv_spread_kernel<T, HD>;
  const int err = flash_decode::allow_smem(kern, L::kSmem);
  if (err != 0) return err;
  dim3 grid(HD / kCols, H, B);
  kern<<<grid, L::kThreads, L::kSmem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), T_len, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace spread

// ---------------------------------------------------------------------------
// Form 1: one thread per state column, every position's state written
// ---------------------------------------------------------------------------
namespace states {

constexpr int kChunk = 32;         // time steps staged per shared-memory load

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
rwkv_wkv_states_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ w,
                       const T* __restrict__ u, const float* __restrict__ s0,
                       T* __restrict__ y, float* __restrict__ s_out,
                       int T_len, int H) {
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
      float* so = s_out + (((size_t)b * T_len + t) * H + h) * HD2;
#pragma unroll
      for (int i = 0; i < HD; ++i) so[i * HD + j] = S[i];
    }
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int B,
           int T_len, int H, cudaStream_t stream) {
  dim3 grid(H, B);
  rwkv_wkv_states_kernel<T, HD><<<grid, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_out), T_len, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace states

template <typename T, int HD>
int launch_mode(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* s_out, int B,
                int T_len, int H, int mode, cudaStream_t stream) {
  if (mode == 1)
    return states::launch<T, HD>(r, k, v, w, u, s0, y, s_out, B, T_len, H,
                                 stream);
  return spread::launch<T, HD>(r, k, v, w, u, s0, y,
                               mode == 2 ? s_out : nullptr, B, T_len, H,
                               stream);
}

}  // namespace

// dtype (of r, k, v, w, u, y): 0 = float32, 1 = bfloat16; s0 and s_out are
// float32. hd must be 32 or 64. mode 0 writes no state; modes 1 and 2 want
// s_out. s0 may be null (zeros). Every pointer 16-byte aligned (the
// wrapper's tensors are contiguous and fresh or the caller's own).
extern "C" int rwkv_wkv_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               void* y, void* s_out, int B, int T_len, int H,
                               int hd, int mode, int dtype,
                               cudaStream_t stream) {
  if (T_len < 1 || mode < 0 || mode > 2 || (mode != 0 && s_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && hd == 64)
    return launch_mode<float, 64>(r, k, v, w, u, s0, y, s_out, B, T_len, H,
                                  mode, stream);
  if (dtype == 0 && hd == 32)
    return launch_mode<float, 32>(r, k, v, w, u, s0, y, s_out, B, T_len, H,
                                  mode, stream);
  if (dtype == 1 && hd == 64)
    return launch_mode<__nv_bfloat16, 64>(r, k, v, w, u, s0, y, s_out, B,
                                          T_len, H, mode, stream);
  if (dtype == 1 && hd == 32)
    return launch_mode<__nv_bfloat16, 32>(r, k, v, w, u, s0, y, s_out, B,
                                          T_len, H, mode, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
