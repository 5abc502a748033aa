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
// reference. q is read and the output written in the model's (B, W, H, d)
// layout in place: no copy on either side.
//
// Bound on the H100: memory and latency. Per (b, h) a call must read the
// visible K and V rows once and the query rows, and write the output; at
// the solo sampler's verify shape that is ~0.76 MB (0.23 us at 3.35 TB/s)
// and the arithmetic (4 * G * W * visible * d flops) is a small fraction
// of even the CUDA cores' float32 rate, so what bounds a call is how many
// bytes are in flight and how many dependent steps each CTA takes.
//
// Design: split-key flash-decoding in one launch. The grid is (row tile x
// key split, kv head, sequence); a row tile is 16 query rows (w-major, so
// a tile holds neighbouring positions), a group is one (row tile, kv head,
// sequence). Each CTA computes its tile's visible key range [lo, hi] from
// lengths[b] on the device and takes its even share of it; the number of
// splits comes from the host's plan (ops.py: split_plan, from S, W, G and
// window, never from the lengths, which would sync the host). The chunk
// is streamed 32 keys at a time through a double-buffered shared tile by
// 16-byte cp.async loads (rows padded by 16 bytes, so lanes reading their
// own key rows hit distinct banks); each lane scores one key against the
// warp's two rows, the warp keeps those rows' running max and sum in
// float32, and each thread accumulates 8 (d = 128) output columns of one
// row. A CTA leaves its partial (m, l, acc) in a float32 workspace; the
// last CTA of the group merges them (split_merge.cuh). One split writes the
// output directly. The math is the reference's: float32 scores, softmax
// and p V on the CUDA cores (the products are tiny here).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#include "split_merge.cuh"

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kRows = 16;          // query rows per CTA, 2 per warp
constexpr int kKeys = 32;          // keys per shared tile, one per lane
constexpr float kNeg = -1.0e30f;   // running-max start, as the reference

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of T as floats
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u,
                                                      float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// N consecutive elements as floats, 16 bytes at a time where N allows
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float* f) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      unpack<T>(reinterpret_cast<const uint4*>(p)[i],
                f + i * (16 / (int)sizeof(T)));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f(p[i]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// keys k0 .. k0 + nk - 1 of K and V rows kb, vb (kv_row elements apart)
// into one shared stage, rows padded to kRowBytes, by 16-byte cp.async
template <typename T, int kPieces, int kVec, int kRowBytes>
__device__ __forceinline__ void stage_keys(uint8_t* stage, const T* kb,
                                           const T* vb, size_t kv_row,
                                           int k0, int nk) {
  const int n = nk * kPieces;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    const bool is_v = i >= n;
    const int j = is_v ? i - n : i;
    const int t = j / kPieces, piece = j % kPieces;
    cp_async16(stage + (is_v ? kKeys + t : t) * kRowBytes + piece * 16,
               (is_v ? vb : kb) + (size_t)(k0 + t) * kv_row + piece * kVec);
  }
  cp_async_commit();
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
struct Layout {
  static constexpr int kVec = 16 / (int)sizeof(T);     // elements per load
  static constexpr int kPieces = D / kVec;             // loads per row
  static constexpr int kRowBytes = D * (int)sizeof(T) + 16;  // padded row
  static constexpr int kStageBytes = 2 * kKeys * kRowBytes;  // K and V
  static constexpr int kCols = D / 16;                 // p V columns a thread
  static constexpr size_t kSmem = 2 * (size_t)kStageBytes +
                                  (size_t)kRows * D * 4 +
                                  (size_t)kRows * kKeys * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const void* lengths,
                        int len64, T* __restrict__ out, float* ws_acc,
                        float2* ws_ml, unsigned* counters, int W, int H,
                        int KV, int S, int window, float scale, int n_tiles,
                        int n_splits) {
  using L = Layout<T, D>;
  const int split = blockIdx.x % n_splits;
  const int tile = blockIdx.x / n_splits;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = tile * kRows;
  const int nr = min(kRows, W * G - r0);
  const int group = (b * KV + h) * n_tiles + tile;
  const int len = len64 ? static_cast<int>(
                              static_cast<const long long*>(lengths)[b])
                        : static_cast<const int*>(lengths)[b];
  // the keys some row of the tile sees, and this split's share of them
  const int hi = min(len + (r0 + nr - 1) / G, S - 1);
  const int lo = window > 0 ? max(0, len + r0 / G - window + 1) : 0;
  const int per = (max(0, hi - lo + 1) + n_splits - 1) / n_splits;
  const int c_lo = lo + split * per;
  const int c_hi = min(hi, c_lo + per - 1);

  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem + 2 * L::kStageBytes);
  float* p_s = q_s + kRows * D;                        // kRows x kKeys

  const split_merge::Rows rows{b, W, H, h, G, r0};     // q and out rows
  // p V: this thread's row pr (one of its warp's two) and columns pc..
  const int pr = tid / 16;
  const int pc = (tid % 16) * L::kCols;
  float acc[L::kCols];
#pragma unroll
  for (int c = 0; c < L::kCols; ++c) acc[c] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows 2 warp + i

  // the query rows as float32 (read first: they do not wait for lengths)
  for (int i = tid; i < kRows * L::kPieces; i += kThreads) {
    const int r = i / L::kPieces, piece = i % L::kPieces;
    float f[L::kVec];
    if (r < nr) {
      unpack<T>(*reinterpret_cast<const uint4*>(q + rows.at(r) * D +
                                                piece * L::kVec),
                f);
    } else {
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) q_s[r * D + piece * L::kVec + e] = f[e];
  }

  if (c_lo <= c_hi) {
    const size_t kv_row = (size_t)KV * D;           // between positions
    const T* kb = k + (size_t)b * S * kv_row + (size_t)h * D;
    const T* vb = v + (size_t)b * S * kv_row + (size_t)h * D;
    const int n_sub = (c_hi - c_lo + kKeys) / kKeys;
    stage_keys<T, L::kPieces, L::kVec, L::kRowBytes>(
        smem, kb, vb, kv_row, c_lo, min(kKeys, c_hi + 1 - c_lo));
    for (int it = 0; it < n_sub; ++it) {
      const int k0 = c_lo + it * kKeys;
      const int nk = min(kKeys, c_hi + 1 - k0);
      cp_async_wait_all();
      __syncthreads();    // sub-tile it has landed; the other stage is free
      if (it + 1 < n_sub)
        stage_keys<T, L::kPieces, L::kVec, L::kRowBytes>(
            smem + ((it + 1) & 1) * L::kStageBytes, kb, vb, kv_row,
            k0 + kKeys, min(kKeys, c_hi + 1 - k0 - kKeys));
      const uint8_t* ks = smem + (it & 1) * L::kStageBytes;
      const uint8_t* vs = ks + kKeys * L::kRowBytes;
      // scores: lane = key, against the warp's rows 2 warp and 2 warp + 1
      float sc[2] = {0.f, 0.f};
      if (lane < nk) {
        const uint4* kr =
            reinterpret_cast<const uint4*>(ks + lane * L::kRowBytes);
        const float* qa = q_s + 2 * warp * D;
#pragma unroll 4
        for (int piece = 0; piece < L::kPieces; ++piece) {
          float f[L::kVec];
          unpack<T>(kr[piece], f);
#pragma unroll
          for (int e = 0; e < L::kVec; ++e) {
            sc[0] = fmaf(qa[piece * L::kVec + e], f[e], sc[0]);
            sc[1] = fmaf(qa[D + piece * L::kVec + e], f[e], sc[1]);
          }
        }
      }
      // online softmax of the two rows, in float32
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * warp + i;
        const int qpos = len + (r0 + r) / G;
        const int kpos = k0 + lane;
        const bool vis = r < nr && lane < nk && kpos <= qpos &&
                         (window <= 0 || kpos > qpos - window);
        const float x = vis ? sc[i] * scale : kNeg;
        const float m_new = fmaxf(m[i], warp_max(x));
        const float p = vis ? expf(x - m_new) : 0.f;
        alpha[i] = expf(m[i] - m_new);
        l[i] = alpha[i] * l[i] + warp_sum(p);
        m[i] = m_new;
        p_s[r * kKeys + lane] = p;
      }
      __syncwarp();
      const float a = lane < 16 ? alpha[0] : alpha[1];
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) acc[c] *= a;
      for (int t = 0; t < nk; ++t) {
        const float p = p_s[pr * kKeys + t];
        float f[L::kCols];
        load_f<T, L::kCols>(
            reinterpret_cast<const T*>(vs + t * L::kRowBytes) + pc, f);
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) acc[c] = fmaf(p, f[c], acc[c]);
      }
    }
  }

  const float m_r = lane < 16 ? m[0] : m[1];
  const float l_r = lane < 16 ? l[0] : l[1];
  if (n_splits == 1) {
    if (pr < nr) {
      const float inv = 1.f / fmaxf(l_r, 1e-30f);
      T* o = out + rows.at(pr) * D + pc;
#pragma unroll
      for (int c = 0; c < L::kCols; ++c)
        o[c] = split_merge::from_f<T>(acc[c] * inv);
    }
    return;
  }
  const size_t slot = (size_t)group * n_splits + split;
  if (l_r > 0.f) {                 // the merge reads acc only where l > 0
    float* wa = ws_acc + (slot * kRows + pr) * D + pc;
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) wa[c] = acc[c];
  }
  if (tid % 16 == 0)
    ws_ml[slot * kRows + pr] =
        make_float2(c_lo <= c_hi ? m_r : -INFINITY, l_r);
  if (!split_merge::last_of_group(counters, group, n_splits)) return;
  split_merge::merge<D, kRows, kThreads>(ws_acc, ws_ml, group, n_splits, nr,
                                         rows, out,
                                         reinterpret_cast<float*>(smem));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           int len64, void* out, void* ws, unsigned* counters, int B, int W,
           int H, int KV, int S, int window, float scale, int n_tiles,
           int n_splits, cudaStream_t stream) {
  using L = Layout<T, D>;
  // the merge keeps 2 (n_splits + 1) kRows floats in the K/V stages
  if (2 * (n_splits + 1) * kRows * 4 > 2 * L::kStageBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = decode_attention_kernel<T, D>;
  if (L::kSmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kSmem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  float* ws_acc = static_cast<float*>(ws);
  float2* ws_ml = reinterpret_cast<float2*>(
      ws_acc + (size_t)B * KV * n_tiles * n_splits * kRows * D);
  dim3 grid(n_tiles * n_splits, KV, B);
  kern<<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, len64, static_cast<T*>(out), ws_acc,
      ws_ml, counters, W, H, KV, S, window, scale, n_tiles, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, W, H, D); k, v: (B, S, KV, D); lengths (B,) int32 or, with
// len64, int64; all contiguous. dtype: 0 = float32, 1 = bfloat16; D 64 or
// 128; H a multiple of KV; n_tiles = ceil(W * H / KV / 16). With
// n_splits > 1, ws holds B * KV * n_tiles * n_splits * 16 * (D + 2) floats
// and counters B * KV * n_tiles zeros (zeros again when the call ends).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    int len64, void* out, void* ws, unsigned* counters, int B, int W, int H,
    int KV, int D, int S, int window, float scale, int dtype, int n_tiles,
    int n_splits, cudaStream_t stream) {
  if (W < 1 || KV < 1 || H % KV != 0 || S < 1 || n_tiles < 1 ||
      n_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define DECODE_ARGS                                                      \
  q, k, v, lengths, len64, out, ws, counters, B, W, H, KV, S, window, scale, \
      n_tiles, n_splits, stream
  if (dtype == 0 && D == 64) return launch<float, 64>(DECODE_ARGS);
  if (dtype == 0 && D == 128) return launch<float, 128>(DECODE_ARGS);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(DECODE_ARGS);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(DECODE_ARGS);
#undef DECODE_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
