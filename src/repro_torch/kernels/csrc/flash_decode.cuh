// Split-key flash-decode of one row tile: the body shared by the dense
// (decode_attention.cu) and the paged (paged_decode.cu) decode kernels.
// They differ only in where a key's K and V rows lie, which a ``Keys``
// source tells (``row(pos, is_v)``: the K or V row of kv head h at logical
// position pos), and in what the paged kernel does before it (stage its
// block table, issue its window writeback). A source computes one address
// per call: written as ``is_v ? value(pos) : key(pos)`` the copy loop ran
// slower on the card.
//
// A group is one (row tile, kv head, sequence); a row tile is kRows query
// rows in w-major order (row r0 + r = w * G + g, query head h * G + g at
// position len + w), read from q and written to out in the model's
// (B, W, H, D) layout in place (split_merge::Rows). Each CTA of a group
// takes an even share [c_lo, c_hi] of the keys some row of its tile sees
// (``chunk_of``, from the length on the device) and streams it 32 keys at a
// time through a double-buffered shared tile by 16-byte cp.async loads
// (rows padded by 16 bytes, so lanes reading their own key rows hit
// distinct banks); each lane scores one key against the warp's two rows,
// the warp keeps those rows' running max and sum in float32, and each
// thread accumulates D / 16 output columns of one row. A CTA leaves its
// partial (m, l, acc) in a float32 workspace; the last CTA of the group
// merges them (split_merge.cuh). One split writes the output directly. The
// math is the reference's: float32 scores, softmax and p V on the CUDA
// cores (the products are tiny at decode shapes). Masks: causal
// k_pos <= q_pos and, with window > 0, k_pos > q_pos - window; keys past
// the span S are never in a chunk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

#include "split_merge.cuh"

namespace flash_decode {

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
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
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
  // two K/V stages, the query rows and the probabilities in float32
  static constexpr size_t kSmem = 2 * (size_t)kStageBytes +
                                  (size_t)kRows * D * 4 +
                                  (size_t)kRows * kKeys * 4;
};

// The keys [c_lo, c_hi] of split ``split`` of a tile with rows r0 ..
// r0 + nr - 1: an even share of the range [lo, hi] that some row sees
// (empty when c_lo > c_hi), keys past the span S excluded.
struct Chunk {
  int lo, hi;
};
__device__ __forceinline__ Chunk chunk_of(int len, int r0, int nr, int G,
                                          int S, int window, int split,
                                          int n_splits) {
  const int hi = min(len + (r0 + nr - 1) / G, S - 1);
  const int lo = window > 0 ? max(0, len + r0 / G - window + 1) : 0;
  const int per = (max(0, hi - lo + 1) + n_splits - 1) / n_splits;
  const int c_lo = lo + split * per;
  return Chunk{c_lo, min(hi, c_lo + per - 1)};
}

// keys k0 .. k0 + nk - 1 into one shared stage, K rows then V rows, padded
// to kRowBytes, by 16-byte cp.async. The loop strides by blockDim.x: with
// the same stride as the constant kThreads, the card's toolkit compiled
// this loop wrong in bf16 (copies past the stage and past the cache).
template <typename T, int D, typename Keys>
__device__ __forceinline__ void stage_keys(uint8_t* stage, const Keys& keys,
                                           int k0, int nk) {
  using L = Layout<T, D>;
  const int n = nk * L::kPieces;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    const bool is_v = i >= n;
    const int j = is_v ? i - n : i;
    const int t = j / L::kPieces, piece = j % L::kPieces;
    cp_async16(stage + (is_v ? kKeys + t : t) * L::kRowBytes + piece * 16,
               keys.row(k0 + t, is_v) + piece * L::kVec);
  }
  cp_async_commit();
}

// The tile's attention over chunk c: partial or, with one split, the
// output. ``smem`` is the kernel's dynamic shared memory (L::kSmem bytes
// at its start); ``len`` the sequence's length. Every thread of the CTA
// calls it. A key source whose addresses come from shared memory
// (``Keys::kStaged``, the paged kernel's block table, staged by cp.async
// before the call) has its first keys issued after the query rows are
// loaded and that table has landed; any other before the query rows, so
// the first keys' copies overlap their loads.
template <typename T, int D, typename Keys>
__device__ __forceinline__ void attend(
    const T* __restrict__ q, T* __restrict__ out, const Keys& keys,
    const split_merge::Rows& rows, int nr, int len, Chunk c, int window,
    float scale, float* ws_acc, float2* ws_ml, unsigned* counters, int group,
    int split, int n_splits, uint8_t* smem) {
  using L = Layout<T, D>;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = rows.G, r0 = rows.r0;
  float* q_s = reinterpret_cast<float*>(smem + 2 * L::kStageBytes);
  float* p_s = q_s + kRows * D;                        // kRows x kKeys

  // p V: this thread's row pr (one of its warp's two) and columns pc..
  const int pr = tid / 16;
  const int pc = (tid % 16) * L::kCols;
  float acc[L::kCols];
#pragma unroll
  for (int k = 0; k < L::kCols; ++k) acc[k] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows 2 warp + i

  const int n_sub = c.lo <= c.hi ? (c.hi - c.lo + kKeys) / kKeys : 0;
  if constexpr (!Keys::kStaged)
    if (n_sub > 0)
      stage_keys<T, D>(smem, keys, c.lo, min(kKeys, c.hi + 1 - c.lo));
  // the query rows as float32
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
  if constexpr (Keys::kStaged) {
    cp_async_wait_all();   // the key source's table, staged by cp.async
    __syncthreads();
    if (n_sub > 0)
      stage_keys<T, D>(smem, keys, c.lo, min(kKeys, c.hi + 1 - c.lo));
  }

  for (int it = 0; it < n_sub; ++it) {
    const int k0 = c.lo + it * kKeys;
    const int nk = min(kKeys, c.hi + 1 - k0);
    cp_async_wait_all();
    __syncthreads();    // sub-tile it has landed; the other stage is free
    if (it + 1 < n_sub)
      stage_keys<T, D>(smem + ((it + 1) & 1) * L::kStageBytes, keys,
                       k0 + kKeys, min(kKeys, c.hi + 1 - k0 - kKeys));
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
    for (int k = 0; k < L::kCols; ++k) acc[k] *= a;
    for (int t = 0; t < nk; ++t) {
      const float p = p_s[pr * kKeys + t];
      float f[L::kCols];
      load_f<T, L::kCols>(
          reinterpret_cast<const T*>(vs + t * L::kRowBytes) + pc, f);
#pragma unroll
      for (int k = 0; k < L::kCols; ++k) acc[k] = fmaf(p, f[k], acc[k]);
    }
  }

  const float m_r = lane < 16 ? m[0] : m[1];
  const float l_r = lane < 16 ? l[0] : l[1];
  if (n_splits == 1) {
    if (pr < nr) {
      const float inv = 1.f / fmaxf(l_r, 1e-30f);
      T* o = out + rows.at(pr) * D + pc;
#pragma unroll
      for (int k = 0; k < L::kCols; ++k)
        o[k] = split_merge::from_f<T>(acc[k] * inv);
    }
    return;
  }
  const size_t slot = (size_t)group * n_splits + split;
  if (l_r > 0.f) {                 // the merge reads acc only where l > 0
    float* wa = ws_acc + (slot * kRows + pr) * D + pc;
#pragma unroll
    for (int k = 0; k < L::kCols; ++k) wa[k] = acc[k];
  }
  if (tid % 16 == 0)
    ws_ml[slot * kRows + pr] =
        make_float2(c.lo <= c.hi ? m_r : -INFINITY, l_r);
  if (!split_merge::last_of_group(counters, group, n_splits)) return;
  split_merge::merge<D, kRows, kThreads>(ws_acc, ws_ml, group, n_splits, nr,
                                         rows, out,
                                         reinterpret_cast<float*>(smem));
}

// Sets the kernel's dynamic shared-memory limit where ``bytes`` pass the
// default 48 KB; returns the CUDA error (0 on success), leaving none behind.
template <typename Kernel>
int allow_smem(Kernel kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// The workspace's (m, l) pairs follow its accumulators: n_groups * n_splits
// partials of kRows x D floats, then as many kRows (m, l) pairs.
template <int D>
__host__ __forceinline__ float2* ws_pairs(void* ws, int n_groups,
                                          int n_splits) {
  return reinterpret_cast<float2*>(static_cast<float*>(ws) +
                                   (size_t)n_groups * n_splits * kRows * D);
}

}  // namespace flash_decode
