// Paged flash-decode for grouped-query attention, with the window K/V
// writeback fused in.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py :
// paged_decode_kernel (_paged_kernel with latent=False, _merge_window,
// _pool_out_map).
//
// Computes, for each sequence b and kv head h, the attention of the G*W
// grouped query rows (row r = g*W + w, query position lengths[b] + w) over
// the keys reached through the block table tables[b, :], where the W fresh
// window rows k_new/v_new[b] take the place of pool slots at logical
// positions [lengths[b], lengths[b] + W). Those merged rows are written back
// into their physical blocks in place, so one launch per layer both reads
// the pool and commits the window. Masks: causal k_pos <= q_pos and, with
// window > 0, k_pos > q_pos - window.
//
// Bound on the H100: memory, at the serving shapes. Per (b, h) the kernel
// must read the visible K and V blocks once (2 * len * d elements) and the
// G*W query rows, and write the window rows and the output; the arithmetic
// (4 * G*W * len * d flops) is a small fraction of the card's rate even in
// float32. At B = 2 and KV = 8 the grid is only 16 blocks.
//
// Design (simple first): one block per (kv head, sequence). The reference's
// sequential grid axis over logical blocks becomes a loop inside the block
// that reads tables[b, j] itself, from the first block the sliding window
// can see to the block holding the last query position (tiles past it and
// below the window are skipped). Each block is taken 16 key slots at a
// time: the slots are loaded into shared memory as float32, window slots
// from k_new/v_new (and stored into the pool, which is what makes the
// writeback fused), then the scores of all G*W rows against the 16 keys,
// an online-softmax update of the running max and sum per row, and the
// rescaled accumulation of p @ V. The query rows, the accumulator and the
// softmax state stay in shared memory in float32 for the whole sweep, so
// the G query heads of one kv head share every K/V tile and the cache is
// never repeated. At the prefill width (W = 64, G = 2, d = 128) the
// accumulator alone is 64 KB, so the launch raises the dynamic shared-memory
// limit. Every block merges the window rows of its own (b, h) itself, and
// no two blocks write the same pool rows, except rows of empty batch slots,
// whose all-zero tables send them all to the sink block 0 (its contents are
// garbage by design and their outputs are discarded).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 16;          // key slots per shared-memory tile
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
constexpr size_t smem_floats(int R) {
  return 2 * (size_t)R * D + kKeys * (D + 1) + kKeys * D + (size_t)R * kKeys +
         3 * (size_t)R;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, T* __restrict__ k_pool,
                    T* __restrict__ v_pool, const T* __restrict__ k_new,
                    const T* __restrict__ v_new,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int KV, int R, int W, int bs, int nb, int window,
                    float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  extern __shared__ float smem[];
  float* q_s = smem;                       // R x D query rows
  float* acc_s = q_s + (size_t)R * D;      // R x D running p @ V
  float* k_s = acc_s + (size_t)R * D;      // kKeys x (D + 1), padded
  float* v_s = k_s + kKeys * (D + 1);      // kKeys x D
  float* p_s = v_s + kKeys * D;            // R x kKeys scores, then p
  float* m_s = p_s + (size_t)R * kKeys;    // R running max
  float* l_s = m_s + R;                    // R running sum
  float* a_s = l_s + R;                    // R rescale factor of this tile

  const int base = lengths[b];
  const T* qb = q + ((size_t)b * KV + h) * R * D;
  for (int i = tid; i < R * D; i += kThreads) {
    q_s[i] = to_f(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  const int last_pos = base + W - 1;       // the last query position
  const int first_vis = window > 0 ? base - window + 1 : 0;
  const int j_hi = min(last_pos / bs, nb - 1);
  const int j_lo = first_vis > 0 ? first_vis / bs : 0;
  const int* tb = tables + (size_t)b * nb;
  __syncthreads();

  for (int j = j_lo; j <= j_hi; ++j) {
    const int phys = tb[j];
    for (int s0 = 0; s0 < bs; s0 += kKeys) {
      const int k0 = j * bs + s0;          // logical position of slot s0
      const int nk = min(kKeys, bs - s0);
      if (k0 > last_pos) break;            // past every query: skip
      if (k0 + nk - 1 < first_vis) continue;   // below the sliding window
      // load the tile; window slots come from the fresh rows and are
      // committed to the pool (the fused writeback)
      for (int i = tid; i < nk * D; i += kThreads) {
        const int t = i / D, c = i % D;
        const int s = s0 + t;
        const int off = k0 + t - base;
        const size_t pidx = (((size_t)phys * bs + s) * KV + h) * D + c;
        T kv, vv;
        if (off >= 0 && off < W) {
          const size_t nidx = (((size_t)b * W + off) * KV + h) * D + c;
          kv = k_new[nidx];
          vv = v_new[nidx];
          k_pool[pidx] = kv;
          v_pool[pidx] = vv;
        } else {
          kv = k_pool[pidx];
          vv = v_pool[pidx];
        }
        k_s[t * (D + 1) + c] = to_f(kv);
        v_s[t * D + c] = to_f(vv);
      }
      __syncthreads();
      // scores of every grouped query row against the tile's keys
      for (int i = tid; i < R * kKeys; i += kThreads) {
        const int r = i / kKeys, t = i % kKeys;
        const int qpos = base + r % W;
        float sc = kNeg;
        if (t < nk && visible(k0 + t, qpos, window)) {
          const float* qr = q_s + (size_t)r * D;
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
      for (int r = tid; r < R; r += kThreads) {
        const int qpos = base + r % W;
        float* pr = p_s + (size_t)r * kKeys;
        float mc = kNeg;
        for (int t = 0; t < nk; ++t)
          if (visible(k0 + t, qpos, window)) mc = fmaxf(mc, pr[t]);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mc);
        const float alpha = expf(m_prev - m_new);
        float sum = 0.f;
        for (int t = 0; t < kKeys; ++t) {
          const bool vis = t < nk && visible(k0 + t, qpos, window);
          const float p = vis ? expf(pr[t] - m_new) : 0.f;
          pr[t] = p;
          sum += p;
        }
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
      __syncthreads();
      for (int i = tid; i < R * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const float* pr = p_s + (size_t)r * kKeys;
        float a = acc_s[i] * a_s[r];
        for (int t = 0; t < nk; ++t) a += pr[t] * v_s[t * D + c];
        acc_s[i] = a;
      }
      __syncthreads();
    }
  }
  T* ob = out + ((size_t)b * KV + h) * R * D;
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D;
    ob[i] = from_f<T>(acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, void* k_pool, void* v_pool, const void* k_new,
           const void* v_new, const int* tables, const int* lengths,
           void* out, int B, int KV, int R, int W, int bs, int nb, int window,
           float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>(R) * sizeof(float);
  auto kern = paged_decode_kernel<T, D>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) {      // more than a block may hold: report it
      cudaGetLastError();           // and leave no stale error behind
      return static_cast<int>(err);
    }
  }
  dim3 grid(KV, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(k_pool),
      static_cast<T*>(v_pool), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), tables, lengths, static_cast<T*>(out),
      KV, R, W, bs, nb, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D must be 64 or 128.
extern "C" int paged_decode_launch(const void* q, void* k_pool, void* v_pool,
                                   const void* k_new, const void* v_new,
                                   const int* tables, const int* lengths,
                                   void* out, int B, int KV, int R, int W,
                                   int D, int bs, int nb, int window,
                                   float scale, int dtype,
                                   cudaStream_t stream) {
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k_pool, v_pool, k_new, v_new, tables,
                             lengths, out, B, KV, R, W, bs, nb, window, scale,
                             stream);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k_pool, v_pool, k_new, v_new, tables,
                              lengths, out, B, KV, R, W, bs, nb, window,
                              scale, stream);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_pool, v_pool, k_new, v_new, tables,
                                     lengths, out, B, KV, R, W, bs, nb,
                                     window, scale, stream);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_pool, v_pool, k_new, v_new,
                                      tables, lengths, out, B, KV, R, W, bs,
                                      nb, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
