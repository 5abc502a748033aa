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
// 16-byte cp.async loads and merged by the last CTA of its group: the body
// shared with the paged decode kernel (flash_decode.cuh). The key source
// is the cache itself: row (b, pos, h) of k and v.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

// K and V rows of kv head h of one sequence's dense cache
template <typename T>
struct DenseKeys {
  static constexpr bool kStaged = false;   // addresses from k, v alone
  const T* k;
  const T* v;
  size_t stride;                    // elements between positions: KV * D
  __device__ __forceinline__ const T* row(int pos, bool is_v) const {
    return (is_v ? v : k) + (size_t)pos * stride;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const void* lengths,
                        int len64, T* __restrict__ out, float* ws_acc,
                        float2* ws_ml, unsigned* counters, int W, int H,
                        int KV, int S, int window, float scale, int n_tiles,
                        int n_splits) {
  const int split = blockIdx.x % n_splits;
  const int tile = blockIdx.x / n_splits;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int r0 = tile * kRows;
  const int nr = min(kRows, W * G - r0);
  const int len = len64 ? static_cast<int>(
                              static_cast<const long long*>(lengths)[b])
                        : static_cast<const int*>(lengths)[b];
  extern __shared__ __align__(16) uint8_t smem[];
  const size_t row = (size_t)KV * D;
  const DenseKeys<T> keys{k + (size_t)b * S * row + (size_t)h * D,
                          v + (size_t)b * S * row + (size_t)h * D, row};
  attend<T, D>(q, out, keys, split_merge::Rows{b, W, H, h, G, r0}, nr, len,
               chunk_of(len, r0, nr, G, S, window, split, n_splits), window,
               scale, ws_acc, ws_ml, counters, (b * KV + h) * n_tiles + tile,
               split, n_splits, smem);
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
  if (const int err = allow_smem(kern, L::kSmem)) return err;
  dim3 grid(n_tiles * n_splits, KV, B);
  kern<<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, len64, static_cast<T*>(out),
      static_cast<float*>(ws), ws_pairs<D>(ws, B * KV * n_tiles, n_splits),
      counters, W, H, KV, S, window, scale, n_tiles, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, W, H, D); k, v: (B, S, KV, D); lengths (B,) int32 or, with
// len64, int64; all contiguous. dtype: 0 = float32, 1 = bfloat16; D 64,
// 128 or 256; H a multiple of KV; n_tiles = ceil(W * H / KV / 16). With
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
  if (dtype == 0 && D == 256) return launch<float, 256>(DECODE_ARGS);
  if (dtype == 1 && D == 256) return launch<__nv_bfloat16, 256>(DECODE_ARGS);
#undef DECODE_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
