// Paged flash-decode for grouped-query attention, with the window K/V
// writeback fused in.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py :
// paged_decode_kernel (_paged_kernel with latent=False, _merge_window,
// _pool_out_map).
//
// Computes, for each sequence b and kv head h, the attention of the W*G
// grouped query rows (row r = w*G + g, query head h*G + g at position
// lengths[b] + w) over the keys reached through the block table
// tables[b, :], where the W fresh window rows k_new/v_new[b] take the place
// of the pool slots at logical positions [lengths[b], lengths[b] + W).
// Those rows are also committed to their physical blocks, so one launch
// per layer both attends and writes the window. Masks: causal
// k_pos <= q_pos and, with window > 0, k_pos > q_pos - window; keys at or
// past the table's span nb * bs are never attended, and window rows there
// never written (the reference sends them to the sink block 0, whose
// contents are garbage by design). q is read and the output written in the
// model's (B, W, H, d) layout in place: no copy on either side.
//
// Bound on the H100: latency, then bytes. Per (b, h) a call must read the
// visible cached K and V rows once, the W fresh rows and the query rows,
// and write the window rows and the output: at the serving verify shape
// (B = 2, W = 8, lengths 100 and 37, 8 kv heads of 128, bf16) ~0.8 MB,
// 0.25 us at 3.35 TB/s, and the arithmetic (4 * G * W * visible * d flops)
// is a small fraction of even the CUDA cores' float32 rate. What bounds a
// call is how many CTAs share the keys, how many bytes each keeps in
// flight and how many dependent global loads each waits for in a row.
//
// Design: split-key paged flash-decoding in one launch, the body shared
// with the dense decode kernel (flash_decode.cuh). The grid is (row tile x
// key split, kv head, sequence): at the verify shape 5 splits of one
// 16-row tile, 80 CTAs; at a 64-wide prefill chunk (B = 1) 8 tiles x 3
// splits, 192 CTAs. Each CTA computes its tile's visible key range from
// lengths[b] on the device, capped at nb * bs - 1, and takes its even
// share; the number of splits comes from the host's plan (split.py:
// split_plan over the span nb * bs, never the lengths). Before its key
// loop the CTA stages, by 4-byte cp.async, the table entries of the blocks
// its share covers (at most ceil(share / bs) + 1), alongside the query
// rows; after that no key address waits on a global load. A key at
// position p in [len, len + W) is read from k_new/v_new[b, p - len, h],
// any other from pool[tab[p / bs], p % bs, h]: both have the row stride
// KV * d, so the double-buffered 32-key stages are filled by 16-byte
// cp.async from a per-key row pointer. Partials go to the float32
// workspace and the last CTA of a group merges them (split_merge.cuh).
//
// The writeback needs no ordering against the attention: window keys are
// read from k_new/v_new, never from the pool, and the pool slots read are
// at positions below len, the ones written at or above it. The CTAs of
// each (sequence, kv head) share out that head's W window rows (row w by
// the CTA w mod their count), 16 bytes a thread, stored before the key
// loop; each in-table window slot is written exactly once. Empty batch
// slots have all-zero tables: they write into block 0 and their outputs
// are discarded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "flash_decode.cuh"

namespace {

using namespace flash_decode;

// K and V rows of kv head h of sequence b: window positions from the fresh
// rows, the rest from the pool through the table entries staged in shared
// memory (tab[i] is logical block blk0 + i)
template <typename T>
struct PagedKeys {
  static constexpr bool kStaged = true;    // addresses from the staged tab
  const T* k_pool;                  // at kv head h
  const T* v_pool;
  const T* k_new;                   // window row 0 of sequence b, kv head h
  const T* v_new;
  const int* tab;
  int blk0, bs, len, W;
  size_t stride;                    // elements between rows: KV * D
  __device__ __forceinline__ const T* row(int pos, bool is_v) const {
    const int o = pos - len;
    if (o >= 0 && o < W) return (is_v ? v_new : k_new) + (size_t)o * stride;
    const int j = pos / bs;
    return (is_v ? v_pool : k_pool) +
           ((size_t)tab[j - blk0] * bs + (pos - j * bs)) * stride;
  }
};

// This CTA's share of kv head h's W window rows (row w by the CTA w mod
// n_ctas), K and V, one 16-byte word a thread; rows at or past the table's
// span are not written.
template <typename T, int D>
__device__ __forceinline__ void write_window(
    T* __restrict__ k_pool, T* __restrict__ v_pool,
    const T* __restrict__ k_new, const T* __restrict__ v_new,
    const int* __restrict__ tb, int b, int h, int KV, int W, int bs, int nb,
    int len, int cta, int n_ctas) {
  using L = Layout<T, D>;
  constexpr int kWords = 2 * L::kPieces;          // K and V words of a row
  const int mine = cta < W ? (W - cta + n_ctas - 1) / n_ctas : 0;
  for (int i = threadIdx.x; i < mine * kWords; i += kThreads) {
    const int w = cta + (i / kWords) * n_ctas;
    const int j = i % kWords;
    const bool is_v = j >= L::kPieces;
    const int col = (is_v ? j - L::kPieces : j) * L::kVec;
    const int pos = len + w, blk = pos / bs;
    if (blk >= nb) continue;
    const uint4 word = *reinterpret_cast<const uint4*>(
        (is_v ? v_new : k_new) + (((size_t)b * W + w) * KV + h) * D + col);
    const size_t slot = (size_t)tb[blk] * bs + (pos - blk * bs);
    *reinterpret_cast<uint4*>((is_v ? v_pool : k_pool) +
                              (slot * KV + h) * D + col) = word;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, T* k_pool, T* v_pool,
                    const T* __restrict__ k_new, const T* __restrict__ v_new,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* ws_acc, float2* ws_ml, unsigned* counters, int W,
                    int H, int KV, int bs, int nb, int window, float scale,
                    int n_tiles, int n_splits) {
  const int split = blockIdx.x % n_splits;
  const int tile = blockIdx.x / n_splits;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int r0 = tile * kRows;
  const int nr = min(kRows, W * G - r0);
  const int len = lengths[b];
  const Chunk c = chunk_of(len, r0, nr, G, nb * bs, window, split, n_splits);
  extern __shared__ __align__(16) uint8_t smem[];
  int* tab_s = reinterpret_cast<int*>(smem + Layout<T, D>::kSmem);
  const int* tb = tables + (size_t)b * nb;
  const int blk0 = c.lo / bs;
  // the table entries of the chunk's blocks, once (attend waits for them;
  // a cp.async loop strides by blockDim.x, as stage_keys says)
  if (c.lo <= c.hi)
    for (int i = threadIdx.x; i <= c.hi / bs - blk0; i += blockDim.x)
      cp_async4(tab_s + i, tb + blk0 + i);
  cp_async_commit();
  write_window<T, D>(k_pool, v_pool, k_new, v_new, tb, b, h, KV, W, bs, nb,
                     len, blockIdx.x, n_tiles * n_splits);
  const size_t row = (size_t)KV * D;
  const PagedKeys<T> keys{k_pool + (size_t)h * D,
                          v_pool + (size_t)h * D,
                          k_new + (size_t)b * W * row + (size_t)h * D,
                          v_new + (size_t)b * W * row + (size_t)h * D,
                          tab_s, blk0, bs, len, W, row};
  attend<T, D>(q, out, keys, split_merge::Rows{b, W, H, h, G, r0}, nr, len,
               c, window, scale, ws_acc, ws_ml, counters,
               (b * KV + h) * n_tiles + tile, split, n_splits, smem);
}

template <typename T, int D>
int launch(const void* q, void* k_pool, void* v_pool, const void* k_new,
           const void* v_new, const int* tables, const int* lengths,
           void* out, void* ws, unsigned* counters, int B, int W, int H,
           int KV, int bs, int nb, int window, float scale, int n_tiles,
           int n_splits, cudaStream_t stream) {
  using L = Layout<T, D>;
  // the merge keeps 2 (n_splits + 1) kRows floats in the K/V stages
  if (2 * (n_splits + 1) * kRows * 4 > 2 * L::kStageBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // a share of at most ceil(nb bs / n_splits) keys covers at most this
  // many blocks, whatever its first key
  const int per = (nb * bs + n_splits - 1) / n_splits;
  const size_t smem =
      L::kSmem + (size_t)((per + bs - 2) / bs + 1) * sizeof(int);
  auto kern = paged_decode_kernel<T, D>;
  if (const int err = allow_smem(kern, smem)) return err;
  dim3 grid(n_tiles * n_splits, KV, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(k_pool),
      static_cast<T*>(v_pool), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), tables, lengths, static_cast<T*>(out),
      static_cast<float*>(ws), ws_pairs<D>(ws, B * KV * n_tiles, n_splits),
      counters, W, H, KV, bs, nb, window, scale, n_tiles, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, W, H, D); pools (P, bs, KV, D), written in place; k_new,
// v_new (B, W, KV, D); tables (B, nb) and lengths (B,) int32; all
// contiguous and 16-byte aligned. dtype: 0 = float32, 1 = bfloat16; D 64,
// 128 or 256; H a multiple of KV; n_tiles = ceil(W * H / KV / 16). With
// n_splits > 1, ws holds B * KV * n_tiles * n_splits * 16 * (D + 2) floats
// and counters B * KV * n_tiles zeros (zeros again when the call ends).
extern "C" int paged_decode_launch(const void* q, void* k_pool, void* v_pool,
                                   const void* k_new, const void* v_new,
                                   const int* tables, const int* lengths,
                                   void* out, void* ws, unsigned* counters,
                                   int B, int W, int H, int KV, int D, int bs,
                                   int nb, int window, float scale, int dtype,
                                   int n_tiles, int n_splits,
                                   cudaStream_t stream) {
  if (W < 1 || KV < 1 || H % KV != 0 || bs < 1 || nb < 1 || n_tiles < 1 ||
      n_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define PAGED_ARGS                                                          \
  q, k_pool, v_pool, k_new, v_new, tables, lengths, out, ws, counters, B, W, \
      H, KV, bs, nb, window, scale, n_tiles, n_splits, stream
  if (dtype == 0 && D == 64) return launch<float, 64>(PAGED_ARGS);
  if (dtype == 0 && D == 128) return launch<float, 128>(PAGED_ARGS);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(PAGED_ARGS);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(PAGED_ARGS);
  if (dtype == 0 && D == 256) return launch<float, 256>(PAGED_ARGS);
  if (dtype == 1 && D == 256) return launch<__nv_bfloat16, 256>(PAGED_ARGS);
#undef PAGED_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
