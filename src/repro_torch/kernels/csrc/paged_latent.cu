// Paged multi-head latent attention (MLA) decode over the absorbed latent
// cache, with the window writeback of both latent pools fused in.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py :
// paged_latent_kernel (_paged_kernel with latent=True, _merge_window,
// _pool_out_map).
//
// Computes, for each sequence b, the attention of its R = H*W query rows
// (row = w*H + h, query head h at position lengths[b] + w) over the latent
// cache reached through the block table tables[b, :]. A key slot holds the
// compressed latent c_kv (r values) and the shared rope key k_rope (dr
// values); the score of a row against a slot is
// (q_lat . c_kv + q_rope . k_rope) * scale, and the merged c_kv row is
// also the value, so the output is the attention-weighted latent (R x r).
// The W fresh window latents c_new/kr_new[b] take the place of the pool
// slots at logical positions [lengths[b], lengths[b] + W), and are
// committed into both pools in place. Mask: k_pos <= q_pos; keys at or
// past the table's span nb * bs are never attended, and window rows there
// never written (the reference sends them to the sink block 0). Softmax
// online, in float32; masked slots contribute exactly 0. q_lat and q_rope
// are read in place through their (b, w, h) strides, in the model's
// (B, W, H, .) layout; the output is written as (B, W, H, r).
//
// Bound on the H100: bytes, then latency. One latent "kv head" serves all
// H = 128 heads, so a call is a small GEMM: at the verify shape (B = 2,
// W = 8, lengths 100 and 37) 1024 query rows per sequence against at most
// 108 keys, 576 deep for the scores and 512 wide for the values. The
// bytes are the queries in and the output out (4.5 of its 4.7 MB, 1.4 us
// at 3.35 TB/s), not the 124 KB of cache; its ~0.5 GFLOP take ~0.5 us on
// the tensor cores, but ~8 us in float32 on the CUDA cores.
//
// bfloat16 (the serving path): a tensor-core kernel. The grid is (row
// tile of 64 rows, column split, sequence). With H = 128 a tile is one
// window position w and 64 heads, so its visible keys are one range; with
// fewer heads (the reduced config) a tile spans several w and the mask is
// per row. The score of a row does not depend on the value columns, so
// the card is filled by splitting the 512 value columns over 2 or 4 CTAs
// (kernel.py: latent_plan, from B and R, never the lengths): each CTA
// recomputes the tile's scores and accumulates its share of the columns.
// A key split would instead leave a 64 x 512 float32 partial (128 KB) per
// CTA to merge, more than the scores it saves cost; the column split needs
// no workspace, no ticket and no merge, and is the same on every replay.
// Each CTA of two warpgroups stages, by 16-byte cp.async, its 64 query
// rows and the table entries of the cached blocks it reads (4-byte
// cp.async) once; then 32-key tiles of the merged [c_kv | k_rope] rows, in
// bf16, through two shared stages, the next tile's copies issued while the
// tensor cores score the current one. 8 threads share a key row (4 a query
// row), so each resolves its row's address once a tile (resolved per
// 16-byte word, the address arithmetic cost more than the copies). Rows
// are stored in 64-column boxes with wgmma's 128-byte swizzle (the 16-byte
// word c of row r at r * 128 + (c ^ r % 8) * 16). Warpgroup `half` scores
// all 64 rows over half of the 576-deep product (K-sliced over r, then
// dr) by wgmma m64n32k16 from those boxes: bf16 in, float32 accumulate,
// and bf16 products are exact in float32, so only the order of summation
// differs from the float32 reference (by mma.sync the scores were bound by
// the ldmatrix traffic, which re-read the query tile every key tile and
// each key tile four times). Warp (rb, half) then adds the other half of
// its 16 rows' scores from its partner warp through shared memory (a + b,
// the same sum in both warps), keeps the rows' running max and sum in
// float32 registers (in log2 units, exp2), and accumulates P V by mma.sync
// m16n8k16 over its half of the CTA's value columns. P stays
// float32-exact, as in flash_attention.cu: hi = bf16(p) and
// lo = bf16(p - hi) are both multiplied by V (read by ldmatrix.trans) into
// the float32 accumulator, which holds at most 16 rows x 128 columns a
// warp (64 registers a thread). The output tile goes out through the
// stages in 16-byte words.
//
// float32 (tests and plain parity paths): TF32 tensor cores could not meet
// the float32 tolerance (2e-5 over 576-long products), so float32 keeps the
// CUDA-core kernel: grid (ceil(R / 16), B), each CTA 16 query rows; 16-slot
// tiles of [c_kv | k_rope] staged in shared memory as float32; the
// 16 x 16 scores split 16 ways a dot product and reduced by shuffles; p V
// by float32 FMAs, each thread owning one or two latent columns.
//
// The writeback needs no ordering against the attention: window keys are
// read from c_new/kr_new, never from the pool, and the pool slots read are
// at positions below lengths[b], the ones written at or above it. The CTAs
// of a sequence share out its W window rows (row w by the CTA w mod their
// count), 16 bytes a thread; each in-table window slot is written once,
// bitwise. Empty batch slots (table all zero, length 0) read no pool slot
// and commit into the sink block 0, whose contents are garbage by design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "flash_decode.cuh"

namespace {

using flash_decode::cp_async16;
using flash_decode::cp_async4;
using flash_decode::cp_async_commit;
using flash_decode::cp_async_wait_all;

constexpr float kNeg = -1.0e30f;   // running-max start, as the reference

// Element strides of a query tensor's (b, w, h) axes; its last axis is
// contiguous.
struct QStrides {
  long long b, w, h;
  __device__ __forceinline__ size_t at(int bb, int w_, int h_) const {
    return (size_t)(bb * b + w_ * w + h_ * h);
  }
};

// The CTAs of sequence b share out its window rows: CTA ``cta`` of
// ``n_ctas`` commits rows cta, cta + n_ctas, ... of c_new/kr_new[b] into
// their pool slots, 16-byte words of the rv latent and dv rope words a row.
__device__ __forceinline__ void commit_window(
    uint4* c4, uint4* kr4, const uint4* cn4, const uint4* krn4,
    const int* tb, int b, int base, int W, int bs, int nb, int rv, int dv,
    int cta, int n_ctas) {
  const int DV = rv + dv;
  const int mine = W > cta ? (W - 1 - cta) / n_ctas + 1 : 0;
  for (int i = threadIdx.x; i < mine * DV; i += blockDim.x) {
    const int w = cta + (i / DV) * n_ctas, v = i % DV;
    const int pos = base + w;
    if (pos >= nb * bs) continue;            // past the table: not written
    const size_t slot = (size_t)tb[pos / bs] * bs + pos % bs;
    const size_t nrow = (size_t)b * W + w;
    if (v < rv)
      c4[slot * rv + v] = cn4[nrow * rv + v];
    else
      kr4[slot * dv + v - rv] = krn4[nrow * dv + v - rv];
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 256;      // 8 warps: 4 row blocks x 2 halves
constexpr int kRows = 64;          // query rows per CTA
constexpr int kKeys = 32;          // keys per shared stage

// Shared rows are [c_kv | k_rope] (or [q_lat | q_rope]) in boxes of 64
// bf16 columns: box j holds columns 64 j .. 64 j + 63 of every row, 128
// bytes a row, with the 128-byte swizzle of wgmma's K-major operands (the
// 16-byte word c of row r at r * 128 + ((c ^ r % 8) * 16), boxes 1024-byte
// aligned). A depth that does not fill its last box leaves that box's
// tail unused.
template <int RL, int DR>
struct Layout {
  static constexpr int kD = RL + DR;                 // score depth
  static constexpr int kSteps = kD / 16;             // k16 steps of a score
  static constexpr int kWords = kD / 8;              // 16-byte words a row
  static constexpr int kBoxes = (kD + 63) / 64;
  static constexpr int kQBox = kRows * 128;          // a box of the queries
  static constexpr int kKBox = kKeys * 128;          // a box of a key stage
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kStageBytes = kBoxes * kKBox;
  static constexpr int kXFloats = 8 * 32 * 16;       // score halves a warp
  static_assert(RL % 16 == 0 && DR % 16 == 0, "k16 steps within r, dr");
  static size_t smem(int nb) {
    return 1024 + (size_t)kQBytes + 2 * (size_t)kStageBytes +
           kXFloats * 4 + (size_t)nb * 4;
  }
  // the byte offset of 16-byte word v of row r in a tile of boxes ``box``
  // bytes apart
  __device__ static __forceinline__ int word(int r, int v, int box) {
    return (v / 8) * box + r * 128 + (((v % 8) ^ (r % 8)) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d (16 x 8, float32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
// (p0, p1) as bf16 pairs hi = bf16(p) and lo = bf16(p - hi)
__device__ __forceinline__ void split_hi_lo(float p0, float p1, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}
__device__ __forceinline__ void pair_barrier(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}
// this thread's shared-memory writes (st.shared, cp.async), visible to
// the tensor cores' reads (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major operand with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of the scores across the
// asynchronous wgmma that writes them
__device__ __forceinline__ void fence_regs(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (64 x 32, float32) (+)= A (64 x 16, shared) B (16 x 32, shared), both
// K-major; scale_d = 0 overwrites d. Warp w of the warpgroup holds rows
// 16 w + lane / 4 (+ 8) and columns 8 n + 2 (lane % 4) (+ 1) at
// d[4 n .. 4 n + 3], the layout of mma.sync's accumulator.
__device__ __forceinline__ void wgmma_s(float (&d)[16], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Row r of a tile of boxes ``box`` bytes apart from a latent row c (RL
// values) and a rope row kr (DR values), or zeros where c is null: this
// thread's words part, part + kParts, ... (kParts threads share a row, so
// each computes its row's addresses once).
template <int RL, int DR, int kParts>
__device__ __forceinline__ void copy_row(uint8_t* tile, int r, int box,
                                         const __nv_bfloat16* c,
                                         const __nv_bfloat16* kr, int part) {
  using L = Layout<RL, DR>;
#pragma unroll
  for (int j = 0; j < (L::kWords + kParts - 1) / kParts; ++j) {
    const int v = part + j * kParts;
    if (v >= L::kWords) break;
    uint8_t* dst = tile + L::word(r, v, box);
    if (c == nullptr)
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    else
      cp_async16(dst, v < RL / 8 ? c + v * 8 : kr + (v - RL / 8) * 8);
  }
}

// Keys k0 .. k0 + nk - 1 as merged [c_kv | k_rope] bf16 rows into one
// stage, by 16-byte cp.async, kKeyParts threads a key; rows nk .. kKeys - 1
// are zeroed (their probabilities are 0, and 0 times a stale value could
// be NaN). A key at position p >= base is window row p - base of
// c_new/kr_new, any other is read through the staged table. The loop
// strides by blockDim.x (one pass with kThreads threads).
constexpr int kKeyParts = kThreads / kKeys;
template <int RL, int DR>
__device__ __forceinline__ void stage_keys(
    uint8_t* stage, const __nv_bfloat16* c_pool,
    const __nv_bfloat16* kr_pool, const __nv_bfloat16* c_new,
    const __nv_bfloat16* kr_new, const int* tab_s, int b, int base, int W,
    int bs, int k0, int nk) {
  using L = Layout<RL, DR>;
  for (int i = threadIdx.x; i < kKeys * kKeyParts; i += blockDim.x) {
    const int t = i / kKeyParts, part = i % kKeyParts;
    const int pos = k0 + t;
    if (t >= nk) {
      copy_row<RL, DR, kKeyParts>(stage, t, L::kKBox, nullptr, nullptr,
                                  part);
    } else if (pos >= base) {
      const size_t row = (size_t)b * W + pos - base;
      copy_row<RL, DR, kKeyParts>(stage, t, L::kKBox, c_new + row * RL,
                                  kr_new + row * DR, part);
    } else {
      const size_t row = (size_t)tab_s[pos / bs] * bs + pos % bs;
      copy_row<RL, DR, kKeyParts>(stage, t, L::kKBox, c_pool + row * RL,
                                  kr_pool + row * DR, part);
    }
  }
  cp_async_commit();
}

// NB: n-blocks of 8 value columns a warp accumulates; the CTA's column
// share is 16 NB wide, so the grid's column splits are RL / (16 NB).
template <int RL, int DR, int NB>
__global__ void __launch_bounds__(kThreads, 1)
paged_latent_tc_kernel(const __nv_bfloat16* __restrict__ q_lat,
                       const __nv_bfloat16* __restrict__ q_rope, QStrides sl,
                       QStrides sr, __nv_bfloat16* __restrict__ c_pool,
                       __nv_bfloat16* __restrict__ kr_pool,
                       const __nv_bfloat16* __restrict__ c_new,
                       const __nv_bfloat16* __restrict__ kr_new,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out, int W, int H, int bs,
                       int nb, float scale) {
  using L = Layout<RL, DR>;
  static_assert(NB % 2 == 0 && (RL / (16 * NB)) * 16 * NB == RL,
                "column share: pairs of n-blocks, dividing r");
  const int b = blockIdx.z;
  const int R = H * W;
  const int row0 = blockIdx.x * kRows;
  const int nr = min(kRows, R - row0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(128) uint8_t tc_smem[];
  // the swizzle wants 1024-byte aligned boxes
  uint8_t* q_s = tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023);
  uint8_t* k_s = q_s + L::kQBytes;                     // two stages
  float* x_s = reinterpret_cast<float*>(k_s + 2 * L::kStageBytes);
  int* tab_s = reinterpret_cast<int*>(x_s + L::kXFloats);

  const int base = lengths[b];
  // the query rows, [q_lat | q_rope], read in place, kQParts threads a
  // row; rows past R zero
  constexpr int kQParts = kThreads / kRows;
  for (int i = tid; i < kRows * kQParts; i += blockDim.x) {
    const int rr = i / kQParts, part = i % kQParts;
    if (rr >= nr) {
      copy_row<RL, DR, kQParts>(q_s, rr, L::kQBox, nullptr, nullptr, part);
      continue;
    }
    const int w = (row0 + rr) / H, h = (row0 + rr) % H;
    copy_row<RL, DR, kQParts>(q_s, rr, L::kQBox, q_lat + sl.at(b, w, h),
                              q_rope + sr.at(b, w, h), part);
  }
  const int span = nb * bs;
  // keys some row of the tile sees: [0, n_keys); cached ones below base
  const int n_keys = min(base + (row0 + nr - 1) / H + 1, span);
  const int n_tab = (min(base, n_keys) + bs - 1) / bs;
  const int* tb = tables + (size_t)b * nb;
  for (int j = tid; j < n_tab; j += blockDim.x) cp_async4(tab_s + j, tb + j);
  cp_async_commit();
  commit_window(reinterpret_cast<uint4*>(c_pool),
                reinterpret_cast<uint4*>(kr_pool),
                reinterpret_cast<const uint4*>(c_new),
                reinterpret_cast<const uint4*>(kr_new), tb, b, base, W, bs,
                nb, RL / 8, DR / 8, blockIdx.y * gridDim.x + blockIdx.x,
                gridDim.x * gridDim.y);
  cp_async_wait_all();
  __syncthreads();
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  if (n_tiles > 0)
    stage_keys<RL, DR>(k_s, c_pool, kr_pool, c_new, kr_new, tab_s, b, base,
                       W, bs, 0, min(kKeys, n_keys));

  // warp (rb, half): rows 16 rb + g and 16 rb + g + 8 of the tile, with
  // g = lane / 4; its warpgroup's k16 steps s_lo .. s_lo + n_st - 1; value
  // columns col0 .. col0 + 8 NB - 1
  const int rb = warp & 3, half = warp >> 2;
  const int g = lane / 4, c = lane % 4;
  constexpr int kMaxSteps = L::kSteps - L::kSteps / 2;
  const int s_lo = half ? L::kSteps / 2 : 0;
  const int n_st = half ? kMaxSteps : L::kSteps / 2;
  const int col0 = blockIdx.y * 16 * NB + half * 8 * NB;
  // the last key each of this thread's two rows sees (-1: a row past R)
  int last[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = rb * 16 + g + 8 * i;
    last[i] = rr < nr ? min(base + (row0 + rr) / H, n_keys - 1) : -1;
  }
  // scores in log2 units: p = 2^(x - m) with x = s * scale * log2(e)
  const float scale2 = scale * 1.4426950408889634f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this lane's row (key) and column of the transposed V fragments
  const int v_key = ((lane / 8) & 1) * 8 + lane % 8;
  const int v_col = col0 + (lane / 16) * 8;
  float* x_mine = x_s + warp * 32 * 16 + lane;
  const float* x_other = x_s + (warp ^ 4) * 32 * 16 + lane;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kKeys;
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();    // tile it has landed; the other stage is free
    const uint8_t* ks = k_s + (it & 1) * L::kStageBytes;
    // this warpgroup's half of the scores, 64 rows x 32 keys, by wgmma
    // from the swizzled query and key boxes; this warp's 16 rows land in
    // s[n] (n-block n of 8 keys), the layout of mma.sync's accumulator
    float s[4][4];
    float (&sf)[16] = reinterpret_cast<float(&)[16]>(s);
    fence_regs(sf);
    wg_fence();
#pragma unroll
    for (int j = 0; j < kMaxSteps; ++j) {
      if (j < n_st) {
        const int st = s_lo + j;
        wgmma_s(sf, desc(q_s + (st / 4) * L::kQBox + (st % 4) * 32),
                desc(ks + (st / 4) * L::kKBox + (st % 4) * 32), j > 0);
      }
    }
    wg_commit();
    // the next tile's copies are issued while the tensor cores score
    if (it + 1 < n_tiles)
      stage_keys<RL, DR>(k_s + ((it + 1) & 1) * L::kStageBytes, c_pool,
                         kr_pool, c_new, kr_new, tab_s, b, base, W, bs,
                         k0 + kKeys, min(kKeys, n_keys - k0 - kKeys));
    wg_wait_all();
    fence_regs(sf);
    // the other half from the partner warp: both form mine + other
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x_mine[(n * 4 + e) * 32] = s[n][e];
    pair_barrier(1 + rb);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += x_other[(n * 4 + e) * 32];
    // online softmax of rows g (i = 0) and g + 8 (i = 1), in float32; a
    // row's 32 keys lie in the lane quad: 4 n-blocks x 2 columns each
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNeg;
      const int lim = last[i] - k0 - 2 * c;   // visible: n * 8 + e <= lim
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = n * 8 + e <= lim ? s[n][2 * i + e] * scale2 : kNeg;
          s[n][2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p =
              n * 8 + e <= lim ? exp2f(s[n][2 * i + e] - m_new) : 0.f;
          s[n][2 * i + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float alpha = exp2f(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
      // the accumulator's rescale, skipped where no row of the warp has a
      // new maximum (alpha is then exactly 1)
      if (__any_sync(0xffffffffu, alpha != 1.f)) {
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          acc[n][2 * i] *= alpha;
          acc[n][2 * i + 1] *= alpha;
        }
      }
    }
    // P as the A operand (k = keys), split hi + lo: the score fragment of
    // n-blocks 2 kk and 2 kk + 1 is the A fragment of key step kk
    uint32_t phi[2][4], plo[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* sv = s[2 * kk + j / 2] + 2 * (j % 2);
        split_hi_lo(sv[0], sv[1], phi[kk][j], plo[kk][j]);
      }
    // O += P_hi V + P_lo V, V = the tile's c_kv rows, this warp's
    // columns: a key step's V fragments first, then the hi products of
    // every n-block, then the lo ones (no product waits on the one before)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t vb[NB / 2][4];
#pragma unroll
      for (int np = 0; np < NB / 2; ++np)
        ldsm_x4_t(vb[np], ks + L::word(kk * 16 + v_key,
                                       (v_col + np * 16) / 8, L::kKBox));
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        mma(acc[2 * np], phi[kk], vb[np][0], vb[np][1]);
        mma(acc[2 * np + 1], phi[kk], vb[np][2], vb[np][3]);
      }
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        mma(acc[2 * np], plo[kk], vb[np][0], vb[np][1]);
        mma(acc[2 * np + 1], plo[kk], vb[np][2], vb[np][3]);
      }
    }
  }

  // the output tile (64 rows x 16 NB columns, bf16) through the key
  // stages, rows padded by 16 bytes, then out in 16-byte words
  constexpr int kOutRow = 32 * NB + 16;          // bytes a staged row
  static_assert(kRows * kOutRow <= 2 * L::kStageBytes, "output tile fits");
  __syncthreads();      // every warp is done with the stages
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    uint8_t* srow = k_s + (rb * 16 + g + 8 * i) * kOutRow +
                    (half * 8 * NB + 2 * c) * 2;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<__nv_bfloat162*>(srow + n * 16) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv,
                                acc[n][2 * i + 1] * inv);
  }
  __syncthreads();
  constexpr int kOutWords = 2 * NB;                // 16-byte words a row
  for (int i = tid; i < nr * kOutWords; i += blockDim.x) {
    const int rr = i / kOutWords, v = i % kOutWords;
    *reinterpret_cast<uint4*>(out + ((size_t)b * R + row0 + rr) * RL +
                              blockIdx.y * 16 * NB + v * 8) =
        *reinterpret_cast<const uint4*>(k_s + rr * kOutRow + v * 16);
  }
}

template <int RL, int DR, int NB>
int launch(const void* q_lat, const void* q_rope, QStrides sl, QStrides sr,
           void* c_pool, void* kr_pool, const void* c_new,
           const void* kr_new, const int* tables, const int* lengths,
           void* out, int B, int W, int H, int bs, int nb, float scale,
           cudaStream_t stream) {
  using T = __nv_bfloat16;
  auto kern = paged_latent_tc_kernel<RL, DR, NB>;
  const size_t bytes = Layout<RL, DR>::smem(nb);
  const int err = flash_decode::allow_smem(kern, bytes);
  if (err != 0) return err;
  dim3 grid((H * W + kRows - 1) / kRows, RL / (16 * NB), B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope), sl, sr,
      static_cast<T*>(c_pool), static_cast<T*>(kr_pool),
      static_cast<const T*>(c_new), static_cast<const T*>(kr_new), tables,
      lengths, static_cast<T*>(out), W, H, bs, nb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kThreads = 256;
constexpr int kRows = 16;          // query rows per CTA
constexpr int kKeys = 16;          // key slots per shared-memory tile
constexpr int kSplit = 16;         // lanes that split one score block's dots
constexpr int kBatch = 4;          // tile words a thread loads at a time
static_assert(kRows * kKeys == kThreads, "softmax: one thread per pair");

__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void store_f4(float* dst, const float* f) {
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
}

// Shared-memory row stride of D values, padded to 4 mod 8 words: the two
// half-warps of a score step read key rows 4 apart, which then fall on
// banks 16 apart.
__host__ __device__ constexpr int row_stride(int D) {
  return D + (12 - D % 8) % 8;
}

size_t smem_bytes(int D) {
  return ((size_t)(kRows + kKeys) * row_stride(D) + kKeys * kRows +
          3 * kRows) * sizeof(float);
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
paged_latent_f32_kernel(const float* __restrict__ q_lat,
                        const float* __restrict__ q_rope, QStrides sl,
                        QStrides sr, float* __restrict__ c_pool,
                        float* __restrict__ kr_pool,
                        const float* __restrict__ c_new,
                        const float* __restrict__ kr_new,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        float* __restrict__ out, int W, int H, int r, int dr,
                        int bs, int nb, float scale) {
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int R = H * W;
  const int D = r + dr;
  const int S = row_stride(D);
  extern __shared__ float smem[];
  float* q_s = smem;                       // kRows x S: [q_lat | q_rope]
  float* k_s = q_s + kRows * S;            // kKeys x S: [c_kv | k_rope]
  float* p_s = k_s + kKeys * S;            // kKeys x kRows scores, then p
  float* m_s = p_s + kKeys * kRows;        // running max per row
  float* l_s = m_s + kRows;                // running sum per row
  float* a_s = l_s + kRows;                // this tile's rescale per row

  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, R - row0);
  const int base = lengths[b];
  // rows move in 16-byte words of 4 values: rv latent words, then dv rope
  // words
  const int rv = r / 4, dv = dr / 4, DV = rv + dv;
  for (int i = tid; i < kRows * DV; i += kThreads) {
    const int rr = i / DV, v = i - rr * DV;
    float f[4] = {0.f, 0.f, 0.f, 0.f};     // rows past R stay zero
    if (rr < nrows) {
      const int w = (row0 + rr) / H, h = (row0 + rr) % H;
      unpack(*reinterpret_cast<const uint4*>(
                 v < rv ? q_lat + sl.at(b, w, h) + 4 * v
                        : q_rope + sr.at(b, w, h) + 4 * (v - rv)),
             f);
    }
    store_f4(q_s + rr * S + v * 4, f);
  }
  if (tid < kRows) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[kRows][NC];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[rr][n] = 0.f;

  uint4* c4 = reinterpret_cast<uint4*>(c_pool);
  uint4* kr4 = reinterpret_cast<uint4*>(kr_pool);
  const uint4* cn4 = reinterpret_cast<const uint4*>(c_new);
  const uint4* krn4 = reinterpret_cast<const uint4*>(kr_new);
  const int* tb = tables + (size_t)b * nb;
  commit_window(c4, kr4, cn4, krn4, tb, b, base, W, bs, nb, rv, dv,
                blockIdx.x, gridDim.x);
  // the last query position of the tile, capped at the table's span
  const int last_pos = min(base + (row0 + nrows - 1) / H, nb * bs - 1);
  const int j_hi = last_pos / bs;
  // this thread's 4 x 4 score block and its share of the dot products
  const int warp = tid >> 5, lane = tid & 31;
  const int rb = 4 * (warp >> 1);                       // first row
  const int kb = 4 * (((warp & 1) << 1) | (lane >> 4));  // first slot
  const int sp = lane & (kSplit - 1);
  __syncthreads();

  for (int j = 0; j <= j_hi; ++j) {
    const int phys = tb[j];
    for (int s0 = 0; s0 < bs; s0 += kKeys) {
      const int k0 = j * bs + s0;          // logical position of slot s0
      if (k0 > last_pos) break;            // past every query: skip
      const int nk = min(kKeys, bs - s0);
      // stage the merged tile, window slots from the fresh rows; each
      // thread issues kBatch word loads before it stores any; words of
      // absent slots stay zero
      for (int i0 = tid; i0 < kKeys * DV; i0 += kBatch * kThreads) {
        uint4 u[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = i0 + k * kThreads;
          const int t = i / DV, v = i - t * DV;
          const int pos = k0 + t;
          const int off = pos - base;
          u[k] = make_uint4(0u, 0u, 0u, 0u);
          if (i < kKeys * DV && t < nk && pos <= last_pos) {
            const bool lat = v < rv;
            if (off >= 0) {
              const size_t nrow = (size_t)b * W + off;
              u[k] = lat ? cn4[nrow * rv + v] : krn4[nrow * dv + v - rv];
            } else {
              const size_t slot = (size_t)phys * bs + s0 + t;
              u[k] = lat ? c4[slot * rv + v] : kr4[slot * dv + v - rv];
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = i0 + k * kThreads;
          if (i >= kKeys * DV) break;
          float f[4];
          unpack(u[k], f);
          const int t = i / DV;
          store_f4(k_s + t * S + (i - t * DV) * 4, f);
        }
      }
      __syncthreads();
      // scores of the 4 x 4 block, the dot products split over 16 lanes
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) sc[i][u] = 0.f;
      for (int c = sp; c < D; c += kSplit) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = q_s[(rb + i) * S + c];
#pragma unroll
        for (int u = 0; u < 4; ++u) kv[u] = k_s[(kb + u) * S + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u) sc[i][u] += qv[i] * kv[u];
      }
#pragma unroll
      for (int o = kSplit / 2; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            sc[i][u] += __shfl_xor_sync(0xffffffffu, sc[i][u], o);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i * 4 + u == sp) p_s[(kb + u) * kRows + rb + i] = sc[i][u] * scale;
      __syncthreads();
      // online softmax, one thread per (row, slot) and a half-warp per
      // row: new running max, rescale factor, probabilities (exactly 0 on
      // masked slots), their sum
      {
        const int rr = tid >> 4, t = tid & (kKeys - 1);
        const int qpos = base + (row0 + rr) / H;
        const bool vis = t < nk && k0 + t <= qpos && k0 + t <= last_pos;
        const float sv = vis ? p_s[t * kRows + rr] : kNeg;
        float mc = sv;
#pragma unroll
        for (int o = kKeys / 2; o > 0; o >>= 1)
          mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, o));
        const float m_prev = m_s[rr];
        const float m_new = fmaxf(m_prev, mc);
        const float p = vis ? expf(sv - m_new) : 0.f;
        p_s[t * kRows + rr] = p;
        float sum = p;
#pragma unroll
        for (int o = kKeys / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (t == 0) {                      // every lane has read m_s[rr]
          const float alpha = expf(m_prev - m_new);
          l_s[rr] = alpha * l_s[rr] + sum;
          m_s[rr] = m_new;
          a_s[rr] = alpha;
        }
      }
      __syncthreads();
      // acc = acc * alpha + p @ V, V = the tile's latent half
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float alpha = a_s[rr];
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[rr][n] *= alpha;
      }
      for (int t = 0; t < nk; ++t) {
        float vv[NC];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int c = tid + n * kThreads;
          vv[n] = c < r ? k_s[t * S + c] : 0.f;
        }
        const float4* pt = reinterpret_cast<const float4*>(p_s + t * kRows);
#pragma unroll
        for (int q4 = 0; q4 < kRows / 4; ++q4) {
          const float4 p = pt[q4];
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            acc[4 * q4 + 0][n] += p.x * vv[n];
            acc[4 * q4 + 1][n] += p.y * vv[n];
            acc[4 * q4 + 2][n] += p.z * vv[n];
            acc[4 * q4 + 3][n] += p.w * vv[n];
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    if (rr >= nrows) break;
    const float l = fmaxf(l_s[rr], 1e-30f);
    float* orow = out + ((size_t)b * R + row0 + rr) * r;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = tid + n * kThreads;
      if (c < r) orow[c] = acc[rr][n] / l;
    }
  }
}

template <int NC>
int launch(const void* q_lat, const void* q_rope, QStrides sl, QStrides sr,
           void* c_pool, void* kr_pool, const void* c_new,
           const void* kr_new, const int* tables, const int* lengths,
           void* out, int B, int W, int H, int r, int dr, int bs, int nb,
           float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(r + dr);
  auto kern = paged_latent_f32_kernel<NC>;
  const int err = flash_decode::allow_smem(kern, bytes);
  if (err != 0) return err;
  dim3 grid((H * W + kRows - 1) / kRows, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      sl, sr, static_cast<float*>(c_pool), static_cast<float*>(kr_pool),
      static_cast<const float*>(c_new), static_cast<const float*>(kr_new),
      tables, lengths, static_cast<float*>(out), W, H, r, dr, bs, nb, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// q_lat (B, W, H, r) and q_rope (B, W, H, dr), read through their (b, w, h)
// element strides (sl_*, sr_*; the last axis contiguous, rows 16-byte
// aligned); pools (P, bs, r) and (P, bs, dr), written in place; c_new
// (B, W, r), kr_new (B, W, dr); tables (B, nb), lengths (B,) int32; out
// (B, W, H, r) contiguous. All of one dtype: 0 = float32 (any r <= 512
// and dr that fill 16-byte words), 1 = bfloat16 ((r, dr) = (512, 64) with
// 2 or 4 column splits, or (32, 16) with 1). ``col_splits`` is ignored in
// float32.
extern "C" int paged_latent_launch(
    const void* q_lat, const void* q_rope, void* c_pool, void* kr_pool,
    const void* c_new, const void* kr_new, const int* tables,
    const int* lengths, void* out, int B, int W, int H, int r, int dr,
    int bs, int nb, float scale, int dtype, long long sl_b, long long sl_w,
    long long sl_h, long long sr_b, long long sr_w, long long sr_h,
    int col_splits, cudaStream_t stream) {
  const QStrides sl{sl_b, sl_w, sl_h}, sr{sr_b, sr_w, sr_h};
  if (dtype == 0) {
    if (r <= f32::kThreads)
      return f32::launch<1>(q_lat, q_rope, sl, sr, c_pool, kr_pool, c_new,
                            kr_new, tables, lengths, out, B, W, H, r, dr, bs,
                            nb, scale, stream);
    if (r <= 2 * f32::kThreads)
      return f32::launch<2>(q_lat, q_rope, sl, sr, c_pool, kr_pool, c_new,
                            kr_new, tables, lengths, out, B, W, H, r, dr, bs,
                            nb, scale, stream);
  } else if (dtype == 1) {
    if (r == 512 && dr == 64 && col_splits == 4)
      return tc::launch<512, 64, 8>(q_lat, q_rope, sl, sr, c_pool, kr_pool,
                                    c_new, kr_new, tables, lengths, out, B, W,
                                    H, bs, nb, scale, stream);
    if (r == 512 && dr == 64 && col_splits == 2)
      return tc::launch<512, 64, 16>(q_lat, q_rope, sl, sr, c_pool, kr_pool,
                                     c_new, kr_new, tables, lengths, out, B,
                                     W, H, bs, nb, scale, stream);
    if (r == 32 && dr == 16 && col_splits == 1)
      return tc::launch<32, 16, 2>(q_lat, q_rope, sl, sr, c_pool, kr_pool,
                                   c_new, kr_new, tables, lengths, out, B, W,
                                   H, bs, nb, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
