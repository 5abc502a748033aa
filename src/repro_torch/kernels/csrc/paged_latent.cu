// Paged multi-head latent attention (MLA) decode over the absorbed latent
// cache, with the window writeback of both latent pools fused in.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py :
// paged_latent_kernel (_paged_kernel with latent=True, _merge_window,
// _pool_out_map).
//
// Computes, for each sequence b, the attention of its R = H*W query rows
// (row = h*W + w, query position lengths[b] + w) over the latent cache
// reached through the block table tables[b, :]. A key slot holds the
// compressed latent c_kv (r values) and the shared rope key k_rope (dr
// values); the score of a row against a slot is
// (q_lat . c_kv + q_rope . k_rope) * scale, and the merged c_kv row is
// also the value, so the output is the attention-weighted latent (R x r).
// The W fresh window latents c_new/kr_new[b] take the place of the pool
// slots at logical positions [lengths[b], lengths[b] + W), and are
// committed into both pools in place. Mask: k_pos <= q_pos. Softmax online,
// in float32; masked slots contribute exactly 0.
//
// Bound on the H100: memory at the serving shapes. Per sequence the op
// must read the cached latents once (len * (r + dr) values), the query
// rows (R * (r + dr)) and the fresh rows, and write the output (R * r) and
// the window slots; the arithmetic is 2 * R * len * (2r + dr) flops, which
// at R = 1024 (128 heads x W = 8) is ~50x the bytes in float32 flops.
//
// Why not paged_decode.cu's layout: one latent "kv head" serves all 128
// heads, so a sequence has 1024 query rows at W = 8 and 8192 in a 64-wide
// prefill chunk; their float32 accumulators (2 MB, 16 MB) do not fit in
// one CTA's shared memory. Design (simple first): the grid is
// (ceil(R / kRows), B); each CTA takes kRows = 16 query rows of one
// sequence, so the grid, not shared memory, grows with W. It loops over
// the sequence's visible blocks (tiles past the last query position are
// skipped) kKeys = 16 slots at a time: stage the merged [c_kv | k_rope]
// tile in shared memory as float32, window slots from c_new/kr_new, moved
// in 16-byte words (so r and dr must fill whole words: the wrapper checks,
// and the commit is a copy of those words, bitwise); score
// the 16 x 16 (row, slot) pairs (each 16-lane half-warp owns a 4 x 4 block
// and splits the 576-long dot product 16 ways, then reduces with
// shuffles); update the running max and sum of each row in a half-warp;
// and accumulate p @ V into registers, each thread owning NC latent
// columns of all 16 rows.
// Only the CTA that holds row tile 0 of a sequence writes the window slots
// into the pools, and it writes only those slots; no CTA reads a pool slot
// at or past lengths[b], so no CTA reads what another writes. Rows whose
// table is all zero (empty batch slots, lengths 0) read no pool slot and
// commit into the sink block 0, whose contents are garbage by design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;          // query rows per CTA
constexpr int kKeys = 16;          // key slots per shared-memory tile
constexpr int kSplit = 16;         // lanes that split one score block's dots
constexpr int kBatch = 4;          // tile words a thread loads at a time
static_assert(kRows * kKeys == kThreads, "softmax: one thread per pair");
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

// The kVec = 16 / sizeof(T) values of a 16-byte word, as float32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(T); ++e) f[e] = to_f(x[e]);
}

template <int N>
__device__ __forceinline__ void store_f4(float* dst, const float* f) {
#pragma unroll
  for (int e = 0; e < N; e += 4)
    *reinterpret_cast<float4*>(dst + e) =
        make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
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

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
paged_latent_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                    T* __restrict__ c_pool, T* __restrict__ kr_pool,
                    const T* __restrict__ c_new, const T* __restrict__ kr_new,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int R, int W, int r, int dr, int bs, int nb,
                    float scale) {
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
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
  // rows move in 16-byte words of kVec values: rv latent words, then dv
  // rope words
  constexpr int kVec = 16 / sizeof(T);
  const int rv = r / kVec, dv = dr / kVec, DV = rv + dv;
  const uint4* ql4 = reinterpret_cast<const uint4*>(q_lat);
  const uint4* qr4 = reinterpret_cast<const uint4*>(q_rope);
  for (int i = tid; i < kRows * DV; i += kThreads) {
    const int rr = i / DV, v = i - rr * DV;
    float f[kVec];
    if (rr < nrows) {
      const size_t row = (size_t)b * R + row0 + rr;
      unpack<T>(v < rv ? ql4[row * rv + v] : qr4[row * dv + v - rv], f);
    } else {                               // rows past R stay zero
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.f;
    }
    store_f4<kVec>(q_s + rr * S + v * kVec, f);
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
  const int last_pos = base + W - 1;       // the last query position
  const int j_hi = min(last_pos / bs, nb - 1);
  const int* tb = tables + (size_t)b * nb;
  const bool commit = blockIdx.x == 0;
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
      // stage the merged tile; window slots come from the fresh rows and
      // row tile 0 commits them; slots past every query are zero
      // each thread issues kBatch word loads before it stores any (the
      // commit stores could alias later pool loads, which would otherwise
      // wait for them); words of absent slots stay zero
      for (int i0 = tid; i0 < kKeys * DV; i0 += kBatch * kThreads) {
        uint4 u[kBatch];
        uint4* dst[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = i0 + k * kThreads;
          const int t = i / DV, v = i - t * DV;
          const int pos = k0 + t;
          const int off = pos - base;
          u[k] = make_uint4(0u, 0u, 0u, 0u);
          dst[k] = nullptr;
          if (i < kKeys * DV && t < nk && pos <= last_pos) {
            const bool lat = v < rv;
            const size_t slot = (size_t)phys * bs + s0 + t;
            uint4* pool_w = lat ? c4 + slot * rv + v
                                : kr4 + slot * dv + v - rv;
            if (off >= 0) {                // off < W since pos <= last_pos
              const size_t nrow = (size_t)b * W + off;
              u[k] = lat ? cn4[nrow * rv + v] : krn4[nrow * dv + v - rv];
              if (commit) dst[k] = pool_w;
            } else {
              u[k] = *pool_w;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = i0 + k * kThreads;
          if (i >= kKeys * DV) break;
          if (dst[k] != nullptr) *dst[k] = u[k];
          float f[kVec];
          unpack<T>(u[k], f);
          const int t = i / DV;
          store_f4<kVec>(k_s + t * S + (i - t * DV) * kVec, f);
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
        const int qpos = base + (row0 + rr) % W;
        const bool vis = t < nk && k0 + t <= qpos;
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
    T* orow = out + ((size_t)b * R + row0 + rr) * r;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = tid + n * kThreads;
      if (c < r) orow[c] = from_f<T>(acc[rr][n] / l);
    }
  }
}

template <typename T, int NC>
int launch(const void* q_lat, const void* q_rope, void* c_pool,
           void* kr_pool, const void* c_new, const void* kr_new,
           const int* tables, const int* lengths, void* out, int B, int R,
           int W, int r, int dr, int bs, int nb, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(r + dr);
  auto kern = paged_latent_kernel<T, NC>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) {      // more than a block may hold: report it
      cudaGetLastError();           // and leave no stale error behind
      return static_cast<int>(err);
    }
  }
  dim3 grid((R + kRows - 1) / kRows, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<T*>(c_pool), static_cast<T*>(kr_pool),
      static_cast<const T*>(c_new), static_cast<const T*>(kr_new), tables,
      lengths, static_cast<T*>(out), R, W, r, dr, bs, nb, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_cols(const void* q_lat, const void* q_rope, void* c_pool,
                void* kr_pool, const void* c_new, const void* kr_new,
                const int* tables, const int* lengths, void* out, int B,
                int R, int W, int r, int dr, int bs, int nb, float scale,
                cudaStream_t stream) {
  if (r <= kThreads)
    return launch<T, 1>(q_lat, q_rope, c_pool, kr_pool, c_new, kr_new,
                        tables, lengths, out, B, R, W, r, dr, bs, nb, scale,
                        stream);
  if (r <= 2 * kThreads)
    return launch<T, 2>(q_lat, q_rope, c_pool, kr_pool, c_new, kr_new,
                        tables, lengths, out, B, R, W, r, dr, bs, nb, scale,
                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q_lat (B, R, r) and q_rope (B, R, dr) with row = h*W + w; pools
// (P, bs, r) and (P, bs, dr), written in place; c_new (B, W, r), kr_new
// (B, W, dr); tables (B, nb), lengths (B,) int32; out (B, R, r). All of
// one dtype: 0 = float32, 1 = bfloat16. r must be at most 512; rows of r
// and of dr values must be multiples of 16 bytes and every pointer 16-byte
// aligned (the wrapper checks).
extern "C" int paged_latent_launch(const void* q_lat, const void* q_rope,
                                   void* c_pool, void* kr_pool,
                                   const void* c_new, const void* kr_new,
                                   const int* tables, const int* lengths,
                                   void* out, int B, int R, int W, int r,
                                   int dr, int bs, int nb, float scale,
                                   int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch_cols<float>(q_lat, q_rope, c_pool, kr_pool, c_new, kr_new,
                              tables, lengths, out, B, R, W, r, dr, bs, nb,
                              scale, stream);
  if (dtype == 1)
    return launch_cols<__nv_bfloat16>(q_lat, q_rope, c_pool, kr_pool, c_new,
                                      kr_new, tables, lengths, out, B, R, W,
                                      r, dr, bs, nb, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
