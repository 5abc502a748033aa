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
// rate, 15 us at the memory rate.
//
// Head widths: 64 (musicgen, internvl), 128 (qwen, dbrx, mistral) and 256
// (gemma), both paths templated on D. Shared memory sets the key tile: at
// D = 256 a 128-key bf16 tile is 64 KB, and Q (64 KB) plus a 2-stage ring
// of such K and V tiles would need 320 KB of the 227 KB a block may use, so
// D = 256 takes 64-key tiles (Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB);
// a row is four 64-column boxes in place of two, and the O accumulator two
// 128-column halves (64 x 256 float32 over a warpgroup: 128 registers a
// thread, and 64 for a 64-key S and its P hi + lo, where D = 128 spends 64
// on O and 128 on S and P: 192 either way, under setmaxnreg's 240). D = 64
// keeps D = 128's 128-key tiles (Q 16 KB + 2 x (K 16 KB + V 16 KB) = 80
// KB): the S tile and the P hi + lo registers are D = 128's, the steps
// along d half as many, and O is one 64-column block (32 registers a
// thread, the n = 64 form of the P V product) in place of a 128-column
// half. Wider key tiles than 128 would not shorten the loop's critical
// path (each tile's softmax waits on its S) and cost S registers.
//
// bfloat16 (the training path): a Hopper tensor-core kernel. One CTA of
// three warpgroups per (128-row query tile, query head, sequence), the
// tiles with the most keys first. Warpgroup 0 is the producer: one
// thread starts the TMA loads of the Q tile and of a two-stage ring of
// kBN-key K and V tiles (4-D tensor maps over (d, heads, T, B), so rows
// past T arrive as zeros; 128-byte swizzle, a head as D / 64 boxes of 64
// columns), each stage behind a full and an empty mbarrier; it then gives
// its registers to the consumers (setmaxnreg). Warpgroups 1 and 2 each own
// 64 query rows: S = Q K^T by wgmma from shared memory (both K-major), the
// mask, the online softmax in float32 registers (exp2 of pre-scaled
// scores), then O += P V by wgmma with P as the register A operand and V
// from shared memory (MN-major, the transpose bit). Key tiles wholly above
// the diagonal or below the window are never loaded; keys past T are
// masked like the causal ones.
//
// P V stays float32-exact: the reference multiplies float32 p by v. P
// rounded to bfloat16 before the product (as SDPA does) parts from it by
// up to 20x the output's one-ulp tolerance; so P is split into
// hi = bf16(p) and lo = bf16(p - hi) and both are multiplied by V (bf16,
// exact) into the float32 accumulator: 1.5x the tensor-core work of a
// plain flash attention (a ~52 us floor at peak), and the output agrees
// with the float32 plain version to one output rounding. Q K^T from bf16
// inputs with float32 accumulation equals the float32 product up to
// summation order.
//
// float32: the tensor cores' float32 path is TF32 (10-bit mantissa), which
// cannot meet the float32 tolerance (1e-5), so float32 inputs keep the
// CUDA-core kernel: one CTA of 256 threads per (64-row query tile, query
// head, sequence), K and V staged in shared memory as float32 64 keys at a
// time, the scores and p V as float32 fmaf, bound by the CUDA cores' 67
// TFLOP/s (at D = 256 its tiles take 214.5 KB of shared memory). Only
// tests and the plain parity paths call it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr float kNeg = -1.0e30f;   // running-max start, as the reference

__device__ __forceinline__ bool visible(int kpos, int qpos, int T,
                                        int window) {
  return kpos <= qpos && kpos < T && (window <= 0 || kpos > qpos - window);
}

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kBQ = 64;            // query rows per CTA
constexpr int kBK = 64;            // keys per shared-memory tile
constexpr int kThreads = 256;
constexpr int kPP = kBK + 1;       // padded row of the score tile

// shared floats at head width D: the Q and K tiles (rows padded to D + 1),
// V, the scores and the per-row max, sum and rescale factor
template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * kPP + 3 * kBQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
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
  constexpr int kQP = D + 1;          // padded row of the Q and K tiles
  constexpr int kC = D / 16;          // output columns a thread

  extern __shared__ float smem[];
  float* q_s = smem;                          // kBQ x kQP
  float* k_s = q_s + (size_t)kBQ * kQP;       // kBK x kQP
  float* v_s = k_s + (size_t)kBK * kQP;       // kBK x D
  float* p_s = v_s + (size_t)kBK * D;         // kBQ x kPP scores, then p
  float* m_s = p_s + (size_t)kBQ * kPP;       // running max per row
  float* l_s = m_s + kBQ;                     // running sum per row
  float* a_s = l_s + kBQ;                     // this tile's rescale factor

  const size_t q_stride = (size_t)H * D;      // between positions
  const size_t kv_stride = (size_t)KV * D;
  const float* qb = q + ((size_t)b * Tn * H + h) * D;
  const float* kb = k + ((size_t)b * Tn * KV + hk) * D;
  const float* vb = v + ((size_t)b * Tn * KV + hk) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int pos = q0 + r;
    q_s[r * kQP + c] = pos < Tn ? qb[pos * q_stride + c] : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) acc[i][j] = 0.f;

  const int q_last = min(q0 + kBQ - 1, Tn - 1);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_lo = k_first / kBK;
  const int kt_hi = q_last / kBK;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();      // the previous tile's k_s, v_s, p_s are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int pos = k0 + r;
      const bool in = pos < Tn;
      k_s[r * kQP + c] = in ? kb[pos * kv_stride + c] : 0.f;
      v_s[r * D + c] = in ? vb[pos * kv_stride + c] : 0.f;
    }
    __syncthreads();
    // scores of rows ty + 16i against keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
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
      for (int j = 0; j < kC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float pv[4], vv[kC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kPP + t];
#pragma unroll
      for (int j = 0; j < kC; ++j) vv[j] = v_s[t * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  // l_s and m_s were last written before the final __syncthreads
  float* ob = o + ((size_t)b * Tn * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int pos = q0 + r;
    if (pos >= Tn) continue;
    const float inv_l = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kC; ++j)
      ob[pos * q_stride + tx + 16 * j] = acc[i][j] * inv_l;
  }
  if (tid < kBQ && q0 + tid < Tn)
    lse[((size_t)b * H + h) * Tn + q0 + tid] =
        m_s[tid] + logf(l_s[tid]);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Tn, int H, int KV, int window, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  dim3 grid((Tn + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Tn, H, KV,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel (TMA, wgmma, warp specialisation)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBM = 128;           // query rows per CTA (two warpgroups)
constexpr int kStages = 2;         // K/V ring depth
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kBox = 64;           // bf16 columns per 128-byte swizzled row

// The shared-memory plan at head width D: the Q tile (kBM rows) and a
// kStages ring of K and V tiles (kBN keys), each row as D / 64 boxes of 64
// columns, box after box; then the barriers.
template <int D>
struct Plan {
  static constexpr int kBN = D == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int kBoxes = D / kBox;          // boxes per row
  static constexpr int kQBox = kBM * 128;          // one Q box: 16 KB
  static constexpr int kKBox = kBN * 128;          // one K or V box
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKBox;  // one K or V tile
  static constexpr int kKOff = kQBytes;            // K of stage s at + s*2*tile
  static constexpr int kBarOff = kQBytes + kStages * 2 * kKVBytes;
  static constexpr int kSmem = kBarOff + 64 + 1024;  // barriers, alignment
  static constexpr int kS = kBN / 2;               // score floats a thread
  static constexpr int kON = D < 128 ? D : 128;    // columns of one O block
  static constexpr int kHalves = D / kON;          // O blocks: 1 or 2
  static constexpr int kOAcc = kON / 2;            // O floats a thread
  static_assert(kSmem <= 232448, "a block's shared memory on the H100");
};
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// waits until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands (Q,
// K): rows of 128 bytes, 8-row groups ``sbo`` = 1024 bytes apart, ``lbo``
// unused. MN-major (V): ``lbo`` = the distance between the two 64-column
// boxes a 128-column product reads, ``sbo`` = 1024 between groups of 8
// keys.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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
// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that reads or writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32 ACC8(0), ACC8(8), ACC8(16), ACC8(24)
#define ACC64                                                          \
  ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),  \
      ACC8(56)
#define D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"
#define D64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, float32) (+)= A (64 x 16, shared, K-major) B (16 x 128,
// shared, K-major); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, float32) (+)= A (64 x 16, shared, K-major) B (16 x 64,
// shared, K-major): the scores of a 64-key tile
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, float32) += A (64 x 16, registers) B (16 x 128, shared,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, float32) += A (64 x 16, registers) B (16 x 64, shared,
// MN-major: the transpose bit): the O block at head width 64
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int Tn, int H, int KV,
                       int window, float scale) {
  using P = Plan<D>;
  constexpr int kBN = P::kBN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint8_t* q_s = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P::kBarOff);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;              // kStages
  uint64_t* empty = bars + 1 + kStages;   // kStages

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;   // the most keys first
  const int hk = h / (H / KV);
  const int q0 = tile * kBM;
  const int q_last = min(q0 + kBM - 1, Tn - 1);
  const int kt_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / kBN;
  const int n_tiles = q_last / kBN - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, P::kQBytes);
      for (int x = 0; x < P::kBoxes; ++x)
        tma_load(q_s + x * P::kQBox, &tq, q_full, x * kBox, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const int ph = (i / kStages) & 1;
        const int k0 = (kt_lo + i) * kBN;
        uint8_t* k_s = smem + P::kKOff + st * 2 * P::kKVBytes;
        uint8_t* v_s = k_s + P::kKVBytes;
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], 2 * P::kKVBytes);
        for (int x = 0; x < P::kBoxes; ++x) {
          tma_load(k_s + x * P::kKBox, &tk, &full[st], x * kBox, hk, k0, b);
          tma_load(v_s + x * P::kKBox, &tv, &full[st], x * kBox, hk, k0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;                     // 0 or 1
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // this thread's rows: row0 + 8 r for r = 0, 1
    const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;
    const int col0 = 2 * (lane % 4);           // + 8 c + (0, 1)
    const int wg_lo = q0 + cw * 64;            // this warpgroup's rows
    const int wg_hi = wg_lo + 63;
    const float sl2 = scale * kLog2e;          // scores in log2 units
    float acc[P::kHalves][P::kOAcc];           // O columns kON x + ...
#pragma unroll
    for (int x = 0; x < P::kHalves; ++x)
#pragma unroll
      for (int i = 0; i < P::kOAcc; ++i) acc[x][i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    const uint8_t* qa = q_s + cw * 64 * 128;   // 64 rows of each box
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const int ph = (i / kStages) & 1;
      const int k0 = (kt_lo + i) * kBN;
      const uint8_t* k_s = smem + P::kKOff + st * 2 * P::kKVBytes;
      const uint8_t* v_s = k_s + P::kKVBytes;
      mbar_wait(&full[st], ph);

      // S = Q K^T: D / 16 steps of 16 along d, 4 in each 64-column box
      float s[P::kS];
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int in_box = (ks % 4) * 32;
        wgmma_ss(s, desc(qa + (ks / 4) * P::kQBox + in_box, 0, 1024),
                 desc(k_s + (ks / 4) * P::kKBox + in_box, 0, 1024), ks > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(s);

      // mask, online softmax (log2 units), rescale of the accumulator
      const bool masked = k0 + kBN - 1 > wg_lo || k0 + kBN > Tn ||
                          (window > 0 && k0 <= wg_hi - window);
      float mc[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < P::kS; ++j) {
        const int r = (j >> 1) & 1;
        float x = s[j] * sl2;
        if (masked) {
          const int kpos = k0 + 8 * (j >> 2) + col0 + (j & 1);
          if (!visible(kpos, row0 + 8 * r, Tn, window)) x = kNeg;
        }
        s[j] = x;
        mc[r] = fmaxf(mc[r], x);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
        mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
        const float m_new = fmaxf(m[r], mc[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      // P as the A operand of the next product, split hi + lo: register
      // e of k-step kk holds columns 16 kk + ... of elements
      // s[8 kk + 2 e], s[8 kk + 2 e + 1], the accumulator's own order
      uint32_t phi[kBN / 16][4], plo[kBN / 16][4];
#pragma unroll
      for (int e = 0; e < P::kS / 2; ++e) {
        const int r = e & 1;
        float p0 = s[2 * e] == kNeg ? 0.f : exp2f(s[2 * e] - m[r]);
        float p1 =
            s[2 * e + 1] == kNeg ? 0.f : exp2f(s[2 * e + 1] - m[r]);
        sum[r] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        phi[e / 4][e % 4] = pack_bf16(hi);
        plo[e / 4][e % 4] = pack_bf16(lo);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int x = 0; x < P::kHalves; ++x)
#pragma unroll
        for (int j = 0; j < P::kOAcc; ++j) acc[x][j] *= alpha[(j >> 1) & 1];

      // O += P_hi V + P_lo V: kBN / 16 steps of 16 keys, each 16 rows of
      // V; each 128-column half of O reads its two boxes of V (at D = 64
      // the one block reads the one box, and lbo goes unused)
#pragma unroll
      for (int x = 0; x < P::kHalves; ++x) fence_regs(acc[x]);
      wg_fence();
#pragma unroll
      for (int x = 0; x < P::kHalves; ++x) {
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          const uint64_t dv =
              desc(v_s + 2 * x * P::kKBox + kk * 16 * 128, P::kKBox, 1024);
          wgmma_rs(acc[x], phi[kk], dv);
          wgmma_rs(acc[x], plo[kk], dv);
        }
      }
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int x = 0; x < P::kHalves; ++x) fence_regs(acc[x]);
      mbar_arrive(&empty[st]);
    }

    // epilogue: o = acc / l in bf16, lse = m ln 2 + log l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = row0 + 8 * r;
      if (pos >= Tn) continue;
      const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = o + (((size_t)b * Tn + pos) * H + h) * D;
#pragma unroll
      for (int x = 0; x < P::kHalves; ++x)
#pragma unroll
        for (int c = 0; c < P::kON / 8; ++c) {
          const int j = 4 * c + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(orow + P::kON * x + 8 * c +
                                              col0) =
              __floats2bfloat162_rn(acc[x][j] * inv_l,
                                    acc[x][j + 1] * inv_l);
        }
      if (lane % 4 == 0)
        lse[((size_t)b * H + h) * Tn + pos] = m[r] * kLn2 + logf(l[r]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: looked up in the libcuda.so.1
// the process already holds, so the build links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// (B, T, heads, D) bf16 as a 4-D map (d, heads, T, B) of 64-column boxes
// of ``rows`` positions, 128-byte swizzle, rows past T read as zeros
int make_map(CUtensorMap* map, const void* ptr, int heads, int Tn, int B,
             int D, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)Tn, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)Tn * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Tn, int H, int KV, int window, float scale,
           cudaStream_t stream) {
  using P = Plan<D>;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, H, Tn, B, D, kBM);
  if (err == 0) err = make_map(&tk, k, KV, Tn, B, D, P::kBN);
  if (err == 0) err = make_map(&tv, v, KV, Tn, B, D, P::kBN);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kSmem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  dim3 grid(H, B, (Tn + kBM - 1) / kBM);
  flash_attention_kernel<D><<<grid, kThreads, P::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Tn, H, KV, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q, o: (B, T, H, D); k, v: (B, T, KV, D); lse: (B, H, T) float32; all
// contiguous. dtype: 0 = float32, 1 = bfloat16. D must be 64, 128 or 256
// and H a multiple of KV.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int Tn, int H, int KV, int D,
                                      int window, float scale, int dtype,
                                      cudaStream_t stream) {
  if (KV <= 0 || H % KV != 0 || Tn <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_ARGS q, k, v, o, lse, B, Tn, H, KV, window, scale, stream
  if (dtype == 0 && D == 64) return f32::launch<64>(FLASH_ARGS);
  if (dtype == 0 && D == 128) return f32::launch<128>(FLASH_ARGS);
  if (dtype == 0 && D == 256) return f32::launch<256>(FLASH_ARGS);
  if (dtype == 1 && D == 64) return tc::launch<64>(FLASH_ARGS);
  if (dtype == 1 && D == 128) return tc::launch<128>(FLASH_ARGS);
  if (dtype == 1 && D == 256) return tc::launch<256>(FLASH_ARGS);
#undef FLASH_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
