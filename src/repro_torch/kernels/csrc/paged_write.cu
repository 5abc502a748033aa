// Window writeback into a paged block pool.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py :
// paged_write_kernel (_write_kernel_body), the writeback epilogue alone.
//
// Commits new[b, 0:W] into the pool (P, bs, ...) at logical positions
// [start[b], start[b] + W) through tables[b, :]: row w goes to slot
// (start[b] + w) % bs of physical block tables[b, (start[b] + w) / bs].
// The reference routes inactive rows and blocks past the table to the sink
// block 0, whose contents are garbage by design; this kernel skips those
// writes instead, so the pool matches the reference bitwise on every block
// but 0. The copy is pure data movement: no rounding enters.
//
// Bound on the H100: launch and dependent-load latency, not bytes. At the
// serving verify shape (B = 2, W = 8, 2048-byte K/V rows) a call moves
// 64 KB, 0.02 us at 3.35 TB/s; what it waits for is the launch and, per
// thread, the table entry, which depends on start[b].
//
// Design: one thread per (sequence, window row, 16-byte word), in CTAs of
// 256: every thread does useful work, with no loop over a block's slots.
// Each thread issues its independent loads together (its fresh word,
// start[b], active[b]) and only then the dependent table entry and the
// store, so its chain is two loads deep.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
paged_write_kernel(uint4* __restrict__ pool, const uint4* __restrict__ fresh,
                   const int* __restrict__ tables,
                   const int* __restrict__ start,
                   const int* __restrict__ active, int B, int W, int nb,
                   int bs, int words) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)B * W * words) return;
  const int word = static_cast<int>(i % words);
  const int row = static_cast<int>(i / words);     // b * W + w
  const int b = row / W, w = row % W;
  const uint4 v = fresh[i];
  const int pos = start[b] + w;
  const bool on = active == nullptr || active[b] != 0;
  const int blk = pos / bs;
  if (!on || blk >= nb) return;
  const int phys = tables[(size_t)b * nb + blk];
  pool[((size_t)phys * bs + (pos - blk * bs)) * words + word] = v;
}

}  // namespace

// row_bytes must be a multiple of 16 and both pointers 16-byte aligned (the
// wrapper checks): every pool of the port has rows of 64 or more values.
// active may be null: every row is active.
extern "C" int paged_write_launch(void* pool, const void* fresh,
                                  const int* tables, const int* start,
                                  const int* active, int B, int W, int nb,
                                  int bs, int row_bytes, cudaStream_t stream) {
  const int words = row_bytes / 16;
  const long long n = (long long)B * W * words;
  if (n == 0) return 0;
  paged_write_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(
      static_cast<uint4*>(pool), static_cast<const uint4*>(fresh), tables,
      start, active, B, W, nb, bs, words);
  return static_cast<int>(cudaGetLastError());
}
