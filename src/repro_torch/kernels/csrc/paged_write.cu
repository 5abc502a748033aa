// Window writeback into a paged block pool.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py :
// paged_write_kernel (_write_kernel_body), the writeback epilogue alone.
//
// Commits new[b, 0:W] into the pool (P, bs, ...) at logical positions
// [start[b], start[b] + W) through tables[b, :]: slot t of logical block
// blk takes new[b, blk*bs + t - start[b]] when that offset lies in [0, W)
// and the row is active. The reference routes inactive rows and blocks
// past the table to the sink block 0, whose contents are garbage by
// design; this kernel skips those writes instead, so the pool matches the
// reference bitwise on every block but 0.
//
// Bound on the H100: memory, and tiny: W rows of the trailing width are
// read and written per active row. Launch latency dominates at the serving
// shapes.
//
// Design: one block per (row, straddled block), over the
// T = (W + bs - 2) / bs + 1 blocks a W-wide span can straddle, as the
// reference's grid. Threads copy (slot, word) pairs of the valid lanes in
// 16-byte words. The copy is pure data movement, so no rounding enters.
#include <cuda_runtime.h>

namespace {

__global__ void paged_write_kernel(uint4* __restrict__ pool,
                                   const uint4* __restrict__ fresh,
                                   const int* __restrict__ tables,
                                   const int* __restrict__ start,
                                   const int* __restrict__ active, int W,
                                   int nb, int bs, int words) {
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int st = start[b];
  const int blk = st / bs + t;
  const int last = (st + W - 1) / bs;
  if (blk >= nb || blk > last || active[b] == 0) return;
  const int phys = tables[(size_t)b * nb + blk];
  for (int i = threadIdx.x; i < bs * words; i += blockDim.x) {
    const int s = i / words, w = i % words;
    const int off = blk * bs + s - st;
    if (off < 0 || off >= W) continue;
    pool[((size_t)phys * bs + s) * words + w] =
        fresh[((size_t)b * W + off) * words + w];
  }
}

}  // namespace

// row_bytes must be a multiple of 16 and both pointers 16-byte aligned (the
// wrapper checks): every pool of the port has rows of 64 or 128 values.
extern "C" int paged_write_launch(void* pool, const void* fresh,
                                  const int* tables, const int* start,
                                  const int* active, int B, int W, int nb,
                                  int bs, int row_bytes, cudaStream_t stream) {
  const int T = (W + bs - 2) / bs + 1;
  dim3 grid(T, B);
  paged_write_kernel<<<grid, 128, 0, stream>>>(
      static_cast<uint4*>(pool), static_cast<const uint4*>(fresh), tables,
      start, active, W, nb, bs, row_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}
