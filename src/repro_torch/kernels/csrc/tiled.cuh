// The tiled row walk shared by the port's row kernels (quantize_send.cu's
// tiled send kernels, pegasos_merge.cu's tiled merge kernel) and the
// cp.async helpers (gossip_cycle.cu's grouped receive kernel too).
//
// A row kernel reads a few (N, w) row-major arrays and writes results per
// row or per element. Persistent blocks of kTiledThreads threads walk tiles
// of R rows, tile blockIdx.x, + gridDim.x, ...: each tile of each input is
// one contiguous run of R w elements, copied into shared memory with
// 16-byte cp.async (the ragged last tile element by element) into a ring of
// two slots, so the next tile's copies are in flight while this one is
// worked on. R is a multiple of 16, which puts every tile's byte offset on
// a 16-byte boundary for 4-byte elements (and 1-byte outputs), so the
// inputs must start on a 16-byte boundary; the route rules check that.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTiledThreads = 256;
constexpr int kTiledMaxRows = 256;  // rows a tile at most (a thread a row)

// 4 or 16 bytes from global to shared memory, asynchronously (cp.async)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group of this thread's copies is in flight
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows a tile holds when a row takes row_bytes of a slot of slot_bytes: a
// multiple of 16, at least 16, at most kTiledMaxRows
inline int tiled_rows(int row_bytes, int slot_bytes) {
  const int r = slot_bytes / row_bytes / 16 * 16;
  return r < 16 ? 16 : (r < kTiledMaxRows ? r : kTiledMaxRows);
}

inline int tiles_for(int n, int rows_per_tile) {
  return static_cast<int>((static_cast<int64_t>(n) + rows_per_tile - 1) /
                          rows_per_tile);
}

// the rows of tile `tile`: R, or fewer in the ragged last tile
__device__ __forceinline__ int tile_rows(int tile, int rows_per_tile, int n) {
  const int64_t left = n - static_cast<int64_t>(tile) * rows_per_tile;
  return left < rows_per_tile ? static_cast<int>(left) : rows_per_tile;
}

// Copy tile `tile` of a row-major array of rows `width` 4-byte elements
// into `dst`, asynchronously: a full tile in 16-byte copies (its start and
// length are multiples of 16 bytes), the ragged last tile element by
// element.
__device__ __forceinline__ void stage_tile(void* dst, const void* src,
                                           int tile, int rows_per_tile, int n,
                                           int width) {
  const int rows = tile_rows(tile, rows_per_tile, n);
  float* out = static_cast<float*>(dst);
  const float* in = static_cast<const float*>(src) +
                    static_cast<int64_t>(tile) * rows_per_tile * width;
  if (rows == rows_per_tile) {
    const int chunks = rows * width / 4;
    for (int c = threadIdx.x; c < chunks; c += kTiledThreads) {
      cp_async16(out + 4 * c, in + 4 * c);
    }
  } else {
    const int elems = rows * width;
    for (int e = threadIdx.x; e < elems; e += kTiledThreads) {
      cp_async4(out + e, in + e);
    }
  }
}

// Walk this block's tiles, blockIdx.x, + gridDim.x, ...: stage(slot, tile)
// issues the copies of a tile into ring slot 0 or 1, and body(slot, first
// row, rows) runs on a tile whose copies have landed, while the next
// tile's are in flight into the other slot. Every thread of the block must
// call it.
template <typename Stage, typename Body>
__device__ __forceinline__ void walk_tiles(int n, int rows_per_tile,
                                           int tiles, Stage stage,
                                           Body body) {
  if (static_cast<int>(blockIdx.x) < tiles) stage(0, blockIdx.x);
  cp_async_commit();
  int buf = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    // every thread is done with the other slot (the previous tile) and
    // with the body's shared scalars, so the next tile may land there
    __syncthreads();
    const int next = tile + gridDim.x;
    if (next < tiles) stage(buf ^ 1, next);
    cp_async_commit();
    cp_async_wait_all_but_one();  // this tile's copies have landed
    __syncthreads();
    body(buf, static_cast<int64_t>(tile) * rows_per_tile,
         tile_rows(tile, rows_per_tile, n));
  }
  cp_async_wait_all();  // the last (empty) group: nothing left in flight
}

// persistent blocks: as many as fit on the card at once, at most one a
// tile; `smem` bytes of dynamic shared memory a block
template <typename Kernel>
unsigned tiled_blocks(Kernel kernel, int tiles, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kTiledThreads, smem);
  const int blocks = sms * per_sm;
  return static_cast<unsigned>(blocks < 1 ? 1 : (blocks < tiles ? blocks
                                                                : tiles));
}

// whether p starts on a 16-byte boundary (a tile's cp.async source)
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
