// Population Pegasos step and fused MERGE + Pegasos step for Hopper
// (sm_90a), one source for both.
//
// Replaces two Pallas TPU kernels:
//   src/repro/kernels/pegasos_update.py pegasos_update (body _pegasos_kernel)
//   src/repro/kernels/gossip_merge.py   merge_update   (body
//                                        _merge_update_kernel)
// For every row i of the (N, d) models, with the local example (x_i, y_i):
//
//   merge (template argument kMerge):  w = (w1 + w2) / 2,  t = max(t1, t2)
//   otherwise:                         w = w1,             t = t1
//   t'    = t + 1
//   eta   = 1 / (lam t')
//   w'    = (1 - eta lam) w + [y <w, x> < 1] (eta y) x
//
// in the op order of the Pallas bodies (and of kernel #1's _pegasos): the
// decay product and the hinge product are rounded apart and then added,
// which --fmad=false keeps (no contraction into an fma); the division is
// IEEE. Only the margin's sum runs in another order than the plain
// version's, so w' equals the plain version bit for bit except in a row
// whose margin lies within that sum's rounding of 1; t' always equals it.
//
// Two layouts for each, chosen before the launch by
// pegasos_update.py::row_route (each C entry takes the choice as an
// argument and refuses a tiled launch outside its range).
//
// strided (the first layout; every d): narrow rows (d < kWideD) take one
// warp each, kRows rows a 256-thread block; lanes stride over d (no
// padding: the loop bound masks the ragged edge, so one layout serves
// d = 10 and 57) and the margin is a warp-shuffle sum. Wide rows
// (d >= kWideD, Reuters' d = 9947) take a whole block each: the margin is
// tiled over d across the block's eight warps, each warp's partial sum
// goes to shared memory and every thread adds the eight in warp order, so
// the sum's order is fixed and the result reproducible. Both passes over a
// row (margin, then update) read w and x again; the second read of a row
// hits the cache. At d = 10 it is latency-bound: 22 of 32 lanes idle, a
// five-level shuffle for a 10-term margin, 4-byte loads from scattered
// 40-byte rows, and two passes that each read w1, w2 and x.
//
// tiled (d <= kTiledMaxWidth, every operand on a 16-byte boundary;
// row_route sends each kernel up to the widest d of chip_smoke.py's sweep
// (10, 32, 57, 128) at which it beats the strided layout on an H100):
// tiled.cuh's walk, persistent blocks of 256 threads over tiles of R rows,
// each tile of the model(s) and x (R d floats) and of the counter(s) and y
// (R values) copied with 16-byte cp.async into a ring of two slots. R is
// as many rows as a slot of kSlotBytes holds (a multiple of 16, at least
// 16): for the merge (w1, w2, x, t1, t2, y) 112 at d = 10, a 36 KB block,
// six blocks an SM, each with a 15 KB slot in flight; for the step (w, x,
// t, y) 176 at d = 10, a 40 KB block, five an SM. On a landed tile:
//   1. an element pass over the flat tile forms the model m, the merge's
//      (w1 + w2) / 2 in place of w1's tile or the step's w as it lies,
//      and the product m x into a copy of the tile whose rows are an odd
//      number of floats apart (d, or d + 1 for even d);
//   2. a row pass, one thread a row, sums that row's products in j order
//      from +0.0 (the odd row pitch spreads a warp's reads over all 32
//      banks), then forms t' = max(t1, t2) + 1 or t + 1 (written out,
//      coalesced), eta, the decay, the hinge and eta y;
//   3. an element pass writes w' = decay m + [hinge] (eta y) x, four
//      elements a thread, 16-byte stores, coalesced.
// Every row is read once and written once; only the margin's order
// differs from the strided layout's, so the two give the same t' and the
// same w' but in a row whose margin lies within that sum's rounding of 1.
//
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiled.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kWideD = 1024;  // rows at least this wide take a whole block

// the tiled layout
constexpr int kSlotBytes = 16384;     // a slot's tiles at most
constexpr int kTiledMaxWidth = 128;   // d it takes at most (16 rows)

enum Route { kTiled = 0, kStrided = 1 };

// the (N, d) arrays a tiled slot holds: the model(s) and x; and as many
// (N,) ones, the counter(s) and y
template <bool kMerge>
__host__ __device__ constexpr int tiled_arrays() {
  return kMerge ? 3 : 2;
}

// rows a tile holds at width d: the merge's w1, w2 and x (d floats each)
// and t1, t2 and y a row (pegasos_update.py::merge_tile_rows), the step's
// w and x and t and y (step_tile_rows)
template <bool kMerge>
int tile_rows_at(int d) {
  return tiled_rows(4 * tiled_arrays<kMerge>() * (d + 1), kSlotBytes);
}

// the row pitch of the tiled merge's products: odd, so that the row pass's
// reads of one column by a warp's 32 rows fall in 32 banks
__host__ __device__ __forceinline__ int product_pitch(int d) { return d | 1; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// element j of the model the step updates
template <bool kMerge>
__device__ __forceinline__ float model(const float* a, const float* b,
                                       int j) {
  if constexpr (kMerge) {
    return (a[j] + b[j]) / 2.0f;
  } else {
    return a[j];
  }
}

// kWarps warps share one row: 1 (a warp per row) or kWarpsPerBlock (a
// block per row).
template <bool kMerge, int kWarps>
__global__ void __launch_bounds__(kThreads)
pegasos_kernel(const float* __restrict__ w1, const int* __restrict__ t1,
               const float* __restrict__ w2, const int* __restrict__ t2,
               const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ w_out, int* __restrict__ t_out, int n,
               int d, float lam) {
  constexpr int kRows = kWarpsPerBlock / kWarps;
  constexpr int kStride = kWarps * kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRows + warp / kWarps;
  const int r = (warp % kWarps) * kWarp + lane;  // thread's place in its row
  // a block per row: the whole block returns together, before the barrier
  if (i >= n) return;

  const float* a = w1 + i * d;
  const float* b = kMerge ? w2 + i * d : nullptr;
  const float* xi = x + i * d;

  float acc = 0.0f;
  for (int j = r; j < d; j += kStride) acc += model<kMerge>(a, b, j) * xi[j];
  acc = warp_sum(acc);
  if constexpr (kWarps > 1) {
    __shared__ float part[kWarps];
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) acc += part[k];
  }

  const int t = (kMerge ? max(t1[i], t2[i]) : t1[i]) + 1;
  const float yi = y[i];
  const float eta = 1.0f / (lam * static_cast<float>(t));
  const float decay = 1.0f - eta * lam;
  const bool hinge = yi * acc < 1.0f;
  const float coef = eta * yi;
  float* out = w_out + i * d;
  for (int j = r; j < d; j += kStride) {
    const float wj = model<kMerge>(a, b, j);
    out[j] = decay * wj + (hinge ? coef * xi[j] : 0.0f);
  }
  if (r == 0) t_out[i] = t;
}

// The tiled layout (the note above). A slot holds, in order, the tiles of
// w1, w2 (with the merge), x (R d floats each), t1, t2 (with the merge)
// and y (R each); behind the two slots lie the products (R rows at
// product_pitch(d)) and each row's decay, eta y and hinge. w2 and t2 are
// read only with the merge.
template <bool kMerge>
__global__ void __launch_bounds__(kTiledThreads)
tiled_kernel(const float* __restrict__ w1, const int* __restrict__ t1,
             const float* __restrict__ w2, const int* __restrict__ t2,
             const float* __restrict__ x, const float* __restrict__ y,
             float* __restrict__ w_out, int* __restrict__ t_out, int n, int d,
             float lam, int rows_per_tile, int tiles) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kArrays = tiled_arrays<kMerge>();
  const int tile = rows_per_tile * d;
  const int slot = kArrays * (tile + rows_per_tile);
  const int pitch = product_pitch(d);
  // offsets in a slot: x's tile after the model tiles, then the counters
  // and y
  const int x_at = (kArrays - 1) * tile;
  const int t_at = kArrays * tile;
  const int y_at = t_at + (kArrays - 1) * rows_per_tile;
  float* s_prod = smem + 2 * slot;
  float* s_decay = s_prod + rows_per_tile * pitch;
  float* s_coef = s_decay + rows_per_tile;
  int* s_hinge = reinterpret_cast<int*>(s_coef + rows_per_tile);
  auto stage = [&](int buf, int t) {
    float* sl = smem + buf * slot;
    stage_tile(sl, w1, t, rows_per_tile, n, d);
    stage_tile(sl + x_at, x, t, rows_per_tile, n, d);
    stage_tile(sl + t_at, t1, t, rows_per_tile, n, 1);
    stage_tile(sl + y_at, y, t, rows_per_tile, n, 1);
    if constexpr (kMerge) {
      stage_tile(sl + tile, w2, t, rows_per_tile, n, d);
      stage_tile(sl + t_at + rows_per_tile, t2, t, rows_per_tile, n, 1);
    }
  };
  walk_tiles(n, rows_per_tile, tiles, stage,
             [&](int buf, int64_t r0, int rows) {
    float* s_m = smem + buf * slot;  // w1's tile, then the merged model
    const float* s_w2 = s_m + tile;
    const float* s_x = s_m + x_at;
    const int* s_t1 = reinterpret_cast<const int*>(s_m + t_at);
    const int* s_t2 = s_t1 + rows_per_tile;
    const float* s_y = s_m + y_at;
    const int elems = rows * d;
    // 1. the model and the margin's products, a flat element a thread
    for (int e = threadIdx.x; e < elems; e += kTiledThreads) {
      float m = s_m[e];
      if constexpr (kMerge) {
        m = (m + s_w2[e]) / 2.0f;
        s_m[e] = m;
      }
      const int row = e / d;
      s_prod[row * pitch + (e - row * d)] = m * s_x[e];
    }
    __syncthreads();
    // 2. the margin in j order from +0.0 and the step's scalars, a thread
    // a row
    const int r = threadIdx.x;
    if (r < rows) {
      const float* pr = s_prod + r * pitch;
      float acc = 0.0f;
      for (int j = 0; j < d; ++j) acc += pr[j];
      const int t = (kMerge ? max(s_t1[r], s_t2[r]) : s_t1[r]) + 1;
      const float yi = s_y[r];
      const float eta = 1.0f / (lam * static_cast<float>(t));
      s_decay[r] = 1.0f - eta * lam;
      s_coef[r] = eta * yi;
      s_hinge[r] = yi * acc < 1.0f;
      t_out[r0 + r] = t;
    }
    __syncthreads();
    // 3. w' four flat elements a thread (a tile is a multiple of four
    // floats long, and its offset in w' a multiple of 16 bytes)
    float* ot = w_out + r0 * d;
    for (int e = 4 * threadIdx.x; e < elems; e += 4 * kTiledThreads) {
      const float4 m4 = *reinterpret_cast<const float4*>(s_m + e);
      const float4 x4 = *reinterpret_cast<const float4*>(s_x + e);
      const float m[4] = {m4.x, m4.y, m4.z, m4.w};
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      float out[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int row = e / d;
      int col = e - row * d;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (e + i < elems) {
          out[i] = s_decay[row] * m[i] +
                   (s_hinge[row] ? s_coef[row] * xv[i] : 0.0f);
        }
        if (++col == d) {
          col = 0;
          ++row;
        }
      }
      if (e + 4 <= elems) {
        *reinterpret_cast<float4*>(ot + e) =
            make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (e + i < elems) ot[e + i] = out[i];
        }
      }
    }
  });
}

// dynamic shared memory of a tiled launch (the kernel's layout)
template <bool kMerge>
size_t tiled_smem(int d) {
  const size_t rows = tile_rows_at<kMerge>(d);
  return sizeof(float) * (2 * tiled_arrays<kMerge>() * rows * (d + 1) +
                          rows * product_pitch(d) + 3 * rows);
}

template <bool kMerge>
void launch_strided(const float* w1, const int* t1, const float* w2,
                    const int* t2, const float* x, const float* y,
                    float* w_out, int* t_out, int n, int d, float lam,
                    cudaStream_t stream) {
  if (d >= kWideD) {
    pegasos_kernel<kMerge, kWarpsPerBlock>
        <<<static_cast<unsigned>(n), kThreads, 0, stream>>>(
            w1, t1, w2, t2, x, y, w_out, t_out, n, d, lam);
  } else {
    const unsigned blocks =
        (static_cast<unsigned>(n) + kWarpsPerBlock - 1) / kWarpsPerBlock;
    pegasos_kernel<kMerge, 1><<<blocks, kThreads, 0, stream>>>(
        w1, t1, w2, t2, x, y, w_out, t_out, n, d, lam);
  }
}

// Check the route and launch on it: a tiled launch only at d <=
// kTiledMaxWidth with every pointer it reads or writes on a 16-byte
// boundary (w2 and t2 are null without the merge).
template <bool kMerge>
int launch(const float* w1, const int* t1, const float* w2, const int* t2,
           const float* x, const float* y, float* w_out, int* t_out, int n,
           int d, float lam, int route, void* stream) {
  if (route != kTiled && route != kStrided) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == kTiled &&
      (d > kTiledMaxWidth || !aligned16(w1) || !aligned16(t1) ||
       !aligned16(w2) || !aligned16(t2) || !aligned16(x) || !aligned16(y) ||
       !aligned16(w_out) || !aligned16(t_out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kStrided) {
    launch_strided<kMerge>(w1, t1, w2, t2, x, y, w_out, t_out, n, d, lam, s);
  } else {
    const int rows = tile_rows_at<kMerge>(d);
    const int tiles = tiles_for(n, rows);
    const size_t smem = tiled_smem<kMerge>(d);
    const unsigned blocks = tiled_blocks(tiled_kernel<kMerge>, tiles, smem);
    tiled_kernel<kMerge><<<blocks, kTiledThreads, smem, s>>>(
        w1, t1, w2, t2, x, y, w_out, t_out, n, d, lam, rows, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w, x, w_out (N, d) f32; t, t_out (N,) i32; y (N,) f32 ±1. route: 0 =
// tiled (d <= 128 and every pointer on a 16-byte boundary only), 1 =
// strided. Returns cudaGetLastError() after the launch (0 on success);
// the launch is asynchronous on `stream`.
extern "C" int pegasos_update(const float* w, const int* t, const float* x,
                              const float* y, float* w_out, int* t_out,
                              int n, int d, float lam, int route,
                              void* stream) {
  return launch<false>(w, t, nullptr, nullptr, x, y, w_out, t_out, n, d, lam,
                       route, stream);
}

// The same with the merge prologue: w1, w2 (N, d) f32 and t1, t2 (N,) i32.
extern "C" int merge_update(const float* w1, const int* t1, const float* w2,
                            const int* t2, const float* x, const float* y,
                            float* w_out, int* t_out, int n, int d,
                            float lam, int route, void* stream) {
  return launch<true>(w1, t1, w2, t2, x, y, w_out, t_out, n, d, lam, route,
                      stream);
}

extern "C" const char* pegasos_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
