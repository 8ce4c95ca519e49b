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
// Layout: narrow rows (d < kWideD) take one warp each, kRows rows a
// 256-thread block; lanes stride over d (no padding: the loop bound masks
// the ragged edge, so one layout serves d = 10 and 57) and the margin is a
// warp-shuffle sum. Wide rows (d >= kWideD, Reuters' d = 9947) take a
// whole block each: the margin is tiled over d across the block's eight
// warps, each warp's partial sum goes to shared memory and every thread
// adds the eight in warp order, so the sum's order is fixed and the result
// reproducible. Both passes over a row (margin, then update) read w and x
// again; the second read of a row hits the cache.
//
// Bound: device memory (3.35 TB/s on an H100 SXM). A launch must read w
// (w1 and w2 for the merge), x, t and y once and write w' and t' once:
// 12 d + 12 bytes a row (16 d + 16 with the merge), against about 5
// operations an element (7 with the merge). Compile with --fmad=false, as
// the other kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kWideD = 1024;  // rows at least this wide take a whole block

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

template <bool kMerge>
void launch(const float* w1, const int* t1, const float* w2, const int* t2,
            const float* x, const float* y, float* w_out, int* t_out, int n,
            int d, float lam, cudaStream_t stream) {
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

}  // namespace

// w, x, w_out (N, d) f32; t, t_out (N,) i32; y (N,) f32 ±1.
// Returns cudaGetLastError() after the launch (0 on success); the launch
// is asynchronous on `stream`.
extern "C" int pegasos_update(const float* w, const int* t, const float* x,
                              const float* y, float* w_out, int* t_out,
                              int n, int d, float lam, void* stream) {
  if (n > 0) {
    launch<false>(w, t, nullptr, nullptr, x, y, w_out, t_out, n, d, lam,
                  static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

// The same with the merge prologue: w1, w2 (N, d) f32 and t1, t2 (N,) i32.
extern "C" int merge_update(const float* w1, const int* t1, const float* w2,
                            const int* t2, const float* x, const float* y,
                            float* w_out, int* t_out, int n, int d,
                            float lam, void* stream) {
  if (n > 0) {
    launch<true>(w1, t1, w2, t2, x, y, w_out, t_out, n, d, lam,
                 static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pegasos_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
