// Batched VOTEDPREDICT (Algorithm 4) for Hopper (sm_90a): the serving
// tier's answer to M queries from a snapshot of the protocol's caches.
//
// Replaces the Pallas TPU kernel src/repro/kernels/voted_predict.py
// voted_predict_batched (body _voted_kernel). For query m, answered by
// node a = assign[m]:
//
//   score_s = <w[a, s], x_m>              for the slots s < count[a]
//   pos     = #{s < count[a] : score_s >= 0}
//   p_ratio = pos / max(count[a], 1)      (float32, IEEE division)
//   out[m]  = p_ratio - 0.5 >= 0 ? +1 : -1
//
// The TPU kernel is given the gathered (M, C, d) rows w[assign]; this one
// reads the rows of the (N, C, d) snapshot itself, which is the same
// function without an (M, C, d) copy in device memory (the gathered form
// is the case assign = 0, 1, ..., M - 1). The vote counts are
// exact small integers and the tie rules are the reference's (a zero score
// votes +1, p_ratio = 0.5 answers +1), so the answers equal the plain
// version's bit for bit wherever no score lies within the rounding of its
// sum order of zero.
//
// Layout: one warp per query, kQueriesPerBlock queries a block. Lanes
// stride over d (no padding: the loop bound masks the ragged edge) and each
// score is a warp-shuffle sum, so one layout serves d = 10, 57 and 9947.
// Slots at or past count[a] are not read.
//
// Bound: device memory (3.35 TB/s on an H100 SXM). A launch must read, for
// each distinct node a query is assigned to, its count and its count[a]
// valid cache rows (4 d bytes each), and for each query its x (4 d bytes)
// and assign entry, and write one float; it does about 2 d operations a
// valid row. chip_smoke.py computes that byte count from the run's own
// assignment and counts. Compile with --fmad=false, as the other kernels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kQueriesPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

__global__ void __launch_bounds__(kWarp * kQueriesPerBlock)
voted_predict_kernel(const float* __restrict__ w,
                     const int* __restrict__ count,
                     const float* __restrict__ x,
                     const int* __restrict__ assign,
                     float* __restrict__ out, int m, int c, int d) {
  const int lane = threadIdx.x % kWarp;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kQueriesPerBlock +
                    threadIdx.x / kWarp;
  if (q >= m) return;

  const int64_t a = assign[q];
  const int cnt = count[a];
  const float* xq = x + q * d;
  const float* wa = w + a * c * d;
  int pos = 0;
  for (int s = 0; s < c && s < cnt; ++s) {
    const float* ws = wa + static_cast<int64_t>(s) * d;
    float acc = 0.0f;
    for (int j = lane; j < d; j += kWarp) acc += ws[j] * xq[j];
    if (warp_sum(acc) >= 0.0f) pos += 1;
  }
  if (lane == 0) {
    const float p_ratio =
        static_cast<float>(pos) / static_cast<float>(max(cnt, 1));
    out[q] = p_ratio - 0.5f >= 0.0f ? 1.0f : -1.0f;
  }
}

}  // namespace

// w (N, C, d) f32, count (N,) i32, x (M, d) f32, assign (M,) i32 node ids
// into the N rows, out (M,) f32.
// Returns cudaGetLastError() after the launch (0 on success); the launch
// is asynchronous on `stream`.
extern "C" int voted_predict_batched(const float* w, const int* count,
                                     const float* x, const int* assign,
                                     float* out, int m, int c, int d,
                                     void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks =
      (static_cast<unsigned>(m) + kQueriesPerBlock - 1) / kQueriesPerBlock;
  voted_predict_kernel<<<blocks, kWarp * kQueriesPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      w, count, x, assign, out, m, c, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* voted_predict_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
