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
// Two routes, chosen before the launch by voted_predict.py::voted_route:
//
// grouped (d <= 32, C <= 256): G = 2^ceil(log2 d) lanes score one
// (query, slot) pair. While a batch's queries fit on the card together a
// query takes C G threads (rounded up to whole warps), so its C slots run
// at once in C groups: one query a block at C = d = 10 (160 threads), so
// M = 256 queries are 256 blocks over the card's 132 SMs. A larger batch
// takes one warp a query, 8 a block, its groups taking the slots in turns,
// which keeps more queries' loads in flight on each SM (grouped_lanes).
// The chain of dependent loads is two round trips: assign[q], then, all
// issued together, count[a], x_q and the node's C d contiguous floats
// (400 B at C = d = 10) into shared memory, 16 bytes a thread where C d 4
// is a multiple of 16 and w starts on a 16-byte boundary, 4 bytes a
// thread otherwise; the slots at or past count[a] are masked after the
// load. Lane j of a group holds +0.0 + w_j x_j (0 past d), the score is a
// G-lane xor butterfly from offset G / 2, and the votes are a ballot of
// the groups' first lanes, popcounted a warp and added in shared memory.
// The butterfly's bits equal the 32-lane tree's of the strided route (its
// lanes at or past G hold zeros, which the tree's first levels add
// exactly) up to the sign of a zero sum, which score >= 0 does not see,
// so the two routes give the same answers.
//
// strided (every d; d > 32: spambase's 57, Reuters' 9947): one warp per
// query, kQueriesPerBlock queries a block. Lanes stride over d (no
// padding: the loop bound masks the ragged edge) and each score is a
// warp-shuffle sum; the slots are scored one after another, each a
// dependent row load, and the slots at or past count[a] are not read.
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
constexpr int kQueriesPerBlock = 8;   // strided
constexpr int kGroupedMaxWidth = 32;
constexpr int kGroupedBlock = 256;    // grouped: threads a block, at least
constexpr int kGroupedMaxLanes = 1024;  // and at most
constexpr int kGroupedMaxSlots = 256;   // C it takes at most (32 KB at d 32)
constexpr size_t kSharedBytes = 48 * 1024;

enum Route { kGrouped = 0, kStrided = 1 };

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

// The grouped route (the note above): a block of blockDim.x / lanes
// queries, each on `lanes` threads (whole warps; fewer than C G and the
// groups take the slots in turns, lanes / G at a time); dynamic shared
// memory holds each query's C d floats. kVec: the node's floats are read
// 16 bytes a thread.
template <bool kVec>
__global__ void __launch_bounds__(kGroupedMaxLanes)
voted_grouped_kernel(const float* __restrict__ w,
                     const int* __restrict__ count,
                     const float* __restrict__ x,
                     const int* __restrict__ assign,
                     float* __restrict__ out, int m, int c, int d,
                     int log2g, int lanes) {
  extern __shared__ __align__(16) float s_w[];
  __shared__ int s_pos[kGroupedBlock / kWarp];
  const int qi = threadIdx.x / lanes;  // the query within the block
  const int t = threadIdx.x - qi * lanes;  // the thread within the query
  const int64_t q = static_cast<int64_t>(blockIdx.x) * (blockDim.x / lanes)
                    + qi;
  const bool live = q < m;
  const int g = 1 << log2g;
  const int j = t & (g - 1);
  const int cd = c * d;
  float* sw = s_w + qi * cd;
  if (t == 0) s_pos[qi] = 0;

  // trip 1: the node; trip 2, all issued together: its count, x_q and its
  // C d floats
  int cnt = 0;
  float xj = 0.0f;
  if (live) {
    const int64_t a = assign[q];
    const float* wa = w + a * cd;
    cnt = count[a];
    if (j < d) xj = x[q * d + j];
    if constexpr (kVec) {
      for (int e = 4 * t; e < cd; e += 4 * lanes) {
        *reinterpret_cast<float4*>(sw + e) =
            *reinterpret_cast<const float4*>(wa + e);
      }
    } else {
      for (int e = t; e < cd; e += lanes) sw[e] = wa[e];
    }
  }
  __syncthreads();

  // slot s's score: a G-lane xor butterfly of +0.0 + w_j x_j; the votes of
  // the groups' first lanes, a ballot a warp
  int pos = 0;
  for (int s0 = 0; s0 < c; s0 += lanes >> log2g) {
    const int s = s0 + (t >> log2g);
    float v = live && s < c && j < d ? 0.0f + sw[s * d + j] * xj : 0.0f;
    for (int o = g / 2; o > 0; o >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, o);
    }
    const bool vote = live && j == 0 && s < c && s < cnt && v >= 0.0f;
    pos += __popc(__ballot_sync(0xffffffffu, vote));
  }
  if (threadIdx.x % kWarp == 0 && pos != 0) atomicAdd(&s_pos[qi], pos);
  __syncthreads();
  if (live && t == 0) {
    const float p_ratio =
        static_cast<float>(s_pos[qi]) / static_cast<float>(max(cnt, 1));
    out[q] = p_ratio - 0.5f >= 0.0f ? 1.0f : -1.0f;
  }
}

// the smallest log2 G with 2^G >= d
int group_log2(int d) {
  int l = 0;
  while ((1 << l) < d) ++l;
  return l;
}

// Threads a query takes on the grouped route: C G (rounded up to whole
// warps), all its slots at once, while the batch's threads fit on the card
// together; past that one warp, its groups taking the slots in turns,
// which keeps more queries' loads in flight on each SM (chip_smoke.py
// phase 5 times both at M = 1, 256 and 65 536).
int grouped_lanes(int m, int c, int log2g) {
  const int all =
      min(((c << log2g) + kWarp - 1) / kWarp * kWarp, kGroupedMaxLanes);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                         dev);
  return static_cast<int64_t>(m) * all <= static_cast<int64_t>(sms) * per_sm
             ? all : kWarp;
}

}  // namespace

// w (N, C, d) f32, count (N,) i32, x (M, d) f32, assign (M,) i32 node ids
// into the N rows, out (M,) f32. route: 0 = grouped (d <= 32 and C <= 256
// only), 1 = strided. lanes: the grouped route's threads a query, a
// multiple of 32 (0: grouped_lanes chooses). Returns cudaGetLastError() after the launch (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int voted_predict_batched(const float* w, const int* count,
                                     const float* x, const int* assign,
                                     float* out, int m, int c, int d,
                                     int route, int lanes, void* stream) {
  if (route != kGrouped && route != kStrided) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == kGrouped && (d > kGroupedMaxWidth || c > kGroupedMaxSlots)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m <= 0 || c <= 0 || d <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kStrided) {
    const unsigned blocks =
        (static_cast<unsigned>(m) + kQueriesPerBlock - 1) / kQueriesPerBlock;
    voted_predict_kernel<<<blocks, kWarp * kQueriesPerBlock, 0, s>>>(
        w, count, x, assign, out, m, c, d);
    return static_cast<int>(cudaGetLastError());
  }
  const int log2g = group_log2(d);
  if (lanes == 0) lanes = grouped_lanes(m, c, log2g);
  if (lanes % kWarp != 0 || lanes > kGroupedMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // as many queries a block as fill kGroupedBlock threads, their floats in
  // the 48 KB of shared memory a launch takes without opting in
  const int per_block =
      max(1, min(kGroupedBlock / lanes,
                 static_cast<int>(kSharedBytes / (sizeof(float) * c * d))));
  const unsigned blocks =
      (static_cast<unsigned>(m) + per_block - 1) / per_block;
  const size_t smem = sizeof(float) * per_block * c * d;
  const bool vec = (c * d) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto kernel = vec ? voted_grouped_kernel<true> : voted_grouped_kernel<false>;
  kernel<<<blocks, per_block * lanes, smem, s>>>(w, count, x, assign, out, m,
                                                 c, d, log2g, lanes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* voted_predict_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
