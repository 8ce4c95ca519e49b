// Fused gossip-cycle receive step for Hopper (sm_90a): K sequential
// receive rounds per node, in place.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gossip_cycle.py
// fused_receive_apply (body _cycle_kernel) for float32 messages and no
// defense screen. For every node i and every round k with valid[k, i]:
//
//   new   = CREATEMODEL(m_k, lastModel)       rw: update(m_k)
//                                              mu: update(merge(m_k, last))
//                                              um: merge(update(m_k),
//                                                        update(last))
//   cache[i, ptr % C] = new;  ptr += 1;  count = min(count + 1, C)
//   lastModel = m_k                            (the received message)
//
// with the Pegasos step t+1, eta = 1/(lam t), w <- (1 - eta lam) w +
// [y <w,x> < 1] (eta y) x, in the op order of _cycle_kernel's _pegasos.
//
// Layout: one warp per node, kNodesPerBlock nodes per block. Lanes stride
// over d (no padding of d or C: the loop bound masks the ragged edge) and
// the margin is a warp-shuffle sum, so one layout serves d = 10, 57 and
// 9947. Rounds run in order inside the warp; a round that is not valid is
// skipped without touching memory.
//
// In place: last_w, last_t, cache_w, cache_t, ptr and count are updated
// where they lie (the JAX chunk function donates its carry, so nothing is
// lost). A node reads its valid rounds' messages, its example and its
// lastModel, writes one cache row per valid round and its lastModel once:
// about (K + 3) d floats instead of rewriting its whole C d cache. The
// running lastModel is not written between rounds: it is always either the
// node's last_w row or the message of its latest valid round, so the kernel
// tracks which one by index.
//
// Bound: the kernel moves bytes and does ~6 flops a byte-pair, so device
// memory bounds it (3.35 TB/s on an H100 SXM). Per launch it must read the
// (K, N) valid lanes and, for each valid (node, round), the message row and
// counter and write one cache row and counter; for each node with a valid
// round it reads x, y, ptr, count, last_t (and last_w for mu/um) and writes
// last_w, last_t, ptr, count. chip_smoke.py computes that byte count from
// the run's own valid mask. Compile with --fmad=false so products and sums
// round like the plain PyTorch version; only the order of the margin's sum
// differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kNodesPerBlock = 8;

enum Variant { kRw = 0, kMu = 1, kUm = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

struct Step {
  float decay;  // 1 - eta * lam
  float coef;   // eta * y, or 0 when the hinge is inactive
  bool hinge;
  int t;
};

__device__ __forceinline__ Step pegasos_step(int t, float margin, float y,
                                             float lam) {
  Step s;
  s.t = t + 1;
  const float eta = 1.0f / (lam * static_cast<float>(s.t));
  s.decay = 1.0f - eta * lam;
  s.hinge = margin < 1.0f;
  s.coef = eta * y;
  return s;
}

__device__ __forceinline__ float apply_step(const Step& s, float w, float x) {
  return s.decay * w + (s.hinge ? s.coef * x : 0.0f);
}

template <int V>
__global__ void __launch_bounds__(kWarp * kNodesPerBlock)
fused_receive_kernel(float* __restrict__ last_w, int* __restrict__ last_t,
                     float* __restrict__ cache_w, int* __restrict__ cache_t,
                     int* __restrict__ ptr, int* __restrict__ count,
                     const float* __restrict__ msg_w,
                     const int* __restrict__ msg_t,
                     const int* __restrict__ valid,
                     const float* __restrict__ x,
                     const float* __restrict__ y, int n, int d, int c, int k,
                     float lam) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kNodesPerBlock + threadIdx.x / kWarp;
  if (i >= n) return;

  const float* xi = x + i * d;
  const float yi = y[i];
  int p = ptr[i];
  int cnt = count[i];
  int lt = last_t[i];
  int src = -1;  // -1: lastModel is the last_w row; else a message round

  for (int r = 0; r < k; ++r) {
    const int64_t ri = static_cast<int64_t>(r) * n + i;
    if (valid[ri] <= 0) continue;
    const float* m = msg_w + ri * d;
    const float* l = src < 0 ? last_w + i * d
                             : msg_w + (static_cast<int64_t>(src) * n + i) * d;
    const int mt = msg_t[ri];

    // pass 1: the margin(s) of the model(s) the Pegasos step updates
    float a1 = 0.0f, a2 = 0.0f;
    for (int j = lane; j < d; j += kWarp) {
      const float xj = xi[j];
      if (V == kMu) {
        const float w = (m[j] + l[j]) / 2.0f;
        a1 += w * xj;
      } else {
        a1 += m[j] * xj;
        if (V == kUm) a2 += l[j] * xj;
      }
    }
    a1 = warp_sum(a1);
    if (V == kUm) a2 = warp_sum(a2);

    // pass 2: the new model goes straight into ring slot ptr % C
    float* out = cache_w + (i * c + p % c) * d;
    int nt;
    if (V == kMu) {
      const Step s = pegasos_step(max(mt, lt), yi * a1, yi, lam);
      for (int j = lane; j < d; j += kWarp) {
        out[j] = apply_step(s, (m[j] + l[j]) / 2.0f, xi[j]);
      }
      nt = s.t;
    } else if (V == kUm) {
      const Step s1 = pegasos_step(mt, yi * a1, yi, lam);
      const Step s2 = pegasos_step(lt, yi * a2, yi, lam);
      for (int j = lane; j < d; j += kWarp) {
        const float xj = xi[j];
        out[j] = (apply_step(s1, m[j], xj) + apply_step(s2, l[j], xj)) / 2.0f;
      }
      nt = max(s1.t, s2.t);
    } else {
      const Step s = pegasos_step(mt, yi * a1, yi, lam);
      for (int j = lane; j < d; j += kWarp) out[j] = apply_step(s, m[j], xi[j]);
      nt = s.t;
    }
    if (lane == 0) cache_t[i * c + p % c] = nt;
    p += 1;
    cnt = min(cnt + 1, c);
    src = r;  // lastModel <- the received message
    lt = mt;
  }

  if (src < 0) return;  // no valid round: the node is untouched
  const float* m = msg_w + (static_cast<int64_t>(src) * n + i) * d;
  for (int j = lane; j < d; j += kWarp) last_w[i * d + j] = m[j];
  if (lane == 0) {
    last_t[i] = lt;
    ptr[i] = p;
    count[i] = cnt;
  }
}

template <int V>
void launch(float* last_w, int* last_t, float* cache_w, int* cache_t,
            int* ptr, int* count, const float* msg_w, const int* msg_t,
            const int* valid, const float* x, const float* y, int n, int d,
            int c, int k, float lam, cudaStream_t stream) {
  const unsigned blocks = (static_cast<unsigned>(n) + kNodesPerBlock - 1) /
                          kNodesPerBlock;
  fused_receive_kernel<V><<<blocks, kWarp * kNodesPerBlock, 0, stream>>>(
      last_w, last_t, cache_w, cache_t, ptr, count, msg_w, msg_t, valid, x,
      y, n, d, c, k, lam);
}

}  // namespace

// variant: 0 = rw, 1 = mu, 2 = um. Returns cudaGetLastError() after the
// launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int gossip_cycle_fused_receive_apply(
    float* last_w, int* last_t, float* cache_w, int* cache_t, int* ptr,
    int* count, const float* msg_w, const int* msg_t, const int* valid,
    const float* x, const float* y, int n, int d, int c, int k, float lam,
    int variant, void* stream) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kRw:
      launch<kRw>(last_w, last_t, cache_w, cache_t, ptr, count, msg_w, msg_t,
                  valid, x, y, n, d, c, k, lam, s);
      break;
    case kMu:
      launch<kMu>(last_w, last_t, cache_w, cache_t, ptr, count, msg_w, msg_t,
                  valid, x, y, n, d, c, k, lam, s);
      break;
    case kUm:
      launch<kUm>(last_w, last_t, cache_w, cache_t, ptr, count, msg_w, msg_t,
                  valid, x, y, n, d, c, k, lam, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gossip_cycle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
