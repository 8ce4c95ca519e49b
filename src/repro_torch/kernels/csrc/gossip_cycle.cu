// Fused gossip-cycle receive step for Hopper (sm_90a): K sequential
// receive rounds per node, in place.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gossip_cycle.py
// fused_receive_apply (body _cycle_kernel, decode _decode_msg) with no
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
// Wire decode (template argument M): the messages m_k arrive as the wire
// codec's payload, a row of P elements per (round, node), and are decoded
// where they are read, so message traffic is paid at wire width (at d = 10:
// 40 B a message for f32, 20 B for bf16/f16, 10 B + 4 B of f16 scale and
// zero-point for int8, 5 B + 2 B for int4, 2 B + 2 B for ternary):
//   f32, bf16, f16   the value, upcast (__bfloat162float / __half2float);
//   affine8          float(q) * scale, then + zp: two roundings, as the
//                    plain version's separate multiply and add
//                    (--fmad=false keeps them apart);
//   int4             byte j / 2, low nibble for even j, sign-extended with
//                    ((nib + 8) & 0xF) - 8, times scale;
//   ternary          byte j / 5, digit (b / 3^(j % 5)) % 3, minus 1, times
//                    scale.
// Rows are read element by element, with no vector load: a packed row of
// ceil(d/2) or ceil(d/5) bytes starts at any byte.
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
// keeps a pointer to that message's payload row and decodes it again.
//
// Bound: the kernel moves bytes and does ~6 flops a byte-pair, so device
// memory bounds it (3.35 TB/s on an H100 SXM). Per launch it must read the
// (K, N) valid lanes and, for each valid (node, round), the message row and
// counter (plus its scale and zero-point) and write one cache row and
// counter; for each node with a valid round it reads x, y, ptr, count,
// last_t (and last_w for mu/um) and writes last_w, last_t, ptr, count.
// chip_smoke.py computes that byte count from the run's own valid mask and
// the codec's payload width. Compile with --fmad=false so products and sums
// round like the plain PyTorch version; only the order of the margin's sum
// differs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kNodesPerBlock = 8;
// Latency bounds the kernel, so the warps in flight matter: five blocks an
// SM (40 warps) caps a thread at 48 registers, the f32 kernel's count
// before the decode modes; without the cap ptxas gave the decode
// instantiations up to 64 and fewer warps fit.
constexpr int kMinBlocksPerSM = 5;

enum Variant { kRw = 0, kMu = 1, kUm = 2 };
enum Mode { kF32 = 0, kBF16 = 1, kF16 = 2, kAffine8 = 3, kInt4 = 4,
            kTernary = 5 };

// bytes per payload element
template <int M>
__host__ __device__ constexpr int elem_bytes() {
  return M == kF32 ? 4 : (M == kBF16 || M == kF16) ? 2 : 1;
}

// coefficient j of one message row, in _decode_msg's op order
template <int M>
__device__ __forceinline__ float decode(const unsigned char* row, int j,
                                        float scale, float zp) {
  if constexpr (M == kF32) {
    return reinterpret_cast<const float*>(row)[j];
  } else if constexpr (M == kBF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[j]);
  } else if constexpr (M == kF16) {
    return __half2float(reinterpret_cast<const __half*>(row)[j]);
  } else if constexpr (M == kAffine8) {
    const float q = static_cast<float>(reinterpret_cast<const int8_t*>(row)[j]);
    const float v = q * scale;
    return v + zp;
  } else if constexpr (M == kInt4) {
    const int b = row[j >> 1];
    const int nib = (j & 1) ? (b >> 4) : (b & 0xF);
    return static_cast<float>(((nib + 8) & 0xF) - 8) * scale;
  } else {
    const int b = row[j / 5];
    const int r = j % 5;
    const int p3 = r == 0 ? 1 : r == 1 ? 3 : r == 2 ? 9 : r == 3 ? 27 : 81;
    return static_cast<float>((b / p3) % 3 - 1) * scale;
  }
}

// one received message: its payload row and its decode metadata
struct Msg {
  const unsigned char* row;
  float scale;
  float zp;
};

template <int M>
__device__ __forceinline__ Msg message(const unsigned char* msg,
                                       const __half* msc, const __half* mzp,
                                       int64_t ri, int pw) {
  Msg m;
  m.row = msg + ri * pw * elem_bytes<M>();
  m.scale = (M == kAffine8 || M == kInt4 || M == kTernary)
                ? __half2float(msc[ri]) : 0.0f;
  m.zp = M == kAffine8 ? __half2float(mzp[ri]) : 0.0f;
  return m;
}

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

template <int V, int M>
__global__ void __launch_bounds__(kWarp * kNodesPerBlock, kMinBlocksPerSM)
fused_receive_kernel(float* __restrict__ last_w, int* __restrict__ last_t,
                     float* __restrict__ cache_w, int* __restrict__ cache_t,
                     int* __restrict__ ptr, int* __restrict__ count,
                     const unsigned char* __restrict__ msg,
                     const __half* __restrict__ msc,
                     const __half* __restrict__ mzp,
                     const int* __restrict__ msg_t,
                     const int* __restrict__ valid,
                     const float* __restrict__ x,
                     const float* __restrict__ y, int n, int d, int c, int k,
                     int pw, float lam) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kNodesPerBlock + threadIdx.x / kWarp;
  if (i >= n) return;

  const float* xi = x + i * d;
  const float yi = y[i];
  int p = ptr[i];
  int cnt = count[i];
  int lt = last_t[i];
  const float* lw = last_w + i * d;
  bool from_msg = false;  // false: lastModel is the last_w row
  Msg prev{nullptr, 0.0f, 0.0f};  // else: the latest valid round's message

  for (int r = 0; r < k; ++r) {
    const int64_t ri = static_cast<int64_t>(r) * n + i;
    if (valid[ri] <= 0) continue;
    const Msg cur = message<M>(msg, msc, mzp, ri, pw);
    const int mt = msg_t[ri];
    auto m = [&](int j) { return decode<M>(cur.row, j, cur.scale, cur.zp); };
    auto l = [&](int j) {
      return from_msg ? decode<M>(prev.row, j, prev.scale, prev.zp) : lw[j];
    };

    // pass 1: the margin(s) of the model(s) the Pegasos step updates
    float a1 = 0.0f, a2 = 0.0f;
    for (int j = lane; j < d; j += kWarp) {
      const float xj = xi[j];
      if (V == kMu) {
        const float w = (m(j) + l(j)) / 2.0f;
        a1 += w * xj;
      } else {
        a1 += m(j) * xj;
        if (V == kUm) a2 += l(j) * xj;
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
        out[j] = apply_step(s, (m(j) + l(j)) / 2.0f, xi[j]);
      }
      nt = s.t;
    } else if (V == kUm) {
      const Step s1 = pegasos_step(mt, yi * a1, yi, lam);
      const Step s2 = pegasos_step(lt, yi * a2, yi, lam);
      for (int j = lane; j < d; j += kWarp) {
        const float xj = xi[j];
        out[j] = (apply_step(s1, m(j), xj) + apply_step(s2, l(j), xj)) / 2.0f;
      }
      nt = max(s1.t, s2.t);
    } else {
      const Step s = pegasos_step(mt, yi * a1, yi, lam);
      for (int j = lane; j < d; j += kWarp) out[j] = apply_step(s, m(j), xi[j]);
      nt = s.t;
    }
    if (lane == 0) cache_t[i * c + p % c] = nt;
    p += 1;
    cnt = min(cnt + 1, c);
    from_msg = true;  // lastModel <- the received message
    prev = cur;
    lt = mt;
  }

  if (!from_msg) return;  // no valid round: the node is untouched
  for (int j = lane; j < d; j += kWarp) {
    last_w[i * d + j] = decode<M>(prev.row, j, prev.scale, prev.zp);
  }
  if (lane == 0) {
    last_t[i] = lt;
    ptr[i] = p;
    count[i] = cnt;
  }
}

struct Args {
  float* last_w;
  int* last_t;
  float* cache_w;
  int* cache_t;
  int* ptr;
  int* count;
  const unsigned char* msg;
  const __half* msc;
  const __half* mzp;
  const int* msg_t;
  const int* valid;
  const float* x;
  const float* y;
  int n, d, c, k, pw;  // pw: payload elements per message row
  float lam;
};

template <int V, int M>
void launch(const Args& a, cudaStream_t stream) {
  const unsigned blocks = (static_cast<unsigned>(a.n) + kNodesPerBlock - 1) /
                          kNodesPerBlock;
  fused_receive_kernel<V, M><<<blocks, kWarp * kNodesPerBlock, 0, stream>>>(
      a.last_w, a.last_t, a.cache_w, a.cache_t, a.ptr, a.count, a.msg, a.msc,
      a.mzp, a.msg_t, a.valid, a.x, a.y, a.n, a.d, a.c, a.k, a.pw, a.lam);
}

template <int V>
bool launch_mode(const Args& a, int mode, cudaStream_t s) {
  switch (mode) {
    case kF32: launch<V, kF32>(a, s); return true;
    case kBF16: launch<V, kBF16>(a, s); return true;
    case kF16: launch<V, kF16>(a, s); return true;
    case kAffine8: launch<V, kAffine8>(a, s); return true;
    case kInt4: launch<V, kInt4>(a, s); return true;
    case kTernary: launch<V, kTernary>(a, s); return true;
    default: return false;
  }
}

}  // namespace

// variant: 0 = rw, 1 = mu, 2 = um. mode: 0 = f32, 1 = bf16, 2 = f16,
// 3 = affine int8 (msc and mzp (K, N) f16), 4 = int4 and 5 = ternary (msc
// only). msg is the (K, N, P) payload. Returns cudaGetLastError() after the
// launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int gossip_cycle_fused_receive_apply(
    float* last_w, int* last_t, float* cache_w, int* cache_t, int* ptr,
    int* count, const void* msg, const void* msc, const void* mzp,
    const int* msg_t, const int* valid, const float* x, const float* y,
    int n, int d, int c, int k, int p, float lam, int variant, int mode,
    void* stream) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{last_w, last_t, cache_w, cache_t, ptr, count,
               static_cast<const unsigned char*>(msg),
               static_cast<const __half*>(msc),
               static_cast<const __half*>(mzp), msg_t, valid, x, y, n, d, c,
               k, p, lam};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (variant) {
    case kRw: ok = launch_mode<kRw>(a, mode, s); break;
    case kMu: ok = launch_mode<kMu>(a, mode, s); break;
    case kUm: ok = launch_mode<kUm>(a, mode, s); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gossip_cycle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
