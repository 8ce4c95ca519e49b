// Fused gossip-cycle receive step for Hopper (sm_90a): K sequential
// receive rounds per node, in place.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gossip_cycle.py
// fused_receive_apply (body _cycle_kernel, decode _decode_msg, and the
// inlined screen faults.apply_defense). For every node i and every round k
// with valid[k, i]:
//
//   m_k   = SCREEN(m_k, lastModel)            (template argument F; a
//                                              rejected m_k skips the round)
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
// Screen (template argument F), between the decode and the merge of every
// valid round, against the current lastModel lw, with sq = sum m^2 and
// rn = sum lw^2 (warp sums; nothing is padded, so nothing is masked):
//   none         nothing; the gated/clipped counts stay 0;
//   norm_clip    thr = max(4 rn, 1); a non-finite sq rejects the message,
//                sq > thr rescales it by sqrt(thr / max(sq, 1e-30));
//   cosine_gate  with dot = sum m lw: a non-finite sq, or rn > 1e-6 and
//                dot < -0.2 sqrt(sq rn), rejects the message.
// A rejected message is not received (no cache write, lastModel kept); it
// adds 1 to the node's gated count, a rescaled one 1 to its clipped count.
// The constants are the reference's float32 values, and IEEE sqrtf and
// division keep the scale's rounding (no --use_fast_math). The reference's
// arithmetic flushes subnormals to zero, and a verdict can turn on one (a
// bitflip makes a zero coefficient subnormal), so the screen flushes what
// faults.apply_defense flushes: its inputs, every product, the clip ratio
// and sq rn, and a rescaled coefficient (ftz below; the sums' terms are
// never subnormal).
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
// Under norm_clip the running lastModel is the rescaled message, so the
// kernel keeps the message's clip factor (kNoClip, or the rescale) beside
// the pointer and rescales after the decode, in the plain version's order.
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
enum Defense { kNone = 0, kNormClip = 1, kCosineGate = 2 };

// the screen's constants: the reference's Python doubles rounded to float32
constexpr float kClipMultSq = 4.0f;        // NORM_CLIP_MULT ** 2
constexpr float kClipFloorSq = 1.0f;       // NORM_CLIP_FLOOR ** 2
constexpr float kClipSqGuard = 1e-30f;
constexpr float kGateMinNormSq = 1e-6f;    // COSINE_GATE_MIN_NORM ** 2
constexpr float kGateThreshold = -0.2f;    // COSINE_GATE_THRESHOLD
constexpr float kFltMin = 1.17549435e-38f;  // smallest normal float
constexpr float kNoClip = -1.0f;  // clip factor of a message not rescaled

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

// v with a subnormal value flushed to a zero of its sign
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < kFltMin ? copysignf(0.0f, v) : v;
}

// a decoded coefficient as the norm_clip screen left it: unchanged, or
// flushed and rescaled by clip (>= 0)
__device__ __forceinline__ float rescaled(float v, float clip) {
  return clip == kNoClip ? v : ftz(ftz(v) * clip);
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

template <int V, int M, int F>
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
                     const float* __restrict__ y,
                     int* __restrict__ counts, int n, int d, int c, int k,
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
  float prev_f = kNoClip;         // and its norm_clip factor
  int gated = 0, clipped = 0;

  for (int r = 0; r < k; ++r) {
    const int64_t ri = static_cast<int64_t>(r) * n + i;
    if (valid[ri] <= 0) continue;
    const Msg cur = message<M>(msg, msc, mzp, ri, pw);
    auto raw = [&](int j) { return decode<M>(cur.row, j, cur.scale, cur.zp); };
    auto l = [&](int j) {
      if (!from_msg) return lw[j];
      const float v = decode<M>(prev.row, j, prev.scale, prev.zp);
      return F == kNormClip ? rescaled(v, prev_f) : v;
    };

    // the screen against the current lastModel
    float f = kNoClip;
    if constexpr (F != kNone) {
      float sq = 0.0f, rn = 0.0f, dot = 0.0f;
      for (int j = lane; j < d; j += kWarp) {
        const float mj = ftz(raw(j));
        const float lj = ftz(l(j));
        sq += ftz(mj * mj);
        rn += ftz(lj * lj);
        if (F == kCosineGate) dot += ftz(mj * lj);
      }
      sq = warp_sum(sq);
      rn = warp_sum(rn);
      bool reject = !isfinite(sq);
      if constexpr (F == kNormClip) {
        const float thr = fmaxf(kClipMultSq * rn, kClipFloorSq);
        if (!reject && sq > thr) {
          f = sqrtf(ftz(thr / fmaxf(sq, kClipSqGuard)));
          clipped += 1;
        }
      } else {
        dot = warp_sum(dot);
        reject = reject || (rn > kGateMinNormSq &&
                            dot < kGateThreshold * sqrtf(ftz(sq * rn)));
      }
      if (reject) {
        gated += 1;
        continue;
      }
    }
    auto m = [&](int j) {
      return F == kNormClip ? rescaled(raw(j), f) : raw(j);
    };
    const int mt = msg_t[ri];

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
    from_msg = true;  // lastModel <- the received (screened) message
    prev = cur;
    prev_f = f;
    lt = mt;
  }

  if (F != kNone && lane == 0) {  // counts are 0 unless written
    if (gated) counts[i] = gated;
    if (clipped) counts[n + i] = clipped;
  }
  if (!from_msg) return;  // nothing received: the node is untouched
  for (int j = lane; j < d; j += kWarp) {
    const float v = decode<M>(prev.row, j, prev.scale, prev.zp);
    last_w[i * d + j] = F == kNormClip ? rescaled(v, prev_f) : v;
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
  int* counts;  // (2, N): gated, then clipped; zero on entry; null (and
                // never read) under kNone
  int n, d, c, k, pw;  // pw: payload elements per message row
  float lam;
};

template <int V, int M, int F>
void launch(const Args& a, cudaStream_t stream) {
  const unsigned blocks = (static_cast<unsigned>(a.n) + kNodesPerBlock - 1) /
                          kNodesPerBlock;
  fused_receive_kernel<V, M, F>
      <<<blocks, kWarp * kNodesPerBlock, 0, stream>>>(
          a.last_w, a.last_t, a.cache_w, a.cache_t, a.ptr, a.count, a.msg,
          a.msc, a.mzp, a.msg_t, a.valid, a.x, a.y, a.counts, a.n, a.d, a.c,
          a.k, a.pw, a.lam);
}

template <int V, int F>
bool launch_mode(const Args& a, int mode, cudaStream_t s) {
  switch (mode) {
    case kF32: launch<V, kF32, F>(a, s); return true;
    case kBF16: launch<V, kBF16, F>(a, s); return true;
    case kF16: launch<V, kF16, F>(a, s); return true;
    case kAffine8: launch<V, kAffine8, F>(a, s); return true;
    case kInt4: launch<V, kInt4, F>(a, s); return true;
    case kTernary: launch<V, kTernary, F>(a, s); return true;
    default: return false;
  }
}

template <int F>
bool launch_variant(const Args& a, int variant, int mode, cudaStream_t s) {
  switch (variant) {
    case kRw: return launch_mode<kRw, F>(a, mode, s);
    case kMu: return launch_mode<kMu, F>(a, mode, s);
    case kUm: return launch_mode<kUm, F>(a, mode, s);
    default: return false;
  }
}

}  // namespace

// variant: 0 = rw, 1 = mu, 2 = um. mode: 0 = f32, 1 = bf16, 2 = f16,
// 3 = affine int8 (msc and mzp (K, N) f16), 4 = int4 and 5 = ternary (msc
// only). defense: 0 = none, 1 = norm_clip, 2 = cosine_gate. msg is the
// (K, N, P) payload; counts the (2, N) gated and clipped counts, zeroed by
// the caller, or null under defense 0, which writes none. Returns cudaGetLastError() after the launch (0 on success);
// the launch is asynchronous on `stream`.
extern "C" int gossip_cycle_fused_receive_apply(
    float* last_w, int* last_t, float* cache_w, int* cache_t, int* ptr,
    int* count, const void* msg, const void* msc, const void* mzp,
    const int* msg_t, const int* valid, const float* x, const float* y,
    int* counts, int n, int d, int c, int k, int p, float lam, int variant,
    int mode, int defense, void* stream) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{last_w, last_t, cache_w, cache_t, ptr, count,
               static_cast<const unsigned char*>(msg),
               static_cast<const __half*>(msc),
               static_cast<const __half*>(mzp), msg_t, valid, x, y, counts,
               n, d, c, k, p, lam};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (defense) {
    case kNone: ok = launch_variant<kNone>(a, variant, mode, s); break;
    case kNormClip: ok = launch_variant<kNormClip>(a, variant, mode, s); break;
    case kCosineGate:
      ok = launch_variant<kCosineGate>(a, variant, mode, s);
      break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gossip_cycle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
