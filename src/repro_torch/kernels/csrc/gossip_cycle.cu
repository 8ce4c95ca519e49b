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
// rn = sum lw^2 (shuffle sums; nothing is padded, so nothing is masked).
// The screen's sums (sq, rn, dot) take the order of the jitted reference,
// the order its engines run (faults._screen_sum and its note): at d <= 32
// each term's two factors are read in lane order by __shfl_sync and
// added from +0.0 by fused multiply-adds in sequence (the products
// rounded apart at 5 <= d <= 8 on the nodes faults.screen_split names,
// which the launch passes as two ScreenSplits; screen_sums); at
// 33 <= d <= 64 the
// rounded products in two halves (sum_halves), and at multiples of 32
// in 32-wide chunks, both on the strided route only; so verdicts on exact
// ties are the reference's. At other d the order is not known, and the
// sums are 32-lane butterflies (warp_sum). The screens:
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
// In place: last_w, last_t, cache_w, cache_t, ptr and count are updated
// where they lie (the JAX chunk function donates its carry, so nothing is
// lost). A node reads its valid rounds' messages, its example and its
// lastModel, writes one cache row per valid round and its lastModel once:
// about (K + 3) d floats instead of rewriting its whole C d cache. A node
// with no valid round is not written at all.
//
// Bound: the kernel moves bytes and does ~6 flops a byte-pair, so device
// memory bounds it (3.35 TB/s on an H100 SXM). Per launch it must read the
// (K, N) valid lanes and, for each valid (node, round), the message row and
// counter (plus its scale and zero-point) and write one cache row and
// counter; for each node with a valid round it reads x, y, ptr, count,
// last_t (and last_w for mu/um and under a screen) and writes last_w,
// last_t, ptr, count. chip_smoke.py::receive_bound computes that byte
// count from the run's own valid mask and the codec's payload width: at
// the main path's N = 10^6, d = 10, K = 4, with about 9 % of the
// (node, round) lanes valid, 80-100 MB, 0.024-0.030 ms. Those bytes are
// scattered: a 40-byte row at any offset costs two or three 32-byte
// sectors, and each valid round and each receiving node touch rows of
// their own, so the sectors the card must move are ~2x the bound's bytes.
// Compile with --fmad=false so products and sums round like the plain
// PyTorch version; only the order of the sums differs.
//
// Two layouts, chosen before the launch by gossip_cycle.py::receive_route
// (the C entry takes the choice as an argument and refuses a grouped
// launch outside its range):
//
// strided (the first layout; every d and K): one warp a node, lanes striding
// over d, sums as 32-lane xor butterflies (warp_sum), the rounds in order
// with each round's loads issued when the round starts. It is
// latency-bound at small d, for three reasons:
//   1. at d = 10, 22 of 32 lanes idle, and a load instruction moves 40 B;
//   2. a node is a chain of ~1 + 2K dependent trips to device memory: the
//      valid flag of round r is read inside the round loop and branched
//      on, so round r + 1's loads wait for round r's flag, message, margin
//      and cache store;
//   3. five blocks of eight warps an SM keep 40 nodes in flight an SM,
//      ~0.2-0.7 MB across the card, where Little's law at 3.35 TB/s and
//      ~0.6 us asks for ~2 MB. It also decodes a message row from device
//      memory up to three times (screen, margin, update) and the running
//      lastModel again from the previous message's row on every use.
// It keeps a pointer to the latest valid round's payload row (and its
// norm_clip factor) as the running lastModel and decodes it again.
//
// grouped (d <= 32 and K <= 8, the main path's widths): each node takes a
// group of G lanes, G the smallest power of two >= d (d = 10: G = 16, two
// nodes a warp; d = 1: G = 1, 32 a warp), coefficient j on lane j of its
// group. What it does about each cause:
//   1. Lanes: G - d of G idle instead of 32 - d of 32.
//   2. Trips: a node costs two dependent trips, not ~1 + 2K. Trip 1: a
//      block stages 256 nodes' valid flags and msg_t for every round, ptr,
//      count, last_t and y into shared memory with cp.async, one thread a
//      node, every copy coalesced and issued before any is used. Trip 2:
//      each group issues, for every valid round at once, the payload row
//      (element j on lane j) with its f16 scale and zero-point, and x[i]
//      and last_w[i] when the node has a valid round. The K rounds then
//      run in order from registers: each row is read once, x once, and
//      the running lastModel is a register (the screened message of the
//      latest accepted round), never decoded again.
//   3. Bytes in flight: blocks are persistent (as many as fit, each
//      walking stages blockIdx.x, + gridDim.x, ...), and a block's next
//      stage of flags is copied while it runs the current one, so trip 1
//      is off the critical path: 256 nodes x (2K + 4) ints, 12 KB a block
//      at K = 4, ~8 MB across the card. Within a stage the block runs 256
//      / G nodes at a time (G tiles); a warp moves from tile to tile with
//      no barrier, skips a tile none of its nodes receives in (most of
//      them on the main path) without a load, and keeps its groups' trip 2
//      loads in flight together.
// The round loop is uniform across the warp (a round no group of the warp
// receives is skipped by __any_sync), so every shuffle runs with all 32
// lanes; a group whose round is not valid, or whose message was rejected,
// predicates its work off. The screen's sums take the same order on both
// routes (screen_sums); the margins are xor butterflies over the group's G lanes
// (group_sum): for d <= G the 32-lane tree's other levels add only +0.0 to
// each lane's one term, and no partial sum is -0.0 (each starts at +0.0),
// so the two trees give the same bits, and the grouped route gives the
// strided route's state, cache_t and counts bit for bit. Staging
// msg_t, ptr, count, last_t and y for every node costs little beyond the
// bound's bytes: with ~9 % of (node, round) lanes valid, most 32-byte
// sectors of those arrays hold a node that needs them anyway.
//
// On an H100 SXM at 700 W the grouped kernel's time per launch at the main
// path's inputs does not move with the blocks an SM (4, 5 or 6), so the
// warps in flight no longer bound it; the scattered sectors above and the
// instructions a node costs (two nodes a warp at d = 10) are what is left.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiled.cuh"  // the cp.async helpers

namespace {

constexpr int kWarp = 32;
constexpr int kNodesPerBlock = 8;
// Latency bounds the kernel, so the warps in flight matter: five blocks an
// SM (40 warps) caps a thread at 48 registers, the f32 kernel's count
// before the decode modes; without the cap ptxas gave the decode
// instantiations up to 64 and fewer warps fit.
constexpr int kMinBlocksPerSM = 5;

// the grouped route
constexpr int kLog2GroupedThreads = 8;
constexpr int kGroupedThreads = 1 << kLog2GroupedThreads;  // 256 / G nodes
constexpr int kGroupedMaxWidth = 32;   // d it takes at most
constexpr int kGroupedMaxRounds = 8;   // K it takes at most
// Blocks an SM: each thread holds KMAX rounds of prefetched payload bits,
// scale and zero-point; four blocks (32 warps) leave ptxas up to 64
// registers a thread, which no instantiation spills, where five (48) spill
// um under a screen. The warps in flight do not bound the kernel (the
// note above), so the fewer warps cost nothing.
constexpr int kGroupedMinBlocks = 4;

enum Variant { kRw = 0, kMu = 1, kUm = 2 };
enum Mode { kF32 = 0, kBF16 = 1, kF16 = 2, kAffine8 = 3, kInt4 = 4,
            kTernary = 5 };
enum Defense { kNone = 0, kNormClip = 1, kCosineGate = 2 };
enum Route { kGrouped = 0, kStrided = 1 };

// the screen's constants: the reference's Python doubles rounded to float32
constexpr float kClipMultSq = 4.0f;        // NORM_CLIP_MULT ** 2
constexpr float kClipFloorSq = 1.0f;       // NORM_CLIP_FLOOR ** 2
constexpr float kClipSqGuard = 1e-30f;
constexpr float kGateMinNormSq = 1e-6f;    // COSINE_GATE_MIN_NORM ** 2
constexpr float kGateThreshold = -0.2f;    // COSINE_GATE_THRESHOLD
constexpr float kFltMin = 1.17549435e-38f;  // smallest normal float
constexpr float kNoClip = -1.0f;  // clip factor of a message not rescaled
// the widths at which the jitted reference sums some nodes' screen sums
// unfused (faults.screen_split)
constexpr int kUnfusedMin = 5;
constexpr int kUnfusedMax = 8;

// Which nodes the jitted reference sums unfused at kUnfusedMin <= d <=
// kUnfusedMax, for the squares (one array read) or the dot (two), as
// faults.screen_split gives it: node i lies in workgroup i / rows and is
// summed unfused where its place in it is below that workgroup's vector
// rows (`last` from the last workgroup's first node `last_start` on,
// `full` before).
struct ScreenSplit {
  int rows, full, last, last_start;
};

__device__ __forceinline__ bool sums_apart(int i, int d, ScreenSplit s) {
  if (d < kUnfusedMin || d > kUnfusedMax) return false;
  const int vec = i >= s.last_start ? s.last : s.full;
  return i % s.rows < vec;
}

// bytes per payload element
template <int M>
__host__ __device__ constexpr int elem_bytes() {
  return M == kF32 ? 4 : (M == kBF16 || M == kF16) ? 2 : 1;
}

// the payload bits that hold coefficient j of one message row, loaded and
// not yet decoded
template <int M>
__device__ __forceinline__ uint32_t fetch(const unsigned char* row, int j) {
  if constexpr (M == kF32) {
    return __float_as_uint(reinterpret_cast<const float*>(row)[j]);
  } else if constexpr (M == kBF16 || M == kF16) {
    return reinterpret_cast<const unsigned short*>(row)[j];
  } else if constexpr (M == kAffine8) {
    return static_cast<uint32_t>(
        static_cast<int>(reinterpret_cast<const int8_t*>(row)[j]));
  } else if constexpr (M == kInt4) {
    return row[j >> 1];
  } else {
    return row[j / 5];
  }
}

// coefficient j from its fetched bits, in _decode_msg's op order
template <int M>
__device__ __forceinline__ float unpack(uint32_t bits, int j, float scale,
                                        float zp) {
  if constexpr (M == kF32) {
    return __uint_as_float(bits);
  } else if constexpr (M == kBF16) {
    return __bfloat162float(
        __ushort_as_bfloat16(static_cast<unsigned short>(bits)));
  } else if constexpr (M == kF16) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
  } else if constexpr (M == kAffine8) {
    const float q = static_cast<float>(static_cast<int>(bits));
    const float v = q * scale;
    return v + zp;
  } else if constexpr (M == kInt4) {
    const int b = static_cast<int>(bits);
    const int nib = (j & 1) ? (b >> 4) : (b & 0xF);
    return static_cast<float>(((nib + 8) & 0xF) - 8) * scale;
  } else {
    const int b = static_cast<int>(bits);
    const int r = j % 5;
    const int p3 = r == 0 ? 1 : r == 1 ? 3 : r == 2 ? 9 : r == 3 ? 27 : 81;
    return static_cast<float>((b / p3) % 3 - 1) * scale;
  }
}

// coefficient j of one message row
template <int M>
__device__ __forceinline__ float decode(const unsigned char* row, int j,
                                        float scale, float zp) {
  return unpack<M>(fetch<M>(row, j), j, scale, zp);
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

// the sum of v over an aligned group of g lanes (g a power of two <= 32),
// levels g/2 ... 1 as in warp_sum; every lane of the warp must call it
__device__ __forceinline__ float group_sum(float v, int g) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    if (o < g) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// a b + c rounded once, a b and a + b, with subnormal operands and results
// flushed to a zero of their sign (the .ftz forms), as the reference's
// arithmetic flushes them
__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The screen's sums at d <= 32 in the jitted reference's order
// (faults._screen_sum): coefficient j of the node lies on lane base + j,
// where m and l hold its two factors (flushed; +0.0 where the node's round
// is not active), and sq = sum m m, rn = sum l l and (with DOT) dot =
// sum m l read them in lane order and add from +0.0: at d = 1 the one
// product; at kUnfusedMin <= d <= kUnfusedMax the products rounded apart,
// in sequence, for sq and rn where `apart` (sums_apart with the squares'
// split) and for dot where `dot_apart`, else fused multiply-adds in
// sequence; at every other d fused multiply-adds in sequence. Each
// result is flushed, as the reference's arithmetic flushes it, by the
// instruction's own .ftz form (the inputs are flushed already): on an H100
// at 700 W that took the cosine_gate screen at N = 10^6, d = 10 from 0.90
// ms to 0.67 ms a launch against a flush after each operation, and the
// loops stay rolled (unrolled, some instantiations spill). Every lane of
// the warp must call it.
template <bool DOT>
__device__ __forceinline__ void screen_sums(float m, float l, float& sq,
                                            float& rn, float& dot, int base,
                                            int d, bool apart,
                                            bool dot_apart) {
  float s = 0.0f, r = 0.0f, t = 0.0f;
  if (d == 1) {
    const float mj = __shfl_sync(0xffffffffu, m, base);
    const float lj = __shfl_sync(0xffffffffu, l, base);
    s = ftz(mj * mj);
    r = ftz(lj * lj);
    if (DOT) t = ftz(mj * lj);
  } else if (d < kUnfusedMin || d > kUnfusedMax) {
#pragma unroll 1
    for (int j = 0; j < d; ++j) {
      const float mj = __shfl_sync(0xffffffffu, m, base + j);
      const float lj = __shfl_sync(0xffffffffu, l, base + j);
      s = fma_ftz(mj, mj, s);
      r = fma_ftz(lj, lj, r);
      if (DOT) t = fma_ftz(mj, lj, t);
    }
  } else {  // the lanes of one warp may hold nodes of either order
#pragma unroll 1
    for (int j = 0; j < d; ++j) {
      const float mj = __shfl_sync(0xffffffffu, m, base + j);
      const float lj = __shfl_sync(0xffffffffu, l, base + j);
      s = apart ? add_ftz(s, mul_ftz(mj, mj)) : fma_ftz(mj, mj, s);
      r = apart ? add_ftz(r, mul_ftz(lj, lj)) : fma_ftz(lj, lj, r);
      if (DOT) {
        t = dot_apart ? add_ftz(t, mul_ftz(mj, lj)) : fma_ftz(mj, lj, t);
      }
    }
  }
  sq = s;
  rn = r;
  if (DOT) dot = t;
}

// acc plus v of lanes from ... to - 1, added in lane order, each partial
// sum flushed; every lane of the warp must call it
__device__ __forceinline__ float lanes_in_sequence(float acc, float v,
                                                   int from, int to) {
#pragma unroll 1
  for (int j = from; j < to; ++j) {
    acc = ftz(acc + __shfl_sync(0xffffffffu, v, j));
  }
  return acc;
}

// the sum of a row of 32 < d <= 64 rounded terms, term j on lane j % 32 of
// t0 (j < 32) or t1, as two halves, j < ceil(d / 2) and the rest, each in
// sequence from +0.0, then added (the jitted reference's order there)
__device__ __forceinline__ float sum_halves(float t0, float t1, int d) {
  const int h = (d + 1) / 2;
  const float a = lanes_in_sequence(0.0f, t0, 0, h);
  const float b = lanes_in_sequence(lanes_in_sequence(0.0f, t0, h, kWarp),
                                    t1, 0, d - kWarp);
  return ftz(a + b);
}

// the screen's verdict on the summed sq, rn and dot (dot is read only by
// cosine_gate): whether it rejects the message; f is set to the norm_clip
// rescale of a clipped message, else kNoClip
template <int F>
__device__ __forceinline__ bool screen_rejects(float sq, float rn, float dot,
                                               float& f) {
  f = kNoClip;
  const bool bad = !isfinite(sq);
  if constexpr (F == kNormClip) {
    const float thr = fmaxf(kClipMultSq * rn, kClipFloorSq);
    if (!bad && sq > thr) f = sqrtf(ftz(thr / fmaxf(sq, kClipSqGuard)));
    return bad;
  } else {
    return bad || (rn > kGateMinNormSq &&
                   dot < kGateThreshold * sqrtf(ftz(sq * rn)));
  }
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
                     int pw, float lam, ScreenSplit sq_split,
                     ScreenSplit dot_split) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kNodesPerBlock + threadIdx.x / kWarp;
  if (i >= n) return;
  // the screen's sum order for this node (at 5 <= d <= 8)
  const bool apart =
      F != kNone && sums_apart(static_cast<int>(i), d, sq_split);
  const bool dot_apart =
      F == kCosineGate && sums_apart(static_cast<int>(i), d, dot_split);

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

    // the screen against the current lastModel, its sums in the jitted
    // reference's order where that is known (the note above)
    float f = kNoClip;
    if constexpr (F != kNone) {
      constexpr bool kDot = F == kCosineGate;
      // the factors of coefficient j, flushed, and +0.0 past d
      auto mf = [&](int j) { return j < d ? ftz(raw(j)) : 0.0f; };
      auto lf = [&](int j) { return j < d ? ftz(l(j)) : 0.0f; };
      float sq = 0.0f, rn = 0.0f, dot = 0.0f;
      if (d <= kWarp) {
        screen_sums<kDot>(mf(lane), lf(lane), sq, rn, dot, 0, d, apart,
                          dot_apart);
      } else if (d <= 2 * kWarp) {
        const float m0 = mf(lane), m1 = mf(lane + kWarp);
        const float l0 = lf(lane), l1 = lf(lane + kWarp);
        sq = sum_halves(ftz(m0 * m0), ftz(m1 * m1), d);
        rn = sum_halves(ftz(l0 * l0), ftz(l1 * l1), d);
        if (kDot) dot = sum_halves(ftz(m0 * l0), ftz(m1 * l1), d);
      } else if (d % kWarp == 0) {  // 32-wide chunks, then their sums
        for (int c0 = 0; c0 < d; c0 += kWarp) {
          const float mj = mf(c0 + lane), lj = lf(c0 + lane);
          sq = ftz(sq + lanes_in_sequence(0.0f, ftz(mj * mj), 0, kWarp));
          rn = ftz(rn + lanes_in_sequence(0.0f, ftz(lj * lj), 0, kWarp));
          if (kDot) {
            dot = ftz(dot + lanes_in_sequence(0.0f, ftz(mj * lj), 0, kWarp));
          }
        }
      } else {  // the order is not known: 32-lane butterflies
        for (int j = lane; j < d; j += kWarp) {
          const float mj = ftz(raw(j));
          const float lj = ftz(l(j));
          sq += ftz(mj * mj);
          rn += ftz(lj * lj);
          if (kDot) dot += ftz(mj * lj);
        }
        sq = warp_sum(sq);
        rn = warp_sum(rn);
        if (kDot) dot = warp_sum(dot);
      }
      const bool reject = screen_rejects<F>(sq, rn, dot, f);
      if (f != kNoClip) clipped += 1;
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

// Trip 1 of one stage of kGroupedThreads nodes, thread t's node base + t:
// its valid flags and msg_t for every round, then ptr, count, last_t and y
// (2K + 4 rows of kGroupedThreads ints), copied asynchronously, 4 bytes a
// copy, each row's copies coalesced across the block. Nodes past n get
// zero valid flags.
__device__ __forceinline__ void stage_nodes(
    int* stage, int64_t base, int n, int k, const int* __restrict__ valid,
    const int* __restrict__ msg_t, const int* __restrict__ ptr,
    const int* __restrict__ count, const int* __restrict__ last_t,
    const float* __restrict__ y) {
  const int t = threadIdx.x;
  const int64_t i = base + t;
  if (i >= n) {
    for (int r = 0; r < k; ++r) stage[r * kGroupedThreads + t] = 0;
    return;
  }
  for (int r = 0; r < k; ++r) {
    const int64_t ri = static_cast<int64_t>(r) * n + i;
    cp_async4(stage + r * kGroupedThreads + t, valid + ri);
    cp_async4(stage + (k + r) * kGroupedThreads + t, msg_t + ri);
  }
  int* rest = stage + 2 * k * kGroupedThreads + t;
  cp_async4(rest, ptr + i);
  cp_async4(rest + kGroupedThreads, count + i);
  cp_async4(rest + 2 * kGroupedThreads, last_t + i);
  cp_async4(rest + 3 * kGroupedThreads, y + i);
}

// The grouped route: a group of g = 2^log2g lanes a node, every operand of
// every valid round issued before the rounds run (the note above). Blocks
// are persistent: each walks stages of kGroupedThreads nodes, blockIdx.x,
// + gridDim.x, ..., staging the next stage's flags (trip 1) while it runs
// the current one, a tile of kGroupedThreads / g nodes at a time; a warp
// runs its groups' nodes of each tile in turn with no barrier between
// tiles. KMAX bounds k; the arithmetic is fused_receive_kernel's, op for op.
template <int V, int M, int F, int KMAX>
__global__ void __launch_bounds__(kGroupedThreads, kGroupedMinBlocks)
fused_receive_grouped_kernel(
    float* __restrict__ last_w, int* __restrict__ last_t,
    float* __restrict__ cache_w, int* __restrict__ cache_t,
    int* __restrict__ ptr, int* __restrict__ count,
    const unsigned char* __restrict__ msg, const __half* __restrict__ msc,
    const __half* __restrict__ mzp, const int* __restrict__ msg_t,
    const int* __restrict__ valid, const float* __restrict__ x,
    const float* __restrict__ y, int* __restrict__ counts, int n, int d,
    int c, int k, int pw, float lam, ScreenSplit sq_split,
    ScreenSplit dot_split, int log2g, int stages) {
  constexpr bool kReadsLast = V != kRw || F != kNone;
  constexpr int kFields = 2 * KMAX + 4;
  // two stages' fields: valid (k rows), msg_t (k rows), ptr, count,
  // last_t, y, each row kGroupedThreads ints
  __shared__ int s_stage[2][kFields * kGroupedThreads];

  const int g = 1 << log2g;
  const int log2tile = kLog2GroupedThreads - log2g;
  const int j = threadIdx.x & (g - 1);  // this lane's coefficient
  const bool lane_on = j < d;
  // a round's payload rows, scales and flags lie n rows apart
  const int64_t row_step = static_cast<int64_t>(n) * pw * elem_bytes<M>();

  if (static_cast<int>(blockIdx.x) < stages) {
    stage_nodes(s_stage[0],
                static_cast<int64_t>(blockIdx.x) << kLog2GroupedThreads, n, k,
                valid, msg_t, ptr, count, last_t, y);
  }
  cp_async_commit();

  int buf = 0;
  for (int sg = blockIdx.x; sg < stages; sg += gridDim.x, buf ^= 1) {
    // every thread is done with the other buffer (the previous stage), so
    // the next stage's flags may land there while this one runs
    __syncthreads();
    const int next = sg + gridDim.x;
    if (next < stages) {
      stage_nodes(s_stage[buf ^ 1],
                  static_cast<int64_t>(next) << kLog2GroupedThreads, n, k,
                  valid, msg_t, ptr, count, last_t, y);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();  // this stage's copies have landed
    __syncthreads();

    const int* st = s_stage[buf];
    for (int tl = 0; tl < g; ++tl) {
      // this group's node, within the stage and in all
      const int node = (tl << log2tile) + (threadIdx.x >> log2g);
      const int64_t i =
          (static_cast<int64_t>(sg) << kLog2GroupedThreads) + node;
      int mask = 0;  // bit r: round r is valid (0 past n)
#pragma unroll
      for (int r = 0; r < KMAX; ++r) {
        if (r < k && st[r * kGroupedThreads + node] > 0) mask |= 1 << r;
      }
      // a warp none of whose nodes receives has nothing to load or write
      if (!__any_sync(0xffffffffu, mask != 0)) continue;
      // the screen's sum order for this node (at 5 <= d <= 8)
      const bool apart =
          F != kNone && sums_apart(static_cast<int>(i), d, sq_split);
      const bool dot_apart =
          F == kCosineGate && sums_apart(static_cast<int>(i), d, dot_split);

      // trip 2: every valid round's payload bits, scale and zero-point, and
      // x and last_w, all issued before the rounds run
      uint32_t bits[KMAX];
      float scale[KMAX], zp[KMAX];
      const unsigned char* row0 = msg + i * pw * elem_bytes<M>();  // round 0
#pragma unroll
      for (int r = 0; r < KMAX; ++r) {
        bits[r] = 0;
        scale[r] = 0.0f;
        zp[r] = 0.0f;
        if ((mask >> r) & 1) {
          const int64_t ri = static_cast<int64_t>(r) * n + i;
          if (M == kAffine8 || M == kInt4 || M == kTernary) {
            scale[r] = __half2float(msc[ri]);
          }
          if (M == kAffine8) zp[r] = __half2float(mzp[ri]);
          if (lane_on) bits[r] = fetch<M>(row0 + r * row_step, j);
        }
      }
      float xj = 0.0f, lcur = 0.0f;  // lcur: the running lastModel
      if (mask != 0 && lane_on) {
        xj = x[i * d + j];
        if (kReadsLast) lcur = last_w[i * d + j];
      }
      const int* counters = st + 2 * k * kGroupedThreads + node;
      int p = counters[0];
      int ring = p % c;  // ring slot ptr % C, advanced with p below
      int cnt = counters[kGroupedThreads];
      int lt = counters[2 * kGroupedThreads];
      const float yi = __int_as_float(counters[3 * kGroupedThreads]);
      bool got = false;  // a message was received
      int gated = 0, clipped = 0;

#pragma unroll
      for (int r = 0; r < KMAX; ++r) {
        bool act = (mask >> r) & 1;
        if (!__any_sync(0xffffffffu, act)) continue;  // uniform in the warp
        const bool on = act && lane_on;
        const float raw = on ? unpack<M>(bits[r], j, scale[r], zp[r]) : 0.0f;

        // the screen against the current lastModel
        float f = kNoClip;
        if constexpr (F != kNone) {
          float sq, rn, dot = 0.0f;
          screen_sums<F == kCosineGate>(
              on ? ftz(raw) : 0.0f, on ? ftz(lcur) : 0.0f, sq, rn, dot,
              (threadIdx.x % kWarp) & ~(g - 1), d, apart, dot_apart);
          const bool reject = screen_rejects<F>(sq, rn, dot, f);
          if (f != kNoClip) clipped += act;
          if (reject) {
            gated += act;
            act = false;
          }
        }
        const bool use = act && lane_on;
        const float mj = F == kNormClip ? rescaled(raw, f) : raw;
        const int mt = st[(k + r) * kGroupedThreads + node];

        // the margin(s) of the model(s) the Pegasos step updates, then the
        // new model for ring slot ptr % C
        float a1 = 0.0f, a2 = 0.0f, out;
        int nt;
        if (V == kMu) {
          const float w = (mj + lcur) / 2.0f;
          if (use) a1 += w * xj;
          a1 = group_sum(a1, g);
          const Step s = pegasos_step(max(mt, lt), yi * a1, yi, lam);
          out = apply_step(s, w, xj);
          nt = s.t;
        } else if (V == kUm) {
          if (use) {
            a1 += mj * xj;
            a2 += lcur * xj;
          }
          a1 = group_sum(a1, g);
          a2 = group_sum(a2, g);
          const Step s1 = pegasos_step(mt, yi * a1, yi, lam);
          const Step s2 = pegasos_step(lt, yi * a2, yi, lam);
          out = (apply_step(s1, mj, xj) + apply_step(s2, lcur, xj)) / 2.0f;
          nt = max(s1.t, s2.t);
        } else {
          if (use) a1 += mj * xj;
          a1 = group_sum(a1, g);
          const Step s = pegasos_step(mt, yi * a1, yi, lam);
          out = apply_step(s, mj, xj);
          nt = s.t;
        }
        if (act) {
          const int64_t slot = i * c + ring;
          if (lane_on) cache_w[slot * d + j] = out;
          if (j == 0) cache_t[slot] = nt;
          p += 1;
          ring = ring + 1 == c ? 0 : ring + 1;  // p % C: p counts up from 0
          cnt = min(cnt + 1, c);
          lcur = mj;  // lastModel <- the received (screened) message
          lt = mt;
          got = true;
        }
      }

      if (F != kNone && j == 0) {  // counts are 0 unless written
        if (gated) counts[i] = gated;
        if (clipped) counts[n + i] = clipped;
      }
      if (got) {  // nothing received: the node is untouched
        if (lane_on) last_w[i * d + j] = lcur;
        if (j == 0) {
          last_t[i] = lt;
          ptr[i] = p;
          count[i] = cnt;
        }
      }
    }
  }
  cp_async_wait_all();  // the last (empty) group: nothing left in flight
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
  ScreenSplit sq_split, dot_split;  // read at kUnfusedMin <= d <= kUnfusedMax
};

// a ScreenSplit from faults.screen_split's three ints for N nodes
ScreenSplit screen_split(const int* s, int n) {
  return {s[0], s[1], s[2], (n - 1) / s[0] * s[0]};
}

// the smallest log2 g with 2^g >= d
int group_log2(int d) {
  int l = 0;
  while ((1 << l) < d) ++l;
  return l;
}

template <int V, int M, int F>
void launch(const Args& a, int route, cudaStream_t stream) {
  if (route == kStrided) {
    const unsigned blocks =
        (static_cast<unsigned>(a.n) + kNodesPerBlock - 1) / kNodesPerBlock;
    fused_receive_kernel<V, M, F>
        <<<blocks, kWarp * kNodesPerBlock, 0, stream>>>(
            a.last_w, a.last_t, a.cache_w, a.cache_t, a.ptr, a.count, a.msg,
            a.msc, a.mzp, a.msg_t, a.valid, a.x, a.y, a.counts, a.n, a.d,
            a.c, a.k, a.pw, a.lam, a.sq_split, a.dot_split);
    return;
  }
  const int log2g = group_log2(a.d);
  const int stages = static_cast<int>(
      (static_cast<int64_t>(a.n) + kGroupedThreads - 1) / kGroupedThreads);
  auto kernel = a.k <= 4 ? fused_receive_grouped_kernel<V, M, F, 4>
                         : fused_receive_grouped_kernel<V, M, F,
                                                        kGroupedMaxRounds>;
  // persistent blocks: as many as fit on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kGroupedThreads, 0);
  const int blocks = max(1, min(stages, sms * per_sm));
  kernel<<<blocks, kGroupedThreads, 0, stream>>>(
      a.last_w, a.last_t, a.cache_w, a.cache_t, a.ptr, a.count, a.msg, a.msc,
      a.mzp, a.msg_t, a.valid, a.x, a.y, a.counts, a.n, a.d, a.c, a.k, a.pw,
      a.lam, a.sq_split, a.dot_split, log2g, stages);
}

template <int V, int F>
bool launch_mode(const Args& a, int mode, int route, cudaStream_t s) {
  switch (mode) {
    case kF32: launch<V, kF32, F>(a, route, s); return true;
    case kBF16: launch<V, kBF16, F>(a, route, s); return true;
    case kF16: launch<V, kF16, F>(a, route, s); return true;
    case kAffine8: launch<V, kAffine8, F>(a, route, s); return true;
    case kInt4: launch<V, kInt4, F>(a, route, s); return true;
    case kTernary: launch<V, kTernary, F>(a, route, s); return true;
    default: return false;
  }
}

template <int F>
bool launch_variant(const Args& a, int variant, int mode, int route,
                    cudaStream_t s) {
  switch (variant) {
    case kRw: return launch_mode<kRw, F>(a, mode, route, s);
    case kMu: return launch_mode<kMu, F>(a, mode, route, s);
    case kUm: return launch_mode<kUm, F>(a, mode, route, s);
    default: return false;
  }
}

}  // namespace

// variant: 0 = rw, 1 = mu, 2 = um. mode: 0 = f32, 1 = bf16, 2 = f16,
// 3 = affine int8 (msc and mzp (K, N) f16), 4 = int4 and 5 = ternary (msc
// only). defense: 0 = none, 1 = norm_clip, 2 = cosine_gate. route: 0 =
// grouped (d <= 32 and K <= 8 only), 1 = strided. msg is the (K, N, P)
// payload; counts the (2, N) gated and clipped counts, zeroed by the
// caller, or null under defense 0, which writes none. split: the screen's
// faults.screen_split(N, d, 1) and then (N, d, 2) (rows > 0; read only at
// 5 <= d <= 8 under a screen). Returns
// cudaGetLastError() after the launch (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int gossip_cycle_fused_receive_apply(
    float* last_w, int* last_t, float* cache_w, int* cache_t, int* ptr,
    int* count, const void* msg, const void* msc, const void* mzp,
    const int* msg_t, const int* valid, const float* x, const float* y,
    int* counts, int n, int d, int c, int k, int p, float lam, int variant,
    int mode, int defense, int route, const int* split, void* stream) {
  if (route != kGrouped && route != kStrided) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (split[0] <= 0 || split[3] <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == kGrouped && (d > kGroupedMaxWidth || k > kGroupedMaxRounds)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{last_w, last_t, cache_w, cache_t, ptr, count,
               static_cast<const unsigned char*>(msg),
               static_cast<const __half*>(msc),
               static_cast<const __half*>(mzp), msg_t, valid, x, y, counts,
               n, d, c, k, p, lam, screen_split(split, n),
               screen_split(split + 3, n)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (defense) {
    case kNone: ok = launch_variant<kNone>(a, variant, mode, route, s); break;
    case kNormClip:
      ok = launch_variant<kNormClip>(a, variant, mode, route, s);
      break;
    case kCosineGate:
      ok = launch_variant<kCosineGate>(a, variant, mode, route, s);
      break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gossip_cycle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
