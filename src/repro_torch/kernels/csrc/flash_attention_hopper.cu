// Flash-attention forward on Hopper's tensor cores (sm_90a): bf16 q, k, v,
// head_dim 64, 128 or 256; causal, sliding window, grouped-query heads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// flash_attention (body _flash_kernel) on the bf16 prefill. It computes the
// function csrc/flash_attention.cu does (see the note there): for q
// (B, S, H, hd) and k, v (B, S, KV, hd), query head h reads kv head
// h / (H / KV); s_ij = <q_i, k_j> / sqrt(hd), masked unless j <= i (causal)
// and i - j < window, and j < S; an online softmax with its running max,
// sum and accumulator in float32; out_i = acc_i / max(l_i, 1e-30) rounded
// to bf16 (nearest even), so a fully masked row gives 0. Keys at or past S
// are masked in the scores: TMA fills them with zeros, which would
// otherwise score 0.
//
// One deliberate change of rounding: P is rounded to bf16 before P V (the
// tensor cores take bf16 operands), as FlashAttention-2/3 and the port's
// plain attention path (models/attention.py) do; the row sum l is taken
// over the unrounded p. The added error is at most about 2^-9 max|v| an
// output. The CUDA-core kernel and the TPU kernel keep P in float32.
//
// Bound: at the serving shape (B 4, S 2048, H 16, KV 8, hd 128, causal)
// the two products are 4 B H hd S^2 / 2 = 6.9e10 operations against
// 1.0e8 bytes of q, k, v and out (0.030 ms at 3.35 TB/s): operations bound
// it, at 989 TFLOP/s of dense bf16 (0.070 ms). So the design keeps the tensor cores fed:
//   - one block of 288 threads (384 at hd 256, below) per (b h, tile of
//     128 queries): two consumer warpgroups own 64 query rows each, one
//     producer warp issues every load; no __syncthreads() after the
//     barriers are made;
//   - the producer loads the Q tile once and streams K and V tiles of kBK
//     keys (128 at hd 64 and 128, 64 at hd 256) through a ring of kStages
//     slots with TMA (tensor maps of q, k and v as they lie, 128-byte
//     swizzle, boxes of 64 hd columns by 128 query rows or kBK key rows:
//     hd / 64 boxes a tile), each slot with a full and an empty mbarrier,
//     so loads overlap the products;
//   - S = Q K^T is wgmma m64n{kBK}k16 with both operands from shared
//     memory (K-major), f32 accumulators in registers;
//   - the softmax runs in registers: a row's four lanes reduce its max
//     with two shuffles, the sum is kept per lane and reduced once at the
//     end, exp2f with scale * log2(e) folded into one fma; masks are
//     computed only on tiles that cross the causal diagonal, the window's
//     edge or S, and tiles outside the band are never loaded;
//   - O += P V is wgmma with P as bf16 register fragments (the score
//     accumulator's layout is the A operand's) and V from shared memory
//     as an MN-major B (the transpose bit: a V tile is keys x hd, hd
//     contiguous); O lives in registers, rescaled by alpha each tile;
//   - the heaviest causal query tiles are scheduled first, so the last
//     wave is short.
// The two warpgroups' softmax and products overlap only as the warp
// schedulers interleave them; ping-pong scheduling between the warpgroups
// and a softmax overlapped with the next tile's Q K^T are later work.
//
// head_dim 256 (recurrentgemma's local attention: one kv head, window
// 2048). 128 x 128 tiles would need 320 KB of shared memory, so the key
// tiles shrink to 64 while a block keeps 128 queries: the Q tile is 64 KB,
// a K/V slot 2 x 64 x 256 x 2 B = 64 KB, two slots 192 KB in all (197,672
// bytes with the barriers and the alignment pad, under the 232,448-byte
// opt-in). S is wgmma m64n64k16 over 16 hd steps; O += P V is m64n256k16
// over 4 key steps. A consumer thread holds O (64 x 256 f32 over 128
// threads: 128 registers), S (32) and P (16 bf16 pairs). At 288 threads
// ptxas gives a thread at most 168 registers and O spills, so hd 256 runs
// three full warpgroups, as FlashAttention-3 does:
// the producer warpgroup drops to 24 registers with setmaxnreg.dec and
// the two consumers rise to 240 with setmaxnreg.inc; the build log must
// show no spills. The 16 query heads of a block row read the same K/V
// tiles of the one kv head; they meet in L2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;                     // queries per block
constexpr int kBox = 64;                     // hd columns a TMA box: 128 B
constexpr int kRowBytes = kBox * 2;          // one box row: 128 B
constexpr int kStages = 2;                   // K/V ring slots
constexpr int kConsumers = 256;              // two warpgroups
// registers a thread where the producer is a whole warpgroup (hd 256):
// 2 x 128 x 240 + 128 x 24 = 64,512 of the SM's 65,536, the 168 a thread
// the launch gives 384 threads moved from the producer to the consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMinSum = 1e-30f;
// codes past CUDA's own errors
constexpr int kNoEncode = 10000;             // cuTensorMapEncodeTiled missing
constexpr int kEncodeFailed = 10001;         // it refused a tensor map

struct Args {
  void* o;
  int64_t ost[3];  // element strides of the output's b, s, head
  int s, h, kv;
  int causal;
  int window;      // <= 0: no window
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// spins until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one TMA box of a (B, S, heads, hd) tensor map at {col, row, head, b}
// into shared memory; completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(row), "r"(head), "r"(b)
      : "memory");
}

// a wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) * B (128 x 16, smem,
// K-major)^T; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (64 x 16, smem,
// K-major)^T; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) * B (16 x 128, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16, bf16 in registers) * B (16 x 256, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ bool visible(int qpos, int kpos, const Args& a) {
  const int diff = qpos - kpos;
  return kpos < a.s && (!a.causal || diff >= 0) &&
         (a.window <= 0 || diff < a.window);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&p)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&p)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, p, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&p)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, p, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128],
                                              const uint32_t (&p)[4],
                                              uint64_t db) {
  wgmma_rs_n256(o, p, db);
}

// S (64 x kBK) (+)= Q K^T over one 16-wide hd step
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&s)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  wgmma_ss_n128(s, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&s)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_ss_n64(s, da, db, scale_d);
}

// Keys per K/V tile: 128, but 64 at hd 256, where two 128-key slots and
// the Q tile would not fit in shared memory.
template <int HD>
__host__ __device__ constexpr int key_tile() {
  return HD == 256 ? 64 : 128;
}

// Threads a block: the two consumer warpgroups and a producer warp (288),
// but at hd 256 a producer warpgroup (384) that hands its registers to the
// consumers with setmaxnreg: at 288 threads ptxas caps a thread at 168
// registers, and hd 256's 128 accumulator registers a thread then spill.
template <int HD>
__host__ __device__ constexpr bool producer_warpgroup() {
  return HD == 256;
}
template <int HD>
__host__ __device__ constexpr int block_threads() {
  return kConsumers + (producer_warpgroup<HD>() ? 128 : 32);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Shared memory, from a 1024-byte-aligned base (the swizzle's period):
// the Q tile (hd / 64 boxes of 128 rows x 128 B), then kStages (K tile,
// V tile) slots, each tile hd / 64 boxes of kBK rows x 128 B; then the
// barriers full[kStages], empty[kStages], q.
template <int HD>
__host__ __device__ constexpr int q_tile_bytes() {
  return HD / kBox * kBQ * kRowBytes;
}
template <int HD>
__host__ __device__ constexpr int kv_tile_bytes() {
  return HD / kBox * key_tile<HD>() * kRowBytes;
}
template <int HD>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(q_tile_bytes<HD>()) +
         static_cast<size_t>(kv_tile_bytes<HD>()) * 2 * kStages +
         8 * (2 * kStages + 1) + 1024;
}

template <int HD>
__global__ void __launch_bounds__(block_threads<HD>(), 1)
    flash_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const Args a) {
  constexpr int kBoxes = HD / kBox;
  constexpr int kBK = key_tile<HD>();
  constexpr int kQTile = q_tile_bytes<HD>();
  constexpr int kTile = kv_tile_bytes<HD>();
  constexpr int kQBox = kBQ * kRowBytes;     // a Q box: 16 KB
  constexpr int kKBox = kBK * kRowBytes;     // a K or V box: 16 or 8 KB
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + kQTile;
  const uint32_t bars = skv + kTile * 2 * kStages;
  const uint32_t qbar = bars + 16 * kStages;
  // full[st] at bars + 8 st, empty[st] at bars + 8 (kStages + st); K of
  // slot st at skv + 2 kTile st, its V one tile further

  const int bh = blockIdx.x;
  const int bi = bh / a.h;
  const int head = bh - bi * a.h;
  const int kvh = head / (a.h / a.kv);
  // the last query tiles see the most keys under a causal mask: first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  // the key tiles this query tile can see
  int k_lo = 0;
  int k_hi = a.s;
  if (a.causal) k_hi = min(a.s, q0 + kBQ);
  if (a.window > 0) k_lo = max(0, q0 - (a.window - 1));
  const int t_lo = k_lo / kBK;
  const int t_hi = (k_hi + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kStages + st), kConsumers / 32);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warp (or warpgroup): one lane issues every load
    if constexpr (producer_warpgroup<HD>()) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qbar, kQTile);
      for (int c = 0; c < kBoxes; ++c) {
        tma_load(sq + c * kQBox, &tq, qbar, c * kBox, q0, head, bi);
      }
      int st = 0;
      uint32_t ph = 0;
      for (int t = t_lo; t < t_hi; ++t) {
        const uint32_t full = bars + 8 * st;
        const uint32_t sk = skv + 2 * kTile * st;
        mbar_wait(bars + 8 * (kStages + st), ph ^ 1);  // the slot is free
        mbar_expect_tx(full, 2 * kTile);
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(sk + c * kKBox, &tk, full, c * kBox, t * kBK, kvh, bi);
          tma_load(sk + kTile + c * kKBox, &tv, full, c * kBox, t * kBK, kvh,
                   bi);
        }
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows q0 + 64 wg + [0, 64); this thread's
  // accumulator rows are r0 and r0 + 8, its columns 8 j + 2 (lane % 4) + 0/1
  if constexpr (producer_warpgroup<HD>()) setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int qw0 = q0 + 64 * wg;
  const int r0 = qw0 + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const float c = a.scale * kLog2e;
  const uint32_t qa = sq + 64 * wg * kRowBytes;  // 64 rows down each box

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.0f, 0.0f};            // this lane's part of the row sums

  mbar_wait(qbar, 0);
  int st = 0;
  uint32_t ph = 0;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    const uint32_t sk = skv + 2 * kTile * st;
    const uint32_t sv = sk + kTile;
    mbar_wait(bars + 8 * st, ph);

    // S = Q K^T over hd in steps of 16: 32 B along a 128-B swizzled row,
    // then the next box
    float s[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_qk<kBK>(s, sw128_desc(qa + (kk / 4) * kQBox + off, 16, 1024),
                    sw128_desc(sk + (kk / 4) * kKBox + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const bool edge = k0 + kBK > a.s || (a.causal && k0 + kBK - 1 > qw0) ||
                      (a.window > 0 && k0 <= qw0 + 63 - a.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int row = r0 + 8 * ((i / 2) % 2);
        const int key = k0 + 8 * (i / 4) + c0 + i % 2;
        if (!visible(row, key, a)) s[i] = -INFINITY;
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
    float ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // nothing visible yet: every p is 0, alpha too
      ms[r] = (mx[r] == -INFINITY ? 0.0f : mx[r]) * c;
      const float alpha = exp2f(m[r] * c - ms[r]);  // 1 when the max stays
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 2 * r] *= alpha;
        o[4 * j + 2 * r + 1] *= alpha;
      }
    }
    // p, and P as bf16 A fragments: keys 16 kk + [0, 16) are accumulator
    // entries 8 kk + [0, 8), in the order the A operand wants them
    uint32_t p[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      float e[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = 8 * kk + u;
        e[u] = exp2f(fmaf(s[i], c, -ms[(i / 2) % 2]));
        l[(i / 2) % 2] += e[u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        p[kk][u] = pack_bf16(e[2 * u], e[2 * u + 1]);
      }
    }

    // O += P V over the tile's keys in steps of 16 (16 rows of 128 B);
    // the next hd box is the leading byte offset away
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_pv<HD>(o, p[kk], sw128_desc(sv + kk * 16 * kRowBytes, kKBox,
                                        1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + st));  // slot read
    if (++st == kStages) {
      st = 0;
      ph ^= 1;
    }
  }

  // out = O / max(l, 1e-30) in bf16, the row sums reduced over the lanes
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + bi * a.ost[0] +
                       head * a.ost[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = r0 + 8 * r;
    if (row >= a.s) continue;
    const float den = fmaxf(sum, kMinSum);
    __nv_bfloat16* dst = out + row * a.ost[1] + c0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's
// entry-point query so that nothing links against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 13000
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    const bool ok = err == cudaSuccess && found == cudaDriverEntryPointSuccess;
#else
    const bool ok = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault) == cudaSuccess;
#endif
    if (ok && p != nullptr) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tensor map of a bf16 (B, S, heads, hd) tensor with element strides st
// of b, s and head (hd contiguous), as it lies: dims {hd, S, heads, B},
// boxes of 64 hd columns by `rows` rows, 128-byte swizzle, rows past S
// read as zeros
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  int b, int s, int heads, int hd, const int64_t* st,
                  int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kBox, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
cudaError_t launch(EncodeTiled encode, const void* q, const void* k,
                   const void* v, const int64_t* strides, const Args& a,
                   int b, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (make_map(encode, &tq, q, b, a.s, a.h, HD, strides, kBQ) !=
          CUDA_SUCCESS ||
      make_map(encode, &tk, k, b, a.s, a.kv, HD, strides + 3,
               key_tile<HD>()) != CUDA_SUCCESS ||
      make_map(encode, &tv, v, b, a.s, a.kv, HD, strides + 6,
               key_tile<HD>()) != CUDA_SUCCESS) {
    return static_cast<cudaError_t>(kEncodeFailed);
  }
  const size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_hopper_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * a.h, (a.s + kBQ - 1) / kBQ);
  flash_hopper_kernel<HD><<<grid, block_threads<HD>(), bytes, stream>>>(
      tq, tk, tv, a);
  return cudaGetLastError();
}

bool tma_ok(const void* p, const int64_t* st) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int d = 0; d < 3; ++d) {
    if (st[d] <= 0 || st[d] % 8 != 0) return false;
  }
  return true;
}

}  // namespace

// q (B, S, H, hd), k and v (B, S, KV, hd), o (B, S, H, hd), all bfloat16
// with hd (64, 128 or 256) contiguous; strides holds the element strides of
// dims 0-2 of q, k, v, then o (12 int64), each of q, k, v's a positive
// multiple of 8 and each base 16-byte aligned (what TMA reads). window <= 0
// means none; scale is 1 / sqrt(hd). Returns 0 on success, else a CUDA
// error code or kNoEncode / kEncodeFailed; the launch is asynchronous on
// `stream`.
extern "C" int flash_attention_hopper_forward(const void* q, const void* k,
                                              const void* v, void* o, int b,
                                              int s, int h, int kv, int hd,
                                              const int64_t* strides,
                                              int causal, int window,
                                              float scale, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  if (kv <= 0 || h % kv != 0 || (hd != 64 && hd != 128 && hd != 256) ||
      (s + kBQ - 1) / kBQ > 65535 || !tma_ok(q, strides) ||
      !tma_ok(k, strides + 3) || !tma_ok(v, strides + 6)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncode;
  Args a{o, {strides[9], strides[10], strides[11]}, s, h, kv, causal, window,
         scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      hd == 64    ? launch<64>(encode, q, k, v, strides, a, b, st)
      : hd == 128 ? launch<128>(encode, q, k, v, strides, a, b, st)
                  : launch<256>(encode, q, k, v, strides, a, b, st);
  return static_cast<int>(err);
}

// the dynamic shared memory a block asks for at head_dim hd (64, 128 or
// 256; 0 for any other)
extern "C" int flash_attention_hopper_smem_bytes(int hd) {
  return static_cast<int>(hd == 64    ? smem_bytes<64>()
                          : hd == 128 ? smem_bytes<128>()
                          : hd == 256 ? smem_bytes<256>()
                                      : 0);
}

extern "C" const char* flash_attention_hopper_error_string(int code) {
  if (code == kNoEncode) {
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  }
  if (code == kEncodeFailed) {
    return "cuTensorMapEncodeTiled refused a tensor map of q, k or v";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
