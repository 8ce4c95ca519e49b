// Send-side encode of the quantized wire codecs for Hopper (sm_90a): one
// pass over the population's fresh models per cycle.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gossip_cycle.py
// quantize_send:
//   affine8 kernels  <- _send_kernel (the int8 and int8_sr codecs): per row
//                       min and max, zp = f16(sat((hi + lo) / 2)), scale =
//                       f16(sat(max(hi - zp, zp - lo) / 126)), codes
//                       round((w - zp) / scale) — or floor(u + noise) for
//                       int8_sr — clipped to +-127;
//   packed kernels   <- _pack_send_kernel (int4, ternary and their _ef
//                       variants): x = w (+ ef), scale = f16(sat(max|x| /
//                       qmax)), codes round(x / scale) clipped to +-qmax,
//                       packed two nibbles (int4) or five base-3 trits
//                       (ternary) a byte, and under error feedback the
//                       residual x - code * scale.
// The op order is wire_codec.quantize_wire's and PackedSymmetricCodec's:
// rintf rounds half to even like torch.round (roundf would not); the f16
// saturation compares explicitly and keeps NaN, as torch.clamp does, before
// __float2half_rn; min, max and max|x| propagate NaN like torch.amin/amax,
// and min and max order -0.0 below +0.0 as jnp.min/jnp.max do (a row of
// mixed-sign zeros has min -0.0 and max +0.0; max|x| never meets -0.0, so
// the packed codecs' reduction is unaffected);
// the zero guard where(scale > 0, scale, 1) takes the guard for NaN. With
// --fmad=false and IEEE division every code, byte, scale, zero-point and
// residual equals the plain PyTorch version bit for bit. Both routes below
// share these helpers, so they give the same bits.
//
// int8_sr noise is positional: element (r, j) takes jax.random.uniform
// (partitionable threefry-2x32) at flat position p = r * d + j, i.e. the
// block cipher on the counter (p >> 32, p & 0xFFFFFFFF), bits = y0 ^ y1, the
// top 23 bits as a mantissa in [1, 2), minus 1. No thread talks to another
// for it, and the key (the cycle's k_recv, int64 words holding uint32
// values) is read on the device, never by the host.
//
// Two layouts, chosen before the launch by gossip_cycle.py::send_route (the
// C entries take the choice as an argument and refuse a tiled launch
// outside its range):
//
// strided (the first layout; every d): one warp per message row,
// kRowsPerBlock rows per block. The row's range is a warp-shuffle
// reduction over lanes striding over d; then lanes stride over the output.
// For the packed codecs a lane owns whole output bytes (its 2 or 5 codes),
// so no two lanes write one byte. Rows are read and written element by
// element: a packed row of ceil(d/2) or ceil(d/5) bytes starts at any
// byte. At d = 10 it is latency-bound:
//   1. lanes: 22 of 32 idle in the range pass; ternary's code loop has
//      cols = 2, so 2 of 32 lanes run, each five IEEE divisions in a row,
//      and int8_sr's threefry runs on 10 lanes; under error feedback the
//      residual goes out from those lanes, five or two strided floats each,
//      and w and ef are read element by element, twice;
//   2. bytes in flight: a warp loads its 40-byte row, waits, reduces, and
//      reads the row again; blocks of 8 rows keep ~2.5 KB an SM in flight
//      where 3.35 TB/s over ~1 us of latency asks for ~25 KB;
//   3. stores: 1- and 2-byte payload stores from a few lanes, and the f16
//      scale from lane 0 of each warp.
//
// tiled (every codec, d up to kTiledMaxWidth, w, and ef and the residual
// under error feedback, on 16-byte boundaries; send_route sends it d <= 57,
// the widest width of chip_smoke.py's sweep (10, 32, 57, 128) at which it
// beats the strided kernels on an H100): tiled.cuh's walk, persistent
// blocks of kTiledThreads threads over tiles of R rows, tile blockIdx.x,
// + gridDim.x, ... A tile of w (and of ef) is one contiguous run of R d
// floats, and R a multiple of 16 puts every tile's byte offsets (inputs,
// int8 codes, packed bytes, residual) on 16-byte boundaries. R is as many
// rows as a slot of kTiledSlotBytes holds (send_rows), at most 256: the
// slot holds the tiles of all staged inputs, so under error feedback R is
// smaller past d = 16 (d = 10: 256 rows either way; d = 32: 128, not 256;
// d = 57: 64, not 128). That keeps a block's shared memory at most ~66 KB:
// three blocks an SM at d = 32 and 57, five at d = 10 (43 KB), each with a
// 20-32 KB slot in flight; two slots of 2 x 29 KB at d = 57 would leave
// one block an SM. What it does about each cause:
//   2. the tiles are copied into shared memory with 16-byte cp.async (the
//      ragged last tile element by element), into a ring of two slots: the
//      next tile's copy is in flight while this one is encoded, and a
//      block's whole tile (10 KB at d = 10, 20 KB with ef) is in flight at
//      once;
//   1. the range pass is one thread a row, from shared memory (each thread
//      starts at its own column so a warp's reads spread over the banks;
//      with -0.0 ordered below +0.0 the reduction is order-free); the code
//      pass is spread over the whole tile: for affine int8 one thread per
//      four consecutive elements of the flat tile (element e of the tile is
//      q[r0 d + e], its noise position r0 d + e as on the strided route), so
//      all 32 lanes run threefry; for the packed codecs one thread per
//      output byte of the tile's contiguous R ceil(d / G) bytes. Under error
//      feedback x = w + ef is formed once, in place of w's tile, before the
//      passes read it, and a residual pass of four flat elements a thread
//      recomputes each code (the same IEEE division) and writes x - code
//      scale;
//   3. the codes go out four bytes a thread, the packed bytes one a thread
//      with neighbouring threads on neighbouring bytes, the residual 16
//      bytes a thread, and the f16 scale (and zero-point) one a thread, R
//      consecutive halves a tile.
// The codes past d in the last byte are code 0 (nibble 0, trit digit 1), as
// pack_int4 and pack_ternary pad, on both routes. The kernels write new
// tensors that the wrapper allocates; the engine copies them into the
// in-flight buffer row.
//
// Bound: device memory (3.35 TB/s on an H100 SXM), except where int8_sr's
// threefry is the larger term: its integer instructions an element, counted
// in the built kernel's SASS by chip_smoke.py, over Hopper's 64 INT32 lanes
// an SM (IMADs on the FMA pipe's 128). Per launch the kernel must read w
// (and ef) once and write the codes, the f16 scale (and zero-point), and
// the residual: at N = 10^6 and d = 10, 40 MB read and 14 MB written for
// int8/int8_sr, 80 MB read and 47 MB written for int4_ef, 40 MB read and
// 4 MB written for ternary. chip_smoke.py computes the bound from each
// launch's shapes.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tiled.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr float kF16Max = 65504.0f;
constexpr float kInt8Qmax = 126.0f;

// the tiled route (the walk itself is tiled.cuh's)
constexpr int kTiledSlotBytes = 32768;  // a slot's tiles of w (and ef)
constexpr int kTiledMaxWidth = 128;     // d it takes at most (32-64 rows)

enum Route { kTiled = 0, kStrided = 1 };

// rows a tile at width d with `inputs` (n, d) float inputs staged (w, and
// ef under error feedback): as many as one slot holds, a multiple of 16,
// at most kTiledMaxRows (gossip_cycle.py::send_tile_rows)
int send_rows(int d, int inputs) {
  return tiled_rows(4 * d * inputs, kTiledSlotBytes);
}

// min / max that keep a NaN operand and order -0.0 below +0.0, as
// jnp.min / jnp.max do (and wire_codec._signed_range): with the sign bit
// breaking a == b, the reduction gives the same value in any order
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a || (a == b && signbit(a))) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a || (a == b && !signbit(a))) ? a : b;
}

// the larger of two magnitudes |x| (never -0.0), keeping a NaN operand:
// the packed codecs' max|x| needs no sign tie-break, and its shorter
// compare keeps the strided kernels' shuffle chain as it was
__device__ __forceinline__ float abs_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <float (*Op)(float, float)>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v = Op(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// _sat_f16: clip to the f16 range (NaN stays NaN), then round to f16
__device__ __forceinline__ __half sat_f16(float v) {
  const float c = v != v ? v : (v < -kF16Max ? -kF16Max
                                             : (v > kF16Max ? kF16Max : v));
  return __float2half_rn(c);
}

// where(scale > 0, scale, 1): a zero or NaN scale divides by one
__device__ __forceinline__ float guarded(float scale) {
  return scale > 0.0f ? scale : 1.0f;
}

// clip a rounded code to [-qmax, qmax]; NaN becomes code 0, as the float
// to integer conversion of the plain version on the card gives
__device__ __forceinline__ int clip_code(float u, float qmax) {
  if (u != u) return 0;
  return static_cast<int>(u < -qmax ? -qmax : (u > qmax ? qmax : u));
}

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

__device__ __forceinline__ void mix4(uint32_t& a, uint32_t& b, int r0,
                                     int r1, int r2, int r3) {
  a += b; b = rotl(b, r0) ^ a;
  a += b; b = rotl(b, r1) ^ a;
  a += b; b = rotl(b, r2) ^ a;
  a += b; b = rotl(b, r3) ^ a;
}

// jax.random.uniform(key, shape) at flat position p (partitionable scheme)
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            int64_t p) {
  const uint32_t ks0 = k0, ks1 = k1, ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t a = static_cast<uint32_t>(p >> 32) + ks0;
  uint32_t b = static_cast<uint32_t>(p & 0xFFFFFFFF) + ks1;
  mix4(a, b, 13, 15, 26, 6);  a += ks1; b += ks2 + 1u;
  mix4(a, b, 17, 29, 16, 24); a += ks2; b += ks0 + 2u;
  mix4(a, b, 13, 15, 26, 6);  a += ks0; b += ks1 + 3u;
  mix4(a, b, 17, 29, 16, 24); a += ks1; b += ks2 + 4u;
  mix4(a, b, 13, 15, 26, 6);  a += ks2; b += ks0 + 5u;
  const uint32_t bits = a ^ b;
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// an affine int8 row's wire scalars from its min and max, and the f32
// zero-point and guarded divisor its codes are made with
struct Affine {
  __half zp, sc;
  float zpf, sf;
};

__device__ __forceinline__ Affine affine_params(float lo, float hi) {
  Affine a;
  a.zp = sat_f16((hi + lo) * 0.5f);
  a.zpf = __half2float(a.zp);
  a.sc = sat_f16(nan_max(hi - a.zpf, a.zpf - lo) / kInt8Qmax);
  a.sf = guarded(__half2float(a.sc));
  return a;
}

// the int8 code of v at flat position p
template <bool SR>
__device__ __forceinline__ int affine_code(float v, float zpf, float sf,
                                           uint32_t k0, uint32_t k1,
                                           int64_t p) {
  float u = (v - zpf) / sf;
  if (SR) {
    u = floorf(u + uniform_at(k0, k1, p));
  } else {
    u = rintf(u);
  }
  return clip_code(u, 127.0f);
}

// code g of a packed byte added in: a two's-complement nibble (int4) or a
// base-3 digit code + 1 (ternary)
template <int G>
__device__ __forceinline__ int pack_code(int byte, int code, int g) {
  if (G == 2) return byte | ((code & 0xF) << (4 * g));
  const int p3 = g == 0 ? 1 : g == 1 ? 3 : g == 2 ? 9 : g == 3 ? 27 : 81;
  return byte + (code + 1) * p3;
}

// ---------------------------------------------------------------------------
// the strided route: a warp a row
// ---------------------------------------------------------------------------

// ROWS: the noise of row r is drawn at row rows[r] of a larger population
// (the senders' rows of compact_all); a compile-time choice, so the dense
// send's instantiations carry no lookup
template <bool SR, bool ROWS>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
affine8_kernel(const float* __restrict__ w, const int64_t* __restrict__ key,
               const int64_t* __restrict__ rows, int8_t* __restrict__ q,
               __half* __restrict__ scale_out, __half* __restrict__ zp_out,
               int n, int d) {
  const int lane = threadIdx.x % kWarp;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (r >= n) return;
  const float* wr = w + r * d;

  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  for (int j = lane; j < d; j += kWarp) {
    const float v = wr[j];
    lo = nan_min(lo, v);
    hi = nan_max(hi, v);
  }
  const Affine a = affine_params(warp_reduce<nan_min>(lo),
                                 warp_reduce<nan_max>(hi));

  uint32_t k0 = 0, k1 = 0;
  if (SR) {
    k0 = static_cast<uint32_t>(key[0]);
    k1 = static_cast<uint32_t>(key[1]);
  }
  int8_t* qr = q + r * d;
  // the noise's flat position: row rows[r] of the whole draw under ROWS
  const int64_t p0 = (ROWS ? rows[r] : r) * d;
  for (int j = lane; j < d; j += kWarp) {
    qr[j] = static_cast<int8_t>(
        affine_code<SR>(wr[j], a.zpf, a.sf, k0, k1, p0 + j));
  }
  if (lane == 0) {
    scale_out[r] = a.sc;
    zp_out[r] = a.zp;
  }
}

template <int G, bool EF>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
packed_kernel(const float* __restrict__ w, const float* __restrict__ ef,
              uint8_t* __restrict__ payload, __half* __restrict__ scale_out,
              float* __restrict__ resid, int n, int d) {
  constexpr float kQmax = G == 2 ? 7.0f : 1.0f;
  const int lane = threadIdx.x % kWarp;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  if (r >= n) return;
  const float* wr = w + r * d;
  const float* er = EF ? ef + r * d : nullptr;
  auto xval = [&](int j) { return EF ? wr[j] + er[j] : wr[j]; };

  float amax = 0.0f;
  for (int j = lane; j < d; j += kWarp) amax = abs_max(amax, fabsf(xval(j)));
  amax = warp_reduce<abs_max>(amax);
  const __half sc = sat_f16(amax / kQmax);
  const float scf = __half2float(sc);
  const float sf = guarded(scf);

  const int cols = (d + G - 1) / G;
  uint8_t* pr = payload + r * cols;
  for (int b = lane; b < cols; b += kWarp) {
    int byte = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = b * G + g;
      int code = 0;  // pad code past d
      if (j < d) {
        const float x = xval(j);
        code = clip_code(rintf(x / sf), kQmax);
        if (EF) {
          const float dec = static_cast<float>(code) * scf;
          resid[r * d + j] = x - dec;
        }
      }
      byte = pack_code<G>(byte, code, g);
    }
    pr[b] = static_cast<uint8_t>(byte);
  }
  if (lane == 0) scale_out[r] = sc;
}

unsigned blocks_for(int n) {
  return (static_cast<unsigned>(n) + kRowsPerBlock - 1) / kRowsPerBlock;
}

// ---------------------------------------------------------------------------
// the tiled route: persistent blocks, tiles of R rows through shared memory
// ---------------------------------------------------------------------------

template <bool SR, bool ROWS>
__global__ void __launch_bounds__(kTiledThreads)
affine8_tiled_kernel(const float* __restrict__ w,
                     const int64_t* __restrict__ key,
                     const int64_t* __restrict__ row_ids,
                     int8_t* __restrict__ q, __half* __restrict__ scale_out,
                     __half* __restrict__ zp_out, int n, int d,
                     int rows_per_tile, int tiles) {
  extern __shared__ __align__(16) float smem[];
  float* s_sf = smem + 2 * rows_per_tile * d;  // each row's divisor
  float* s_zp = s_sf + rows_per_tile;          // and zero-point
  uint32_t k0 = 0, k1 = 0;
  if (SR) {
    k0 = static_cast<uint32_t>(key[0]);
    k1 = static_cast<uint32_t>(key[1]);
  }
  const int slot = rows_per_tile * d;
  auto stage = [&](int buf, int tile) {
    stage_tile(smem + buf * slot, w, tile, rows_per_tile, n, d);
  };
  walk_tiles(n, rows_per_tile, tiles, stage,
             [&](int buf, int64_t r0, int rows) {
    const float* s = smem + buf * slot;
    // the range pass: thread r owns row r
    const int r = threadIdx.x;
    if (r < rows) {
      const float* sr = s + r * d;
      float lo = CUDART_INF_F, hi = -CUDART_INF_F;
      int j = r % d;
      for (int t = 0; t < d; ++t) {
        const float v = sr[j];
        lo = nan_min(lo, v);
        hi = nan_max(hi, v);
        j = j + 1 == d ? 0 : j + 1;
      }
      const Affine a = affine_params(lo, hi);
      s_sf[r] = a.sf;
      s_zp[r] = a.zpf;
      scale_out[r0 + r] = a.sc;
      zp_out[r0 + r] = a.zp;
    }
    __syncthreads();
    // the code pass: four consecutive elements of the flat tile a thread,
    // element e at flat position r0 d + e; a float4 read (the slot's
    // length is a multiple of four floats) and a 4-byte store; one copy of
    // the loop body (chip_smoke.py reads threefry's instructions off it)
    const int elems = rows * d;
    const int64_t p0 = r0 * d;
    int8_t* qt = q + p0;
#pragma unroll 1
    for (int e = 4 * threadIdx.x; e < elems; e += 4 * kTiledThreads) {
      const float4 v4 = *reinterpret_cast<const float4*>(s + e);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      int row = e / d;
      int col = e - row * d;
      uint32_t codes = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (e + i < elems) {
          // the noise's flat position: row row_ids[r0 + row] of the
          // whole draw under ROWS
          const int64_t pos =
              ROWS ? row_ids[r0 + row] * d + col : p0 + e + i;
          const int c = affine_code<SR>(v[i], s_zp[row], s_sf[row], k0, k1,
                                        pos);
          codes |= static_cast<uint32_t>(static_cast<uint8_t>(c)) << (8 * i);
        }
        if (++col == d) {
          col = 0;
          ++row;
        }
      }
      if (e + 4 <= elems) {
        *reinterpret_cast<uint32_t*>(qt + e) = codes;
      } else {
        for (int i = 0; i < elems - e; ++i) {
          qt[e + i] = static_cast<int8_t>(codes >> (8 * i));
        }
      }
    }
  });
}

// The packed kernels' range pass on a tile in shared memory: thread r owns
// row r, from its own column on (max|x| is order-free), and writes the
// row's f16 scale to scale[r], its divisor to s_sf[r] and, where s_scf is
// not null, the scale as f32 to s_scf[r].
template <int G>
__device__ __forceinline__ void packed_range_pass(const float* s, int d,
                                                  int rows, float* s_sf,
                                                  float* s_scf,
                                                  __half* scale) {
  constexpr float kQmax = G == 2 ? 7.0f : 1.0f;
  const int r = threadIdx.x;
  if (r >= rows) return;
  const float* sr = s + r * d;
  float amax = 0.0f;
  int j = r % d;
  for (int t = 0; t < d; ++t) {
    amax = abs_max(amax, fabsf(sr[j]));
    j = j + 1 == d ? 0 : j + 1;
  }
  const __half sc = sat_f16(amax / kQmax);
  const float scf = __half2float(sc);
  s_sf[r] = guarded(scf);
  if (s_scf != nullptr) s_scf[r] = scf;
  scale[r] = sc;
}

// The packed kernels' code pass: one thread per output byte of the tile's
// rows ceil(d / G) contiguous bytes, neighbouring threads on neighbouring
// bytes.
template <int G>
__device__ __forceinline__ void packed_code_pass(const float* s, int d,
                                                 int rows, const float* s_sf,
                                                 uint8_t* pt) {
  constexpr float kQmax = G == 2 ? 7.0f : 1.0f;
  const int cols = (d + G - 1) / G;
  const int nbytes = rows * cols;
  for (int b = threadIdx.x; b < nbytes; b += kTiledThreads) {
    const int row = b / cols;
    const int c = b - row * cols;
    const float* sr = s + row * d;
    const float sf = s_sf[row];
    int byte = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = c * G + g;
      const int code = j < d ? clip_code(rintf(sr[j] / sf), kQmax) : 0;
      byte = pack_code<G>(byte, code, g);
    }
    pt[b] = static_cast<uint8_t>(byte);
  }
}

template <int G>
__global__ void __launch_bounds__(kTiledThreads)
packed_tiled_kernel(const float* __restrict__ w,
                    uint8_t* __restrict__ payload,
                    __half* __restrict__ scale_out, int n, int d,
                    int rows_per_tile, int tiles) {
  extern __shared__ __align__(16) float smem[];
  float* s_sf = smem + 2 * rows_per_tile * d;  // each row's divisor
  const int slot = rows_per_tile * d;
  auto stage = [&](int buf, int tile) {
    stage_tile(smem + buf * slot, w, tile, rows_per_tile, n, d);
  };
  walk_tiles(n, rows_per_tile, tiles, stage,
             [&](int buf, int64_t r0, int rows) {
    const float* s = smem + buf * slot;
    packed_range_pass<G>(s, d, rows, s_sf, nullptr, scale_out + r0);
    __syncthreads();
    packed_code_pass<G>(s, d, rows, s_sf, payload + r0 * ((d + G - 1) / G));
  });
}

// The tiled packed kernel under error feedback (int4_ef, ternary_ef): a
// slot holds the tile of w and then the tile of ef; x = w + ef is formed
// once, in place of w's tile, four elements a thread, before the passes
// read it; after the range and code passes the residual pass writes resid
// four elements a thread, coalesced, recomputing each code from x as the
// code pass does (the same IEEE division gives the same code).
template <int G>
__global__ void __launch_bounds__(kTiledThreads)
packed_ef_tiled_kernel(const float* __restrict__ w,
                       const float* __restrict__ ef,
                       uint8_t* __restrict__ payload,
                       __half* __restrict__ scale_out,
                       float* __restrict__ resid, int n, int d,
                       int rows_per_tile, int tiles) {
  constexpr float kQmax = G == 2 ? 7.0f : 1.0f;
  extern __shared__ __align__(16) float smem[];
  const int tile_floats = rows_per_tile * d;
  const int slot = 2 * tile_floats;
  float* s_sf = smem + 2 * slot;         // each row's divisor
  float* s_scf = s_sf + rows_per_tile;   // and its f16 scale as f32
  auto stage = [&](int buf, int tile) {
    stage_tile(smem + buf * slot, w, tile, rows_per_tile, n, d);
    stage_tile(smem + buf * slot + tile_floats, ef, tile, rows_per_tile, n,
               d);
  };
  walk_tiles(n, rows_per_tile, tiles, stage,
             [&](int buf, int64_t r0, int rows) {
    float* s = smem + buf * slot;
    const float* se = s + tile_floats;
    // x = w + ef, four elements a thread (a tile is a multiple of four
    // floats long; past the ragged tile's rows the sums go unread)
    const int elems = rows * d;
    for (int e = 4 * threadIdx.x; e < elems; e += 4 * kTiledThreads) {
      float4 x4 = *reinterpret_cast<const float4*>(s + e);
      const float4 e4 = *reinterpret_cast<const float4*>(se + e);
      x4.x = x4.x + e4.x;
      x4.y = x4.y + e4.y;
      x4.z = x4.z + e4.z;
      x4.w = x4.w + e4.w;
      *reinterpret_cast<float4*>(s + e) = x4;
    }
    __syncthreads();
    packed_range_pass<G>(s, d, rows, s_sf, s_scf, scale_out + r0);
    __syncthreads();
    packed_code_pass<G>(s, d, rows, s_sf, payload + r0 * ((d + G - 1) / G));
    // the residual pass: element e of the flat tile is resid[r0 d + e]
    float* rt = resid + r0 * d;
    for (int e = 4 * threadIdx.x; e < elems; e += 4 * kTiledThreads) {
      const float4 x4 = *reinterpret_cast<const float4*>(s + e);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      float out[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int row = e / d;
      int col = e - row * d;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (e + i < elems) {
          const int code = clip_code(rintf(x[i] / s_sf[row]), kQmax);
          out[i] = x[i] - static_cast<float>(code) * s_scf[row];
        }
        if (++col == d) {
          col = 0;
          ++row;
        }
      }
      if (e + 4 <= elems) {
        *reinterpret_cast<float4*>(rt + e) =
            make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (e + i < elems) rt[e + i] = out[i];
        }
      }
    }
  });
}

// dynamic shared memory of a tiled launch: two slots of `inputs` tiles of
// R d floats, then R floats of per-row scalars for each of `scalars`
size_t tiled_smem(int d, int inputs, int scalars) {
  const int rows = send_rows(d, inputs);
  return sizeof(float) * (2 * static_cast<size_t>(inputs) * rows * d +
                          static_cast<size_t>(scalars) * rows);
}

// whether the tiled route takes these operands: d in range, w on a 16-byte
// boundary (its tiles are copied 16 bytes at a time)
bool tiled_takes(const void* w, int d) {
  return d <= kTiledMaxWidth && aligned16(w);
}

template <bool SR, bool ROWS>
void launch_affine8(const float* w, const int64_t* key, const int64_t* rows,
                    int8_t* q, __half* sc, __half* zp, int n, int d,
                    int route, cudaStream_t s) {
  if (route == kStrided) {
    affine8_kernel<SR, ROWS><<<blocks_for(n), kWarp * kRowsPerBlock, 0, s>>>(
        w, key, rows, q, sc, zp, n, d);
    return;
  }
  const int tile_rows = send_rows(d, 1);
  const int tiles = tiles_for(n, tile_rows);
  const size_t smem = tiled_smem(d, 1, 2);
  const unsigned blocks =
      tiled_blocks(affine8_tiled_kernel<SR, ROWS>, tiles, smem);
  affine8_tiled_kernel<SR, ROWS><<<blocks, kTiledThreads, smem, s>>>(
      w, key, rows, q, sc, zp, n, d, tile_rows, tiles);
}

template <int G>
void launch_packed(const float* w, const float* ef, uint8_t* payload,
                   __half* sc, float* resid, int n, int d, int route,
                   cudaStream_t s) {
  if (route == kStrided) {
    const dim3 grid(blocks_for(n)), block(kWarp * kRowsPerBlock);
    if (ef) packed_kernel<G, true><<<grid, block, 0, s>>>(w, ef, payload, sc,
                                                          resid, n, d);
    else packed_kernel<G, false><<<grid, block, 0, s>>>(w, ef, payload, sc,
                                                        resid, n, d);
    return;
  }
  if (ef) {
    const int rows = send_rows(d, 2);
    const int tiles = tiles_for(n, rows);
    const size_t smem = tiled_smem(d, 2, 2);
    const unsigned blocks =
        tiled_blocks(packed_ef_tiled_kernel<G>, tiles, smem);
    packed_ef_tiled_kernel<G><<<blocks, kTiledThreads, smem, s>>>(
        w, ef, payload, sc, resid, n, d, rows, tiles);
    return;
  }
  const int rows = send_rows(d, 1);
  const int tiles = tiles_for(n, rows);
  const size_t smem = tiled_smem(d, 1, 1);
  const unsigned blocks = tiled_blocks(packed_tiled_kernel<G>, tiles, smem);
  packed_tiled_kernel<G><<<blocks, kTiledThreads, smem, s>>>(
      w, payload, sc, n, d, rows, tiles);
}

}  // namespace

// int8 / int8_sr: w (n, d) f32 -> q (n, d) int8, scale and zp (n,) f16.
// key: the (2,) int64 threefry key (read only when stochastic). rows: null,
// or the (n,) int64 rows of a larger population that w holds (read only
// when stochastic): row r's noise is then drawn at flat positions
// rows[r] * d + j of the whole draw instead of r * d + j. route: 0 =
// tiled (d <= 128 and w on a 16-byte boundary only), 1 = strided. Returns
// cudaGetLastError() after the launch (0 on success); asynchronous on
// `stream`.
extern "C" int quantize_send_affine8(const float* w, const int64_t* key,
                                     const int64_t* rows, int8_t* q,
                                     void* scale, void* zp, int n, int d,
                                     int stochastic, int route,
                                     void* stream) {
  if (route != kTiled && route != kStrided) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == kTiled &&
      (!tiled_takes(w, d) || reinterpret_cast<uintptr_t>(q) % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __half* sc = static_cast<__half*>(scale);
  __half* z = static_cast<__half*>(zp);
  if (stochastic && rows) {
    launch_affine8<true, true>(w, key, rows, q, sc, z, n, d, route, s);
  } else if (stochastic) {
    launch_affine8<true, false>(w, key, nullptr, q, sc, z, n, d, route, s);
  } else {
    launch_affine8<false, false>(w, key, nullptr, q, sc, z, n, d, route, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// int4 (group 2) / ternary (group 5), with error feedback when ef is not
// null: w (and ef) (n, d) f32 -> payload (n, ceil(d / group)) uint8, scale
// (n,) f16, resid (n, d) f32 (written only with ef). route: 0 = tiled
// (d <= 128 and w, and ef and resid where given, on 16-byte boundaries
// only), 1 = strided.
extern "C" int quantize_send_packed(const float* w, const float* ef,
                                    uint8_t* payload, void* scale,
                                    float* resid, int n, int d, int group,
                                    int route, void* stream) {
  if ((ef == nullptr) != (resid == nullptr) || (group != 2 && group != 5) ||
      (route != kTiled && route != kStrided)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == kTiled && (!tiled_takes(w, d) ||
                          (ef != nullptr &&
                           (!aligned16(ef) || !aligned16(resid))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __half* sc = static_cast<__half*>(scale);
  if (group == 2) {
    launch_packed<2>(w, ef, payload, sc, resid, n, d, route, s);
  } else {
    launch_packed<5>(w, ef, payload, sc, resid, n, d, route, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quantize_send_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
