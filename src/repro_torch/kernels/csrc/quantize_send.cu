// Send-side encode of the quantized wire codecs for Hopper (sm_90a): one
// pass over the population's fresh models per cycle.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/gossip_cycle.py
// quantize_send:
//   affine8_kernel   <- _send_kernel (the int8 and int8_sr codecs): per row
//                       min and max, zp = f16(sat((hi + lo) / 2)), scale =
//                       f16(sat(max(hi - zp, zp - lo) / 126)), codes
//                       round((w - zp) / scale) — or floor(u + noise) for
//                       int8_sr — clipped to +-127;
//   packed_kernel    <- _pack_send_kernel (int4, ternary and their _ef
//                       variants): x = w (+ ef), scale = f16(sat(max|x| /
//                       qmax)), codes round(x / scale) clipped to +-qmax,
//                       packed two nibbles (int4) or five base-3 trits
//                       (ternary) a byte, and under error feedback the
//                       residual x - code * scale.
// The op order is wire_codec.quantize_wire's and PackedSymmetricCodec's:
// rintf rounds half to even like torch.round (roundf would not); the f16
// saturation compares explicitly and keeps NaN, as torch.clamp does, before
// __float2half_rn; min, max and max|x| propagate NaN like torch.amin/amax;
// the zero guard where(scale > 0, scale, 1) takes the guard for NaN. With
// --fmad=false and IEEE division every code, byte, scale, zero-point and
// residual equals the plain PyTorch version bit for bit.
//
// int8_sr noise is positional: element (r, j) takes jax.random.uniform
// (partitionable threefry-2x32) at flat position p = r * d + j, i.e. the
// block cipher on the counter (p >> 32, p & 0xFFFFFFFF), bits = y0 ^ y1, the
// top 23 bits as a mantissa in [1, 2), minus 1. No thread talks to another
// for it, and the key (the cycle's k_recv, int64 words holding uint32
// values) is read on the device, never by the host.
//
// Layout: one warp per message row, kRowsPerBlock rows per block. The row's
// range is a warp-shuffle reduction over lanes striding over d; then lanes
// stride over the output. For the packed codecs a lane owns whole output
// bytes (its 2 or 5 codes), so no two lanes write one byte; the codes past
// d in the last byte are code 0 (nibble 0, trit digit 1), as pack_int4 and
// pack_ternary pad. Rows are read and written element by element: a packed
// row of ceil(d/2) or ceil(d/5) bytes starts at any byte. The kernels write
// new tensors that the wrapper allocates; the engine copies them into the
// in-flight buffer row.
//
// Bound: device memory (3.35 TB/s on an H100 SXM), except where int8_sr's
// threefry (about 120 integer operations an element) is the larger term.
// Per launch the kernel must read w (and ef) once and write the codes, the
// f16 scale (and zero-point), and the residual: at N = 10^6 and d = 10,
// 40 MB read and 14 MB written for int8/int8_sr, 80 MB read and 47 MB
// written for int4_ef, 40 MB read and 4 MB written for ternary, 0.013 to
// 0.04 ms. chip_smoke.py computes the bound from each launch's shapes.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr float kF16Max = 65504.0f;
constexpr float kInt8Qmax = 126.0f;

// min / max that keep a NaN operand, as torch.amin / torch.amax do
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
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

template <bool SR>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
affine8_kernel(const float* __restrict__ w, const int64_t* __restrict__ key,
               int8_t* __restrict__ q, __half* __restrict__ scale_out,
               __half* __restrict__ zp_out, int n, int d) {
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
  lo = warp_min(lo);
  hi = warp_max(hi);
  const __half zp = sat_f16((hi + lo) * 0.5f);
  const float zpf = __half2float(zp);
  const __half sc = sat_f16(nan_max(hi - zpf, zpf - lo) / kInt8Qmax);
  const float sf = guarded(__half2float(sc));

  uint32_t k0 = 0, k1 = 0;
  if (SR) {
    k0 = static_cast<uint32_t>(key[0]);
    k1 = static_cast<uint32_t>(key[1]);
  }
  int8_t* qr = q + r * d;
  for (int j = lane; j < d; j += kWarp) {
    float u = (wr[j] - zpf) / sf;
    if (SR) {
      u = floorf(u + uniform_at(k0, k1, r * d + j));
    } else {
      u = rintf(u);
    }
    qr[j] = static_cast<int8_t>(clip_code(u, 127.0f));
  }
  if (lane == 0) {
    scale_out[r] = sc;
    zp_out[r] = zp;
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
  for (int j = lane; j < d; j += kWarp) amax = nan_max(amax, fabsf(xval(j)));
  amax = warp_max(amax);
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
      if (G == 2) {
        byte |= (code & 0xF) << (4 * g);
      } else {
        const int p3 = g == 0 ? 1 : g == 1 ? 3 : g == 2 ? 9 : g == 3 ? 27 : 81;
        byte += (code + 1) * p3;
      }
    }
    pr[b] = static_cast<uint8_t>(byte);
  }
  if (lane == 0) scale_out[r] = sc;
}

unsigned blocks_for(int n) {
  return (static_cast<unsigned>(n) + kRowsPerBlock - 1) / kRowsPerBlock;
}

}  // namespace

// int8 / int8_sr: w (n, d) f32 -> q (n, d) int8, scale and zp (n,) f16.
// key: the (2,) int64 threefry key (read only when stochastic). Returns
// cudaGetLastError() after the launch (0 on success); asynchronous on
// `stream`.
extern "C" int quantize_send_affine8(const float* w, const int64_t* key,
                                     int8_t* q, void* scale, void* zp, int n,
                                     int d, int stochastic, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __half* sc = static_cast<__half*>(scale);
  __half* z = static_cast<__half*>(zp);
  if (stochastic) {
    affine8_kernel<true><<<blocks_for(n), kWarp * kRowsPerBlock, 0, s>>>(
        w, key, q, sc, z, n, d);
  } else {
    affine8_kernel<false><<<blocks_for(n), kWarp * kRowsPerBlock, 0, s>>>(
        w, key, q, sc, z, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// int4 (group 2) / ternary (group 5), with error feedback when ef is not
// null: w (and ef) (n, d) f32 -> payload (n, ceil(d / group)) uint8, scale
// (n,) f16, resid (n, d) f32 (written only with ef).
extern "C" int quantize_send_packed(const float* w, const float* ef,
                                    uint8_t* payload, void* scale,
                                    float* resid, int n, int d, int group,
                                    void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __half* sc = static_cast<__half*>(scale);
  const dim3 grid(blocks_for(n)), block(kWarp * kRowsPerBlock);
  if ((ef == nullptr) != (resid == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (group == 2) {
    if (ef) packed_kernel<2, true><<<grid, block, 0, s>>>(w, ef, payload, sc,
                                                          resid, n, d);
    else packed_kernel<2, false><<<grid, block, 0, s>>>(w, ef, payload, sc,
                                                        resid, n, d);
  } else if (group == 5) {
    if (ef) packed_kernel<5, true><<<grid, block, 0, s>>>(w, ef, payload, sc,
                                                          resid, n, d);
    else packed_kernel<5, false><<<grid, block, 0, s>>>(w, ef, payload, sc,
                                                        resid, n, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quantize_send_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
