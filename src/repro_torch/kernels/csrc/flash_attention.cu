// Blocked online-softmax attention forward for Hopper (sm_90a): causal,
// sliding window, grouped-query heads.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// flash_attention (body _flash_kernel). For q (B, S, H, hd) and k, v
// (B, S, KV, hd), query head h reads kv head h / (H / KV), and for query
// position i and key position j (Sq = Sk, no offset):
//
//   s_ij = <q_i, k_j> / sqrt(hd)        masked (-1e30) unless j <= i (causal)
//                                        and i - j < window (if a window)
//   out_i = sum_j p_ij v_j / max(l_i, 1e-30),  p_ij = exp(s_ij - m_i) or 0
//                                               where masked, l_i = sum_j p_ij
//
// with the running max m, the sum l and the accumulator in float32 over
// inputs upcast to float32, updated tile by tile as the Pallas body does
// (alpha = exp(m_prev - m_new) rescales l and the accumulator). A fully
// masked row gives 0. Key tiles wholly outside the causal/window band are
// not visited. The output has q's type (float32 or bfloat16, rounded to
// nearest even).
//
// q, k and v are read where they lie, in their own (B, S, heads, hd)
// layout with the strides the caller passes (hd contiguous): no transposed
// or padded copy, and hd is not padded (the TPU kernel pads hd to its
// 128-lane width).
//
// Layout: one block of 256 threads per (b h, tile of kBQ = 64 queries).
// The block stages its query tile, then each key tile of kBK = 32 keys and
// values, in shared memory as float32 (rows padded by one float, so that
// the threads of a warp reading one column of 16 rows hit 16 banks), and
// per key tile runs three phases between barriers:
//   1. scores: thread (tr, tc) = (tid / 16, tid % 16) computes the 4 x 2
//      scores of rows tr + 16 i and keys tc + 16 j by explicit fmaf over
//      hd into the (kBQ, kBK) score tile;
//   2. softmax: four threads a row (row tid / 4) take the tile's row max
//      and the exponentials, keep the row's running m and l in registers,
//      and leave p in the score tile and alpha beside it;
//   3. P V: thread (tr, tc) holds the accumulator of rows tr + 16 i and
//      columns tc + 16 j (4 x hd/16 floats in registers), rescales it by
//      alpha and adds p v over the tile's keys.
// Templated on the element type (float, bfloat16) and on hd: 64 and 128
// compile with exact bounds; HD = 0 is the generic path for any hd up to
// kMaxHD, with the bound read at run time and the columns past hd masked.
// The products are CUDA-core float32 fmas; tensor cores (wgmma), TMA and a
// pipelined ring of tiles are later work.
//
// Bound: at the serving shapes (B = 4, S = 2048, H = 16, hd = 128, bf16,
// causal) the work is about 4 B H hd S^2 / 2 = 6.9e10 operations against
// 4 B S (H + 2 KV) hd bytes = 2.7e7: operations bound it, at the card's
// 989 TFLOP/s for dense bf16 on the tensor cores (0.070 ms); this kernel
// does them on the CUDA cores in float32, whose peak is 67 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // queries per block
constexpr int kBK = 32;          // keys per tile
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kBQ / 16;   // 4 query rows per thread
constexpr int kKeysPerThread = kBK / 16;   // 2 keys per thread (scores)
constexpr int kPartsPerRow = kThreads / kBQ;        // 4 softmax threads a row
constexpr int kColsPerPart = kBK / kPartsPerRow;    // 8 keys each
constexpr int kMaxHD = 256;      // the generic path's largest hd
constexpr float kNegInf = -1e30f;
constexpr float kMinSum = 1e-30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // element strides of dims 0-2 (b, s, head) of q, k, v and o; dim 3 is 1
  int64_t st[4][3];
  int b, s, h, kv, hd;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// rows [row0, row0 + rows) of one head, upcast into shared memory with row
// stride ld; rows at or past S are zero
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      const int64_t* st, int bi, int head,
                                      int row0, int rows, int s, int hd,
                                      int ld) {
  const T* base = src + bi * st[0] + head * st[2];
  for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
    const int r = e / hd;
    const int c = e - r * hd;
    const int pos = row0 + r;
    dst[r * ld + c] = pos < s ? to_f32(base[pos * st[1] + c]) : 0.0f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int s,
                                        int causal, int window) {
  const int diff = qpos - kpos;
  return kpos < s && (!causal || diff >= 0) && (window <= 0 || diff < window);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Args a) {
  constexpr int kCols = (HD ? HD : kMaxHD) / 16;  // accumulator columns
  const int hd = HD ? HD : a.hd;
  const int ld = hd + 1;
  extern __shared__ float smem[];
  float* sq = smem;                    // kBQ x ld
  float* sk = sq + kBQ * ld;           // kBK x ld
  float* sv = sk + kBK * ld;           // kBK x ld
  float* ss = sv + kBK * ld;           // kBQ x (kBK + 1): scores, then p
  float* srow = ss + kBQ * (kBK + 1);  // kBQ: alpha, at the end 1 / l

  const int bh = blockIdx.y;
  const int bi = bh / a.h;
  const int head = bh - bi * a.h;
  const int kvh = head / (a.h / a.kv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int srow_id = tid / kPartsPerRow;   // softmax: this thread's row
  const int part = tid % kPartsPerRow;

  stage(sq, static_cast<const T*>(a.q), a.st[0], bi, head, q0, kBQ, a.s, hd,
        ld);

  float m_run = kNegInf;  // softmax threads: the row's running max, sum
  float l_run = 0.0f;
  float acc[kRowsPerThread][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // the band of keys this query tile can see
  int k_lo = 0;
  int k_hi = a.s;
  if (a.causal) k_hi = min(a.s, q0 + kBQ);
  if (a.window > 0) k_lo = max(0, q0 - (a.window - 1));
  for (int k0 = k_lo / kBK * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage(sk, static_cast<const T*>(a.k), a.st[1], bi, kvh, k0, kBK, a.s, hd,
          ld);
    stage(sv, static_cast<const T*>(a.v), a.st[2], bi, kvh, k0, kBK, a.s, hd,
          ld);
    __syncthreads();

    // 1. scores
    float sc[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) sc[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int c = 0; c < hd; ++c) {
      float qv[kRowsPerThread];
      float kk[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = sq[(tr + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) kk[j] = sk[(tc + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j) {
          sc[i][j] = fmaf(qv[i], kk[j], sc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int r = tr + 16 * i;
        const int c = tc + 16 * j;
        ss[r * (kBK + 1) + c] =
            visible(q0 + r, k0 + c, a.s, a.causal, a.window)
                ? sc[i][j] * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // 2. online softmax, four threads a row
    {
      float* row = ss + srow_id * (kBK + 1) + part * kColsPerPart;
      const int qpos = q0 + srow_id;
      const int kbase = k0 + part * kColsPerPart;
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kColsPerPart; ++u) mx = fmaxf(mx, row[u]);
#pragma unroll
      for (int o = 1; o < kPartsPerRow; o <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kColsPerPart; ++u) {
        const float p = visible(qpos, kbase + u, a.s, a.causal, a.window)
                            ? expf(row[u] - m_new) : 0.0f;
        row[u] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < kPartsPerRow; o <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      const float alpha = expf(m_run - m_new);
      l_run = alpha * l_run + sum;
      m_run = m_new;
      if (part == 0) srow[srow_id] = alpha;
    }
    __syncthreads();

    // 3. acc = alpha acc + P V
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const float al = srow[tr + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= al;
    }
    for (int c = 0; c < kBK; ++c) {
      float p[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        p[i] = ss[(tr + 16 * i) * (kBK + 1) + c];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tc + 16 * j;
        if (HD == 0 && col >= hd) break;
        const float vv = sv[c * ld + col];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), in q's type
  __syncthreads();
  if (part == 0) srow[srow_id] = fmaxf(l_run, kMinSum);
  __syncthreads();
  T* o = static_cast<T*>(a.o) + bi * a.st[3][0] + head * a.st[3][2];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = tr + 16 * i;
    const int pos = q0 + r;
    if (pos >= a.s) continue;
    const float l = srow[r];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = tc + 16 * j;
      if (HD == 0 && col >= hd) break;
      o[pos * a.st[3][1] + col] = from_f32<T>(acc[i][j] / l);
    }
  }
}

size_t smem_bytes(int hd) {
  const int ld = hd + 1;
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * ld + kBQ * (kBK + 1) + kBQ);
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.hd);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.b * a.h);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Args& a, cudaStream_t stream) {
  switch (a.hd) {
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return launch<T, 0>(a, stream);
  }
}

}  // namespace

// q (B, S, H, hd), k and v (B, S, KV, hd), o (B, S, H, hd), all of one
// type (dtype 0 = float32, 1 = bfloat16) with hd contiguous; strides holds
// the element strides of dims 0-2 of q, k, v, then o (12 int64). window
// <= 0 means none; scale is 1 / sqrt(hd). Returns cudaGetLastError()
// after the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* o, int dtype,
                                       int b, int s, int h, int kv, int hd,
                                       const int64_t* strides, int causal,
                                       int window, float scale,
                                       void* stream) {
  if (b <= 0 || s <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  if (kv <= 0 || h % kv != 0 || hd <= 0 || hd > kMaxHD || b * h > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, o, {}, b, s, h, kv, hd, causal, window, scale};
  for (int t = 0; t < 4; ++t) {
    for (int d = 0; d < 3; ++d) a.st[t][d] = strides[3 * t + d];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_hd<float>(a, st); break;
    case 1: err = launch_hd<__nv_bfloat16>(a, st); break;
    default: err = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(err);
}

// the dynamic shared memory a block asks for at head_dim hd (<= kMaxHD):
// above 48 KB (hd > 80) the launch opts in through cudaFuncSetAttribute
extern "C" int flash_attention_smem_bytes(int hd) {
  return static_cast<int>(smem_bytes(hd));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
