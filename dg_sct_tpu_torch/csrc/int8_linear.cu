// K4: the int8 linear of int8 serving, for Hopper (sm_90a).
//
// Replaces dg_sct_tpu/ops/quant.py:52 `linear_int8`, an XLA int8 dot with
// int32 sums (no pallas_call on the TPU). For x (rows, K) in float32 or
// bfloat16 and the weight quantized per output column:
//   xq = clip(rint(x / ascale), -127, 127)            (int8)
//   y  = float(xq . Wq) * (ascale * kscale) + bias     (int32 sums, float32)
// and y is cast to x's type. ascale is one static float32 value, or per row
// max(absmax(row), 1e-8) / 127 from the absmax the wrapper passes. The
// quantize rounds as rint of the IEEE quotient does (`quant_fast`: a product
// by the reciprocal, `quant_exact`'s division where the two could round apart),
// rint rounds half to even, the integer product is exact (|sum| <= 127^2 *
// 6144 < 2^31), and the epilogue's multiply and add are kept apart
// (__fmul_rn / __fadd_rn, no FMA), so the kernel repeats the JAX package's
// arithmetic step for step.
//
// What bounds it on this card: at the main path's shapes, operations for the
// larger GEMMs (int8 tensor cores, 1979 TOPS dense) and bytes for the
// skinny ones; x is read in its own type (2 or 4 bytes an element), the
// int8 weight once per row tile.
//
// Design, a simple correct kernel (mma.sync, no wgmma, no TMA): one block of
// 8 warps (2 x 4, each 32 x 32) per 64 x 128 output tile, k-tiles of 64. A
// ring of 4 stages (3 in float32) of shared memory keeps the raw x tile and
// the int8 weight tile of the next k-tiles in flight by cp.async while the
// current one runs, since at these shapes a k-tile's compute is shorter than
// a trip to device memory. Each k-tile, the block quantizes its raw x tile
// from shared memory into an int8 tile (the row's scale from shared memory;
// rows past the end are zeros, without divisions), then runs it against the
// weight tile on mma.sync m16n8k32 s8 with int32 accumulators. The weight is
// kept as (N, K) rows, so a B fragment is one 32-bit load; int8 rows are 80
// bytes apart, so the fragment loads hit 32 distinct banks. Every column tile
// quantizes its rows again: the 128-wide tile halves that repeated work
// against a 64-wide one. Dequantize, bias and cast happen in registers in the
// epilogue. Ragged row and column tiles are masked (zero-filled copies).
#include "tensor_core.cuh"

namespace dgsct {
namespace {

constexpr int kBM = 64, kBN = 128, kBK = 64;
constexpr int kThreads = 256;
constexpr int kStride = kBK + 16;  // bytes between rows of an int8 tile
constexpr int kBBytes = kBN * kStride;
constexpr int kABytes = kBM * kStride;

// Stages of the ring for x of type T: 3 for float32 keeps two blocks an SM.
template <typename T> struct Ring {
  static constexpr int kStages = sizeof(T) == 4 ? 3 : 4;
  static constexpr int kRawBytes = kBM * kBK * static_cast<int>(sizeof(T));  // a raw x tile
  static constexpr int kSmem = kStages * (kRawBytes + kBBytes) + 2 * kABytes +
                               kBM * static_cast<int>(sizeof(float2));
};

// The quantize of one value, clip(rint(v / s), -127, 127), from sr = (s, 1/s
// correctly rounded), as a float. The fast form takes q = v * (1/s), which
// lies within 1.5 ulp of the correctly rounded quotient, clamps it to
// [-128, 128] (the clip makes that exact) and rounds half to even by the
// 1.5 * 2^23 trick, in full-rate adds with no branch. The two quotients round
// to the same integer unless they lie within a few ulp of a half-integer; the
// fast form flags that case (rare), and the exact form then decides with the
// IEEE division.
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23

__device__ __forceinline__ float quant_fast(float v, float2 sr, bool& near_tie) {
  const float q = fminf(fmaxf(__fmul_rn(v, sr.y), -128.0f), 128.0f);
  const float rq = __fsub_rn(__fadd_rn(q, kMagic), kMagic);
  near_tie |= fabsf(fabsf(__fsub_rn(q, rq)) - 0.5f) <= fabsf(q) * 0x1p-20f;
  return fminf(fmaxf(rq, -127.0f), 127.0f);
}

__device__ __forceinline__ float quant_exact(float v, float2 sr) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, sr.x)), -127.0f), 127.0f);
}

// An integer-valued float in [-127, 127] as its low byte, by the same trick.
__device__ __forceinline__ uint32_t byte_of(float rq) {
  return static_cast<uint32_t>(__float_as_int(__fadd_rn(rq, kMagic))) & 0xffu;
}

// Four values -> four int8 in one word, the first in the lowest byte.
__device__ __forceinline__ uint32_t pack_s8(float a, float b, float c, float d) {
  return byte_of(a) | (byte_of(b) << 8) | (byte_of(c) << 16) | (byte_of(d) << 24);
}

// 16 bytes of x (4 floats or 8 bf16) -> their int8 values in shared memory.
template <int N> __device__ __forceinline__ void quant_store_f(const float (&v)[N], float2 sr,
                                                               int8_t* dst) {
  float q[N];
  bool near_tie = false;
#pragma unroll
  for (int i = 0; i < N; ++i) q[i] = quant_fast(v[i], sr, near_tie);
  if (near_tie) {
#pragma unroll
    for (int i = 0; i < N; ++i) q[i] = quant_exact(v[i], sr);
  }
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<uint32_t*>(dst + i) = pack_s8(q[i], q[i + 1], q[i + 2], q[i + 3]);
}

template <typename T> struct ALoad;

template <> struct ALoad<float> {
  static constexpr int kPerChunk = 4;  // elements in 16 bytes
  using Raw = float4;
  __device__ __forceinline__ static void quant_store(const Raw& r, float2 sr, int8_t* dst) {
    const float v[4] = {r.x, r.y, r.z, r.w};
    quant_store_f(v, sr, dst);
  }
};

template <> struct ALoad<__nv_bfloat16> {
  static constexpr int kPerChunk = 8;
  using Raw = uint4;
  __device__ __forceinline__ static float2 pair(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
  __device__ __forceinline__ static void quant_store(const Raw& r, float2 sr, int8_t* dst) {
    const float2 a = pair(r.x), b = pair(r.y), c = pair(r.z), d = pair(r.w);
    const float v[8] = {a.x, a.y, b.x, b.y, c.x, c.y, d.x, d.y};
    quant_store_f(v, sr, dst);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_linear_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ kscale, const float* __restrict__ ascale,
                   const void* __restrict__ bias, T* __restrict__ out, int rows, int K, int N,
                   int per_row, int bias_bf16) {
  using L = ALoad<T>;
  constexpr int kStages = Ring<T>::kStages;
  constexpr int kPer = L::kPerChunk;                         // elements in 16 bytes
  constexpr int kChunksPerRow = kBK / kPer;                  // 16 (f32) or 8 (bf16)
  constexpr int kAChunks = kBM * kChunksPerRow / kThreads;   // 4 or 2 a thread
  constexpr int kBChunks = kBN * (kBK / 16) / kThreads;      // 2 a thread
  constexpr int kRawBytes = Ring<T>::kRawBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw = smem;                                           // kStages raw x tiles
  int8_t* bring = reinterpret_cast<int8_t*>(smem + kStages * kRawBytes);  // kStages w tiles
  int8_t* aq = bring + kStages * kBBytes;                              // 2 int8 x tiles
  float2* row_scale = reinterpret_cast<float2*>(aq + 2 * kABytes);  // (s, 1/s) a row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const int KT = K / kBK;

  if (tid < kBM) {
    const int r = m0 + tid;
    float s = 1.0f;
    if (r < rows) s = per_row ? __fdiv_rn(fmaxf(ascale[r], 1e-8f), 127.0f) : ascale[0];
    row_scale[tid] = make_float2(s, __frcp_rn(s));
  }

  // k-tile kt's raw x rows and weight rows into ring slot kt % kStages
  auto load_stage = [&](int kt) {
    const int slot = kt % kStages;
    T* xs = reinterpret_cast<T*>(raw + slot * kRawBytes);
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * kPer;
      const bool valid = m0 + r < rows;
      const T* src = valid ? x + static_cast<size_t>(m0 + r) * K + kt * kBK + col : x;
      cp_async16(xs + r * kBK + col, src, valid);
    }
    int8_t* ws = bring + slot * kBBytes;
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int c = tid + i * kThreads;
      const int n = c >> 2, kc = (c & 3) * 16;
      const bool valid = n0 + n < N;
      const int8_t* src = valid ? w + static_cast<size_t>(n0 + n) * K + kt * kBK + kc : w;
      cp_async16(ws + n * kStride + kc, src, valid);
    }
  };
  // the raw x tile of k-tile kt -> int8 tile buf
  auto quantize = [&](int kt, int buf) {
    const T* xs = reinterpret_cast<const T*>(raw + (kt % kStages) * kRawBytes);
    int8_t* dst = aq + buf * kABytes;
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunksPerRow, col = (c % kChunksPerRow) * kPer;
      int8_t* d = dst + r * kStride + col;
      if (m0 + r < rows) {
        L::quant_store(*reinterpret_cast<const typename L::Raw*>(xs + r * kBK + col),
                       row_scale[r], d);
      } else {
#pragma unroll
        for (int e = 0; e < kPer; e += 4) *reinterpret_cast<uint32_t*>(d + e) = 0u;
      }
    }
  };
  const bool warp_rows = m0 + wm < rows;  // the warp's 32 rows hold at least one row of x

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_stage(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // k-tile kt has landed; k-tile kt - 1's products are done
    quantize(kt, kt & 1);
    if (kt + kStages - 1 < KT) load_stage(kt + kStages - 1);  // into k-tile kt - 1's slot
    cp_async_commit();
    __syncthreads();  // the int8 x tile is complete
    const int8_t* as = aq + (kt & 1) * kABytes;
    const int8_t* bs = bring + (kt % kStages) * kBBytes;
    if (!warp_rows) continue;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = as + (wm + mi * 16 + g) * kStride + ks + 4 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = bs + (wn + ni * 8 + g) * kStride + ks + 4 * t;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }

  // epilogue: float(acc) * (ascale * kscale) + bias, in x's type
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + 2 * t;
    if (col >= N) continue;
    const float ks0 = kscale[col], ks1 = kscale[col + 1];
    float b0 = 0.0f, b1 = 0.0f;
    if (bias != nullptr) {
      if (bias_bf16) {
        const __nv_bfloat16* bp = static_cast<const __nv_bfloat16*>(bias);
        b0 = __bfloat162float(bp[col]);
        b1 = __bfloat162float(bp[col + 1]);
      } else {
        const float* bp = static_cast<const float*>(bias);
        b0 = bp[col];
        b1 = bp[col + 1];
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = wm + mi * 16 + g + 8 * h;
        const int r = m0 + rl;
        if (r >= rows) continue;
        const float sa = row_scale[rl].x;
        float y0 = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h]), __fmul_rn(sa, ks0));
        float y1 = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + 1]), __fmul_rn(sa, ks1));
        if (bias != nullptr) {
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
        }
        store2(out + static_cast<size_t>(r) * N + col, y0, y1);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* kscale, const void* ascale,
           const void* bias, void* out, int rows, int K, int N, int per_row, int bias_bf16,
           cudaStream_t s) {
  const dim3 grid((rows + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  constexpr int smem = Ring<T>::kSmem;
  const cudaError_t err = allow_smem(int8_linear_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_linear_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(kscale), static_cast<const float*>(ascale), bias,
      static_cast<T*>(out), rows, K, N, per_row, bias_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dgsct

// x (rows, K) f32/bf16, w (N, K) int8 rows, kscale (N,) f32, ascale: one f32
// (per_row = 0) or the rows' f32 absmax (per_row = 1), bias (N,) or null in
// f32 (bias_dtype 0) or bf16 (1), out (rows, N) in x's type.
extern "C" int k4_int8_linear(const void* x, const void* w, const void* kscale,
                              const void* ascale, const void* bias, void* out, int rows, int K,
                              int N, int per_row, int bias_dtype, int dtype, void* stream) {
  using namespace dgsct;
  if (rows <= 0 || K <= 0 || N <= 0 || K % kBK != 0 || N % 8 != 0 ||
      (N + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int bias_bf16 = bias_dtype == kBF16;
  if (dtype == kF32)
    return launch<float>(x, w, kscale, ascale, bias, out, rows, K, N, per_row, bias_bf16, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, w, kscale, ascale, bias, out, rows, K, N, per_row,
                                 bias_bf16, s);
  return cudaErrorInvalidValue;
}
