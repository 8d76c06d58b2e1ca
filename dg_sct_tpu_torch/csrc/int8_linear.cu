// K4: the int8 linear of int8 serving, for Hopper (sm_90a), as two kernels.
//
// Replaces dg_sct_tpu/ops/quant.py:52 `linear_int8`, an XLA int8 dot with
// int32 sums (no pallas_call on the TPU). For x (rows, K) in float32 or
// bfloat16 and the weight quantized per output column:
//   xq = clip(rint(x / ascale), -127, 127)            (int8)
//   y  = float(xq . Wq) * (ascale * kscale) + bias     (int32 sums, float32)
// and y is cast to x's type. ascale is one static float32 value, or per row
// max(absmax(row), 1e-8) / 127. The quantize rounds as rint of the IEEE
// quotient does (`quant_fast`: a product by the reciprocal, `quant_exact`'s
// division where the two could round apart), rint rounds half to even, the
// integer product is exact (|sum| <= 127^2 * 6144 < 2^31), and the
// epilogue's multiply and add are kept apart (__fmul_rn / __fadd_rn, no FMA),
// so the kernels repeat the JAX package's arithmetic step for step.
//
// What bounds it on this card: bytes at the main path's shapes (x read in its
// own type, the int8 weight, the output written in x's type: 4.9 GB a bf16
// B=2 forward, 1.48 ms, against 1.74 T int8 operations, 0.88 ms).
//
// Design:
//  * `int8_quantize_kernel` quantizes each element of x once a call: one warp
//    a row, 16-byte loads, the row's absmax from the same warp for dynamic
//    scales (a first pass over the row; the second reads it from the cache),
//    and writes the int8 rows and each row's (s, 1/s) as a float2.
//  * `int8_linear_kernel` multiplies the int8 rows by the weight's (N, K) int8
//    rows on wgmma: one block of 2 consumer warpgroups and a producer warp a
//    128 x 128 output tile, two blocks an SM. The producer keeps a 96 KB ring
//    of k-tiles loading by TMA (both operands K-major, swizzled as wgmma reads
//    them; bytes past K and rows past the end arrive as zeros), with an
//    mbarrier for each stage's arrival and one for its release; each
//    warpgroup runs m64n128k32 products with int32 sums on its 64 rows. The
//    epilogue dequantizes, adds the bias and casts in registers, stages the
//    tile in shared memory (rows padded: no bank conflicts) and writes it as
//    16-byte row segments.
// Ragged row and column tiles are masked (zero-filled loads, masked stores).
#include "hopper.cuh"
#include "tensor_core.cuh"

namespace dgsct {
namespace {

// ---------------------------------------------------------------------------
// the quantize
// ---------------------------------------------------------------------------

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

// 16 bytes of x as floats: 4 float32 or 8 bfloat16.
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};

template <> struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

constexpr int kQuantWarps = 8;  // rows a block

// x (rows, K) -> xq (rows, K) int8 and rs (rows,) float2 (s, 1/s). One warp a
// row; s = ascale[0] (static) or max(absmax(row), 1e-8) / 127 (per_row), NaN
// if the row holds a NaN, as the plain version's amax gives.
template <typename T>
__global__ void __launch_bounds__(kQuantWarps * 32)
int8_quantize_kernel(const T* __restrict__ x, const float* __restrict__ ascale,
                int8_t* __restrict__ xq, float2* __restrict__ rs, int rows, int K, int per_row) {
  using C = Chunk<T>;
  constexpr int kN = C::kN;
  grid_launch_dependents();  // the GEMM that follows may start its prologue
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * K;
  int8_t* qr = xq + static_cast<size_t>(row) * K;
  const int chunks = K / kN;
  float s;
  if (per_row) {
    float m = 0.0f;
    bool nan = false;
    for (int c = lane; c < chunks; c += 32) {
      float v[kN];
      C::load(xr + c * kN, v);
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        m = fmaxf(m, fabsf(v[i]));
        nan |= v[i] != v[i];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    s = __any_sync(0xffffffffu, nan) ? __int_as_float(0x7fffffff)
                                     : __fdiv_rn(fmaxf(m, 1e-8f), 127.0f);
  } else {
    s = ascale[0];
  }
  const float2 sr = make_float2(s, __frcp_rn(s));
  if (lane == 0) rs[row] = sr;
  for (int c = lane; c < chunks; c += 32) {
    float v[kN], q[kN];
    C::load(xr + c * kN, v);
    bool near_tie = false;
#pragma unroll
    for (int i = 0; i < kN; ++i) q[i] = quant_fast(v[i], sr, near_tie);
    if (near_tie) {
#pragma unroll
      for (int i = 0; i < kN; ++i) q[i] = quant_exact(v[i], sr);
    }
    if constexpr (kN == 4) {
      *reinterpret_cast<uint32_t*>(qr + c * kN) = pack_s8(q[0], q[1], q[2], q[3]);
    } else {
      *reinterpret_cast<uint2*>(qr + c * kN) =
          make_uint2(pack_s8(q[0], q[1], q[2], q[3]), pack_s8(q[4], q[5], q[6], q[7]));
    }
  }
}

// ---------------------------------------------------------------------------
// the int8 GEMM
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128;      // the output tile
constexpr int kGemmThreads = 288;        // 2 consumer warpgroups and 1 producer warp
constexpr int kRingBytes = 96 * 1024;    // two blocks an SM
constexpr int kOutPad = 8;               // elements past each staged output row

constexpr int kKB = 128;                          // a k-tile: 128 bytes (`tma_map_u8`'s boxes)
constexpr int kTile = kBM * kKB;                  // one A or B tile of a stage, 16 KB
constexpr int kStages = kRingBytes / (2 * kTile);  // 3

template <typename T> struct Staged {
  static constexpr int kStride = kBN + kOutPad;
  static constexpr int kBytes = kBM * kStride * static_cast<int>(sizeof(T));
  static_assert(kBytes <= kRingBytes, "the output tile reuses the ring");
};

constexpr int kGemmSmem = 1024 + kRingBytes + 2 * 8 * 8;  // 1 KB to align the ring; barriers

// xq (rows, K) int8 and w (N, K) int8 rows by TMA (amap, bmap: boxes of 128
// rows x 128 bytes, 128-byte swizzle; bytes past K and rows past the end read
// as zeros), rs (rows,) (s, 1/s), kscale (N,), bias (N,) or null -> out
// (rows, N) in T. Warp 8 keeps a ring of stages loading; warpgroup w (warps
// 4w..4w+3) multiplies rows 64w..64w+63 of the 128 x 128 tile on wgmma
// m64n128k32 and frees each stage once its products are done. Launched as a
// programmatic dependent of the quantize: the prologue and the first stages'
// weight tiles overlap the quantize's end, and xq and rs are read only after
// `grid_dependency_wait`.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads, 2)
int8_linear_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap, const float2* __restrict__ rs,
                   const float* __restrict__ kscale, const void* __restrict__ bias,
                   T* __restrict__ out, int rows, int K, int N, int bias_bf16) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (shared_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int KT = (K + kKB - 1) / kKB;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  } else if (tid == 256) {
    tma_prefetch(&amap);
    tma_prefetch(&bmap);
  }
  __syncthreads();

  if (warp == 8) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      const int first = KT < kStages ? KT : kStages;
      for (int kt = 0; kt < first; ++kt) {  // the weight needs no wait for the quantize
        mbar_arrive_expect_tx(&full[kt], 2 * kTile);
        tma_load_2d(smem + kt * 2 * kTile + kTile, &bmap, &full[kt], kt * kKB, n0);
      }
      grid_dependency_wait();  // the quantize's xq and rs are complete and visible
      for (int kt = 0; kt < first; ++kt)
        tma_load_2d(smem + kt * 2 * kTile, &amap, &full[kt], kt * kKB, m0);
      for (int kt = first; kt < KT; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        unsigned char* a = smem + s * 2 * kTile;
        mbar_arrive_expect_tx(&full[s], 2 * kTile);
        tma_load_2d(a, &amap, &full[s], kt * kKB, m0);
        tma_load_2d(a + kTile, &bmap, &full[s], kt * kKB, n0);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    __syncwarp();  // wgmma is .aligned: the warp issues it converged
    const unsigned char* a = smem + s * 2 * kTile;
    const uint64_t da = smem_desc(a + wg * 64 * kKB), db = smem_desc(a + kTile);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kKB / 32; ++k)  // 32 bytes of k a product: the start address + 32 k
      wgmma_m64n128k32_s8(acc, da + 2 * k, db + 2 * k);
    wgmma_commit();
    wgmma_wait<1>();  // k-tile kt - 1's products are done: its stage is free
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();
  named_barrier(1, 256);  // both warpgroups are done with the ring: it becomes the output tile
  grid_dependency_wait();  // returns at once: the producer's wait came before every A tile

  // epilogue: float(acc) * (ascale * kscale) + bias, in T, staged by rows
  constexpr int kOS = Staged<T>::kStride;
  T* tile = reinterpret_cast<T*>(smem);
  const int g = lane >> 2, q = lane & 3;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;  // the thread's rows r0 and r0 + 8
  float sa[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) sa[h] = m0 + r0 + 8 * h < rows ? rs[m0 + r0 + 8 * h].x : 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int cl = 8 * j + 2 * q;
    const int col = n0 + cl;
    float ks0 = 0.0f, ks1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
    if (col < N) {
      ks0 = kscale[col];
      ks1 = kscale[col + 1];
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
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), __fmul_rn(sa[h], ks0));
      float y1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), __fmul_rn(sa[h], ks1));
      if (bias != nullptr) {
        y0 = __fadd_rn(y0, b0);
        y1 = __fadd_rn(y1, b1);
      }
      store2(tile + (r0 + 8 * h) * kOS + cl, y0, y1);
    }
  }
  named_barrier(1, 256);
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes
  constexpr int kRowChunks = kBN / kPer;
  for (int c = tid; c < kBM * kRowChunks; c += 256) {
    const int rl = c / kRowChunks, cl = (c % kRowChunks) * kPer;
    if (m0 + rl < rows && n0 + cl < N)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m0 + rl) * N + n0 + cl) =
          *reinterpret_cast<const uint4*>(tile + rl * kOS + cl);
  }
}

template <typename T>
int launch_gemm(const void* xq, const void* rs, const void* w, const void* kscale,
                const void* bias, void* out, int rows, int K, int N, int bias_bf16,
                cudaStream_t s) {
  CUtensorMap amap, bmap;
  cudaError_t err = tma_map_u8(&amap, xq, rows, K, kBM);
  if (err == cudaSuccess) err = tma_map_u8(&bmap, w, N, K, kBN);
  static const cudaError_t opted_in = allow_smem(int8_linear_kernel<T>, kGemmSmem);  // once
  if (err == cudaSuccess) err = opted_in;
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute dependent;
  dependent.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = kGemmSmem;
  cfg.stream = s;
  cfg.attrs = &dependent;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_linear_kernel<T>, amap, bmap,
                           static_cast<const float2*>(rs), static_cast<const float*>(kscale),
                           bias, static_cast<T*>(out), rows, K, N, bias_bf16);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_quantize(const void* x, const void* ascale, void* xq, void* rs, int rows, int K,
                    int per_row, cudaStream_t s) {
  int8_quantize_kernel<T><<<(rows + kQuantWarps - 1) / kQuantWarps, kQuantWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(ascale), static_cast<int8_t*>(xq),
      static_cast<float2*>(rs), rows, K, per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace dgsct

// x (rows, K) f32/bf16 -> xq (rows, K) int8 and rs (rows, 2) f32 (s, 1/s); ascale
// one f32 (per_row = 0) or unused (per_row = 1: each row's absmax scale).
extern "C" int k4_quantize(const void* x, const void* ascale, void* xq, void* rs, int rows,
                           int K, int per_row, int dtype, void* stream) {
  using namespace dgsct;
  if (rows <= 0 || K <= 0 || K % 64 != 0 || (!per_row && ascale == nullptr))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_quantize<float>(x, ascale, xq, rs, rows, K, per_row, s);
  if (dtype == kBF16)
    return launch_quantize<__nv_bfloat16>(x, ascale, xq, rs, rows, K, per_row, s);
  return cudaErrorInvalidValue;
}

// xq (rows, K) int8, rs (rows, 2) f32, w (N, K) int8 rows, kscale (N,) f32,
// bias (N,) or null in f32 (bias_dtype 0) or bf16 (1) -> out (rows, N) in
// dtype.
extern "C" int k4_int8_gemm(const void* xq, const void* rs, const void* w, const void* kscale,
                            const void* bias, void* out, int rows, int K, int N, int bias_dtype,
                            int dtype, void* stream) {
  using namespace dgsct;
  if (rows <= 0 || K <= 0 || N <= 0 || K % 64 != 0 || N % 8 != 0 ||
      (N + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int bias_bf16 = bias_dtype == kBF16;
  if (dtype == kF32)
    return launch_gemm<float>(xq, rs, w, kscale, bias, out, rows, K, N, bias_bf16, s);
  if (dtype == kBF16)
    return launch_gemm<__nv_bfloat16>(xq, rs, w, kscale, bias, out, rows, K, N, bias_bf16, s);
  return cudaErrorInvalidValue;
}
