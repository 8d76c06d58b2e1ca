// K3: stage 5 of an eval DG-SCT adapter (the grouped bottleneck), for Hopper
// (sm_90a).
//
// Replaces dg_sct_tpu/ops/pallas/adapter_bottleneck.py:66 `_bottleneck_rows`
// (kernel body `_kernel` :39, reached through `fused_bottleneck` :84). Per
// token row x of C channels, after `fold_eval` put the BN affines into the
// GEMM biases and the gate into ln_post:
//   z = LN_before(x) (optional);  for each group g of G:
//   o_g = ReLU(z_g . Wd[g] + bd_g) . Wu[g] + bu_g;  out = LN_post(concat_g o_g)
// Rounding points of the TPU kernel: z_g and the ReLU output h_g are rounded
// to x's type before their products; sums, LN statistics and o are float32.
//
// What bounds it on this card: bytes. The two grouped products cost C^2 / 4
// FLOPs per row (a group's bottleneck is only C / 16 wide) against 2 C
// elements of x and out, far below the card's ratio of operations to bytes.
//
// Design: one block per tile of 16 rows; the ragged last tile is masked, with
// no padding copy. The tile's z sits in shared memory as float32 (16 x C,
// 96 KB at C = 1536), then h (16 x C/8). Wd and Wu (288 KB each in bf16 at
// C = 1536) do not fit beside it and are read from L2 (50 MB) instead: each
// thread owns one output column, reads each weight of that column once per
// tile and applies it to the 16 rows held in registers. o overwrites z in
// shared memory, and one warp per row takes LN_post and stores the tile.
#include "common.cuh"

namespace dgsct {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;

template <typename T, bool HAS_LN1>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ wd,
                  const T* __restrict__ bd, const T* __restrict__ wu,
                  const T* __restrict__ bu, const T* __restrict__ ln1s,
                  const T* __restrict__ ln1b, const T* __restrict__ ln2s,
                  const T* __restrict__ ln2b, T* __restrict__ out, int rows, int C,
                  int G, int go) {
  extern __shared__ float smem[];
  const int gi = C / G, H = G * go;
  float* zs = smem;               // kRows x C: z, later o
  float* hs = zs + kRows * C;     // kRows x H
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;

  // ---- z = LN_before(x), rounded to x's type --------------------------------------
  for (int r = warp; r < kRows; r += kWarps) {
    const int gr = row0 + r;
    float* zr = zs + r * C;
    if (gr >= rows) {
      for (int c = lane; c < C; c += 32) zr[c] = 0.f;
      continue;
    }
    const T* xr = x + static_cast<size_t>(gr) * C;
    for (int c = lane; c < C; c += 32) zr[c] = to_f(xr[c]);
    if (HAS_LN1) {
      __syncwarp();
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += zr[c];
      const float m = warp_sum(s) / C;
      float s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = zr[c] - m;
        s2 += d * d;
      }
      const float rs = rsqrtf(warp_sum(s2) / C + 1e-5f);
      for (int c = lane; c < C; c += 32)
        zr[c] = round_to<T>((zr[c] - m) * rs * to_f(ln1s[c]) + to_f(ln1b[c]));
    }
  }
  __syncthreads();

  // ---- h = ReLU(z_g . Wd[g] + bd), one output column per thread -------------------
  for (int col = tid; col < H; col += kThreads) {
    const int g = col / go, j = col - g * go;
    const T* wcol = wd + static_cast<size_t>(g) * gi * go + j;
    const float* zg = zs + g * gi;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int i = 0; i < gi; ++i) {
      const float w = to_f(wcol[static_cast<size_t>(i) * go]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(zg[r * C + i], w, acc[r]);
    }
    const float b = to_f(bd[col]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) hs[r * H + col] = round_to<T>(fmaxf(acc[r] + b, 0.f));
  }
  __syncthreads();

  // ---- o = h_g . Wu[g] + bu, written over z ----------------------------------------
  for (int col = tid; col < C; col += kThreads) {
    const int g = col / gi, c = col - g * gi;
    const T* wcol = wu + static_cast<size_t>(g) * go * gi + c;
    const float* hg = hs + g * go;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int j = 0; j < go; ++j) {
      const float w = to_f(wcol[static_cast<size_t>(j) * gi]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(hg[r * H + j], w, acc[r]);
    }
    const float b = to_f(bu[col]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) zs[r * C + col] = acc[r] + b;
  }
  __syncthreads();

  // ---- out = LN_post(o) -------------------------------------------------------------
  for (int r = warp; r < kRows; r += kWarps) {
    const int gr = row0 + r;
    if (gr >= rows) continue;
    const float* orow = zs + r * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += orow[c];
    const float m = warp_sum(s) / C;
    float s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = orow[c] - m;
      s2 += d * d;
    }
    const float rs = rsqrtf(warp_sum(s2) / C + 1e-5f);
    T* dst = out + static_cast<size_t>(gr) * C;
    for (int c = lane; c < C; c += 32)
      dst[c] = from_f<T>((orow[c] - m) * rs * to_f(ln2s[c]) + to_f(ln2b[c]));
  }
}

template <typename T, bool HAS_LN1>
int launch(const void* x, const void* wd, const void* bd, const void* wu, const void* bu,
           const void* ln1s, const void* ln1b, const void* ln2s, const void* ln2b,
           void* out, int rows, int C, int G, int go, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRows * (C + G * go);
  auto kern = bottleneck_kernel<T, HAS_LN1>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<(rows + kRows - 1) / kRows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wd), static_cast<const T*>(bd),
      static_cast<const T*>(wu), static_cast<const T*>(bu), static_cast<const T*>(ln1s),
      static_cast<const T*>(ln1b), static_cast<const T*>(ln2s), static_cast<const T*>(ln2b),
      static_cast<T*>(out), rows, C, G, go);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dgsct

// x, out: (rows, C); wd: (G, C/G, go); bd: (G*go); wu: (G, go, C/G); bu, ln*: (C).
// ln1s / ln1b are read only when has_ln1.
extern "C" int k3_adapter_bottleneck(const void* x, const void* wd, const void* bd,
                                     const void* wu, const void* bu, const void* ln1s,
                                     const void* ln1b, const void* ln2s, const void* ln2b,
                                     void* out, int rows, int C, int G, int go, int has_ln1,
                                     int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dgsct::kF32)
    return has_ln1 ? dgsct::launch<float, true>(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b,
                                                out, rows, C, G, go, s)
                   : dgsct::launch<float, false>(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b,
                                                 out, rows, C, G, go, s);
  if (dtype == dgsct::kBF16)
    return has_ln1 ? dgsct::launch<__nv_bfloat16, true>(x, wd, bd, wu, bu, ln1s, ln1b, ln2s,
                                                        ln2b, out, rows, C, G, go, s)
                   : dgsct::launch<__nv_bfloat16, false>(x, wd, bd, wu, bu, ln1s, ln1b, ln2s,
                                                         ln2b, out, rows, C, G, go, s);
  return cudaErrorInvalidValue;
}
