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
// no padding copy.
//   bfloat16 (the served type): the two grouped products run on bf16
//   mma.sync (m16n8k16, float32 sums). The x tile and the per-channel
//   vectors arrive by one cp.async group, so a tile waits for device memory
//   once; z is made in place as bf16 over the first half of the o tile. The
//   LN phases give each warp two rows at once (two independent chains), or
//   16 lanes a row where a row's 8-column chunks fill 16 lanes better, with
//   one-pass float32 statistics. The warps split the 8-column output tiles
//   of both groups and share the A fragments (ldmatrix). Wd and Wu (288 KB
//   each at C = 1536) stream through two shared-memory slabs of at most
//   32 KB by cp.async, the next slab in flight while one is used, the first
//   two issued with x; B fragments are two 16-bit loads each, since rows of
//   go = 3, 6 or 12 weights are not 16-byte aligned. go is padded to 8
//   (down) and 16 (up) columns of zeros; where C/G is an odd multiple of 8,
//   a group's last k-step is padded with zero weights.
//   float32: one warp per row takes LN_before and LN_post; each thread owns
//   one output column of each product, reads that column's weights from L2
//   once per tile and applies them to the 16 rows in registers (scalar FMA);
//   z, then o, in a float32 tile.
#include <algorithm>

#include "tensor_core.cuh"

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

// ================================ bfloat16: mma.sync =================================

using bf16 = __nv_bfloat16;

constexpr int kMaxUnits = 4;            // 8-column down tiles a warp keeps: G * go <= 256
// Cap on one weight slab in shared memory: 32 KB lets two blocks share an SM
// at C = 768.
constexpr int kStageBytes = 32 * 1024;
static_assert(kRows == 2 * kWarps, "each warp takes two rows in the LN phases");

// Shared-memory geometry and weight slabs of one (C, G, go), all in elements.
struct MmaPlan {
  int C, G, gi, go;
  int gok;   // go padded to the up product's k-step (16)
  int hst;   // row stride of h (bf16)
  int ost;   // row stride of o (float32) and of z (bf16) over it
  int kr;    // rows of the flattened (C, go) Wd in one down slab: a multiple of 16,
             // and of whole groups where C / G is not
  int nd;    // down slabs
  int nc;    // columns of each group's Wu in one up slab, a multiple of 8
  int nu;    // up slabs
  int wbuf;  // one weight slab buffer
  int nvec;  // bu, ln2s, ln2b, ln1s, ln1b (C each), then bd (G * go, padded to 8)
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The strides are 4 words mod 32 (z), 8 mod 32 (o; an up slab row) or spread
// over 8 rows (h), so that ldmatrix rows, fragment stores and the B loads of
// the up product hit distinct banks. Slabs are split evenly under the cap.
MmaPlan make_plan(int C, int G, int go) {
  MmaPlan p{};
  p.C = C, p.G = G, p.gi = C / G, p.go = go;
  p.gok = (go + 15) / 16 * 16;
  p.hst = p.gok + 8;
  p.ost = C + 8;
  // fewest slabs under the cap, then the k-step units split evenly between
  // them; a group with gi = 8 (mod 16) starts its k-steps off the 16-grid, so
  // its slab boundaries fall on pairs of groups
  const int unit = p.gi % 16 ? 2 * p.gi : 16;
  const int nunits = ceil_div(C, unit), max_u = std::max(1, kStageBytes / (2 * unit * go));
  const int us = ceil_div(nunits, ceil_div(nunits, max_u));
  p.kr = unit * us;
  p.nd = ceil_div(C, p.kr);
  const int tiles = p.gi / 8, max_t = std::max(1, (kStageBytes / (2 * G * go) - 8) / 8);
  const int nt = ceil_div(tiles, ceil_div(tiles, max_t));
  p.nc = 8 * nt;
  p.nu = ceil_div(tiles, nt);
  p.wbuf = std::max(p.kr * go, G * go * (p.nc + 8));
  p.nvec = 5 * C + (G * go + 7) / 8 * 8;
  return p;
}

size_t mma_smem_bytes(const MmaPlan& p) {
  return sizeof(float) * kRows * p.ost +
         sizeof(bf16) * (p.G * kRows * p.hst + 2 * p.wbuf + p.nvec);
}

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                                            pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// f(r, c) for the cells i = tid, tid + kThreads, ... of a rows x cols grid,
// stepping (r, c) without a division per cell.
template <typename F>
__device__ __forceinline__ void for_cells(int rows, int cols, int tid, F&& f) {
  int r = tid / cols, c = tid - r * cols;
  const int dr = kThreads / cols, dc = kThreads - dr * cols;
  while (r < rows) {
    f(r, c);
    r += dr, c += dc;
    if (c >= cols) c -= cols, ++r;
  }
}

__device__ __forceinline__ float sum8(const float (&f)[8]) {
  return ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
}

// LN over the 16-row tile: W = 32 lanes per row, each lane on two rows (warp
// and warp + kWarps: two independent chains), or W = 16 lanes per row, each
// half-warp on one of them. Lane l takes columns 8 (l % W) + 8 W i.
// Statistics in float32, as the TPU kernel.
template <int W> struct LnRows {
  static constexpr int NR = W / 16;  // rows a lane serves
  int r[NR];                         // tile rows
  int c0;                            // first column

  __device__ __forceinline__ explicit LnRows(int warp, int lane) {
    if (W == 32) {
      r[0] = warp, r[NR - 1] = warp + kWarps;
    } else {
      r[0] = warp + kWarps * (lane >> 4);
    }
    c0 = 8 * (lane % W);
  }

  // mean and 1 / std of each served row of a (kRows x ld) tile, in one pass:
  // sums of d and d^2 for d = x - x[0] (the shift keeps the variance free of
  // cancellation when the mean is large against the spread)
  template <typename E>
  __device__ __forceinline__ void stats(const E* t, int ld, int C, float (&m)[NR],
                                        float (&rs)[NR]) const {
    float k[NR], s1[NR] = {}, s2[NR] = {};
#pragma unroll
    for (int i = 0; i < NR; ++i) k[i] = to_f(t[r[i] * ld]);
    for (int c = c0; c < C; c += 8 * W) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        float f[8];
        load8(t + r[i] * ld + c, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = f[j] - k[i];
          s1[i] += d;
          s2[i] = fmaf(d, d, s2[i]);
        }
      }
    }
    reduce(s1);
    reduce(s2);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float d = s1[i] / C;
      m[i] = k[i] + d;
      rs[i] = rsqrtf(fmaxf(s2[i] / C - d * d, 0.f) + 1e-5f);
    }
  }

  __device__ __forceinline__ static void reduce(float (&s)[NR]) {
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < NR; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
    }
  }
};

// z = LN_before(x) in place (bf16), or out = LN_post(o) (o float32 in the tile).
template <int W, typename E>
__device__ __forceinline__ void ln_tile(const E* t, int ld, int C, const bf16* sc,
                                        const bf16* sh, bf16* dst, int dst_ld, int row0,
                                        int rows, int warp, int lane) {
  const LnRows<W> lr(warp, lane);
  constexpr int NR = LnRows<W>::NR;
  float m[NR], rs[NR];
  lr.stats(t, ld, C, m, rs);
  for (int c = lr.c0; c < C; c += 8 * W) {
    float g[8], b[8];
    load8(sc + c, g);
    load8(sh + c, b);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float f[8];
      load8(t + lr.r[i] * ld + c, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = (f[j] - m[i]) * rs[i] * g[j] + b[j];
      if (row0 + lr.r[i] < rows) store8(dst + static_cast<size_t>(lr.r[i]) * dst_ld + c, f);
    }
  }
}

// UNITS: the down tiles a warp keeps (1, 2 or 4); fewer registers let more
// blocks share an SM at small C, where the tile's latency is the cost.
template <bool HAS_LN1, int UNITS>
__global__ void __launch_bounds__(kThreads, UNITS == 1 ? 4 : 2)
bottleneck_kernel_mma(const bf16* __restrict__ x, const bf16* __restrict__ wd,
                      const bf16* __restrict__ bd, const bf16* __restrict__ wu,
                      const bf16* __restrict__ bu, const bf16* __restrict__ ln1s,
                      const bf16* __restrict__ ln1b, const bf16* __restrict__ ln2s,
                      const bf16* __restrict__ ln2b, bf16* __restrict__ out, int rows,
                      const MmaPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* os = reinterpret_cast<float*>(smem_raw);              // kRows x ost: o
  bf16* zs = reinterpret_cast<bf16*>(smem_raw);                // kRows x ost: x, z, over o
  bf16* hs = reinterpret_cast<bf16*>(os + kRows * p.ost);      // G x kRows x hst: h
  bf16* wbuf = hs + p.G * kRows * p.hst;                       // 2 x wbuf: weight slabs
  bf16* vs = wbuf + 2 * p.wbuf;                                // nvec: vectors
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  const int row0 = blockIdx.x * kRows;
  const int C = p.C, gi = p.gi, go = p.go, slabs = p.nd + p.nu;
  const bf16 zero = __ushort_as_bfloat16(0);
  const bf16 bias_d = tid < p.G * go ? bd[tid] : zero;  // G * go <= kThreads

  // ---- one cp.async group: the x tile (masked rows and the 8 pad columns a
  // group's last k-step may read as zeros) and the vectors ----------------------------
  const int cpr = C / 8;  // 16-byte chunks of a row
  for_cells(kRows, cpr + 1, tid, [&](int r, int c) {
    const bool ok = row0 + r < rows && c < cpr;
    cp_async16(zs + r * p.ost + 8 * c, x + (ok ? static_cast<size_t>(row0 + r) * C : 0) + 8 * c,
               ok);
  });
  for_cells(HAS_LN1 ? 5 : 3, cpr, tid, [&](int v, int c) {
    const bf16* src = v == 0 ? bu : v == 1 ? ln2s : v == 2 ? ln2b : v == 3 ? ln1s : ln1b;
    cp_async16(vs + v * C + 8 * c, src + 8 * c);
  });
  cp_async_commit();

  // Slab s into buffer s % 2: down slabs are row runs of the flattened Wd,
  // contiguous; up slabs are one column chunk of every row of the flattened
  // (G * go, gi) Wu, at a row stride of nc + 8.
  auto issue = [&](int s) {
    if (s < slabs) {
      bf16* dst = wbuf + (s & 1) * p.wbuf;
      if (s < p.nd) {
        const int r0 = s * p.kr, n = min(p.kr, C - r0) * go;  // r0 % 16 = C % 8 = 0
        const bf16* src = wd + static_cast<size_t>(r0) * go;
        for (int i = tid; i < n / 8; i += kThreads) cp_async16(dst + 8 * i, src + 8 * i);
      } else {
        const int n0 = (s - p.nd) * p.nc;
        for_cells(p.G * go, min(p.nc, gi - n0) / 8, tid, [&](int r, int c) {
          cp_async16(dst + r * (p.nc + 8) + 8 * c,
                     wu + static_cast<size_t>(r) * gi + n0 + 8 * c);
        });
      }
    }
    cp_async_commit();  // an empty group past the last slab keeps the count
  };
  issue(0);
  issue(1);

  // h's pad columns (go..gok) must read as zeros in the up product.
  for (int i = tid; i < p.G * kRows * p.hst / 2; i += kThreads)
    reinterpret_cast<uint32_t*>(hs)[i] = 0u;
  bf16* vbd = vs + 5 * C;
  if (tid < p.G * go) vbd[tid] = bias_d;

  // 16 lanes a row where a row's 8-column chunks fill 16 lanes better than 32
  const bool half_warp_rows = C <= 128 || C % 256 == 128;

  // ---- z = LN_before(x), rounded to bf16, in place (a masked row's z is
  // discarded with its output) --------------------------------------------------------
  cp_async_wait<2>();  // the x tile and vectors; the two slabs may still fly
  __syncthreads();
  if (HAS_LN1) {
    if (half_warp_rows)
      ln_tile<16>(zs, p.ost, C, vs + 3 * C, vs + 4 * C, zs, p.ost, 0, kRows, warp, lane);
    else
      ln_tile<32>(zs, p.ost, C, vs + 3 * C, vs + 4 * C, zs, p.ost, 0, kRows, warp, lane);
  }

  // Down units: (group, 8-column tile) pairs u = warp + kWarps * i; their
  // sums stay in registers across the down slabs.
  const int ntd = (go + 7) / 8, units = p.G * ntd;
  int ug[UNITS], un[UNITS];  // group (-1: none) and first column
#pragma unroll
  for (int i = 0; i < UNITS; ++i) {
    const int u = warp + kWarps * i;
    ug[i] = u < units ? u / ntd : -1;
    un[i] = 8 * (u - (u / ntd) * ntd);
  }
  float acc[UNITS][4] = {};

  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const bf16* w = wbuf + (s & 1) * p.wbuf;
    if (s < p.nd) {
      // ---- h_g += z_g . Wd[g] over this slab's k-steps (Wd row = z column) --------
      const int r0 = s * p.kr, r1 = min(r0 + p.kr, C);
      for (int g = r0 / gi; g * gi < r1; ++g) {
        bool mine = false;
#pragma unroll
        for (int i = 0; i < UNITS; ++i) mine |= ug[i] == g;
        if (!mine) continue;
        const int hi = min(r1, (g + 1) * gi);
#pragma unroll 4
        for (int zc = max(r0, g * gi); zc < hi; zc += 16) {
          uint32_t a[4];
          ldmatrix_x4(a, zs + (lane & 15) * p.ost + zc + (lane >> 4) * 8);
          const bf16* wk = w + (zc - r0 + 2 * t4) * go + gq;
          const bool full = zc + 16 <= hi;  // else k rows 8..15 lie past the group
#pragma unroll
          for (int i = 0; i < UNITS; ++i) {
            if (ug[i] != g) continue;
            const int n = un[i];
            const bool ok = n + gq < go, ok1 = ok && full;
            const uint32_t b0 = pack_bf16(ok ? wk[n] : zero, ok ? wk[go + n] : zero);
            const uint32_t b1 =
                pack_bf16(ok1 ? wk[8 * go + n] : zero, ok1 ? wk[9 * go + n] : zero);
            mma_bf16(acc[i], a, b0, b1);
          }
        }
      }
    } else {
      if (s == p.nd) {
        // ---- h = ReLU(sums + bd), rounded to bf16 (pad columns stay 0) -----------
#pragma unroll
        for (int i = 0; i < UNITS; ++i) {
          if (ug[i] < 0) continue;
          const int g = ug[i], col = un[i] + 2 * t4;
          const float b0 = col < go ? to_f(vbd[g * go + col]) : 0.f;
          const float b1 = col + 1 < go ? to_f(vbd[g * go + col + 1]) : 0.f;
          bf16* hg = hs + g * kRows * p.hst + col;
          *reinterpret_cast<uint32_t*>(hg + gq * p.hst) =
              pack_bf16(fmaxf(acc[i][0] + b0, 0.f), fmaxf(acc[i][1] + b1, 0.f));
          *reinterpret_cast<uint32_t*>(hg + (gq + 8) * p.hst) =
              pack_bf16(fmaxf(acc[i][2] + b0, 0.f), fmaxf(acc[i][3] + b1, 0.f));
        }
        __syncthreads();
      }
      // ---- o_g = h_g . Wu[g] + bu over this slab's columns, written over z; a warp
      // takes units u and u + kWarps of the slab's (group, 8-column tile) pairs
      // together, two independent chains ------------------------------------------
      const int n0 = (s - p.nd) * p.nc, nt = min(p.nc, gi - n0) / 8, nu = p.G * nt;
      const int wst = p.nc + 8;
      for (int u = warp; u < nu; u += 2 * kWarps) {
        const bf16* av[2];  // this lane's ldmatrix row of h_g
        const bf16* bv[2];  // this lane's first B element in the slab
        int col[2];         // this lane's first output column
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          int g = 0, j = min(u + v * kWarps, nu - 1);
          while (j >= nt) j -= nt, ++g;
          av[v] = hs + (g * kRows + (lane & 15)) * p.hst + (lane >> 4) * 8;
          bv[v] = w + (g * go + 2 * t4) * wst + 8 * j + gq;
          col[v] = g * gi + n0 + 8 * j + 2 * t4;
        }
        const bool two = u + kWarps < nu;
        float c[2][4] = {};
        for (int k0 = 0; k0 < p.gok; k0 += 16) {
          const int k = k0 + 2 * t4;
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            if (v == 1 && !two) continue;
            uint32_t a[4];
            ldmatrix_x4(a, av[v] + k0);
            const bf16* wk = bv[v] + k0 * wst;
            const uint32_t b0 = pack_bf16(k < go ? wk[0] : zero, k + 1 < go ? wk[wst] : zero);
            const uint32_t b1 =
                pack_bf16(k + 8 < go ? wk[8 * wst] : zero, k + 9 < go ? wk[9 * wst] : zero);
            mma_bf16(c[v], a, b0, b1);
          }
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          if (v == 1 && !two) continue;
          const float2 b = load2(vs + col[v]);
          store2(os + gq * p.ost + col[v], c[v][0] + b.x, c[v][1] + b.y);
          store2(os + (gq + 8) * p.ost + col[v], c[v][2] + b.x, c[v][3] + b.y);
        }
      }
    }
    __syncthreads();
    issue(s + 2);
  }

  // ---- out = LN_post(o) -------------------------------------------------------------
  bf16* dst = out + static_cast<size_t>(row0) * C;
  if (half_warp_rows)
    ln_tile<16>(os, p.ost, C, vs + C, vs + 2 * C, dst, C, row0, rows, warp, lane);
  else
    ln_tile<32>(os, p.ost, C, vs + C, vs + 2 * C, dst, C, row0, rows, warp, lane);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool HAS_LN1, int UNITS>
int launch_mma(const void* x, const void* wd, const void* bd, const void* wu, const void* bu,
               const void* ln1s, const void* ln1b, const void* ln2s, const void* ln2b,
               void* out, int rows, const MmaPlan& plan, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(plan);
  auto kern = bottleneck_kernel_mma<HAS_LN1, UNITS>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<(rows + kRows - 1) / kRows, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wd), static_cast<const bf16*>(bd),
      static_cast<const bf16*>(wu), static_cast<const bf16*>(bu),
      static_cast<const bf16*>(ln1s), static_cast<const bf16*>(ln1b),
      static_cast<const bf16*>(ln2s), static_cast<const bf16*>(ln2b), static_cast<bf16*>(out),
      rows, plan);
  return cudaGetLastError();
}

template <bool HAS_LN1>
int launch_mma(const void* x, const void* wd, const void* bd, const void* wu, const void* bu,
               const void* ln1s, const void* ln1b, const void* ln2s, const void* ln2b,
               void* out, int rows, int C, int G, int go, cudaStream_t stream) {
  // gi a multiple of 8: 16-byte rows of x, z and the Wu slabs, 8-column tiles
  const int units = G * ((go + 7) / 8);
  if (G < 1 || go < 1 || C % G || (C / G) % 8 || units > kWarps * kMaxUnits)
    return cudaErrorInvalidValue;
  for (const void* q : {x, wd, wu, bu, ln1s, ln1b, ln2s, ln2b, static_cast<const void*>(out)})
    if (!aligned16(q)) return cudaErrorMisalignedAddress;
  const MmaPlan plan = make_plan(C, G, go);
  if (units <= kWarps)
    return launch_mma<HAS_LN1, 1>(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, out, rows, plan,
                                  stream);
  if (units <= 2 * kWarps)
    return launch_mma<HAS_LN1, 2>(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, out, rows, plan,
                                  stream);
  return launch_mma<HAS_LN1, kMaxUnits>(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, out, rows,
                                        plan, stream);
}

}  // namespace
}  // namespace dgsct

// x, out: (rows, C); wd: (G, C/G, go); bd: (G*go); wu: (G, go, C/G); bu, ln*: (C).
// ln1s / ln1b are read only when has_ln1. bfloat16 needs C/G a multiple of 8,
// G * ceil(go / 8) <= 32 and 16-byte aligned x, out, wd, wu, bu and ln*
// (cudaErrorInvalidValue, cudaErrorMisalignedAddress otherwise).
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
    return has_ln1 ? dgsct::launch_mma<true>(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, out,
                                             rows, C, G, go, s)
                   : dgsct::launch_mma<false>(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, out,
                                              rows, C, G, go, s);
  return cudaErrorInvalidValue;
}
