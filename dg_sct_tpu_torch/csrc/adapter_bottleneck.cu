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
// What holds a tile back in practice is each tile reading all of Wd and Wu
// (590 KB each in float32 at C = 1536) and the latency of its serial phases.
//
// Design: the ragged last tile is masked, with no padding copy.
//   bfloat16 (the served type): one block per tile of 16 rows; the two
//   grouped products run on bf16 mma.sync (m16n8k16, float32 sums). The x tile and the per-channel
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
//   float32: both products on the TF32 tensor cores at float32 accuracy
//   (3xTF32 mma.sync m16n8k8: each operand split into TF32 halves, the
//   small x small product dropped, as K1 and K2 in float32). Nothing is
//   rounded between the steps. Tiles of 16, 32 or 64 rows (m-tiles sharing
//   each weight fragment, split once); where rows are few,
//   a cluster of two CTAs a tile, each on half the groups, the rows'
//   LayerNorm sums added through distributed shared memory. Every warp
//   streams the weight rows of its own output tiles through its own ring of
//   cp.async chunks and waits only on them; the down product is split by k
//   between warps where its partial sums fit over z (Tf32Plan).
#include <cooperative_groups.h>

#include <algorithm>

#include "tensor_core.cuh"

namespace dgsct {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;

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

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

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

// ============================== float32: 3xTF32 mma.sync ==============================

// Shared-memory geometry of one (C, G, go) on CL CTAs a tile of 16 M rows (a
// thread-block cluster when CL = 2: each CTA takes G / CL groups), in floats.
// Every row stride puts the fragment loads of a warp on distinct banks.
//
// The products' work, every warp on its own. Down product: wpg warps a
// group, kss k slices by wpg / kss parts of its gok / 8 output tiles (tpw
// tiles a warp); the slices' partial sums meet in shared memory over z once
// z is read (kss = 1: each warp holds its tiles' sums over all k rows, at
// most 12 / M tiles a pass). Up product: items of uw columns of one group,
// warp w taking items w, w + 8, ... A warp streams the weight rows its
// tiles need, chunks of kc k-steps (8 kc rows) by its columns, through its own
// ring of kF32Depth slots by cp.async, and waits on nothing but its own
// copies.
struct Tf32Plan {
  int C, gi, go;
  int gl;     // groups a CTA takes (G / CL)
  int cl;     // channels a CTA takes (gl * gi)
  int gik;    // gi padded to the k-step (8)
  int gok;    // go padded to the k-step (8): h's columns, the up product's k
  int ost;    // row stride of the x / z / o tile (4 mod 8, past the last k-step's reads)
  int hst;    // row stride of h (4 mod 8)
  int nvec;   // ln1s, ln1b, ln2s, ln2b, bu (cl each), bd (gl x gok), padded to 4
  int wpg;    // warps a group in the down product (8 / gl, or 1 when gl is more)
  int kss;    // k slices of a group's down product (a divisor of wpg)
  int tpw;    // down tiles a warp (its group's gok / 8 over wpg / kss warps)
  int dw;     // a down pass's columns: 8 x a tile count (kTileCounts) for tpw, at most
              // 12 / M tiles, narrowed to fit a slot
  int kcd;    // k-steps of a down chunk
  int uw;     // columns of an up item: 8 x a tile count, at most 12 / M tiles
  int nper;   // up items a group (ceil(gi / uw))
  int kcu;    // k-steps of an up chunk
  int slot;   // floats of a ring slot
  int has_ln1;     // LN_before
  int vx, vd, vu;  // 16-byte copies of x and the vectors / Wd / Wu rows; float4 LN phases
};

constexpr int kF32Depth = 4;      // slots of a warp's ring: three chunks in flight
constexpr int kSerialSteps = 16;  // k-steps a down tile may take without a k split

int round_up(int a, int b) { return ceil_div(a, b) * b; }

// The tile counts a chunk's products are compiled for (`with_tiles`; 12 / M is
// one of them): n rounded up to one of them, at most nt_max; and the largest
// one below n.
constexpr int kTileCounts[] = {1, 2, 3, 6, 12};
int tile_count(int n, int nt_max) {
  for (const int t : kTileCounts)
    if (t >= n) return std::min(t, nt_max);
  return nt_max;
}
int tile_count_below(int n) {
  int best = 1;
  for (const int t : kTileCounts)
    if (t < n) best = t;
  return best;
}

// 8 or 24 mod 32: a B fragment's 4 k rows and 8 columns fall on 32 banks
__host__ __device__ __forceinline__ int spread_stride(int n) {
  return n % 32 == 8 || n % 32 == 24 ? n : n + 8;
}

size_t tf32_smem_bytes(const Tf32Plan& p, int m) {
  return sizeof(float) * (static_cast<size_t>(16 * m) * (p.ost + 2 * p.gl * p.hst + 2) + p.nvec +
                          static_cast<size_t>(kWarps) * kF32Depth * p.slot);
}

// The plan for M m-tiles with ring slots of `slot` floats, the down product
// in as many k slices as keep a warp's tiles within 12 / M, the slices'
// partial sums within z's rows and a chunk within a slot; false if it does
// not fit in `budget` bytes or a slot holds no chunk.
bool make_tf32_plan(int C, int G, int go, int cl_ctas, int m, int slot, size_t budget,
                    Tf32Plan& p) {
  p = Tf32Plan{};
  const int nt_max = 12 / m;  // 8-column tiles a warp keeps
  p.C = C, p.gi = C / G, p.go = go;
  p.gl = G / cl_ctas, p.cl = p.gl * p.gi;
  p.gik = round_up(p.gi, 8), p.gok = round_up(go, 8);
  p.ost = round_up(p.cl + p.gik - p.gi, 8) + 4;
  p.hst = p.gok + 4;
  p.nvec = round_up(5 * p.cl + p.gl * p.gok, 4);
  p.slot = slot;
  p.wpg = p.gl <= kWarps ? kWarps / p.gl : 1;
  const int ntd = p.gok / 8;
  // split k only where a warp would run more than kSerialSteps k-steps alone:
  // below that the partial sums' two barriers cost more than they save
  for (p.kss = p.gik / 8 > kSerialSteps ? p.wpg : 1; p.kss > 1; --p.kss) {
    const int tpw = ceil_div(ntd, p.wpg / p.kss);
    if (p.wpg % p.kss == 0 && tpw <= nt_max && p.kss * p.gl * p.gok <= p.ost &&
        8 * spread_stride(8 * tile_count(tpw, nt_max)) <= slot)
      break;
  }
  p.tpw = ceil_div(ntd, p.wpg / p.kss);
  p.dw = 8 * tile_count(p.tpw, nt_max);  // a pass's tiles
  while (p.dw > 8 && 8 * spread_stride(p.dw) > slot) p.dw = 8 * tile_count_below(p.dw / 8);
  p.kcd = std::min(p.gik / 8, slot / (8 * spread_stride(p.dw)));
  // up items: the local columns over the warps, at most nt_max tiles each
  p.uw = 8 * tile_count(std::min(ceil_div(p.cl, 8 * kWarps), p.gik / 8), nt_max);
  while (p.uw > 8 && 8 * spread_stride(p.uw) > slot) p.uw = 8 * tile_count_below(p.uw / 8);
  p.nper = ceil_div(p.gi, p.uw);
  p.kcu = std::min(p.gok / 8, slot / (8 * spread_stride(p.uw)));
  return p.kcd >= 1 && p.kcu >= 1 && tf32_smem_bytes(p, m) <= budget;
}

// W = 4: float4 columns (vx), else 1.
template <int W> __device__ __forceinline__ void loadw(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = *p;
  }
}
template <int W> __device__ __forceinline__ void storew(float* p, const float (&v)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// Each lane's M rows' sums over their 16 lanes, then, with CL = 2, plus the
// peer CTA's sums of the same rows through distributed shared memory (`part`,
// one slot a row; both CTAs add the same two numbers, so they agree bit for
// bit).
template <int CL, int M>
__device__ __forceinline__ void row_sums(float (&s)[M], float* part, int r0, int lane) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
  if constexpr (CL == 2) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    if ((lane & 15) == 0)
#pragma unroll
      for (int i = 0; i < M; ++i) part[r0 + 16 * i] = s[i];
    cluster.sync();
    const float* peer = cluster.map_shared_rank(part, cluster.block_rank() ^ 1);
#pragma unroll
    for (int i = 0; i < M; ++i) s[i] += peer[r0 + 16 * i];
  }
}

// LayerNorm of each row of the tile's cl columns over all C channels, float32
// and two passes (the mean, then the mean square of the deviations), as the
// TPU kernel and the plain version. 16 lanes a row (rows r0 + 16 i), W
// columns a lane at a time; sc, sh in shared memory. dst: the tile itself (LN_before,
// in place) or the output rows.
template <int CL, int M, int W>
__device__ __forceinline__ void ln_rows(float* t, const Tf32Plan& p, const float* sc,
                                        const float* sh, float* dst, size_t dst_ld, int row0,
                                        int rows, float* part, int warp, int lane) {
  const int r0 = 2 * warp + (lane >> 4), c0 = W * (lane & 15);
  float s[M], m[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    s[i] = 0.f;
#pragma unroll 4
    for (int c = c0; c < p.cl; c += 16 * W) {
      float v[W];
      loadw<W>(t + (r0 + 16 * i) * p.ost + c, v);
#pragma unroll
      for (int e = 0; e < W; ++e) s[i] += v[e];
    }
  }
  row_sums<CL, M>(s, part, r0, lane);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    m[i] = s[i] / p.C;
    s[i] = 0.f;
#pragma unroll 4
    for (int c = c0; c < p.cl; c += 16 * W) {
      float v[W];
      loadw<W>(t + (r0 + 16 * i) * p.ost + c, v);
#pragma unroll
      for (int e = 0; e < W; ++e) s[i] = fmaf(v[e] - m[i], v[e] - m[i], s[i]);
    }
  }
  row_sums<CL, M>(s, part + 16 * M, r0, lane);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float rs = rsqrtf(s[i] / p.C + 1e-5f);
    const int r = r0 + 16 * i;
    if (row0 + r >= rows) continue;
#pragma unroll 4
    for (int c = c0; c < p.cl; c += 16 * W) {
      float v[W], g[W], b[W];
      loadw<W>(t + r * p.ost + c, v);
      loadw<W>(sc + c, g);
      loadw<W>(sh + c, b);
#pragma unroll
      for (int e = 0; e < W; ++e) v[e] = (v[e] - m[i]) * rs * g[e] + b[e];
      storew<W>(dst + r * dst_ld + c, v);
    }
  }
}

// x = big + small, each rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32) by integer operations: the conversion instruction runs on
// a quarter-rate pipe, and the products split two weights for three mma.sync.
// NaN stays NaN in small; only |x| within 2^-11 of FLT_MAX turns to inf.
__device__ __forceinline__ void split_tf32_int(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

template <int R> __device__ __forceinline__ SplitFrag<R> split_frag(const float (&v)[R]) {
  SplitFrag<R> f;
#pragma unroll
  for (int i = 0; i < R; ++i) split_tf32_int(v[i], f.big[i], f.small[i]);
  return f;
}

// A (16 x 8) fragment of a float32 tile (row stride ld) at its row 0 and
// k-column 0, split; or of a tile stored split (h), as it is.
__device__ __forceinline__ SplitFrag<4> a_frag(const float* t, int ld, int gq, int t4) {
  const float* a = t + gq * ld + t4;
  const float v[4] = {a[0], a[8 * ld], a[4], a[8 * ld + 4]};
  return split_frag(v);
}
__device__ __forceinline__ SplitFrag<4> a_frag(const uint32_t* big, const uint32_t* small, int ld,
                                               int gq, int t4) {
  SplitFrag<4> a;
  const int o = gq * ld + t4;
  a.big[0] = big[o], a.big[1] = big[o + 8 * ld], a.big[2] = big[o + 4], a.big[3] = big[o + 8 * ld + 4];
  a.small[0] = small[o], a.small[1] = small[o + 8 * ld], a.small[2] = small[o + 4];
  a.small[3] = small[o + 8 * ld + 4];
  return a;
}

// B (8 x 8) fragment of a float32 chunk (row stride ld) at its k row 0 and
// column 0, split: each weight is read by one warp once a tile and split there,
// once, for the tile's M m-tiles.
__device__ __forceinline__ SplitFrag<2> b_frag(const float* b, int ld, int gq, int t4) {
  const float v[2] = {b[t4 * ld + gq], b[(t4 + 4) * ld + gq]};
  return split_frag(v);
}

// A lane's cells of a warp's chunk copies: 16 bytes (or 4) a cell, `cells` a
// row; lane l takes cells l, l + 32, ... as (row, column) stepped without a
// division.
struct ChunkLanes {
  int r, c, dr, dc, cells, e;
  __device__ __forceinline__ ChunkLanes(int w, bool vec, int lane) {
    e = vec ? 4 : 1, cells = w / e;
    r = lane / cells, c = lane - r * cells, dr = 32 / cells, dc = 32 - dr * cells;
  }
};

// 8 kc rows x w columns of a row-major weight (row stride ldb) into a ring slot
// (row stride spread_stride(w)) by the warp's lanes; zeros past `nrows` rows and
// `ncols` columns.
__device__ __forceinline__ void copy_chunk(float* dst, const float* src, size_t ldb, int kc,
                                           int w, int nrows, int ncols, bool vec,
                                           const ChunkLanes& l) {
  const int ws = spread_stride(w);
  for (int r = l.r, c = l.c; r < 8 * kc;) {
    const bool ok = r < nrows && l.e * c < ncols;
    const float* s = src + (ok ? r * ldb + l.e * c : 0);
    if (vec)
      cp_async16(dst + r * ws + 4 * c, s, ok);
    else
      cp_async4(dst + r * ws + c, s, ok);
    r += l.dr, c += l.dc;
    if (c >= l.cells) c -= l.cells, ++r;
  }
}

template <int N> struct Tiles {
  static constexpr int value = N;
};

// f(Tiles<n>()) for n one of kTileCounts up to NT (make_tf32_plan's widths).
template <int NT, typename F> __device__ __forceinline__ void with_tiles(int n, F&& f) {
  if (n == 1) f(Tiles<1>());
  else if (n == 2) f(Tiles<2>());
  else if (n == 3) f(Tiles<3>());
  if constexpr (NT >= 6) {
    if (n == 6) f(Tiles<6>());
  }
  if constexpr (NT >= 12) {
    if (n == 12) f(Tiles<12>());
  }
}

template <int CL, int M>
__global__ void __launch_bounds__(kThreads, 2)
bottleneck_kernel_tf32(const float* __restrict__ x, const float* __restrict__ wd,
                       const float* __restrict__ bd, const float* __restrict__ wu,
                       const float* __restrict__ bu, const float* __restrict__ ln1s,
                       const float* __restrict__ ln1b, const float* __restrict__ ln2s,
                       const float* __restrict__ ln2b, float* __restrict__ out, int rows,
                       const Tf32Plan p) {
  constexpr int R = 16 * M, NT = 12 / M, D = kF32Depth;
  extern __shared__ __align__(16) float smf[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;  // fragment row and column
  float* ts = smf;                                                   // R x ost: x, z, o
  uint32_t* hb = reinterpret_cast<uint32_t*>(ts + R * p.ost);        // gl x R x hst: h, big
  uint32_t* hsm = hb + p.gl * R * p.hst;                             // h, small
  float* part = reinterpret_cast<float*>(hsm + p.gl * R * p.hst);    // 2 x R: peer's sums
  float* vec = part + 2 * R;  // ln1s, ln1b, ln2s, ln2b, bu (cl each), bd (gl x gok)
  float* ring = vec + p.nvec + warp * D * p.slot;                    // this warp's ring
  int rank = 0;
  if constexpr (CL == 2) rank = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  const int row0 = (blockIdx.x / CL) * R;
  const int C = p.C, gi = p.gi, go = p.go, cl = p.cl, c0 = rank * cl, g0 = rank * p.gl;
  const int ntd = p.gok / 8, spg = p.gik / 8;

  // ---- this warp's chunks: down ones, then up ones ------------------------------------
  // down: groups dg (+ 8 a when gl is more than 8); k-steps [dk0, dk1)
  // (k slice ds of kss) of tiles [dt0, dt1), in passes of dw / 8 tiles (one when kss > 1)
  const bool dgrp = p.gl <= kWarps;
  const int dg = dgrp ? warp / p.wpg : warp, dj = dgrp ? warp % p.wpg : 0, ds = dj % p.kss;
  const int kper = ceil_div(spg, p.kss);
  const int dk0 = min(ds * kper, spg), dk1 = min(dk0 + kper, spg);
  const int dt0 = min(dj / p.kss * p.tpw, ntd), dt1 = min(dt0 + p.tpw, ntd);
  const int dgroups = dg < p.gl ? (dgrp ? 1 : ceil_div(p.gl - warp, kWarps)) : 0;
  const int dpasses = ceil_div(dt1 - dt0, p.dw / 8), dchunks = ceil_div(dk1 - dk0, p.kcd);
  const int nqd = dt1 > dt0 && dk1 > dk0 ? dgroups * dpasses * dchunks : 0;
  // up: items warp + 8 a, each its group's k rows in chunks
  const int uitems = p.gl * p.nper, uchunks = ceil_div(ntd, p.kcu);
  const int nqu = warp < uitems ? ceil_div(uitems - warp, kWarps) * uchunks : 0;

  // A warp's chunks in order, its down segments (a pass over a group's k-steps)
  // then its up items, stepped by a cursor: a division only where a segment begins.
  const int dsegs = nqd > 0 ? dgroups * dpasses : 0;
  const int nsegs = dsegs + (warp < uitems ? ceil_div(uitems - warp, kWarps) : 0);
  struct Chunk {
    int g, k0, kc, t0, nt;  // group, first k-step, k-steps; first tile, tiles
    bool last;              // the last chunk of its pass or item
  };
  struct Cursor {
    int q, seg, kk, nk, step, kend;  // chunk, segment, its chunk and chunks, k-steps a chunk
    Chunk c;
  };
  auto begin = [&](Cursor& u) {  // u.seg's first chunk
    u.kk = 0;
    if (u.seg < dsegs) {
      const int a = u.seg / dpasses;
      u.c.g = dgrp ? dg : warp + kWarps * a;
      u.c.t0 = dt0 + p.dw / 8 * (u.seg - a * dpasses), u.c.nt = min(p.dw / 8, dt1 - u.c.t0);
      u.c.k0 = dk0, u.step = p.kcd, u.kend = dk1, u.nk = dchunks;
    } else if (u.seg < nsegs) {
      const int it = warp + kWarps * (u.seg - dsegs);
      u.c.g = it / p.nper;
      u.c.t0 = (it - u.c.g * p.nper) * p.uw / 8, u.c.nt = min(p.uw / 8, spg - u.c.t0);
      u.c.k0 = 0, u.step = p.kcu, u.kend = ntd, u.nk = uchunks;
    }
    u.c.kc = min(u.step, u.kend - u.c.k0), u.c.last = u.nk == 1;
  };
  auto next = [&](Cursor& u) {
    ++u.q;
    if (++u.kk < u.nk) {
      u.c.k0 += u.step;
      u.c.kc = min(u.step, u.kend - u.c.k0), u.c.last = u.kk == u.nk - 1;
    } else {
      ++u.seg;
      begin(u);
    }
  };
  Cursor ic{0, 0}, cc{0, 0};  // the chunk to issue next, and to compute next
  begin(ic), begin(cc);
  const ChunkLanes dl(p.dw, p.vd, lane), ul(p.uw, p.vu, lane);
  auto issue = [&]() {  // ic's chunk, then ic steps on
    if (ic.seg < nsegs) {
      float* dst = ring + (ic.q % D) * p.slot;
      const Chunk& c = ic.c;
      const int k = 8 * c.k0;
      if (ic.seg < dsegs)
        copy_chunk(dst, wd + (static_cast<size_t>(g0 + c.g) * gi + k) * go + 8 * c.t0, go, c.kc,
                   p.dw, gi - k, go - 8 * c.t0, p.vd, dl);
      else
        copy_chunk(dst, wu + (static_cast<size_t>(g0 + c.g) * go + k) * gi + 8 * c.t0, gi, c.kc,
                   p.uw, go - k, gi - 8 * c.t0, p.vu, ul);
      next(ic);
    }
    cp_async_commit();  // an empty group past the last chunk keeps the count
  };

  // ---- the x tile (this CTA's columns; zeros in masked rows and past cl) and the
  // vectors, then each warp's first chunks ------------------------------------------
  const int vw = p.vx ? 4 : 1;
  for_cells(R, p.ost / vw, tid, [&](int r, int c) {
    const bool ok = row0 + r < rows && vw * c < cl;
    const float* src = x + (ok ? static_cast<size_t>(row0 + r) * C + c0 + vw * c : 0);
    if (p.vx)
      cp_async16(ts + r * p.ost + vw * c, src, ok);
    else
      cp_async4(ts + r * p.ost + vw * c, src, ok);
  });
  for_cells(p.has_ln1 ? 5 : 3, cl / vw, tid, [&](int v, int c) {
    const float* src = (v == 0 ? ln2s : v == 1 ? ln2b : v == 2 ? bu : v == 3 ? ln1s : ln1b) + c0;
    float* dst = vec + ((v + 2) % 5) * cl + vw * c;  // ln1s, ln1b, ln2s, ln2b, bu
    if (p.vx)
      cp_async16(dst, src + vw * c);
    else
      cp_async4(dst, src + vw * c);
  });
  for_cells(p.gl, p.gok, tid, [&](int g, int c) {
    cp_async4(vec + 5 * cl + g * p.gok + c, bd + (c < go ? (g0 + g) * go + c : 0), c < go);
  });
  cp_async_commit();
#pragma unroll
  for (int q = 0; q < D - 1; ++q) issue();
  const float* vln1s = vec;
  const float* vln1b = vec + cl;
  const float* vln2s = vec + 2 * cl;
  const float* vln2b = vec + 3 * cl;
  const float* vbu = vec + 4 * cl;
  const float* vbd = vec + 5 * cl;

  // ---- z = LN_before(x), in place (a masked row's z is discarded with its output) --
  cp_async_wait<D - 1>();
  __syncthreads();
  if (p.has_ln1) {
    if (p.vx)
      ln_rows<CL, M, 4>(ts, p, vln1s, vln1b, ts, p.ost, 0, R, part, warp, lane);
    else
      ln_rows<CL, M, 1>(ts, p, vln1s, vln1b, ts, p.ost, 0, R, part, warp, lane);
    __syncthreads();
  }

  float acc[NT][M][4];
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][m][e] = 0.f;
  };
  // chunk cc's products over TN tiles (the chunk's width; tiles past the chunk's
  // own are zeros or another warp's and are not stored): A from `a(kstep, m)`,
  // B from the ring slot (row stride ws). Straight-line code, so that the
  // compiler interleaves the tiles' loads and products.
  auto product = [&](auto tn, const Chunk& c, int ws, auto&& a) {
    constexpr int TN = decltype(tn)::value;
    const float* b = ring + (cc.q % D) * p.slot;
    for (int kk = 0; kk < c.kc; ++kk) {
      SplitFrag<4> af[M];
#pragma unroll
      for (int m = 0; m < M; ++m) af[m] = a(c.k0 + kk, m);
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        const SplitFrag<2> bf = b_frag(b + 8 * kk * ws + 8 * i, ws, gq, t4);
#pragma unroll
        for (int m = 0; m < M; ++m) mma_3xtf32(acc[i][m], af[m], bf);
      }
    }
  };
  // h = ReLU(sum + bd), split into its TF32 halves, at (group g, tile row r, column col)
  auto put_h = [&](int g, int r, int col, float sum) {
    const int o = (g * R + r) * p.hst + col;
    split_tf32_int(fmaxf(sum + vbd[g * p.gok + col], 0.f), hb[o], hsm[o]);
  };

  // ---- h_g = ReLU(z_g . Wd[g] + bd_g), split into TF32 halves (a pad column is 0) --
  zero();
  const int wsd = spread_stride(p.dw), wsu = spread_stride(p.uw);
  with_tiles<NT>(p.dw / 8, [&](auto tn) {
  for (int q = 0; q < nqd; ++q, next(cc)) {
    cp_async_wait<D - 2>();
    __syncwarp();
    issue();
    const Chunk& c = cc.c;
    product(tn, c, wsd, [&](int ks, int m) {
      return a_frag(ts + 16 * m * p.ost + c.g * gi + 8 * ks, p.ost, gq, t4);
    });
    if (c.last && p.kss == 1) {  // the pass's last chunk
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (i >= c.nt) break;
        const int col = 8 * (c.t0 + i) + 2 * t4;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int r = 16 * m + gq;
          put_h(c.g, r, col, acc[i][m][0]), put_h(c.g, r, col + 1, acc[i][m][1]);
          put_h(c.g, r + 8, col, acc[i][m][2]), put_h(c.g, r + 8, col + 1, acc[i][m][3]);
        }
      }
      zero();
    }
  }
  });
  if (p.kss > 1) {
    // the k slices' partial sums over z (every warp is past its last read of z),
    // then h from their sum, slice by slice
    __syncthreads();
    float* ps = ts + (dg * p.kss + ds) * R * p.gok;  // the slice's R x gok partial
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (dt0 + i >= dt1 || dg >= p.gl) break;  // an empty k slice writes zeros
      const int col = 8 * (dt0 + i) + 2 * t4;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float* pr = ps + (16 * m + gq) * p.gok + col;
        pr[0] = acc[i][m][0], pr[1] = acc[i][m][1];
        pr[8 * p.gok] = acc[i][m][2], pr[8 * p.gok + 1] = acc[i][m][3];
      }
    }
    zero();
    __syncthreads();
    for_cells(p.gl * R, p.gok, tid, [&](int gr, int col) {
      const int g = gr / R, r = gr - g * R;
      const float* pr = ts + (g * p.kss * R + r) * p.gok + col;
      float sum = 0.f;
      for (int j = 0; j < p.kss; ++j) sum += pr[j * R * p.gok];
      put_h(g, r, col, sum);
    });
  }
  __syncthreads();  // h complete; z and the partial sums no longer read

  // ---- o_g = h_g . Wu[g] + bu_g over this warp's items, written over z -------------
  with_tiles<NT>(p.uw / 8, [&](auto tn) {
  for (int q = 0; q < nqu; ++q, next(cc)) {
    cp_async_wait<D - 2>();
    __syncwarp();
    issue();
    const Chunk& c = cc.c;
    const int hoff = c.g * R * p.hst;
    product(tn, c, wsu, [&](int ks, int m) {
      const int o = hoff + 16 * m * p.hst + 8 * ks;
      return a_frag(hb + o, hsm + o, p.hst, gq, t4);
    });
    if (c.last) {  // the item's last chunk
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (i >= c.nt) break;
        const int col = 8 * (c.t0 + i) + 2 * t4, oc = c.g * gi + col;  // tile column
        const float b0 = col < gi ? vbu[oc] : 0.f, b1 = col + 1 < gi ? vbu[oc + 1] : 0.f;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          float* orow = ts + (16 * m + gq) * p.ost + oc;
          if (col < gi) orow[0] = acc[i][m][0] + b0, orow[8 * p.ost] = acc[i][m][2] + b0;
          if (col + 1 < gi) orow[1] = acc[i][m][1] + b1, orow[8 * p.ost + 1] = acc[i][m][3] + b1;
        }
      }
      zero();
    }
  }
  });
  cp_async_wait<0>();
  __syncthreads();

  // ---- out = LN_post(o) -------------------------------------------------------------
  float* dst = out + static_cast<size_t>(row0) * C + c0;
  if (p.vx)
    ln_rows<CL, M, 4>(ts, p, vln2s, vln2b, dst, C, row0, rows, part, warp, lane);
  else
    ln_rows<CL, M, 1>(ts, p, vln2s, vln2b, dst, C, row0, rows, part, warp, lane);
  if constexpr (CL == 2) cooperative_groups::this_cluster().sync();  // the peer read `part`
}

template <int CL, int M>
int launch_tf32(const void* x, const void* wd, const void* bd, const void* wu, const void* bu,
                const void* ln1s, const void* ln1b, const void* ln2s, const void* ln2b,
                void* out, int rows, const Tf32Plan& plan, cudaStream_t stream) {
  const size_t smem = tf32_smem_bytes(plan, M);
  auto kern = bottleneck_kernel_tf32<CL, M>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ceil_div(rows, 16 * M) * CL);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  return cudaLaunchKernelEx(&cfg, kern, f(x), f(wd), f(bd), f(wu), f(bu), f(ln1s), f(ln1b),
                            f(ln2s), f(ln2b), static_cast<float*>(out), rows, plan);
}

// The float32 entry: `cluster` CTAs a tile (1; 2, a cluster, each on half the
// groups) and `m` 16-row m-tiles a CTA (1, 2, or 4 on one CTA a tile), or 0
// for either to choose.
// Ring slots as large as fit two CTAs an SM where there are enough CTAs, else
// one.
int launch_f32(const void* x, const void* wd, const void* bd, const void* wu, const void* bu,
               const void* ln1s, const void* ln1b, const void* ln2s, const void* ln2b, void* out,
               int rows, int C, int G, int go, bool has_ln1, int cluster, int m,
               cudaStream_t stream) {
  if (G < 1 || go < 1 || C < G || C % G || rows < 1 || cluster < 0 || cluster > 2 ||
      (m != 0 && m != 1 && m != 2 && m != 4) || (m == 4 && cluster == 2))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // chosen: a cluster where one CTA a tile leaves SMs idle, two m-tiles where
  // there are rows enough to fill the card with them, four where the channels
  // are few and the rows fill it twice over with those; then the first that
  // fits, the other cluster (groups allowing) and fewer m-tiles, in that order
  const bool pick_cluster = cluster == 0, pick_m = m == 0;
  if (pick_cluster) cluster = G % 2 == 0 && ceil_div(rows, 16) < sms ? 2 : 1;
  if (pick_m) {
    m = 5 * ceil_div(rows, 32) * cluster >= 3 * sms ? 2 : 1;
    if (cluster == 1 && C <= 192 && ceil_div(rows, 64) >= 2 * sms) m = 4;
  }
  if (G % cluster) return cudaErrorInvalidValue;
  const size_t half = static_cast<size_t>(smem_max) / 2 - 1024;
  Tf32Plan plan;
  bool ok = false;
  for (const int cl : {cluster, 3 - cluster}) {
    if (ok || G % cl || (cl != cluster && !pick_cluster)) continue;
    for (int mm = m; mm >= (pick_m ? 1 : m) && !ok; mm /= 2) {
      if (mm == 4 && cl == 2) continue;
      const bool two = ceil_div(rows, 16 * mm) * cl > sms;
      for (const size_t budget : {two ? half : static_cast<size_t>(smem_max),
                                  static_cast<size_t>(smem_max)}) {
        for (const int slot : {1024, 768, 512, 384, 256, 128})
          if ((ok = make_tf32_plan(C, G, go, cl, mm, slot, budget, plan))) break;
        if (ok) break;
      }
      if (ok) cluster = cl, m = mm;
    }
  }
  if (!ok) return cudaErrorInvalidValue;
  plan.has_ln1 = has_ln1;
  plan.vx = plan.cl % 4 == 0 && aligned16(x) && aligned16(out) && aligned16(bu) &&
            aligned16(ln2s) && aligned16(ln2b) &&
            (!has_ln1 || (aligned16(ln1s) && aligned16(ln1b)));
  plan.vd = go % 4 == 0 && aligned16(wd);
  plan.vu = plan.gi % 4 == 0 && aligned16(wu);
  auto launch = cluster == 2 ? (m == 2 ? launch_tf32<2, 2> : launch_tf32<2, 1>)
                             : (m == 4 ? launch_tf32<1, 4>
                                       : m == 2 ? launch_tf32<1, 2> : launch_tf32<1, 1>);
  return launch(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, out, rows, plan, stream);
}

}  // namespace
}  // namespace dgsct

// x, out: (rows, C); wd: (G, C/G, go); bd: (G*go); wu: (G, go, C/G); bu, ln*: (C).
// ln1s / ln1b are read only when has_ln1. float32 needs C a multiple of G and
// the plan in shared memory (C + G * go up to about 3000); bfloat16 needs C/G
// a multiple of 8, G * ceil(go / 8) <= 32 and 16-byte aligned x, out, wd, wu,
// bu and ln* (cudaErrorInvalidValue, cudaErrorMisalignedAddress otherwise).
extern "C" int k3_adapter_bottleneck(const void* x, const void* wd, const void* bd,
                                     const void* wu, const void* bu, const void* ln1s,
                                     const void* ln1b, const void* ln2s, const void* ln2b,
                                     void* out, int rows, int C, int G, int go, int has_ln1,
                                     int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dgsct::kF32)
    return dgsct::launch_f32(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, out, rows, C, G, go,
                             has_ln1 != 0, 0, 0, s);
  if (dtype == dgsct::kBF16)
    return has_ln1 ? dgsct::launch_mma<true>(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, out,
                                             rows, C, G, go, s)
                   : dgsct::launch_mma<false>(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, out,
                                              rows, C, G, go, s);
  return cudaErrorInvalidValue;
}

// The float32 kernel with its geometry chosen: `cluster` CTAs a tile (1, or 2:
// a cluster of two, each on half the groups) and `m` 16-row m-tiles a CTA (1,
// 2, or 4 with one CTA a tile); 0 for either chooses as k3_adapter_bottleneck
// does. For timing the geometries against each other.
extern "C" int k3_adapter_bottleneck_f32(const void* x, const void* wd, const void* bd,
                                         const void* wu, const void* bu, const void* ln1s,
                                         const void* ln1b, const void* ln2s, const void* ln2b,
                                         void* out, int rows, int C, int G, int go, int has_ln1,
                                         int cluster, int m, void* stream) {
  return dgsct::launch_f32(x, wd, bd, wu, bu, ln1s, ln1b, ln2s, ln2b, out, rows, C, G, go,
                           has_ln1 != 0, cluster, m, static_cast<cudaStream_t>(stream));
}
