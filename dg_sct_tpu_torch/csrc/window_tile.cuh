// The attention of one (window, head) on tensor cores: the stage that K1
// (window_attention.cu) and K2 (block_attention.cu) share.
//
// One warp takes 16 query rows against all N keys of its window and head:
//   s = q k^T + bias (+ mask), keys past N at -inf
//   p = softmax(s) in float32, e times 1 / sum(e), rounded to the operand type E
//   o = p v, float32 sums
// The scores stay in the warp's registers (mma accumulators), so they never
// reach shared or device memory. The operand type E fixes both products:
//   E = __nv_bfloat16: bf16 mma.sync m16n8k16 with float32 accumulation, and
//     p rounded to bf16 (K1 in bf16: the TPU kernel's p.astype(v.dtype));
//   E = float: 3xTF32 mma.sync m16n8k8, float32-accurate, and p stays
//     float32 (K1 in float32; K2 in either type, whose q, k, v are float32).
//     The block splits k and v into their TF32 halves once (prepare_rows),
//     so that the warps that share them do not each split them again.
#pragma once

#include <type_traits>

#include "tensor_core.cuh"

namespace dgsct {

// A window's q, k or v tile in shared memory: NP = 16 * NKB rows (the pad
// rows zero), D columns zero-padded to cols(D), a k-step of the score product,
// at a row stride of stride(D) elements. The stride is 4 words mod 8, so the
// fragment loads of a warp hit 32 banks, and a multiple of 16 bytes for
// cp.async. A (window, head) pair holds kTiles tiles: q, k, v, and for float
// the TF32 small halves of k and v right after them (slots 2 and 4).
template <typename E> struct WinTile;
template <> struct WinTile<__nv_bfloat16> {
  static constexpr int kTiles = 3, kSlotK = 1, kSlotV = 2;
  __host__ __device__ static constexpr int cols(int D) { return (D + 15) / 16 * 16; }
  __host__ __device__ static constexpr int stride(int D) { return cols(D) + 8; }
};
template <> struct WinTile<float> {
  static constexpr int kTiles = 5, kSlotK = 1, kSlotV = 3;
  __host__ __device__ static constexpr int cols(int D) { return (D + 7) / 8 * 8; }
  __host__ __device__ static constexpr int stride(int D) { return cols(D) + 4; }
};

constexpr int kMaxHeadDim = 32;  // four 8-column output tiles per warp

// Blocks of NKB 16-row tiles: P (window, head) pairs per block, one warp per
// 16 query rows, so that small windows still give a block several warps.
template <int NKB> struct WinPack {
  static constexpr int NP = 16 * NKB;
  static constexpr int P = NKB >= 8 ? 1 : 8 / NKB;
  static constexpr int kWarps = P * NKB;
  static constexpr int kThreads = 32 * kWarps;
  // Blocks an SM should hold, which caps the registers: one block cannot
  // hide its own load and softmax latency. At NKB 9 the scores alone are 72
  // registers a thread, so 2 blocks of 9 warps; smaller windows, 3.
  static constexpr int kMinBlocks = NKB >= 8 ? 2 : 3;
  template <typename E> static size_t smem_bytes(int D) {
    return sizeof(E) * static_cast<size_t>(WinTile<E>::kTiles * P * NP * WinTile<E>::stride(D));
  }
};

// Calls f(std::integral_constant<int, NKB>) with the smallest compiled NKB
// whose NP covers N <= 144. The compiled ones are the models' windows:
// 6x6 (N 36, NKB 3), 8x8 (64, 4) and 12x12 (144, 9); other N pad up.
template <typename F> cudaError_t with_nkb(int N, F&& f) {
  if (N <= 48) return f(std::integral_constant<int, 3>{});
  if (N <= 64) return f(std::integral_constant<int, 4>{});
  if (N <= 144) return f(std::integral_constant<int, 9>{});
  return cudaErrorInvalidValue;
}

// Copies an N x D tile (row stride ld elements in device memory, 16-byte
// aligned rows, D a multiple of 8) into the WinTile layout at dst with
// cp.async; the pad rows and columns are zero-filled by the same copies.
// The caller commits and waits.
template <typename E>
__device__ __forceinline__ void load_tile(E* dst, const E* __restrict__ src, size_t ld, int N,
                                          int NP, int D, int tid, int nthreads) {
  constexpr int V = 16 / sizeof(E);
  const int S = WinTile<E>::stride(D), chunks = WinTile<E>::cols(D) / V;
  for (int i = tid; i < NP * chunks; i += nthreads) {
    const int r = i / chunks, c = (i - r * chunks) * V;
    const bool ok = r < N && c < D;
    cp_async16(dst + r * S + c, ok ? src + r * ld + c : src, ok);
  }
}

// Float tiles only, once their copies have landed: rows of q times qscale
// (after L2 normalisation if `normalise`), rows of k L2-normalised if
// `normalise`, and k and v split into TF32 halves, the big half in place and
// the small half in the next slot. 8 lanes per row, 4 columns per lane, so a
// warp takes 4 rows at a time. qscale(p) is pair p's scale of q. The caller
// synchronises before and after.
template <int NKB, typename QScale>
__device__ __forceinline__ void prepare_rows(float* pairs, int npairs, int N, int D,
                                             bool normalise, QScale qscale, int warp,
                                             int nwarps) {
  using Tile = WinTile<float>;
  const int S = Tile::stride(D), tile = 16 * NKB * S, rows = 3 * N, total = npairs * rows;
  const int lane = threadIdx.x & 31, c = 4 * (lane & 7);
  for (int base = 4 * warp; base < total; base += 4 * nwarps) {
    const int R = base + (lane >> 3), p = R / rows, r = R - p * rows, which = r / N;
    const bool ok = R < total && c < D;
    const int slot = which == 0 ? 0 : (which == 1 ? Tile::kSlotK : Tile::kSlotV);
    float* x = pairs + (p * Tile::kTiles + slot) * tile + (r - which * N) * S + c;
    float4 v = ok ? *reinterpret_cast<const float4*>(x) : make_float4(0.f, 0.f, 0.f, 0.f);
    if (normalise) {  // every lane takes part in the shuffles
      float ss = v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (which < 2) {
        const float inv = rsqrtf(ss + 1e-12f);
        v = make_float4(v.x * inv, v.y * inv, v.z * inv, v.w * inv);
      }
    }
    if (!ok) continue;
    if (which == 0) {
      const float sc = qscale(p);
      *reinterpret_cast<float4*>(x) = make_float4(v.x * sc, v.y * sc, v.z * sc, v.w * sc);
    } else {
      uint4 big, small;
      split_tf32(v.x, big.x, small.x);
      split_tf32(v.y, big.y, small.y);
      split_tf32(v.z, big.z, small.z);
      split_tf32(v.w, big.w, small.w);
      *reinterpret_cast<uint4*>(x) = big;
      *reinterpret_cast<uint4*>(x + tile) = small;
    }
  }
  // Zeros in the small halves of k and v wherever the loop above writes none
  // (pad rows N..NP-1, pad columns D..cols(D)-1): load_tile fills only the
  // slots it copies into, so these would hold what an earlier kernel left in
  // shared memory, and a zero weight or a zero q column times a non-finite
  // leftover is NaN.
  const int chunks = Tile::cols(D) / 4, per_slot = 16 * NKB * chunks;
  for (int i = 32 * warp + lane; i < npairs * 2 * per_slot; i += 32 * nwarps) {
    const int p = i / (2 * per_slot), kv = i / per_slot - 2 * p, e = i - (2 * p + kv) * per_slot;
    const int row = e / chunks, col = 4 * (e - row * chunks);
    if (row < N && col < D) continue;
    const int slot = (kv ? Tile::kSlotV : Tile::kSlotK) + 1;
    *reinterpret_cast<float4*>(pairs + (p * Tile::kTiles + slot) * tile + row * S + col) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Query rows [r0, r0 + 16) of one window and head, by one warp, from the
// tiles of one pair in the WinTile layout (for float, k and v split by
// prepare_rows). bias and mask (null: none) are N x N of type B.
// store(row, d, o[row][d], o[row][d + 1]) is called for rows < N, even d < D.
template <int NKB, typename E, typename B, typename Store>
__device__ __forceinline__ void attend_rows(const E* pair, int N, int D, int r0,
                                            const B* __restrict__ bias,
                                            const B* __restrict__ mask, Store store) {
  constexpr bool kBF16 = std::is_same<E, __nv_bfloat16>::value;
  constexpr int NT = 2 * NKB;  // 8-key tiles
  constexpr int DT = kMaxHeadDim / 8;
  const int S = WinTile<E>::stride(D), DP = WinTile<E>::cols(D), dt = D / 8;
  const int tile = 16 * NKB * S;
  const E* qs = pair;
  const E* ks = pair + WinTile<E>::kSlotK * tile;
  const E* vs = pair + WinTile<E>::kSlotV * tile;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

  // ---- s = q k^T ----------------------------------------------------------------
  if constexpr (kBF16) {
    for (int k0 = 0; k0 < DP; k0 += 16) {
      const E* qa = qs + (r0 + g) * S + k0 + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * S), ld32(qa + 8), ld32(qa + 8 * S + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const E* kb = ks + (8 * j + g) * S + k0 + 2 * t;
        mma_bf16(s[j], a, ld32(kb), ld32(kb + 8));
      }
    }
  } else {
    for (int k0 = 0; k0 < DP; k0 += 8) {
      const float* qa = qs + (r0 + g) * S + k0 + t;
      const SplitFrag<4> a({qa[0], qa[8 * S], qa[4], qa[8 * S + 4]});
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t* kb = reinterpret_cast<const uint32_t*>(ks + (8 * j + g) * S + k0 + t);
        SplitFrag<2> b;
        b.big[0] = kb[0];
        b.big[1] = kb[4];
        b.small[0] = kb[tile];
        b.small[1] = kb[tile + 4];
        mma_3xtf32(s[j], a, b);
      }
    }
  }

  // ---- + bias + mask, softmax over the row (4 lanes share a row) -----------------
  const int ra = r0 + g, rb = ra + 8;
  const bool pairs_ok = (N & 1) == 0;  // (row, 2t) pairs of bias and mask are aligned
  float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? rb : ra, col = 8 * j + 2 * t;
      float v0 = col < N ? s[j][2 * h] : -INFINITY;
      float v1 = col + 1 < N ? s[j][2 * h + 1] : -INFINITY;
      if (row < N && col < N) {
        const int i = row * N + col;
        if (pairs_ok) {
          float2 b = load2(bias + i);
          if (mask) {
            const float2 m = load2(mask + i);
            b = make_float2(b.x + m.x, b.y + m.y);
          }
          v0 += b.x;
          v1 += b.y;
        } else {
          v0 += to_f(bias[i]) + (mask ? to_f(mask[i]) : 0.f);
          if (col + 1 < N) v1 += to_f(bias[i + 1]) + (mask ? to_f(mask[i + 1]) : 0.f);
        }
      }
      s[j][2 * h] = v0;
      s[j][2 * h + 1] = v1;
      if (h) mxb = fmaxf(mxb, fmaxf(v0, v1));
      else mxa = fmaxf(mxa, fmaxf(v0, v1));
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, o));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, o));
  }
  float suma = 0.f, sumb = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = expf(s[j][e] - (e < 2 ? mxa : mxb));
      s[j][e] = x;
      if (e < 2) suma += x;
      else sumb += x;
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    suma += __shfl_xor_sync(0xffffffffu, suma, o);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, o);
  }
  const float inva = 1.f / suma, invb = 1.f / sumb;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= e < 2 ? inva : invb;

  // ---- o = p v: the score accumulators are the A fragments -----------------------
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  if constexpr (kBF16) {
#pragma unroll
    for (int kb = 0; kb < NKB; ++kb) {
      const uint32_t a[4] = {pack_bf16(s[2 * kb][0], s[2 * kb][1]),
                             pack_bf16(s[2 * kb][2], s[2 * kb][3]),
                             pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                             pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3])};
      const E* v0 = vs + (16 * kb + 2 * t) * S + g;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        if (n < dt) {
          const E* vp = v0 + 8 * n;
          mma_bf16(o[n], a, pack_bf16(vp[0], vp[S]), pack_bf16(vp[8 * S], vp[9 * S]));
        }
      }
    }
  } else {
    // A column t stands for key 8j + 2t and column t + 4 for key 8j + 2t + 1,
    // so the C layout of the scores is the A layout with no shuffle; the B
    // rows of v follow the same order.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const SplitFrag<4> a({s[j][0], s[j][2], s[j][1], s[j][3]});
      const uint32_t* v0 = reinterpret_cast<const uint32_t*>(vs + (8 * j + 2 * t) * S + g);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        if (n < dt) {
          SplitFrag<2> b;
          b.big[0] = v0[8 * n];
          b.big[1] = v0[S + 8 * n];
          b.small[0] = v0[tile + 8 * n];
          b.small[1] = v0[tile + S + 8 * n];
          mma_3xtf32(o[n], a, b);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < DT; ++n) {
    if (n < dt) {
      if (ra < N) store(ra, 8 * n + 2 * t, o[n][0], o[n][1]);
      if (rb < N) store(rb, 8 * n + 2 * t, o[n][2], o[n][3]);
    }
  }
}

}  // namespace dgsct
