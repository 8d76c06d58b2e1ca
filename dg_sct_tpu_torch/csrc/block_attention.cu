// K2: the attention half-block of an eval Swin block, for Hopper (sm_90a).
//
// Replaces dg_sct_tpu/ops/pallas/block_attention.py:113 `fused_attn_half_block`
// (kernel body `_kernel` :49). x is (B, H, W, C), already rolled by the caller
// for shifted windows. With D = C / heads and N = ws * ws:
//   v1 (HTS-AT):  out = x + proj(attn(LN1(x)))      scaled dot scores + rel-pos bias
//   v2 (Swin-V2): out = x + LN1(proj(attn(x)))      cosine scores: L2-normalised q, k,
//                 q times exp(min(logit_scale, ln 100)), 16 sigmoid(CPB) bias given
// Rounding points of the TPU kernel: LN1(x) is rounded to x's type before the
// qkv product (v1); qkv, q, k, v, scores and softmax stay float32; the
// attention output is rounded to x's type before proj; proj, LN and the
// residual are float32 and round once at the store.
//
// What bounds it on this card: operations. The qkv and proj products are
// 8 T C^2 FLOPs for T tokens against 2 T C elements of x and out (C = 96..768),
// 91% of the work at Swin stage 2, and their operands are in x's type with
// float32 sums: exactly the tensor cores' bf16 product. The TPU kernel's
// plan of one ws x W strip with all of Wqkv resident does not carry over:
// Wqkv is 3.4 MiB in bf16 at C = 768, and one 144-token window at C = 768
// already fills a block's 227 KB of shared memory, so the products are
// token-major GEMMs that read x once, not once per head.
//
// Design, four kernels per call:
//   1. v1 only: block_attn_layernorm_kernel, one warp per token row, writes
//      LN1(x) rounded to x's type (the TPU kernel's rounding point) into the
//      attention-output scratch, which is free until step 3.
//   2. block_attn_gemm_kernel (qkv): GEMM of (T x C) by Wqkv (C x 3C),
//      128 x 128 block tiles, a 3-stage cp.async ring (16-byte copies of both
//      operands, 64 deep in bf16), 8 warps of 64 x 32 each. bf16: ldmatrix and
//      mma.sync m16n8k16 with float32 accumulation; float32: 3xTF32 mma.sync
//      (float32-accurate; TF32 stays off). The A rows are gathered in window
//      order (the window partition as an address map), and the epilogue adds
//      bqkv and writes q, k, v in float32 as (B nW, 3, heads, N, D), each
//      head's tile contiguous.
//   3. block_attn_attention_kernel: one warp per (window, head, 16 query
//      rows) (window_tile.cuh), 4320 warps at Swin stage 2. It stages the
//      head's float32 q, k, v with cp.async, applies the v2 normalisation and
//      clamped logit scale or the v1 scale and splits k and v into their TF32
//      halves in one pass, keeps the scores in registers and writes the
//      head's output in x's type, token-major (B, H, W, C). The TPU kernel
//      takes these two products in float32, so they are 3xTF32 mma.sync
//      (about 2^-22 relative per product): bf16 tensor cores would round q,
//      k, v and p to 8 bits, TF32 alone to 11.
//   4. block_attn_gemm_kernel (proj) of that output by Wproj, plus bproj.
//      v1: the epilogue adds x and stores out. v2: LN1 needs whole rows, so
//      the epilogue stores a float32 y and block_attn_residual_kernel (one
//      warp per row) does LN1, the residual and the store; the y round trip
//      is 8 T C bytes, in L2 at the larger C.
// The price of the token-major GEMMs is the float32 qkv scratch, 12 T C
// bytes written and read once. What holds it back now (PERF.md): the
// attention stage of a 144-token window is latency-bound (two blocks of
// 9 warps an SM: 72 score registers a thread and 104 KB of split tiles a
// pair), and mma.sync reaches a fraction of what wgmma would.
#include "window_tile.cuh"

namespace dgsct {
namespace {

constexpr int kRowThreads = 256;  // row kernels: one warp per token row
constexpr int kRowWarps = kRowThreads / 32;

// ---- 1. LN1(x) in x's type (v1) ------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
block_attn_layernorm_kernel(const T* __restrict__ x, const T* __restrict__ ln_s,
                            const T* __restrict__ ln_b, T* __restrict__ out, int M, int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + static_cast<size_t>(row) * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  const float m = warp_sum(s) / C;
  float s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - m;
    s2 += d * d;
  }
  const float r = rsqrtf(warp_sum(s2) / C + 1e-5f);
  T* orow = out + static_cast<size_t>(row) * C;
  for (int c = lane; c < C; c += 32)
    orow[c] = from_f<T>((to_f(xr[c]) - m) * r * to_f(ln_s[c]) + to_f(ln_b[c]));
}

// ---- 2, 4. (M x K) . (K x N) on tensor cores --------------------------------------------
// Block tile 128 x 128 x BK (bf16 64, float 32), 8 warps of 64 x 32 (2 x 4),
// a 3-stage cp.async ring: two blocks fit an SM in either type.
template <typename T> struct Gemm {
  static constexpr int BM = 128, BN = 128, BK = sizeof(T) == 2 ? 64 : 32, STAGES = 3;
  static constexpr int kThreads = 256;
  static constexpr int MI = 4, NI = 4;      // 16 x 8 mma tiles of a warp
  static constexpr int V = 16 / sizeof(T);  // elements of one 16-byte copy
  // Row strides in elements: 16-byte aligned rows for cp.async and ldmatrix,
  // padded so that a warp's fragment loads hit distinct banks.
  static constexpr int SA = BK + (sizeof(T) == 2 ? 8 : 4);
  static constexpr int SB = BN + 8;
  static constexpr int A_ELEMS = BM * SA, B_ELEMS = BK * SB;
  static constexpr int A_COPIES = BM * BK / V / kThreads;  // per thread and slab
  static constexpr size_t kSmem = sizeof(T) * STAGES * (A_ELEMS + B_ELEMS);
};

// One BK slab of a warp's 64 x 32 tile: as = the warp's A rows (stride SA),
// bs = the warp's B columns (stride SB).
__device__ __forceinline__ void mma_slab(float (&acc)[4][4][4], const __nv_bfloat16* as,
                                         const __nv_bfloat16* bs, int lane) {
  using G = Gemm<__nv_bfloat16>;
#pragma unroll
  for (int ks = 0; ks < G::BK; ks += 16) {
    uint32_t a[G::MI][4], b[G::NI][2];
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
      ldmatrix_x4(a[mi], as + (mi * 16 + (lane & 15)) * G::SA + ks + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < G::NI / 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, bs + (ks + (lane & 15)) * G::SB + np * 16 + (lane >> 4) * 8);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

__device__ __forceinline__ void mma_slab(float (&acc)[4][4][4], const float* as, const float* bs,
                                         int lane) {
  using G = Gemm<float>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < G::BK; ks += 8) {
    SplitFrag<2> b[G::NI];
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni) {
      const float* bp = bs + (ks + t) * G::SB + ni * 8 + g;
      b[ni] = SplitFrag<2>({bp[0], bp[4 * G::SB]});
    }
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi) {
      const float* ap = as + (mi * 16 + g) * G::SA + ks + t;
      const SplitFrag<4> a({ap[0], ap[8 * G::SA], ap[4], ap[8 * G::SA + 4]});
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) mma_3xtf32(acc[mi][ni], a, b[ni]);
    }
  }
}

// out = A . W, A (M x K) with its rows gathered by plan.a_row(m), W (K x N)
// row-major; plan.store(plan.row(m), plan.col(n), out[m][n], out[m][n + 1])
// for even n. K and N multiples of 8 (16-byte rows), a and w 16-byte
// aligned; the ragged edges are zero-filled by cp.async.
template <typename T, typename Plan>
__global__ void __launch_bounds__(Gemm<T>::kThreads)
block_attn_gemm_kernel(const T* __restrict__ a, const T* __restrict__ w, int M, int N, int K,
                       Plan plan) {
  using G = Gemm<T>;
  constexpr int CPR = G::BK / G::V;  // copies per A row and slab
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + G::STAGES * G::A_ELEMS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * G::BM, n0 = blockIdx.y * G::BN;

  // the A rows this thread copies are the same in every slab
  const int a_col = (tid % CPR) * G::V;
  const T* a_src[G::A_COPIES];
#pragma unroll
  for (int q = 0; q < G::A_COPIES; ++q) {
    const int m = m0 + tid / CPR + q * (G::kThreads / CPR);
    a_src[q] = m < M ? a + plan.a_row(m) * K + a_col : nullptr;
  }
  auto load = [&](int slot, int kt) {
    const int k0 = kt * G::BK;
    T* as = As + slot * G::A_ELEMS;
    T* bs = Bs + slot * G::B_ELEMS;
#pragma unroll
    for (int q = 0; q < G::A_COPIES; ++q) {
      const bool ok = a_src[q] != nullptr && k0 + a_col < K;
      cp_async16(as + (tid / CPR + q * (G::kThreads / CPR)) * G::SA + a_col,
                 ok ? a_src[q] + k0 : a, ok);
    }
    for (int i = tid; i < G::BK * G::BN / G::V; i += G::kThreads) {
      const int r = i / (G::BN / G::V), c = (i % (G::BN / G::V)) * G::V;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(bs + r * G::SB + c, ok ? w + static_cast<size_t>(k0 + r) * N + n0 + c : w, ok);
    }
  };

  float acc[G::MI][G::NI][4];
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int KT = (K + G::BK - 1) / G::BK;
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<G::STAGES - 2>();  // slab kt has landed (this thread's copies)
    __syncthreads();                 // ... everyone's; and slab kt-1 is consumed
    if (kt + G::STAGES - 1 < KT) load((kt + G::STAGES - 1) % G::STAGES, kt + G::STAGES - 1);
    cp_async_commit();
    const int slot = kt % G::STAGES;
    mma_slab(acc, As + slot * G::A_ELEMS + wm * 64 * G::SA, Bs + slot * G::B_ELEMS + wn * 32,
             lane);
  }

  const int g = lane >> 2, t = lane & 3;
  typename Plan::Col cols[G::NI];
#pragma unroll
  for (int ni = 0; ni < G::NI; ++ni) {
    const int n = n0 + wn * 32 + ni * 8 + 2 * t;
    if (n < N) cols[ni] = plan.col(n);
  }
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + mi * 16 + g + 8 * h;
      if (m >= M) continue;
      const auto r = plan.row(m);
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni)
        if (n0 + wn * 32 + ni * 8 + 2 * t < N)
          plan.store(r, cols[ni], acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
}

// qkv: A rows in window order (the window partition as a gather of x's
// rows); q, k, v + bqkv out in float32 as (B nW, 3, heads, N, D).
template <typename T> struct QkvPlan {
  const T* bias;
  float* qkv;
  int Hs, Ws, ws, C, heads;
  struct Col {
    size_t off;
    float b0, b1;
  };
  __device__ __forceinline__ size_t a_row(int m) const {  // (window, n) -> token row
    const int N = ws * ws, nWc = Ws / ws, nW = (Hs / ws) * nWc;
    const int bw = m / N, n = m - bw * N, b = bw / nW, wi = bw - b * nW, i = n / ws;
    return (static_cast<size_t>(b) * Hs + (wi / nWc) * ws + i) * Ws + (wi % nWc) * ws +
           (n - i * ws);
  }
  __device__ __forceinline__ size_t row(int m) const {
    const int N = ws * ws, bw = m / N;
    return static_cast<size_t>(bw) * 3 * N * C + static_cast<size_t>(m - bw * N) * (C / heads);
  }
  __device__ __forceinline__ Col col(int n) const {
    const int D = C / heads, part = n / C, hc = n - part * C, h = hc / D;
    return {static_cast<size_t>(part * heads + h) * ws * ws * D + (hc - h * D), to_f(bias[n]),
            to_f(bias[n + 1])};
  }
  __device__ __forceinline__ void store(size_t r, const Col& c, float v0, float v1) const {
    store2(qkv + r + c.off, v0 + c.b0, v1 + c.b1);
  }
};

// Token-major rows, proj + bproj. v1 (x given): out = x + that, in x's type.
// v2 (x null): y = that, float32, for the row kernel's LN1.
template <typename T> struct ProjPlan {
  const T* bias;
  const T* x;
  T* out;
  float* y;
  int C;
  struct Col {
    int n;
    float b0, b1;
  };
  __device__ __forceinline__ size_t a_row(int m) const { return m; }
  __device__ __forceinline__ size_t row(int m) const { return static_cast<size_t>(m) * C; }
  __device__ __forceinline__ Col col(int n) const {
    return {n, to_f(bias[n]), to_f(bias[n + 1])};
  }
  __device__ __forceinline__ void store(size_t r, const Col& c, float v0, float v1) const {
    const size_t i = r + c.n;
    if (x) {
      const float2 xv = load2(x + i);
      store2(out + i, xv.x + (v0 + c.b0), xv.y + (v1 + c.b1));
    } else {
      store2(y + i, v0 + c.b0, v1 + c.b1);
    }
  }
};

// ---- 3. window attention of each (window, head), q, k, v float32 ----------------------
template <typename T, int KIND, int NKB>
__global__ void __launch_bounds__(WinPack<NKB>::kThreads, WinPack<NKB>::kMinBlocks)
block_attn_attention_kernel(const float* __restrict__ qkv, const T* __restrict__ bias,
                            const T* __restrict__ mask, const T* __restrict__ logit_scale,
                            T* __restrict__ attn, int pairs, int Hs, int Ws, int C, int heads,
                            int ws, float q_scale, float max_log_scale) {
  using Pack = WinPack<NKB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  using Tile = WinTile<float>;
  const int D = C / heads, N = ws * ws;
  const int tile = Pack::NP * Tile::stride(D), pair_elems = Tile::kTiles * tile;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int pair0 = blockIdx.x * Pack::P, npairs = min(Pack::P, pairs - pair0);

#pragma unroll
  for (int p = 0; p < Pack::P; ++p) {
    if (p < npairs) {
      const int bw = (pair0 + p) / heads, h = (pair0 + p) - bw * heads;
      const int slot[3] = {0, Tile::kSlotK, Tile::kSlotV};
#pragma unroll
      for (int part = 0; part < 3; ++part)
        load_tile(smem + p * pair_elems + slot[part] * tile,
                  qkv + (static_cast<size_t>(bw * 3 + part) * heads + h) * N * D, D, N,
                  Pack::NP, D, tid, Pack::kThreads);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // v1: q times D^-1/2; v2: q and k L2-normalised, q times the clamped
  // logit scale of its head
  prepare_rows<NKB>(
      smem, npairs, N, D, KIND == 2,
      [&](int p) {
        return KIND == 2 ? expf(fminf(to_f(logit_scale[(pair0 + p) % heads]), max_log_scale))
                         : q_scale;
      },
      warp, Pack::kWarps);
  __syncthreads();

  const int p = warp / NKB, pr = pair0 + p;
  if (pr >= pairs) return;
  const int bw = pr / heads, h = pr - bw * heads;
  const int nWc = Ws / ws, nW = (Hs / ws) * nWc;
  const int b = bw / nW, wi = bw - b * nW;
  const int r0 = (wi / nWc) * ws, c0 = (wi % nWc) * ws;
  T* ob = attn + static_cast<size_t>(h) * D;
  attend_rows<NKB>(smem + p * pair_elems, N, D, 16 * (warp - p * NKB),
                   bias + static_cast<size_t>(h) * N * N,
                   mask ? mask + static_cast<size_t>(wi) * N * N : nullptr,
                   [&](int n, int d, float o0, float o1) {
                     const int i = n / ws, j = n - i * ws;
                     const size_t tok = (static_cast<size_t>(b) * Hs + r0 + i) * Ws + c0 + j;
                     store2(ob + tok * C + d, o0, o1);
                   });
}

// ---- v2: out = x + LN1(y), one warp per token row --------------------------------------
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
block_attn_residual_kernel(const T* __restrict__ x, const float* __restrict__ y,
                           const T* __restrict__ ln_s, const T* __restrict__ ln_b,
                           T* __restrict__ out, int M, int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t base = static_cast<size_t>(row) * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += y[base + c];
  const float m = warp_sum(s) / C;
  float s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = y[base + c] - m;
    s2 += d * d;
  }
  const float r = rsqrtf(warp_sum(s2) / C + 1e-5f);
  for (int c = lane; c < C; c += 32) {
    const float ln = (y[base + c] - m) * r * to_f(ln_s[c]) + to_f(ln_b[c]);
    out[base + c] = from_f<T>(to_f(x[base + c]) + ln);
  }
}

struct Args {
  const void *x, *wqkv, *bqkv, *wproj, *bproj, *bias, *ln_s, *ln_b, *mask, *logit_scale;
  void *qkv, *attn, *y, *out;
  int B, Hs, Ws, C, heads, ws;
};

template <typename T, typename Plan>
cudaError_t gemm(const T* a, const T* w, int M, int N, int K, Plan plan, cudaStream_t stream) {
  using G = Gemm<T>;
  auto kern = block_attn_gemm_kernel<T, Plan>;
  cudaError_t err = allow_smem(kern, G::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((M + G::BM - 1) / G::BM, (N + G::BN - 1) / G::BN), G::kThreads, G::kSmem, stream>>>(
      a, w, M, N, K, plan);
  return cudaGetLastError();
}

template <typename T, int KIND>
int launch(const Args& g, cudaStream_t stream) {
  const int D = g.C / g.heads, N = g.ws * g.ws, M = g.B * g.Hs * g.Ws;
  if (D % 8 || D > kMaxHeadDim) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(g.x);
  const T* ln_s = static_cast<const T*>(g.ln_s);
  const T* ln_b = static_cast<const T*>(g.ln_b);
  T* attn = static_cast<T*>(g.attn);
  T* out = static_cast<T*>(g.out);
  float* qkv = static_cast<float*>(g.qkv);
  const int row_blocks = (M + kRowWarps - 1) / kRowWarps;
  cudaError_t err;

  const T* a = x;
  if (KIND == 1) {  // LN1(x) into the attention scratch, free until step 3
    block_attn_layernorm_kernel<T><<<row_blocks, kRowThreads, 0, stream>>>(x, ln_s, ln_b, attn,
                                                                           M, g.C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    a = attn;
  }
  err = gemm(a, static_cast<const T*>(g.wqkv), M, 3 * g.C, g.C,
             QkvPlan<T>{static_cast<const T*>(g.bqkv), qkv, g.Hs, g.Ws, g.ws, g.C, g.heads},
             stream);
  if (err != cudaSuccess) return err;

  err = with_nkb(N, [&](auto nkb) {
    constexpr int NKB = decltype(nkb)::value;
    using Pack = WinPack<NKB>;
    const size_t smem = Pack::template smem_bytes<float>(D);
    auto kern = block_attn_attention_kernel<T, KIND, NKB>;
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    const int pairs = (M / N) * g.heads;
    kern<<<(pairs + Pack::P - 1) / Pack::P, Pack::kThreads, smem, stream>>>(
        qkv, static_cast<const T*>(g.bias), static_cast<const T*>(g.mask),
        static_cast<const T*>(g.logit_scale), attn, pairs, g.Hs, g.Ws, g.C, g.heads, g.ws,
        static_cast<float>(1.0 / sqrt(static_cast<double>(D))), logf(100.0f));
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;

  const T* wproj = static_cast<const T*>(g.wproj);
  const T* bproj = static_cast<const T*>(g.bproj);
  if (KIND == 1)
    return gemm(static_cast<const T*>(attn), wproj, M, g.C, g.C,
                ProjPlan<T>{bproj, x, out, nullptr, g.C}, stream);
  float* y = static_cast<float*>(g.y);
  err = gemm(static_cast<const T*>(attn), wproj, M, g.C, g.C,
             ProjPlan<T>{bproj, nullptr, nullptr, y, g.C}, stream);
  if (err != cudaSuccess) return err;
  block_attn_residual_kernel<T><<<row_blocks, kRowThreads, 0, stream>>>(x, y, ln_s, ln_b, out, M,
                                                                        g.C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dgsct

// x, out: (B, Hs, Ws, C); wqkv: (C, 3C); bqkv: (3C); wproj: (C, C); bproj, ln_s,
// ln_b: (C); bias: (heads, N, N); mask: (nW, N, N) or null; logit_scale: (heads)
// (v2). D = C / heads a multiple of 8 and <= 32, N <= 144; x, the weights and
// the scratch 16-byte aligned. Scratch from the caller: qkv float32
// (B nW, 3, heads, N, D); attn (B, Hs, Ws, C) of x's type; y float32
// (B, Hs, Ws, C), v2 only. kind: 1 = v1 (HTS-AT), 2 = v2 (Swin-V2).
extern "C" int k2_block_attention(const void* x, const void* wqkv, const void* bqkv,
                                  const void* wproj, const void* bproj, const void* bias,
                                  const void* ln_s, const void* ln_b, const void* mask,
                                  const void* logit_scale, void* qkv, void* attn, void* y,
                                  void* out, int B, int Hs, int Ws, int C, int heads, int ws,
                                  int kind, int dtype, void* stream) {
  const dgsct::Args g{x,   wqkv, bqkv, wproj, bproj, bias, ln_s, ln_b, mask, logit_scale,
                      qkv, attn, y,    out,   B,     Hs,   Ws,   C,    heads, ws};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dgsct::kF32 && kind == 1) return dgsct::launch<float, 1>(g, s);
  if (dtype == dgsct::kF32 && kind == 2) return dgsct::launch<float, 2>(g, s);
  if (dtype == dgsct::kBF16 && kind == 1) return dgsct::launch<__nv_bfloat16, 1>(g, s);
  if (dtype == dgsct::kBF16 && kind == 2) return dgsct::launch<__nv_bfloat16, 2>(g, s);
  return cudaErrorInvalidValue;
}
