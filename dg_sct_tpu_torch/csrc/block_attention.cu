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
// and the TPU kernel's plan of one ws x W strip with all of Wqkv resident does
// not carry over: Wqkv is 3.4 MiB in bf16 at C = 768, and one 144-token window
// at C = 768 already fills a block's 227 KB of shared memory.
//
// Design, three kernels per call:
//   1. qkv_attention: one block per (window, head). It streams the window's
//      rows of x (through LN1 for v1, with row statistics from a first pass)
//      and the head's 3 D columns of Wqkv through shared memory in chunks of
//      32 channels, accumulates the (N x 3D) product in registers (16 x 16
//      threads, an MR x MC tile each, masked to N and 3D), then takes the
//      head's attention from shared memory (one warp per query row) and
//      writes it to a (B, H, W, C) scratch in x's type.
//   2. proj: a 64 x 64 tiled product of that scratch with Wproj, plus bias,
//      into a float32 scratch.
//   3. residual: one warp per token row: LN1 (v2), the residual, the store.
// Plain FMA in float32; wgmma and TMA are later work.
#include "common.cuh"

namespace dgsct {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;  // channels per chunk of the qkv product

template <int MR, int MC>
struct QkvTile {
  static constexpr int RT = 16 * MR;  // rows of the product tile (>= N)
  static constexpr int CT = 16 * MC;  // columns of the product tile (>= 3 D)
  static int floats(int N, int D) {
    const int a = RT * (kKC + 1) + kKC * CT;  // x chunk + Wqkv chunk
    const int b = 3 * N * (D + 1);            // q, k, v (aliases the chunks)
    return (a > b ? a : b) + 2 * RT + kWarps * N;
  }
};

template <typename T, int KIND, int MR, int MC>
__global__ void __launch_bounds__(kThreads)
qkv_attention_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                     const T* __restrict__ bqkv, const T* __restrict__ bias,
                     const T* __restrict__ ln_s, const T* __restrict__ ln_b,
                     const T* __restrict__ mask, const T* __restrict__ logit_scale,
                     T* __restrict__ attn_out, int Hs, int Ws, int C, int heads,
                     int ws, float q_scale, float max_log_scale) {
  using Tile = QkvTile<MR, MC>;
  constexpr int RT = Tile::RT, CT = Tile::CT, LX = kKC + 1;
  const int D = C / heads, N = ws * ws, D3 = 3 * D, LD = D + 1;

  extern __shared__ float smem[];
  float* xs = smem;                 // RT x LX     (product phase)
  float* wsm = xs + RT * LX;        // kKC x CT    (product phase)
  float* qs = smem;                 // N x LD      (attention phase)
  float* ks = qs + N * LD;
  float* vs = ks + N * LD;
  const int region = (RT * LX + kKC * CT > 3 * N * LD) ? RT * LX + kKC * CT : 3 * N * LD;
  float* mu = smem + region;        // RT: v1 row mean
  float* rstd = mu + RT;            // RT: v1 row 1/std
  float* prow = rstd + RT;          // kWarps x N

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = blockIdx.x, h = blockIdx.y;
  const int nWc = Ws / ws, nW = (Hs / ws) * nWc;
  const int b = wg / nW, wi = wg - b * nW;
  const int r0 = (wi / nWc) * ws, c0 = (wi % nWc) * ws;
  auto token_row = [&](int n) -> size_t {
    const int i = n / ws, j = n - i * ws;
    return (static_cast<size_t>(b) * Hs + r0 + i) * Ws + c0 + j;
  };

  if (KIND == 1) {  // LN1 row statistics (two-pass variance, as the reference)
    for (int n = warp; n < N; n += kWarps) {
      const T* xr = x + token_row(n) * C;
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
      const float m = warp_sum(s) / C;
      float s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = to_f(xr[c]) - m;
        s2 += d * d;
      }
      const float var = warp_sum(s2) / C;
      if (lane == 0) {
        mu[n] = m;
        rstd[n] = rsqrtf(var + 1e-5f);
      }
    }
    __syncthreads();
  }

  // ---- (N x 3D) = x_window (N x C) . Wqkv[:, head columns] (C x 3D) ----------
  const int tx = tid & 15, ty = tid >> 4;
  float acc[MR][MC];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < MC; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kKC) {
    for (int e = tid; e < RT * kKC; e += kThreads) {
      const int r = e / kKC, kk = e - r * kKC, kc = k0 + kk;
      float val = 0.f;
      if (r < N && kc < C) {
        val = to_f(x[token_row(r) * C + kc]);
        if (KIND == 1)
          val = round_to<T>((val - mu[r]) * rstd[r] * to_f(ln_s[kc]) + to_f(ln_b[kc]));
      }
      xs[r * LX + kk] = val;
    }
    for (int e = tid; e < kKC * CT; e += kThreads) {
      const int kk = e / CT, c = e - kk * CT, kc = k0 + kk;
      float val = 0.f;
      if (c < D3 && kc < C) {
        const int part = c / D;
        val = to_f(wqkv[static_cast<size_t>(kc) * 3 * C + part * C + h * D + (c - part * D)]);
      }
      wsm[kk * CT + c] = val;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      float a[MR], w[MC];
#pragma unroll
      for (int i = 0; i < MR; ++i) a[i] = xs[(ty + 16 * i) * LX + kk];
#pragma unroll
      for (int j = 0; j < MC; ++j) w[j] = wsm[kk * CT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  // ---- q, k, v (+ bias) into shared memory, float32 ----------------------------
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      const int c = tx + 16 * j;
      if (r < N && c < D3) {
        const int part = c / D, d = c - part * D;
        float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
        dst[r * LD + d] = acc[i][j] + to_f(bqkv[part * C + h * D + d]);
      }
    }
  }
  __syncthreads();

  if (KIND == 2) {  // cosine attention: unit rows, q times the clamped scale
    const float lscale = expf(fminf(to_f(logit_scale[h]), max_log_scale));
    for (int n = warp; n < 2 * N; n += kWarps) {
      float* row = n < N ? qs + n * LD : ks + (n - N) * LD;
      float ss = 0.f;
      for (int d = lane; d < D; d += 32) ss += row[d] * row[d];
      const float inv = rsqrtf(warp_sum(ss) + 1e-12f);
      for (int d = lane; d < D; d += 32) {
        float t = row[d] * inv;
        if (n < N) t = t * lscale;
        row[d] = t;
      }
    }
  } else {
    for (int e = tid; e < N * D; e += kThreads) {
      const int n = e / D, d = e - n * D;
      qs[n * LD + d] *= q_scale;
    }
  }
  __syncthreads();

  // ---- attention of this head, one warp per query row ----------------------------
  const T* bias_h = bias + static_cast<size_t>(h) * N * N;
  const T* mask_w = mask ? mask + static_cast<size_t>(wi) * N * N : nullptr;
  float* p = prow + warp * N;
  for (int n = warp; n < N; n += kWarps) {
    const float* qr = qs + n * LD;
    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const float* kr = ks + j * LD;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s += to_f(bias_h[n * N + j]);
      if (mask_w) s += to_f(mask_w[n * N + j]);
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) p[j] = p[j] / sum;
    __syncwarp();
    T* orow = attn_out + token_row(n) * C + h * D;
    for (int d = lane; d < D; d += 32) {
      float o = 0.f;
      for (int j = 0; j < N; ++j) o = fmaf(p[j], vs[j * LD + d], o);
      orow[d] = from_f<T>(o);
    }
    __syncwarp();
  }
}

// y (M x Nc, float32) = a (M x K) . w (K x Nc) + bias
template <typename T>
__global__ void __launch_bounds__(kThreads)
proj_kernel(const T* __restrict__ a, const T* __restrict__ w, const T* __restrict__ bias,
            float* __restrict__ y, int M, int K, int Nc) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;  // rows on x: no 65535 cap
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, kk = e - r * BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < K) ? to_f(a[static_cast<size_t>(gr) * K + gk]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, c = e - kk * BN;
      const int gk = k0 + kk, gc = col0 + c;
      Bs[kk][c] = (gk < K && gc < Nc) ? to_f(w[static_cast<size_t>(gk) * Nc + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gr < M && gc < Nc) y[static_cast<size_t>(gr) * Nc + gc] = acc[i][j] + to_f(bias[gc]);
    }
  }
}

// out = x + LN1(y) (v2) or x + y (v1), one warp per token row
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
residual_kernel(const T* __restrict__ x, const float* __restrict__ y,
                const T* __restrict__ ln_s, const T* __restrict__ ln_b,
                T* __restrict__ out, int M, int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const size_t base = static_cast<size_t>(row) * C;
  if (KIND == 2) {
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
  } else {
    for (int c = lane; c < C; c += 32) out[base + c] = from_f<T>(to_f(x[base + c]) + y[base + c]);
  }
}

struct Args {
  const void *x, *wqkv, *bqkv, *wproj, *bproj, *bias, *ln_s, *ln_b, *mask, *logit_scale;
  void *attn, *y, *out;
  int B, Hs, Ws, C, heads, ws;
};

template <typename T, int KIND, int MR, int MC>
cudaError_t launch_qkv_attention(const Args& g, cudaStream_t stream) {
  const int D = g.C / g.heads, N = g.ws * g.ws;
  const size_t smem = sizeof(float) * QkvTile<MR, MC>::floats(N, D);
  auto kern = qkv_attention_kernel<T, KIND, MR, MC>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int windows = g.B * (g.Hs / g.ws) * (g.Ws / g.ws);
  kern<<<dim3(windows, g.heads), kThreads, smem, stream>>>(
      static_cast<const T*>(g.x), static_cast<const T*>(g.wqkv), static_cast<const T*>(g.bqkv),
      static_cast<const T*>(g.bias), static_cast<const T*>(g.ln_s), static_cast<const T*>(g.ln_b),
      static_cast<const T*>(g.mask), static_cast<const T*>(g.logit_scale),
      static_cast<T*>(g.attn), g.Hs, g.Ws, g.C, g.heads, g.ws,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))), logf(100.0f));
  return cudaGetLastError();
}

template <typename T, int KIND>
int launch(const Args& g, cudaStream_t stream) {
  const int D = g.C / g.heads, N = g.ws * g.ws;
  cudaError_t err;
  if (N <= 64 && 3 * D <= 80)        // HTS-AT windows: 64 tokens, D = 24
    err = launch_qkv_attention<T, KIND, 4, 5>(g, stream);
  else if (N <= 144 && 3 * D <= 96)  // Swin-V2 windows: 144 (36) tokens, D = 32
    err = launch_qkv_attention<T, KIND, 9, 6>(g, stream);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const int M = g.B * g.Hs * g.Ws;
  proj_kernel<T><<<dim3((M + 63) / 64, (g.C + 63) / 64), kThreads, 0, stream>>>(
      static_cast<const T*>(g.attn), static_cast<const T*>(g.wproj),
      static_cast<const T*>(g.bproj), static_cast<float*>(g.y), M, g.C, g.C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  residual_kernel<T, KIND><<<(M + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const T*>(g.x), static_cast<const float*>(g.y),
      static_cast<const T*>(g.ln_s), static_cast<const T*>(g.ln_b), static_cast<T*>(g.out),
      M, g.C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dgsct

// x, out: (B, Hs, Ws, C); wqkv: (C, 3C); bqkv: (3C); wproj: (C, C); bproj, ln_s,
// ln_b: (C); bias: (heads, N, N); mask: (nW, N, N) or null; logit_scale: (heads)
// (v2). Scratch from the caller: attn (B, Hs, Ws, C) of x's type, y float32.
// kind: 1 = v1 (HTS-AT), 2 = v2 (Swin-V2).
extern "C" int k2_block_attention(const void* x, const void* wqkv, const void* bqkv,
                                  const void* wproj, const void* bproj, const void* bias,
                                  const void* ln_s, const void* ln_b, const void* mask,
                                  const void* logit_scale, void* attn, void* y, void* out,
                                  int B, int Hs, int Ws, int C, int heads, int ws, int kind,
                                  int dtype, void* stream) {
  const dgsct::Args g{x, wqkv, bqkv, wproj, bproj, bias, ln_s, ln_b, mask, logit_scale,
                      attn, y, out, B, Hs, Ws, C, heads, ws};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == dgsct::kF32 && kind == 1) return dgsct::launch<float, 1>(g, s);
  if (dtype == dgsct::kF32 && kind == 2) return dgsct::launch<float, 2>(g, s);
  if (dtype == dgsct::kBF16 && kind == 1) return dgsct::launch<__nv_bfloat16, 1>(g, s);
  if (dtype == dgsct::kBF16 && kind == 2) return dgsct::launch<__nv_bfloat16, 2>(g, s);
  return cudaErrorInvalidValue;
}
