// K1: the window-attention core, for Hopper (sm_90a).
//
// Replaces dg_sct_tpu/ops/pallas/window_attention.py:73 `fused_window_attention`
// (kernel body `_kernel` :29). Per window w and head h, with q, k, v in their
// native (Bw, N, H, D) layout and q already scaled:
//   s = q k^T + bias[h] (+ mask[w mod nW]);  p = softmax(s) in float32;
//   out = p (rounded to the output type, as the TPU kernel rounds) . v
// Scores, softmax and sums are float32 for float32 and bfloat16 tensors.
//
// What bounds it on this card: bytes. A window's scores never leave the SM,
// so the kernel must move q, k, v and out once (4 N H D elements per window)
// plus the bias; the two small products (N x N x D) are far below the
// tensor-core rate. On the main path it runs only in Swin stage 3 (N=36,
// H=48, D=32, 20 windows for two clips), where launch latency dominates.
//
// Design: one block per (window, head). k and v of the head sit in shared
// memory as float32 with a padded row (D+1) so that 32 lanes reading 32
// different key rows hit 32 banks. Each warp owns query rows: one lane per
// key for the scores, warp reductions for max and sum, one lane per channel
// for p.v. Plain FMA; any N and D whose working set fits in shared memory.
#include "common.cuh"

namespace dgsct {
namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ bias,
                        const T* __restrict__ mask, T* __restrict__ out,
                        int N, int H, int D, int nW) {
  extern __shared__ float smem[];
  const int LD = D + 1;
  float* ks = smem;                  // N x LD
  float* vs = ks + N * LD;           // N x LD
  float* prow = vs + N * LD;         // kWarps x N: one probability row per warp
  float* qrow = prow + kWarps * N;   // kWarps x D: one query row per warp

  const int w = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rs = static_cast<size_t>(H) * D;           // token stride
  const size_t base = static_cast<size_t>(w) * N * rs + static_cast<size_t>(h) * D;

  for (int i = tid; i < N * D; i += blockDim.x) {
    const int n = i / D, d = i - n * D;
    ks[n * LD + d] = to_f(k[base + n * rs + d]);
    vs[n * LD + d] = to_f(v[base + n * rs + d]);
  }
  __syncthreads();

  const T* bias_h = bias + static_cast<size_t>(h) * N * N;
  const T* mask_w = mask ? mask + static_cast<size_t>(w % nW) * N * N : nullptr;
  float* p = prow + warp * N;
  float* qr = qrow + warp * D;

  for (int n = warp; n < N; n += kWarps) {
    for (int d = lane; d < D; d += 32) qr[d] = to_f(q[base + n * rs + d]);
    __syncwarp();
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
    for (int j = lane; j < N; j += 32) p[j] = round_to<T>(p[j] / sum);
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(p[j], vs[j * LD + d], acc);
      out[base + n * rs + d] = from_f<T>(acc);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* mask, void* out, int Bw, int N, int H, int D, int nW,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * N * (D + 1) + kWarps * N + kWarps * D);
  auto kern = window_attention_kernel<T>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Bw, H), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<const T*>(mask), static_cast<T*>(out),
      N, H, D, nW);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dgsct

// q, k, v, out: (Bw, N, H, D); bias: (H, N, N); mask: (nW, N, N) or null.
extern "C" int k1_window_attention(const void* q, const void* k, const void* v,
                                   const void* bias, const void* mask, void* out,
                                   int Bw, int N, int H, int D, int nW, int dtype,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dgsct::kF32:
      return dgsct::launch<float>(q, k, v, bias, mask, out, Bw, N, H, D, nW, s);
    case dgsct::kBF16:
      return dgsct::launch<__nv_bfloat16>(q, k, v, bias, mask, out, Bw, N, H, D, nW, s);
    default:
      return cudaErrorInvalidValue;
  }
}
