// K1: the window-attention core, for Hopper (sm_90a).
//
// Replaces dg_sct_tpu/ops/pallas/window_attention.py:73 `fused_window_attention`
// (kernel body `_kernel` :29). Per window w and head h, with q, k, v in their
// native (Bw, N, H, D) layout and q already scaled:
//   s = q k^T + bias[h] (+ mask[w mod nW]);  p = softmax(s) in float32;
//   out = p (rounded to the operand type, as the TPU kernel rounds) . v
//
// What bounds it on this card: bytes. A window's scores never leave the SM,
// so the kernel must move q, k, v and out once (4 N H D elements per window)
// plus the bias; its two products (N x N x D each) are far below the
// tensor-core rate. On the main path it runs only in Swin stage 3 (N 36,
// H 48, D 32, 20 windows for two clips): 960 (window, head) pairs of a few
// KB each, so what costs is filling the card and the latency of each load,
// not bandwidth.
//
// Design (window_tile.cuh): one warp per 16 query rows; a block takes
// WinPack<NKB>::P pairs (2 at N 36: 6 warps), so the main-path call is 480
// blocks of 6 well-filled warps in one wave. Each block stages its pairs'
// q, k, v with cp.async (16-byte copies, L1 bypassed) into padded tiles,
// then each warp computes its scores on tensor cores into registers, takes
// the softmax there and multiplies p by v on tensor cores. N is padded to
// 16 (pad keys at -inf), D to the k-step (zeros). For bf16 both products are
// bf16 mma.sync with float32 accumulation and p rounded to bf16, which is
// the TPU kernel's arithmetic; for float32 they are 3xTF32 mma.sync, which
// keeps float32 accuracy (TF32 alone does not).
#include "window_tile.cuh"

namespace dgsct {
namespace {

template <typename T, int NKB>
__global__ void __launch_bounds__(WinPack<NKB>::kThreads, WinPack<NKB>::kMinBlocks)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ bias,
                        const T* __restrict__ mask, T* __restrict__ out, int pairs, int N,
                        int H, int D, int nW) {
  using Pack = WinPack<NKB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int tile = Pack::NP * WinTile<T>::stride(D), pair_elems = WinTile<T>::kTiles * tile;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int pair0 = blockIdx.x * Pack::P;
  const size_t ld = static_cast<size_t>(H) * D;  // token stride
  auto base = [&](int pr) {                       // (window, head) -> row 0 of its tile
    const int w = pr / H, h = pr - w * H;
    return static_cast<size_t>(w) * N * ld + static_cast<size_t>(h) * D;
  };

#pragma unroll
  for (int p = 0; p < Pack::P; ++p) {
    if (pair0 + p < pairs) {
      const size_t b = base(pair0 + p);
      T* tp = smem + p * pair_elems;
      load_tile(tp, q + b, ld, N, Pack::NP, D, tid, Pack::kThreads);
      load_tile(tp + WinTile<T>::kSlotK * tile, k + b, ld, N, Pack::NP, D, tid, Pack::kThreads);
      load_tile(tp + WinTile<T>::kSlotV * tile, v + b, ld, N, Pack::NP, D, tid, Pack::kThreads);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (std::is_same<T, float>::value) {  // q is scaled already
    prepare_rows<NKB>(smem, min(Pack::P, pairs - pair0), N, D, false, [](int) { return 1.f; },
                      warp, Pack::kWarps);
    __syncthreads();
  }

  const int p = warp / NKB, pr = pair0 + p;
  if (pr >= pairs) return;
  const int w = pr / H, h = pr - w * H;
  T* ob = out + base(pr);
  attend_rows<NKB>(smem + p * pair_elems, N, D, 16 * (warp - p * NKB),
                   bias + static_cast<size_t>(h) * N * N,
                   mask ? mask + static_cast<size_t>(w % nW) * N * N : nullptr,
                   [&](int row, int d, float o0, float o1) { store2(ob + row * ld + d, o0, o1); });
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
           void* out, int Bw, int N, int H, int D, int nW, cudaStream_t stream) {
  if (D % 8 || D > kMaxHeadDim) return cudaErrorInvalidValue;
  return with_nkb(N, [&](auto nkb) {
    constexpr int NKB = decltype(nkb)::value;
    using Pack = WinPack<NKB>;
    const size_t smem = Pack::template smem_bytes<T>(D);
    auto kern = window_attention_kernel<T, NKB>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    const int pairs = Bw * H;
    kern<<<(pairs + Pack::P - 1) / Pack::P, Pack::kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(bias), static_cast<const T*>(mask), static_cast<T*>(out), pairs,
        N, H, D, nW);
    return cudaGetLastError();
  });
}

}  // namespace
}  // namespace dgsct

// q, k, v, out: (Bw, N, H, D), 16-byte aligned, D a multiple of 8 and
// <= 32, N <= 144; bias: (H, N, N); mask: (nW, N, N) or null.
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
