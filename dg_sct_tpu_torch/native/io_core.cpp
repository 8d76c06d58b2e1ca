// Native data-loader core of dg_sct_tpu_torch: JPEG decode, PIL-compatible
// ANTIALIASED bicubic resize and ImageNet normalize (the transform of
// DG-SCT/AVE/dataloader.py:61-64,162-171) as batched, threaded C++ routines
// bound with ctypes, so that decode keeps up with the card. A copy of
// dg_sct_tpu/native/io_core.cpp; the batched loaders write their shared
// `status` with `omp atomic` only.
//
// Build (native/__init__.py, at first use):
//   g++ -O3 -march=x86-64-v3 -fno-math-errno -shared -fPIC -fopenmp io_core.cpp -ljpeg

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// PIL-style cubic kernel (a = -0.5, matching Pillow's BICUBIC).
inline double cubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// One axis of PIL's antialiased resampling: precompute per-output-pixel tap
// windows with support scaled by the downscale factor. Coefficients are
// computed in double (Pillow-matching) and stored as float: the two passes
// quantize to 8bpc anyway, so float32 accumulation is below the
// quantization floor, and float taps let the hot loops run SIMD.
struct Taps {
  std::vector<int> bounds;    // (xmin, xsize) per output pixel
  std::vector<float> coeffs;  // ksize coeffs per output pixel
  int ksize = 0;
};

Taps make_taps(int in_size, int out_size) {
  Taps t;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  t.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.bounds.resize(2 * out_size);
  t.coeffs.assign(static_cast<size_t>(out_size) * t.ksize, 0.0f);
  std::vector<double> kd(t.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
    int xmax = static_cast<int>(std::min<double>(in_size, std::ceil(center + support)));
    int xsize = xmax - xmin;
    float* k = &t.coeffs[static_cast<size_t>(xx) * t.ksize];
    double ww = 0.0;
    for (int x = 0; x < xsize; ++x) {
      kd[x] = cubic((x + xmin - center + 0.5) / filterscale);
      ww += kd[x];
    }
    for (int x = 0; x < xsize; ++x)
      k[x] = static_cast<float>(ww != 0.0 ? kd[x] / ww : kd[x]);
    t.bounds[2 * xx] = xmin;
    t.bounds[2 * xx + 1] = xsize;
  }
  return t;
}

// Separable antialiased resize (H, W, 3) uint8 -> (out, out, 3) float.
void resize_bicubic(const uint8_t* src, int h, int w, float* dst, int out) {
  Taps tw = make_taps(w, out);
  Taps th = make_taps(h, out);
  const int out3 = out * 3;
  // horizontal pass: (h, out, 3). The row is converted u8->f32 once so the
  // tap loop is a pure float FMA chain.
  std::vector<float> tmp(static_cast<size_t>(h) * out3);
  std::vector<float> rowf(static_cast<size_t>(w) * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    for (int i = 0; i < w * 3; ++i) rowf[i] = row[i];  // vectorized convert
    float* trow = &tmp[static_cast<size_t>(y) * out3];
    for (int xx = 0; xx < out; ++xx) {
      const int xmin = tw.bounds[2 * xx], xsize = tw.bounds[2 * xx + 1];
      const float* k = &tw.coeffs[static_cast<size_t>(xx) * tw.ksize];
      const float* p = &rowf[static_cast<size_t>(xmin) * 3];
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int x = 0; x < xsize; ++x) {
        const float kx = k[x];
        a0 += p[x * 3 + 0] * kx;
        a1 += p[x * 3 + 1] * kx;
        a2 += p[x * 3 + 2] * kx;
      }
      // Pillow quantizes to uint8 between the two passes (8bpc fixed point)
      trow[xx * 3 + 0] = std::min(255.0f, std::max(0.0f, std::floor(a0 + 0.5f)));
      trow[xx * 3 + 1] = std::min(255.0f, std::max(0.0f, std::floor(a1 + 0.5f)));
      trow[xx * 3 + 2] = std::min(255.0f, std::max(0.0f, std::floor(a2 + 0.5f)));
    }
  }
  // vertical pass: tap-outer / pixel-inner so each step is a contiguous
  // width-out3 SIMD axpy on the destination row.
  for (int yy = 0; yy < out; ++yy) {
    const int ymin = th.bounds[2 * yy], ysize = th.bounds[2 * yy + 1];
    const float* k = &th.coeffs[static_cast<size_t>(yy) * th.ksize];
    float* drow = dst + static_cast<size_t>(yy) * out3;
    {
      const float k0 = k[0];
      const float* trow = &tmp[static_cast<size_t>(ymin) * out3];
      for (int xx = 0; xx < out3; ++xx) drow[xx] = trow[xx] * k0;
    }
    for (int y = 1; y < ysize; ++y) {
      const float ky = k[y];
      const float* trow = &tmp[static_cast<size_t>(ymin + y) * out3];
      for (int xx = 0; xx < out3; ++xx) drow[xx] += trow[xx] * ky;
    }
  }
}

// target > 0 enables DCT-domain scaled decoding: pick the smallest m/8 scale
// whose output still covers `target` on the short side, so the IDCT + color
// conversion run at a fraction of full-resolution cost (the dominant host
// cost per frame). target <= 0 decodes at full size (bit-parity path).
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* out,
                 int* h, int* w, int target = 0,
                 J_COLOR_SPACE color_space = JCS_RGB) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = color_space;
  if (target > 0) {
    const int short_side = std::min<int>(cinfo.image_height, cinfo.image_width);
    int m = 8;
    while (m > 1 && (short_side * (m - 1)) / 8 >= target) --m;
    // libjpeg-turbo's SIMD IDCT covers 1/8, 2/8, 4/8, 8/8 only; intermediate
    // m values hit a scalar C path that is SLOWER than full decode (measured
    // in perf/decode_phases.cpp). Round up to the nearest SIMD-fast scale —
    // the slightly larger intermediate is cheap for the SIMD resize.
    m = m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : 8;
    cinfo.scale_num = m;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  out->resize(static_cast<size_t>(*h) * *w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowp = out->data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Same separable antialiased resize, storing rounded uint8 (the device
// normalizes; shipping uint8 quarters the host->device transfer).
void resize_bicubic_u8(const uint8_t* src, int h, int w, uint8_t* dst, int out) {
  std::vector<float> tmp(static_cast<size_t>(out) * out * 3);
  resize_bicubic(src, h, w, tmp.data(), out);
  for (size_t i = 0; i < tmp.size(); ++i)
    dst[i] = static_cast<uint8_t>(
        std::min(255.0f, std::max(0.0f, std::round(tmp[i]))));
}

}  // namespace

extern "C" {

// Resize + normalize an already-decoded uint8 RGB image.
// src: (h, w, 3) uint8; dst: (out, out, 3) float32 = (x/255 - mean)/std.
int dgsct_resize_normalize(const uint8_t* src, int h, int w, float* dst,
                           int out, const float* mean, const float* std_) {
  std::vector<float> resized(static_cast<size_t>(out) * out * 3);
  resize_bicubic(src, h, w, resized.data(), out);
  for (int i = 0; i < out * out; ++i)
    for (int c = 0; c < 3; ++c) {
      float v = std::min(255.0f, std::max(0.0f, resized[i * 3 + c])) / 255.0f;
      dst[i * 3 + c] = (v - mean[c]) / std_[c];
    }
  return 0;
}

// Decode one JPEG buffer, resize to (out, out), normalize into dst.
int dgsct_decode_jpeg(const uint8_t* data, long len, float* dst, int out,
                      const float* mean, const float* std_) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (!decode_jpeg(data, static_cast<size_t>(len), &rgb, &h, &w)) return -1;
  return dgsct_resize_normalize(rgb.data(), h, w, dst, out, mean, std_);
}

// Fast serving path: DCT-scaled decode + antialiased resize to uint8.
// dst: (out, out, 3) uint8. Normalization happens on the device
// (ops/basic.normalize_frames_u8), so the host does the least work per frame.
int dgsct_decode_jpeg_u8(const uint8_t* data, long len, uint8_t* dst, int out) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (!decode_jpeg(data, static_cast<size_t>(len), &rgb, &h, &w, out))
    return -1;
  resize_bicubic_u8(rgb.data(), h, w, dst, out);
  return 0;
}

// YUV420 serving ingest: decode at DCT-scaled size in JCS_YCbCr (libjpeg
// skips its color-conversion pass), antialias-resize the interleaved YCbCr
// to (out, out, 3), then emit a full-res Y plane and a 2x2-mean subsampled
// interleaved CbCr plane (out/2, out/2, 2).  Halves the host->device bytes
// vs interleaved RGB; the device reconstructs RGB with a chroma upsample by
// two resize products and one affine (ops/basic.normalize_frames_yuv420). `out` must be even.
int dgsct_decode_jpeg_yuv420(const uint8_t* data, long len, uint8_t* y_dst,
                             uint8_t* uv_dst, int out) {
  std::vector<uint8_t> ycc;
  int h = 0, w = 0;
  if (!decode_jpeg(data, static_cast<size_t>(len), &ycc, &h, &w, out,
                   JCS_YCbCr))
    return -1;
  std::vector<uint8_t> r(static_cast<size_t>(out) * out * 3);
  resize_bicubic_u8(ycc.data(), h, w, r.data(), out);
  for (int i = 0; i < out * out; ++i) y_dst[i] = r[static_cast<size_t>(i) * 3];
  const int half = out / 2;
  for (int yy = 0; yy < half; ++yy)
    for (int xx = 0; xx < half; ++xx) {
      const size_t i00 = (static_cast<size_t>(2 * yy) * out + 2 * xx) * 3;
      const size_t i01 = i00 + 3;
      const size_t i10 = i00 + static_cast<size_t>(out) * 3;
      const size_t i11 = i10 + 3;
      for (int c = 1; c <= 2; ++c) {
        const int s = r[i00 + c] + r[i01 + c] + r[i10 + c] + r[i11 + c];
        uv_dst[(static_cast<size_t>(yy) * half + xx) * 2 + (c - 1)] =
            static_cast<uint8_t>((s + 2) >> 2);
      }
    }
  return 0;
}

// Batched YUV420 loader: y (n, out, out) + uv (n, out/2, out/2, 2) uint8.
int dgsct_load_jpeg_batch_yuv420(const char** paths, int n, uint8_t* y_dst,
                                 uint8_t* uv_dst, int out) {
  int status = 0;
  const size_t ystride = static_cast<size_t>(out) * out;
  const size_t uvstride = static_cast<size_t>(out / 2) * (out / 2) * 2;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    FILE* f = fopen(paths[i], "rb");
    if (!f) {
#pragma omp atomic write
      status = -1;
      continue;
    }
    fseek(f, 0, SEEK_END);
    long len = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(static_cast<size_t>(len));
    const size_t got = fread(buf.data(), 1, static_cast<size_t>(len), f);
    fclose(f);
    if (got != static_cast<size_t>(len) ||
        dgsct_decode_jpeg_yuv420(buf.data(), len, y_dst + i * ystride,
                                 uv_dst + i * uvstride, out) != 0) {
#pragma omp atomic write
      status = -1;
    }
  }
  return status;
}

// Batched uint8 loader: (n, out, out, 3) uint8, parallel over files.
int dgsct_load_jpeg_batch_u8(const char** paths, int n, uint8_t* dst, int out) {
  int status = 0;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    FILE* f = fopen(paths[i], "rb");
    if (!f) {
#pragma omp atomic write
      status = -1;
      continue;
    }
    fseek(f, 0, SEEK_END);
    long len = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(len);
    size_t got = fread(buf.data(), 1, len, f);
    fclose(f);
    if (static_cast<long>(got) != len ||
        dgsct_decode_jpeg_u8(buf.data(), len,
                             dst + static_cast<size_t>(i) * out * out * 3,
                             out) != 0) {
#pragma omp atomic write
      status = -1;
    }
  }
  return status;
}

// Batched file loader: decode `n` JPEG files into (n, out, out, 3) float32,
// parallel over files.
int dgsct_load_jpeg_batch(const char** paths, int n, float* dst, int out,
                          const float* mean, const float* std_) {
  int status = 0;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    FILE* f = fopen(paths[i], "rb");
    if (!f) {
#pragma omp atomic write
      status = -1;
      continue;
    }
    fseek(f, 0, SEEK_END);
    long len = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(len);
    size_t got = fread(buf.data(), 1, len, f);
    fclose(f);
    if (static_cast<long>(got) != len ||
        dgsct_decode_jpeg(buf.data(), len, dst + static_cast<size_t>(i) * out * out * 3,
                          out, mean, std_) != 0) {
#pragma omp atomic write
      status = -1;
    }
  }
  return status;
}

}  // extern "C"
