// Host-side data kernels of the capture loader, built with the host C++
// compiler (ops/cuda_lib.py HostLib) and bound by ctypes (native.py):
//
//   ava_resize_bilinear_u8 — uint8 HWC bilinear resize (half-pixel centres),
//                            the same arithmetic as ava256_tpu/native/dataio.cpp
//                            (built with the same flags, so both round alike)
//   ava_png_unfilter       — undo the PNG row filters (types 0-4) of an
//                            inflated 8-bit image
//
// The camera images of a capture are 4096 x 2668; a PNG's Sub, Average and
// Paeth filters are sequential in each row, which Python or numpy cannot run
// at a usable speed.

#include <cstdint>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Bilinear resize, half-pixel centers, uint8 HWC.
void ava_resize_bilinear_u8(const uint8_t* src, int64_t sh, int64_t sw,
                            int64_t ch, uint8_t* dst, int64_t dh, int64_t dw) {
  const float scale_y = static_cast<float>(sh) / dh;
  const float scale_x = static_cast<float>(sw) / dw;
  std::vector<int64_t> x0s(dw), x1s(dw);
  std::vector<float> wxs(dw);
  for (int64_t x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * scale_x - 0.5f;
    float floor_fx = std::floor(fx);
    int64_t x0 = static_cast<int64_t>(floor_fx);
    wxs[x] = fx - floor_fx;
    x0s[x] = x0 < 0 ? 0 : (x0 > sw - 1 ? sw - 1 : x0);
    int64_t x1 = x0 + 1;
    x1s[x] = x1 < 0 ? 0 : (x1 > sw - 1 ? sw - 1 : x1);
  }
  for (int64_t y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * scale_y - 0.5f;
    float floor_fy = std::floor(fy);
    int64_t y0 = static_cast<int64_t>(floor_fy);
    float wy = fy - floor_fy;
    y0 = y0 < 0 ? 0 : (y0 > sh - 1 ? sh - 1 : y0);
    int64_t y1 = y0 + 1;
    y1 = y1 < 0 ? 0 : (y1 > sh - 1 ? sh - 1 : y1);
    const uint8_t* r0 = src + y0 * sw * ch;
    const uint8_t* r1 = src + y1 * sw * ch;
    uint8_t* drow = dst + y * dw * ch;
    for (int64_t x = 0; x < dw; ++x) {
      const float wx = wxs[x];
      const uint8_t* p00 = r0 + x0s[x] * ch;
      const uint8_t* p01 = r0 + x1s[x] * ch;
      const uint8_t* p10 = r1 + x0s[x] * ch;
      const uint8_t* p11 = r1 + x1s[x] * ch;
      for (int64_t c = 0; c < ch; ++c) {
        float top = p00[c] + (p01[c] - p00[c]) * wx;
        float bot = p10[c] + (p11[c] - p10[c]) * wx;
        float v = top + (bot - top) * wy;
        drow[x * ch + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// The PNG specification's Paeth predictor.
static inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// src: h rows of (1 filter-type byte + rowbytes bytes), as inflated from the
// IDAT stream; dst: h * rowbytes bytes; bpp: bytes per pixel (>= 1). Returns
// 0, or row + 1 of the first row whose filter type is not 0-4 (dst is then
// filled up to that row).
int64_t ava_png_unfilter(const uint8_t* src, int64_t h, int64_t rowbytes, int64_t bpp,
                         uint8_t* dst) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t ftype = src[y * (rowbytes + 1)];
    const uint8_t* in = src + y * (rowbytes + 1) + 1;
    uint8_t* out = dst + y * rowbytes;
    const uint8_t* up = y > 0 ? out - rowbytes : nullptr;  // the row above, unfiltered
    switch (ftype) {
      case 0:  // None
        std::memcpy(out, in, static_cast<size_t>(rowbytes));
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int64_t i = 0; i < rowbytes; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (up ? up[i] : 0));
        break;
      case 3:  // Average
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          out[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          out[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
