// Native image-output backend for openglraytracer_tpu.
//
// This is the JAX build's counterpart of the reference's C++ host-side
// presentation path (the RGBA8 screen texture + blit in main.cpp:122-207,
// 243-260 of blubs/OpenGLRaytracer): the device delivers float RGB, and this
// library quantizes, row-flips (GL row 0 = bottom -> PNG row 0 = top), and
// PNG-encodes it at native speed. Exposed via a C ABI for ctypes.
//
// Build: make -C native   (produces libimageio.so; zlib is the only dep)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <zlib.h>

namespace {

inline uint32_t be32(uint32_t v) {
  return ((v & 0xFF) << 24) | ((v & 0xFF00) << 8) | ((v >> 8) & 0xFF00) |
         (v >> 24);
}

struct Buf {
  uint8_t* data;
  size_t size;
  size_t cap;
  void put(const void* p, size_t n) {
    if (size + n > cap) {
      cap = (size + n) * 2;
      data = static_cast<uint8_t*>(realloc(data, cap));
    }
    memcpy(data + size, p, n);
    size += n;
  }
};

void put_chunk(Buf* b, const char tag[4], const uint8_t* data, size_t n) {
  uint32_t len = be32(static_cast<uint32_t>(n));
  b->put(&len, 4);
  size_t crc_start = b->size;
  b->put(tag, 4);
  if (n) b->put(data, n);
  uint32_t crc = crc32(0L, b->data + crc_start, static_cast<uInt>(n + 4));
  crc = be32(crc);
  b->put(&crc, 4);
}

}  // namespace

extern "C" {

// float RGB (h, w, 3) in [0,1], row 0 = bottom -> uint8 (h, w, 3) row 0 = top
void oglrt_tonemap_u8(const float* src, uint8_t* dst, int h, int w) {
  for (int y = 0; y < h; ++y) {
    const float* in = src + static_cast<size_t>(h - 1 - y) * w * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * w * 3;
    for (int i = 0; i < w * 3; ++i) {
      float v = in[i];
      v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
      out[i] = static_cast<uint8_t>(v * 255.0f + 0.5f);
    }
  }
}

// Encode (h, w, 3) uint8 top-first rows to PNG. Returns malloc'd buffer in
// *out (caller frees with oglrt_free); returns byte size, or -1 on error.
long oglrt_encode_png(const uint8_t* rgb, int h, int w, uint8_t** out) {
  // Filter-0 scanlines
  size_t stride = static_cast<size_t>(w) * 3;
  size_t raw_size = (stride + 1) * h;
  uint8_t* raw = static_cast<uint8_t*>(malloc(raw_size));
  if (!raw) return -1;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw + static_cast<size_t>(y) * (stride + 1);
    row[0] = 0;
    memcpy(row + 1, rgb + static_cast<size_t>(y) * stride, stride);
  }

  uLongf comp_cap = compressBound(static_cast<uLong>(raw_size));
  uint8_t* comp = static_cast<uint8_t*>(malloc(comp_cap));
  if (!comp) {
    free(raw);
    return -1;
  }
  if (compress2(comp, &comp_cap, raw, static_cast<uLong>(raw_size), 6) !=
      Z_OK) {
    free(raw);
    free(comp);
    return -1;
  }
  free(raw);

  Buf b{static_cast<uint8_t*>(malloc(1 << 16)), 0, 1 << 16};
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  b.put(sig, 8);

  uint8_t ihdr[13];
  uint32_t wbe = be32(w), hbe = be32(h);
  memcpy(ihdr, &wbe, 4);
  memcpy(ihdr + 4, &hbe, 4);
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(&b, "IHDR", ihdr, 13);
  put_chunk(&b, "IDAT", comp, comp_cap);
  put_chunk(&b, "IEND", nullptr, 0);
  free(comp);

  *out = b.data;
  return static_cast<long>(b.size);
}

void oglrt_free(uint8_t* p) { free(p); }

}  // extern "C"
