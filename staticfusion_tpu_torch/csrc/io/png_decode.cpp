// Minimal PNG decoder for the dataset loader: 8-bit RGB/RGBA/gray and
// 16-bit grayscale (TUM depth), zlib inflate + standard unfiltering.
//
// TPU-native counterpart of the reference's OpenCV imread path
// (FrontEnd.cpp:220,240); implemented from the PNG spec, no image library.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  uint32_t u32() {
    if (off + 4 > n) { ok = false; return 0; }
    uint32_t v = (uint32_t(p[off]) << 24) | (uint32_t(p[off + 1]) << 16) |
                 (uint32_t(p[off + 2]) << 8) | uint32_t(p[off + 3]);
    off += 4;
    return v;
  }
};

int paeth(int a, int b, int c) {
  int pp = a + b - c;
  int pa = abs(pp - a), pb = abs(pp - b), pc = abs(pp - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" {

// Decodes a PNG file. Returns 0 on success. Caller frees *out with sf_free.
// channels: 1 (gray), 3 (rgb). bitdepth: 8 or 16. 16-bit output is
// host-endian uint16 (PNG big-endian converted).
int sf_decode_png(const char* path, uint8_t** out, int* width, int* height,
                  int* channels, int* bitdepth) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (fread(buf.data(), 1, fsize, f) != size_t(fsize)) { fclose(f); return -2; }
  fclose(f);

  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (fsize < 8 || memcmp(buf.data(), magic, 8) != 0) return -3;

  Reader r{buf.data(), size_t(fsize), 8};
  uint32_t w = 0, h = 0;
  int depth = 0, color = -1, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;

  while (r.ok && r.off + 8 <= r.n) {
    uint32_t len = r.u32();
    if (r.off + 4 > r.n) break;
    char type[5] = {0};
    memcpy(type, r.p + r.off, 4);
    r.off += 4;
    if (r.off + len + 4 > r.n) break;
    const uint8_t* data = r.p + r.off;

    if (strcmp(type, "IHDR") == 0 && len >= 13) {
      w = (uint32_t(data[0]) << 24) | (data[1] << 16) | (data[2] << 8) | data[3];
      h = (uint32_t(data[4]) << 24) | (data[5] << 16) | (data[6] << 8) | data[7];
      depth = data[8];
      color = data[9];
      interlace = data[12];
    } else if (strcmp(type, "PLTE") == 0) {
      palette.assign(data, data + len);
    } else if (strcmp(type, "IDAT") == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (strcmp(type, "IEND") == 0) {
      break;
    }
    r.off += len + 4;  // skip data + crc
  }

  if (w == 0 || h == 0 || interlace != 0) return -4;
  // color types: 0 gray, 2 rgb, 3 palette, 4 gray+alpha, 6 rgba
  int src_ch;
  switch (color) {
    case 0: src_ch = 1; break;
    case 2: src_ch = 3; break;
    case 3: src_ch = 1; break;
    case 4: src_ch = 2; break;
    case 6: src_ch = 4; break;
    default: return -5;
  }
  if (depth != 8 && depth != 16) return -6;
  if (color == 3 && depth != 8) return -6;

  const size_t bpp = size_t(src_ch) * depth / 8;      // bytes per pixel
  const size_t stride = size_t(w) * bpp;              // bytes per row
  std::vector<uint8_t> raw(h * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())  // short inflate = truncated image data
    return -7;

  // Unfilter in place into `img`.
  std::vector<uint8_t> img(h * stride);
  const uint8_t* prev = nullptr;
  for (uint32_t y = 0; y < h; y++) {
    const uint8_t* src = raw.data() + y * (stride + 1);
    uint8_t filter = src[0];
    src++;
    uint8_t* dst = img.data() + y * stride;
    switch (filter) {
      case 0:
        memcpy(dst, src, stride);
        break;
      case 1:
        for (size_t i = 0; i < stride; i++)
          dst[i] = src[i] + (i >= bpp ? dst[i - bpp] : 0);
        break;
      case 2:
        for (size_t i = 0; i < stride; i++)
          dst[i] = src[i] + (prev ? prev[i] : 0);
        break;
      case 3:
        for (size_t i = 0; i < stride; i++) {
          int a = i >= bpp ? dst[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          dst[i] = src[i] + ((a + b) >> 1);
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; i++) {
          int a = i >= bpp ? dst[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          dst[i] = src[i] + paeth(a, b, c);
        }
        break;
      default:
        return -8;
    }
    prev = dst;
  }

  // Convert to output: gray (1ch) or rgb (3ch); drop alpha; expand palette;
  // 16-bit big-endian -> host.
  int out_ch = (color == 2 || color == 3 || color == 6) ? 3 : 1;
  int out_depth = depth;
  if (color == 3) out_depth = 8;
  size_t out_px_bytes = size_t(out_ch) * out_depth / 8;
  uint8_t* o = (uint8_t*)malloc(size_t(w) * h * out_px_bytes);
  if (!o) return -9;

  for (uint32_t y = 0; y < h; y++) {
    const uint8_t* s = img.data() + y * stride;
    uint8_t* d = o + size_t(y) * w * out_px_bytes;
    for (uint32_t x = 0; x < w; x++) {
      if (color == 3) {
        uint8_t idx = s[x];
        if (size_t(idx) * 3 + 2 < palette.size()) {
          d[x * 3] = palette[idx * 3];
          d[x * 3 + 1] = palette[idx * 3 + 1];
          d[x * 3 + 2] = palette[idx * 3 + 2];
        } else {
          d[x * 3] = d[x * 3 + 1] = d[x * 3 + 2] = 0;
        }
      } else if (depth == 8) {
        for (int ch = 0; ch < out_ch; ch++)
          d[x * out_ch + ch] = s[x * src_ch + ch];
      } else {  // 16-bit
        for (int ch = 0; ch < out_ch; ch++) {
          uint16_t v = (uint16_t(s[(x * src_ch + ch) * 2]) << 8) |
                       s[(x * src_ch + ch) * 2 + 1];
          ((uint16_t*)d)[x * out_ch + ch] = v;
        }
      }
    }
  }

  *out = o;
  *width = int(w);
  *height = int(h);
  *channels = out_ch;
  *bitdepth = out_depth;
  return 0;
}

void sf_free(void* p) { free(p); }

}  // extern "C"
