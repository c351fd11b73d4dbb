// Self-contained PNG/PPM codec for the native runner, the port's own copy
// of the JAX package's native/image_io.cc. PNG support covers what the
// pipeline needs: 8-bit depth, color types 0 (gray), 2 (RGB), 6 (RGBA), no
// interlacing; all five scanline filters. Compression via the system zlib.

#include "image_io.h"

#include <zlib.h>

#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace vstimg {
namespace {

uint32_t rd_be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

void wr_be32(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)(v >> 24);
  p[1] = (uint8_t)(v >> 16);
  p[2] = (uint8_t)(v >> 8);
  p[3] = (uint8_t)v;
}

bool read_file(const std::string& path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize((size_t)n);
  size_t got = n > 0 ? std::fread(out->data(), 1, (size_t)n, f) : 0;
  std::fclose(f);
  return got == (size_t)n;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool inflate_all(const uint8_t* src, size_t n, std::vector<uint8_t>* dst) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)n;
  zs.next_out = dst->data();
  zs.avail_out = (uInt)dst->size();
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.avail_out == 0;
}

bool load_png(const std::vector<uint8_t>& buf, Image* out, std::string* err) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 || std::memcmp(buf.data(), sig, 8) != 0) {
    *err = "not a PNG";
    return false;
  }
  uint32_t w = 0, h = 0;
  int bit_depth = 0, color = -1;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 8 <= buf.size()) {
    uint32_t len = rd_be32(&buf[pos]);
    if (pos + 12 + len > buf.size()) break;
    const char* type = (const char*)&buf[pos + 4];
    const uint8_t* data = &buf[pos + 8];
    if (!std::memcmp(type, "IHDR", 4)) {
      w = rd_be32(data);
      h = rd_be32(data + 4);
      bit_depth = data[8];
      color = data[9];
      if (bit_depth != 8) { *err = "only 8-bit PNG supported"; return false; }
      if (color != 0 && color != 2 && color != 6) {
        *err = "only gray/RGB/RGBA PNG supported";
        return false;
      }
      if (data[12] != 0) { *err = "interlaced PNG unsupported"; return false; }
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (!w || !h || idat.empty()) { *err = "malformed PNG"; return false; }
  int ch = color == 0 ? 1 : (color == 2 ? 3 : 4);
  size_t stride = (size_t)w * ch;
  std::vector<uint8_t> raw((stride + 1) * h);
  if (!inflate_all(idat.data(), idat.size(), &raw)) {
    *err = "PNG inflate failed";
    return false;
  }
  // un-filter in place into `pix`
  std::vector<uint8_t> pix(stride * h);
  for (uint32_t y = 0; y < h; y++) {
    uint8_t filt = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* cur = &pix[y * stride];
    const uint8_t* up = y ? &pix[(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= (size_t)ch ? cur[x - ch] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= (size_t)ch) ? up[x - ch] : 0;
      int v = src[x];
      switch (filt) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: *err = "bad PNG filter"; return false;
      }
      cur[x] = (uint8_t)v;
    }
  }
  out->w = (int)w;
  out->h = (int)h;
  out->rgb.resize((size_t)w * h * 3);
  for (size_t i = 0; i < (size_t)w * h; i++) {
    const uint8_t* p = &pix[i * ch];
    float r = p[0] / 255.0f;
    float g = ch >= 3 ? p[1] / 255.0f : r;
    float b2 = ch >= 3 ? p[2] / 255.0f : r;
    out->rgb[i * 3 + 0] = r;
    out->rgb[i * 3 + 1] = g;
    out->rgb[i * 3 + 2] = b2;
  }
  return true;
}

bool load_ppm(const std::vector<uint8_t>& buf, Image* out, std::string* err) {
  // P6\n<w> <h>\n<max>\n<binary RGB>
  if (buf.size() < 2 || buf[0] != 'P' || buf[1] != '6') {
    *err = "not a P6 PPM";
    return false;
  }
  size_t pos = 2;
  long vals[3];
  for (int k = 0; k < 3; k++) {
    while (pos < buf.size() &&
           (std::isspace(buf[pos]) || buf[pos] == '#')) {
      if (buf[pos] == '#') {
        while (pos < buf.size() && buf[pos] != '\n') pos++;
      } else {
        pos++;
      }
    }
    long v = 0;
    while (pos < buf.size() && std::isdigit(buf[pos]))
      v = v * 10 + (buf[pos++] - '0');
    vals[k] = v;
  }
  pos++;  // single whitespace after maxval
  long w = vals[0], h = vals[1], maxv = vals[2];
  if (w <= 0 || h <= 0 || maxv != 255 ||
      pos + (size_t)(w * h * 3) > buf.size()) {
    *err = "malformed PPM";
    return false;
  }
  out->w = (int)w;
  out->h = (int)h;
  out->rgb.resize((size_t)w * h * 3);
  for (size_t i = 0; i < (size_t)w * h * 3; i++)
    out->rgb[i] = buf[pos + i] / 255.0f;
  return true;
}

}  // namespace

bool load_image(const std::string& path, Image* out, std::string* err) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) {
    *err = "cannot read " + path;
    return false;
  }
  if (buf.size() >= 2 && buf[0] == 'P' && buf[1] == '6')
    return load_ppm(buf, out, err);
  if (!load_png(buf, out, err)) {
    *err += " (supported inputs: 8-bit PNG, P6 PPM)";
    return false;
  }
  return true;
}

bool save_png(const std::string& path, const Image& img, std::string* err) {
  size_t stride = (size_t)img.w * 3;
  std::vector<uint8_t> raw((stride + 1) * img.h);
  for (int y = 0; y < img.h; y++) {
    raw[y * (stride + 1)] = 0;  // filter: none
    for (size_t x = 0; x < stride; x++) {
      float v = img.rgb[y * stride + x];
      v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
      raw[y * (stride + 1) + 1 + x] = (uint8_t)(v * 255.0f + 0.5f);
    }
  }
  uLongf zlen = compressBound((uLong)raw.size());
  std::vector<uint8_t> z(zlen);
  if (compress2(z.data(), &zlen, raw.data(), (uLong)raw.size(), 6) != Z_OK) {
    *err = "deflate failed";
    return false;
  }
  z.resize(zlen);

  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) { *err = "cannot write " + path; return false; }
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  std::fwrite(sig, 1, 8, f);
  auto chunk = [&](const char* type, const uint8_t* data, uint32_t len) {
    uint8_t hdr[8];
    wr_be32(hdr, len);
    std::memcpy(hdr + 4, type, 4);
    std::fwrite(hdr, 1, 8, f);
    if (len) std::fwrite(data, 1, len, f);
    uLong crc = crc32(0, (const Bytef*)type, 4);
    if (len) crc = crc32(crc, data, len);
    uint8_t cb[4];
    wr_be32(cb, (uint32_t)crc);
    std::fwrite(cb, 1, 4, f);
  };
  uint8_t ihdr[13];
  wr_be32(ihdr, (uint32_t)img.w);
  wr_be32(ihdr + 4, (uint32_t)img.h);
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  chunk("IHDR", ihdr, 13);
  chunk("IDAT", z.data(), (uint32_t)z.size());
  chunk("IEND", nullptr, 0);
  std::fclose(f);
  return true;
}

Image resize_bilinear(const Image& src, int new_h, int new_w) {
  if (src.h == new_h && src.w == new_w) return src;
  Image dst;
  dst.h = new_h;
  dst.w = new_w;
  dst.rgb.resize((size_t)new_h * new_w * 3);
  float sy = (float)src.h / new_h, sx = (float)src.w / new_w;
  for (int y = 0; y < new_h; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= src.h ? src.h - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= src.h ? src.h - 1 : y0 + 1);
    for (int x = 0; x < new_w; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)std::floor(fx);
      float wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 >= src.w ? src.w - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 >= src.w ? src.w - 1 : x0 + 1);
      for (int c = 0; c < 3; c++) {
        float a = src.rgb[(y0c * src.w + x0c) * 3 + c];
        float b = src.rgb[(y0c * src.w + x1c) * 3 + c];
        float d = src.rgb[(y1c * src.w + x0c) * 3 + c];
        float e = src.rgb[(y1c * src.w + x1c) * 3 + c];
        dst.rgb[((size_t)y * new_w + x) * 3 + c] =
            (a * (1 - wx) + b * wx) * (1 - wy) +
            (d * (1 - wx) + e * wx) * wy;
      }
    }
  }
  return dst;
}

}  // namespace vstimg
