// Minimal standalone image I/O for the native runner (main.cc): 8-bit PNG
// (gray/RGB/RGBA, non-interlaced; zlib for inflate/deflate) and binary
// PPM (P6), plus bilinear resize. The port's own copy of the JAX
// package's native/image_io.h, unchanged in behaviour.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace vstimg {

struct Image {
  int w = 0, h = 0;          // pixels
  std::vector<float> rgb;    // h*w*3, row-major, [0, 1]
};

// Decode a PNG or PPM file by extension/signature. Returns false and sets
// `err` on failure (unsupported bit depth / interlace / format).
bool load_image(const std::string& path, Image* out, std::string* err);

// Write an 8-bit RGB PNG (values clamped to [0,1]).
bool save_png(const std::string& path, const Image& img, std::string* err);

// Bilinear resize (align_corners=false pixel-center convention).
Image resize_bilinear(const Image& src, int new_h, int new_w);

}  // namespace vstimg
