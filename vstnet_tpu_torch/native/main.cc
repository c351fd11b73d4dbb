// vstnet-torch-native: the standalone native runner of the PyTorch port.
//
// Counterpart of native/vstnet_main.cc (the JAX package's vstnet-native):
// load an AOTInductor package made by runtime/native.py:package_program
// (weights held in it), run it through the engine (engine.cc) on the CUDA
// card, or on the CPU with --device cpu, and write PNGs. No Python runs in
// this process.
//
//   vstnet-torch-native --artifact stylize_512x512.aoti.pt2 --style s.png \
//       -o out/ c1.png c2.png
//   vstnet-torch-native --artifact segment_render_512x512.aoti.pt2 \
//       -o out/ scene.png
//
// The mode (two inputs: content and style; one: segment-render) and the
// input shape come from the package's metadata; images are bilinear-resized
// to the package's shape, and each output back to its content's size.
// Output: out/<content>_<style>.png, or out/<content>_seg.png.

#include <getopt.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "engine.h"
#include "image_io.h"

namespace {

void usage() {
  std::fprintf(stderr,
               "vstnet-torch-native: run an AOTInductor package on images "
               "(no Python at run time)\n\n"
               "usage: vstnet-torch-native --artifact F [--style S] [-o DIR] "
               "[--device cuda|cuda:N|cpu] image.png [image2.png ...]\n"
               "  -a, --artifact  .pt2 package (package_program, weights "
               "held):\n"
               "                  a 2-input stylize program (needs --style)\n"
               "                  or a 1-input program such as segment-\n"
               "                  render; the mode is read from the\n"
               "                  package's metadata\n"
               "  -s, --style     style image (PNG or P6 PPM); 2-input only\n"
               "  -o, --out_dir   output directory (default: output)\n"
               "  -d, --device    cuda (default), cuda:N, or cpu\n");
}

std::string stem(const std::string& p) {
  size_t s = p.find_last_of('/');
  std::string base = s == std::string::npos ? p : p.substr(s + 1);
  size_t d = base.find_last_of('.');
  return d == std::string::npos ? base : base.substr(0, d);
}

bool is_image(const std::vector<int64_t>& s) {
  return s.size() == 4 && s[3] == 3;
}

}  // namespace

int main(int argc, char** argv) {
  std::string artifact, style_path, out_dir = "output", device = "cuda";
  static option longopts[] = {
      {"artifact", required_argument, nullptr, 'a'},
      {"style", required_argument, nullptr, 's'},
      {"out_dir", required_argument, nullptr, 'o'},
      {"device", required_argument, nullptr, 'd'},
      {"help", no_argument, nullptr, 'h'},
      {nullptr, 0, nullptr, 0},
  };
  int c;
  while ((c = getopt_long(argc, argv, "a:s:o:d:h", longopts, nullptr)) !=
         -1) {
    switch (c) {
      case 'a': artifact = optarg; break;
      case 's': style_path = optarg; break;
      case 'o': out_dir = optarg; break;
      case 'd': device = optarg; break;
      default: usage(); return c == 'h' ? 0 : 2;
    }
  }
  if (artifact.empty() || optind >= argc) {
    usage();
    return 2;
  }

  void* eng = engine_create(device.c_str());
  auto fail = [&](const char* what) {
    std::fprintf(stderr, "error: %s: %s\n", what, engine_last_error(eng));
    engine_destroy(eng);
    return 1;
  };
  if (!engine_ok(eng)) return fail("engine");
  auto t0 = std::chrono::steady_clock::now();
  if (engine_load(eng, artifact.c_str()) != 0) return fail("package");
  double load_s = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0).count();

  int n_in = engine_n_inputs(eng);
  std::vector<std::vector<int64_t>> in_shapes(n_in > 0 ? n_in : 0);
  for (int i = 0; i < n_in; i++) {
    int64_t dims[8];
    int nd = engine_input_shape(eng, i, dims, 8);
    in_shapes[i].assign(dims, dims + (nd > 0 ? nd : 0));
  }
  int64_t out_dims[8];
  int out_nd = engine_output_shape(eng, out_dims, 8);
  std::vector<int64_t> out_shape(out_dims, out_dims + (out_nd > 0 ? out_nd
                                                                  : 0));
  if (n_in < 1 || n_in > 2 || !is_image(in_shapes[0]) ||
      (n_in == 2 && in_shapes[1] != in_shapes[0]) || !is_image(out_shape)) {
    std::fprintf(stderr,
                 "error: package signature not recognized (expect one or "
                 "two NHWC float32 RGB inputs of one shape and an NHWC "
                 "RGB output)\n");
    engine_destroy(eng);
    return 1;
  }
  if (n_in == 2 && style_path.empty()) {
    std::fprintf(stderr, "error: 2-input (stylize) package needs --style\n");
    engine_destroy(eng);
    return 2;
  }
  if (n_in == 1 && !style_path.empty()) {
    std::fprintf(stderr,
                 "error: --style given but the package takes ONE input "
                 "(segment-render mode) — it would be silently ignored\n");
    engine_destroy(eng);
    return 2;
  }
  int64_t b = in_shapes[0][0], H = in_shapes[0][1], W = in_shapes[0][2];
  if (b != 1 || out_shape[0] != 1) {
    std::fprintf(stderr, "error: the runner expects a batch-1 package\n");
    engine_destroy(eng);
    return 1;
  }
  std::printf("package: %s (%s)  input %ldx%ld  output %ldx%ld  load %.3f s\n",
              artifact.c_str(), engine_metadata(eng, "vstnet_what"), (long)H,
              (long)W, (long)out_shape[1], (long)out_shape[2], load_s);
  std::printf("device: %s\n", engine_device_info(eng));

  std::string err;
  vstimg::Image style_r;
  if (n_in == 2) {
    vstimg::Image style;
    if (!vstimg::load_image(style_path, &style, &err)) {
      std::fprintf(stderr, "error: style: %s\n", err.c_str());
      engine_destroy(eng);
      return 1;
    }
    style_r = vstimg::resize_bilinear(style, (int)H, (int)W);
  }

  std::string mkdir_cmd = "mkdir -p '" + out_dir + "'";
  if (std::system(mkdir_cmd.c_str()) != 0) {
    std::fprintf(stderr, "error: cannot create %s\n", out_dir.c_str());
    engine_destroy(eng);
    return 1;
  }
  std::string sstem = n_in == 2 ? stem(style_path) : "seg";

  int failures = 0, runs = 0;
  double total_ms = 0.0;
  for (int i = optind; i < argc; i++) {
    vstimg::Image content;
    if (!vstimg::load_image(argv[i], &content, &err)) {
      std::fprintf(stderr, "error: %s: %s\n", argv[i], err.c_str());
      failures++;
      continue;
    }
    vstimg::Image content_r =
        vstimg::resize_bilinear(content, (int)H, (int)W);

    const float* ins[2] = {content_r.rgb.data(),
                           n_in == 2 ? style_r.rgb.data() : nullptr};
    int32_t ndims[2] = {4, 4};
    int64_t dims[8] = {1, H, W, 3, 1, H, W, 3};
    int64_t out_n = 1;
    for (int64_t d : out_shape) out_n *= d;
    std::vector<float> out((size_t)out_n);
    float* outs[1] = {out.data()};
    int64_t out_sizes[1] = {out_n};
    // host buffers in, the run, the result back on the host
    auto t1 = std::chrono::steady_clock::now();
    int rc = engine_execute(eng, n_in, ins, ndims, dims, 1, outs, out_sizes);
    double ms = std::chrono::duration<double, std::milli>(
                    std::chrono::steady_clock::now() - t1).count();
    if (rc != 0) {
      std::fprintf(stderr, "error: %s: %s\n", argv[i],
                   engine_last_error(eng));
      failures++;
      continue;
    }
    runs++;
    total_ms += ms;

    vstimg::Image result;
    result.h = (int)out_shape[1];
    result.w = (int)out_shape[2];
    result.rgb.assign(out.begin(), out.end());
    // raw program output, clamped at save
    vstimg::Image final_img =
        vstimg::resize_bilinear(result, content.h, content.w);
    std::string dst = out_dir + "/" + stem(argv[i]) + "_" + sstem + ".png";
    if (!vstimg::save_png(dst, final_img, &err)) {
      std::fprintf(stderr, "error: save: %s\n", err.c_str());
      failures++;
      continue;
    }
    std::printf("wrote %s (execute %.3f ms)\n", dst.c_str(), ms);
  }
  if (runs)
    std::printf("executed %d image(s), mean %.3f ms\n", runs,
                total_ms / runs);
  engine_destroy(eng);
  return failures ? 1 : 0;
}
