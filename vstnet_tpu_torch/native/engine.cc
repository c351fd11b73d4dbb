// Native inference engine over AOTInductor packages (libtorch, no Python).
//
// Counterpart of native/vstnet_engine.cc, which runs a StableHLO module
// through a PJRT plugin. Here the artifact is a `.pt2` AOTInductor package
// made from the port's torch.export programs by
// runtime/native.py:package_program, which is where the compile step
// (engine_compile of the PJRT engine) happens, ahead of time. The engine
// loads the package with torch::inductor::AOTIModelPackageLoader and runs
// it on one device with float32 host buffers in and out.
//
// Device rule of the port: "cuda" / "cuda:N" unless the caller asks for
// "cpu". A missing card is an error, and so is a package compiled for
// another device type (its AOTI_DEVICE_KEY): nothing is moved silently.
//
// TF32: ATen's global context is told to keep cuDNN convs and cuBLAS
// matmuls in true float32 before the first run (the C++ twin of
// models/segformer.py:true_f32); with TF32 left on, the stylize program
// at 512x512 lies 8.8e-4 to 1.2e-3 from true float32 on an H100 80GB HBM3
// at 700 W (runtime/export.py).
//
// C ABI for ctypes (runtime/native.py:NativeEngine) and for main.cc.

#include "engine.h"

#include <dlfcn.h>

#include <ATen/ATen.h>
#include <ATen/Context.h>
#include <ATen/detail/CUDAHooksInterface.h>
#include <c10/core/Device.h>
#include <c10/core/DeviceGuard.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <cstring>
#include <memory>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// Keys that package_program writes into aot_inductor.metadata.
const char kNInputs[] = "vstnet_n_inputs";
const char kInputShapes[] = "vstnet_input_shapes";
const char kInputDtypes[] = "vstnet_input_dtypes";
const char kOutputShape[] = "vstnet_output_shape";
const char kDeviceKey[] = "AOTI_DEVICE_KEY";

struct Engine {
  c10::Device device{c10::kCPU};
  bool ok = false;
  std::string last_error, info, value;
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  std::unordered_map<std::string, std::string> meta;
  std::vector<std::vector<int64_t>> in_shapes;
  std::vector<at::ScalarType> in_dtypes;
  std::vector<int64_t> out_shape;
};

std::string message(const std::exception& e) {
  if (auto* ce = dynamic_cast<const c10::Error*>(&e))
    return ce->what_without_backtrace();
  return e.what();
}

std::vector<std::string> split(const std::string& s, char sep) {
  std::vector<std::string> parts;
  std::stringstream ss(s);
  std::string part;
  while (std::getline(ss, part, sep)) parts.push_back(part);
  return parts;
}

// "1x512x512x3" -> {1, 512, 512, 3}
std::vector<int64_t> parse_shape(const std::string& s) {
  std::vector<int64_t> dims;
  for (const auto& d : split(s, 'x')) dims.push_back(std::stoll(d));
  return dims;
}

at::ScalarType parse_dtype(const std::string& s) {
  static const std::unordered_map<std::string, at::ScalarType> names = {
      {"float32", at::kFloat},  {"float64", at::kDouble},
      {"float16", at::kHalf},   {"bfloat16", at::kBFloat16},
      {"int32", at::kInt},      {"int64", at::kLong},
  };
  auto it = names.find(s);
  if (it == names.end())
    throw std::runtime_error("unsupported input dtype " + s);
  return it->second;
}

std::string need(const std::unordered_map<std::string, std::string>& meta,
                 const char* key) {
  auto it = meta.find(key);
  if (it == meta.end())
    throw std::runtime_error(std::string("package metadata lacks ") + key +
                             " (not made by package_program)");
  return it->second;
}

// Name of CUDA device `index` and whether this process holds its primary
// context, from libcuda, which the process has already loaded (through
// libtorch_cuda): no CUDA header is needed to build the engine.
std::string cuda_info(int index) {
  void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
  if (!lib) return "(libcuda is not loaded in this process)";
  using GetFn = int (*)(int*, int);
  using NameFn = int (*)(char*, int, int);
  using StateFn = int (*)(int, unsigned*, int*);
  auto get = reinterpret_cast<GetFn>(dlsym(lib, "cuDeviceGet"));
  auto name = reinterpret_cast<NameFn>(dlsym(lib, "cuDeviceGetName"));
  auto state =
      reinterpret_cast<StateFn>(dlsym(lib, "cuDevicePrimaryCtxGetState"));
  std::string out = "(libcuda entry points missing)";
  int dev = 0;
  char buf[256] = {0};
  unsigned flags = 0;
  int active = 0;
  if (get && name && state && get(&dev, index) == 0 &&
      name(buf, sizeof(buf), dev) == 0 && state(dev, &flags, &active) == 0)
    out = std::string(buf) + (active ? " (primary context active)"
                                     : " (no primary context)");
  dlclose(lib);
  return out;
}

}  // namespace

extern "C" {

void* engine_create(const char* device) {
  auto* eng = new Engine();
  try {
    eng->device = c10::Device(std::string(device ? device : "cuda"));
    if (eng->device.is_cuda()) {
      if (!at::hasCUDA())
        throw std::runtime_error(
            "no CUDA device is available to this libtorch (torch.version."
            "cuda is None or no card is visible); pass \"cpu\" to run on "
            "the CPU");
      int n = at::detail::getCUDAHooks().getNumGPUs();
      if (!eng->device.has_index()) eng->device.set_index(0);
      if (eng->device.index() >= n)
        throw std::runtime_error("CUDA device " + eng->device.str() +
                                 " requested, " + std::to_string(n) +
                                 " visible");
    } else if (!eng->device.is_cpu()) {
      throw std::runtime_error("device must be cuda, cuda:N or cpu, not " +
                               eng->device.str());
    }
    at::globalContext().setAllowTF32CuDNN(false);
    at::globalContext().setAllowTF32CuBLAS(false);
    eng->ok = true;
  } catch (const std::exception& e) {
    eng->last_error = std::string("device ") + (device ? device : "cuda") +
                      ": " + message(e);
  }
  return eng;
}

int32_t engine_ok(void* h) { return static_cast<Engine*>(h)->ok ? 1 : 0; }

const char* engine_last_error(void* h) {
  return static_cast<Engine*>(h)->last_error.c_str();
}

const char* engine_device_info(void* h) {
  auto* eng = static_cast<Engine*>(h);
  eng->info = eng->device.str();
  if (eng->ok && eng->device.is_cuda())
    eng->info += " " + cuda_info(eng->device.index());
  return eng->info.c_str();
}

int32_t engine_load(void* h, const char* package_path) {
  auto* eng = static_cast<Engine*>(h);
  if (!eng->ok) return -1;
  try {
    auto meta = torch::inductor::AOTIModelPackageLoader::
        load_metadata_from_package(package_path, "model");
    std::string key = need(meta, kDeviceKey);
    std::string want = c10::DeviceTypeName(eng->device.type(), true);
    if (key != want)
      throw std::runtime_error("the package was compiled for " + key +
                               " and the engine runs on " +
                               eng->device.str() +
                               ": package it for this device");
    std::vector<std::vector<int64_t>> shapes;
    for (const auto& s : split(need(meta, kInputShapes), ';'))
      shapes.push_back(parse_shape(s));
    std::vector<at::ScalarType> dtypes;
    for (const auto& s : split(need(meta, kInputDtypes), ';'))
      dtypes.push_back(parse_dtype(s));
    size_t n = std::stoul(need(meta, kNInputs));
    if (shapes.size() != n || dtypes.size() != n)
      throw std::runtime_error("package metadata: input counts disagree");
    auto out_shape = parse_shape(need(meta, kOutputShape));
    c10::DeviceGuard guard(eng->device);
    eng->loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
        package_path, "model", false, 1,
        eng->device.is_cuda() ? eng->device.index() : -1);
    eng->meta = std::move(meta);
    eng->in_shapes = std::move(shapes);
    eng->in_dtypes = std::move(dtypes);
    eng->out_shape = std::move(out_shape);
    return 0;
  } catch (const std::exception& e) {
    eng->loader.reset();
    eng->last_error = std::string("load ") + package_path + ": " + message(e);
    return -1;
  }
}

int32_t engine_n_inputs(void* h) {
  auto* eng = static_cast<Engine*>(h);
  return eng->loader ? (int32_t)eng->in_shapes.size() : -1;
}

static int32_t copy_dims(const std::vector<int64_t>& v, int64_t* dims,
                         int32_t max_n) {
  if ((int32_t)v.size() > max_n) return -1;
  for (size_t k = 0; k < v.size(); k++) dims[k] = v[k];
  return (int32_t)v.size();
}

int32_t engine_input_shape(void* h, int32_t i, int64_t* dims,
                           int32_t max_n) {
  auto* eng = static_cast<Engine*>(h);
  if (!eng->loader || i < 0 || (size_t)i >= eng->in_shapes.size())
    return -1;
  return copy_dims(eng->in_shapes[(size_t)i], dims, max_n);
}

int32_t engine_output_shape(void* h, int64_t* dims, int32_t max_n) {
  auto* eng = static_cast<Engine*>(h);
  if (!eng->loader) return -1;
  return copy_dims(eng->out_shape, dims, max_n);
}

const char* engine_metadata(void* h, const char* key) {
  auto* eng = static_cast<Engine*>(h);
  auto it = eng->meta.find(key);
  eng->value = it == eng->meta.end() ? "" : it->second;
  return eng->value.c_str();
}

int32_t engine_execute(void* h, int64_t n_in, const float** in_data,
                       const int32_t* ndims, const int64_t* dims_flat,
                       int64_t n_out, float** out_bufs,
                       const int64_t* out_sizes) {
  auto* eng = static_cast<Engine*>(h);
  if (!eng->loader) {
    eng->last_error = "execute: no package loaded";
    return -1;
  }
  try {
    if ((size_t)n_in != eng->in_shapes.size())
      throw std::runtime_error(
          "the package takes " + std::to_string(eng->in_shapes.size()) +
          " inputs, " + std::to_string(n_in) + " given");
    c10::DeviceGuard guard(eng->device);
    std::vector<at::Tensor> inputs;
    const int64_t* dp = dims_flat;
    for (int64_t i = 0; i < n_in; i++) {
      std::vector<int64_t> dims(dp, dp + ndims[i]);
      dp += ndims[i];
      if (dims != eng->in_shapes[(size_t)i])
        throw std::runtime_error("input " + std::to_string(i) +
                                 ": shape differs from the package's");
      // the host buffer -> a tensor of the package's dtype on its device
      // (a copy: the caller keeps its buffer)
      auto host = at::from_blob(const_cast<float*>(in_data[i]), dims,
                                at::TensorOptions().dtype(at::kFloat));
      inputs.push_back(host.to(eng->device, eng->in_dtypes[(size_t)i],
                               /*non_blocking=*/false, /*copy=*/true));
    }
    std::vector<at::Tensor> outputs = eng->loader->run(inputs);
    if ((int64_t)outputs.size() != n_out)
      throw std::runtime_error("the package gives " +
                               std::to_string(outputs.size()) +
                               " outputs, " + std::to_string(n_out) +
                               " expected");
    for (int64_t k = 0; k < n_out; k++) {
      // one copy back to the host, which waits for the run
      at::Tensor out = outputs[(size_t)k]
                           .to(at::kCPU, at::kFloat)
                           .contiguous();
      if (out.numel() != out_sizes[k])
        throw std::runtime_error("output " + std::to_string(k) + " has " +
                                 std::to_string(out.numel()) +
                                 " elements, the buffer " +
                                 std::to_string(out_sizes[k]));
      std::memcpy(out_bufs[k], out.data_ptr<float>(),
                  sizeof(float) * (size_t)out_sizes[k]);
    }
    return 0;
  } catch (const std::exception& e) {
    eng->last_error = "execute: " + message(e);
    return -1;
  }
}

void engine_destroy(void* h) { delete static_cast<Engine*>(h); }

}  // extern "C"
