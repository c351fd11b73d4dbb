// C ABI of the native engine (engine.cc): an AOTInductor package run on
// one device, float32 host buffers in and out.
//
// Counterpart of native/vstnet_engine.cc (the JAX package's PJRT engine):
//   engine_create(device)  -> "cuda" or "cuda:N" (the default of every
//                             caller), or "cpu" when asked for; fails
//                             without the device, never moves to another
//   engine_load(package)   -> load a .pt2 AOTInductor package made by
//                             runtime/native.py:package_program (the
//                             compile step of the PJRT engine happens
//                             there, in Python, ahead of time)
//   engine_execute(...)    -> host float32 buffers in, host float32 out
//   engine_destroy
// Functions returning int32_t give 0 (or a count) on success and -1 on
// failure; engine_last_error then says why.

#pragma once

#include <cstdint>

#ifdef __cplusplus
extern "C" {
#endif

// Never NULL: check engine_ok, and engine_last_error when it is 0.
void* engine_create(const char* device);
int32_t engine_ok(void* h);
const char* engine_last_error(void* h);
// The device, its name and whether this process holds a context on it,
// e.g. "cuda:0 NVIDIA H100 80GB HBM3 (primary context active)".
const char* engine_device_info(void* h);

int32_t engine_load(void* h, const char* package_path);
// The package's metadata (runtime/native.py:package_program): the number
// of inputs, each input's shape and the output's shape. The shape
// functions write up to max_n dims and return the rank (-1 on error).
int32_t engine_n_inputs(void* h);
int32_t engine_input_shape(void* h, int32_t i, int64_t* dims, int32_t max_n);
int32_t engine_output_shape(void* h, int64_t* dims, int32_t max_n);
// The package's metadata value for `key` ("" when absent).
const char* engine_metadata(void* h, const char* key);

// n_in float32 inputs (dense, row-major; ndims/dims_flat describe them)
// -> n_out float32 outputs copied into out_bufs of out_sizes elements.
int32_t engine_execute(void* h, int64_t n_in, const float** in_data,
                       const int32_t* ndims, const int64_t* dims_flat,
                       int64_t n_out, float** out_bufs,
                       const int64_t* out_sizes);

void engine_destroy(void* h);

#ifdef __cplusplus
}
#endif
