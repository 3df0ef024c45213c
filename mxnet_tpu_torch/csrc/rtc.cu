// The runtime-compilation bridge of mx.rtc.Rtc (mxnet_tpu_torch/rtc.py):
// NVRTC compiles a user's decorated CUDA source to a CUBIN for the card,
// and the CUDA driver API loads it into the device's primary context and
// launches it on the caller's stream.
//
// Replaces: the Pallas path of mxnet_tpu/rtc.py (Rtc._specialize, which
// wraps the user's body in pl.pallas_call at mxnet_tpu/rtc.py:91).  The
// design goes back to the reference MXNet's MXRtc (src/common/mxrtc.cc):
// the user writes the body of a __global__ function and chooses its
// grid and block.  What bounds a launch is the user's kernel; this file
// adds host work only, and the CUBIN is compiled for sm_90a ahead of the
// launch, so no PTX JIT runs when the module loads.
//
// Host cost of a push: rtc.py keeps one launch plan per (device, argument
// dtypes) — this file's context and function handles — in a dict it reads
// without a lock, and makes one ctypes call per push, whose one argument
// is a packed launch record of plain integers (the handles, stream, grid,
// block and the arguments' device addresses).  The launch checks
// the calling thread's current context (a few nanoseconds) instead of
// pushing and popping the primary context around every cuLaunchKernel.
//
// Plain C entry points, bound with ctypes.  Each returns 0 or the
// nvrtcResult / CUresult code of the call that failed;
// mxtpu_cuda_error_string names a CUresult code.  Linked with -lnvrtc and
// -lcuda (the toolkit's stub library at link time, the installed CUDA
// library at run time).
#include <cuda.h>
#include <nvrtc.h>

#include <cstdlib>
#include <cstring>
#include <string>

namespace {

void copy_log(const char* msg, char* log, size_t cap) {
  if (!log || cap == 0) return;
  std::strncpy(log, msg ? msg : "", cap - 1);
  log[cap - 1] = '\0';
}

}  // namespace

extern "C" {

const char* mxtpu_cuda_error_string(int err) {
  const char* s = nullptr;
  if (cuGetErrorString(static_cast<CUresult>(err), &s) != CUDA_SUCCESS ||
      s == nullptr)
    return "unknown CUDA driver error";
  return s;
}

const char* mxtpu_nvrtc_error_string(int err) {
  return nvrtcGetErrorString(static_cast<nvrtcResult>(err));
}

// Compile `src` (file name `name`.cu) for `arch` (e.g. "sm_90a") with
// -I`include_dir`.  On success *cubin is a malloc'd CUBIN of *size bytes
// (release with mxtpu_rtc_free_cubin).  `log` receives NVRTC's log, or
// the error's name when there is no log.
int mxtpu_rtc_compile(const char* src, const char* name, const char* arch,
                      const char* include_dir, char** cubin, size_t* size,
                      char* log, size_t log_cap) {
  *cubin = nullptr;
  *size = 0;
  copy_log("", log, log_cap);
  nvrtcProgram prog;
  std::string file = std::string(name) + ".cu";
  nvrtcResult r =
      nvrtcCreateProgram(&prog, src, file.c_str(), 0, nullptr, nullptr);
  if (r != NVRTC_SUCCESS) {
    copy_log(nvrtcGetErrorString(r), log, log_cap);
    return r;
  }
  std::string arch_opt = std::string("--gpu-architecture=") + arch;
  std::string inc_opt = std::string("-I") + include_dir;
  const char* opts[] = {arch_opt.c_str(), "-std=c++17", inc_opt.c_str()};
  int n_opts = (include_dir && include_dir[0]) ? 3 : 2;
  r = nvrtcCompileProgram(prog, n_opts, opts);
  size_t log_size = 0;
  if (nvrtcGetProgramLogSize(prog, &log_size) == NVRTC_SUCCESS &&
      log_size > 1) {
    std::string text(log_size, '\0');
    if (nvrtcGetProgramLog(prog, &text[0]) == NVRTC_SUCCESS)
      copy_log(text.c_str(), log, log_cap);
  }
  if (r != NVRTC_SUCCESS) {
    if (log_size <= 1) copy_log(nvrtcGetErrorString(r), log, log_cap);
    nvrtcDestroyProgram(&prog);
    return r;
  }
  size_t n = 0;
  r = nvrtcGetCUBINSize(prog, &n);
  if (r == NVRTC_SUCCESS) {
    char* buf = static_cast<char*>(std::malloc(n));
    if (buf == nullptr) {
      r = NVRTC_ERROR_OUT_OF_MEMORY;
    } else if ((r = nvrtcGetCUBIN(prog, buf)) == NVRTC_SUCCESS) {
      *cubin = buf;
      *size = n;
    } else {
      std::free(buf);
    }
  }
  if (r != NVRTC_SUCCESS) copy_log(nvrtcGetErrorString(r), log, log_cap);
  nvrtcDestroyProgram(&prog);
  return r;
}

void mxtpu_rtc_free_cubin(char* cubin) { std::free(cubin); }

// Load `cubin` into the primary context of CUDA device `device` (retained
// here, released by mxtpu_rtc_free) and look up `name` in it.  The
// calling thread's current context is left as it was.
int mxtpu_rtc_load(const void* cubin, const char* name, int device,
                   void** ctx_out, void** module_out, void** function_out) {
  CUresult r = cuInit(0);
  if (r != CUDA_SUCCESS) return r;
  CUdevice dev;
  if ((r = cuDeviceGet(&dev, device)) != CUDA_SUCCESS) return r;
  CUcontext ctx;
  if ((r = cuDevicePrimaryCtxRetain(&ctx, dev)) != CUDA_SUCCESS) return r;
  if ((r = cuCtxPushCurrent(ctx)) != CUDA_SUCCESS) {
    cuDevicePrimaryCtxRelease(dev);
    return r;
  }
  CUmodule module = nullptr;
  CUfunction function = nullptr;
  r = cuModuleLoadData(&module, cubin);
  if (r == CUDA_SUCCESS) {
    r = cuModuleGetFunction(&function, module, name);
    if (r != CUDA_SUCCESS) cuModuleUnload(module);
  }
  CUcontext popped;
  cuCtxPopCurrent(&popped);
  if (r != CUDA_SUCCESS) {
    cuDevicePrimaryCtxRelease(dev);
    return r;
  }
  *ctx_out = ctx;
  *module_out = module;
  *function_out = function;
  return CUDA_SUCCESS;
}

// Launch one kernel as rtc.py packs it, with no dynamic shared memory, as
// MXRtc did.  `record` holds native-endian uint64s, read here with memcpy
// (no alignment assumed): the context and function of mxtpu_rtc_load, the
// stream, grid x/y/z, block x/y/z, the argument count n, and the n
// arguments (the arrays' device addresses).  Packed in one bytes object,
// a push costs one ctypes argument conversion instead of eleven.  The
// parameter array cuLaunchKernel reads (one pointer to each argument) is
// built on this stack; cuLaunchKernel copies the arguments before it
// returns.  The context is the primary context the function was loaded
// into, which is the current one on any thread where PyTorch has used
// the device: it is pushed, and popped after the launch, only where
// another context or none is current (a thread that never touched CUDA,
// another device).  Does not synchronise.
int mxtpu_rtc_launch_record(const unsigned char* record) {
  enum { kHead = 10, kMaxArgs = 512 };
  unsigned long long head[kHead];
  std::memcpy(head, record, sizeof head);
  const unsigned long long n = head[9];
  if (n > kMaxArgs) return CUDA_ERROR_INVALID_VALUE;
  for (int i = 3; i < 9; ++i)
    if (head[i] > 0xffffffffull) return CUDA_ERROR_INVALID_VALUE;
  unsigned long long args[kMaxArgs];
  void* params[kMaxArgs];
  std::memcpy(args, record + sizeof head, n * sizeof(unsigned long long));
  for (unsigned long long i = 0; i < n; ++i) params[i] = &args[i];
  CUcontext ctx = reinterpret_cast<CUcontext>(head[0]);
  CUcontext current = nullptr;
  CUresult r = cuCtxGetCurrent(&current);
  if (r != CUDA_SUCCESS) return r;
  const bool push = current != ctx;
  if (push && (r = cuCtxPushCurrent(ctx)) != CUDA_SUCCESS) return r;
  r = cuLaunchKernel(reinterpret_cast<CUfunction>(head[1]),
                     static_cast<unsigned>(head[3]),
                     static_cast<unsigned>(head[4]),
                     static_cast<unsigned>(head[5]),
                     static_cast<unsigned>(head[6]),
                     static_cast<unsigned>(head[7]),
                     static_cast<unsigned>(head[8]), 0,
                     reinterpret_cast<CUstream>(head[2]), params, nullptr);
  if (push) {
    CUcontext popped;
    cuCtxPopCurrent(&popped);
  }
  return r;
}

// Unload a module of mxtpu_rtc_load and release its primary context.
int mxtpu_rtc_free(void* ctx, void* module, int device) {
  CUresult r = cuCtxPushCurrent(static_cast<CUcontext>(ctx));
  if (r != CUDA_SUCCESS) return r;
  r = cuModuleUnload(static_cast<CUmodule>(module));
  CUcontext popped;
  cuCtxPopCurrent(&popped);
  CUdevice dev;
  if (cuDeviceGet(&dev, device) == CUDA_SUCCESS)
    cuDevicePrimaryCtxRelease(dev);
  return r;
}

}  // extern "C"
