// fused_bn_relu.cu — y = max(x * scale[c] + bias[c], 0) with a per-channel
// affine, computed in f32 and stored in x's dtype (float32 or bfloat16).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_fused.py:_bn_relu_pallas
// (body _bn_relu_kernel): the BatchNorm apply step, statistics pre-folded
// to (scale, bias), fused with the relu that follows it.
//
// Bound: memory.  The function reads x once and writes y once,
// 2 * numel * itemsize bytes (plus 8 * C bytes of scale/bias), against
// three flops per element; at the H100's 3.35 TB/s the bytes bound it by
// two orders of magnitude.  So the design is a single grid-stride pass
// that keeps every load and store 16 bytes wide and coalesced:
//
// - The input is NCHW (or (M, C) for 2-D), taken as is.  The channel of
//   flat element i is (i / HW) % C (HW = 1 for 2-D), so the TPU path's
//   NCHW <-> channels-last transpose pair is not needed.
// - Each thread moves 16-byte vectors (4 floats or 8 bf16).  It divides
//   once per vector to find its first channel and then steps the channel
//   as the in-plane offset wraps, so a plane length no vector width
//   divides (7x7 = 49) stays on the vector path.
// - Elements past the last whole vector, or all of them when a pointer is
//   not 16-byte aligned, take the scalar loop of the same launch; ragged
//   sizes need no block-divisibility fallback.
// - 32-bit indexing when numel < 2^31 keeps the divisions cheap.
//
// The multiply and the add are rounded separately (__fmul_rn/__fadd_rn,
// no FMA contraction), so the result is bit-identical to the plain
// PyTorch version in mxnet_tpu_torch/ops/fused.py.
//
// Launch contract: runs on the caller's stream, does not synchronise,
// allocates nothing; returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float bn_relu(float x, float s, float b) {
  const float y = __fadd_rn(__fmul_rn(x, s), b);
  return y < 0.0f ? 0.0f : y;  // NaN propagates, as torch.relu does
}

template <typename T, typename Index>
__global__ void __launch_bounds__(kThreads)
    bn_relu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y,
                   Index n, Index hw, Index c, Index nvec) {
  constexpr int V = 16 / sizeof(T);
  const Index stride = (Index)gridDim.x * kThreads;
  const Index tid = (Index)blockIdx.x * kThreads + threadIdx.x;
  for (Index v = tid; v < nvec; v += stride) {
    const Index i0 = v * V;
    Index r = i0 % hw;
    Index ch = (i0 / hw) % c;
    float s = scale[ch];
    float b = bias[ch];
    uint4 in = reinterpret_cast<const uint4*>(x)[v];
    uint4 out;
    const T* xs = reinterpret_cast<const T*>(&in);
    T* ys = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      ys[k] = from_f32<T>(bn_relu(to_f32(xs[k]), s, b));
      if (k + 1 < V && ++r == hw) {
        r = 0;
        ch = (ch + 1 == c) ? 0 : ch + 1;
        s = scale[ch];
        b = bias[ch];
      }
    }
    reinterpret_cast<uint4*>(y)[v] = out;
  }
  for (Index i = nvec * V + tid; i < n; i += stride) {
    const Index ch = (i / hw) % c;
    y[i] = from_f32<T>(bn_relu(to_f32(x[i]), scale[ch], bias[ch]));
  }
}

template <typename T, typename Index>
void launch(const void* x, const float* scale, const float* bias, void* y,
            long long n, long long hw, long long c, bool vec_ok,
            cudaStream_t stream) {
  constexpr long long V = 16 / sizeof(T);
  const long long nvec = vec_ok ? n / V : 0;
  const long long work = nvec > n - nvec * V ? nvec : n - nvec * V;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = (long long)(sms > 0 ? sms : 1) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  bn_relu_kernel<T, Index><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), (Index)n,
      (Index)hw, (Index)c, (Index)nvec);
}

template <typename T>
void dispatch(const void* x, const float* scale, const float* bias, void* y,
              long long n, long long hw, long long c, bool vec_ok,
              cudaStream_t stream) {
  if (n < (1LL << 31))
    launch<T, uint32_t>(x, scale, bias, y, n, hw, c, vec_ok, stream);
  else
    launch<T, uint64_t>(x, scale, bias, y, n, hw, c, vec_ok, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec_ok: x and y are 16-byte aligned.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int mxtpu_fused_bn_relu(const void* x, const float* scale,
                                   const float* bias, void* y, long long n,
                                   long long hw, long long c, int dtype,
                                   int vec_ok, void* stream) {
  if (n <= 0 || hw <= 0 || c <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch<float>(x, scale, bias, y, n, hw, c, vec_ok != 0, s);
  else
    dispatch<__nv_bfloat16>(x, scale, bias, y, n, hw, c, vec_ok != 0, s);
  return (int)cudaGetLastError();
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
