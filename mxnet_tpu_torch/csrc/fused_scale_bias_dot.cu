// fused_scale_bias_dot.cu — Y = (relu?)(X * scale + bias) @ W with the
// per-K-column affine applied to X on its way into shared memory, rounded
// to X's dtype before the product, f32 accumulation, Y in X's dtype
// (float32 or bfloat16).  X is (M, K), W is (K, N), both row-major.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_fused.py:_pallas_forward
// (body _kernel): the BatchNorm apply step fused into the 1x1 convolution
// that consumes it, so the normalized activation never reaches memory.
// The stride-2 1x1 convolution gets a contiguous subsampled X from its
// caller (fuse.py _bn_relu_conv, as the JAX lowering slices it there).
//
// Bound: operations at the training path's shapes (2*M*N*K flops against
// (M*K + K*N + M*N) * itemsize bytes; e.g. M = 100352, K = 64, N = 256
// is 3.3 GFLOP against 64 MB).  Design and tiling: prologue_gemm.cuh.

#include "prologue_gemm.cuh"

namespace {

// Row m of X starts at m * K; one tap.
struct DotSrc {
  long long K;
  __device__ void init(long long m, mxtpu::RowTable& r) const {
    r.base = m * K;
  }
  __device__ long long at(const mxtpu::RowTable& r, int) const {
    return r.base;
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scale and bias are float32 (K,).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int mxtpu_fused_scale_bias_dot(const void* x, const void* w,
                                          const float* scale,
                                          const float* bias, void* y,
                                          long long M, long long N,
                                          long long K, int relu, int dtype,
                                          void* stream) {
  mxtpu::Problem p{x, w, scale, bias, y, M, N, K, 1, relu};
  return mxtpu::launch(p, DotSrc{K}, dtype,
                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
