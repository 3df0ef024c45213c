// fused_scale_bias_conv3x3.cu — Y = conv3x3(relu?(X * scale + bias), W),
// pad 1, stride 1 or 2: NHWC input X (N, H, W, C), HWIO weights
// (3, 3, C, F), NHWC output (N, OH, OW, F), f32 accumulation, Y in X's
// dtype (float32 or bfloat16).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_conv.py:_pallas_conv (body
// _kernel): the BatchNorm apply step and relu fused into the 3x3
// convolution that consumes them.
//
// An implicit GEMM (prologue_gemm.cuh): output row m = (n, oh, ow), nine
// taps t = (dy, dx), tap t reading input pixel (oh*s + dy - 1,
// ow*s + dx - 1).  The HWIO weight tensor is the (9C, F) matrix of the
// GEMM as it lies.  A halo pixel is a zero row written AFTER the
// prologue (pallas_conv.py:56-62 pads the activated block), so it adds 0
// and not relu(bias).  Strided rows are just other offsets: stride 2 at
// odd H or W needs no fallback (the TPU kernel's :153-157).
//
// Bound: operations at the training path's shapes (2 * N*OH*OW * F * 9C
// flops; e.g. 32 x 56 x 56 x 64 -> 64 is 7.4 GFLOP against 26 MB).

#include "prologue_gemm.cuh"

namespace {

struct ConvSrc {
  int H, W, C, OH, OW, stride;
  __device__ void init(long long m, mxtpu::RowTable& r) const {
    const int ow = (int)(m % OW);
    const long long t = m / OW;
    const int oh = (int)(t % OH);
    const long long n = t / OH;
    r.base = n * H * W * C;
    r.ih0 = oh * stride - 1;
    r.iw0 = ow * stride - 1;
  }
  __device__ long long at(const mxtpu::RowTable& r, int tap) const {
    const int ih = r.ih0 + tap / 3, iw = r.iw0 + tap % 3;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return -1;
    return r.base + ((long long)ih * W + iw) * C;
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scale and bias are float32 (C,).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int mxtpu_fused_scale_bias_conv3x3(
    const void* x, const void* w, const float* scale, const float* bias,
    void* y, long long N, long long H, long long W, long long C, long long F,
    long long OH, long long OW, int stride, int relu, int dtype,
    void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  if (OH != (H - 1) / stride + 1 || OW != (W - 1) / stride + 1)
    return (int)cudaErrorInvalidValue;
  if (H * W * C >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  mxtpu::Problem p{x, w, scale, bias, y, N * OH * OW, F, C, 9, relu};
  const ConvSrc src{(int)H, (int)W, (int)C, (int)OH, (int)OW, stride};
  return mxtpu::launch(p, src, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
