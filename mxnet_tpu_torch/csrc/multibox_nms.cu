// multibox_nms.cu — the greedy non-maximum suppression of SSD's
// MultiBoxDetection over rows already ordered by descending score.
//
// Rows are [batch, anchors, 6] float32: (class_id, score, xmin, ymin,
// xmax, ymax).  For each row i in turn, if row i is still alive (class id
// >= 0), every later live row j of the same class (any class with
// force_suppress) whose IoU with row i is at least the threshold gets
// class id -1; scores and coordinates are kept.  The rows are updated in
// place.
//
// Replaces: no pl.pallas_call.  The JAX package computes this step as
// fori_loop(0, num_anchors, nms_step, rows) (mxnet_tpu/ops/multibox.py:
// 260-279), which XLA keeps on the device as one loop.  In PyTorch that
// loop would be about twelve launches per anchor (7308 anchors at SSD's
// 300x300: ~90k launches a forward, or a CUDA graph of as many nodes).
//
// Bound: the rows are read once and the class ids written once
// (28 bytes a row); the work is data-dependent: each row that survives
// to its turn tests every later live row, so the operations grow with
// the kept rows times the anchors.  The scan is sequential over i, so
// the design keeps that sequence inside one thread block per image:
//
// - The block copies the image's class ids into shared memory once.
//   Each step reads row i's class id there (a broadcast), so a dead row
//   costs a shared-memory read and no barrier: every thread sees the same
//   value and skips it together.
// - A live row's coordinates come from global memory (one broadcast
//   load); the block's threads stride over the later rows, test them and
//   mark suppressions in shared memory, then meet at one __syncthreads.
//   Between two barriers only one live step writes, and it writes only
//   rows after its own, so no thread reads a class id another thread is
//   writing.
// - The class ids go back to global memory at the end.
//
// The IoU uses the plain version's expression and operation order, each
// operation rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn,
// __fdiv_rn; no FMA contraction), so the rows it keeps match the plain
// version in mxnet_tpu_torch/ops/multibox.py bit for bit.
//
// Launch contract: runs on the caller's stream, does not synchronise,
// allocates nothing; returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kStaticSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
    nms_kernel(float* __restrict__ rows, int anchors, float threshold,
               int force_suppress) {
  extern __shared__ float cls[];
  float* r = rows + (size_t)blockIdx.x * anchors * 6;
  for (int j = threadIdx.x; j < anchors; j += kThreads) cls[j] = r[j * 6];
  __syncthreads();
  for (int i = 0; i + 1 < anchors; ++i) {
    const float ci = cls[i];
    if (!(ci >= 0.0f)) continue;  // dead: uniform across the block
    const float ix0 = r[i * 6 + 2], iy0 = r[i * 6 + 3];
    const float ix1 = r[i * 6 + 4], iy1 = r[i * 6 + 5];
    const float area_i = __fmul_rn(__fsub_rn(ix1, ix0), __fsub_rn(iy1, iy0));
    for (int j = i + 1 + threadIdx.x; j < anchors; j += kThreads) {
      const float cj = cls[j];
      if (!(cj >= 0.0f)) continue;
      if (!force_suppress && cj != ci) continue;
      const float* q = r + (size_t)j * 6;
      const float jx0 = q[2], jy0 = q[3], jx1 = q[4], jy1 = q[5];
      const float ltx = fmaxf(jx0, ix0), lty = fmaxf(jy0, iy0);
      const float rbx = fminf(jx1, ix1), rby = fminf(jy1, iy1);
      const float w = fmaxf(__fsub_rn(rbx, ltx), 0.0f);
      const float h = fmaxf(__fsub_rn(rby, lty), 0.0f);
      const float inter = __fmul_rn(w, h);
      const float area_j =
          __fmul_rn(__fsub_rn(jx1, jx0), __fsub_rn(jy1, jy0));
      const float uni = __fsub_rn(__fadd_rn(area_j, area_i), inter);
      const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
      if (iou >= threshold) cls[j] = -1.0f;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < anchors; j += kThreads) r[j * 6] = cls[j];
}

}  // namespace

// rows: [batch, anchors, 6] float32, contiguous, updated in place.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int mxtpu_multibox_nms(void* rows, long long batch,
                                  long long anchors, float threshold,
                                  int force_suppress, void* stream) {
  if (batch <= 0 || anchors <= 0 || batch > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)anchors * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)kStaticSmem) {
    // the attribute belongs to the current device: set on every such
    // launch, so a second card gets it too (cheap beside the scan)
    cudaError_t e = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_kernel<<<(unsigned)batch, kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(rows), (int)anchors, threshold, force_suppress);
  return (int)cudaGetLastError();
}

extern "C" const char* mxtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
