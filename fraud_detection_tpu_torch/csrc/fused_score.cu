// fused_score: p[i] = 1 / (1 + exp(-(sum_j x[i,j] * w[j] + b))) for a
// contiguous float32 x (n, d), any n >= 1 and d >= 1.
//
// Replaces fraud_detection_tpu/ops/pallas_kernels.py::_score_kernel (the
// Pallas TPU body behind fused_score). The TPU version pads d to the
// 128-lane width and stores each score broadcast across a (BN, 128) block;
// neither carries over. Here one warp owns one row: its 32 lanes stride the
// row's d features (consecutive lanes read consecutive floats, so each
// warp's load of a row is coalesced), fold them with fmaf, and reduce with
// __shfl_down_sync. Lane 0 adds the bias, applies the sigmoid with expf
// (not __expf: the kernel stays within a few ulp of torch.sigmoid) and
// writes one float. Warps walk the rows in a grid-stride loop.
//
// Bound on the H100: bytes. The work is 2*n*d flops over 4*n*(d+1) bytes
// moved (x read once, one score written), far below the card's
// flop-per-byte balance. At the serving bucket of 1024 rows and d = 30
// that is ~127 KB, under 0.04 us at 3.35 TB/s — far under the few
// microseconds a launch costs, so at serving sizes the launch dominates.
// The design answers that by doing the whole row in one pass with no
// scratch and no second kernel: one launch, x read once, nothing staged
// through device memory. Fusing the neighbouring launches of a flush (a
// CUDA-graph replay) is later work.
//
// The bias is read from a device pointer (never synchronised to the host).
// The launcher allocates nothing, does not synchronise, and runs on the
// caller's stream (PyTorch's current stream); it returns
// cudaGetLastError() so a refused launch is reported by the wrapper.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 64;  // a few waves; rows loop

__global__ void __launch_bounds__(kThreads)
fused_score_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out,
                   long long n, int d) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  const float bias = __ldg(b);
  // row is uniform across the warp, so every lane runs the same trips and
  // the full-mask shuffle below is safe
  for (long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n; row += stride) {
    const float* xr = x + row * (long long)d;
    float acc = 0.0f;
    for (int j = lane; j < d; j += 32) {
      acc = fmaf(__ldg(xr + j), __ldg(w + j), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) {
      out[row] = 1.0f / (1.0f + expf(-(acc + bias)));
    }
  }
}

}  // namespace

extern "C" int fused_score_launch(const void* x, const void* w, const void* b,
                                  void* out, long long n, int d, int device,
                                  void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  fused_score_kernel<<<(unsigned int)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)b, (float*)out, n, d);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
