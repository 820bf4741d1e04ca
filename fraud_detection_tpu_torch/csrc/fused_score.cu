// fused_score: p[i] = 1 / (1 + exp(-(sum_j x[i,j] * w[j] + b))) for a
// contiguous x (n, d) of float32 or bfloat16 rows, any n >= 1 and d >= 1,
// any base aligned to its element; w (d,), b and the scores (n,) float32.
//
// Replaces fraud_detection_tpu/ops/pallas_kernels.py::_score_kernel (the
// Pallas TPU body behind fused_score). The TPU version upcasts x to f32,
// pads d to the 128-lane width and stores each score broadcast across a
// (BN, 128) block; only the upcast carries over, and it happens here as
// each element is read (__bfloat162float is exact).
//
// Bound on the H100: bytes. The work is 2*n*d flops over (e*d + 4)*n bytes
// moved (e = 4 or 2 bytes an element: x read once, one f32 score written),
// far below the card's flop-per-byte balance.
//
// Two shapes, chosen by the launcher from n and d:
//
// - A warp a row (fused_score_warps): the warp's lanes stride the row's
//   features with coalesced loads, fold them with fmaf and add the lanes
//   with __shfl_down_sync; lane 0 writes the score. Its chain is one load
//   and five shuffles, so it is the faster shape wherever the rows do not
//   fill the card: every bucket of the serving ladder (n <= 4096), and
//   rows wider than kTileMaxCols, where a warp a row is the group of lanes
//   such a row wants.
// - A thread a row (fused_score_tiles), from kTileMinRows rows up: a
//   one-warp block owns tiles of 32 contiguous rows. It stages a tile in
//   shared memory row by row (a coalesced request a row; f32 words with
//   cp.async, every copy of the tile in flight before one wait; bf16
//   elements through registers, upcast as they are stored), at a row
//   stride of d | 1 words, so the warp's reads of 32 rows at one column
//   hit 32 different banks. Then each lane folds its own row and the warp
//   stores 32 consecutive scores. The rows' bytes, not one warp's chain
//   per row, are then the time.
//
// Both shapes give the same bits. Lane l of a warp a row sums fmaf over
// the features j = l (mod 32) in increasing j from 0.0f, then the lanes
// are added at shuffle offsets 16, 8, 4, 2, 1. A thread a row holds those
// 32 partials in registers, runs each in the same order and adds them by
// the same tree: the same additions on the same operands. Then 1/(1 +
// expf(-(acc + b))): expf, not __expf. A bf16 row is upcast exactly, so it
// scores bitwise as its values in f32.
//
// The bias is read from a device pointer (never synchronised to the host).
// The launcher allocates nothing, does not synchronise, and runs on the
// caller's stream (PyTorch's current stream); it returns cudaGetLastError()
// so a refused launch is reported by the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// The least n that takes a thread a row: on the H100 the tiles lose to a
// warp a row at 4096 rows and win at 8192 (fused_score_turns, PERF.md).
// A build may set it: 1 sends every launch with d <= kTileMaxCols there.
#ifndef FUSED_SCORE_TILE_MIN_ROWS
#define FUSED_SCORE_TILE_MIN_ROWS 8192
#endif

namespace {

constexpr long long kTileMinRows = FUSED_SCORE_TILE_MIN_ROWS;
constexpr int kTileMaxCols = 64;   // wider rows take a warp a row
constexpr int kTileRows = 32;      // a tile: a row a lane of a one-warp block
constexpr int kBlocksPerSM = 32;   // the card's most one-warp blocks: <= 64 registers
constexpr int kWarpThreads = 256;  // a warp a row: 8 rows a block
constexpr long long kWarpMaxBlocks = 132LL * 64;  // a few waves; rows loop
constexpr long long kMaxGrid = 0x7fffffffLL;

// x's element types: kF32 = 0, kBF16 = 1 (the launcher's x_dtype)
enum { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_float(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// Stage one element in shared memory as f32: an f32 word is copied by
// cp.async (no register holds it; wait_copies completes it), a bf16
// element is upcast through a register.
__device__ __forceinline__ void stage(float* dst, const float* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src) : "memory");
}

__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src) {
  *dst = load_float(src);
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <class T>
__global__ void __launch_bounds__(kWarpThreads)
fused_score_warps(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ out, long long n, int d) {
  constexpr int kRowsPerBlock = kWarpThreads / 32;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kRowsPerBlock;
  const float bias = __ldg(b);
  // row is uniform across the warp, so every lane runs the same trips and
  // the full-mask shuffle below is safe
  for (long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5); row < n;
       row += stride) {
    const T* xr = x + row * (long long)d;
    float acc = 0.0f;
    for (int j = lane; j < d; j += 32) acc = fmaf(load_float(xr + j), __ldg(w + j), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[row] = 1.0f / (1.0f + expf(-(acc + bias)));
  }
}

// Fold columns [0, min(cols, 32)) of a staged row into partials 0 .. 31.
__device__ __forceinline__ void fold32(const float* row, const float* wsm, int cols,
                                       float (&p)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k < cols) p[k] = fmaf(row[k], wsm[k], p[k]);
  }
}

template <class T>
__global__ void __launch_bounds__(kTileRows, kBlocksPerSM)
fused_score_tiles(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ out, long long n,
                  long long tiles, int d) {
  extern __shared__ float smem[];
  const int stride = d | 1;  // odd: a column of the tile lies in 32 banks
  float* tile = smem;
  float* wsm = smem + kTileRows * stride;
  const int lane = threadIdx.x;
  for (int j = lane; j < d; j += 32) stage(wsm + j, w + j);
  const float bias = __ldg(b);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kTileRows;
    const int live = (int)min((long long)kTileRows, n - row0);
    __syncwarp();  // the last tile's reads are done
    // lane c copies column c (and c + 32) of each row: a coalesced request
    // a row, few instructions a copy (a lone warp waits out each one's
    // latency), and 16 rows' loads in flight before a bf16 element is
    // stored
    if (lane < d) {
      const T* from = x + row0 * d + lane;
      float* to = tile + lane;
      const bool second = lane + 32 < d;
#pragma unroll 16
      for (int r = 0; r < live; ++r, from += d, to += stride) {
        stage(to, from);
        if (second) stage(to + 32, from + 32);
      }
    }
    wait_copies();
    __syncwarp();
    if (lane < live) {
      const float* row = tile + lane * stride;
      float p[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) p[k] = 0.0f;
      fold32(row, wsm, d, p);
      if (d > 32) fold32(row + 32, wsm + 32, d - 32, p);
      // the shuffle tree's additions: partial k += partial k + off for
      // off = 16, 8, 4, 2, 1 (fixed trip counts: p stays in registers)
#pragma unroll
      for (int s = 0; s < 5; ++s) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (k < (16 >> s)) p[k] += p[k + (16 >> s)];
        }
      }
      out[row0 + lane] = 1.0f / (1.0f + expf(-(p[0] + bias)));
    }
  }
}

template <class T>
cudaError_t launch(const void* xv, const void* wv, const void* bv, void* outv, long long n,
                   int d, cudaStream_t stream) {
  const T* x = (const T*)xv;
  const float* w = (const float*)wv;
  const float* b = (const float*)bv;
  float* out = (float*)outv;
  if (n >= kTileMinRows && d <= kTileMaxCols) {
    const long long tiles = (n + kTileRows - 1) / kTileRows;
    const size_t smem = (size_t)(kTileRows * (d | 1) + d) * sizeof(float);
    fused_score_tiles<T><<<(unsigned)(tiles < kMaxGrid ? tiles : kMaxGrid), kTileRows, smem,
                           stream>>>(x, w, b, out, n, tiles, d);
  } else {
    long long blocks = (n + kWarpThreads / 32 - 1) / (kWarpThreads / 32);
    if (blocks > kWarpMaxBlocks) blocks = kWarpMaxBlocks;
    fused_score_warps<T><<<(unsigned)blocks, kWarpThreads, 0, stream>>>(x, w, b, out, n, d);
  }
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 for float32 rows, 1 for bfloat16 rows.
extern "C" int fused_score_launch(const void* x, const void* w, const void* b, void* out,
                                  long long n, int d, int x_dtype, int device,
                                  void* stream) {
  if (n < 1 || d < 1 || (x_dtype != kF32 && x_dtype != kBF16)) {
    return (int)cudaErrorInvalidValue;
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  err = x_dtype == kF32 ? launch<float>(x, w, b, out, n, d, s)
                        : launch<__nv_bfloat16>(x, w, b, out, n, d, s);
  return (int)err;
}

extern "C" const char* fused_score_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
