// gbt_hist: gradient/hessian histograms of one tree level,
//     hist[f, m, b, :] = sum over rows r of 1[local_r = m] * 1[bins_rf = b] * (g_r, h_r)
// bins (n, d) uint8 row-major, local (n,) int32 (the row's node within the
// level), g and h (n,) float32; out (d, n_nodes, n_bins, 2) float32. Rows
// whose node lies outside [0, n_nodes) and bins >= n_bins are inert. Any
// n >= 1, d >= 1, 1 <= n_bins <= 256, 1 <= n_nodes <= 65536.
//
// Replaces fraud_detection_tpu/ops/gbt.py::_hist_pallas_kernel (launched by
// _hist_pallas). The TPU version is a one-hot contraction on the MXU: per
// 8192-row block it builds the (rows, n_bins) bin one-hot of each feature
// in VMEM and multiplies the bf16-rounded node-masked [g, h] strip into a
// (2 * n_nodes, d * n_bins) f32 accumulator carried across its sequential
// grid. None of that carries over: the matmul spends 2 * n_nodes * n_bins
// flops per (row, feature) on a one-hot, and its bf16 rounding of g and h
// is an MXU artefact. Here every (row, feature) adds its g and h to exactly
// one cell, in float32.
//
// Deterministic: the same inputs give the same bits on every launch (the
// forest a run grows reproduces). No float atomics. One block per
// (feature, row chunk, node tile). Each warp owns a private histogram in
// shared memory; lane L owns the bins b with b % 32 == L. The warp loads 32
// rows at a time and walks them in row order, and only the lane owning a
// row's bin adds it, so no two lanes touch one cell and every cell sums its
// rows in ascending order. The block then sums its warps in warp order into
// one partial per chunk, and a second kernel sums the chunks in chunk order.
// The number of chunks and warps depends on the shapes only.
//
// Bound on the H100: bytes. Each row's bins are read once (n * d B), local,
// g and h once (12 n B), the output written once (8 d n_nodes n_bins B).
// At the GBT recipe's last level (n = 31,684, d = 30, 16 nodes, 256 bins)
// that is ~2.3 MB, ~0.7 us at 3.35 TB/s: below one launch. The simple
// design is right here; its work is ~15 warp instructions per (row,
// feature), a few microseconds over the card.
//
// The launcher allocates nothing (the wrapper passes the chunk scratch),
// does not synchronise, runs on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr int kSmemMax = 200 * 1024;  // dynamic shared memory per block
constexpr int kTargetBlocks = 264;     // ~2 blocks per SM of an H100
constexpr int kMinRowsPerWarp = 64;
constexpr int kMaxNodes = 65536;
constexpr int kMaxBins = 256;

struct Plan {
  int warps;
  int node_tile;
  int tiles;
  int chunks;
  long long rows_per_chunk;
};

// the launch shape: a function of the shapes only, so that the summation
// order (and the result's bits) never depends on anything else
Plan plan(long long n, int d, int n_nodes, int n_bins) {
  Plan p;
  const int per_node = n_bins * (int)sizeof(float2);
  p.node_tile = n_nodes < kSmemMax / per_node ? n_nodes : kSmemMax / per_node;
  p.tiles = (n_nodes + p.node_tile - 1) / p.node_tile;
  int w = kSmemMax / (p.node_tile * per_node);
  p.warps = w < 1 ? 1 : (w > kMaxWarps ? kMaxWarps : w);
  long long want = (kTargetBlocks + (long long)d * p.tiles - 1) / ((long long)d * p.tiles);
  long long most = (n + (long long)p.warps * kMinRowsPerWarp - 1) /
                   ((long long)p.warps * kMinRowsPerWarp);
  long long c = want < most ? want : most;
  if (c < 1) c = 1;
  if (c > 65535) c = 65535;
  p.chunks = (int)c;
  p.rows_per_chunk = (n + c - 1) / c;
  return p;
}

__global__ void gbt_hist_partial(const uint8_t* __restrict__ bins,
                                 const int* __restrict__ local,
                                 const float* __restrict__ g,
                                 const float* __restrict__ h,
                                 float2* __restrict__ partial, long long n,
                                 int d, int n_nodes, int n_bins, int node_tile,
                                 long long rows_per_chunk) {
  extern __shared__ float2 hist[];  // [warps][node_tile * n_bins]
  const int f = blockIdx.x;
  const int chunk = blockIdx.y;
  const int node0 = blockIdx.z * node_tile;
  const int nt = min(node_tile, n_nodes - node0);
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cells = nt * n_bins;
  float2* mine = hist + (long long)warp * node_tile * n_bins;

  for (int c = lane; c < cells; c += 32) mine[c] = make_float2(0.0f, 0.0f);
  __syncwarp();

  const long long r_begin = (long long)chunk * rows_per_chunk;
  const long long r_end = min(n, r_begin + rows_per_chunk);
  const long long per_warp = (r_end - r_begin + warps - 1) / warps;
  const long long w_begin = r_begin + warp * per_warp;
  const long long w_end = min(r_end, w_begin + per_warp);

  for (long long base = w_begin; base < w_end; base += 32) {
    const long long r = base + lane;
    int b = 0, m = -1;
    float gg = 0.0f, hh = 0.0f;
    if (r < w_end) {
      b = bins[r * d + f];
      const int mm = __ldg(local + r) - node0;
      if (mm >= 0 && mm < nt && b < n_bins) {
        m = mm;
        gg = __ldg(g + r);
        hh = __ldg(h + r);
      }
    }
    // the live rows of this group, visited in ascending row order
    unsigned live = __ballot_sync(0xffffffffu, m >= 0);
    while (live) {
      const int j = __ffs(live) - 1;
      live &= live - 1;
      const int bj = __shfl_sync(0xffffffffu, b, j);
      const int mj = __shfl_sync(0xffffffffu, m, j);
      const float gj = __shfl_sync(0xffffffffu, gg, j);
      const float hj = __shfl_sync(0xffffffffu, hh, j);
      if ((bj & 31) == lane) {
        float2 c = mine[mj * n_bins + bj];
        c.x += gj;
        c.y += hj;
        mine[mj * n_bins + bj] = c;
      }
    }
  }
  __syncthreads();

  // warps in warp order → this chunk's partial of the tile's cells
  float2* out = partial + ((long long)chunk * d + f) * n_nodes * n_bins +
                (long long)node0 * n_bins;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    float2 s = hist[c];
    for (int w = 1; w < warps; ++w) {
      const float2 v = hist[(long long)w * node_tile * n_bins + c];
      s.x += v.x;
      s.y += v.y;
    }
    out[c] = s;
  }
}

// out[cell] = sum over chunks, in chunk order
__global__ void gbt_hist_sum_chunks(const float2* __restrict__ partial,
                                    float2* __restrict__ out, long long cells,
                                    int chunks) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  float2 s = partial[c];
  for (int k = 1; k < chunks; ++k) {
    const float2 v = partial[(long long)k * cells + c];
    s.x += v.x;
    s.y += v.y;
  }
  out[c] = s;
}

bool bad_shape(long long n, int d, int n_nodes, int n_bins) {
  return n < 1 || d < 1 || d > 65535 || n_nodes < 1 || n_nodes > kMaxNodes ||
         n_bins < 1 || n_bins > kMaxBins;
}

}  // namespace

// floats of chunk scratch the launch needs (0: one chunk, none needed);
// -1 for shapes the kernel does not take
extern "C" long long gbt_hist_scratch_floats(long long n, int d, int n_nodes,
                                             int n_bins) {
  if (bad_shape(n, d, n_nodes, n_bins)) return -1;
  const Plan p = plan(n, d, n_nodes, n_bins);
  if (p.chunks == 1) return 0;
  return (long long)p.chunks * d * n_nodes * n_bins * 2;
}

extern "C" int gbt_hist_launch(const void* bins, const void* local,
                               const void* g, const void* h, void* scratch,
                               void* out, long long n, int d, int n_nodes,
                               int n_bins, int device, void* stream) {
  if (bad_shape(n, d, n_nodes, n_bins)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(n, d, n_nodes, n_bins);
  if (p.chunks > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)p.warps * p.node_tile * n_bins * sizeof(float2);
  // the plan never asks for more than kSmemMax: allow that much once per
  // device (not per launch, so that a launch can be captured in a graph)
  static bool allowed[64] = {};
  if (smem > 48 * 1024 && !(device >= 0 && device < 64 && allowed[device])) {
    err = cudaFuncSetAttribute(gbt_hist_partial,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < 64) allowed[device] = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  float2* partial = p.chunks > 1 ? (float2*)scratch : (float2*)out;
  dim3 grid((unsigned)d, (unsigned)p.chunks, (unsigned)p.tiles);
  gbt_hist_partial<<<grid, p.warps * 32, smem, st>>>(
      (const uint8_t*)bins, (const int*)local, (const float*)g,
      (const float*)h, partial, n, d, n_nodes, n_bins, p.node_tile,
      p.rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.chunks == 1) return (int)err;
  const long long cells = (long long)d * n_nodes * n_bins;
  const int threads = 256;
  gbt_hist_sum_chunks<<<(unsigned)((cells + threads - 1) / threads), threads, 0,
                        st>>>(partial, (float2*)out, cells, p.chunks);
  return (int)cudaGetLastError();
}

extern "C" const char* gbt_hist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
