// gbt_hist: gradient/hessian histograms of one tree level,
//     hist[f, m, b, :] = sum over rows r of 1[local_r = m] * 1[bins_rf = b] * (g_r, h_r)
// bins (n, d) uint8 row-major, local (n,) int32 (the row's node within the
// level), g and h (n,) float32; out (d, n_nodes, n_bins, 2) float32. Rows
// whose node lies outside [0, n_nodes) and bins >= n_bins are inert. Any
// n >= 1, 1 <= d <= 65535, 1 <= n_bins <= 256, 1 <= n_nodes <= 65536.
//
// Replaces fraud_detection_tpu/ops/gbt.py::_hist_pallas_kernel (launched by
// _hist_pallas). The TPU version is a one-hot contraction on the MXU: per
// 8192-row block it builds the (rows, n_bins) bin one-hot of each feature
// in VMEM and multiplies the bf16-rounded node-masked [g, h] strip into a
// (2 * n_nodes, d * n_bins) f32 accumulator carried across its sequential
// grid. None of that carries over: the matmul spends 2 * n_nodes * n_bins
// flops per (row, feature) on a one-hot, and its bf16 rounding of g and h
// is an MXU artefact. Here every (row, feature) adds its g and h to one cell.
//
// Bound on the H100: bytes. Each row's bins are read once (n * d B), local,
// g and h once (12 n B), the output written once (8 d n_nodes n_bins B):
// ~2.3 MB, ~0.7 us at 3.35 TB/s at the GBT recipe's last level (n = 31,684,
// d = 30, 16 nodes, 256 bins), below one launch.
//
// Design: deterministic by integer arithmetic, not by order (the scheme of
// XGBoost's GPU hist method and its GradientQuantiser). Three kernels:
//   1. gbt_hist_prepare: max|g| and max|h| over the live rows (node in
//      range), one partial per block (a max does not depend on order), and
//      zero the int64 (d, n_nodes, n_bins, 2) accumulator in scratch.
//   2. gbt_hist_accumulate: every block turns the partials into a quantum
//      per channel, q = 2^(e - 62) with frexp(n * max) = (m, e), so that
//      n * max / q < 2^62 and no int64 cell can overflow (each row adds
//      less than max / q + 1). Each row's g and h become int64 multiples of
//      q rounded away from zero, so a row with h != 0 adds at least one
//      quantum (the fit floors h at 1e-16 and tests a leaf's H > 0). A
//      block takes a chunk of rows and a tile of features (and of nodes,
//      when one feature's table exceeds the budget), keeps ONE int64 table
//      of its tile in shared memory for all its warps (16 B a (node, bin)
//      cell; one copy per warp where a feature's table has <= 64 cells, to
//      spread the contention of the leaf sums), stages its rows' node, (g,
//      h) and the tile's bins in shared memory once (16-byte loads when the
//      tile is the whole row), and every thread adds its own (row, feature)
//      with shared-memory integer atomics. sm_90 has no native 64-bit
//      shared add (atomicAdd on a u64 compiles to an ATOMS.CAST.SPIN loop),
//      so each add is two native 32-bit ATOMS.ADD, the low word's wrap
//      carried into the high word: exact modulo 2^64. The block then adds
//      the tile's non-zero cells into the accumulator with global 64-bit
//      integer atomics (REDG.ADD.64).
//   3. gbt_hist_finish: out = (float)((double)cell * q), rounded to float32
//      once from the exact double product (q is a power of two; the cell's
//      int64 to double conversion is exact below 2^53).
// Integer addition is associative, so the bits never depend on the order
// in which rows, warps or blocks add: the launch plan may depend on the
// card's SM count. Error: each row is off by less than one quantum, so a
// cell is within (rows in it) * q of the exact sum of its float32 inputs
// before the final float32 rounding; q <= n * max * 2^-61, ~1e-14 * max at
// the recipe's n, far below float32's own rounding of a cell.
// Non-finite input: a NaN or +-inf g (h) in a live row makes that channel's
// quantum NaN; its rows then add nothing and every g (h) cell comes out NaN.
// The fit's g and h are finite (a sigmoid times finite weights).
//
// Compiled code: see PERF.md, "gbt_hist" under Findings, for what ptxas
// reports (registers, shared memory, spills) and what the SASS holds.
//
// The launcher allocates nothing (the wrapper passes the scratch), does not
// synchronise, runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // accumulate block
constexpr int kWarps = kThreads / 32;
constexpr int kPrepThreads = 256;
constexpr int kMaxPartials = 256;       // blocks of the max pass
constexpr int kHistBudget = 96 * 1024;  // shared int64 table per block
constexpr int kStageBytes = 32 * 1024;  // most staged bins per step
constexpr int kStageRows = 512;
constexpr int kTinyCells = 64;  // per-feature cells up to which each warp has a copy
constexpr int kSmemCap = 160 * 1024;  // the plan never asks for more
constexpr int kSmemPerSm = 233472;    // 228 KB on an H100 SM
constexpr int kSmemPerBlockReserved = 1024;
constexpr int kMaxNodes = 65536;
constexpr int kMaxBins = 256;

bool bad_shape(long long n, int d, int n_nodes, int n_bins) {
  return n < 1 || d < 1 || d > 65535 || n_nodes < 1 || n_nodes > kMaxNodes ||
         n_bins < 1 || n_bins > kMaxBins;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// how one launch cuts the work: tiles of features x nodes, chunks of rows
struct Grid {
  int copies, feat_tile, feat_tiles, node_tile, node_tiles, stage_rows;
  int chunks, partials;
  long long rows_per_chunk;
  size_t smem;
};

Grid make_grid(long long n, int d, int n_nodes, int n_bins, int sms) {
  Grid p;
  p.copies = (long long)n_nodes * n_bins <= kTinyCells ? kWarps : 1;
  const long long per_node = (long long)n_bins * 16 * p.copies;
  if (n_nodes * per_node <= kHistBudget) {
    p.node_tile = n_nodes;
    long long f = kHistBudget / (n_nodes * per_node);
    if (f > d) f = d;
    if (f > kStageBytes / 16) f = kStageBytes / 16;
    p.feat_tiles = (int)cdiv(d, f);
    p.feat_tile = (int)cdiv(d, p.feat_tiles);  // balanced tiles
  } else {
    p.feat_tile = 1;
    p.feat_tiles = d;
    const int most = (int)(kHistBudget / per_node);
    p.node_tiles = (int)cdiv(n_nodes, most);
    p.node_tile = (int)cdiv(n_nodes, p.node_tiles);
  }
  p.node_tiles = (int)cdiv(n_nodes, p.node_tile);
  int r = (kStageBytes / p.feat_tile) & ~15;
  p.stage_rows = r < 16 ? 16 : (r > kStageRows ? kStageRows : r);
  const size_t hist = (size_t)p.copies * p.feat_tile * p.node_tile * n_bins * 16;
  const size_t stage = (size_t)p.stage_rows * (16 + 4) +
                       (((size_t)p.stage_rows * p.feat_tile + 15) & ~(size_t)15);
  p.smem = hist + stage;
  long long per_sm = kSmemPerSm / ((long long)p.smem + kSmemPerBlockReserved);
  if (per_sm > 2048 / kThreads) per_sm = 2048 / kThreads;
  if (per_sm < 1) per_sm = 1;
  // enough chunks to fill the card once, but no fewer rows in a chunk than
  // half the tile's (node, bin) cells of one feature, so that the global
  // adds of its flush stay fewer than its shared ones
  const long long tiles = (long long)p.feat_tiles * p.node_tiles;
  long long c = per_sm * sms / tiles;
  long long min_rows = (long long)p.node_tile * n_bins / 2;
  if (min_rows < p.stage_rows) min_rows = p.stage_rows;
  const long long by_rows = n / min_rows;
  if (c > by_rows) c = by_rows;
  if (c < 1) c = 1;
  if (c > 65535) c = 65535;
  p.rows_per_chunk = (cdiv(n, c) + 15) & ~15LL;  // 16-byte aligned row spans
  p.chunks = (int)cdiv(n, p.rows_per_chunk);
  const long long cells = (long long)d * n_nodes * n_bins;
  long long parts = cdiv(n > cells ? n : cells, 4LL * kPrepThreads);
  p.partials = (int)(parts > kMaxPartials ? kMaxPartials : parts);
  return p;
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  // |v| as bits: unsigned order is float order, and NaN sorts above +inf
  return __float_as_uint(fabsf(v));
}

// max|g| and max|h| over the live rows, one (g, h) pair per block, and the
// accumulator zeroed
__global__ void __launch_bounds__(kPrepThreads) gbt_hist_prepare(
    const int* __restrict__ local, const float* __restrict__ g,
    const float* __restrict__ h, unsigned* __restrict__ partial,
    longlong2* __restrict__ acc, long long n, int n_nodes, long long cells) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned mg = 0, mh = 0;
  for (long long r = first; r < n; r += stride) {
    const int m = local[r];
    if (m >= 0 && m < n_nodes) {
      mg = max(mg, abs_bits(g[r]));
      mh = max(mh, abs_bits(h[r]));
    }
  }
  for (long long c = first; c < cells; c += stride) acc[c] = make_longlong2(0, 0);
  mg = __reduce_max_sync(0xffffffffu, mg);
  mh = __reduce_max_sync(0xffffffffu, mh);
  __shared__ unsigned wg[kPrepThreads / 32], wh[kPrepThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wg[warp] = mg;
    wh[warp] = mh;
  }
  __syncthreads();
  if (warp == 0) {
    mg = lane < kPrepThreads / 32 ? wg[lane] : 0u;
    mh = lane < kPrepThreads / 32 ? wh[lane] : 0u;
    mg = __reduce_max_sync(0xffffffffu, mg);
    mh = __reduce_max_sync(0xffffffffu, mh);
    if (lane == 0) {
      partial[2 * blockIdx.x] = mg;
      partial[2 * blockIdx.x + 1] = mh;
    }
  }
}

// the exponent e of q = 2^(e - 62) for n rows of at most |max|; false for a
// non-finite max
__device__ bool quantum_exponent(unsigned max_bits, long long n, int* e) {
  if (max_bits >= 0x7f800000u) return false;
  frexp((double)n * (double)__uint_as_float(max_bits), e);
  return true;
}

// v / q rounded away from zero; inv_q = 1 / q is a power of two, so the
// product is exact
__device__ __forceinline__ long long to_fixed(float v, double inv_q) {
  const long long k = (long long)ceil(fabs((double)v) * inv_q);
  return v < 0.0f ? -k : k;
}

// a 64-bit shared-memory integer add as two native 32-bit atomics. The low
// word adds modulo 2^32 and the add that wraps it carries one into the high
// word, so the cell ends at the exact sum modulo 2^64.
__device__ __forceinline__ void add64(unsigned long long* cell, long long v) {
  unsigned* w = reinterpret_cast<unsigned*>(cell);
  const unsigned lo = (unsigned)v;
  const unsigned old = atomicAdd(w, lo);
  const unsigned hi = (unsigned)((unsigned long long)v >> 32) + (old + lo < old ? 1u : 0u);
  if (hi != 0u) atomicAdd(w + 1, hi);
}

__global__ void __launch_bounds__(kThreads) gbt_hist_accumulate(
    const uint8_t* __restrict__ bins, const int* __restrict__ local,
    const float* __restrict__ g, const float* __restrict__ h,
    const unsigned* __restrict__ partial, int partials,
    unsigned long long* __restrict__ acc, double* __restrict__ quanta,
    long long n, int d, int n_nodes, int n_bins, int feat_tile, int feat_tiles,
    int node_tile, int copies, int stage_rows, long long rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double inv_q[2];
  __shared__ int live[2];

  const int f0 = (int)(blockIdx.x % feat_tiles) * feat_tile;
  const int m0 = (int)(blockIdx.x / feat_tiles) * node_tile;
  const int nf = min(feat_tile, d - f0);
  const int nm = min(node_tile, n_nodes - m0);
  const int rows_max = stage_rows;
  const long long copy_cells = (long long)feat_tile * node_tile * n_bins;
  // [copies][feat_tile][node_tile][n_bins] cells of (g, h) int64
  unsigned long long* table = (unsigned long long*)smem;
  longlong2* s_q = (longlong2*)(smem + copies * copy_cells * 16);
  int* s_node = (int*)(s_q + rows_max);
  uint8_t* s_bins = (uint8_t*)(s_node + rows_max);

  if (threadIdx.x < 32) {
    unsigned mg = 0, mh = 0;
    for (int i = threadIdx.x; i < partials; i += 32) {
      mg = max(mg, partial[2 * i]);
      mh = max(mh, partial[2 * i + 1]);
    }
    mg = __reduce_max_sync(0xffffffffu, mg);
    mh = __reduce_max_sync(0xffffffffu, mh);
    if (threadIdx.x == 0) {
      const unsigned bits[2] = {mg, mh};
      for (int ch = 0; ch < 2; ++ch) {
        int e = 0;
        live[ch] = quantum_exponent(bits[ch], n, &e);
        inv_q[ch] = live[ch] ? ldexp(1.0, 62 - e) : 0.0;
        if (blockIdx.x == 0 && blockIdx.y == 0)
          quanta[ch] = live[ch] ? ldexp(1.0, e - 62) : nan("");
      }
    }
  }
  longlong2* table2 = (longlong2*)table;
  for (long long c = threadIdx.x; c < copies * copy_cells; c += kThreads)
    table2[c] = make_longlong2(0, 0);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  unsigned long long* mine = table + (copies > 1 ? warp : 0) * copy_cells * 2;
  const long long r_begin = (long long)blockIdx.y * rows_per_chunk;
  const long long r_end = min(n, r_begin + rows_per_chunk);
  const bool whole_rows = nf == d;
  for (long long s0 = r_begin; s0 < r_end; s0 += rows_max) {
    const int rows = (int)min((long long)rows_max, r_end - s0);
    // stage each row's node (-1: adds nothing to this tile) and its (g, h)
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      const long long r = s0 + i;
      const int mm = local[r] - m0;
      long long qg = 0, qh = 0;
      if (mm >= 0 && mm < nm) {
        if (live[0]) qg = to_fixed(g[r], inv_q[0]);
        if (live[1]) qh = to_fixed(h[r], inv_q[1]);
      }
      s_node[i] = (qg != 0 || qh != 0) ? mm : -1;
      s_q[i] = make_longlong2(qg, qh);
    }
    // ... and the tile's bins of those rows, row-major (rows, nf)
    const uint8_t* src = bins + s0 * d + f0;
    if (whole_rows && ((uintptr_t)src & 15) == 0) {
      const int nbytes = rows * d;
      const int nvec = nbytes / 16;
      for (int i = threadIdx.x; i < nvec; i += kThreads)
        ((uint4*)s_bins)[i] = ((const uint4*)src)[i];
      for (int i = nvec * 16 + threadIdx.x; i < nbytes; i += kThreads) s_bins[i] = src[i];
    } else {
#pragma unroll 4
      for (int p = threadIdx.x; p < rows * nf; p += kThreads) {
        const int i = p / nf, j = p - (p / nf) * nf;
        s_bins[p] = src[(long long)i * d + j];
      }
    }
    __syncthreads();
    // every thread adds its own (row, feature): lanes take consecutive rows
    // of one feature
    for (int p = threadIdx.x; p < rows * nf; p += kThreads) {
      const int j = p / rows;
      const int i = p - j * rows;
      const int mm = s_node[i];
      if (mm < 0) continue;
      const int b = s_bins[i * nf + j];
      if (b >= n_bins) continue;
      const longlong2 q = s_q[i];
      unsigned long long* cell = mine + (((long long)j * node_tile + mm) * n_bins + b) * 2;
      if (q.x != 0) add64(cell, q.x);
      if (q.y != 0) add64(cell + 1, q.y);
    }
    __syncthreads();
  }

  // the tile's non-zero cells into the accumulator
  const long long per_feat = (long long)node_tile * n_bins;
  for (long long c = threadIdx.x; c < nf * per_feat; c += kThreads) {
    const int j = (int)(c / per_feat);
    const long long rem = c - j * per_feat;
    const int mm = (int)(rem / n_bins);
    if (mm >= nm) continue;
    const int b = (int)(rem - (long long)mm * n_bins);
    unsigned long long sg = 0, sh = 0;
    for (int w = 0; w < copies; ++w) {
      sg += table[(w * copy_cells + c) * 2];
      sh += table[(w * copy_cells + c) * 2 + 1];
    }
    const long long out = (((long long)(f0 + j) * n_nodes + m0 + mm) * n_bins + b) * 2;
    if (sg != 0) atomicAdd(acc + out, sg);
    if (sh != 0) atomicAdd(acc + out + 1, sh);
  }
}

__global__ void gbt_hist_finish(const longlong2* __restrict__ acc,
                                const double* __restrict__ quanta,
                                float2* __restrict__ out, long long cells) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cells) return;
  const longlong2 v = acc[c];
  out[c] = make_float2((float)((double)v.x * quanta[0]), (float)((double)v.y * quanta[1]));
}

int sm_count(int device) {
  static int cached[64] = {};
  if (device >= 0 && device < 64 && cached[device] > 0) return cached[device];
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || v < 1)
    v = 132;
  if (device >= 0 && device < 64) cached[device] = v;
  return v;
}

}  // namespace

// bytes of scratch one launch needs: the int64 accumulator (d, n_nodes,
// n_bins, 2), then the two float64 quanta (g, h), then the max pass's
// partials; -1 for shapes the kernel refuses
extern "C" long long gbt_hist_scratch_bytes(long long n, int d, int n_nodes,
                                            int n_bins) {
  if (bad_shape(n, d, n_nodes, n_bins)) return -1;
  return (long long)d * n_nodes * n_bins * 16 + 16 + kMaxPartials * 8;
}

extern "C" int gbt_hist_launch(const void* bins, const void* local,
                               const void* g, const void* h, void* scratch,
                               void* out, long long n, int d, int n_nodes,
                               int n_bins, int device, void* stream) {
  if (bad_shape(n, d, n_nodes, n_bins) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Grid p = make_grid(n, d, n_nodes, n_bins, sm_count(device));
  if (p.smem > (size_t)kSmemCap) return (int)cudaErrorInvalidValue;
  // allow kSmemCap once per device (not per launch, so that a launch can
  // be captured in a graph), whatever this launch's size: the kernel's
  // static shared memory counts against the default 48 KB too
  static bool allowed[64] = {};
  if (!(device >= 0 && device < 64 && allowed[device])) {
    err = cudaFuncSetAttribute(gbt_hist_accumulate,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < 64) allowed[device] = true;
  }
  const long long cells = (long long)d * n_nodes * n_bins;
  char* base = (char*)scratch;
  longlong2* acc = (longlong2*)base;
  double* quanta = (double*)(base + cells * 16);
  unsigned* partial = (unsigned*)(base + cells * 16 + 16);
  cudaStream_t st = (cudaStream_t)stream;

  gbt_hist_prepare<<<p.partials, kPrepThreads, 0, st>>>(
      (const int*)local, (const float*)g, (const float*)h, partial, acc, n,
      n_nodes, cells);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((long long)p.feat_tiles * p.node_tiles), (unsigned)p.chunks);
  gbt_hist_accumulate<<<grid, kThreads, p.smem, st>>>(
      (const uint8_t*)bins, (const int*)local, (const float*)g, (const float*)h,
      partial, p.partials, (unsigned long long*)acc, quanta, n, d, n_nodes,
      n_bins, p.feat_tile, p.feat_tiles, p.node_tile, p.copies, p.stage_rows,
      p.rows_per_chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gbt_hist_finish<<<(unsigned)cdiv(cells, 256), 256, 0, st>>>(
      acc, quanta, (float2*)out, cells);
  return (int)cudaGetLastError();
}

extern "C" const char* gbt_hist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
