// tree_shap: exact interventional TreeSHAP phi (n, d) in margin space of a
// forest of perfect binary trees of static depth D <= 5, from the compact
// per-tree tables that ops/tree_shap.build_tables makes once per explainer
// (L = 2^D leaves, V = 2^D violation patterns, N = 2^D - 1 internal nodes in
// heap order, G = kGroup trees a group):
//
//   node_key (T, 32) int32                split bin << 8 | split feature of
//                                          each internal node (padded to 32)
//   leaf_sums (T, L, D, V) float32        for each pattern v of leaf l's
//                                          failed path conditions (bit k:
//                                          level k fails), s[l, k, v] = the
//                                          sum over the level subsets m (in
//                                          ascending order) that v leaves
//                                          intact of coef[m, k, l]: Shapley
//                                          weight x leaf value x background
//                                          factor (0 off the canonical
//                                          levels)
//   group_order (T * N) int32             per group of G trees, its nodes
//                                          (w * N + q for tree w of the
//                                          group) grouped by split feature,
//                                          ascending (tree, node) within one
//   group_start, group_count (groups, d)  each feature's run in group_order
//
// bins (n, d) int32 are the rows' bin ids. For each row and tree,
//   pat[l]   = bitmask of the levels k whose path condition fails (right
//              child: bin > thr; left child: bin <= thr),
//   node[q]  = sum over the leaves l below internal node q (at level k), in
//              ascending l, of leaf_sums[t, l, k, pat[l]]: the contribution
//              of q's split feature;
// for each group g and feature f, part[g, f] = the node values of f's run in
// group_order, added in that order; phi[f] = part[0, f] + part[1, f] + ...
// in group order. Every add is a float32 add in an order fixed by the
// forest's shape (T, D, d) alone, never by n or by the rows beside a row;
// no atomics, no tensor cores: the result is deterministic and a row's phi
// is bitwise the same in any batch.
//
// Replaces fraud_detection_tpu/ops/pallas_kernels.py::_chisel_kernel (and
// the tables of _chisel_tables). The TPU version restates the post-
// processing as three dense matmuls per (row block, tree), padded to the
// (8, 128) tiling, ~0.4 MFLOP per (row, tree) at depth 5. Here the subset
// loop, which depends on the row only through pat[l], is folded into
// leaf_sums when the explainer is built.
//
// Bound on the H100: bytes, the tables once (~2.1 MB at 100 trees of depth
// 5, leaf_sums 2.05 MB of it; fewer where this run's rows touch fewer
// (tree, leaf, pattern) entries), ~0.6 us at 3.35 TB/s; operations ~2*L*D
// per (row, tree), ~33 M for 1,024 rows x 100 trees, ~0.5 us at the f32
// rate.
//
// Design: tree-stationary. The grid is (tree group, row chunk), about one
// block an SM. Lane 0 of warp w stages tree w of the block's group into
// shared memory with 1-D TMA bulk copies (cp.async.bulk, completing on the
// warp's own mbarrier; 8 x 20.6 KB at depth 5), so a (row, tree) reads no
// table from global memory and the tables cross L2 once per block, not once
// per row. Warp w is tree w and lane r is row r of a 32-row tile. A thread
// walks its (row, tree) alone in registers, depth first and unrolled at
// compile time: N compares, and L*D conflict-free shared reads of leaf_sums
// (the lanes of a warp differ only in pat, the fastest axis) summed into N
// node registers - a short chain with much independent work, and no
// shuffles. The warps then write their node values to shared memory, and
// warp w sums the runs of features w, w + 8, ... side by side (lanes =
// rows: coalesced writes) while the next tile's bins are already loading.
// With one group the block writes phi; with more it writes a (groups, d, n)
// partial, and a second small kernel, launched as its programmatic
// dependent, adds the groups in order. A lone request's 8-row bucket still
// gets one block a group (13 at the 100-tree recipe), one tree a warp.
//
// The launcher allocates nothing (the wrapper passes the partial), does not
// synchronise, runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 8;  // trees a block holds: 8 x 20.6 KB at depth 5
constexpr int kThreads = kGroup * 32;
constexpr int kMaxDepth = 5;
constexpr int kMaxD = 128;
constexpr int kKeyWords = 32;  // node_key row, padded: a 16-byte multiple
constexpr int kBarrierBytes = 128;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(0u)
        : "memory");
  }
}

template <int D>
struct Shape {
  static constexpr int L = 1 << D;
  static constexpr int N = L - 1;
  static constexpr int V = L;
  static constexpr int kLeafWords = L * D * V;
  static constexpr int kTreeWords = kKeyWords + kLeafWords;
};

// the dynamic shared memory of one block, in bytes
template <int D>
constexpr long long smem_bytes(int d) {
  using S = Shape<D>;
  return kBarrierBytes +
         4LL * (kGroup * S::kTreeWords + kGroup * S::N * 32 + 32 * (d | 1) +
                kGroup * S::N + 2 * d);
}

// One (row, tree), depth first from heap node Q at level K, whose path so
// far fails the levels in p: at an internal node, compare and recurse left
// then right; at leaf l = Q - N, add its D sums into the nodes above it.
// The recursion is resolved at compile time, so p and node[] stay in
// registers, and the leaves arrive in ascending l.
template <int D, int K, int Q>
__device__ __forceinline__ void walk(int p, const int* key, const float* ls,
                                     const int* rb, float* node) {
  using S = Shape<D>;
  if constexpr (K == D) {
    constexpr int l = Q - S::N;
    const float* s = ls + l * D * S::V + p;
#pragma unroll
    for (int k = 0; k < D; ++k) node[(1 << k) - 1 + (l >> (D - k))] += s[k * S::V];
  } else {
    const int w = key[Q];
    const int right = rb[w & 0xff] > (w >> 8) ? 1 : 0;
    walk<D, K + 1, 2 * Q + 1>(p | (right << K), key, ls, rb, node);        // left fails
    walk<D, K + 1, 2 * Q + 2>(p | ((right ^ 1) << K), key, ls, rb, node);  // right fails
  }
}

// The node values of one (row, tree), for the row whose bins are rb, into
// out[q * 32] (q = heap index of the internal node).
template <int D>
__device__ __forceinline__ void node_values(const int* key, const float* ls,
                                            const int* rb, float* out) {
  using S = Shape<D>;
  float node[S::N];
#pragma unroll
  for (int q = 0; q < S::N; ++q) node[q] = 0.0f;
  walk<D, 0, 0>(0, key, ls, rb, node);
#pragma unroll
  for (int q = 0; q < S::N; ++q) out[q * 32] = node[q];
}

template <int D, int Q>  // Q: the features a warp sums, d <= kGroup * Q
__global__ void __launch_bounds__(kThreads, 1)
tree_shap_groups(const int* __restrict__ bins, const int* __restrict__ node_key,
                 const float* __restrict__ leaf_sums,
                 const int* __restrict__ group_order,
                 const int* __restrict__ group_start,
                 const int* __restrict__ group_count, float* __restrict__ out,
                 int n, int d, int n_trees, int tiles_per_block, int direct) {
  using S = Shape<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = d | 1;  // odd row stride: 32 rows at one feature, 32 banks
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* tab = reinterpret_cast<float*>(smem + kBarrierBytes);
  float* nv = tab + kGroup * S::kTreeWords;
  int* row_bins = reinterpret_cast<int*>(nv + kGroup * S::N * 32);
  int* order = row_bins + 32 * dp;
  int* start = order + kGroup * S::N;
  int* count = start + d;

  const int g = blockIdx.x;
  const int t0 = g * kGroup;
  const int trees = min(kGroup, n_trees - t0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // lane 0 of warp w stages tree w of the group: two 1-D bulk copies
  // (its node keys, its leaf sums) completing on the warp's own barrier
  if (lane == 0 && warp < trees) {
    const uint32_t b = smem_addr(bar + warp);
    float* dst = tab + warp * S::kTreeWords;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"(S::kTreeWords * 4)
                 : "memory");
    bulk_load(dst, node_key + (long long)(t0 + warp) * kKeyWords, kKeyWords * 4, bar + warp);
    bulk_load(dst + kKeyWords, leaf_sums + (long long)(t0 + warp) * S::kLeafWords,
              S::kLeafWords * 4, bar + warp);
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // the group's runs: offsets into nv, and each feature's run
  for (int i = threadIdx.x; i < trees * S::N; i += kThreads) {
    order[i] = __ldg(group_order + (long long)t0 * S::N + i) * 32;
  }
  for (int j = threadIdx.x; j < d; j += kThreads) {
    start[j] = __ldg(group_start + (long long)g * d + j);
    count[j] = __ldg(group_count + (long long)g * d + j);
  }

  const int tiles = (n + 31) / 32;
  const int tile_end = min(tiles, (int)(blockIdx.y + 1) * tiles_per_block);
  const float* tree_tab = tab + warp * S::kTreeWords;
  const int* key = reinterpret_cast<const int*>(tree_tab);
  bool staged = false;
  int ahead[Q];
  const auto fetch = [&](int tile) {
    const int rows = min(32, n - tile * 32);
    const int* src = bins + (long long)tile * 32 * d;
#pragma unroll
    for (int c = 0; c < Q; ++c) {
      const int i = threadIdx.x + c * kThreads;
      ahead[c] = i < rows * d ? __ldg(src + i) : 0;
    }
  };
  fetch(blockIdx.y * tiles_per_block);
  for (int tile = blockIdx.y * tiles_per_block; tile < tile_end; ++tile) {
    const int row0 = tile * 32;
    const int rows = min(32, n - row0);
#pragma unroll
    for (int c = 0; c < Q; ++c) {
      const int i = threadIdx.x + c * kThreads;
      if (i < 32 * d) {
        const int r = i / d;
        row_bins[r * dp + (i - r * d)] = ahead[c];
      }
    }
    __syncthreads();  // bins in; the previous tile's sums have read nv
    if (tile + 1 < tile_end) fetch(tile + 1);
    if (warp < trees) {
      if (!staged) {
        barrier_wait(bar + warp);
        staged = true;
      }
      node_values<D>(key, tree_tab + kKeyWords, row_bins + lane * dp,
                     nv + warp * S::N * 32 + lane);
    }
    __syncthreads();  // nv complete; row_bins free for the next tile
    // warp w sums features w, w + kGroup, ...: their runs side by side, each
    // in its own order
    float acc[Q];
    int beg[Q], cnt[Q];
    int longest = 0;
#pragma unroll
    for (int c = 0; c < Q; ++c) {
      const int j = warp + c * kGroup;
      acc[c] = 0.0f;
      beg[c] = j < d ? start[j] : 0;
      cnt[c] = j < d ? count[j] : 0;
      longest = max(longest, cnt[c]);
    }
    for (int p = 0; p < longest; ++p) {
#pragma unroll
      for (int c = 0; c < Q; ++c) {
        if (p < cnt[c]) acc[c] += nv[order[beg[c] + p] + lane];
      }
    }
    const long long row = row0 + lane;
#pragma unroll
    for (int c = 0; c < Q; ++c) {
      const int j = warp + c * kGroup;
      if (j < d && lane < rows) {
        if (direct) {
          out[row * d + j] = acc[c];
        } else {
          out[((long long)g * d + j) * n + row] = acc[c];
        }
      }
    }
  }
}

// phi[row, f] = part[0, f, row] + part[1, f, row] + ... in group order.
// Launched as a programmatic dependent of the first kernel: its blocks may
// start early and wait here until that kernel has finished and its writes
// are visible, which hides this launch behind the first one.
__global__ void __launch_bounds__(256)
tree_shap_sum_groups(const float* __restrict__ part, float* __restrict__ phi,
                     long long n, int d, int groups) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * d) return;
  const long long j = i / n;
  const long long row = i - j * n;
  // L2 loads: the first kernel may still have been running when this began
  float a = __ldcg(part + i);
  for (int g = 1; g < groups; ++g) a += __ldcg(part + ((long long)g * d + j) * n + row);
  phi[row * d + j] = a;
}

struct Launch {
  const int* bins;
  const int* node_key;
  const float* leaf_sums;
  const int* group_order;
  const int* group_start;
  const int* group_count;
  float* partial;
  float* phi;
  int n, d, n_trees, device;
  cudaStream_t stream;
};

template <int D, int Q>
cudaError_t launch(const Launch& a) {
  // the dynamic shared memory each device already allows this kernel: set
  // once, before any launch a CUDA graph captures
  static long long granted[kMaxDevices] = {};
  const long long bytes = smem_bytes<D>(a.d);
  cudaError_t err;
  if (a.device < 0 || a.device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > granted[a.device]) {
    err = cudaFuncSetAttribute(tree_shap_groups<D, Q>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    granted[a.device] = bytes;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a.device);
  if (err != cudaSuccess) return err;
  const int groups = (a.n_trees + kGroup - 1) / kGroup;
  const int tiles = (a.n + 31) / 32;
  // about one block an SM: the row tiles split into sms / groups chunks
  const int chunks = sms / groups > 1 ? sms / groups : 1;
  const int per = (tiles + chunks - 1) / chunks;
  const bool direct = groups == 1;
  tree_shap_groups<D, Q><<<dim3(groups, (tiles + per - 1) / per), kThreads, bytes, a.stream>>>(
      a.bins, a.node_key, a.leaf_sums, a.group_order, a.group_start, a.group_count,
      direct ? a.phi : a.partial, a.n, a.d, a.n_trees, per, direct ? 1 : 0);
  if (!direct) {
    const long long cells = (long long)a.n * a.d;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((cells + 255) / 256));
    cfg.blockDim = dim3(256);
    cfg.stream = a.stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, tree_shap_sum_groups, (const float*)a.partial, a.phi,
                             (long long)a.n, a.d, groups);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// Q = the features each warp sums: 4, 8 or 16 (d <= 32, 64, 128)
template <int D>
cudaError_t launch_width(const Launch& a) {
  if (a.d <= 4 * kGroup) return launch<D, 4>(a);
  if (a.d <= 8 * kGroup) return launch<D, 8>(a);
  return launch<D, 16>(a);
}

}  // namespace

extern "C" int tree_shap_launch(const void* bins, const void* node_key,
                                const void* leaf_sums, const void* group_order,
                                const void* group_start, const void* group_count,
                                void* partial, void* phi, long long n, int d,
                                int n_trees, int depth, int group, int device,
                                void* stream) {
  if (n < 1 || n > 0x7fffffffLL - 31 || d < 1 || d > kMaxD || n_trees < 1 ||
      depth < 1 || depth > kMaxDepth || group != kGroup ||
      (n_trees > kGroup && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Launch a = {(const int*)bins, (const int*)node_key, (const float*)leaf_sums,
                    (const int*)group_order, (const int*)group_start,
                    (const int*)group_count, (float*)partial, (float*)phi,
                    (int)n, d, n_trees, device, (cudaStream_t)stream};
  switch (depth) {
    case 1: return (int)launch_width<1>(a);
    case 2: return (int)launch_width<2>(a);
    case 3: return (int)launch_width<3>(a);
    case 4: return (int)launch_width<4>(a);
    default: return (int)launch_width<5>(a);
  }
}

extern "C" const char* tree_shap_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
