// tree_shap: exact interventional TreeSHAP phi (n, d) in margin space of a
// forest of perfect binary trees of static depth D <= 5, from the compact
// per-tree tables that ops/tree_shap.build_tables makes once per explainer
// (L = 2^D leaves, V = 2^D violation patterns, N = 2^D - 1 internal nodes):
//
//   path_feat, path_thr (T, L, D) int32   feature and split bin of leaf l's
//                                          ancestor at level k
//   leaf_sums (T, L, V, D) float32        for each pattern v of leaf l's
//                                          failed path conditions (bit k:
//                                          level k fails), s[k] = the sum
//                                          over the level subsets m (in
//                                          ascending order) that v leaves
//                                          intact of coef[m, k, l]: Shapley
//                                          weight x leaf value x background
//                                          factor (0 off the canonical
//                                          levels)
//   node_order (T, N) int32               internal nodes grouped by split
//                                          feature, ascending within one
//   node_start, node_count (T, d) int32   each feature's run in node_order
//
// bins (n, d) int32 are the row's bin ids. For each row and tree,
//   viol[l]  = bitmask of the levels k whose path condition fails (right
//              child: bin > thr; left child: bin <= thr),
//   s[l, k]  = leaf_sums[t, l, viol[l], k],
//   node[q]  = sum of s[l, k] over the leaves l below internal node q (at
//              level k): the contribution of q's split feature,
//   phi[f]  += the node values of f's run in node_order.
//
// Replaces fraud_detection_tpu/ops/pallas_kernels.py::_chisel_kernel (and
// the tables of _chisel_tables). The TPU version restates the post-
// processing as three dense matmuls per (row block, tree), padded to the
// (8, 128) tiling: a signed one-hot gather (d x L*D), a violation count
// against the block-diagonal subset matrix (L*D x M*L) and a scatter with
// the dense (M*L x d) coefficient matrix, ~0.4 MFLOP per (row, tree) at
// depth 5. Here the same function is computed in compact form. The subset
// loop depends on the row only through viol[l], a D-bit pattern, so it is
// folded into leaf_sums when the explainer is built: a (row, tree) costs
// L*D compares, L*D table reads and the sums to N nodes and their features.
//
// Design: one block per row, 8 warps; warp c takes the c-th contiguous
// eighth of the trees (the TPU's sequential tree axis), lane l = leaf l (so
// D <= 5, L <= 32: the cap; deeper forests take the plain body, as the JAX
// package does above depth 5). The row's bins sit in shared memory. For
// each level k the leaves below one node are an aligned run of 2^(D-k)
// lanes, summed by a butterfly of shuffles; lane j then adds feature j's
// node values (and j + 32, ...) into registers across the warp's trees.
// The block sums its warps' partials in warp order. All arithmetic is
// float32 adds in an order fixed by the forest's shape alone (never by n),
// no tensor cores: the result is deterministic and a row's phi does not
// depend on the rows beside it in the batch.
//
// Bound on the H100: bytes of the tables (~2.5 MB at 100 trees of depth 5,
// leaf_sums 2.05 MB of it), ~0.75 us at 3.35 TB/s; operations ~(2*L*D + N)
// per (row, tree), ~36 M for 1,024 rows x 100 trees, ~0.5 us at the f32
// rate.
//
// The launcher allocates nothing, does not synchronise, runs on the
// caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // tree chunks per row
constexpr int kMaxDepth = 5;
constexpr int kMaxNodes = (1 << kMaxDepth) - 1;
constexpr int kMaxD = 128;
constexpr unsigned kFull = 0xffffffffu;

template <int Q>  // features per lane: d <= 32 * Q
__global__ void __launch_bounds__(kWarps * 32)
tree_shap_kernel(const int* __restrict__ bins, const int* __restrict__ path_feat,
                 const int* __restrict__ path_thr,
                 const float* __restrict__ leaf_sums,
                 const int* __restrict__ node_order,
                 const int* __restrict__ node_start,
                 const int* __restrict__ node_count, float* __restrict__ phi,
                 int d, int n_trees, int depth) {
  __shared__ int row_bins[kMaxD];
  __shared__ float node_val[kWarps][kMaxNodes + 1];
  __shared__ float partial[kWarps][kMaxD];
  const long long row = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    row_bins[j] = __ldg(bins + row * d + j);
  }
  __syncthreads();

  const int leaves = 1 << depth;
  const int nodes = leaves - 1;
  const bool leaf_lane = lane < leaves;
  const int per = (n_trees + kWarps - 1) / kWarps;
  const int t_begin = warp * per;
  const int t_end = min(n_trees, t_begin + per);
  float acc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) acc[q] = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    int viol = 0;
    if (leaf_lane) {
      const long long pl = ((long long)t * leaves + lane) * depth;
#pragma unroll
      for (int k = 0; k < kMaxDepth; ++k) {
        if (k < depth) {
          const int b = row_bins[__ldg(path_feat + pl + k)];
          const int right = b > __ldg(path_thr + pl + k) ? 1 : 0;
          const int want = (lane >> (depth - 1 - k)) & 1;
          viol |= (right != want) << k;
        }
      }
    }
    const float* s = leaf_sums + (((long long)t * leaves + lane) * leaves + viol) * depth;
#pragma unroll
    for (int k = 0; k < kMaxDepth; ++k) {
      if (k < depth) {
        float v = leaf_lane ? __ldg(s + k) : 0.0f;
        const int run = 1 << (depth - k);  // the lanes below one level-k node
        for (int off = 1; off < run; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
        if (leaf_lane && (lane & (run - 1)) == 0) {
          node_val[warp][(1 << k) - 1 + (lane >> (depth - k))] = v;
        }
      }
    }
    __syncwarp();
    const long long tn = (long long)t * nodes;
    const long long tf = (long long)t * d;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int j = lane + 32 * q;
      if (j < d) {
        const int beg = __ldg(node_start + tf + j);
        const int cnt = __ldg(node_count + tf + j);
        float a = 0.0f;
        for (int p = 0; p < cnt; ++p) a += node_val[warp][__ldg(node_order + tn + beg + p)];
        acc[q] += a;
      }
    }
    __syncwarp();  // node_val is rewritten by the next tree
  }

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = lane + 32 * q;
    if (j < d) partial[warp][j] = acc[q];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float a = partial[0][j];
    for (int w = 1; w < kWarps; ++w) a += partial[w][j];
    phi[row * d + j] = a;
  }
}

template <int Q>
cudaError_t launch_q(const int* bins, const int* pf, const int* pt,
                     const float* ls, const int* no, const int* ns,
                     const int* nc, float* phi, long long n, int d,
                     int n_trees, int depth, cudaStream_t st) {
  tree_shap_kernel<Q><<<(unsigned)n, kWarps * 32, 0, st>>>(
      bins, pf, pt, ls, no, ns, nc, phi, d, n_trees, depth);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tree_shap_launch(const void* bins, const void* path_feat,
                                const void* path_thr, const void* leaf_sums,
                                const void* node_order, const void* node_start,
                                const void* node_count, void* phi, long long n,
                                int d, int n_trees, int depth, int device,
                                void* stream) {
  if (n < 1 || n > 0x7fffffffLL || d < 1 || d > kMaxD || n_trees < 1 ||
      depth < 1 || depth > kMaxDepth) {
    return (int)cudaErrorInvalidValue;
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* b = (const int*)bins;
  const int* pf = (const int*)path_feat;
  const int* pt = (const int*)path_thr;
  const float* ls = (const float*)leaf_sums;
  const int* no = (const int*)node_order;
  const int* ns = (const int*)node_start;
  const int* nc = (const int*)node_count;
  float* o = (float*)phi;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 32) return (int)launch_q<1>(b, pf, pt, ls, no, ns, nc, o, n, d, n_trees, depth, st);
  if (d <= 64) return (int)launch_q<2>(b, pf, pt, ls, no, ns, nc, o, n, d, n_trees, depth, st);
  return (int)launch_q<4>(b, pf, pt, ls, no, ns, nc, o, n, d, n_trees, depth, st);
}

extern "C" const char* tree_shap_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
