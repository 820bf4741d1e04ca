// knn_topk: for each row q of a centred float32 matrix xc (m, d), the
// indices of its k nearest other rows by squared euclidean distance
//     d2(q, j) = (|q|^2 - 2 q.x_j) + |x_j|^2
// self excluded, ascending by (d2, index): among equal distances the lowest
// index comes first. xc is contiguous (m, d), sq (m,) holds |x_j|^2 of the
// centred rows, out (m, k) int32. Any m >= 2, 1 <= d <= 128, 1 <= k <= 32,
// k < m. Inputs must be finite.
//
// Replaces fraud_detection_tpu/ops/pallas_kernels.py::_knn_kernel (the
// Pallas TPU body behind knn_topk, launched by _knn_padded). The TPU version
// tiles (query block x key block) on the MXU, pads d to 128 lanes and the
// rows to the block size (padding keys get +inf), folds each tile to
// per-lane candidates and carries 128 candidate slots per query in VMEM
// across the sequential key axis of its grid. None of that carries over.
// Here one thread owns one query row: the query sits in registers, key
// tiles are staged through shared memory and read as broadcasts (every
// thread of a block reads the same key at the same time), and the thread
// keeps a sorted list of its best (d2, index) pairs in registers while it
// walks the keys in ascending order. The ragged edge is masked, not padded:
// keys past m are never candidates and threads past m compute nothing.
//
// Exactness: the dot product is accumulated with fmaf in feature order, in
// plain float32 FMA units. No tensor cores: TF32 keeps ~10 mantissa bits,
// which would swap neighbours whose distances differ in the low bits, and
// the indices are meant to match the plain version exactly wherever the
// distances are not near-ties.
//
// Bound on the H100: operations. Each (query, key) pair costs d FMAs plus
// the combine, the compare and the self test: ~2*m^2*d + 3*m^2 flops over
// 4*(m*d + m + m*k) bytes. At m = 100,000 and d = 30 that is ~6.3e11 flops,
// ~9.4 ms at 67 TFLOP/s (float32 outside the tensor cores); at the default
// training run's m = 158 the work is a few microseconds below one launch.
// The design keeps the inner loop to one 16-byte shared-memory broadcast
// per four FMAs and runs four keys at once for independent FMA chains.
//
// The launcher allocates nothing, does not synchronise, runs on the
// caller's stream (PyTorch's current stream) and returns cudaGetLastError()
// so that a refused launch is reported by the wrapper.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;        // queries per block
constexpr int kTileFloats = 8192;    // 32 KB key tile in shared memory
constexpr int kMaxK = 32;
constexpr int kMaxD = 128;
constexpr int kBigId = 0x7fffffff;   // never a real row

template <int DMAX, int KMAX>
__global__ void __launch_bounds__(kThreads)
knn_topk_kernel(const float* __restrict__ xc, const float* __restrict__ sq,
                int* __restrict__ out, long long m, int d, int k) {
  constexpr int TK = kTileFloats / DMAX;  // keys per tile: 256, 128 or 64
  __shared__ __align__(16) float tile[TK * DMAX];
  __shared__ float tile_sq[TK];

  const long long qi = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = qi < m;

  float q[DMAX];
#pragma unroll
  for (int f = 0; f < DMAX; ++f) {
    q[f] = (live && f < d) ? __ldg(xc + qi * d + f) : 0.0f;
  }
  const float qsq = live ? __ldg(sq + qi) : 0.0f;

  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int s = 0; s < KMAX; ++s) {
    bd[s] = INFINITY;
    bi[s] = kBigId;
  }
  float worst = INFINITY;  // bd[k - 1]
  int worst_i = kBigId;    // bi[k - 1]

  for (long long k0 = 0; k0 < m; k0 += TK) {
    __syncthreads();  // the previous tile is no longer read
    // stage keys k0 .. k0 + TK - 1 row-major at stride DMAX; columns >= d
    // and rows >= m are zero (their candidates are masked below)
    for (int t = threadIdx.x; t < TK * DMAX; t += kThreads) {
      const int r = t / DMAX;
      const int c = t % DMAX;
      const long long row = k0 + r;
      tile[t] = (c < d && row < m) ? __ldg(xc + row * d + c) : 0.0f;
    }
    for (int t = threadIdx.x; t < TK; t += kThreads) {
      const long long row = k0 + t;
      tile_sq[t] = row < m ? __ldg(sq + row) : 0.0f;
    }
    __syncthreads();
    if (!live) continue;

    const long long left = m - k0;
    const int nk = left < TK ? (int)left : TK;
    for (int j = 0; j < nk; j += 4) {  // TK is a multiple of 4
      const float4* r0 = reinterpret_cast<const float4*>(tile + (j + 0) * DMAX);
      const float4* r1 = reinterpret_cast<const float4*>(tile + (j + 1) * DMAX);
      const float4* r2 = reinterpret_cast<const float4*>(tile + (j + 2) * DMAX);
      const float4* r3 = reinterpret_cast<const float4*>(tile + (j + 3) * DMAX);
      float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int f4 = 0; f4 < DMAX / 4; ++f4) {
        const float4 a = r0[f4], b = r1[f4], c = r2[f4], e = r3[f4];
        const float q0 = q[4 * f4], q1 = q[4 * f4 + 1];
        const float q2 = q[4 * f4 + 2], q3 = q[4 * f4 + 3];
        // feature order within each chain; the zero columns past d add
        // exact zeros at the end
        dot[0] = fmaf(q3, a.w, fmaf(q2, a.z, fmaf(q1, a.y, fmaf(q0, a.x, dot[0]))));
        dot[1] = fmaf(q3, b.w, fmaf(q2, b.z, fmaf(q1, b.y, fmaf(q0, b.x, dot[1]))));
        dot[2] = fmaf(q3, c.w, fmaf(q2, c.z, fmaf(q1, c.y, fmaf(q0, c.x, dot[2]))));
        dot[3] = fmaf(q3, e.w, fmaf(q2, e.z, fmaf(q1, e.y, fmaf(q0, e.x, dot[3]))));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long key = k0 + j + u;
        // (|q|^2 - 2 q.x) + |x|^2, rounded in this order like the plain
        // version; 2*dot is exact
        const float d2 =
            __fadd_rn(__fsub_rn(qsq, 2.0f * dot[u]), tile_sq[j + u]);
        const int ki = (int)key;
        const bool better = d2 < worst || (d2 == worst && ki < worst_i);
        if (key < m && key != qi && better) {
          // insert (d2, ki) into the list kept ascending by (d2, index);
          // the largest pair falls off the end. Branch-free selects with
          // constant indices only, from the tail down, so that the list
          // stays in registers: slot s takes its left neighbour when the
          // candidate ranks before that neighbour, the candidate when it
          // ranks before slot s only, else keeps its pair.
#pragma unroll
          for (int s = KMAX - 1; s >= 0; --s) {
            const bool here = d2 < bd[s] || (d2 == bd[s] && ki < bi[s]);
            if (s > 0) {
              const bool left =
                  d2 < bd[s - 1] || (d2 == bd[s - 1] && ki < bi[s - 1]);
              bd[s] = left ? bd[s - 1] : (here ? d2 : bd[s]);
              bi[s] = left ? bi[s - 1] : (here ? ki : bi[s]);
            } else {
              bd[0] = here ? d2 : bd[0];
              bi[0] = here ? ki : bi[0];
            }
          }
#pragma unroll
          for (int s = 0; s < KMAX; ++s) {
            if (s == k - 1) {
              worst = bd[s];
              worst_i = bi[s];
            }
          }
        }
      }
    }
  }

  if (live) {
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      if (s < k) out[qi * k + s] = bi[s];
    }
  }
}

template <int DMAX>
cudaError_t launch_d(const float* xc, const float* sq, int* out, long long m,
                     int d, int k, cudaStream_t stream) {
  const long long blocks = (m + kThreads - 1) / kThreads;
  if (k <= 8) {
    knn_topk_kernel<DMAX, 8><<<(unsigned int)blocks, kThreads, 0, stream>>>(
        xc, sq, out, m, d, k);
  } else {
    knn_topk_kernel<DMAX, kMaxK><<<(unsigned int)blocks, kThreads, 0, stream>>>(
        xc, sq, out, m, d, k);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int knn_topk_launch(const void* xc, const void* sq, void* out,
                               long long m, int d, int k, int device,
                               void* stream) {
  if (m < 2 || m > 0x7fffffffLL || d < 1 || d > kMaxD || k < 1 ||
      k > kMaxK || (long long)k >= m) {
    return (int)cudaErrorInvalidValue;
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* x = (const float*)xc;
  const float* s = (const float*)sq;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 32) return (int)launch_d<32>(x, s, o, m, d, k, st);
  if (d <= 64) return (int)launch_d<64>(x, s, o, m, d, k, st);
  return (int)launch_d<128>(x, s, o, m, d, k, st);
}

extern "C" const char* knn_topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
