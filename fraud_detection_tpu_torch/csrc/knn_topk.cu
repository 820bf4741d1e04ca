// knn_topk: for each row q of a centred float32 matrix xc (m, d), the
// indices of its k nearest other rows by squared euclidean distance
//     d2(q, j) = (|q|^2 - 2 q.x_j) + |x_j|^2
// self excluded, ascending by (d2, index): among equal distances the lowest
// index comes first. xc is contiguous (m, d), sq (m,) holds |x_j|^2 of the
// centred rows, out (m, k) int32. Any m >= 2 (m < 2^31), 1 <= d <= 128,
// 1 <= k <= 32, k < m. Inputs must be finite.
//
// Replaces fraud_detection_tpu/ops/pallas_kernels.py::_knn_kernel (the
// Pallas TPU body behind knn_topk, launched by _knn_padded). The TPU version
// tiles (query block x key block) on the MXU, pads d to 128 lanes and the
// rows to the block size (padding keys get +inf), folds each tile to
// per-lane candidates and carries 128 candidate slots per query in VMEM
// across the sequential key axis of its grid. None of that carries over.
//
// The invariant that makes any split of the work safe. Every (query, key)
// pair's d2 is one chain: fmaf over features 0 .. d-1 in order, starting
// from 0.0f, then __fadd_rn(__fsub_rn(qsq, 2 * dot), sq[j]) -- the
// arithmetic of the earlier one-thread-a-query kernel, whose trailing zero
// features only ever added exact zeros (a chain that starts at +0 never
// holds -0, so fmaf(0, 0, dot) == dot). No dot product is split across
// threads and no tensor core is used: TF32 or 3xTF32 would change the bits.
// So every d2 is bit-identical to that kernel's, (d2, index) is a strict
// total order (d2 compared as floats: -0 == +0, ties to the lower index),
// and the k best and their order cannot depend on how the keys are split
// across threads, blocks or passes: the indices are bitwise those of the
// earlier kernel on every input, wherever they agree with the plain version
// or not.
//
// The design. Pass 1, knn_topk_split, has a grid of (query tiles x key
// splits); a block owns BM queries and walks the keys of its split in tiles
// of BN (above kSmallM rows 128 x 128 for d <= 32, 64 x 64 for more
// features; 32 x 32 at kSmallM rows or fewer). Both sit
// in shared memory feature-major, staged with cp.async; two key buffers, so
// the next tile loads while this one is used. A thread of the 16 x 16 grid
// reads its TM query and TN key values of a feature as 16- or 8-byte loads
// and runs TM x TN independent fmaf chains (8 x 8: four LDS.128 per 64
// FMAs, against one per four in the earlier kernel; 4 x 4 where the 128-row
// tile's shared memory would not fit d > 32). Each d2 is held in
// registers against its query's current k-th best; the few that beat it
// (exact (d2, index) test) go, packed, into the query's 32 candidate slots
// in shared memory (a shared atomic a thread and row). A warp then merges
// each query's candidates into its list by rank -- a key's new position is
// its position in its own sequence plus its rank in the other, read from
// shared memory, so no insertion runs serially -- with a ballot form for
// one or two candidates, a long walk's usual case (about k ln(m/k)
// candidates a query get that far in all). A query with more than 32 (an
// early tile of a long walk) has its row computed again by its warp, lane
// by lane, with the same chain. The keys split over blocks when the
// queries alone would leave SMs idle: the split count minimises waves x
// (tiles a split + 1) at the occupancy the card reports. Each block then
// writes its k best a query as packed keys into a (splits, m, k) scratch,
// and pass 2, knn_topk_merge (a programmatic dependent launch: its blocks
// start while pass 1 runs and wait at griddepcontrol.wait), merges the
// splits with the same rank merge. With one split pass 1 writes the
// indices itself. Ragged edges are masked: rows past m are zero-filled by
// cp.async and never become candidates, and a query's own row never is one.
//
// Packed key: the order-preserving unsigned image of d2 (-0.0 first mapped
// to +0.0, negative d2 -- cancellation between near-duplicate rows -- below
// every non-negative one) in the high word, the index in the low word. An
// empty slot is (+inf, 0x7fffffff), above every real candidate; NaN d2
// never passes the test, as in the earlier kernel.
//
// Bound on the H100: operations. fmaf's product does not depend on the
// order of its operands, so q.x_j and x_j.q are the same bits: the function
// needs the m(m-1)/2 unordered pairs' d FMAs each, then the combine, the
// compare and the self test for every ordered pair: m(m-1)*d + 3*m^2 flops
// over 4*(m*d + m + m*k) bytes. At m = 100,000 and d = 30 that is ~3.3e11
// flops, ~4.9 ms at 67 TFLOP/s (float32 outside the tensor cores). This
// kernel runs every ordered pair's chain (a block owns its queries' lists,
// so a tile's transpose would have to reach another block's), twice the
// FMAs of that bound. At the default training run's m = 158 the work is far
// below one launch, and the design spreads it over tens of blocks so that
// no chain is longer than a tile.
// At m = 100,000 the 8 x 8 thread tile moves one byte of shared memory per
// FMA, the shared-memory pipe's 128 bytes a clock against 128 FMAs a clock,
// so the two pipes pace each other; a larger tile needs more registers
// than two blocks an SM allow.
//
// The launchers allocate nothing, do not synchronise, run on the caller's
// stream (PyTorch's current stream) and return cudaGetLastError() so that a
// refused launch is reported by the wrapper.

#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxK = 32;
constexpr int kMaxD = 128;
constexpr int kBigId = 0x7fffffff;  // never a real row
constexpr int kThreads = 256;       // a 16 x 16 grid of thread tiles
constexpr int kWarps = kThreads / 32;
constexpr long long kSmallM = 4096;  // at or below: 32-row tiles
constexpr int kMaxDevices = 64;
constexpr u64 kEmpty = 0xff8000007fffffffULL;  // (+inf, kBigId)
constexpr int kCap = 32;  // candidates a query a tile kept for the merge

// A 256-thread block is a GY x GX grid of thread tiles; a thread holds TM
// queries x TN keys, so a block's tile is BM = GY * TM queries by BN = GX *
// TN keys. A thread's TM queries are TM / VQ groups of VQ neighbours (one
// 16- or 8-byte load a group), the groups GY * VQ rows apart; its keys
// likewise.
template <int GY_, int TM_, int TN_>
struct Layout {
  static constexpr int GY = GY_, TM = TM_, TN = TN_;
  static constexpr int GX = kThreads / GY;
  static constexpr int BM = GY * TM;
  static constexpr int BN = GX * TN;
  static constexpr int VQ = TM < 4 ? TM : 4;
  static constexpr int VK = TN < 4 ? TN : 4;
  static constexpr int LDQ = BM + 4;  // row strides in shared memory
  static constexpr int LDK = BN + 4;  // (= 4 mod 32: see stage_rows)
  // feature steps unrolled: small thread tiles batch their loads; 8 x 8
  // unrolls twice within the registers of two blocks an SM
  static constexpr int UNROLL = TM * TN <= 4 ? 8 : 2;
  static_assert(BN % 32 == 0 && BM % 4 == 0 && (BM + 4) % 32 == 4 && (BN + 4) % 32 == 4,
                "tile shapes");
  __device__ static int query(int i, int ty) { return (i / VQ) * GY * VQ + ty * VQ + i % VQ; }
  __device__ static int key(int j, int tx) { return (j / VK) * GX * VK + tx * VK + j % VK; }
};

using SmallTile = Layout<16, 2, 2>;  // 32 x 32
using MidTile = Layout<16, 4, 4>;    // 64 x 64
using LargeTile = Layout<16, 8, 8>;  // 128 x 128

template <class L, int DMAX>
constexpr size_t smem_bytes(int k) {
  return sizeof(u64) * (L::BM * (k + kCap)) +
         sizeof(float) * (DMAX * L::LDQ + 2 * (DMAX * L::LDK + L::BN) + 4 * L::BM);
}

__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__device__ __forceinline__ u64 pack(float d, unsigned i) {
  unsigned u = __float_as_uint(d);
  u = u == 0x80000000u ? 0u : u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | i;
}

__device__ __forceinline__ float unpack_d2(u64 key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Merge 32 candidate keys (cs, in shared memory: distinct real keys, none
// in the list, kEmpty in the slots past them) into a list of k ascending
// keys (ls, shared memory), in place. Each key's new position is its own
// position in its sequence plus its rank in the other; those under k are
// written after every lane has read. Lane l ranks candidate l, lane s < k
// list slot s; the candidates are read as 16-byte broadcasts.
__device__ __forceinline__ void merge_into(u64* ls, const u64* cs, int k, int lane) {
  const u64 mine = cs[lane];
  const u64 slot = lane < k ? ls[lane] : kEmpty;
  int rank_c = 0;  // candidates, then list slots, before this lane's candidate
  int rank_l = 0;  // candidates before this lane's list slot
#pragma unroll
  for (int t = 0; t < 32; t += 2) {
    const ulonglong2 c = *reinterpret_cast<const ulonglong2*>(cs + t);
    rank_c += (c.x < mine) + (c.y < mine);
    rank_l += (c.x < slot) + (c.y < slot);
  }
#pragma unroll 4
  for (int t = 0; t < k; ++t) rank_c += ls[t] < mine;
  __syncwarp();
  if (mine != kEmpty && rank_c < k) ls[rank_c] = mine;
  if (lane < k && lane + rank_l < k) ls[lane + rank_l] = slot;
  __syncwarp();
}

// merge_into for n <= kFew candidates (a long walk's usual case): every
// lane loads the n keys at once; a candidate's rank in the list is a
// ballot of the list slots before it.
constexpr int kFew = 2;
__device__ __forceinline__ void merge_few(u64* ls, const u64* cs, int n, int k, int lane) {
  u64 c[kFew];
#pragma unroll
  for (int t = 0; t < kFew; ++t) c[t] = t < n ? cs[t] : kEmpty;
  const u64 slot = lane < k ? ls[lane] : kEmpty;
  int rank_l = 0;
  int pos = kMaxK;  // lane t < n writes candidate t
  u64 mine = kEmpty;
#pragma unroll
  for (int t = 0; t < kFew; ++t) {
    rank_l += c[t] < slot;
    int p = __popc(__ballot_sync(0xffffffffu, slot < c[t]));
#pragma unroll
    for (int u = 0; u < kFew; ++u) p += c[u] < c[t];
    if (lane == t && t < n) {
      pos = p;
      mine = c[t];
    }
  }
  __syncwarp();
  if (pos < k) ls[pos] = mine;
  if (lane < k && lane + rank_l < k) ls[lane + rank_l] = slot;
  __syncwarp();
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage rows [row0, row_end) (at most ROWS) feature-major into dst[f * ld +
// r] and their |x|^2 into dst_sq; rows past row_end and features past d
// read as zeros. A warp copies 4 rows x 8 features: 4 sectors of global
// memory, and with ld = 4 (mod 32) 32 distinct banks of shared memory.
template <int ROWS, int DMAX>
__device__ __forceinline__ void stage_rows(float* dst, int ld, float* dst_sq,
                                           const float* __restrict__ xc,
                                           const float* __restrict__ sq,
                                           unsigned row0, unsigned row_end, int d) {
  constexpr int kFeatureBlocks = DMAX / 8;
  constexpr int kPer = ROWS * DMAX / kThreads;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int b = e >> 5;
    const int r = (b / kFeatureBlocks) * 4 + (e & 3);
    const int f = (b % kFeatureBlocks) * 8 + ((e & 31) >> 2);
    const unsigned row = row0 + r;
    const bool ok = row < row_end && f < d;
    cp_async4(dst + f * ld + r, ok ? xc + (size_t)row * d + f : xc, ok);
  }
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    const bool ok = row0 + r < row_end;
    cp_async4(dst_sq + r, ok ? sq + row0 + r : sq, ok);
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  static_assert(V == 2 || V == 4, "8- or 16-byte loads");
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}

// Pass 1: a block's BM queries against the keys of its split, in tiles of
// BN keys (two key buffers: the next tile loads while this one is used).
// scratch == nullptr: one split, write the indices to out.
template <class L, int DMAX, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
knn_topk_split(const float* __restrict__ xc, const float* __restrict__ sq,
               u64* __restrict__ scratch, int* __restrict__ out, unsigned m, int d,
               int k, long long span) {
  constexpr int BM = L::BM, BN = L::BN, TM = L::TM, TN = L::TN;
  constexpr int LDQ = L::LDQ, LDK = L::LDK;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* lists = reinterpret_cast<u64*>(smem);  // (BM, k), ascending
  u64* cands = lists + BM * k;  // (BM, kCap): this tile's passers, then kEmpty
  float* qs = reinterpret_cast<float*>(cands + BM * kCap);  // (DMAX, LDQ)
  float* ks = qs + DMAX * LDQ;       // 2 x (DMAX, LDK)
  float* ksq = ks + 2 * DMAX * LDK;  // 2 x BN
  float* qsq = ksq + 2 * BN;
  float* thr_d = qsq + BM;  // each query's k-th best: d2 ...
  int* thr_i = reinterpret_cast<int*>(thr_d + BM);  // ... and index
  int* count = thr_i + BM;  // this tile's passers a query (> kCap: too many)

  // the merge pass may start its blocks now; they wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = tid / L::GX;
  const int tx = tid % L::GX;
  const unsigned q0 = blockIdx.x * BM;
  const long long lo64 = (long long)blockIdx.y * span;
  const unsigned lo = (unsigned)(lo64 < m ? lo64 : m);
  const unsigned hi = (unsigned)(lo64 + span < m ? lo64 + span : m);

  stage_rows<BM, DMAX>(qs, LDQ, qsq, xc, sq, q0, m, d);
  stage_rows<BN, DMAX>(ks, LDK, ksq, xc, sq, lo, hi, d);
  cp_async_commit();
  for (int i = tid; i < BM * k; i += kThreads) lists[i] = kEmpty;
  for (int i = tid; i < BM * kCap; i += kThreads) cands[i] = kEmpty;
  for (int i = tid; i < BM; i += kThreads) {
    thr_d[i] = INFINITY;
    thr_i[i] = kBigId;
    count[i] = 0;
  }

  int buf = 0;
  for (unsigned k0 = lo; k0 < hi; k0 += BN, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile in; the last selection is done with the other
    if (k0 + BN < hi) {
      stage_rows<BN, DMAX>(ks + (buf ^ 1) * DMAX * LDK, LDK, ksq + (buf ^ 1) * BN, xc, sq,
                           k0 + BN, hi, d);
      cp_async_commit();
    }
    const float* kt = ks + buf * DMAX * LDK;
    const float* ktsq = ksq + buf * BN;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    }
    // one fmaf chain a pair, features in order
#pragma unroll (L::UNROLL)
    for (int f = 0; f < d; ++f) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / L::VQ; ++g) {
        load_vec<L::VQ>(qs + f * LDQ + L::query(g * L::VQ, ty), a + g * L::VQ);
      }
#pragma unroll
      for (int g = 0; g < TN / L::VK; ++g) {
        load_vec<L::VK>(kt + f * LDK + L::key(g * L::VK, tx), b + g * L::VK);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // the exact (d2, index) test against each query's k-th best, for the
    // rows with a d2 at or under it (NaN never): the passers go to their
    // query's candidate slots
    float kq[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) kq[j] = ktsq[L::key(j, tx)];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = L::query(i, ty);
      const float qq = qsq[r];
      const float td = thr_d[r];
      bool near = false;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        // (|q|^2 - 2 q.x) + |x|^2, rounded in this order; 2*dot is exact
        acc[i][j] = __fadd_rn(__fsub_rn(qq, 2.0f * acc[i][j]), kq[j]);
        near |= acc[i][j] <= td;
      }
      const unsigned q = q0 + r;
      if (near && q < m) {
        const int ti = thr_i[r];
        unsigned pass = 0;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const unsigned key = k0 + L::key(j, tx);
          pass |= (unsigned)(key < hi && key != q && before(acc[i][j], (int)key, td, ti)) << j;
        }
        if (pass) {
          int slot = atomicAdd(count + r, __popc(pass));
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            if ((pass >> j) & 1u) {
              if (slot < kCap) cands[r * kCap + slot] = pack(acc[i][j], k0 + L::key(j, tx));
              ++slot;
            }
          }
        }
      }
    }
    __syncthreads();  // candidates complete

    // selection: warp w merges the candidates of queries w, w + 8, ... into
    // their lists; a query with more than kCap (an early tile of a long
    // walk) has its d2 row computed again by its warp, lane by lane, with
    // the same chain, and merged 32 keys at a time
    const int mine = lane < BM / kWarps ? count[warp + kWarps * lane] : 0;
    for (unsigned todo = __ballot_sync(0xffffffffu, mine > 0); todo; todo &= todo - 1) {
      const int r = warp + kWarps * (__ffs(todo) - 1);
      const unsigned q = q0 + r;
      const int n = __shfl_sync(0xffffffffu, mine, __ffs(todo) - 1);
      u64* ls = lists + r * k;
      u64* cs = cands + r * kCap;
      if (n <= kFew) {
        merge_few(ls, cs, n, k, lane);
      } else if (n <= kCap) {
        merge_into(ls, cs, k, lane);
      } else {
        const float qq = qsq[r];
        for (int c = 0; c < BN; c += 32) {
          const u64 last = ls[k - 1];
          const float td = unpack_d2(last);
          const int ti = (int)(unsigned)last;
          float dot = 0.0f;
#pragma unroll 4
          for (int f = 0; f < d; ++f) dot = fmaf(qs[f * LDQ + r], kt[f * LDK + c + lane], dot);
          // (|q|^2 - 2 q.x) + |x|^2, rounded in this order; 2*dot is exact
          const float dv = __fadd_rn(__fsub_rn(qq, 2.0f * dot), ktsq[c + lane]);
          const unsigned j = k0 + c + lane;
          const bool pass = j < hi && j != q && before(dv, (int)j, td, ti);
          cs[lane] = pass ? pack(dv, j) : kEmpty;
          __syncwarp();
          merge_into(ls, cs, k, lane);
        }
      }
      cs[lane] = kEmpty;
      if (lane == 0) {
        const u64 last = ls[k - 1];
        thr_d[r] = unpack_d2(last);
        thr_i[r] = (int)(unsigned)last;
        count[r] = 0;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  for (int r = warp; r < BM; r += kWarps) {
    const unsigned q = q0 + r;
    if (q >= m) break;
    if (lane < k) {
      const u64 key = lists[r * k + lane];
      if (scratch != nullptr) {
        scratch[((size_t)blockIdx.y * m + q) * k + lane] = key;
      } else {
        out[(size_t)q * k + lane] = (int)(unsigned)key;
      }
    }
  }
}

// Pass 2: a warp a query merges its splits' lists (splits * k packed keys)
// with the same rank merge. Launched as a programmatic dependent of pass 1.
__global__ void __launch_bounds__(kThreads)
knn_topk_merge(const u64* __restrict__ scratch, int* __restrict__ out, unsigned m,
               int k, int splits) {
  __shared__ __align__(16) u64 lists[kWarps][32];
  __shared__ __align__(16) u64 cands[kWarps][32];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned q = blockIdx.x * kWarps + warp;
  if (q >= m) return;
  const int total = splits * k;
  lists[warp][lane] = kEmpty;
  for (int base = 0; base < total; base += 32) {
    const int e = base + lane;
    u64 cand = kEmpty;
    if (e < total) {
      const int s = e / k;
      // L2 loads: pass 1 may still have been running when this block began
      cand = __ldcg(scratch + ((size_t)s * m + q) * k + (e - s * k));
    }
    cands[warp][lane] = cand;
    __syncwarp();
    merge_into(lists[warp], cands[warp], k, lane);
  }
  if (lane < k) out[(size_t)q * k + lane] = (int)(unsigned)lists[warp][lane];
}

struct Plan {
  int splits;      // key splits (grid y)
  int qtiles;      // query tiles (grid x)
  int ktiles;      // key tiles
  int bn;          // keys a tile
  long long span;  // keys a split
};

// The instantiation that takes (m, d) and its dynamic shared memory.
struct Kernel {
  const void* fn;
  size_t smem;
  int bm, bn;
  cudaError_t (*launch)(const float*, const float*, u64*, int*, long long, int, int,
                        const Plan&, size_t, cudaStream_t);
};

template <class L, int DMAX, int MIN_BLOCKS>
cudaError_t launch_split(const float* xc, const float* sq, u64* scratch, int* out,
                         long long m, int d, int k, const Plan& p, size_t smem,
                         cudaStream_t stream) {
  knn_topk_split<L, DMAX, MIN_BLOCKS>
      <<<dim3((unsigned)p.qtiles, (unsigned)p.splits), kThreads, smem, stream>>>(
          xc, sq, scratch, out, (unsigned)m, d, k, p.span);
  return cudaGetLastError();
}

template <class L, int DMAX, int MIN_BLOCKS>
Kernel kernel_of(int k) {
  return {(const void*)knn_topk_split<L, DMAX, MIN_BLOCKS>, smem_bytes<L, DMAX>(k), L::BM,
          L::BN, launch_split<L, DMAX, MIN_BLOCKS>};
}

// The instantiation for (m, d, k), allowed its dynamic shared memory on this
// device, and the blocks an SM the card runs of it: both found once, before
// any launch a CUDA graph captures.
cudaError_t kernel_for(long long m, int d, int k, int device, Kernel* kern, int* per_sm) {
  static size_t granted[kMaxDevices][6] = {};
  static int occupancy[kMaxDevices][6][kMaxK + 1] = {};
  const bool small = m <= kSmallM;
  const int which = (small ? 3 : 0) + (d <= 32 ? 0 : d <= 64 ? 1 : 2);
  switch (which) {
    case 0: *kern = kernel_of<LargeTile, 32, 2>(k); break;
    case 1: *kern = kernel_of<MidTile, 64, 2>(k); break;
    case 2: *kern = kernel_of<MidTile, 128, 1>(k); break;
    case 3: *kern = kernel_of<SmallTile, 32, 1>(k); break;
    case 4: *kern = kernel_of<SmallTile, 64, 1>(k); break;
    default: *kern = kernel_of<SmallTile, 128, 1>(k); break;
  }
  cudaError_t err;
  if (kern->smem > granted[device][which]) {
    err = cudaFuncSetAttribute(kern->fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kern->smem);
    if (err != cudaSuccess) return err;
    granted[device][which] = kern->smem;
  }
  int& blocks = occupancy[device][which][k];
  if (blocks == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern->fn, kThreads,
                                                        kern->smem);
    if (err != cudaSuccess) return err;
    if (blocks < 1) blocks = 1;
  }
  *per_sm = blocks;
  return cudaSuccess;
}

// The grid: the split count that minimises waves x (key tiles a split + one
// tile of set-up), with as many blocks an SM as the card runs at once;
// fewer splits on a tie.
cudaError_t plan_for(long long m, int d, int k, int device, Kernel* kern, Plan* plan) {
  static int sm_count[kMaxDevices] = {};
  int per_sm = 0;
  cudaError_t err = kernel_for(m, d, k, device, kern, &per_sm);
  if (err != cudaSuccess) return err;
  if (sm_count[device] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const long long slots = (long long)sm_count[device] * per_sm;
  const long long qtiles = (m + kern->bm - 1) / kern->bm;
  const long long ktiles = (m + kern->bn - 1) / kern->bn;
  long long best = 1, best_cost = -1;
  for (long long s = 1; s <= ktiles && s <= 4 * slots; ++s) {
    const long long per = (ktiles + s - 1) / s;
    if (s > 1 && (ktiles + per - 1) / per < s) continue;  // an empty split
    const long long cost = ((qtiles * s + slots - 1) / slots) * (per + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  *plan = {(int)best, (int)qtiles, (int)ktiles, kern->bn,
           ((ktiles + best - 1) / best) * kern->bn};
  return cudaSuccess;
}

cudaError_t launch_merge(const u64* scratch, int* out, long long m, int k, int splits,
                         cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((m + kWarps - 1) / kWarps));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, knn_topk_merge, scratch, out,
                                             (unsigned)m, k, splits);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool valid_shape(long long m, int d, int k) {
  return m >= 2 && m <= 0x7fffffffLL && d >= 1 && d <= kMaxD && k >= 1 &&
         k <= kMaxK && (long long)k < m;
}

cudaError_t set_device(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// The launch's shape, as knn_topk_launch chooses it: plan[0] key splits,
// [1] query tiles, [2] keys a tile, [3] keys a split. With more than one
// split the launch needs a scratch of plan[0] * m * k * 8 bytes.
extern "C" int knn_topk_plan(long long m, int d, int k, int device, int* plan) {
  if (!valid_shape(m, d, k)) return (int)cudaErrorInvalidValue;
  Kernel kern;
  Plan p;
  cudaError_t err = set_device(device);
  if (err == cudaSuccess) err = plan_for(m, d, k, device, &kern, &p);
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.splits;
  plan[1] = p.qtiles;
  plan[2] = p.bn;
  plan[3] = (int)p.span;
  return 0;
}

// scratch: scratch_bytes of device memory for the splits' (splits, m, k)
// packed keys; unused (may be null) when the plan has one split, refused
// when it is smaller than the plan needs.
extern "C" int knn_topk_launch(const void* xc, const void* sq, void* scratch,
                               long long scratch_bytes, void* out, long long m, int d,
                               int k, int device, void* stream) {
  if (!valid_shape(m, d, k)) return (int)cudaErrorInvalidValue;
  Kernel kern;
  Plan p;
  cudaError_t err = set_device(device);
  if (err == cudaSuccess) err = plan_for(m, d, k, device, &kern, &p);
  if (err != cudaSuccess) return (int)err;
  const bool split = p.splits > 1;
  if (split && (scratch == nullptr ||
                scratch_bytes < (long long)p.splits * m * k * (long long)sizeof(u64))) {
    return (int)cudaErrorInvalidValue;
  }
  u64* part = split ? (u64*)scratch : nullptr;
  err = kern.launch((const float*)xc, (const float*)sq, part, (int*)out, m, d, k, p,
                    kern.smem, (cudaStream_t)stream);
  if (err != cudaSuccess || !split) return (int)err;
  return (int)launch_merge(part, (int*)out, m, k, p.splits, (cudaStream_t)stream);
}

extern "C" const char* knn_topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
