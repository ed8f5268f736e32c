// Count-min sketch update + query for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_cms_kernel` in
// src/repro/kernels/cms/kernel.py (launcher `cms_update_query`, pallas_call
// at line 62), and computes what `cms_update_query_ref` computes, bit for
// bit, for n sketches at once over one shared batch of row indices.
//
// Semantics (the reference's tile order, which the result depends on): the
// batch streams in tiles of `tile` lanes, in order.  Each masked lane's
// estimate is min_d counts[d, idx[b, d]] against the sketch as it stood at
// the start of the lane's tile; then every masked lane of the tile adds 1
// to its five cells.  Unmasked lanes report 0 and add nothing.  An index
// outside [0, W) matches no cell, as in the one-hot oracle: it reads 0 and
// adds nothing.
//
// What bounds it: nothing the card is short of.  At the rack's shape (32
// sketches of [5, 2048], 1,408 lanes, each lane masked on about one sketch
// in 32) it moves about 3 MB, a microsecond of HBM time, and does some
// twenty thousand integer operations.  Latency sets its time: the launch,
// the dependent reads of the mask and of the masked lanes' columns, and the
// copy of each sketch in and out.
//
// A fleet of P racks launches its P x n sketches at once: sketch s reads
// the row indices of point s / n (an index stride of 0 shares one batch of
// indices between all sketches, as one rack's launch does).  At the
// rack's shape a launch for P = 4 and 12 points (128 and 384 blocks) takes
// 7.3 and 22.8 us, against 27 and 81 for P one-rack launches; at P = 12
// the batch moves 36 MB, 10.8 us of HBM time (chip_smoke.py, NVIDIA H100
// 80GB HBM3, 700 W).
//
// Design.  The TPU kernel keeps the sketch resident in VMEM across its
// sequential grid steps and turns each tile into [TB, W] one-hot products
// for the MXU.  Here one block of 512 threads owns one sketch (grid = n):
//   1. the block's mask words are in flight while it copies its [5, W]
//      counters into shared memory with 16-byte loads (a scalar tail where
//      5W is not a multiple of 4 or the sketch is not 16-byte aligned);
//   2. a ballot per warp and a scan over the block's warp counts compact
//      the masked lanes of a unit of whole tiles (up to 4,096 lanes) into a
//      shared list in lane order: lane, tile, five columns.  Unmasked lanes
//      get est = 0 in the same coalesced pass.  Only listed lanes read
//      their columns, and those reads are in flight during the scan;
//   3. the tiles need no barrier between them: a listed lane's estimate in
//      row d is the counter at the start of the unit plus the number of
//      listed lanes of earlier tiles (a prefix of the list, found by binary
//      search) with the same column in row d, which is what the sketch
//      holds at the start of its tile.  A tile with no masked lane costs
//      nothing.  Then every listed lane adds its five cells with
//      shared-memory atomicAdd (integer adds, order-free);
//   4. the sketch goes back out with 16-byte stores.
// A tile longer than a unit is queried over all its lanes first and then
// updated, unit by unit.  The one-hot grids are not ported.  Five blocks
// per sketch, one row each, were tried and were slower (PERF.md): the
// block that answers still lists every masked lane, and its reads of the
// other rows' counters add a round trip to global memory.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 6.3 us on the
// device per launch at the rack's shape with masks of density 1/32,
// against 13.7-13.9 us for the design it replaced (tiles walked in order, each
// pass reading every mask word); PERF.md has the numbers and their runs.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 5;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                        // lanes per thread per unit
constexpr int kUnitMax = kPer * kThreads;      // 4,096 lanes
constexpr int kEntryWords = 2 + kDepth;        // lane, tile, five columns
constexpr int kFixedWords = kPer * kWarps + 1; // warp counts and the total
constexpr int kMaxSmem = 232448;               // one block on Hopper

// Lanes in one unit: the batch rounded up to whole passes of the block, at
// most 4,096 and at most what shared memory holds beside the sketch
// (kernel.py mirrors it).  Below one pass the launch is refused.
int unit_lanes(int B, int W) {
  long long fit = (kMaxSmem / 4 - (long long)kDepth * W - kFixedWords) /
                  kEntryWords;
  fit = fit / kThreads * kThreads;
  long long want = ((long long)B + kThreads - 1) / kThreads * kThreads;
  want = want < kThreads ? kThreads : want;
  want = want > kUnitMax ? kUnitMax : want;
  return (int)(fit < want ? fit : want);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copy n words, 16 bytes at a time where both ends allow it.
__device__ __forceinline__ void copy_words(int32_t* dst, const int32_t* src,
                                           int n, bool from_global) {
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    const int n4 = n / 4;
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      d4[i] = from_global ? __ldg(s4 + i) : s4[i];
    done = 4 * n4;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = from_global ? __ldg(src + i) : src[i];
}

struct Shared {
  int32_t* row;    // [kDepth * W] the sketch
  int32_t* lane;   // [unit] listed lanes, in lane order
  int32_t* tile;   // [unit] their tiles
  int32_t* col;    // [kDepth][unit] their columns, one row of the sketch
                   // after another
  int32_t* wc;     // [kPer * kWarps + 1] warp counts, then the total
  int unit;
};

// The mask words of lanes [u0, u1), kPer per thread, pass-major.
__device__ __forceinline__ void load_masks(const int32_t* m, int u0, int u1,
                                           int (&mk)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int b = u0 + k * kThreads + threadIdx.x;
    mk[k] = b < u1 ? __ldg(m + b) : 0;
  }
}

// List the masked lanes of [u0, u1) in lane order; unmasked lanes get
// est = 0 when `zero_est`.  A masked lane's columns are in flight while the
// block counts.  Returns the number listed.
__device__ __forceinline__ int compact(const int (&mk)[kPer], int u0, int u1,
                                       int tile,
                                       const int32_t* __restrict__ idx,
                                       int32_t* e, bool zero_est,
                                       const Shared& s) {
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const unsigned lt = (1u << ln) - 1u;
  unsigned bal[kPer];
  int col[kPer][kDepth];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int b = u0 + k * kThreads + tid;
    bal[k] = __ballot_sync(0xffffffffu, mk[k] > 0);
    if (ln == 0) s.wc[k * kWarps + warp] = __popc(bal[k]);
    if (mk[k] > 0) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d)
        col[k][d] = __ldg(idx + (long long)b * kDepth + d);
    } else if (zero_est && b < u1) {
      e[b] = 0;
    }
  }
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the kPer * kWarps counts
    constexpr int kEach = kPer * kWarps / 32;
    int v[kEach], sum = 0;
#pragma unroll
    for (int i = 0; i < kEach; ++i) {
      v[i] = s.wc[kEach * ln + i];
      sum += v[i];
    }
    int inc = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, inc, off);
      if (ln >= off) inc += up;
    }
    int run = inc - sum;
#pragma unroll
    for (int i = 0; i < kEach; ++i) {
      s.wc[kEach * ln + i] = run;
      run += v[i];
    }
    if (ln == 31) s.wc[kPer * kWarps] = inc;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (mk[k] > 0) {
      const int b = u0 + k * kThreads + tid;
      const int pos = s.wc[k * kWarps + warp] + __popc(bal[k] & lt);
      s.lane[pos] = b;
      s.tile[pos] = b / tile;
#pragma unroll
      for (int d = 0; d < kDepth; ++d) s.col[d * s.unit + pos] = col[k][d];
    }
  }
  const int listed = s.wc[kPer * kWarps];
  __syncthreads();
  return listed;
}

// Estimates of the listed lanes against the sketch at the start of each
// one's tile: the counter now plus the listed lanes of earlier tiles (a
// prefix of the list, found by binary search) that share the column.
__device__ __forceinline__ void query(int listed, int W, int32_t* e,
                                      const Shared& s) {
  for (int i = threadIdx.x; i < listed; i += blockDim.x) {
    const int ti = s.tile[i];
    int lo = 0, hi = i;               // first entry of tile ti
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s.tile[mid] < ti) lo = mid + 1; else hi = mid;
    }
    int c[kDepth], v[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      c[d] = s.col[d * s.unit + i];
      v[d] = (c[d] >= 0 && c[d] < W) ? s.row[d * W + c[d]] : 0;
    }
#pragma unroll 4
    for (int j = 0; j < lo; ++j) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d) v[d] += s.col[d * s.unit + j] == c[d];
    }
    int q = INT_MAX;
#pragma unroll
    for (int d = 0; d < kDepth; ++d)
      q = min(q, (c[d] >= 0 && c[d] < W) ? v[d] : 0);
    e[s.lane[i]] = q;
  }
}

// Every listed lane adds 1 to its five cells.
__device__ __forceinline__ void update(int listed, int W, const Shared& s) {
  for (int i = threadIdx.x; i < listed; i += blockDim.x) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int col = s.col[d * s.unit + i];
      if (col >= 0 && col < W) atomicAdd(&s.row[d * W + col], 1);
    }
  }
}

template <bool kWork>
__global__ void __launch_bounds__(kThreads) cms_kernel(
    const int32_t* __restrict__ idx,        // [P, B, kDepth], P = n / per
    const int32_t* __restrict__ mask,       // [n, B]
    const int32_t* __restrict__ counts_in,  // [n, kDepth, W]
    int32_t* __restrict__ counts_out,       // [n, kDepth, W]
    int32_t* __restrict__ est,              // [n, B]
    long long idx_stride, int per, int B, int W, int tile, int unit) {
  if (!kWork) return;
  idx += (long long)(blockIdx.x / per) * idx_stride;
  extern __shared__ __align__(16) int32_t sm[];
  const int cells = kDepth * W;
  Shared s;
  s.row = sm;
  s.lane = s.row + cells;
  s.tile = s.lane + unit;
  s.col = s.tile + unit;
  s.wc = s.col + unit * kDepth;
  s.unit = unit;
  const long long base = (long long)blockIdx.x * cells;
  const int32_t* m = mask + (long long)blockIdx.x * B;
  int32_t* e = est + (long long)blockIdx.x * B;

  // whole tiles per unit; a tile longer than a unit goes unit by unit
  const bool long_tile = tile > unit;
  const int span = long_tile ? tile : unit / tile * tile;
  int mk[kPer];
  load_masks(m, 0, min(long_tile ? unit : span, B), mk);
  copy_words(s.row, counts_in + base, cells, true);
  __syncthreads();

  for (int t0 = 0; t0 < B; t0 += span) {
    const int t1 = min(t0 + span, B);
    if (!long_tile) {
      if (t0 > 0) load_masks(m, t0, t1, mk);
      const int listed = compact(mk, t0, t1, tile, idx, e, true, s);
      query(listed, W, e, s);
      __syncthreads();
      update(listed, W, s);
      continue;
    }
    for (int pass = 0; pass < 2; ++pass) {   // query all, then update all
      for (int u0 = t0; u0 < t1; u0 += unit) {
        const int u1 = min(u0 + unit, t1);
        if (u0 > 0 || pass > 0) load_masks(m, u0, u1, mk);
        const int listed = compact(mk, u0, u1, tile, idx, e, pass == 0, s);
        if (pass == 0) query(listed, W, e, s);
        else update(listed, W, s);
      }
      __syncthreads();
    }
  }
  __syncthreads();
  copy_words(counts_out + base, s.row, cells, false);
}

long long smem_bytes(int B, int W) {
  return 4LL * ((long long)kDepth * W +
                (long long)kEntryWords * unit_lanes(B, W) + kFixedWords);
}

template <typename K>
int launch_with(K kernel, const void* idx, long long idx_stride, int per,
                const void* mask, const void* counts_in, void* counts_out,
                void* est, int n, int B, int W, int tile, void* stream) {
  const int unit = unit_lanes(B, W);
  if (unit < kThreads || per < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes(B, W);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(mask),
      static_cast<const int32_t*>(counts_in),
      static_cast<int32_t*>(counts_out), static_cast<int32_t*>(est),
      idx_stride, per, B, W, tile, unit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// n sketches, one block each: mask int32[n, B], counts_in/out
// int32[n, 5, W], est int32[n, B]; sketch s reads its row indices at
// idx + (s / per) * idx_stride (int32[n / per, B, 5] with idx_stride = 5B;
// 0 shares one idx[B, 5]) (device addresses).  Returns a cudaError_t; 0
// means the launch was accepted.
int cms_batched_launch(const void* idx, long long idx_stride, int per,
                       const void* mask, const void* counts_in,
                       void* counts_out, void* est, int n, int B, int W,
                       int tile, void* stream) {
  return launch_with(cms_kernel<true>, idx, idx_stride, per, mask,
                     counts_in, counts_out, est, n, B, W, tile, stream);
}

// The same launch, every sketch reading one idx[B, 5], of a kernel that
// does nothing: the launch floor.
int cms_empty_launch(const void* idx, const void* mask, const void* counts_in,
                     void* counts_out, void* est, int n, int B, int W,
                     int tile, void* stream) {
  return launch_with(cms_kernel<false>, idx, 0, 1, mask, counts_in,
                     counts_out, est, n, B, W, tile, stream);
}

const char* cms_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
