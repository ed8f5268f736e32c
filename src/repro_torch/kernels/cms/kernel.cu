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
// sketches of [5, 2048], 1,408 lanes) it moves about 3 MB, a microsecond
// of HBM time; the in-order tiles (a barrier after each query pass and
// each update pass) and the launch set its time.
//
// Design.  The TPU kernel keeps the sketch resident in VMEM across its
// sequential grid steps and turns each tile into [TB, W] one-hot products
// for the MXU.  Here one block owns one sketch (grid = n): it stages the
// [5, W] counters in shared memory (40 KiB at W = 2048), streams the tiles
// in order inside the block, gathers the estimates from shared memory,
// and applies the tile's increments with shared-memory atomicAdd (integer
// adds, so their order does not matter).  The one-hot grids are not
// ported.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 5;
constexpr int kThreads = 256;

template <bool kWork>
__global__ void __launch_bounds__(kThreads) cms_kernel(
    const int32_t* __restrict__ idx,        // [B, kDepth]
    const int32_t* __restrict__ mask,       // [n, B]
    const int32_t* __restrict__ counts_in,  // [n, kDepth, W]
    int32_t* __restrict__ counts_out,       // [n, kDepth, W]
    int32_t* __restrict__ est,              // [n, B]
    int B, int W, int tile) {
  if (!kWork) return;
  extern __shared__ int32_t sk[];           // [kDepth * W]
  const int cells = kDepth * W;
  const long long base = (long long)blockIdx.x * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x)
    sk[i] = counts_in[base + i];
  __syncthreads();

  const int32_t* m = mask + (long long)blockIdx.x * B;
  int32_t* e = est + (long long)blockIdx.x * B;
  for (int t0 = 0; t0 < B; t0 += tile) {
    const int t1 = min(t0 + tile, B);
    // query: every lane of the tile against the sketch at the tile start
    for (int b = t0 + threadIdx.x; b < t1; b += blockDim.x) {
      int32_t q = 0;
      if (m[b] > 0) {
        q = INT_MAX;
        for (int d = 0; d < kDepth; ++d) {
          const int col = idx[(long long)b * kDepth + d];
          q = min(q, (col >= 0 && col < W) ? sk[d * W + col] : 0);
        }
      }
      e[b] = q;
    }
    __syncthreads();
    // update: the tile's masked lanes add 1 to their five cells
    for (int b = t0 + threadIdx.x; b < t1; b += blockDim.x) {
      if (m[b] > 0) {
        for (int d = 0; d < kDepth; ++d) {
          const int col = idx[(long long)b * kDepth + d];
          if (col >= 0 && col < W) atomicAdd(&sk[d * W + col], 1);
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < cells; i += blockDim.x)
    counts_out[base + i] = sk[i];
}

template <typename K>
int launch_with(K kernel, const void* idx, const void* mask,
                const void* counts_in, void* counts_out, void* est, int n,
                int B, int W, int tile, void* stream) {
  const size_t smem = sizeof(int32_t) * kDepth * (size_t)W;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(mask),
      static_cast<const int32_t*>(counts_in),
      static_cast<int32_t*>(counts_out), static_cast<int32_t*>(est), B, W,
      tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// idx int32[B, 5]; mask int32[n, B]; counts_in/out int32[n, 5, W];
// est int32[n, B] (device addresses).  Returns a cudaError_t; 0 means the
// launch was accepted.
int cms_launch(const void* idx, const void* mask, const void* counts_in,
               void* counts_out, void* est, int n, int B, int W, int tile,
               void* stream) {
  return launch_with(cms_kernel<true>, idx, mask, counts_in, counts_out, est,
                     n, B, W, tile, stream);
}

// The same launch of a kernel that does nothing: the launch floor.
int cms_empty_launch(const void* idx, const void* mask, const void* counts_in,
                     void* counts_out, void* est, int n, int B, int W,
                     int tile, void* stream) {
  return launch_with(cms_kernel<false>, idx, mask, counts_in, counts_out,
                     est, n, B, W, tile, stream);
}

const char* cms_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
