// Batched 128-bit match-action lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_match_kernel` in
// src/repro/kernels/orbit_match/kernel.py (launcher `orbit_match`,
// pallas_call at line 74), and computes what `orbit_match_ref` computes:
//   cidx[b]  = the first occupied entry c with table[c] == hkey[b] (all four
//              32-bit words), or -1;
//   hit[b]   = cidx[b] >= 0;   vhit[b] = hit[b] && valid[cidx[b]] > 0;
//   pop[c]   = the number of lanes with mask > 0 (every lane without a
//              mask) that match entry c, counting every matching entry.
// Flags are true where > 0, so -1 is false.
//
// What bounds it: at one subround's ingress of the paper's rack (B = 336
// lanes against C = 128 entries) it reads about 14 KB and does about 0.2 M
// integer compares, nanoseconds of either; the launch sets its time.
//
// Design.  The TPU kernel builds a [TB, C] equality matrix per tile of
// lanes and carries `pop` across its sequential grid.  Here one thread owns
// one lane; each block stages the table's hash words and flags in shared
// memory (24 bytes per entry) and every thread walks the entries in
// ascending order, so the first match is `cidx` and duplicate entries are
// legal.  `pop` accumulates with shared-memory atomicAdd, then each block
// adds its nonzero counts into the global `pop`, which the launch zeroes
// first on the same stream.  Integer adds are order-free, so every output
// is exact.  Nothing is padded: any B and C whose table fits in shared
// memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kWork>
__global__ void __launch_bounds__(kThreads) orbit_match_kernel(
    const int32_t* __restrict__ hkey,    // [B, 4]
    const int32_t* __restrict__ table,   // [C, 4]
    const int32_t* __restrict__ occ,     // [C]
    const int32_t* __restrict__ valid,   // [C]
    const int32_t* __restrict__ mask,    // [B], or null: every lane counts
    int32_t* __restrict__ cidx,          // [B]
    int32_t* __restrict__ hit,           // [B]
    int32_t* __restrict__ vhit,          // [B]
    int32_t* __restrict__ pop,           // [C], zeroed before the launch
    int B, int C) {
  if (!kWork) return;
  extern __shared__ int32_t sm[];
  int32_t* s_thk = sm;              // [4C]
  int32_t* s_occ = s_thk + 4 * C;   // [C]
  int32_t* s_val = s_occ + C;       // [C]
  int32_t* s_pop = s_val + C;       // [C] this block's counts
  const int tid = threadIdx.x;
  for (int i = tid; i < 4 * C; i += blockDim.x) s_thk[i] = table[i];
  for (int c = tid; c < C; c += blockDim.x) {
    s_occ[c] = occ[c];
    s_val[c] = valid[c];
    s_pop[c] = 0;
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + tid;
  if (b < B) {
    const int h0 = hkey[4 * b], h1 = hkey[4 * b + 1];
    const int h2 = hkey[4 * b + 2], h3 = hkey[4 * b + 3];
    const bool counted = mask == nullptr || mask[b] > 0;
    int first = -1;
    for (int c = 0; c < C; ++c) {
      if (s_occ[c] > 0 && s_thk[4 * c] == h0 && s_thk[4 * c + 1] == h1 &&
          s_thk[4 * c + 2] == h2 && s_thk[4 * c + 3] == h3) {
        if (first < 0) first = c;
        if (counted) atomicAdd(&s_pop[c], 1);
      }
    }
    cidx[b] = first;
    hit[b] = first >= 0;
    vhit[b] = first >= 0 && s_val[first] > 0;
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x)
    if (s_pop[c]) atomicAdd(&pop[c], s_pop[c]);
}

// Dynamic shared memory one block needs, in bytes (kernel.py mirrors it).
long long smem_bytes(int C) { return 28LL * C; }

template <bool kWork>
int launch_with(const void* hkey, const void* table, const void* occ,
                const void* valid, const void* mask, void* cidx, void* hit,
                void* vhit, void* pop, int B, int C, void* stream) {
  if (B < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long smem = smem_bytes(C);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        orbit_match_kernel<kWork>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t e = cudaMemsetAsync(pop, 0, sizeof(int32_t) * (size_t)C, s);
  if (e != cudaSuccess) return (int)e;
  orbit_match_kernel<kWork>
      <<<(B + kThreads - 1) / kThreads, kThreads, (size_t)smem, s>>>(
          static_cast<const int32_t*>(hkey),
          static_cast<const int32_t*>(table),
          static_cast<const int32_t*>(occ),
          static_cast<const int32_t*>(valid),
          static_cast<const int32_t*>(mask), static_cast<int32_t*>(cidx),
          static_cast<int32_t*>(hit), static_cast<int32_t*>(vhit),
          static_cast<int32_t*>(pop), B, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// hkey int32[B, 4] and table int32[C, 4] (uint32 bit patterns); occ, valid
// int32[C]; mask int32[B] or null; outputs int32 cidx, hit, vhit [B] and
// pop [C] (device addresses).  Zeroes pop, then launches, on `stream`.
// Returns a cudaError_t; 0 means both were accepted.
int orbit_match_launch(const void* hkey, const void* table, const void* occ,
                       const void* valid, const void* mask, void* cidx,
                       void* hit, void* vhit, void* pop, int B, int C,
                       void* stream) {
  return launch_with<true>(hkey, table, occ, valid, mask, cidx, hit, vhit,
                           pop, B, C, stream);
}

// The same zeroing and launch of a kernel that does nothing: the floor.
int orbit_match_empty_launch(const void* hkey, const void* table,
                             const void* occ, const void* valid,
                             const void* mask, void* cidx, void* hit,
                             void* vhit, void* pop, int B, int C,
                             void* stream) {
  return launch_with<false>(hkey, table, occ, valid, mask, cidx, hit, vhit,
                            pop, B, C, stream);
}

const char* orbit_match_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
