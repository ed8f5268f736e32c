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
// What bounds it: at one subround's ingress of the paper's rack (B = 352
// lanes against C = 128 entries) it reads about 14 KB and does about 0.2 M
// integer compares, nanoseconds of either at the card's rates; the launch,
// the round trip to global memory and the block's barriers set its time.
//
// Design.  The TPU kernel builds a [TB, C] equality matrix per tile of
// lanes and carries `pop` across its sequential grid.  Here one thread owns
// one lane, and the launch is one kernel node, with no memset of `pop`:
//   0. every thread loads its lane's hash words (one 16-byte load) and mask
//      before it stages the table: the entries' hash words as int4 and one
//      flag word per entry (bit 0 occupied, bit 1 valid).  The entries are
//      then grouped into 256 buckets by the top byte of their first hash
//      word: a count per bucket (shared atomics), one warp's scan of the
//      counts, and each entry's (first word, index) placed in its bucket;
//   1. the match: a lane compares its first word with those of its bucket
//      only, about C / 256 entries, keeping the lowest index and the count
//      of its candidates.  A single candidate is checked in full; a lane
//      with several (a duplicate entry, or a first word shared by chance)
//      checks every candidate of its bucket, so the lowest occupied match
//      is `cidx`.  (Comparing the first words of all C entries, four per
//      16-byte broadcast read as the subround kernel does, measured 3.8 us
//      at the paper's shape against 3.0: its B x C compares load the integer
//      pipes of the block's one SM.)
//   2. `pop`: the lanes of a warp on one entry add their count with one
//      shared atomic (__match_any_sync); a lane with several candidates
//      adds each of its matches.  Up to 1,024 lanes run in one block, which
//      writes `pop` with plain stores.  More lanes run in a thread-block
//      cluster of up to 8 blocks of 1,024 threads (threads loop over the
//      lanes past 8,192): each block counts in its own shared memory, then
//      adds its counts into the leader block's through distributed shared
//      memory, and the leader writes `pop`.
// The entries pass in chunks of at most kChunk, ascending, each staged,
// matched and counted in turn, so any C fits: a lane keeps the cidx of the
// first chunk it matches in, and `pop` is written a chunk at a time.  The
// paper's C (128) is one chunk.  Integer adds are order-free, so every
// output is exact.  Nothing is padded: any B and any C.  Shared memory:
// 32 bytes an entry of a chunk, 4 KB at C = 128, 130 KB from C = 4,096 on.
//
// Measured (chip_smoke.py --against, NVIDIA H100 80GB HBM3, 700 W): 2.7 us
// on the device per launch at 352 lanes against 128 entries, against
// 10.1-10.3 us for the design it replaced; the floor, one kernel node,
// 0.8-1.0 us against 2.8-3.0 with the memset.  PERF.md has the numbers and
// their runs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kLogBuckets = 8;     // entries bucketed by a first word's top
constexpr int kBuckets = 1 << kLogBuckets;   // byte
constexpr int kNone = 0x7fffffff;
constexpr int kChunk = 4096;      // entries per pass (kernel.py mirrors it)

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ int4 load_words(const int32_t* base, int i,
                                           bool vec) {
  if (vec) return __ldg(reinterpret_cast<const int4*>(base) + i);
  const int32_t* p = base + 4 * i;
  return make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ int bucket_of(int32_t w) {
  return (int)((uint32_t)w >> (32 - kLogBuckets));
}

template <bool kWork>
__global__ void __launch_bounds__(kMaxThreads) orbit_match_kernel(
    const int32_t* __restrict__ hkey,    // [B, 4]
    const int32_t* __restrict__ table,   // [C, 4]
    const int32_t* __restrict__ occ,     // [C]
    const int32_t* __restrict__ valid,   // [C]
    const int32_t* __restrict__ mask,    // [B], or null: every lane counts
    int32_t* __restrict__ cidx,          // [B]
    int32_t* __restrict__ hit,           // [B]
    int32_t* __restrict__ vhit,          // [B]
    int32_t* __restrict__ pop,           // [C], written whole
    int B, int C) {
  if (!kWork) return;
  extern __shared__ __align__(16) int32_t sm[];
  const int cn = C < kChunk ? C : kChunk;      // entries of a full chunk
  int4* s_thk = reinterpret_cast<int4*>(sm);            // [cn] hash words
  int2* s_ent = reinterpret_cast<int2*>(sm + 4 * cn);   // [cn] by bucket:
                                                        // (first word, c)
  int32_t* s_flag = sm + 6 * cn;               // [cn] occupied | valid << 1
  int32_t* s_pop = s_flag + cn;                // [cn] counts
  int32_t* s_start = s_pop + cn;               // [kBuckets + 1] bucket starts
  int32_t* s_fill = s_start + kBuckets + 1;    // [kBuckets] counts, then ends
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int stride = gridDim.x * nt;
  const bool hk_vec = aligned16(hkey), tb_vec = aligned16(table);

  // the first lane's words in flight before the first chunk is staged
  int4 h = make_int4(0, 0, 0, 0);
  bool counted = false;
  if (blockIdx.x * nt + tid < B) {
    h = load_words(hkey, blockIdx.x * nt + tid, hk_vec);
    counted = mask == nullptr || __ldg(mask + blockIdx.x * nt + tid) > 0;
  }
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int n = min(C - c0, kChunk);
    if (c0 > 0) __syncthreads();   // the last chunk is matched and stored

    // ---- 0: stage the chunk, grouped by bucket ---------------------------
    for (int i = tid; i < kBuckets; i += nt) s_fill[i] = 0;
    __syncthreads();
    for (int c = tid; c < n; c += nt) {
      const int4 k = load_words(table, c0 + c, tb_vec);
      s_thk[c] = k;
      s_flag[c] = (__ldg(occ + c0 + c) > 0) | ((__ldg(valid + c0 + c) > 0)
                                               << 1);
      s_pop[c] = 0;
      atomicAdd(&s_fill[bucket_of(k.x)], 1);
    }
    __syncthreads();
    // the buckets' starts: warp 0 scans the counts, 8 buckets a lane
    if (tid < 32) {
      constexpr int kPer = kBuckets / 32;
      int cnt[kPer], run = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) run += cnt[j] = s_fill[tid * kPer + j];
      int incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      int start = incl - run;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s_start[tid * kPer + j] = s_fill[tid * kPer + j] = start;
        start += cnt[j];
      }
      if (tid == 31) s_start[kBuckets] = incl;
    }
    __syncthreads();
    for (int c = tid; c < n; c += nt) {
      const int w = s_thk[c].x;
      s_ent[atomicAdd(&s_fill[bucket_of(w)], 1)] = make_int2(w, c);
    }
    __syncthreads();

    // ---- 1 and 2: match and count, lane by lane --------------------------
    for (int b0 = blockIdx.x * nt, b = b0 + tid; b0 < B;
         b0 += stride, b += stride) {
      const bool inb = b < B;
      if (inb && (b0 >= stride || c0 > 0)) {
        h = load_words(hkey, b, hk_vec);
        counted = mask == nullptr || __ldg(mask + b) > 0;
      }
      // the candidates: the entries of the lane's bucket with its first word
      int lo = 0, hi = 0, cand = kNone, ncand = 0;
      if (inb) {
        const int bk = bucket_of(h.x);
        lo = s_start[bk];
        hi = s_start[bk + 1];
        for (int i = lo; i < hi; ++i) {
          const int2 e = s_ent[i];
          if (e.x == h.x) {
            cand = min(cand, e.y);
            ++ncand;
          }
        }
      }
      int first = -1;
      if (ncand == 1 && (s_flag[cand] & 1)) {
        const int4 t = s_thk[cand];
        if (t.y == h.y && t.z == h.z && t.w == h.w) first = cand;
      }
      if (ncand > 1) {   // a duplicate entry, or a first word shared by chance
        for (int i = lo; i < hi; ++i) {
          const int c = s_ent[i].y;
          const int4 t = s_thk[c];
          if ((s_flag[c] & 1) && t.x == h.x && t.y == h.y && t.z == h.z &&
              t.w == h.w) {
            first = first < 0 ? c : min(first, c);
            if (counted) atomicAdd(&s_pop[c], 1);
          }
        }
      }
      const int pkey = (ncand == 1 && counted && first >= 0) ? first : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, pkey);
      if (pkey >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&s_pop[pkey], __popc(peers));
      // a lane that matched in an earlier chunk keeps that match (this
      // thread stored it)
      if (inb && (c0 == 0 || cidx[b] < 0)) {
        cidx[b] = first < 0 ? -1 : c0 + first;
        hit[b] = first >= 0;
        vhit[b] = first >= 0 && (s_flag[first] & 2);
      }
    }

    // ---- the counts: one block stores them, a cluster adds into its leader
    if (gridDim.x == 1) {
      __syncthreads();
      for (int c = tid; c < n; c += nt) pop[c0 + c] = s_pop[c];
      continue;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const unsigned rank = cluster.block_rank();
    if (rank != 0) {
      int32_t* lead = cluster.map_shared_rank(s_pop, 0);
      for (int c = tid; c < n; c += nt)
        if (s_pop[c]) atomicAdd(&lead[c], s_pop[c]);
    }
    cluster.sync();
    if (rank == 0)
      for (int c = tid; c < n; c += nt) pop[c0 + c] = s_pop[c];
  }
}

// Dynamic shared memory one block needs, in bytes.
long long smem_bytes(int C) {
  return 4LL * (8LL * (C < kChunk ? C : kChunk) + 2 * kBuckets + 1);
}

template <bool kWork>
int launch_with(const void* hkey, const void* table, const void* occ,
                const void* valid, const void* mask, void* cidx, void* hit,
                void* vhit, void* pop, int B, int C, void* stream) {
  if (B < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const long long smem = smem_bytes(C);
  auto kernel = orbit_match_kernel<kWork>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // one block of whole warps when B fits, enough threads to stage the
  // table; else a cluster of blocks of 1,024
  int blocks = (B + kMaxThreads - 1) / kMaxThreads;
  if (blocks > kMaxCluster) blocks = kMaxCluster;
  int threads = kMaxThreads;
  if (blocks == 1) {
    const int cn = C < kChunk ? C : kChunk;
    const int want = B > cn ? B : cn;
    threads = want < kMaxThreads ? (want + 31) & ~31 : kMaxThreads;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int32_t*>(hkey),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(occ),
      static_cast<const int32_t*>(valid), static_cast<const int32_t*>(mask),
      static_cast<int32_t*>(cidx), static_cast<int32_t*>(hit),
      static_cast<int32_t*>(vhit), static_cast<int32_t*>(pop), B, C);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// hkey int32[B, 4] and table int32[C, 4] (uint32 bit patterns); occ, valid
// int32[C]; mask int32[B] or null; outputs int32 cidx, hit, vhit [B] and
// pop [C] (device addresses), every element written.  One kernel launch
// on `stream`.  Returns a cudaError_t; 0 means it was accepted.
int orbit_match_launch(const void* hkey, const void* table, const void* occ,
                       const void* valid, const void* mask, void* cidx,
                       void* hit, void* vhit, void* pop, int B, int C,
                       void* stream) {
  return launch_with<true>(hkey, table, occ, valid, mask, cidx, hit, vhit,
                           pop, B, C, stream);
}

// The same launch (grid, cluster and shared memory) of a kernel that does
// nothing: the floor.
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
