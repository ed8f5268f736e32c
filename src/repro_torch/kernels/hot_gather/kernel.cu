// Gather-by-id over a hot set for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_hot_gather_kernel` in
// src/repro/kernels/hot_gather/kernel.py (launcher `hot_gather`,
// pallas_call at line 43), and computes what `hot_gather_ref` computes:
//   out[b, :] = sum over c of [ids[b] == hot[c]] * rows[c, :]
//   hit[b]    = any c with ids[b] == hot[c]
// summed over every match, not the first.  int32 rows sum exactly (and
// wrap as int32 does); float32 rows sum in ascending c, which is exact
// when at most one hot id matches a lane; bf16 rows sum in float32 in
// ascending c and round once to bf16.
//
// What bounds it: at the control plane's shapes (D = 1, up to 2,048 ids
// against 2,048 hot ids) it moves about 40 KB, well under a microsecond of
// HBM time; what sets its time is latency: the launch, one round trip to
// global memory for the inputs (two for float rows), and the dependent
// shared-memory atomics of building a table of the hot ids.
//
// Design.  The TPU kernel casts the [TB, C] equality matrix to the row
// type and contracts it with the rows on the MXU: B x C compares.  The
// first Hopper kernel had each thread walk all C hot ids for its lane, in
// at most 8 blocks.  Here every block builds a hash table of the hot ids
// in shared memory, then each of its lanes probes it once, so a block does
// work in proportion to C plus its lanes, and the grid holds one block per
// 64 lanes (and per 8 columns), 32 blocks at 2,048 ids.  The hot ids pass
// in chunks of at most kChunk, one table each, in ascending order, so any
// C fits and a lane's sum keeps the order of its c; the controller's C
// (up to 2,048) is one chunk.  Per chunk:
//   1. The block stages the chunk's hot ids in shared memory, kPre loads
//      per thread in flight at once, and clears a table of T slots, a
//      power of two >= 4 x the chunk, so a probe ends at an empty slot.
//      At a quarter full the probe chains, whose longest in a warp sets
//      each round's time, are short (at half full the controller's inputs
//      took about 1.5 times as long).
//   2. Insert, one thread per hot id.  Hot vectors may hold runs of the -2
//      sentinel (each server's invalid report lanes come last), so only
//      the head of each run of equal ids in a warp inserts (__shfl_up_sync
//      and __ballot_sync find the heads; __match_any_sync, which also
//      groups ids that are not adjacent, measured slower).  A slot holds
//      first + 1, the lowest c of its id (an atomicCAS claims an empty
//      slot, an atomicMin lowers it), so the slot's id is hot[slot - 1],
//      and beside it the id's last c (each run's last, atomicMax).
//   3. Probe, one thread per (lane, column): linear probing from the id's
//      hash until an empty slot or the id.  A hit adds the row of its
//      first c, then walks c up to its last, adding the rows of the other
//      matches in ascending order; on the controller's inputs, whose hot
//      ids are distinct, first == last and the walk is empty.
// A fleet of P racks merges its P controllers' reports in one launch:
// grid z = P, block z reading its point's ids, hot ids and rows at z times
// their per-point strides (0 for an input all points share, such as the
// controller's zero rows) and writing its point's out and hit.  Each block
// builds its own point's tables, so the order rules above hold per point.
// At 2,048 ids against 2,048 hot ids a launch for P = 4 and 12 takes 3.3
// and 5.2 us, against 12.7 and 38.1 for P one-point launches
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
// Shared memory: 8 bytes per slot and 4 per hot id of a chunk, 72 KB at
// C = 2,048 and 144 KB from C = 4,096 on.
//
// Measured (chip_smoke.py --against, NVIDIA H100 80GB HBM3, 700 W): 2.8-3.0
// / 2.9-3.1 / 2.2-2.4 us on the device per launch at the controller's three
// shapes (4.1-4.3 / 4.3-4.5 / 2.2-2.4 on one period's live inputs), against
// 53.9-54.1 / 56.3-56.5 / 5.3 us for the design it replaced.  Hot ids that
// repeat far apart make the walk long: 53 / 56 / 6.1 us with hot ids drawn
// from C / 3 values.  PERF.md has the numbers and their runs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 64;     // lanes per block
constexpr int kMaxTD = 8;      // columns per block
constexpr int kPre = 4;        // hot ids a thread stages at once
constexpr int kChunk = 4096;   // hot ids per table (kernel.py mirrors it)

// The accumulator of a row type: the type itself, float32 for bf16.
template <typename T>
struct Acc {
  using type = T;
  static __device__ T load(T x) { return x; }
  static __device__ T store(T x) { return x; }
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
  static __device__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);   // round to nearest even
  }
};

__device__ __forceinline__ int slot_of(int32_t id, int log_t) {
  return (int)(((uint32_t)id * 0x9E3779B1u) >> (32 - log_t));
}

template <typename T, bool kWork>
__global__ void __launch_bounds__(kThreads) hot_gather_kernel(
    const int32_t* __restrict__ ids,   // [B]
    const int32_t* __restrict__ hot,   // [C]
    const T* __restrict__ rows,        // [C, D]
    T* __restrict__ out,               // [B, D]
    int32_t* __restrict__ hit,         // [B]
    long long ids_str, long long hot_str, long long rows_str,
    int B, int C, int D, int td, int log_t) {
  if (!kWork) return;
  {  // this block's point: per-point strides, outputs stacked
    const long long pt = blockIdx.z;
    ids += pt * ids_str;
    hot += pt * hot_str;
    rows += pt * rows_str;
    out += pt * (long long)B * D;
    hit += pt * B;
  }
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) int32_t sm[];
  const int n_slots = 1 << log_t, mask = n_slots - 1;
  int32_t* s_slot = sm;               // [T] first c + 1 of its id, 0: empty
  int32_t* s_last = sm + n_slots;     // [T] last c of its id
  int32_t* s_hot = s_last + n_slots;  // [min(C, kChunk)] the chunk's ids
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;

  // this thread's (lane, column) of the output; its id is loaded first
  const int j = tid % td;
  const int b = blockIdx.x * kLanes + tid / td;
  const int d = blockIdx.y * td + j;
  const bool mine = tid < kLanes * td && b < B && d < D;
  const int32_t id = mine ? __ldg(ids + b) : 0;
  A acc = A(0);
  bool found = false;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int n = min(C - c0, kChunk);
    if (c0 > 0) __syncthreads();   // the last chunk's probes are done

    // ---- 1: stage the hot ids, kPre loads in flight, clear the table ----
    for (int i0 = 0; i0 < n; i0 += kPre * nt) {
      int32_t hk[kPre];
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const int c = i0 + u * nt + tid;
        hk[u] = c < n ? __ldg(hot + c0 + c) : 0;
      }
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const int c = i0 + u * nt + tid;
        if (c < n) s_hot[c] = hk[u];
      }
    }
    for (int i = tid; i < n_slots / 2; i += nt)   // s_slot and s_last
      reinterpret_cast<int4*>(sm)[i] = make_int4(0, 0, 0, 0);
    __syncthreads();

    // ---- 2: insert: the head of each run of equal ids in a warp ----
    for (int i0 = 0; i0 < n; i0 += nt) {
      const int c = i0 + tid;
      const bool live = c < n;
      const int32_t key = live ? s_hot[c] : 0;
      const int32_t prev = __shfl_up_sync(0xffffffffu, key, 1);
      const bool head = live && (lane == 0 || prev != key);
      const unsigned heads = __ballot_sync(0xffffffffu, head);
      if (head) {
        int h = slot_of(key, log_t);
        for (;;) {
          const int old = atomicCAS(&s_slot[h], 0, c + 1);
          if (old == 0) break;
          if (s_hot[old - 1] == key) {
            if (c + 1 < old) atomicMin(&s_slot[h], c + 1);
            break;
          }
          h = (h + 1) & mask;
        }
        const unsigned above = heads & ~(0xffffffffu >> (31 - lane));
        const int end = above ? __ffs(above) - 2 : 31;   // the run's last
        atomicMax(&s_last[h], min(c - lane + end, n - 1));
      }
    }
    __syncthreads();

    // ---- 3: probe, one thread per (lane, column) ----
    if (mine) {
      int h = slot_of(id, log_t), s;
      while ((s = s_slot[h]) != 0 && s_hot[s - 1] != id) h = (h + 1) & mask;
      if (s != 0) {
        const T* col = rows + (long long)c0 * D + d;
        const int first = s - 1, last = s_last[h];
        acc += Acc<T>::load(col[(long long)first * D]);
        for (int c = first + 1; c <= last; ++c)
          if (s_hot[c] == id) acc += Acc<T>::load(col[(long long)c * D]);
        found = true;
      }
    }
  }
  if (!mine) return;
  out[(long long)b * D + d] = Acc<T>::store(acc);
  if (blockIdx.y == 0 && j == 0) hit[b] = found;
}

// The table's size (log2): slots >= 4 x the chunk, at least 32.
int log_slots(int C) {
  const long long n = C < kChunk ? C : kChunk;
  int log_t = 5;
  while ((1LL << log_t) < 4 * n) ++log_t;
  return log_t;
}

// Dynamic shared memory one block needs, in bytes.
long long smem_bytes(int C) {
  return 4LL * (2 * (1LL << log_slots(C)) + (C < kChunk ? C : kChunk));
}

template <typename T, bool kWork>
int launch_typed(const void* ids, const void* hot, const void* rows,
                 void* out, void* hit, const long long* str, int P, int B,
                 int C, int D, void* stream) {
  const int td = D < kMaxTD ? D : kMaxTD;
  const dim3 grid((B + kLanes - 1) / kLanes, (D + td - 1) / td, P);
  const long long smem = smem_bytes(C);
  auto kernel = hot_gather_kernel<T, kWork>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, (size_t)smem,
           reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(hot),
      static_cast<const T*>(rows), static_cast<T*>(out),
      static_cast<int32_t*>(hit), str[0], str[1], str[2], B, C, D, td,
      log_slots(C));
  return (int)cudaGetLastError();
}

template <bool kWork>
int launch_with(const void* ids, const void* hot, const void* rows,
                void* out, void* hit, const long long* str, int P, int B,
                int C, int D, int dtype, void* stream) {
  if (P < 1 || P > 65535 || B < 1 || C < 0 || D < 1)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_typed<int32_t, kWork>(ids, hot, rows, out, hit, str, P,
                                          B, C, D, stream);
    case 1:
      return launch_typed<float, kWork>(ids, hot, rows, out, hit, str, P, B,
                                        C, D, stream);
    case 2:
      return launch_typed<__nv_bfloat16, kWork>(ids, hot, rows, out, hit,
                                                str, P, B, C, D, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// P points in one launch (grid z = P): point 0's ids int32[B], hot
// int32[C] and rows [C, D] of the row type (dtype 0: int32, 1: float32,
// 2: bf16), each with its per-point stride in elements (0 for an input
// every point shares); out [P, B, D] of the row type and hit int32[P, B]
// stacked (device addresses).  Returns a cudaError_t; 0 means the launch
// was accepted.
int hot_gather_batched_launch(const void* ids, long long s_ids,
                              const void* hot, long long s_hot,
                              const void* rows, long long s_rows, void* out,
                              void* hit, int P, int B, int C, int D,
                              int dtype, void* stream) {
  const long long str[3] = {s_ids, s_hot, s_rows};
  return launch_with<true>(ids, hot, rows, out, hit, str, P, B, C, D, dtype,
                           stream);
}

// One point's launch of a kernel that does nothing: the launch floor.
int hot_gather_empty_launch(const void* ids, const void* hot,
                            const void* rows, void* out, void* hit, int B,
                            int C, int D, int dtype, void* stream) {
  const long long none[3] = {0, 0, 0};
  return launch_with<false>(ids, hot, rows, out, hit, none, 1, B, C, D,
                            dtype, stream);
}

const char* hot_gather_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
