// The servers' FIFO enqueue of a window's arrivals, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference enqueues in `jnp` inside
// `server_step` (src/repro/kvstore/server.py), which XLA fuses on the TPU.
// The port's plain version (`ref.py`, `server_step`'s expression before
// this kernel) builds an int32 one-hot [lanes, n] and takes a cumulative
// sum down its lanes: a scan along the outer dimension, one thread a
// column, 1,344 dependent adds each on the paper rack (0.24-0.26 ms a
// window, the largest single device op of every cell), with some 60 more
// launches of glue around it.  This kernel computes what
// `server_enqueue_ref` computes, for each point and server s:
//   total[s]    = #{l : to_server[l] and server[l] == s}
//   offset[l]   = #{l' < l : to_server[l'] and server[l'] == server[l]}
//   accepted[l] = to_server[l] and offset[l] < q - qlen[s]
//   ring[r][s, (rear[s] + offset[l]) % q] = field[r][l]   (accepted l)
//   new[s] = max(0, min(total[s], q - qlen[s])), dropped[s] = total - new
//   qlen'[s] = qlen[s] + new[s], rear'[s] = (rear[s] + new[s]) % q
// with every other ring slot copied.  The eight fields and rings are moved
// as 32-bit words (`ts` is float32: its bits), so every output is the
// plain version's bit for bit.  All terms of the slot are non-negative (a
// ring's `rear` lies in [0, q)), so C's `%` is the plain version's.
//
// What bounds it: latency, not bytes.  A 12-point fleet window moves ~181
// KB a point (the rings read and written, 131 KB, and 1,344 lanes x 37
// B): ~0.65 us at 3.35 TB/s, below the ~1 us floor of a launch.
//
// Design.  One block a (server, point): grid (n, P), 384 blocks of 256
// threads for the paper fleet, all resident at once (blocks of 512
// threads at 64 registers fit two an SM, 264 on the card: the fleet then
// ran in two waves, 9.3 us against 4.4 for one rack).  A block copies its
// server's eight ring rows (q words each) to the outputs, then walks the
// lanes kPass = kPer * kThreads at a time (one pass for the paper's
// 1,344): each thread loads the server and flag of kPer lanes (lane order
// is tile k, then warp, then thread), `__ballot_sync` gives each lane its
// rank among its warp's lanes of this server, the warps' counts go to
// shared memory, and every thread adds up the counts before its own
// (earlier tiles, then earlier warps) to its running base: the offset in
// lane order, with no scan over a one-hot and no atomics.  An accepted
// lane puts its number in shared memory at its offset within the pass;
// the pass's accepted offsets are one run, [first, min(total, room)), so
// the whole block then copies their eight fields, field by field, to
// consecutive slots from rear + first.  The slots are distinct (every
// accepted offset is below the free room, at most q), so no two threads
// write one word; `__syncthreads` orders the ring copy before them.  Each
// lane's `accepted` is written by one block: that of its server if it
// goes to one, else server 0's (the plain version's `where(to_server,
// server, 0)`).  A fleet's P points (a fabric's points x racks) are one
// launch: each input is read at point x its per-point stride (0 for one
// all points share), and the outputs' points are stacked.  Shared memory
// is fixed (the counts and kPass lane numbers, ~6 KB); n, q and the lane
// count are runtime arguments, indexed in uint32: the wrapper refuses
// sizes of 2**31 words or more.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 6;       // lanes a thread takes in one pass
constexpr int kPass = kPer * kThreads;
constexpr int kFields = 8;    // op, kidx, seq, client, port, flag, vlen, ts

// inputs: server, to_server, the eight lane fields, the eight rings, qlen,
// rear; outputs: the eight rings, qlen', rear', new_counts, dropped_now,
// accepted
constexpr int kIn = 2 + 2 * kFields + 2;
constexpr int kOut = kFields + 5;
constexpr int kServer = 0, kTo = 1, kField = 2, kRing = 2 + kFields;
constexpr int kQlen = 2 + 2 * kFields, kRear = kQlen + 1;
constexpr int kOutQlen = kFields, kOutRear = kFields + 1;
constexpr int kOutNew = kFields + 2, kOutDrop = kFields + 3;
constexpr int kOutAcc = kFields + 4;

struct Args {
  const void* in[kIn];
  uint32_t stride[kIn];   // elements from one point to the next (0: shared)
  void* out[kOut];
  uint32_t lanes, n, q;
};

template <typename T>
__device__ __forceinline__ const T* at(const Args& a, int k, uint32_t p) {
  return static_cast<const T*>(a.in[k]) + p * a.stride[k];
}

template <bool kWork>
__global__ void __launch_bounds__(kThreads) server_enqueue_kernel(
    const Args a) {
  if (!kWork) return;
  __shared__ uint32_t counts[kPer][kWarps];
  __shared__ uint32_t lane_of[kPass];     // accepted lanes by offset
  __shared__ const uint32_t* field[kFields];
  __shared__ uint32_t* ring[kFields];
  const uint32_t s = blockIdx.x, p = blockIdx.y;
  const uint32_t n = a.n, q = a.q, lanes = a.lanes;
  const uint32_t tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t row = (p * n + s) * q;       // the server's output row

  // the server's ring rows, copied whole: all eight loads, then the stores
  for (uint32_t j = tid; j < q; j += kThreads) {
    uint32_t v[kFields];
#pragma unroll
    for (int r = 0; r < kFields; ++r)
      v[r] = __ldg(at<uint32_t>(a, kRing + r, p) + s * q + j);
#pragma unroll
    for (int r = 0; r < kFields; ++r)
      static_cast<uint32_t*>(a.out[r])[row + j] = v[r];
  }
  if (tid < kFields) {
#pragma unroll
    for (int r = 0; r < kFields; ++r) {
      if (tid == static_cast<uint32_t>(r)) {
        field[r] = at<uint32_t>(a, kField + r, p);
        ring[r] = static_cast<uint32_t*>(a.out[r]) + row;
      }
    }
  }

  const int qlen = __ldg(at<int32_t>(a, kQlen, p) + s);
  const int rear = __ldg(at<int32_t>(a, kRear, p) + s);
  const int room = static_cast<int>(q) - qlen;   // free slots
  const int32_t* server = at<int32_t>(a, kServer, p);
  const uint8_t* to_server = at<uint8_t>(a, kTo, p);
  const uint32_t lt = (1u << lane) - 1u;
  uint8_t* accepted = static_cast<uint8_t*>(a.out[kOutAcc]) + p * lanes;
  uint32_t base = 0;                 // this server's lanes before the pass
  for (uint32_t c0 = 0; c0 < lanes; c0 += kPass) {
    bool mine[kPer], own[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint32_t l = c0 + k * kThreads + tid;
      const bool in = l < lanes;
      const int sv = in ? __ldg(server + l) : -1;
      const bool to = in && __ldg(to_server + l) != 0;
      const bool routed = to && sv >= 0 && sv < static_cast<int>(n);
      mine[k] = routed && sv == static_cast<int>(s);
      own[k] = in && (routed ? sv : 0) == static_cast<int>(s);
    }
    uint32_t rank[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint32_t b = __ballot_sync(0xFFFFFFFFu, mine[k]);
      rank[k] = __popc(b & lt);
      if (lane == 0) counts[k][warp] = __popc(b);
    }
    __syncthreads();
    const uint32_t pass0 = base;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      uint32_t tot = 0, pre = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t c = counts[k][w];
        tot += c;
        pre += static_cast<uint32_t>(w) < warp ? c : 0u;
      }
      const uint32_t off = base + pre + rank[k];
      const bool acc = mine[k] && static_cast<int>(off) < room;
      const uint32_t l = c0 + k * kThreads + tid;
      if (own[k]) accepted[l] = acc;
      if (acc) lane_of[off - pass0] = l;
      base += tot;
    }
    __syncthreads();
    // the pass's accepted lanes hold offsets [pass0, min(base, room)):
    // their fields go to consecutive slots from rear + pass0
    const int hi = static_cast<int>(base) < room ? static_cast<int>(base)
                                                 : room;
    const int n_acc = hi > static_cast<int>(pass0)
                          ? hi - static_cast<int>(pass0) : 0;
    for (int i = tid; i < n_acc * kFields; i += kThreads) {
      const int r = i / n_acc, j = i - r * n_acc;
      const uint32_t slot = (static_cast<uint32_t>(rear) + pass0 + j) % q;
      ring[r][slot] = __ldg(field[r] + lane_of[j]);
    }
    __syncthreads();            // lane_of and the counts are rewritten
  }

  if (tid == 0) {
    const int total = static_cast<int>(base);
    int added = total < room ? total : room;
    added = added < 0 ? 0 : added;
    const uint32_t i = p * n + s;
    static_cast<int32_t*>(a.out[kOutQlen])[i] = qlen + added;
    static_cast<int32_t*>(a.out[kOutRear])[i] =
        static_cast<int32_t>((static_cast<uint32_t>(rear + added)) % q);
    static_cast<int32_t*>(a.out[kOutNew])[i] = added;
    static_cast<int32_t*>(a.out[kOutDrop])[i] = total - added;
  }
}

template <bool kWork>
int launch_with(const long long* in, const long long* strides,
                const long long* out, int P, int lanes, int n, int q,
                void* stream) {
  const long long lim = 1LL << 31;
  if (P < 1 || P > 65535 || lanes < 0 || n < 1 || q < 1 ||
      (long long)P * lanes >= lim || (long long)P * n * q >= lim)
    return (int)cudaErrorInvalidValue;
  Args a;
  for (int k = 0; k < kIn; ++k) {
    if (strides[k] < 0 || strides[k] >= lim)
      return (int)cudaErrorInvalidValue;
    a.in[k] = reinterpret_cast<const void*>(in[k]);
    a.stride[k] = (uint32_t)strides[k];
  }
  for (int k = 0; k < kOut; ++k) a.out[k] = reinterpret_cast<void*>(out[k]);
  a.lanes = (uint32_t)lanes;
  a.n = (uint32_t)n;
  a.q = (uint32_t)q;
  server_enqueue_kernel<kWork>
      <<<dim3((unsigned)n, (unsigned)P), kThreads, 0,
         reinterpret_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// P points of `lanes` lanes and n servers with rings of q slots each.
// `in` holds the device addresses of point 0's 20 inputs in order: int32
// server [lanes], bool to_server [lanes], the eight lane fields [lanes]
// (int32 op, kidx, seq, client, port, flag, vlen; float32 ts), the eight
// rings [n, q] in the same order, int32 qlen and rear [n]; `strides` their
// per-point strides in elements (0 for an input every point shares).
// `out` holds the 13 outputs' addresses, each [P, ...] contiguous: the
// eight rings [n, q], int32 qlen', rear', new_counts, dropped_now [n] and
// bool accepted [lanes], all written whole.  Returns a cudaError_t; 0
// means the launch was accepted.
int server_enqueue_batched_launch(const long long* in,
                                  const long long* strides,
                                  const long long* out, int P, int lanes,
                                  int n, int q, void* stream) {
  return launch_with<true>(in, strides, out, P, lanes, n, q, stream);
}

// The same launch of a kernel that does nothing: the launch floor.
int server_enqueue_empty_launch(const long long* in, const long long* strides,
                                const long long* out, int P, int lanes,
                                int n, int q, void* stream) {
  return launch_with<false>(in, strides, out, P, lanes, n, q, stream);
}

const char* server_enqueue_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
