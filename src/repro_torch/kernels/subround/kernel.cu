// Fused OrbitCache subround pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_subround_kernel` in
// src/repro/kernels/subround/kernel.py (launcher `subround`, pallas_call at
// line 271), and computes what `subround_ref` computes, bit for bit, for
// any B lanes and C entries.
//
// What bounds it: nothing the card is short of.  At the paper's shape
// (B = 352, C = 128, S = 8, F = 1, J = 8) it reads and writes about 0.1 MB,
// well under a microsecond of HBM time, and does a few hundred thousand
// integer compares.  What sets its time is latency: the launch, the
// round trips to global memory that depend on one another, the barriers
// between the phases of one block, and one SM's rate of stores.
//
// Design.  The Pallas kernel streams lane tiles through a sequential TPU
// grid and carries per-entry running counts from one grid step to the next.
// GPU blocks run in no order, so one block of 512 threads (one switch
// instance) owns the whole batch, and every table lives in shared memory.
// Global memory is read in two rounds, the call-time inputs at the start
// and the winners' payload words in phase 3, and each output is written
// once:
//   0. every thread issues its loads before it stores any: its first lane's
//      hash words (one 16-byte load) and gates, and the call-time tables
//      (hash words, state, queues, orbit lines, request table), which go
//      into shared memory;
//   1. one thread per lane compares the first hash word of four entries at
//      a time (one 16-byte broadcast read of shared memory) and keeps the
//      first candidate and their count; a single candidate is checked in
//      full, and only a lane with several (a duplicate key, or a word
//      shared by chance) walks all C entries.  Popularity counts every
//      occupied matching entry, not just cidx: the lanes of a warp that
//      share an entry add their count with one shared atomic
//      (__match_any_sync).  Write invalidations, validations and the
//      install winners (atomicMax on the lane index: the last installer
//      wins) accumulate in shared memory, since none depends on lane order;
//   2. admission, in parallel: in rounds of 512 lanes, each warp ranks its
//      32 lanes per entry (__match_any_sync) and writes its per-entry
//      counts to a [16 warps x C] table; an exclusive scan down each column,
//      seeded by the count of earlier rounds, gives every warp its running
//      count, so a lane's offset is prefix[warp][entry] + rank: the
//      whole-batch exclusive count in lane order.  An accepted lane records
//      itself as the unique writer of its slot; an entry's accepted count
//      is min(free slots, lanes wanting it), clamped at 0;
//   3. per entry, the state bits, versions, rear pointer and its F orbit
//      lines (stamped with the post-batch version, refreshed by the
//      drop-stale rule); per slot, the request table, finished in shared
//      memory.  Payload words are read only for the lanes that won a slot
//      or a line, by index, all issued before any is used;
//   4. the serving round: one thread per grid cell (entry, j) gathers its
//      slot from the shared request table.
// A fleet of P racks (the reference vmaps this kernel over its sweep
// points inside one pallas_call) launches P blocks, one switch instance
// each: block p offsets every array by p times its per-point stride, and an
// input the points share has stride 0.  One rack is P = 1 with strides
// of 0: 8.34 us a launch, 0.94 more than a copy of the kernel with the
// offsets compiled out would take, a cost no measured workload pays.  At
// P = 4 and 12 a launch takes 8.6 and 8.7 us, against 30 and 89 for P
// one-rack launches (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
// No float arithmetic: `ts` travels as its 32-bit pattern.  Every array is
// 4-byte, so the kernel sees them all as int32.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 7.4 us on the
// device per launch at the paper's shape, against 28.4-29.1 us for the design
// it replaced (one block of 256 threads, admission walked by one warp);
// PERF.md has the numbers and their runs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kIn = 31;
constexpr int kOut = 32;

// input order (SubroundOuts argument order of the reference)
enum In {
  HKEY, WANT, WREQ, INST, FRAG, NFRAGS, KIDX, VLEN, CLIENT, SEQ, PORT, TS,
  THK, OCC, STV, STVER,
  RTC, RTS, RTP, RTTS, RTA, RTK, QLEN, FRONT, REAR,
  OLIVE, OKIDX, OVER, OVLEN, OFRAGS,
  BUDGET
};
// output order (ops.SubroundOuts)
enum Out {
  O_HIT, O_VHIT, O_ACC, O_OVF, O_POP, O_STV, O_STVER,
  O_RTC, O_RTS, O_RTP, O_RTTS, O_RTA, O_RTK, O_QLEN, O_FRONT, O_REAR,
  O_OLIVE, O_OKIDX, O_OVER, O_OVLEN, O_OFRAGS, O_VWR, O_VWN,
  O_SRV, O_GCL, O_GSQ, O_GPT, O_GTS, O_GKX, O_LKX, O_LVL, O_LVR
};

struct Params {
  const int32_t* in[kIn];
  int32_t* out[kOut];
  int str[kIn + kOut];   // per-point strides in elements
  int B, C, S, F, J;
};

// The arrays of one switch instance.  A launch runs one instance per
// block, block p reading and writing each array `p x its stride` on (a
// stride of 0 shares an input between the points).
struct Inputs {
  const Params& p;
  long long pt;
  __device__ __forceinline__ const int32_t* operator[](int k) const {
    return p.in[k] + pt * p.str[k];
  }
};
struct Outputs {
  const Params& p;
  long long pt;
  __device__ __forceinline__ int32_t* operator[](int k) const {
    return p.out[k] + pt * p.str[kIn + k];
  }
};

// jnp's integer // and % round toward minus infinity; C's toward zero.
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One lane's inputs to the match: its hash words and its four gates.
struct Lane {
  int4 h;
  int want, wreq, inst, frag;
};

template <typename In>
__device__ __forceinline__ Lane load_lane(const In& in, int b, bool hk_vec) {
  Lane l;
  if (hk_vec) {
    l.h = __ldg(reinterpret_cast<const int4*>(in[HKEY]) + b);
  } else {
    const int32_t* h = in[HKEY] + 4 * b;
    l.h = make_int4(__ldg(h), __ldg(h + 1), __ldg(h + 2), __ldg(h + 3));
  }
  l.want = __ldg(in[WANT] + b);
  l.wreq = __ldg(in[WREQ] + b);
  l.inst = __ldg(in[INST] + b);
  l.frag = __ldg(in[FRAG] + b);
  return l;
}

__global__ void __launch_bounds__(kThreads) subround_kernel(Params p) {
  extern __shared__ __align__(16) int32_t sm[];
  const int B = p.B, C = p.C, S = p.S, F = p.F, J = p.J;
  const int C4 = (C + 3) & ~3, CF = C * F, CS = C * S;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const Inputs in{p, blockIdx.x};
  const Outputs out{p, blockIdx.x};

  int4* s_thk = reinterpret_cast<int4*>(sm);  // [C4] hash words per entry
  int32_t* s_k0 = sm + 4 * C4;        // [C4] first hash word, 16-B aligned
  int32_t* s_occ = s_k0 + C4;         // [C] call-time tables ...
  int32_t* s_stv = s_occ + C;
  int32_t* s_stver = s_stv + C;
  int32_t* s_qlen = s_stver + C;
  int32_t* s_rear = s_qlen + C;
  int32_t* s_front = s_rear + C;
  int32_t* s_ofr = s_front + C;       // [C] fragment count, then post-install
  int32_t* s_run = s_ofr + C;         // [C] want lanes of earlier rounds
  int32_t* s_newc = s_run + C;        // [C] accepted lanes
  int32_t* s_pop = s_newc + C;
  int32_t* s_bump = s_pop + C;        // [C] write invalidations
  int32_t* s_valf = s_bump + C;       // [C] validated by an install
  int32_t* s_ewin = s_valf + C;       // [C] last frag-0 installer
  int32_t* s_lcnt = s_ewin + C;       // [C] live lines per entry
  int32_t* s_lwin = s_lcnt + C;       // [C*F] last installer per line
  int32_t* s_line = s_lwin + CF;      // [4][C*F] live, kidx, version, vlen
  int32_t* s_rtw = s_line + 4 * CF;   // [C*S] unique writer per slot
  int32_t* s_rt = s_rtw + CS;         // [6][C*S] the request table
  int32_t* s_cnt = s_rt + 6 * CS;     // [kWarps*C] admission counts
  int32_t* s_wcid = s_cnt + kWarps * C;  // [B] entry a lane may queue at
  int32_t* s_nlive = s_wcid + B;      // [1]

  // ---- 0: every call-time input in flight at once, then shared memory ----
  const bool hk_vec = aligned16(in[HKEY]);
  Lane ln;
  if (tid < B) ln = load_lane(in, tid, hk_vec);
  const int budget = __ldg(in[BUDGET]);

  const bool thk_vec = aligned16(in[THK]);
  const int stage = max(max(C4, CF), CS);
#pragma unroll 2
  for (int i = tid; i < stage; i += nt) {
    int4 k = make_int4(0, 0, 0, 0);   // padding: the match skips c >= C
    int e[7], l[4], r[6];
    if (i < C) {
      const int32_t* t = in[THK] + 4 * i;
      k = thk_vec ? __ldg(reinterpret_cast<const int4*>(t))
                  : make_int4(__ldg(t), __ldg(t + 1), __ldg(t + 2),
                              __ldg(t + 3));
      const int src[7] = {OCC, STV, STVER, QLEN, REAR, FRONT, OFRAGS};
#pragma unroll
      for (int a = 0; a < 7; ++a) e[a] = __ldg(in[src[a]] + i);
    }
    if (i < CF) {
      const int src[4] = {OLIVE, OKIDX, OVER, OVLEN};
#pragma unroll
      for (int a = 0; a < 4; ++a) l[a] = __ldg(in[src[a]] + i);
    }
    if (i < CS) {
      const int src[6] = {RTC, RTS, RTP, RTTS, RTA, RTK};
#pragma unroll
      for (int a = 0; a < 6; ++a) r[a] = __ldg(in[src[a]] + i);
    }
    if (i < C4) {
      s_thk[i] = k;
      s_k0[i] = k.x;
    }
    if (i < C) {
      int32_t* dst[7] = {s_occ, s_stv, s_stver, s_qlen, s_rear, s_front,
                         s_ofr};
#pragma unroll
      for (int a = 0; a < 7; ++a) dst[a][i] = e[a];
      s_run[i] = 0; s_pop[i] = 0; s_bump[i] = 0; s_valf[i] = 0;
      s_ewin[i] = -1;
    }
    if (i < CF) {
      s_lwin[i] = -1;
#pragma unroll
      for (int a = 0; a < 4; ++a) s_line[a * CF + i] = l[a];
    }
    if (i < CS) {
      s_rtw[i] = -1;
#pragma unroll
      for (int a = 0; a < 6; ++a) s_rt[a * CS + i] = r[a];
    }
  }
  for (int i = tid; i < kWarps * C; i += nt) s_cnt[i] = 0;
  if (tid == 0) s_nlive[0] = 0;
  __syncthreads();

  // ---- 1: match + the order-free accumulators ----------------------------
  // The first hash word picks the candidates; a lane with one candidate
  // checks it, a lane with more (a duplicate key, or a word shared by
  // chance) walks every entry.  Warps stay converged, and a warp's lanes
  // count the popularity of one entry with one shared atomic.
  const int4* k0v = reinterpret_cast<const int4*>(s_k0);
  for (int b0 = 0; b0 < B; b0 += nt) {
    const int b = b0 + tid;
    const bool inb = b < B;
    if (inb && b0 > 0) ln = load_lane(in, b, hk_vec);
    const int hx = ln.h.x;
    int cand = -1, ncand = 0;
    if (inb) {
#pragma unroll 8
      for (int q = 0; q < C4 / 4; ++q) {
        const int4 k = k0v[q];
        const int e[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool m = e[u] == hx;
          cand = (m && cand < 0) ? 4 * q + u : cand;
          ncand += m;
        }
      }
    }
    const bool want = inb && ln.want > 0;
    int first = -1;
    if (ncand == 1 && cand < C && s_occ[cand] > 0) {
      const int4 t = s_thk[cand];
      if (t.y == ln.h.y && t.z == ln.h.z && t.w == ln.h.w) first = cand;
    }
    if (ncand > 1) {
      for (int c = 0; c < C; ++c) {
        const int4 t = s_thk[c];
        if (s_occ[c] > 0 && t.x == hx && t.y == ln.h.y && t.z == ln.h.z &&
            t.w == ln.h.w) {
          if (first < 0) first = c;
          // popularity counts every occupied matching entry
          if (want) atomicAdd(&s_pop[c], 1);
        }
      }
    }
    const int pkey = (ncand == 1 && want && first >= 0) ? first : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, pkey);
    if (pkey >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&s_pop[pkey], __popc(peers));
    if (inb) {
      const bool hit = first >= 0;
      const bool valid = hit && s_stv[first] > 0;
      out[O_HIT][b] = hit;
      out[O_VHIT][b] = valid;
      s_wcid[b] = (want && valid) ? first : -1;
      if (hit) {
        if (ln.wreq > 0) atomicAdd(&s_bump[first], 1);
        if (ln.inst > 0) {
          s_valf[first] = 1;
          const int fr = min(max(ln.frag, 0), F - 1);
          atomicMax(&s_lwin[first * F + fr], b);
          if (ln.frag == 0) atomicMax(&s_ewin[first], b);
        }
      }
    }
  }
  __syncthreads();

  // ---- 2: admission, whole-batch exclusive counts in lane order ----------
  const unsigned lt = (1u << lane) - 1u;
  for (int r0 = 0; r0 < B; r0 += nt) {
    if (r0 > 0) {
      for (int i = tid; i < kWarps * C; i += nt) s_cnt[i] = 0;
      __syncthreads();
    }
    const int b = r0 + tid;
    const int cid = b < B ? s_wcid[b] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, cid);
    const int rank = __popc(peers & lt);
    if (cid >= 0 && rank == 0) s_cnt[warp * C + cid] = __popc(peers);
    __syncthreads();
    for (int c = tid; c < C; c += nt) {   // exclusive scan down the column
      int run = s_run[c];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int v = s_cnt[w * C + c];
        s_cnt[w * C + c] = run;
        run += v;
      }
      s_run[c] = run;
    }
    __syncthreads();
    if (b < B) {
      bool acc = false;
      if (cid >= 0) {
        const int offset = s_cnt[warp * C + cid] + rank;
        acc = offset < S - s_qlen[cid];
        if (acc) s_rtw[cid * S + floormod(s_rear[cid] + offset, S)] = b;
      }
      out[O_ACC][b] = acc;
      out[O_OVF][b] = cid >= 0 && !acc;
    }
    __syncthreads();
  }

  // ---- 3: state table, orbit lines and request table ---------------------
  // The winners' payload words are the only global reads left; each thread
  // issues all of its own before it uses any.
  int my_live = 0;
  const int fin = max(C, CS);
  for (int i = tid; i < fin; i += nt) {
    const int ws = i < CS ? s_rtw[i] : -1;
    int pay[5];
    if (ws >= 0) {
      const int src[5] = {CLIENT, SEQ, PORT, TS, KIDX};
#pragma unroll
      for (int a = 0; a < 5; ++a) pay[a] = __ldg(in[src[a]] + ws);
    }
    int ew = -1, nfr = 0;
    if (i < C) {
      ew = s_ewin[i];
      if (ew >= 0) nfr = __ldg(in[NFRAGS] + ew);
    }
    if (i < C) {
      const int c = i;
      const int bump = s_bump[c];
      const int stvf = ((s_stv[c] > 0) && bump == 0) || s_valf[c] > 0;
      const int stverf = s_stver[c] + bump;
      // lanes wanting c took offsets 0 .. run-1; those below free got in
      const int newc = max(0, min(S - s_qlen[c], s_run[c]));
      s_newc[c] = newc;
      out[O_STV][c] = stvf;
      out[O_STVER][c] = stverf;
      out[O_POP][c] = s_pop[c];
      const int ofr = ew >= 0 ? max(nfr, 1) : s_ofr[c];
      s_ofr[c] = ofr;
      out[O_OFRAGS][c] = ofr;
      out[O_REAR][c] = floormod(s_rear[c] + newc, S);
      int lcnt = 0, vsum = 0;
      for (int f = 0; f < F; ++f) {
        const int l = c * F + f;
        const int w = s_lwin[l];
        const bool wr = w >= 0;
        int okidx = s_line[CF + l], ovlen = s_line[3 * CF + l];
        if (wr) {
          okidx = __ldg(in[KIDX] + w);
          ovlen = __ldg(in[VLEN] + w);
        }
        const int over = wr ? stverf : s_line[2 * CF + l];
        const bool live = s_occ[c] > 0 && stvf && over == stverf &&
                          (wr || s_line[l] > 0);
        out[O_OLIVE][l] = live;
        out[O_OKIDX][l] = okidx;
        out[O_OVER][l] = over;
        out[O_OVLEN][l] = ovlen;
        out[O_VWR][l] = wr ? w : 0;
        out[O_VWN][l] = wr;
        lcnt += live;
        vsum += ovlen;
        if (f == 0) {
          out[O_LKX][c] = okidx;
          out[O_LVR][c] = over;
        }
      }
      s_lcnt[c] = lcnt;
      out[O_LVL][c] = vsum;
      my_live += lcnt;
    }
    if (i < CS) {
      const int dst[6] = {O_RTC, O_RTS, O_RTP, O_RTTS, O_RTA, O_RTK};
      const int from[6] = {0, 1, 2, 3, -1, 4};
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        int v = s_rt[a * CS + i];
        if (ws >= 0) {
          v = from[a] < 0 ? 0 : pay[from[a]];
          s_rt[a * CS + i] = v;
        }
        out[dst[a]][i] = v;
      }
    }
  }
  my_live = __reduce_add_sync(0xffffffffu, my_live);
  if (lane == 0 && my_live) atomicAdd(s_nlive, my_live);
  __syncthreads();

  // ---- 4: serving round, one thread per grid cell, from shared memory ----
  const int per_line = floordiv(budget, max(s_nlive[0], 1));
  for (int g = tid; g < C * J; g += nt) {
    const int c = g / J, j = g - c * J;
    const int budget_c = s_lcnt[c] >= s_ofr[c] ? per_line : 0;
    const int n_serve = min(s_qlen[c] + s_newc[c], budget_c);
    const int flat = c * S + floormod(s_front[c] + j, S);
    out[O_SRV][g] = j < n_serve;
    out[O_GCL][g] = s_rt[flat];
    out[O_GSQ][g] = s_rt[CS + flat];
    out[O_GPT][g] = s_rt[2 * CS + flat];
    out[O_GTS][g] = s_rt[3 * CS + flat];
    out[O_GKX][g] = s_rt[5 * CS + flat];
  }
  for (int c = tid; c < C; c += nt) {
    const int budget_c = s_lcnt[c] >= s_ofr[c] ? per_line : 0;
    const int qlen2 = s_qlen[c] + s_newc[c];
    const int n_pop = min(max(min(qlen2, budget_c), 0), J);
    out[O_QLEN][c] = qlen2 - n_pop;
    out[O_FRONT][c] = floormod(s_front[c] + n_pop, S);
  }
}

// Does nothing with the same parameters, block and shared memory: its time
// per launch is the floor that launching sets under subround_kernel.
__global__ void __launch_bounds__(kThreads) empty_kernel(Params) {}

// Dynamic shared memory one launch needs, in bytes (kernel.py mirrors it).
long long smem_bytes(int B, int C, int S, int F) {
  const long long c4 = (C + 3) & ~3;
  return 4LL * (5 * c4 + (long long)C * (14 + 5 * F + 7 * S + kWarps) +
                B + 1);
}

}  // namespace

template <typename K>
int launch_with(K kernel, const unsigned long long* ptrs, const int* strides,
                int P, int B, int C, int S, int F, int J, void* stream) {
  if (P < 1) return (int)cudaErrorInvalidValue;
  Params p;
  for (int i = 0; i < kIn; ++i)
    p.in[i] = reinterpret_cast<const int32_t*>(ptrs[i]);
  for (int i = 0; i < kOut; ++i)
    p.out[i] = reinterpret_cast<int32_t*>(ptrs[kIn + i]);
  for (int i = 0; i < kIn + kOut; ++i) p.str[i] = strides ? strides[i] : 0;
  p.B = B; p.C = C; p.S = S; p.F = F; p.J = J;
  const long long smem = smem_bytes(B, C, S, F);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<P, kThreads, (size_t)smem,
           reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" {

// P switch instances in one launch, one block each.  ptrs: point 0's 31
// inputs then its 32 outputs (device addresses, 4-byte elements);
// strides: the 63 per-point strides in elements, the inputs' then the
// outputs' (0 for an input all points share).  Returns a cudaError_t; 0
// means the launch was accepted.
int subround_batched_launch(const unsigned long long* ptrs,
                            const int* strides, int P, int B, int C, int S,
                            int F, int J, void* stream) {
  return launch_with(subround_kernel, ptrs, strides, P, B, C, S, F, J,
                     stream);
}

// One instance's launch of empty_kernel, to time the launch floor.
int subround_empty_launch(const unsigned long long* ptrs, int B, int C,
                          int S, int F, int J, void* stream) {
  return launch_with(empty_kernel, ptrs, nullptr, 1, B, C, S, F, J, stream);
}

const char* subround_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
