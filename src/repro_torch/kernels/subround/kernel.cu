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
// integer compares; the launch and the in-order admission scan set its time.
//
// Design.  The Pallas kernel streams lane tiles through a sequential TPU
// grid and carries per-entry running counts from one grid step to the next.
// GPU blocks run in no order, so one block (one switch instance) owns the
// whole batch and the tables live in shared memory:
//   1. every thread matches its lanes against all C entries; popularity,
//      write invalidations, validations and the install winners (atomicMax
//      on the lane index: the last installer wins) accumulate in shared
//      memory, since none of them depends on lane order;
//   2. warp 0 walks the lanes in order, 32 at a time: a lane's admission
//      offset is the entry's running count plus the number of earlier
//      lanes of the chunk wanting the same entry (__match_any_sync), and an
//      accepted lane records itself as the unique writer of its slot;
//   3. block-wide, the tables are finalized: request-table winners, state
//      bits and versions, orbit lines stamped with the post-batch version
//      and refreshed by the drop-stale rule;
//   4. the serving round splits the budget over live lines and gathers the
//      J front slots of every entry.
// No float arithmetic: `ts` travels as its 32-bit pattern.  Every array is
// 4-byte, so the kernel sees them all as int32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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
  int B, C, S, F, J;
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

__global__ void __launch_bounds__(kThreads) subround_kernel(Params p) {
  extern __shared__ int32_t sm[];
  const int B = p.B, C = p.C, S = p.S, F = p.F, J = p.J;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int32_t* const* in = p.in;
  int32_t* const* out = p.out;

  int32_t* s_cidx = sm;               // [B] first matching entry or -1
  int32_t* s_thk = s_cidx + B;        // [4C]
  int32_t* s_occ = s_thk + 4 * C;     // [C] call-time tables ...
  int32_t* s_stv = s_occ + C;
  int32_t* s_qlen = s_stv + C;
  int32_t* s_rear = s_qlen + C;
  int32_t* s_run = s_rear + C;        // [C] want lanes seen so far
  int32_t* s_newc = s_run + C;        // [C] accepted lanes
  int32_t* s_pop = s_newc + C;
  int32_t* s_bump = s_pop + C;        // [C] write invalidations
  int32_t* s_valf = s_bump + C;       // [C] validated by an install
  int32_t* s_ewin = s_valf + C;       // [C] last frag-0 installer
  int32_t* s_stvf = s_ewin + C;       // [C] post-batch valid / version
  int32_t* s_stverf = s_stvf + C;
  int32_t* s_lcnt = s_stverf + C;     // [C] live lines per entry
  int32_t* s_ofr = s_lcnt + C;        // [C] post-install fragment count
  int32_t* s_lwin = s_ofr + C;        // [C*F] last installer per line
  int32_t* s_rtw = s_lwin + C * F;    // [C*S] unique writer per slot
  int32_t* s_nlive = s_rtw + C * S;   // [1]

  // ---- 0: call-time tables into shared memory, zero the accumulators ----
  for (int i = tid; i < 4 * C; i += nt) s_thk[i] = in[THK][i];
  for (int c = tid; c < C; c += nt) {
    s_occ[c] = in[OCC][c];
    s_stv[c] = in[STV][c];
    s_qlen[c] = in[QLEN][c];
    s_rear[c] = in[REAR][c];
    s_run[c] = 0; s_newc[c] = 0; s_pop[c] = 0; s_bump[c] = 0;
    s_valf[c] = 0; s_ewin[c] = -1; s_lcnt[c] = 0;
  }
  for (int i = tid; i < C * F; i += nt) s_lwin[i] = -1;
  for (int i = tid; i < C * S; i += nt) s_rtw[i] = -1;
  if (tid == 0) s_nlive[0] = 0;
  __syncthreads();

  // ---- 1: match + the order-free accumulators ----------------------------
  for (int b = tid; b < B; b += nt) {
    const int h0 = in[HKEY][4 * b], h1 = in[HKEY][4 * b + 1];
    const int h2 = in[HKEY][4 * b + 2], h3 = in[HKEY][4 * b + 3];
    const bool want = in[WANT][b] > 0;
    int first = -1;
    for (int c = 0; c < C; ++c) {
      if (s_occ[c] > 0 && s_thk[4 * c] == h0 && s_thk[4 * c + 1] == h1 &&
          s_thk[4 * c + 2] == h2 && s_thk[4 * c + 3] == h3) {
        if (first < 0) first = c;
        // popularity counts every occupied matching entry, not just cidx
        if (want) atomicAdd(&s_pop[c], 1);
      }
    }
    const bool hit = first >= 0;
    out[O_HIT][b] = hit;
    out[O_VHIT][b] = hit && s_stv[first] > 0;
    s_cidx[b] = first;
    if (hit) {
      if (in[WREQ][b] > 0) atomicAdd(&s_bump[first], 1);
      if (in[INST][b] > 0) {
        s_valf[first] = 1;
        const int fr = min(max(in[FRAG][b], 0), F - 1);
        atomicMax(&s_lwin[first * F + fr], b);
        if (in[FRAG][b] == 0) atomicMax(&s_ewin[first], b);
      }
    }
  }
  __syncthreads();

  // ---- 2: admission, in lane order, one warp ------------------------------
  if (tid < 32) {
    const unsigned lt = (1u << tid) - 1u;
    for (int base = 0; base < B; base += 32) {
      const int b = base + tid;
      const bool inb = b < B;
      const int cid = inb ? s_cidx[b] : -1;
      const bool want = inb && cid >= 0 && in[WANT][b] > 0 && s_stv[cid] > 0;
      const unsigned peers = __match_any_sync(0xffffffffu, want ? cid : -1);
      const int rank = __popc(peers & lt);
      const int run = want ? s_run[cid] : 0;
      const int offset = run + rank;
      const bool acc = want && offset < S - s_qlen[cid];
      if (inb) {
        out[O_ACC][b] = acc;
        out[O_OVF][b] = want && !acc;
      }
      if (acc) s_rtw[cid * S + floormod(s_rear[cid] + offset, S)] = b;
      const unsigned accm = __ballot_sync(0xffffffffu, acc);
      __syncwarp();
      if (want && rank == 0) {   // one lane per entry group
        s_run[cid] = run + __popc(peers);
        s_newc[cid] += __popc(peers & accm);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- 3: finalize state table, request table and orbit lines ------------
  for (int c = tid; c < C; c += nt) {
    const int stvf = ((s_stv[c] > 0) && s_bump[c] == 0) || s_valf[c] > 0;
    const int stverf = in[STVER][c] + s_bump[c];
    s_stvf[c] = stvf;
    s_stverf[c] = stverf;
    out[O_STV][c] = stvf;
    out[O_STVER][c] = stverf;
    out[O_POP][c] = s_pop[c];
    const int ew = s_ewin[c];
    s_ofr[c] = ew >= 0 ? max(in[NFRAGS][ew], 1) : in[OFRAGS][c];
    out[O_OFRAGS][c] = s_ofr[c];
    out[O_REAR][c] = floormod(s_rear[c] + s_newc[c], S);
  }
  for (int i = tid; i < C * S; i += nt) {
    const int w = s_rtw[i];
    const bool wr = w >= 0;
    out[O_RTC][i] = wr ? in[CLIENT][w] : in[RTC][i];
    out[O_RTS][i] = wr ? in[SEQ][w] : in[RTS][i];
    out[O_RTP][i] = wr ? in[PORT][w] : in[RTP][i];
    out[O_RTTS][i] = wr ? in[TS][w] : in[RTTS][i];
    out[O_RTA][i] = wr ? 0 : in[RTA][i];
    out[O_RTK][i] = wr ? in[KIDX][w] : in[RTK][i];
  }
  __syncthreads();
  for (int l = tid; l < C * F; l += nt) {
    const int c = l / F;
    const int w = s_lwin[l];
    const bool wr = w >= 0;
    const int over = wr ? s_stverf[c] : in[OVER][l];
    const bool live = s_occ[c] > 0 && s_stvf[c] && over == s_stverf[c] &&
                      (in[OLIVE][l] > 0 || wr);
    out[O_OLIVE][l] = live;
    out[O_OKIDX][l] = wr ? in[KIDX][w] : in[OKIDX][l];
    out[O_OVER][l] = over;
    out[O_OVLEN][l] = wr ? in[VLEN][w] : in[OVLEN][l];
    out[O_VWR][l] = wr ? w : 0;
    out[O_VWN][l] = wr;
    if (live) {
      atomicAdd(&s_lcnt[c], 1);
      atomicAdd(s_nlive, 1);
    }
  }
  __syncthreads();

  // ---- 4: serving round ----------------------------------------------------
  const int per_line = floordiv(in[BUDGET][0], max(s_nlive[0], 1));
  for (int c = tid; c < C; c += nt) {
    const int budget_c = s_lcnt[c] >= s_ofr[c] ? per_line : 0;
    const int qlen2 = s_qlen[c] + s_newc[c];
    const int n_serve = min(qlen2, budget_c);
    const int front0 = in[FRONT][c];
    int n_pop = 0;
    for (int j = 0; j < J; ++j) {
      const int g = c * J + j;
      const int flat = c * S + floormod(front0 + j, S);
      const bool sv = j < n_serve;
      n_pop += sv;
      out[O_SRV][g] = sv;
      out[O_GCL][g] = out[O_RTC][flat];
      out[O_GSQ][g] = out[O_RTS][flat];
      out[O_GPT][g] = out[O_RTP][flat];
      out[O_GTS][g] = out[O_RTTS][flat];
      out[O_GKX][g] = out[O_RTK][flat];
    }
    out[O_QLEN][c] = qlen2 - n_pop;
    out[O_FRONT][c] = floormod(front0 + n_pop, S);
    int vsum = 0;
    for (int f = 0; f < F; ++f) vsum += out[O_OVLEN][c * F + f];
    out[O_LKX][c] = out[O_OKIDX][c * F];
    out[O_LVL][c] = vsum;
    out[O_LVR][c] = out[O_OVER][c * F];
  }
}

// Does nothing with the same parameters, block and shared memory: its time
// per launch is the floor that launching sets under subround_kernel.
__global__ void __launch_bounds__(kThreads) empty_kernel(Params) {}

// Dynamic shared memory one launch needs, in bytes (kernel.py mirrors it).
long long smem_bytes(int B, int C, int S, int F) {
  return 4LL * (B + (long long)C * (18 + F + S) + 1);
}

}  // namespace

template <typename K>
int launch_with(K kernel, const unsigned long long* ptrs, int B, int C,
                int S, int F, int J, void* stream) {
  Params p;
  for (int i = 0; i < kIn; ++i)
    p.in[i] = reinterpret_cast<const int32_t*>(ptrs[i]);
  for (int i = 0; i < kOut; ++i)
    p.out[i] = reinterpret_cast<int32_t*>(ptrs[kIn + i]);
  p.B = B; p.C = C; p.S = S; p.F = F; p.J = J;
  const long long smem = smem_bytes(B, C, S, F);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<1, kThreads, (size_t)smem,
           reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" {

// ptrs: the 31 inputs then the 32 outputs (device addresses, 4-byte
// elements).  Returns a cudaError_t; 0 means the launch was accepted.
int subround_launch(const unsigned long long* ptrs, int B, int C, int S,
                    int F, int J, void* stream) {
  return launch_with(subround_kernel, ptrs, B, C, S, F, J, stream);
}

// The same launch of empty_kernel, to time the launch floor.
int subround_empty_launch(const unsigned long long* ptrs, int B, int C,
                          int S, int F, int J, void* stream) {
  return launch_with(empty_kernel, ptrs, B, C, S, F, J, stream);
}

const char* subround_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
