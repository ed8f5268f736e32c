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
// against 2,048 hot ids) it moves about 40 KB and does a few million
// integer compares, microseconds of either; the launch sets its time.
//
// Design.  The TPU kernel casts the [TB, C] equality matrix to the row
// type and contracts it with the rows on the MXU.  D is 1 on the port's
// path, so tensor cores would do a product of width 1; instead one thread
// owns one (lane, column) output.  A block holds kThreads / td lanes by td
// columns; the hot ids and the block's column slice of the rows pass
// through shared memory in tiles of kTileC (in the accumulator's type),
// every thread compares its id against the tile and accumulates the
// matches, and `hit` comes from the same pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileC = 128;
constexpr int kMaxTD = 32;

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

template <typename T, bool kWork>
__global__ void __launch_bounds__(kThreads) hot_gather_kernel(
    const int32_t* __restrict__ ids,   // [B]
    const int32_t* __restrict__ hot,   // [C]
    const T* __restrict__ rows,        // [C, D]
    T* __restrict__ out,               // [B, D]
    int32_t* __restrict__ hit,         // [B]
    int B, int C, int D, int td) {
  if (!kWork) return;
  using A = typename Acc<T>::type;
  __shared__ int32_t s_hot[kTileC];
  __shared__ A s_rows[kTileC * kMaxTD];
  const int j = threadIdx.x % td;
  const int b = blockIdx.x * (kThreads / td) + threadIdx.x / td;
  const int d0 = blockIdx.y * td;
  const bool lane = threadIdx.x / td < kThreads / td && b < B;
  const int32_t id = lane ? ids[b] : 0;
  A acc = A(0);
  int any = 0;
  for (int c0 = 0; c0 < C; c0 += kTileC) {
    const int n = min(kTileC, C - c0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_hot[i] = hot[c0 + i];
    for (int i = threadIdx.x; i < n * td; i += blockDim.x) {
      const int r = i / td, d = d0 + i % td;
      s_rows[i] = d < D ? Acc<T>::load(rows[(long long)(c0 + r) * D + d])
                        : A(0);
    }
    __syncthreads();
    if (lane) {
      for (int i = 0; i < n; ++i) {
        if (s_hot[i] == id) {
          acc += s_rows[i * td + j];
          any = 1;
        }
      }
    }
    __syncthreads();
  }
  if (lane && d0 + j < D)
    out[(long long)b * D + d0 + j] = Acc<T>::store(acc);
  if (lane && blockIdx.y == 0 && j == 0) hit[b] = any;
}

template <typename T, bool kWork>
int launch_typed(const void* ids, const void* hot, const void* rows,
                 void* out, void* hit, int B, int C, int D, void* stream) {
  const int td = D < kMaxTD ? D : kMaxTD;
  const dim3 grid((B + kThreads / td - 1) / (kThreads / td),
                  (D + td - 1) / td);
  hot_gather_kernel<T, kWork>
      <<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(ids), static_cast<const int32_t*>(hot),
          static_cast<const T*>(rows), static_cast<T*>(out),
          static_cast<int32_t*>(hit), B, C, D, td);
  return (int)cudaGetLastError();
}

template <bool kWork>
int launch_with(const void* ids, const void* hot, const void* rows,
                void* out, void* hit, int B, int C, int D, int dtype,
                void* stream) {
  if (B < 1 || D < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch_typed<int32_t, kWork>(ids, hot, rows, out, hit, B, C, D,
                                          stream);
    case 1:
      return launch_typed<float, kWork>(ids, hot, rows, out, hit, B, C, D,
                                        stream);
    case 2:
      return launch_typed<__nv_bfloat16, kWork>(ids, hot, rows, out, hit,
                                                B, C, D, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// ids int32[B]; hot int32[C]; rows [C, D] and out [B, D] of the row type
// (dtype 0: int32, 1: float32, 2: bf16); hit int32[B] (device
// addresses).  Returns a cudaError_t; 0 means the launch was accepted.
int hot_gather_launch(const void* ids, const void* hot, const void* rows,
                      void* out, void* hit, int B, int C, int D, int dtype,
                      void* stream) {
  return launch_with<true>(ids, hot, rows, out, hit, B, C, D, dtype, stream);
}

// The same launch of a kernel that does nothing: the launch floor.
int hot_gather_empty_launch(const void* ids, const void* hot,
                            const void* rows, void* out, void* hit, int B,
                            int C, int D, int dtype, void* stream) {
  return launch_with<false>(ids, hot, rows, out, hit, B, C, D, dtype, stream);
}

const char* hot_gather_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
