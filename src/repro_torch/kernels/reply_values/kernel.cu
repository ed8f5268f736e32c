// The servers' reply value bytes for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference computes these bytes in `jnp`
// inside `server_step` (src/repro/kvstore/server.py, `synth_value` and the
// `keep` mask), which XLA fuses into one pass on the TPU.  The port's
// plain version (`ref.py`, `server_step`'s expression before this kernel)
// ran it as ~45 int64 elementwise passes over [n, cap, F, pad] with three
// ops a 32-bit multiply: about 2.08 GB moved a 12-point fleet window for
// 5.52 MB of output.  It computes what `reply_values_ref` computes:
//   out[p, (l * F + j) * pad + i] =
//     splitmix32(kidx * 0x9E3779B9 ^ version * 0x85EBCA6B ^ (j * pad + i))
//     & 0xFF                 if carries[l] and i < clamp(vlen - j * pad,
//                                                          0, pad)
//     0                      otherwise
// for every lane l of point p (live or not, as the plain version), all of
// it in wrapping uint32 arithmetic, the same function bit for bit.
//
// What bounds it: its output.  A 12-point fleet window writes 12 x 32
// servers x 10 lanes x 1 fragment x 1,438 bytes = 5,521,920 bytes, 1.65 us
// at 3.35 TB/s, and reads a few KB.  The hash costs ~12 integer
// instructions a byte, ~4 us of the SMs' integer rate were every byte
// hashed; only the bytes under a lane's value length are (the paper's
// values are 64 B for 82 % of keys), so the rest are stores of zeros.
//
// Design.  The output is one contiguous run of bytes.  Each thread makes
// 16 consecutive bytes of it and stores them as one 16-byte uint4 (the
// output's base is 256-byte aligned); a run that ends in a ragged tail is
// stored byte by byte.  Rows (pad bytes, 1,438 on the paper's rack) are no
// multiple of 16, so a thread derives its row and byte from its flat
// index once, and steps to the next row where its run crosses one; the
// lane's four scalars are read at the start of each row the run touches.
// A run wholly past its row's value length stores zeros and hashes
// nothing.  A fleet's P points (a fabric's points x racks) are one launch:
// each input is read at point * its per-point stride (0 for one all points
// share), and the output's points are stacked.  No int64 anywhere: the
// wrapper refuses an output of 2**31 bytes or more.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;      // bytes a thread makes: one uint4 store

struct Row {
  uint32_t base;   // kidx * P1 ^ version * P2
  uint32_t off;    // j * pad: the row's first byte within its value
  int lim;         // bytes of the row under the value (0: none)
};

__device__ __forceinline__ Row load_row(
    uint32_t row, const int32_t* __restrict__ kidx, uint32_t s_kidx,
    const int32_t* __restrict__ version, uint32_t s_version,
    const int32_t* __restrict__ vlen, uint32_t s_vlen,
    const uint8_t* __restrict__ carries, uint32_t s_carries, uint32_t lanes,
    uint32_t F, uint32_t pad) {
  const uint32_t lane_g = row / F;
  const uint32_t frag = row - lane_g * F;
  const uint32_t p = lane_g / lanes;
  const uint32_t l = lane_g - p * lanes;
  const uint32_t k = static_cast<uint32_t>(__ldg(kidx + p * s_kidx + l));
  const uint32_t v =
      static_cast<uint32_t>(__ldg(version + p * s_version + l));
  const uint32_t off = frag * pad;
  // vlen - j * pad in int32 as the plain version wraps it, then clamped
  const int32_t rest = static_cast<int32_t>(
      static_cast<uint32_t>(__ldg(vlen + p * s_vlen + l)) - off);
  int lim = rest < 0 ? 0 : rest;
  lim = lim > static_cast<int>(pad) ? static_cast<int>(pad) : lim;
  if (!__ldg(carries + p * s_carries + l)) lim = 0;
  return Row{k * 0x9E3779B9u ^ v * 0x85EBCA6Bu, off, lim};
}

__device__ __forceinline__ uint32_t value_byte(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x & 0xFFu;
}

template <bool kWork>
__global__ void __launch_bounds__(kThreads) reply_values_kernel(
    const int32_t* __restrict__ kidx, uint32_t s_kidx,
    const int32_t* __restrict__ version, uint32_t s_version,
    const int32_t* __restrict__ vlen, uint32_t s_vlen,
    const uint8_t* __restrict__ carries, uint32_t s_carries,
    uint8_t* __restrict__ out, uint32_t lanes, uint32_t F, uint32_t pad,
    uint32_t total) {
  if (!kWork) return;
  const uint32_t e0 = (blockIdx.x * kThreads + threadIdx.x) * kRun;
  if (e0 >= total) return;
  const uint32_t n = total - e0 < kRun ? total - e0 : kRun;
  uint32_t row = e0 / pad;
  uint32_t i = e0 - row * pad;
  Row r = load_row(row, kidx, s_kidx, version, s_version, vlen, s_vlen,
                   carries, s_carries, lanes, F, pad);
  uint32_t w[kRun / 4] = {0, 0, 0, 0};
  if (n == kRun && i + kRun <= pad && i >= static_cast<uint32_t>(r.lim)) {
    // the whole run lies in one row, past its value: zeros
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (j < static_cast<int>(n)) {
        if (i == pad) {
          i = 0;
          ++row;
          r = load_row(row, kidx, s_kidx, version, s_version, vlen, s_vlen,
                       carries, s_carries, lanes, F, pad);
        }
        if (i < static_cast<uint32_t>(r.lim))
          w[j >> 2] |= value_byte(r.base ^ (r.off + i)) << (8 * (j & 3));
        ++i;
      }
    }
  }
  if (n == kRun) {
    *reinterpret_cast<uint4*>(out + e0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (uint32_t j = 0; j < n; ++j)
      out[e0 + j] = static_cast<uint8_t>(w[j >> 2] >> (8 * (j & 3)));
  }
}

template <bool kWork>
int launch_with(const void* kidx, long long s_kidx, const void* version,
                long long s_version, const void* vlen, long long s_vlen,
                const void* carries, long long s_carries, void* out, int P,
                int lanes, int F, int pad, void* stream) {
  if (P < 1 || lanes < 1 || F < 1 || pad < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)P * lanes * F * pad;
  const long long lane_count = (long long)P * lanes;
  if (total >= (1LL << 31) || lane_count >= (1LL << 31) ||
      s_kidx < 0 || s_version < 0 || s_vlen < 0 || s_carries < 0 ||
      (s_kidx | s_version | s_vlen | s_carries) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long runs = (total + kRun - 1) / kRun;
  const unsigned blocks = (unsigned)((runs + kThreads - 1) / kThreads);
  reply_values_kernel<kWork>
      <<<blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(kidx), (uint32_t)s_kidx,
          static_cast<const int32_t*>(version), (uint32_t)s_version,
          static_cast<const int32_t*>(vlen), (uint32_t)s_vlen,
          static_cast<const uint8_t*>(carries), (uint32_t)s_carries,
          static_cast<uint8_t*>(out), (uint32_t)lanes, (uint32_t)F,
          (uint32_t)pad, (uint32_t)total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// P points of `lanes` lanes each (device addresses of point 0's int32
// kidx, version and vlen and bool carries [lanes], and the per-point
// strides in elements, 0 for an input every point shares); out
// uint8[P, lanes * F, pad], written whole.  Returns a cudaError_t; 0 means
// the launch was accepted.
int reply_values_launch(const void* kidx, long long s_kidx,
                        const void* version, long long s_version,
                        const void* vlen, long long s_vlen,
                        const void* carries, long long s_carries, void* out,
                        int P, int lanes, int F, int pad, void* stream) {
  return launch_with<true>(kidx, s_kidx, version, s_version, vlen, s_vlen,
                           carries, s_carries, out, P, lanes, F, pad,
                           stream);
}

// The same launch of a kernel that does nothing: the launch floor.
int reply_values_empty_launch(const void* kidx, long long s_kidx,
                              const void* version, long long s_version,
                              const void* vlen, long long s_vlen,
                              const void* carries, long long s_carries,
                              void* out, int P, int lanes, int F, int pad,
                              void* stream) {
  return launch_with<false>(kidx, s_kidx, version, s_version, vlen, s_vlen,
                            carries, s_carries, out, P, lanes, F, pad,
                            stream);
}

const char* reply_values_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
