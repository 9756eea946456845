// sr_cast_prng / sr_cast_bits: round a float32 tensor onto a low-precision
// grid (the activation-site rounding of the precision policy).
//
// Two entry points share one kernel body:
//   sr_cast_prng -- K1', replaces repro/kernels/sr_cast.py:sr_cast_prng_p.
//     The tensor is read as its flat (ceil(n / 128), 128) layout and
//     element i is rounded with the bits of Threefry keyed by
//     (i / 128, i % 128), stream 0 (rounding.cuh:element_bits), so the
//     result depends on neither the block partition nor the launch shape
//     and equals the plain twin repro_torch.kernels.sr_cast.
//     sr_cast_prng_plain bit for bit.
//   sr_cast_bits -- K1, replaces sr_cast.py:sr_cast_p: element i takes
//     word i of a flat uint32 bits operand (its low rand_bits bits), as
//     the plain twin sr_cast_plain does.
// Both take rn, sr, sr_eps and signed_sr_eps (rounding.cuh:round_value);
// signed_sr_eps reads a bias-direction operand v of x's shape and rounds
// toward -sign(v) with probability shifted by eps (the reference's
// _signed_sr_cast_kernel, which draws 32-bit fields).
//
// What bounds it on an H100: K1' moves 8 bytes per element (read x, write
// out; 12 with v) against one Threefry (>= 60 int32 operations) per two
// 32-bit words of random fields; K1 moves 12 (16 with v) and draws
// nothing.  Each thread takes a group of 8 consecutive elements (one row
// of the layout holds 16 groups), so K1' evaluates one Threefry per
// distinct word pair of its group (4 for 32-bit fields, 2 for 16, 1 for
// 8), and where every operand is 16-byte aligned (vec_ok) a group moves as
// 16-byte loads and stores.  At the serving path's size (98,304 elements
// per call) it is bound by the launch, not by either.
#include <cuda_runtime.h>

#include "rounding.cuh"

namespace {

constexpr int kGroup = 8;
constexpr int kThreads = 256;
constexpr uint32_t kLanes = 128;

__device__ __forceinline__ void load8(const float* p, long long i0,
                                      long long n, bool full,
                                      float (&v)[kGroup]) {
  if (full) {
    const float4* src = reinterpret_cast<const float4*>(p + i0);
    const float4 lo = src[0], hi = src[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) v[j] = i0 + j < n ? p[i0 + j] : 0.0f;
  }
}

// bits == nullptr: draw in-kernel (K1'); else read word i (K1).  v: null,
// or the signed_sr_eps bias direction.
__global__ void __launch_bounds__(kThreads)
sr_cast_kernel(const float* __restrict__ x, const uint32_t* __restrict__ bits,
               const float* __restrict__ vdir, float* __restrict__ out,
               long long n, int vec_ok, uint32_t k0, uint32_t k1,
               rt::RoundParams p) {
  const long long n_groups = (n + kGroup - 1) / kGroup;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint32_t ratio = 32u / static_cast<uint32_t>(p.rand_bits);
  const bool stochastic = p.mode != rt::kRN;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       g < n_groups; g += stride) {
    const long long i0 = g * kGroup;
    const bool full = vec_ok && i0 + kGroup <= n;
    float v[kGroup], sv[kGroup];
    load8(x, i0, n, full, v);
    if (vdir != nullptr) {
      load8(vdir, i0, n, full, sv);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) sv[j] = rt::sign_of(sv[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) sv[j] = 0.0f;
    }
    uint32_t w[kGroup];
    if (stochastic && bits != nullptr) {
      if (full) {
        const uint4* src = reinterpret_cast<const uint4*>(bits + i0);
        const uint4 lo = src[0], hi = src[1];
        w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
        w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
      } else {
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          w[j] = i0 + j < n ? bits[i0 + j] : 0u;
      }
    } else if (stochastic) {
      // a group never straddles two rows of the 128-lane layout
      const uint32_t row = static_cast<uint32_t>(i0 / kLanes);
      const uint32_t col0 = static_cast<uint32_t>(i0 % kLanes);
      uint32_t pair = 0xFFFFFFFFu, o0 = 0u, o1 = 0u;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const uint32_t col = col0 + j;
        const uint32_t wc = col / ratio;
        if ((wc >> 1) != pair) {
          pair = wc >> 1;
          rt::threefry2x32(k0, k1, row, pair, o0, o1);
        }
        const uint32_t word = (wc & 1u) ? o1 : o0;
        w[j] = p.rand_bits == 32
                   ? word
                   : (word >> ((col % ratio) *
                               static_cast<uint32_t>(p.rand_bits))) &
                         ((1u << p.rand_bits) - 1u);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) w[j] = 0u;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      v[j] = rt::round_value(v[j], w[j], p, sv[j]);
    if (full) {
      float4* dst = reinterpret_cast<float4*>(out + i0);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (i0 + j < n) out[i0 + j] = v[j];
    }
  }
}

int run(const float* x, const uint32_t* bits, const float* v, float* out,
        long long n, int vec_ok, uint32_t k0, uint32_t k1, int precision,
        int emin, int emax, float xmax, int mode, int rand_bits, float eps,
        void* stream) {
  if (n <= 0) return 0;
  const rt::RoundParams p{precision, emin, emax, xmax, mode, rand_bits, 1,
                          eps};
  const long long n_groups = (n + kGroup - 1) / kGroup;
  const long long want = (n_groups + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  sr_cast_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, bits, v, out, n, vec_ok, k0, k1, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1'.  v: null, or float32 of n elements (signed_sr_eps).  vec_ok: every
// operand is 16-byte aligned (whole groups move as 16-byte words).  Launch
// on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int sr_cast_prng(const float* x, const float* v, float* out,
                            long long n, int vec_ok, uint32_t k0, uint32_t k1,
                            int precision, int emin, int emax, float xmax,
                            int mode, int rand_bits, float eps,
                            void* stream) {
  return run(x, nullptr, v, out, n, vec_ok, k0, k1, precision, emin, emax,
             xmax, mode, rand_bits, eps, stream);
}

// K1.  bits: n uint32 words on the device (read only when stochastic).
extern "C" int sr_cast_bits(const float* x, const uint32_t* bits,
                            const float* v, float* out, long long n,
                            int vec_ok, int precision, int emin, int emax,
                            float xmax, int mode, int rand_bits, float eps,
                            void* stream) {
  return run(x, bits, v, out, n, vec_ok, 0u, 0u, precision, emin, emax, xmax,
             mode, rand_bits, eps, stream);
}
