// sr_cast: round a float32 tensor onto a low-precision grid with random bits
// drawn in-kernel (the activation-site rounding of the precision policy).
//
// Replaces the TPU kernel repro/kernels/sr_cast.py:sr_cast_prng_p.  The
// tensor is read as its flat (ceil(n / 128), 128) layout and element i is
// rounded with the bits of Threefry keyed by (i / 128, i % 128), stream 0
// (rounding.cuh:element_bits), so the result depends on neither the block
// partition nor the launch shape and equals the plain twin
// repro_torch.kernels.sr_cast.sr_cast_prng_plain bit for bit.
//
// What bounds it on an H100: 8 bytes per element (read x, write out)
// against one Threefry (>= 60 int32 operations) per two 32-bit words of
// random fields.  Each thread takes a group of 8 consecutive elements
// (one row of the layout holds 16 groups), so it evaluates one Threefry
// per distinct word pair of its group (4 for 32-bit fields, 2 for 16, 1
// for 8) and moves its 32 bytes as two 16-byte loads and stores.  At the
// serving path's size (98,304 elements per call) it is bound by the
// launch, not by either.
#include <cuda_runtime.h>

#include "rounding.cuh"

namespace {

constexpr int kGroup = 8;
constexpr int kThreads = 256;
constexpr uint32_t kLanes = 128;

__global__ void __launch_bounds__(kThreads)
sr_cast_kernel(const float* __restrict__ x, float* __restrict__ out,
               long long n, int vec_ok, uint32_t k0, uint32_t k1,
               rt::RoundParams p) {
  const long long n_groups = (n + kGroup - 1) / kGroup;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint32_t ratio = 32u / static_cast<uint32_t>(p.rand_bits);
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       g < n_groups; g += stride) {
    const long long i0 = g * kGroup;
    const bool full = vec_ok && i0 + kGroup <= n;
    float v[kGroup];
    if (full) {
      const float4* src = reinterpret_cast<const float4*>(x + i0);
      const float4 lo = src[0], hi = src[1];
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) v[j] = i0 + j < n ? x[i0 + j] : 0.0f;
    }
    // a group never straddles two rows of the 128-lane layout
    const uint32_t row = static_cast<uint32_t>(i0 / kLanes);
    const uint32_t col0 = static_cast<uint32_t>(i0 % kLanes);
    uint32_t pair = 0xFFFFFFFFu, o0 = 0u, o1 = 0u;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      uint32_t bits = 0u;
      if (p.mode == rt::kSR) {
        const uint32_t col = col0 + j;
        const uint32_t wc = col / ratio;
        if ((wc >> 1) != pair) {
          pair = wc >> 1;
          rt::threefry2x32(k0, k1, row, pair, o0, o1);
        }
        const uint32_t w = (wc & 1u) ? o1 : o0;
        bits = p.rand_bits == 32
                   ? w
                   : (w >> ((col % ratio) * static_cast<uint32_t>(
                                                p.rand_bits))) &
                         ((1u << p.rand_bits) - 1u);
      }
      v[j] = rt::round_value(v[j], bits, p);
    }
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

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// vec_ok: x and out are 16-byte aligned (whole groups move as float4).
extern "C" int sr_cast_prng(const float* x, float* out, long long n,
                            int vec_ok, uint32_t k0, uint32_t k1,
                            int precision, int emin, int emax, float xmax,
                            int mode, int rand_bits, void* stream) {
  if (n <= 0) return 0;
  const rt::RoundParams p{precision, emin, emax, xmax, mode, rand_bits, 1};
  const long long n_groups = (n + kGroup - 1) / kGroup;
  const long long want = (n_groups + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  sr_cast_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, vec_ok, k0, k1, p);
  return static_cast<int>(cudaGetLastError());
}
