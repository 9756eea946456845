// sr_cast_prng / sr_cast_bits: round a float32 tensor onto a low-precision
// grid (the activation-site rounding of the precision policy).
//
// Two entry points:
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
// K1' also has a wide instance (sr_cast_prng_wide: rounding.cuh:
// round_value_wide, every scheme x grid x overflow pair of the reference's
// sr_cast_prng_p, the same threads and draws);
// signed_sr_eps reads a bias-direction operand v of x's shape and rounds
// toward -sign(v) with probability shifted by eps (the reference's
// _signed_sr_cast_kernel, which draws 32-bit fields).
//
// What bounds it on an H100: K1' moves 8 bytes per element (read x, write
// out; 12 with v) against one Threefry (>= 60 int32 operations) per two
// 32-bit words of random fields; K1 moves 12 (16 with v) and draws
// nothing.  At the serving path's size (98,304 elements per call) neither
// bounds it: the launch and one thread's dependent chain do.  So a K1'
// thread takes exactly the elements one Threefry evaluation covers (2 at
// 32-bit fields, 4 at 16, 8 at 8: 64 / rand_bits consecutive elements,
// which never straddle a row of the layout) and evaluates it once, with
// 8-, 16- or 32-byte accesses where every operand is 16-byte aligned
// (vec_ok); the grid has a thread per group (49,152 at the path's size,
// 192 blocks) up to 132 x 16 blocks, then strides.  The path's spec (sr,
// 32-bit draws, no v) has an instance with the scheme and the draw width
// fixed at compile time (sr_cast.sr_cast_instance); the generic instance
// reads them from its arguments.  K1 is shaped the same way: a thread
// rounds 4 elements, one 16-byte load of x and one of their words where
// every operand is 16-byte aligned (else element by element), in blocks
// of 128 threads, so the path's 98,304 elements make 24,576 threads in
// 192 blocks over the 132 SMs (8 elements per thread in 256-thread blocks
// made 48 blocks); the path's spec (the oracle act site: sr, 32-bit
// draws, no v) has an instance with both fixed at compile time
// (sr_cast.sr_cast_bits_instance), beside the generic one.
#include <cuda_runtime.h>

#include <type_traits>

#include "rounding.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBitsGroup = 4;      // K1: elements per thread
constexpr int kBitsThreads = 128;  // K1: threads per block
constexpr uint32_t kLanes = 128;
constexpr long long kMaxBlocks = 132 * 16;

// kE consecutive float32 values from p + i0: one 8-byte or kE / 4
// 16-byte loads where `full`, else element by element (zeros past n).
template <int kE>
__device__ __forceinline__ void load_group(const float* p, long long i0,
                                           long long n, bool full,
                                           float (&v)[kE]) {
  if (full) {
    if constexpr (kE == 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + i0);
      v[0] = t.x;
      v[1] = t.y;
    } else {
#pragma unroll
      for (int h = 0; h < kE / 4; ++h) {
        const float4 t = reinterpret_cast<const float4*>(p + i0)[h];
        v[4 * h] = t.x;
        v[4 * h + 1] = t.y;
        v[4 * h + 2] = t.z;
        v[4 * h + 3] = t.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j) v[j] = i0 + j < n ? p[i0 + j] : 0.0f;
  }
}

template <int kE>
__device__ __forceinline__ void store_group(float* p, long long i0,
                                            long long n, bool full,
                                            const float (&v)[kE]) {
  if (full) {
    if constexpr (kE == 2) {
      *reinterpret_cast<float2*>(p + i0) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
      for (int h = 0; h < kE / 4; ++h)
        reinterpret_cast<float4*>(p + i0)[h] = make_float4(
            v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j)
      if (i0 + j < n) p[i0 + j] = v[j];
  }
}

// K1': a thread rounds the kE = 64 / rand_bits elements whose fields come
// from one Threefry evaluation, keyed (i0 / 128, (i0 % 128) / kE): element
// i0 + j takes word j / (kE / 2) of it, field j % (kE / 2) (element_bits
// at (i / 128, i % 128), stream 0).  kMode >= 0 fixes the scheme at compile
// time (the path instance: no v); kMode < 0 reads it from p.  P: the site,
// rt::RoundParams (the first instances) or rt::WideParams (the wide one).
template <int kE, int kMode, typename P = rt::RoundParams>
__global__ void __launch_bounds__(kThreads)
sr_cast_prng_kernel(const float* __restrict__ x,
                    const float* __restrict__ vdir, float* __restrict__ out,
                    long long n, int vec_ok, uint32_t k0, uint32_t k1,
                    P p) {
  constexpr int kBits = 64 / kE, kRatio = kE / 2;
  rt::RoundParams& site = rt::site_of(p);
  site.rand_bits = kBits;
  if (kMode >= 0) site.mode = kMode;
  const bool signed_v = kMode < 0 && vdir != nullptr;
  const long long n_groups = (n + kE - 1) / kE;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       g < n_groups; g += stride) {
    const long long i0 = g * kE;
    const bool full = vec_ok && i0 + kE <= n;
    float v[kE], sv[kE];
    load_group<kE>(x, i0, n, full, v);
    if (signed_v) {
      load_group<kE>(vdir, i0, n, full, sv);
#pragma unroll
      for (int j = 0; j < kE; ++j) sv[j] = rt::sign_of(sv[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kE; ++j) sv[j] = 0.0f;
    }
    uint32_t o0 = 0u, o1 = 0u;
    // the first instances' test, kept as it was (their code unchanged)
    if (std::is_same<P, rt::RoundParams>::value ? site.mode != rt::kRN
                                                 : rt::draws(site.mode))
      rt::threefry2x32(k0, k1, static_cast<uint32_t>(i0 / kLanes),
                       static_cast<uint32_t>((i0 % kLanes) / kE), o0, o1);
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      uint32_t w = j < kRatio ? o0 : o1;
      if constexpr (kBits < 32)
        w = (w >> ((j % kRatio) * kBits)) & ((1u << kBits) - 1u);
      v[j] = rt::round_at(v[j], w, p, sv[j]);
    }
    store_group<kE>(out, i0, n, full, v);
  }
}

// K1: element i takes word i of `bits` (its low rand_bits bits); a
// thread rounds the kBitsGroup elements [i0, i0 + 4).  kMode >= 0 fixes
// the scheme and 32-bit draws at compile time (the path instance: no v);
// kMode < 0 reads them from p, v null or the signed_sr_eps bias direction.
template <int kMode>
__global__ void __launch_bounds__(kBitsThreads)
sr_cast_bits_kernel(const float* __restrict__ x,
                    const uint32_t* __restrict__ bits,
                    const float* __restrict__ vdir, float* __restrict__ out,
                    long long n, int vec_ok, rt::RoundParams p) {
  constexpr int kE = kBitsGroup;
  if (kMode >= 0) {
    p.mode = kMode;
    p.rand_bits = 32;
  }
  const bool signed_v = kMode < 0 && vdir != nullptr;
  const bool stochastic = p.mode != rt::kRN;
  const long long n_groups = (n + kE - 1) / kE;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       g < n_groups; g += stride) {
    const long long i0 = g * kE;
    const bool full = vec_ok && i0 + kE <= n;
    float v[kE], sv[kE];
    uint32_t w[kE] = {0u, 0u, 0u, 0u};
    load_group<kE>(x, i0, n, full, v);
    if (stochastic) {
      if (full) {
        const uint4 t = *reinterpret_cast<const uint4*>(bits + i0);
        w[0] = t.x;
        w[1] = t.y;
        w[2] = t.z;
        w[3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < kE; ++j) w[j] = i0 + j < n ? bits[i0 + j] : 0u;
      }
    }
    if (signed_v) {
      load_group<kE>(vdir, i0, n, full, sv);
#pragma unroll
      for (int j = 0; j < kE; ++j) sv[j] = rt::sign_of(sv[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kE; ++j) sv[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kE; ++j) v[j] = rt::round_value(v[j], w[j], p, sv[j]);
    store_group<kE>(out, i0, n, full, v);
  }
}

int blocks_for(long long n_groups, int threads = kThreads) {
  const long long want = (n_groups + threads - 1) / threads;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

// K1'.  v: null, or float32 of n elements (signed_sr_eps).  vec_ok: every
// operand is 16-byte aligned (groups move as 8-, 16- or 32-byte words).
// instance: 0 generic, 1 the path's (sr, 32-bit draws, no v:
// sr_cast.sr_cast_instance); a launch that does not fit it is refused.
// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int sr_cast_prng(const float* x, const float* v, float* out,
                            long long n, int vec_ok, uint32_t k0, uint32_t k1,
                            int precision, int emin, int emax, float xmax,
                            int mode, int rand_bits, float eps, int instance,
                            void* stream) {
  if (n <= 0) return 0;
  if (rand_bits != 32 && rand_bits != 16 && rand_bits != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (instance == 1 && (mode != rt::kSR || rand_bits != 32 || v != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::RoundParams p{precision, emin, emax, xmax, mode, rand_bits, 1,
                          eps};
  const long long n_groups = (n - 1) / (64 / rand_bits) + 1;
  const int blocks = blocks_for(n_groups);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (instance == 1)
    sr_cast_prng_kernel<2, rt::kSR><<<blocks, kThreads, 0, st>>>(
        x, v, out, n, vec_ok, k0, k1, p);
  else if (rand_bits == 32)
    sr_cast_prng_kernel<2, -1><<<blocks, kThreads, 0, st>>>(
        x, v, out, n, vec_ok, k0, k1, p);
  else if (rand_bits == 16)
    sr_cast_prng_kernel<4, -1><<<blocks, kThreads, 0, st>>>(
        x, v, out, n, vec_ok, k0, k1, p);
  else
    sr_cast_prng_kernel<8, -1><<<blocks, kThreads, 0, st>>>(
        x, v, out, n, vec_ok, k0, k1, p);
  return static_cast<int>(cudaGetLastError());
}

// K1.  bits: n uint32 words on the device (read only when stochastic).
// instance: 0 generic, 1 the path's (sr, 32-bit draws, no v:
// sr_cast.sr_cast_bits_instance); a launch that does not fit it is
// refused.  Other arguments as sr_cast_prng's.
extern "C" int sr_cast_bits(const float* x, const uint32_t* bits,
                            const float* v, float* out, long long n,
                            int vec_ok, int precision, int emin, int emax,
                            float xmax, int mode, int rand_bits, float eps,
                            int instance, void* stream) {
  if (n <= 0) return 0;
  if (instance == 1 && (mode != rt::kSR || rand_bits != 32 || v != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::RoundParams p{precision, emin, emax, xmax, mode, rand_bits, 1,
                          eps};
  const int blocks = blocks_for((n - 1) / kBitsGroup + 1, kBitsThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (instance == 1)
    sr_cast_bits_kernel<rt::kSR><<<blocks, kBitsThreads, 0, st>>>(
        x, bits, v, out, n, vec_ok, p);
  else
    sr_cast_bits_kernel<-1><<<blocks, kBitsThreads, 0, st>>>(
        x, bits, v, out, n, vec_ok, p);
  return static_cast<int>(cudaGetLastError());
}

// K1''s wide instance: every scheme x grid x overflow pair of the
// reference's round_block (sr_cast_prng_p takes overflow).  site: int[8]
// {1, precision, emin, emax, mode, rand_bits, 0, flags} and fsite:
// float[4] {xmax, eps, scale, mu} (rt::wide_params); other arguments as
// sr_cast_prng's.
extern "C" int sr_cast_prng_wide(const float* x, const float* v, float* out,
                                 long long n, int vec_ok, uint32_t k0,
                                 uint32_t k1, const int* site,
                                 const float* fsite, void* stream) {
  if (n <= 0) return 0;
  const int rand_bits = site[5];
  if (rand_bits != 32 && rand_bits != 16 && rand_bits != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::WideParams p =
      rt::wide_params(site, fsite[0], fsite[1], fsite + 2);
  const long long n_groups = (n - 1) / (64 / rand_bits) + 1;
  const int blocks = blocks_for(n_groups);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rand_bits == 32)
    sr_cast_prng_kernel<2, -1, rt::WideParams><<<blocks, kThreads, 0, st>>>(
        x, v, out, n, vec_ok, k0, k1, p);
  else if (rand_bits == 16)
    sr_cast_prng_kernel<4, -1, rt::WideParams><<<blocks, kThreads, 0, st>>>(
        x, v, out, n, vec_ok, k0, k1, p);
  else
    sr_cast_prng_kernel<8, -1, rt::WideParams><<<blocks, kThreads, 0, st>>>(
        x, v, out, n, vec_ok, k0, k1, p);
  return static_cast<int>(cudaGetLastError());
}
