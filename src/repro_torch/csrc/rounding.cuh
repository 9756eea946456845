// Device-side rounding core shared by the rounded-GEMM and update kernels.
//
// A CUDA port of repro.kernels.common.round_block: round_value for plain FP
// grids under the "rn", "sr", "sr_eps" and "signed_sr_eps" schemes (every
// kernel's first instances), round_value_wide for every scheme x grid x
// overflow pair round_block takes (the wide instances of the eq.-8 update,
// K3', K4', K8' and K1', which read their sites with wide_params and round
// through round_at), and the reference's counter-based random bits (Threefry-2x32
// keyed by the element's global (row, col), the interpret-mode derivation
// of repro.kernels.common.counter_bits_reduced).
// The plain PyTorch twin is repro_torch/kernels/common.py; both must give
// the same bits for the same inputs.
//
// Exactness: every step of the decomposition is an exact float32 operation
// (power-of-two scalings assembled in the exponent field, floor, a
// subtraction of two multiples of the same power of two).  The products and
// sums below use __fmul_rn/__fadd_rn so the compiler never contracts them
// into FMAs, and the file must be built without --use_fast_math: subnormals
// are kept, and the flush below 2^-126 that the reference performs is
// explicit.
#pragma once

#include <cstdint>
#include <cstring>

namespace rt {

// A float32 from its bit pattern, on the host.
inline float float_of_bits(int bits) {
  float f;
  std::memcpy(&f, &bits, sizeof f);
  return f;
}

constexpr uint32_t kGolden = 0x9E3779B9u;   // stream offset in the key
constexpr uint32_t kParity = 0x1BD11BDAu;
constexpr float kTiny = 1.17549435082228750797e-38f;   // 2^-126

enum Mode : int { kRN = 0, kSR = 1, kSREps = 2, kSignedSREps = 3,
                  // round_value_wide only: toward zero, away from zero,
                  // toward -inf, toward +inf
                  kRZ = 4, kRA = 5, kRD = 6, kRU = 7 };

// How a stochastic scheme turns its word into a uniform (round_value_wide):
// centred few-bit draws (sr, sr_eps, signed_sr_eps), SR 2.0's uncentred
// comparison draw (sr2), the complemented uncentred draw of the bit trick
// (sr_bittrick), and the bit trick's integer path on bfloat16 at r = 16.
enum Randomness : int { kUniform = 0, kComparison = 1, kBitTrick = 2,
                        kBitTrickBf16 = 3 };

// One rounding site: an FP grid (precision p, [emin, emax], xmax), the
// scheme, the random bits a stochastic draw consumes per element, and the
// epsilon of sr_eps / signed_sr_eps.
struct RoundParams {
  int precision;
  int emin;
  int emax;
  float xmax;
  int mode;
  int rand_bits;   // 32, 16 or 8
  int enabled;     // 0: identity site (no rounding)
  float eps = 0.0f;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds: repro.kernels.common.threefry2x32.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
    const int r0 = (g % 2) ? 17 : 13, r1 = (g % 2) ? 29 : 15;
    const int r2 = (g % 2) ? 16 : 26, r3 = (g % 2) ? 24 : 6;
    x0 += x1; x1 = rotl32(x1, r0) ^ x0;
    x0 += x1; x1 = rotl32(x1, r1) ^ x0;
    x0 += x1; x1 = rotl32(x1, r2) ^ x0;
    x0 += x1; x1 = rotl32(x1, r3) ^ x0;
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  o0 = x0;
  o1 = x1;
}

// The random field of output element (row, col): word col' % 2 of
// threefry(k0, k1 + golden * stream, row, col' / 2) with col' = col / ratio,
// then field col % ratio of that word (ratio = 32 / rand_bits).
__device__ __forceinline__ uint32_t element_bits(uint32_t k0, uint32_t k1,
                                                 uint32_t stream,
                                                 int rand_bits, uint32_t row,
                                                 uint32_t col) {
  const uint32_t ratio = 32u / static_cast<uint32_t>(rand_bits);
  const uint32_t wc = col / ratio;
  uint32_t o0, o1;
  threefry2x32(k0, k1 + kGolden * stream, row, wc >> 1, o0, o1);
  const uint32_t w = (wc & 1u) ? o1 : o0;
  if (rand_bits == 32) return w;
  const uint32_t field = col % ratio;
  return (w >> (field * static_cast<uint32_t>(rand_bits))) &
         ((1u << rand_bits) - 1u);
}

// element_bits at columns c0..c0+3 of one row (c0 % 4 == 0) from the
// fewest Threefry evaluations: one word pair covers 2, 4 or 8 columns at
// r = 32, 16 or 8, so the four take two evaluations at r = 32 and one
// otherwise.
__device__ __forceinline__ void element_bits4(uint32_t k0, uint32_t k1,
                                              uint32_t stream, int rand_bits,
                                              uint32_t row, uint32_t c0,
                                              uint32_t (&out)[4]) {
  const uint32_t key1 = k1 + kGolden * stream;
  uint32_t w0, w1;
  if (rand_bits == 32) {      // word c % 2 of pair c / 2
    threefry2x32(k0, key1, row, c0 >> 1, w0, w1);
    out[0] = w0;
    out[1] = w1;
    threefry2x32(k0, key1, row, (c0 >> 1) + 1u, w0, w1);
    out[2] = w0;
    out[3] = w1;
  } else if (rand_bits == 16) {   // word (c / 2) % 2 of pair c / 4
    threefry2x32(k0, key1, row, c0 >> 2, w0, w1);
    out[0] = w0 & 0xFFFFu;
    out[1] = w0 >> 16;
    out[2] = w1 & 0xFFFFu;
    out[3] = w1 >> 16;
  } else {                    // r = 8: word (c / 4) % 2 of pair c / 8
    threefry2x32(k0, key1, row, c0 >> 3, w0, w1);
    const uint32_t w = ((c0 >> 2) & 1u) ? w1 : w0;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = (w >> (8 * j)) & 0xFFu;
  }
}

// Random bits -> uniform in [0, 1): top 24 bits for r = 32, the centred
// (b + 1/2) * 2^-r for r in {8, 16}.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits,
                                                   int rand_bits) {
  if (rand_bits == 32)
    return __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);
  const float low = __uint2float_rn(bits & ((1u << rand_bits) - 1u));
  const float scale = (rand_bits == 16) ? 1.52587890625e-05f : 0.00390625f;
  return __fmul_rn(__fadd_rn(low, 0.5f), scale);
}

// Exact float32 2^n for -126 <= n <= 127.
__device__ __forceinline__ float pow2i(int n) {
  return __int_as_float((n + 127) << 23);
}

__device__ __forceinline__ int floor_div2(int n) { return n >> 1; }

// x * 2^n exactly, for |n| <= 252, in two in-range factors.
__device__ __forceinline__ float exact_scale(float x, int n) {
  const int n1 = floor_div2(n);
  return __fmul_rn(__fmul_rn(x, pow2i(n1)), pow2i(n - n1));
}

// floor(log2|x|) for normal |x|; -127 for zero and subnormals.
__device__ __forceinline__ int float_exponent(float x) {
  const int raw = (__float_as_int(x) >> 23) & 0xFF;
  return raw > 0 ? raw - 127 : -127;
}

// jnp.sign: +-1, and the argument itself for +-0 and NaN.
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v);
}

// round_block for one value: decompose |z| on the grid, choose the floor or
// ceiling neighbour, saturate at xmax, restore the sign (keeping -0), pass
// NaN and +-inf through.  sign_v is sign(v), the bias direction of
// signed_sr_eps (0 where the site has none).
__device__ __forceinline__ float round_value(float x, uint32_t bits,
                                             const RoundParams& p,
                                             float sign_v = 0.0f) {
  float z = x;
  if (fabsf(z) < kTiny) z = __fmul_rn(z, 0.0f);   // explicit FTZ, signed
  const float mag_in = fabsf(z);
  const int e = float_exponent(mag_in);
  const int qe = min(max(e, p.emin), p.emax) - (p.precision - 1);
  const int qmin = p.emin - p.precision + 1;
  const bool narrow = qmin >= -126 && (p.emax - p.precision) < 126;

  float y, fy, frac, floor_mag, quantum;
  if (narrow) {
    quantum = pow2i(qe);
    y = __fmul_rn(mag_in, pow2i(-qe));
    fy = floorf(y);
    frac = __fadd_rn(y, -fy);
    floor_mag = __fmul_rn(fy, quantum);
  } else {
    y = exact_scale(mag_in, -qe);
    fy = floorf(y);
    frac = __fadd_rn(y, -fy);
    floor_mag = exact_scale(fy, qe);
    quantum = __fmul_rn(pow2i(floor_div2(qe)), pow2i(qe - floor_div2(qe)));
  }

  const float u = (p.mode != kRN) ? uniform_from_bits(bits, p.rand_bits)
                                  : 0.5f;
  float mag;
  if (p.mode == kSR && qmin >= -126) {
    // pure-SR fast path: ceil = floor + quantum exactly; frac == 0 never
    // rounds up, so the exact-input fix-up is implied
    mag = (u < frac) ? __fadd_rn(floor_mag, quantum) : floor_mag;
  } else {
    const float fy1 = __fadd_rn(fy, 1.0f);
    const float ceil_mag = narrow ? __fmul_rn(fy1, pow2i(qe))
                                  : exact_scale(fy1, qe);
    float p_up;
    if (p.mode == kSR) {
      p_up = frac;
    } else if (p.mode == kSREps) {        // min(frac + eps, 1)
      p_up = fminf(__fadd_rn(frac, p.eps), 1.0f);
    } else if (p.mode == kSignedSREps) {  // clamp(frac - sx sv eps, 0, 1)
      const float bias = __fmul_rn(__fmul_rn(sign_of(z), sign_v), p.eps);
      p_up = fminf(fmaxf(__fadd_rn(frac, -bias), 0.0f), 1.0f);
    } else {   // rn, ties to even
      const float odd = (static_cast<int>(fy) & 1) ? 1.0f : 0.0f;
      p_up = frac > 0.5f ? 1.0f : (frac < 0.5f ? 0.0f : odd);
    }
    mag = (u < p_up) ? ceil_mag : floor_mag;
    if (frac == 0.0f) mag = mag_in;
  }
  mag = fminf(mag, p.xmax);
  float out = (z < 0.0f) ? -mag : mag;
  if (z == 0.0f && signbit(z)) out = -0.0f;
  return isfinite(x) ? out : x;
}

// One rounding site of round_value_wide: round_value's site plus what the
// reference's round_block reads beyond it.  mode may be any Mode.
struct WideParams {
  RoundParams r;
  int randomness;     // Randomness
  int overflow_inf;   // 1: magnitudes past xmax become +-inf; 0: saturate
  int subnormals;     // 0: below 2^emin the quantum stays 2^emin
  int shifted;        // round (x - mu) / scale, then map back y * scale + mu
  float scale;
  float mu;
};

// _uniform_from_bits for every randomness kind: the bit trick's
// complemented draw (b ^ (2^r - 1)) 2^-r; else round_value's draws, the
// comparison draw uncentred, b 2^-r.  r = 32 takes the top 24 bits for all
// but the bit trick, as the reference does.
__device__ __forceinline__ float uniform_wide(uint32_t bits, int rand_bits,
                                              int randomness) {
  if (randomness >= kBitTrick) {
    const uint32_t mask =
        rand_bits == 32 ? 0xFFFFFFFFu : (1u << rand_bits) - 1u;
    return __fmul_rn(__uint2float_rn((bits & mask) ^ mask),
                     pow2i(-rand_bits));
  }
  if (rand_bits == 32)
    return __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);
  const float low = __uint2float_rn(bits & ((1u << rand_bits) - 1u));
  return randomness == kComparison
             ? __fmul_rn(low, pow2i(-rand_bits))
             : __fmul_rn(__fadd_rn(low, 0.5f), pow2i(-rand_bits));
}

// round_block for one value on any grid the reference registers -- FP
// formats with or without subnormals, fixed point (an FP format with emin
// == emax), a (scale, mu)-shifted grid around either -- under any scheme,
// saturating or overflowing to +-inf: round_value's steps with the
// reference's additions, in its order.  The shift is (x - mu) / scale
// before, y * scale + mu after, each operation rounded once (no FMA).
// The bit trick on bfloat16 at r = 16 (kBitTrickBf16) adds the 16 random
// bits to the word and keeps its top half.  A scheme with p_up == frac
// (sr, sr2, sr_bittrick) on a grid whose quantum stays a normal float
// takes the ceiling as floor + quantum; every other rule compares u with
// p_up and then puts exactly representable inputs back.
__device__ __forceinline__ float round_value_wide(float x, uint32_t bits,
                                                  const WideParams& w,
                                                  float sign_v = 0.0f) {
  const RoundParams& p = w.r;
  float z = w.shifted ? __fdiv_rn(__fadd_rn(x, -w.mu), w.scale) : x;
  if (fabsf(z) < kTiny) z = __fmul_rn(z, 0.0f);   // explicit FTZ, signed
  if (w.randomness == kBitTrickBf16) {
    float out = __uint_as_float((__float_as_uint(z) + (bits & 0xFFFFu)) &
                                0xFFFF0000u);
    if (!w.overflow_inf && !isfinite(out)) out = __fmul_rn(sign_of(z), p.xmax);
    return isfinite(x) ? out : x;
  }
  const float mag_in = fabsf(z);
  const int e = float_exponent(mag_in);
  int qe = min(max(e, p.emin), p.emax) - (p.precision - 1);
  if (!w.subnormals && e < p.emin) qe = p.emin;
  const int qmin = p.emin - p.precision + 1;
  const bool narrow = qmin >= -126 && (p.emax - p.precision) < 126;

  float y, fy, frac, floor_mag, quantum;
  if (narrow) {
    quantum = pow2i(qe);
    y = __fmul_rn(mag_in, pow2i(-qe));
    fy = floorf(y);
    frac = __fadd_rn(y, -fy);
    floor_mag = __fmul_rn(fy, quantum);
  } else {
    y = exact_scale(mag_in, -qe);
    fy = floorf(y);
    frac = __fadd_rn(y, -fy);
    floor_mag = exact_scale(fy, qe);
    quantum = __fmul_rn(pow2i(floor_div2(qe)), pow2i(qe - floor_div2(qe)));
  }

  const bool stoch =
      p.mode == kSR || p.mode == kSREps || p.mode == kSignedSREps;
  const float u = stoch ? uniform_wide(bits, p.rand_bits, w.randomness)
                        : 0.5f;
  float mag;
  if (p.mode == kSR && qmin >= -126) {
    mag = (u < frac) ? __fadd_rn(floor_mag, quantum) : floor_mag;
  } else {
    const float fy1 = __fadd_rn(fy, 1.0f);
    const float ceil_mag = narrow ? __fmul_rn(fy1, pow2i(qe))
                                  : exact_scale(fy1, qe);
    float p_up;
    if (p.mode == kSR) {
      p_up = frac;
    } else if (p.mode == kSREps) {        // min(frac + eps, 1)
      p_up = fminf(__fadd_rn(frac, p.eps), 1.0f);
    } else if (p.mode == kSignedSREps) {  // clamp(frac - sx sv eps, 0, 1)
      const float bias = __fmul_rn(__fmul_rn(sign_of(z), sign_v), p.eps);
      p_up = fminf(fmaxf(__fadd_rn(frac, -bias), 0.0f), 1.0f);
    } else if (p.mode == kRZ) {
      p_up = 0.0f;
    } else if (p.mode == kRA) {
      p_up = 1.0f;
    } else if (p.mode == kRD) {           // away from zero below zero
      p_up = z < 0.0f ? 1.0f : 0.0f;
    } else if (p.mode == kRU) {           // away from zero above zero
      p_up = z > 0.0f ? 1.0f : 0.0f;
    } else {   // rn, ties to even
      const float odd = (static_cast<int>(fy) & 1) ? 1.0f : 0.0f;
      p_up = frac > 0.5f ? 1.0f : (frac < 0.5f ? 0.0f : odd);
    }
    mag = (u < p_up) ? ceil_mag : floor_mag;
    if (frac == 0.0f) mag = mag_in;
  }
  if (w.overflow_inf)
    mag = mag > p.xmax ? INFINITY : mag;
  else
    mag = fminf(mag, p.xmax);
  float out = (z < 0.0f) ? -mag : mag;
  if (z == 0.0f && signbit(z)) out = -0.0f;
  if (w.shifted) out = __fadd_rn(__fmul_rn(out, w.scale), w.mu);
  return isfinite(x) ? out : x;
}

// The flags of a wide site row's slot 7 (kernels/common.py: wide_flags):
// bits 0-1 the Randomness, bit 2 overflow to +-inf, bit 3 a format without
// subnormals, bit 4 a shifted grid, bit 5 a fixed-point grid (rounded as
// the FP format it is).
constexpr int kFlagInf = 4, kFlagNoSubnormals = 8, kFlagShifted = 16;

// A wide site from the wrappers' row q = int[8] {enabled, precision, emin,
// emax, mode, rand_bits, v source, flags} (kernels/common.py: wide_row),
// its xmax and eps, and shift: its grid's (scale, mu), or null where no
// site of the call is shifted.
__host__ __device__ inline WideParams wide_params(const int* q, float xmax,
                                                  float eps,
                                                  const float* shift) {
  const int f = q[7];
  const bool shifted = (f & kFlagShifted) && shift != nullptr;
  return WideParams{RoundParams{q[1], q[2], q[3], xmax, q[4], q[5], q[0],
                                eps},
                    f & 3, (f & kFlagInf) ? 1 : 0,
                    (f & kFlagNoSubnormals) ? 0 : 1, shifted ? 1 : 0,
                    shifted ? shift[0] : 1.0f, shifted ? shift[1] : 0.0f};
}

// Whether a site's scheme draws random bits: sr (sr2 and the bit trick are
// sr with other draws), sr_eps and signed_sr_eps.
__host__ __device__ __forceinline__ bool draws(int mode) {
  return mode >= kSR && mode <= kSignedSREps;
}

// The GEMM and cast epilogues' rounding of one value, templated on their
// site: round_value at a RoundParams site (their first instances: rn, sr
// and sr_eps on plain FP grids with subnormals, saturating),
// round_value_wide at a WideParams site (their wide instances: every
// scheme x grid x overflow pair).  site_of gives the RoundParams part.
__host__ __device__ __forceinline__ const RoundParams& site_of(
    const RoundParams& p) {
  return p;
}
__host__ __device__ __forceinline__ const RoundParams& site_of(
    const WideParams& w) {
  return w.r;
}
__host__ __device__ __forceinline__ RoundParams& site_of(RoundParams& p) {
  return p;
}
__host__ __device__ __forceinline__ RoundParams& site_of(WideParams& w) {
  return w.r;
}
__device__ __forceinline__ float round_at(float x, uint32_t bits,
                                            const RoundParams& p,
                                            float sign_v = 0.0f) {
  return round_value(x, bits, p, sign_v);
}
__device__ __forceinline__ float round_at(float x, uint32_t bits,
                                            const WideParams& w,
                                            float sign_v = 0.0f) {
  return round_value_wide(x, bits, w, sign_v);
}

// A packed code word's layout (repro_torch.kernels.common.pack_spec):
// sign | biased exponent (ebits) | mantissa (mbits); field 0 holds the
// subnormals, and the all-ones field encodes +-inf / NaN where the format
// has a spare one (has_nf).
struct PackParams {
  int ebits;
  int mbits;
  int emin;
  int has_nf;
};

// A code word back to its exact float32 grid value: the device twin of
// repro_torch.kernels.common.unpack_block, bit for bit (NaN is the
// canonical quiet NaN 0x7FC00000).
__device__ __forceinline__ float unpack(uint32_t c, const PackParams& p) {
  const uint32_t sign = (c >> (p.ebits + p.mbits)) & 1u;
  const uint32_t emask = (1u << p.ebits) - 1u;
  const uint32_t field = (c >> p.mbits) & emask;
  const uint32_t m = c & ((1u << p.mbits) - 1u);
  if (p.has_nf && field == emask) {
    if (m != 0u) return __int_as_float(0x7FC00000);
    return sign ? -INFINITY : INFINITY;
  }
  const int e = field == 0u ? p.emin
                            : static_cast<int>(field) - 1 + p.emin;
  const uint32_t sig = field == 0u ? m : m + (1u << p.mbits);
  const float mag = exact_scale(static_cast<float>(sig), e - p.mbits);
  return sign ? -mag : mag;
}

// A grid value as its code word: the device twin of
// repro_torch.kernels.common.pack_block, bit for bit (xmax, xmin: the
// grid's largest value and smallest normal; a non-finite value takes the
// spare all-ones field where the layout has one, else saturates to xmax).
__device__ __forceinline__ uint32_t pack_code(float x, const PackParams& p,
                                              float xmax, float xmin) {
  const bool finite = isfinite(x);
  const float mag = finite ? fabsf(x) : xmax;
  const uint32_t sign = signbit(x) ? 1u : 0u;
  uint32_t code;
  if (mag >= xmin) {
    const uint32_t bits = __float_as_uint(mag);
    code = ((((bits >> 23) - static_cast<uint32_t>(126 + p.emin)))
            << p.mbits) | ((bits & 0x7FFFFFu) >> (23 - p.mbits));
  } else {   // a subnormal of the grid: its magnitude over the least step
    code = static_cast<uint32_t>(
        __float2int_rz(exact_scale(mag, p.mbits - p.emin)));
  }
  code |= sign << (p.ebits + p.mbits);
  if (p.has_nf && !finite) {
    code = (sign << (p.ebits + p.mbits)) |
           (((1u << p.ebits) - 1u) << p.mbits) |
           (isnan(x) ? (1u << p.mbits) - 1u : 0u);
  }
  return code;
}

// How a tensor is stored: float32 (bytes == 0) or code words of one grid,
// 1 or 2 bytes each (the reference's a_fmt / out_packed storage).
struct CodeFormat {
  int bytes;
  PackParams pack;
  float xmax;
  float xmin;
};

// From the wrappers' int[7] {bytes, ebits, mbits, emin, has_nf, xmax bits,
// xmin bits}; a null pointer is float32.
inline CodeFormat code_format(const int* q) {
  CodeFormat f{0, PackParams{0, 0, 0, 0}, 0.0f, 0.0f};
  if (q == nullptr || q[0] == 0) return f;
  f.bytes = q[0];
  f.pack = PackParams{q[1], q[2], q[3], q[4]};
  f.xmax = float_of_bits(q[5]);
  f.xmin = float_of_bits(q[6]);
  return f;
}

// Element i of a tensor stored as `f`, as float32.
__device__ __forceinline__ float load_code(const void* p, size_t i,
                                           const CodeFormat& f) {
  if (f.bytes == 0) return static_cast<const float*>(p)[i];
  const uint32_t c = f.bytes == 1 ? static_cast<const uint8_t*>(p)[i]
                                  : static_cast<const uint16_t*>(p)[i];
  return unpack(c, f.pack);
}

// Store grid value v as element i of a tensor stored as `f`.
__device__ __forceinline__ void store_code(void* p, size_t i, float v,
                                           const CodeFormat& f) {
  if (f.bytes == 0) {
    static_cast<float*>(p)[i] = v;
  } else if (f.bytes == 1) {
    static_cast<uint8_t*>(p)[i] =
        static_cast<uint8_t>(pack_code(v, f.pack, f.xmax, f.xmin));
  } else {
    static_cast<uint16_t*>(p)[i] =
        static_cast<uint16_t>(pack_code(v, f.pack, f.xmax, f.xmin));
  }
}

// One rounding site of the eq.-8 chain: the identity when disabled.
__device__ __forceinline__ float apply_site(float x, uint32_t bits,
                                            const RoundParams& p,
                                            float sign_v) {
  return p.enabled ? round_value(x, bits, p, sign_v) : x;
}

// SiLU as the plain twin computes it: g * (1 / (1 + exp(-g))).  expf is the
// accurate libm routine (no __expf): this is one of the two places where
// kernel and reference may differ by a float32 ulp (the other is the
// summation order of the GEMM).
__device__ __forceinline__ float silu(float g) {
  return __fmul_rn(g, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g))));
}

// Float32 subnormals to signed zero, as XLA's CPU backend treats operands
// and results: a multiply by 1 with the hardware's flush, one instruction
// on the FMA pipe.  A subnormal becomes the zero of its sign and every
// other value passes exactly, but a NaN comes out as the canonical NaN:
// every flushed value is next an operand of arithmetic, which would make
// that NaN of it anyway.
__device__ __forceinline__ float ftz(float v) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, 0f3F800000;" : "=f"(r) : "f"(v));
  return r;
}

// XLA's CPU float32 tanh, op by op (the twin: repro_torch/core/xla_math.py:
// tanh_f32): |x| below 0.0004 (and NaN) returns x; else x clamped to
// +-7.99881172180175781, then x P(x^2) / Q(x^2) with both polynomials as
// Horner chains of fused multiply-adds and one IEEE division.  No operand
// or result of the chain can be subnormal there, so it needs no flush.
__device__ __forceinline__ float tanh_xla(float x) {
  if (!(fabsf(x) >= 0.0004f)) return x;
  const float c = fminf(fmaxf(x, -7.99881172180175781f), 7.99881172180175781f);
  const float c2 = __fmul_rn(c, c);
  float p = -2.76076847742355e-16f;
  p = __fmaf_rn(c2, p, 2.00018790482477e-13f);
  p = __fmaf_rn(c2, p, -8.60467152213735e-11f);
  p = __fmaf_rn(c2, p, 5.12229709037114e-08f);
  p = __fmaf_rn(c2, p, 1.48572235717979e-05f);
  p = __fmaf_rn(c2, p, 6.37261928875436e-04f);
  p = __fmaf_rn(c2, p, 4.89352455891786e-03f);
  float q = 1.19825839466702e-06f;
  q = __fmaf_rn(c2, q, 1.18534705686654e-04f);
  q = __fmaf_rn(c2, q, 2.26843463243900e-03f);
  q = __fmaf_rn(c2, q, 4.89352518554385e-03f);
  return __fdiv_rn(__fmul_rn(c, p), q);
}

// jax.nn.gelu's tanh form as XLA's CPU code computes it on float32 (the
// twin: repro_torch/kernels/qmatmul.py:gelu): x * (0.5 * (1 + tanh(c *
// fma(0.044715, x^3, x)))), c = float32(sqrt(2 / pi)), x^3 = (x x) x, the
// input and every result flushed.
__device__ __forceinline__ float gelu(float x) {
  x = ftz(x);
  const float x3 = ftz(__fmul_rn(ftz(__fmul_rn(x, x)), x));
  const float inner = ftz(__fmaf_rn(0.044715f, x3, x));
  const float t = tanh_xla(ftz(__fmul_rn(0.7978845834732056f, inner)));
  return ftz(__fmul_rn(x, ftz(__fmul_rn(0.5f, ftz(__fadd_rn(1.0f, t))))));
}

// jax.nn.relu, max(x, 0) on XLA's CPU: x where x is a positive normal
// number, NaN kept, else +0 (-0 and positive subnormals: the comparison
// reads them as 0).
__device__ __forceinline__ float relu(float x) {
  return x >= kTiny || x != x ? x : 0.0f;
}

// jnp.square(jax.nn.relu(x)): relu's result times itself, flushed.
__device__ __forceinline__ float relu_sq(float x) {
  const float r = relu(x);
  return ftz(__fmul_rn(r, r));
}

// The GLU kernels' activations (repro_torch/kernels/qmatmul.py:ACT_FNS),
// one compiled library each (qmatmul_swiglu_<act>.cu).
enum GluAct : int { kSilu = 0, kGelu = 1, kRelu = 2, kReluSq = 3 };

// The GLU hidden act(g) * u before its rounding site.  SiLU keeps the
// product its twin computes (torch's, no flush); the other activations
// mirror XLA's float32 product, operands and result flushed.
template <int kAct>
__device__ __forceinline__ float glu_hidden(float g, float u) {
  if constexpr (kAct == kSilu) {
    return __fmul_rn(silu(g), u);
  } else {
    const float a = kAct == kGelu ? gelu(g) : kAct == kRelu ? relu(g)
                                                           : relu_sq(g);
    return ftz(__fmul_rn(a, ftz(u)));
  }
}

}  // namespace rt
