// fused_qupdate: the paper's eq.-8 rounded gradient-descent update over a
// flat float32 parameter vector, in one pass:
//
//   g_hat = Q1(g)              (8a)
//   upd   = Q2(t * g_hat)      (8b)
//   x_new = Q3(x - upd)        (8c, signed-SRe biased by sign(g_hat))
//
// Two entry points:
//   fused_qupdate_prng -- K2', replaces repro/kernels/fused_update.py:
//     fused_qupdate_prng_p.  The random bits are drawn in-kernel: element n
//     sits at (row, col) = (n / 128, n % 128) of the reference's (rows, 128)
//     layout, and the stochastic steps take, in order, word 0 and word 1 of
//     threefry(k0, k1, row, col), then word 0 of
//     threefry(k0, k1 + golden, row, col) (kernel_bits3's pair streams), so
//     the result equals the plain twin and the reference's interpret mode.
//   fused_qupdate_bits -- K2, replaces fused_update.py:fused_qupdate_p.  The
//     three bit planes are an explicit uint32 (3, n) operand.
//
//   fused_qadam_prng -- K5, replaces fused_update.py:fused_qadam_prng_p: one
//     pass of QAdam.  Per element, the m and v carries (float32, or packed
//     grid codes) take the rounded EMAs
//       m' = Qm(b1 m + (1 - b1) g)       bits: stream 8
//       v' = Qv(b2 v + (1 - b2) g g)     bits: stream 9
//     (Kahan-compensated with float32 carries cm, cv when given), then the
//     direction d = (m'/c1) / (sqrt(v'/c2) + eps) + wd x runs the eq.-8
//     chain with K2''s pair words.  The moment bits are
//     counter_bits_reduced fields at (row, col): one Threefry word pair
//     covers 2, 4 or 8 columns at r = 32, 16 or 8, so a thread owns four
//     adjacent columns of one row and draws the pairs once for all four.
//     It computes what the reference's kernel computes as XLA's CPU backend
//     compiles it (the port's bitwise reference): float32 subnormal
//     operands and results are zero (ftz below), the sums XLA contracts
//     are __fmaf_rn with XLA's operand order, and (m'/c1) / (s + eps) is
//     m' / (c1 (s + eps)), XLA's rewrite.
//
// and the optimizer's momentum step beside them:
//   momentum_fma -- out = a * m + g with one rounding (__fmaf_rn), as the
//     reference's compiled step contracts `momentum * m + g`
//     (repro/optim/sgd.py); float32 subnormal operands count as zero and
//     subnormal results flush to zero, as on XLA's CPU backend.
//
// The chain uses __fmul_rn / __fadd_rn so that t * g_hat and x - upd are
// two roundings, never one FMA.  Indices are 64-bit (n reaches ~1.1e9).
//
// What bounds it on an H100: K2' moves 12 bytes per element (x, g in, x_new
// out) and K2 12 plus 4 per stochastic step; K2' also runs one
// Threefry-2x32 (~70 integer operations) per element for every two
// stochastic steps, which with the chain's roundings makes it bound by
// the instructions it issues, not by the bytes.  So K2' and K2 take K5's
// design (below): groups of four consecutive elements per thread (a warp
// covers one row of the 128-lane layout) with 16-byte accesses of x, g,
// the output and K2's bit rows where every operand is aligned (the scalar
// path serves the tail and views off the boundary), a group's words all
// drawn before its arithmetic, and three instances each: one for
// train.PAPER_RUN's chain (rn / sr / signed-SRe with 32-bit draws on a
// narrow grid, sub_v = "grad") with the schemes fixed at compile time, a
// generic one for rn / sr / sr_eps / signed-SRe sites on plain FP grids
// with subnormals, saturating (rt::round_value), and a wide one for every
// scheme x grid x overflow pair the reference's round_block takes
// (rt::round_value_wide: rz / ra / rd / ru, sr2, the bit trick, fixed-point
// and shifted grids, formats without subnormals, overflow to +-inf), which
// the paper's GD experiments run (repro_torch.paper).  The wide instance
// is a kernel of its own so that the other two compile as before.
// momentum_fma is one thread per element in a grid-stride loop with plain
// 4-byte loads.
//
// K5 moves 20 bytes per element with bf16 codes but issues more
// instructions than that takes: two Threefry evaluations, five roundings,
// two IEEE divisions and a square root per element, most of it on the
// half-rate integer and compare pipe.  So its design cuts instructions and
// keeps the loads wide: a thread takes groups of four consecutive elements
// (a warp covers a row of the 128-lane layout), moves each array of a
// group as one 16-, 8- or 4-byte access where every operand is aligned
// (the scalar path serves the tail and views off the boundary), draws all
// of a group's words before its arithmetic, and is compiled twice over:
// an instance for train.ADAM_RUN's case with every scheme, the storage and
// the absence of Kahan carries fixed at compile time (its bf16 SR and
// codes as integer operations, its chain roundings without the runtime
// scheme and draw-width tests), and a generic instance for every other
// case.  The floating-point operations and their order are the same in
// both.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <initializer_list>

#include "rounding.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;   // the reference's (rows, 128) flat layout

// Bias-direction sources of GDRounding's *_v fields.
enum VSource : int { kSelf = 0, kGrad = 1, kNegGrad = 2 };

struct Chain {
  rt::RoundParams grad, mul, sub;
  int grad_v, mul_v, sub_v;
};

__device__ __forceinline__ float sign_v(int source, float g) {
  if (source == kGrad) return rt::sign_of(g);
  if (source == kNegGrad) return rt::sign_of(-g);
  return 0.0f;
}

__device__ __forceinline__ bool stochastic(const rt::RoundParams& p) {
  return p.enabled && p.mode != rt::kRN;
}

__device__ __forceinline__ float update_chain(const Chain& c, float x,
                                              float g, float t, uint32_t b1,
                                              uint32_t b2, uint32_t b3) {
  const float g_hat = rt::apply_site(g, b1, c.grad, sign_v(c.grad_v, g));
  const float upd = rt::apply_site(__fmul_rn(t, g_hat), b2, c.mul,
                                   sign_v(c.mul_v, g_hat));
  const float z = __fadd_rn(x, -upd);
  return rt::apply_site(z, b3, c.sub, sign_v(c.sub_v, g_hat));
}

// Float32 subnormals to signed zero, as XLA's CPU backend treats operands
// and results: a multiply by 1 with the hardware's flush, one instruction
// on the FMA pipe.  A subnormal becomes the zero of its sign and every
// other value passes exactly, but a NaN comes out as the canonical NaN:
// every flushed value here is next an operand of arithmetic, which would
// make that NaN of it anyway.
__device__ __forceinline__ float ftz(float v) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, 0f3F800000;" : "=f"(r) : "f"(v));
  return r;
}

__global__ void __launch_bounds__(kThreads)
momentum_fma_kernel(const float* __restrict__ m,
                    const float* __restrict__ g, float* out, int64_t n,
                    float a) {
  a = ftz(a);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = ftz(
        __fmaf_rn(a, ftz(m[i]), ftz(g[i])));
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------
// One moment site: its rounding, whether it is the bf16 bit-trick SR, and
// its storage (code bytes 0 = float32, else packed with `pack`; bf16: the
// layout is bfloat16's, whose codes are the top half of the float32 word).
struct Moment {
  rt::RoundParams round;
  int bittrick;
  int code_bytes;
  int bf16;
  rt::PackParams pack;
  float xmax, xmin;
};

struct AdamScalars {
  float t, c1, c2, eps, wd, b1, ob1, b2, ob2;
};

// bf16 codes as shifts: rt::unpack and rt::pack_code bit for bit on that
// layout (every NaN code unpacks to the canonical quiet NaN, a NaN packs
// to the all-ones field and mantissa).
__device__ __forceinline__ float unpack_bf16(uint32_t c) {
  const uint32_t w = c << 16;
  return (w & 0x7FFFFFFFu) > 0x7F800000u ? __int_as_float(0x7FC00000)
                                         : __uint_as_float(w);
}

__device__ __forceinline__ uint32_t pack_bf16(float x) {
  const uint32_t c = __float_as_uint(x) >> 16;
  return isnan(x) ? (c & 0x8000u) | 0x7FFFu : c;
}

__device__ __forceinline__ float unpack_moment(uint32_t c, const Moment& s,
                                               bool bf16) {
  return ftz(bf16 ? unpack_bf16(c) : rt::unpack(c, s.pack));
}

__device__ __forceinline__ uint32_t pack_moment(float x, const Moment& s,
                                                bool bf16) {
  return bf16 ? pack_bf16(x) : rt::pack_code(x, s.pack, s.xmax, s.xmin);
}

// Four consecutive float32 elements from i0 (`count` of them in range):
// one 16-byte access when `vec`.
__device__ __forceinline__ void load4(const float* p, int64_t i0, int count,
                                      bool vec, float (&out)[4]) {
  if (vec) {
    const float4 t = *reinterpret_cast<const float4*>(p + i0);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = j < count ? p[i0 + j] : 0.0f;
  }
}

__device__ __forceinline__ void store4(float* p, int64_t i0, int count,
                                       bool vec, const float (&v)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p + i0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < count) p[i0 + j] = v[j];
  }
}

// Four carries as float32 (flushed), from float32 or 1- or 2-byte codes:
// one 16-, 4- or 8-byte access when `vec`.  kBf16: the storage is known
// at compile time to be bf16 codes.
template <bool kBf16>
__device__ __forceinline__ void load_moment4(const void* p, int64_t i0,
                                             int count, bool vec,
                                             const Moment& s,
                                             float (&out)[4]) {
  const int bytes = kBf16 ? 2 : s.code_bytes;
  if (bytes == 0) {
    load4(static_cast<const float*>(p), i0, count, vec, out);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = ftz(out[j]);
    return;
  }
  uint32_t c[4];
  if (bytes == 1) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    if (vec) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(b + i0);
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = (w >> (8 * j)) & 0xFFu;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = j < count ? b[i0 + j] : 0u;
    }
  } else {
    const uint16_t* h = static_cast<const uint16_t*>(p);
    if (vec) {
      const uint2 w = *reinterpret_cast<const uint2*>(h + i0);
      c[0] = w.x & 0xFFFFu; c[1] = w.x >> 16;
      c[2] = w.y & 0xFFFFu; c[3] = w.y >> 16;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = j < count ? h[i0 + j] : 0u;
    }
  }
  const bool bf16 = kBf16 || s.bf16;
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = unpack_moment(c[j], s, bf16);
}

template <bool kBf16>
__device__ __forceinline__ void store_moment4(void* p, int64_t i0, int count,
                                              bool vec, const Moment& s,
                                              const float (&v)[4]) {
  const int bytes = kBf16 ? 2 : s.code_bytes;
  if (bytes == 0) {
    store4(static_cast<float*>(p), i0, count, vec, v);
    return;
  }
  const bool bf16 = kBf16 || s.bf16;
  uint32_t c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) c[j] = pack_moment(v[j], s, bf16);
  if (bytes == 1) {
    uint8_t* b = static_cast<uint8_t*>(p);
    if (vec) {
      *reinterpret_cast<uint32_t*>(b + i0) =
          c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < count) b[i0 + j] = static_cast<uint8_t>(c[j]);
    }
  } else {
    uint16_t* h = static_cast<uint16_t*>(p);
    if (vec) {
      *reinterpret_cast<uint2*>(h + i0) =
          make_uint2(c[0] | (c[1] << 16), c[2] | (c[3] << 16));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < count) h[i0 + j] = static_cast<uint16_t>(c[j]);
    }
  }
}

// round_block's bf16 bit-trick SR: add the 16 random bits to the float32
// word and keep its top half (the carry is the round-up event).
__device__ __forceinline__ float bittrick_bf16(float x, uint32_t bits,
                                               float xmax) {
  const float z = ftz(x);
  const uint32_t r = (__float_as_uint(z) + (bits & 0xFFFFu)) & 0xFFFF0000u;
  float out = __uint_as_float(r);
  if (!isfinite(out)) out = (z > 0.0f ? 1.0f : (z < 0.0f ? -1.0f : z)) * xmax;
  return isfinite(x) ? out : x;
}

// rt::round_value under SR onto bfloat16 with 32-bit draws, in integer form,
// for an input already flushed (as every caller's is): a finite one is 0
// or normal, so its grid quantum is 2^(e - 7) for every exponent, frac is
// the low 16 bits of the word over 2^16, and u = (bits >> 8) 2^-24 < frac
// exactly when bits >> 16 < those 16 bits: the round-up is a carry into
// the top half.  Magnitudes past xmax (and the carry into the exponent's
// all-ones field) saturate.
__device__ __forceinline__ float sr_bf16(float x, uint32_t bits, float xmax) {
  const uint32_t w = __float_as_uint(x);
  if ((w & 0x7F800000u) == 0x7F800000u) return x;   // +-inf, NaN
  const uint32_t r =
      (w & 0xFFFF0000u) + ((bits >> 16) < (w & 0xFFFFu) ? 0x10000u : 0u);
  return __uint_as_float((r & 0x80000000u) |
                         min(r & 0x7FFFFFFFu, __float_as_uint(xmax)));
}

// The instances.  kTrainer: train.ADAM_RUN's case, fixed at compile time
// -- bf16 codes rounded by SR with 32-bit draws, no Kahan carries, the
// chain rn / sr / signed-SRe with 32-bit draws on grids whose scaled
// values stay in float32 range (rounding.cuh's `narrow`); the generic
// instance reads every fact from its arguments.  The host checks that a
// launch fits its instance.
template <bool kTrainer>
__device__ __forceinline__ float round_moment(float x, uint32_t bits,
                                              const Moment& s) {
  if (kTrainer) return sr_bf16(x, bits, s.round.xmax);
  if (!s.round.enabled) return x;
  if (s.bittrick) return bittrick_bf16(x, bits, s.round.xmax);
  return rt::round_value(x, bits, s.round);
}

// One rounded EMA carry (the twin's _moment_ema).  `g` is the gradient
// (for the second moment, a = g * g); kahan carries in `comp`.
template <bool kTrainer, bool kKahan>
__device__ __forceinline__ float moment_ema(const Moment& s, float m,
                                            float g, bool square, float b,
                                            float ob, uint32_t bits,
                                            float& comp) {
  const float a = square ? ftz(__fmul_rn(g, g)) : g;
  if (!kKahan) {
    const bool packed = kTrainer || s.code_bytes;
    const float sum = packed ? ftz(__fmaf_rn(ob, a, ftz(__fmul_rn(b, m))))
                             : ftz(__fmaf_rn(b, m, ftz(__fmul_rn(ob, a))));
    return round_moment<kTrainer>(sum, bits, s);
  }
  const float diff = square ? ftz(__fmaf_rn(g, g, -m)) : ftz(__fsub_rn(g, m));
  const float y = ftz(__fmaf_rn(ob, diff, -comp));
  const float out = round_moment<kTrainer>(ftz(__fadd_rn(m, y)), bits, s);
  comp = ftz(__fsub_rn(ftz(__fsub_rn(out, m)), y));
  return out;
}

// rt::round_value on a narrow grid (its scaled values stay in float32's
// exponent range) with the scheme fixed at compile time and 32-bit draws,
// as the trainer instances' chain runs it: the same floating-point steps
// and choice, with the grid's exponent in float form -- 2^e of the flushed
// |z| (0 or normal) is its exponent field alone, 0 for 0 as round_value's
// e = -127 clamps to emin, clamped to [2^emin, 2^emax] by fminf/fmaxf, so
// quantum = 2^qe comes out of one multiply by 2^(1 - p) and 2^-qe out of
// the biased exponent reflected about 127 (one integer subtraction; qe
// and -qe stay in the normal range on a narrow grid) -- and the sign back
// by copysignf, which gives -mag, -0 and +0 exactly where round_value's
// two steps do (the magnitude is never negative).
template <int kMode>
__device__ __forceinline__ float round_narrow(float x, uint32_t bits,
                                              const rt::RoundParams& p,
                                              float sign_v = 0.0f) {
  const float z = ftz(x);
  const float mag_in = fabsf(z);
  const float scale =
      fminf(fmaxf(__uint_as_float(__float_as_uint(z) & 0x7F800000u),
                  rt::pow2i(p.emin)),
            rt::pow2i(p.emax));
  const float quantum = __fmul_rn(scale, rt::pow2i(1 - p.precision));
  const float y = __fmul_rn(
      mag_in, __uint_as_float(0x7F000000u - __float_as_uint(quantum)));
  float mag;
  if (kMode == rt::kRN) {
    // round_value's choice under rn -- the ceiling above a half, the floor
    // below, the even one of the two at a half, y itself on the grid -- is
    // y rounded to the nearest integer, ties to even: rintf, whose product
    // with the quantum is exact as the floor's and ceiling's are
    mag = __fmul_rn(rintf(y), quantum);
  } else {
    const float fy = floorf(y);
    const float frac = __fadd_rn(y, -fy);
    const float floor_mag = __fmul_rn(fy, quantum);
    if (kMode == rt::kSR) {   // round_value's pure-SR path
      mag = rt::uniform_from_bits(bits, 32) < frac
                ? __fadd_rn(floor_mag, quantum)
                : floor_mag;
    } else {                  // signed-SRe
      const float ceil_mag = __fmul_rn(__fadd_rn(fy, 1.0f), quantum);
      const float u = rt::uniform_from_bits(bits, 32);
      // round_value's sign(z) sign_v eps from the sign bits: +-eps, or a
      // zero where z or sign_v is (whose sign cannot reach p_up); sign_v is
      // +-1 or +-0 here, the chain's signs of finite values
      const float bias =
          (z == 0.0f || sign_v == 0.0f)
              ? 0.0f
              : __uint_as_float(__float_as_uint(p.eps) ^
                                ((__float_as_uint(z) ^
                                  __float_as_uint(sign_v)) & 0x80000000u));
      const float p_up = fminf(fmaxf(__fadd_rn(frac, -bias), 0.0f), 1.0f);
      mag = (u < p_up) ? ceil_mag : floor_mag;
      if (frac == 0.0f) mag = mag_in;
    }
  }
  float out = copysignf(fminf(mag, p.xmax), z);
  // made on every path, so that the pass-through of a non-finite x below is
  // a select and not a branch around the rounding
  asm volatile("" : "+f"(out));
  return isfinite(x) ? out : x;
}

// The words of element (row, col) in the order the chain's stochastic
// steps consume them: word 0 and word 1 of threefry(k0, k1, row, col),
// then word 0 of threefry(k0, k1 + golden, row, col) (kernel_bits3's pair
// streams); a deterministic step takes none.
__device__ __forceinline__ void chain_words(uint32_t k0, uint32_t k1,
                                            uint32_t row, uint32_t col,
                                            const bool (&need)[3],
                                            uint32_t& b1, uint32_t& b2,
                                            uint32_t& b3) {
  const int n_stoch = int(need[0]) + int(need[1]) + int(need[2]);
  uint32_t w0 = 0u, w1 = 0u, w2 = 0u, unused;
  if (n_stoch > 0) rt::threefry2x32(k0, k1, row, col, w0, w1);
  if (n_stoch > 2) rt::threefry2x32(k0, k1 + rt::kGolden, row, col, w2, unused);
  b1 = b2 = b3 = 0u;
  if (need[0]) { b1 = w0; w0 = w1; w1 = w2; }
  if (need[1]) { b2 = w0; w0 = w1; }
  if (need[2]) b3 = w0;
}

// The eq.-8 chain with the trainer's modes fixed: bitwise update_chain
// for rn / sr / signed-SRe sites on narrow grids with 32-bit draws.
// kSubGrad: the signed-SRe direction is sign(g_hat) (sub_v = "grad"), fixed
// at compile time; else read from the chain.
template <bool kSubGrad>
__device__ __forceinline__ float trainer_chain(const Chain& c, float x,
                                               float g, float t, uint32_t b2,
                                               uint32_t b3) {
  const float g_hat = round_narrow<rt::kRN>(g, 0u, c.grad);
  const float upd = round_narrow<rt::kSR>(__fmul_rn(t, g_hat), b2, c.mul);
  const float z = __fadd_rn(x, -upd);
  return round_narrow<rt::kSignedSREps>(
      z, b3, c.sub, kSubGrad ? rt::sign_of(g_hat) : sign_v(c.sub_v, g_hat));
}

// Four consecutive elements of the flat vector and their carries.
struct Group {
  int64_t i0;
  int count;   // elements in range: 4, fewer at the tail, 0 past the end
  bool vec;    // every access of the group is one vector access
  float x[4], g[4], m[4], v[4], cm[4], cv[4];
};

struct K5Args {
  const float* x;
  const float* g;
  const void* m;
  const void* v;
  const float* cm;
  const float* cv;
  float* ox;
  void* om;
  void* ov;
  float* ocm;
  float* ocv;
  int64_t n;
  int vec;     // every pointer aligned for the vector accesses
  AdamScalars sc;
  uint32_t k0, k1;
  Chain c;
  Moment ms, vs;
};

template <bool kTrainer, bool kKahan>
__device__ __forceinline__ void load_group(const K5Args& a, Group& q) {
  load4(a.x, q.i0, q.count, q.vec, q.x);
  load4(a.g, q.i0, q.count, q.vec, q.g);
  load_moment4<kTrainer>(a.m, q.i0, q.count, q.vec, a.ms, q.m);
  load_moment4<kTrainer>(a.v, q.i0, q.count, q.vec, a.vs, q.v);
  if (kKahan) {
    load4(a.cm, q.i0, q.count, q.vec, q.cm);
    load4(a.cv, q.i0, q.count, q.vec, q.cv);
  }
}

// Draw every word of the group first (the moments' fields of streams 8 and
// 9, the chain's pair words of each element), then run its arithmetic and
// store it.
template <bool kTrainer, bool kKahan>
__device__ __forceinline__ void update_group(const K5Args& a, Group& q) {
  const Chain& c = a.c;
  const AdamScalars& sc = a.sc;
  const uint32_t row = static_cast<uint32_t>(static_cast<uint64_t>(q.i0) /
                                             kLanes);
  const uint32_t c0 = static_cast<uint32_t>(q.i0) % kLanes;
  uint32_t bm[4] = {0u, 0u, 0u, 0u}, bv[4] = {0u, 0u, 0u, 0u};
  if (kTrainer || (a.ms.round.enabled && a.ms.round.mode != rt::kRN))
    rt::element_bits4(a.k0, a.k1, 8u, kTrainer ? 32 : a.ms.round.rand_bits,
                      row, c0, bm);
  if (kTrainer || (a.vs.round.enabled && a.vs.round.mode != rt::kRN))
    rt::element_bits4(a.k0, a.k1, 9u, kTrainer ? 32 : a.vs.round.rand_bits,
                      row, c0, bv);
  // the chain's words, as K2' deals them
  uint32_t b1[4], b2[4], b3[4];
  const bool need[3] = {kTrainer ? false : stochastic(c.grad),
                        kTrainer ? true : stochastic(c.mul),
                        kTrainer ? true : stochastic(c.sub)};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    chain_words(a.k0, a.k1, row, c0 + j, need, b1[j], b2[j], b3[j]);
  float xo[4], mo[4], vo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float xi = ftz(q.x[j]);
    const float gi = ftz(q.g[j]);
    float cmi = kKahan ? ftz(q.cm[j]) : 0.0f;
    float cvi = kKahan ? ftz(q.cv[j]) : 0.0f;
    mo[j] = moment_ema<kTrainer, kKahan>(a.ms, q.m[j], gi, false, sc.b1,
                                         sc.ob1, bm[j], cmi);
    vo[j] = moment_ema<kTrainer, kKahan>(a.vs, q.v[j], gi, true, sc.b2,
                                         sc.ob2, bv[j], cvi);
    const float den = ftz(__fadd_rn(
        ftz(__fsqrt_rn(ftz(__fdiv_rn(vo[j], sc.c2)))), sc.eps));
    const float d = ftz(__fmaf_rn(
        sc.wd, xi, ftz(__fdiv_rn(mo[j], ftz(__fmul_rn(sc.c1, den))))));
    xo[j] = kTrainer ? trainer_chain<false>(c, xi, d, sc.t, b2[j], b3[j])
                     : update_chain(c, xi, d, sc.t, b1[j], b2[j], b3[j]);
    q.cm[j] = cmi;
    q.cv[j] = cvi;
  }
  store4(a.ox, q.i0, q.count, q.vec, xo);
  store_moment4<kTrainer>(a.om, q.i0, q.count, q.vec, a.ms, mo);
  store_moment4<kTrainer>(a.ov, q.i0, q.count, q.vec, a.vs, vo);
  if (kKahan) {
    store4(a.ocm, q.i0, q.count, q.vec, q.cm);
    store4(a.ocv, q.i0, q.count, q.vec, q.cv);
  }
}

// Each thread takes groups of 4 consecutive elements (a warp covers one
// row of the 128-lane layout), kInFlight of them kThreads groups apart per
// iteration, all their loads issued before any arithmetic.  One group per
// iteration keeps the trainer instance at 48 registers, so 5 blocks of 256
// threads share an SM; two in flight (71 registers, 3 blocks) read 16 %
// slower on an H100 (launch/k5_variants.py): the warps, not the loads in
// flight, hide the latency of this instruction-bound loop.
constexpr int kInFlight = 1;

template <bool kTrainer, bool kKahan>
__global__ void __launch_bounds__(kThreads)
fused_qadam_prng_kernel(const float* __restrict__ x,
                        const float* __restrict__ g,
                        const void* __restrict__ m,
                        const void* __restrict__ v,
                        const float* __restrict__ cm,
                        const float* __restrict__ cv, float* __restrict__ ox,
                        void* __restrict__ om, void* __restrict__ ov,
                        float* __restrict__ ocm, float* __restrict__ ocv,
                        int64_t n, int vec, AdamScalars sc, uint32_t k0,
                        uint32_t k1, Chain c, Moment ms, Moment vs) {
  const K5Args a{x, g, m, v, cm, cv, ox, om, ov, ocm, ocv, n, vec, sc,
                 k0, k1, c, ms, vs};
  const int64_t groups = (n + 3) / 4;
  const int64_t span = int64_t(gridDim.x) * kThreads * kInFlight;
  for (int64_t q0 = int64_t(blockIdx.x) * kThreads * kInFlight +
                    threadIdx.x;
       q0 < groups; q0 += span) {
    Group q[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int64_t gi = q0 + int64_t(u) * kThreads;
      q[u].i0 = 4 * gi;
      const int64_t left = n - 4 * gi;   // elements from the group on
      q[u].count = left >= 4 ? 4 : (left > 0 ? static_cast<int>(left) : 0);
      q[u].vec = vec && q[u].count == 4;
      if (q[u].count > 0) load_group<kTrainer, kKahan>(a, q[u]);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (q[u].count > 0) update_group<kTrainer, kKahan>(a, q[u]);
  }
}

// ---------------------------------------------------------------------------
// K2' and K2
// ---------------------------------------------------------------------------
struct K2Args {
  const float* x;
  const float* g;
  const uint32_t* bits3;   // K2: uint32 (3, n); K2': null
  float* out;
  int64_t n;
  int vec;        // x, g and out aligned for 16-byte accesses
  int vec_bits;   // bits3 too, and every row's groups (n % 4 == 0)
  float t;
  uint32_t k0, k1;
  Chain c;
};

// Four consecutive words of a bit row from i0: one 16-byte access when
// `vec`.
__device__ __forceinline__ void load_words4(const uint32_t* p, int64_t i0,
                                            int count, bool vec,
                                            uint32_t (&out)[4]) {
  if (vec) {
    const uint4 w = *reinterpret_cast<const uint4*>(p + i0);
    out[0] = w.x; out[1] = w.y; out[2] = w.z; out[3] = w.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = j < count ? p[i0 + j] : 0u;
  }
}

// One group of four consecutive elements from i0 (`count` in range): load
// x and g, take every word of the group (K2: the rows of the stochastic
// steps; K2': all four elements' Threefry words, drawn before any
// arithmetic so that the chains overlap), run the chain, store.
template <bool kTrainer, bool kBits>
__device__ __forceinline__ void qupdate_group(const K2Args& a, int64_t i0,
                                              int count) {
  const bool vec = a.vec && count == 4;
  float x[4], g[4];
  load4(a.x, i0, count, vec, x);
  load4(a.g, i0, count, vec, g);
  const bool need[3] = {kTrainer ? false : stochastic(a.c.grad),
                        kTrainer ? true : stochastic(a.c.mul),
                        kTrainer ? true : stochastic(a.c.sub)};
  uint32_t b[3][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
  if (kBits) {
    const bool vec_bits = a.vec_bits && count == 4;
#pragma unroll
    for (int s = 0; s < 3; ++s)
      if (need[s]) load_words4(a.bits3 + s * a.n, i0, count, vec_bits, b[s]);
  } else {
    const uint32_t row = static_cast<uint32_t>(static_cast<uint64_t>(i0) /
                                               kLanes);
    const uint32_t c0 = static_cast<uint32_t>(i0) % kLanes;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      chain_words(a.k0, a.k1, row, c0 + j, need, b[0][j], b[1][j], b[2][j]);
  }
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = kTrainer ? trainer_chain<true>(a.c, x[j], g[j], a.t, b[1][j],
                                          b[2][j])
                    : update_chain(a.c, x[j], g[j], a.t, b[0][j], b[1][j],
                                   b[2][j]);
  store4(a.out, i0, count, vec, o);
}

// K2' (kBits false) and K2.  Each thread takes groups of four consecutive
// elements (a warp covers one row of the 128-lane layout), kK2Threads
// groups apart, in a grid-stride loop over at most kK2PrngBlocks (K2') or
// kK2BitsBlocks (K2) blocks.  Chosen on an H100 (launch/k5_variants.py
// --kernel k2, over 1.1e9 elements): 512 threads took 1 % off K2' and K2
// against 256; K2, bound by its bytes, ran 4 % faster with one group per
// thread than in 132 x 64 blocks, K2' 4 % slower.
constexpr int kK2Threads = 512;
constexpr int64_t kK2PrngBlocks = 132 * 64;
constexpr int64_t kK2BitsBlocks = 0x7FFFFFFF;

template <bool kTrainer, bool kBits>
__global__ void __launch_bounds__(kK2Threads)
fused_qupdate_kernel(const K2Args a) {
  const int64_t groups = (a.n + 3) / 4;
  const int64_t span = int64_t(gridDim.x) * kK2Threads;
  for (int64_t q = int64_t(blockIdx.x) * kK2Threads + threadIdx.x;
       q < groups; q += span) {
    const int64_t left = a.n - 4 * q;
    qupdate_group<kTrainer, kBits>(a, 4 * q,
                                   left >= 4 ? 4 : static_cast<int>(left));
  }
}

// ---------------------------------------------------------------------------
// K2' and K2, the wide instance
// ---------------------------------------------------------------------------
struct WideChain {
  rt::WideParams grad, mul, sub;
  int grad_v, mul_v, sub_v;
};

struct K2WideArgs {
  const float* x;
  const float* g;
  const uint32_t* bits3;   // K2: uint32 (3, n); K2': null
  float* out;
  int64_t n;
  int vec;
  int vec_bits;
  float t;
  uint32_t k0, k1;
  WideChain c;
};

__device__ __forceinline__ bool wide_stochastic(const rt::WideParams& p) {
  return p.r.enabled && (p.r.mode == rt::kSR || p.r.mode == rt::kSREps ||
                         p.r.mode == rt::kSignedSREps);
}

__device__ __forceinline__ float wide_site(float x, uint32_t bits,
                                           const rt::WideParams& p,
                                           float sv) {
  return p.r.enabled ? rt::round_value_wide(x, bits, p, sv) : x;
}

// update_chain over wide sites: the same operations in the same order.
__device__ __forceinline__ float wide_chain(const WideChain& c, float x,
                                            float g, float t, uint32_t b1,
                                            uint32_t b2, uint32_t b3) {
  const float g_hat = wide_site(g, b1, c.grad, sign_v(c.grad_v, g));
  const float upd = wide_site(__fmul_rn(t, g_hat), b2, c.mul,
                              sign_v(c.mul_v, g_hat));
  const float z = __fadd_rn(x, -upd);
  return wide_site(z, b3, c.sub, sign_v(c.sub_v, g_hat));
}

// qupdate_group of the wide instance: the same loads, words and stores.
template <bool kBits>
__device__ __forceinline__ void wide_group(const K2WideArgs& a, int64_t i0,
                                           int count) {
  const bool vec = a.vec && count == 4;
  float x[4], g[4];
  load4(a.x, i0, count, vec, x);
  load4(a.g, i0, count, vec, g);
  const bool need[3] = {wide_stochastic(a.c.grad), wide_stochastic(a.c.mul),
                        wide_stochastic(a.c.sub)};
  uint32_t b[3][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
  if (kBits) {
    const bool vec_bits = a.vec_bits && count == 4;
#pragma unroll
    for (int s = 0; s < 3; ++s)
      if (need[s]) load_words4(a.bits3 + s * a.n, i0, count, vec_bits, b[s]);
  } else {
    const uint32_t row = static_cast<uint32_t>(static_cast<uint64_t>(i0) /
                                               kLanes);
    const uint32_t c0 = static_cast<uint32_t>(i0) % kLanes;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      chain_words(a.k0, a.k1, row, c0 + j, need, b[0][j], b[1][j], b[2][j]);
  }
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = wide_chain(a.c, x[j], g[j], a.t, b[0][j], b[1][j], b[2][j]);
  store4(a.out, i0, count, vec, o);
}

// The wide instance of K2' (kBits false) and K2: fused_qupdate_kernel's
// launch shape and loop.
template <bool kBits>
__global__ void __launch_bounds__(kK2Threads)
fused_qupdate_wide_kernel(const K2WideArgs a) {
  const int64_t groups = (a.n + 3) / 4;
  const int64_t span = int64_t(gridDim.x) * kK2Threads;
  for (int64_t q = int64_t(blockIdx.x) * kK2Threads + threadIdx.x;
       q < groups; q += span) {
    const int64_t left = a.n - 4 * q;
    wide_group<kBits>(a, 4 * q, left >= 4 ? 4 : static_cast<int>(left));
  }
}

float float_from_bits(int bits) {
  float f;
  std::memcpy(&f, &bits, sizeof f);
  return f;
}

// moment[16] = {enabled, precision, emin, emax, mode, rand_bits, bittrick,
//               code bytes, ebits, mbits, has_nf, xmax bits, xmin bits,
//               eps bits, unused, unused}
Moment make_moment(const int* q) {
  Moment s;
  s.round = rt::RoundParams{q[1], q[2], q[3], float_from_bits(q[11]),
                            q[4], q[5], q[0], float_from_bits(q[13])};
  s.bittrick = q[6];
  s.code_bytes = q[7];
  s.pack = rt::PackParams{q[8], q[9], q[2], q[10]};
  s.bf16 = s.code_bytes == 2 && s.pack.ebits == 8 && s.pack.mbits == 7 &&
           s.pack.emin == -126 && s.pack.has_nf;
  s.xmax = float_from_bits(q[11]);
  s.xmin = float_from_bits(q[12]);
  return s;
}

// site[8] = {enabled, precision, emin, emax, mode, rand_bits, v_source,
//            unused}; xmax[i] / eps[i] alongside.
Chain make_chain(const int* sites, const float* xmax, const float* eps) {
  Chain c;
  rt::RoundParams* ps[3] = {&c.grad, &c.mul, &c.sub};
  int* vs[3] = {&c.grad_v, &c.mul_v, &c.sub_v};
  for (int s = 0; s < 3; ++s) {
    const int* q = sites + 8 * s;
    *ps[s] = rt::RoundParams{q[1], q[2], q[3], xmax[s], q[4], q[5], q[0],
                             eps[s]};
    *vs[s] = q[6];
  }
  return c;
}

// The flags of a site row's slot 7 (wide sites only): bits 0-1 the
// Randomness, bit 2 overflow to +-inf, bit 3 a format without subnormals,
// bit 4 a shifted grid, bit 5 a fixed-point grid (which the wide instance
// rounds as the FP format it is).
constexpr int kFlagInf = 4, kFlagNoSubnormals = 8, kFlagShifted = 16;

// make_chain's sites for the wide instance; shift: float[6], (scale, mu)
// of each site (null: no site is shifted).
WideChain make_wide_chain(const int* sites, const float* xmax,
                          const float* eps, const float* shift) {
  WideChain c;
  rt::WideParams* ps[3] = {&c.grad, &c.mul, &c.sub};
  int* vs[3] = {&c.grad_v, &c.mul_v, &c.sub_v};
  for (int s = 0; s < 3; ++s) {
    const int* q = sites + 8 * s;
    const int f = q[7];
    const bool shifted = (f & kFlagShifted) && shift != nullptr;
    *ps[s] = rt::WideParams{
        rt::RoundParams{q[1], q[2], q[3], xmax[s], q[4], q[5], q[0], eps[s]},
        f & 3, (f & kFlagInf) ? 1 : 0, (f & kFlagNoSubnormals) ? 0 : 1,
        shifted ? 1 : 0, shifted ? shift[2 * s] : 1.0f,
        shifted ? shift[2 * s + 1] : 0.0f};
    *vs[s] = q[6];
  }
  return c;
}

// Whether a chain needs the wide instance: a site with a scheme beyond
// round_value's or any slot-7 flag.
bool wide_only(const int* sites) {
  for (int s = 0; s < 3; ++s) {
    const int* q = sites + 8 * s;
    if (q[0] && (q[4] > rt::kSignedSREps || q[7] != 0)) return true;
  }
  return false;
}

unsigned grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 64;   // a few waves of resident blocks
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

// round_value's `narrow`: the site's scaled values stay in float32 range.
bool narrow(const rt::RoundParams& p) {
  return p.emin - p.precision + 1 >= -126 && p.emax - p.precision < 126;
}

bool site_is(const rt::RoundParams& p, int mode) {
  return p.enabled && p.mode == mode && narrow(p) &&
         (mode == rt::kRN || p.rand_bits == 32);
}

// Whether a chain is the trainer instances' (trainer_chain).
bool trainer_chain_case(const Chain& c) {
  return site_is(c.grad, rt::kRN) && site_is(c.mul, rt::kSR) &&
         site_is(c.sub, rt::kSignedSREps);
}

// Whether a chain is K2' and K2's trainer instance's: the signed-SRe
// direction fixed too.
bool k2_trainer_case(const Chain& c) {
  return trainer_chain_case(c) && c.sub_v == kGrad;
}

// Whether a launch is the trainer instance's case (fused_qadam_prng_kernel).
bool trainer_case(const Chain& c, const Moment& ms, const Moment& vs,
                  bool kahan) {
  for (const Moment* s : {&ms, &vs})
    if (!s->round.enabled || s->round.mode != rt::kSR || s->bittrick ||
        s->round.rand_bits != 32 || !s->bf16)
      return false;
  return !kahan && trainer_chain_case(c);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) ==
         0;
}

dim3 k2_grid(int64_t n, bool bits) {
  const int64_t blocks = ((n + 3) / 4 + kK2Threads - 1) / kK2Threads;
  const int64_t cap = bits ? kK2BitsBlocks : kK2PrngBlocks;
  return dim3(static_cast<unsigned>(blocks < cap ? blocks : cap));
}

// K2' and K2 through fused_qupdate_kernel.  instance: 0 generic, 1 the
// trainer's (fused_update.k2_instance); a trainer launch whose chain does
// not fit is refused.
int launch_qupdate(const K2Args& a, int instance, void* stream) {
  if (a.n <= 0) return 0;
  if (instance == 1 && !k2_trainer_case(a.c))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bits = a.bits3 != nullptr;
  const dim3 grid = k2_grid(a.n, bits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (instance == 1 && bits)
    fused_qupdate_kernel<true, true><<<grid, kK2Threads, 0, st>>>(a);
  else if (instance == 1)
    fused_qupdate_kernel<true, false><<<grid, kK2Threads, 0, st>>>(a);
  else if (bits)
    fused_qupdate_kernel<false, true><<<grid, kK2Threads, 0, st>>>(a);
  else
    fused_qupdate_kernel<false, false><<<grid, kK2Threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K2' and K2 through fused_qupdate_wide_kernel (instance 2).
int launch_wide(const K2WideArgs& a, void* stream) {
  if (a.n <= 0) return 0;
  const bool bits = a.bits3 != nullptr;
  const dim3 grid = k2_grid(a.n, bits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits)
    fused_qupdate_wide_kernel<true><<<grid, kK2Threads, 0, st>>>(a);
  else
    fused_qupdate_wide_kernel<false><<<grid, kK2Threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K2' and K2 on any instance: 0 generic, 1 trainer, 2 wide.  The generic
// and trainer instances refuse a chain that needs the wide one.
int launch_any(const float* x, const float* g, const uint32_t* bits3,
               float* out, int64_t n, float t, uint32_t k0, uint32_t k1,
               const int* sites, const float* xmax, const float* eps,
               const float* shift, int instance, void* stream) {
  const bool vec = aligned(x, 16) && aligned(g, 16) && aligned(out, 16);
  const int vec_bits = bits3 != nullptr && aligned(bits3, 16) && n % 4 == 0;
  if (instance == 2) {
    const K2WideArgs a{x, g, bits3, out, n, vec, vec_bits, t, k0, k1,
                       make_wide_chain(sites, xmax, eps, shift)};
    return launch_wide(a, stream);
  }
  if (wide_only(sites)) return static_cast<int>(cudaErrorInvalidValue);
  const K2Args a{x, g, bits3, out, n, vec, vec_bits, t, k0, k1,
                 make_chain(sites, xmax, eps)};
  return launch_qupdate(a, instance, stream);
}

}  // namespace

// K2'.  sites: int[24], xmax/eps: float[3], shift: float[6] ((scale, mu)
// per site, read by the wide instance only) for (grad, mul, sub).  instance:
// 0 generic, 1 trainer, 2 wide (fused_update.K2_INSTANCES).  Launch on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fused_qupdate_prng(const float* x, const float* g, float* out,
                                  int64_t n, float t, uint32_t k0,
                                  uint32_t k1, const int* sites,
                                  const float* xmax, const float* eps,
                                  const float* shift, int instance,
                                  void* stream) {
  return launch_any(x, g, nullptr, out, n, t, k0, k1, sites, xmax, eps,
                    shift, instance, stream);
}

// K2.  bits3: uint32 (3, n), row s read only where step s is stochastic.
extern "C" int fused_qupdate_bits(const float* x, const float* g,
                                  const uint32_t* bits3, float* out,
                                  int64_t n, float t, const int* sites,
                                  const float* xmax, const float* eps,
                                  const float* shift, int instance,
                                  void* stream) {
  return launch_any(x, g, bits3, out, n, t, 0u, 0u, sites, xmax, eps, shift,
                    instance, stream);
}

// out = a * m + g, one rounding (m, g, out: float32 of n elements).
extern "C" int momentum_fma(const float* m, const float* g, float* out,
                            int64_t n, float a, void* stream) {
  if (n <= 0) return 0;
  momentum_fma_kernel<<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(m, g, out, n, a);
  return static_cast<int>(cudaGetLastError());
}

// K5.  m, v (and the outputs om, ov): float32 or uint8/uint16 codes per
// moment[7]; cm, cv, ocm, ocv: float32 Kahan carries or all null.
// scal order: t, c1, c2, eps, wd, b1, 1 - b1, b2, 1 - b2 (float32).
// instance: 0 generic, 1 the trainer's (fused_update.k5_instance); a
// launch that does not fit the trainer instance is refused.
extern "C" int fused_qadam_prng(const float* x, const float* g,
                                const void* m, const void* v,
                                const float* cm, const float* cv, float* ox,
                                void* om, void* ov, float* ocm, float* ocv,
                                int64_t n, float t, float c1, float c2,
                                float eps, float wd, float b1, float ob1,
                                float b2, float ob2, uint32_t k0,
                                uint32_t k1, const int* sites,
                                const float* xmax, const float* site_eps,
                                const int* moment, int instance,
                                void* stream) {
  if (n <= 0) return 0;
  if ((cm == nullptr) != (ocv == nullptr)) return -1;
  const bool kahan = cm != nullptr;
  const Chain c = make_chain(sites, xmax, site_eps);
  const AdamScalars sc{t, c1, c2, eps, wd, b1, ob1, b2, ob2};
  const Moment ms = make_moment(moment), vs = make_moment(moment + 16);
  if (instance == 1 && !trainer_case(c, ms, vs, kahan))
    return static_cast<int>(cudaErrorInvalidValue);
  // a group of four moves as 16-byte float32 accesses and 4- or 8-byte
  // code accesses where every operand allows it
  bool vec = true;
  for (const float* p : {x, g, cm, cv, static_cast<const float*>(ox),
                         static_cast<const float*>(ocm),
                         static_cast<const float*>(ocv)})
    vec = vec && aligned(p, 16);
  for (int i = 0; i < 2; ++i) {
    const Moment& s = i ? vs : ms;
    const int width = 4 * (s.code_bytes ? s.code_bytes : 4);
    vec = vec && aligned(i ? v : m, width) && aligned(i ? ov : om, width);
  }
  const dim3 grid(grid_for(((n + 3) / 4 + kInFlight - 1) / kInFlight));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (instance == 1)
    fused_qadam_prng_kernel<true, false><<<grid, kThreads, 0, st>>>(
        x, g, m, v, cm, cv, ox, om, ov, ocm, ocv, n, vec, sc, k0, k1, c, ms,
        vs);
  else if (kahan)
    fused_qadam_prng_kernel<false, true><<<grid, kThreads, 0, st>>>(
        x, g, m, v, cm, cv, ox, om, ov, ocm, ocv, n, vec, sc, k0, k1, c, ms,
        vs);
  else
    fused_qadam_prng_kernel<false, false><<<grid, kThreads, 0, st>>>(
        x, g, m, v, cm, cv, ox, om, ov, ocm, ocv, n, vec, sc, k0, k1, c, ms,
        vs);
  return static_cast<int>(cudaGetLastError());
}
