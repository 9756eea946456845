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
// out) and K2 24; K2' also runs one Threefry-2x32 (~80 integer operations)
// per element for every two stochastic steps, which at the card's int32
// rate costs about as much as the bytes.  This first version is one thread
// per element in a grid-stride loop with plain 4-byte loads.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

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
// and results.
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < rt::kTiny ? __fmul_rn(v, 0.0f) : v;   // keeps the sign
}

__global__ void __launch_bounds__(kThreads)
fused_qupdate_prng_kernel(const float* x,
                          const float* __restrict__ g, float* out, int64_t n,
                          float t, uint32_t k0, uint32_t k1, Chain c) {
  const bool need[3] = {stochastic(c.grad), stochastic(c.mul),
                        stochastic(c.sub)};
  const int n_stoch = int(need[0]) + int(need[1]) + int(need[2]);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t row = static_cast<uint32_t>(i / kLanes);
    const uint32_t col = static_cast<uint32_t>(i % kLanes);
    // words in the order the stochastic steps consume them
    uint32_t q0 = 0u, q1 = 0u, q2 = 0u, unused;
    if (n_stoch > 0) rt::threefry2x32(k0, k1, row, col, q0, q1);
    if (n_stoch > 2)
      rt::threefry2x32(k0, k1 + rt::kGolden, row, col, q2, unused);
    uint32_t b1 = 0u, b2 = 0u, b3 = 0u;
    if (need[0]) { b1 = q0; q0 = q1; q1 = q2; }
    if (need[1]) { b2 = q0; q0 = q1; }
    if (need[2]) b3 = q0;
    out[i] = update_chain(c, x[i], g[i], t, b1, b2, b3);
  }
}

__global__ void __launch_bounds__(kThreads)
fused_qupdate_bits_kernel(const float* x,
                          const float* __restrict__ g,
                          const uint32_t* __restrict__ bits3, float* out,
                          int64_t n, float t, Chain c) {
  const bool need[3] = {stochastic(c.grad), stochastic(c.mul),
                        stochastic(c.sub)};
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t b1 = need[0] ? bits3[i] : 0u;
    const uint32_t b2 = need[1] ? bits3[n + i] : 0u;
    const uint32_t b3 = need[2] ? bits3[2 * n + i] : 0u;
    out[i] = update_chain(c, x[i], g[i], t, b1, b2, b3);
  }
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
// its storage (code bytes 0 = float32, else packed with `pack`).
struct Moment {
  rt::RoundParams round;
  int bittrick;
  int code_bytes;
  rt::PackParams pack;
  float xmax, xmin;
};

struct AdamScalars {
  float t, c1, c2, eps, wd, b1, ob1, b2, ob2;
};

// A grid value as its code word (rounding.cuh: pack_code).
__device__ __forceinline__ uint32_t pack_code(float x, const Moment& s) {
  return rt::pack_code(x, s.pack, s.xmax, s.xmin);
}

__device__ __forceinline__ float load_moment(const void* p, int64_t i,
                                             const Moment& s) {
  if (s.code_bytes == 0) return ftz(static_cast<const float*>(p)[i]);
  const uint32_t c = s.code_bytes == 1
                         ? static_cast<const uint8_t*>(p)[i]
                         : static_cast<const uint16_t*>(p)[i];
  return ftz(rt::unpack(c, s.pack));
}

__device__ __forceinline__ void store_moment(void* p, int64_t i, float v,
                                             const Moment& s) {
  if (s.code_bytes == 0) {
    static_cast<float*>(p)[i] = v;
  } else if (s.code_bytes == 1) {
    static_cast<uint8_t*>(p)[i] = static_cast<uint8_t>(pack_code(v, s));
  } else {
    static_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(pack_code(v, s));
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

__device__ __forceinline__ float round_moment(float x, uint32_t bits,
                                              const Moment& s) {
  if (!s.round.enabled) return x;
  if (s.bittrick) return bittrick_bf16(x, bits, s.round.xmax);
  return rt::round_value(x, bits, s.round);
}

// The random fields of columns c0..c0+3 (c0 % 4 == 0) of one row:
// counter_bits_reduced(k0, k1, stream, rand_bits) at (row, c).
__device__ __forceinline__ void moment_bits(uint32_t k0, uint32_t k1,
                                            uint32_t stream, int rand_bits,
                                            uint32_t row, uint32_t c0,
                                            uint32_t out[4]) {
  const uint32_t key1 = k1 + rt::kGolden * stream;
  uint32_t w0, w1;
  if (rand_bits == 32) {      // word c % 2 of pair c / 2
    rt::threefry2x32(k0, key1, row, c0 >> 1, w0, w1);
    out[0] = w0;
    out[1] = w1;
    rt::threefry2x32(k0, key1, row, (c0 >> 1) + 1u, w0, w1);
    out[2] = w0;
    out[3] = w1;
  } else if (rand_bits == 16) {   // word (c / 2) % 2 of pair c / 4
    rt::threefry2x32(k0, key1, row, c0 >> 2, w0, w1);
    out[0] = w0 & 0xFFFFu;
    out[1] = w0 >> 16;
    out[2] = w1 & 0xFFFFu;
    out[3] = w1 >> 16;
  } else {                    // r = 8: word (c / 4) % 2 of pair c / 8
    rt::threefry2x32(k0, key1, row, c0 >> 3, w0, w1);
    const uint32_t w = ((c0 >> 2) & 1u) ? w1 : w0;
    for (int j = 0; j < 4; ++j) out[j] = (w >> (8 * j)) & 0xFFu;
  }
}

// One rounded EMA carry (the twin's _moment_ema).  `g` is the gradient
// (for the second moment, a = g * g); kahan carries in `comp`.
__device__ __forceinline__ float moment_ema(const Moment& s, float m,
                                            float g, bool square, float b,
                                            float ob, uint32_t bits,
                                            bool kahan, float* comp) {
  const float a = square ? ftz(__fmul_rn(g, g)) : g;
  if (!kahan) {
    const float sum =
        s.code_bytes ? ftz(__fmaf_rn(ob, a, ftz(__fmul_rn(b, m))))
                     : ftz(__fmaf_rn(b, m, ftz(__fmul_rn(ob, a))));
    return round_moment(sum, bits, s);
  }
  const float diff = square ? ftz(__fmaf_rn(g, g, -m)) : ftz(__fsub_rn(g, m));
  const float y = ftz(__fmaf_rn(ob, diff, -*comp));
  const float out = round_moment(ftz(__fadd_rn(m, y)), bits, s);
  *comp = ftz(__fsub_rn(ftz(__fsub_rn(out, m)), y));
  return out;
}

__global__ void __launch_bounds__(kThreads)
fused_qadam_prng_kernel(const float* x, const float* __restrict__ g,
                        const void* m, const void* v,
                        const float* __restrict__ cm,
                        const float* __restrict__ cv, float* ox, void* om,
                        void* ov, float* ocm, float* ocv, int64_t n,
                        AdamScalars sc, uint32_t k0, uint32_t k1, Chain c,
                        Moment ms, Moment vs) {
  const bool need[3] = {stochastic(c.grad), stochastic(c.mul),
                        stochastic(c.sub)};
  const int n_stoch = int(need[0]) + int(need[1]) + int(need[2]);
  const bool kahan = cm != nullptr;
  const bool m_draw = ms.round.enabled && ms.round.mode != rt::kRN;
  const bool v_draw = vs.round.enabled && vs.round.mode != rt::kRN;
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t q = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
       q < groups; q += stride) {
    const int64_t i0 = 4 * q;
    const uint32_t row = static_cast<uint32_t>(i0 / kLanes);
    const uint32_t c0 = static_cast<uint32_t>(i0 % kLanes);
    uint32_t bm[4] = {0u, 0u, 0u, 0u}, bv[4] = {0u, 0u, 0u, 0u};
    if (m_draw)
      moment_bits(k0, k1, 8u, ms.round.rand_bits, row, c0, bm);
    if (v_draw)
      moment_bits(k0, k1, 9u, vs.round.rand_bits, row, c0, bv);
    for (int j = 0; j < 4; ++j) {
      const int64_t i = i0 + j;
      if (i >= n) break;
      const float xi = ftz(x[i]);
      const float gi = ftz(g[i]);
      float cmi = kahan ? ftz(cm[i]) : 0.0f;
      float cvi = kahan ? ftz(cv[i]) : 0.0f;
      const float mi = moment_ema(ms, load_moment(m, i, ms), gi, false,
                                  sc.b1, sc.ob1, bm[j], kahan, &cmi);
      const float vi = moment_ema(vs, load_moment(v, i, vs), gi, true,
                                  sc.b2, sc.ob2, bv[j], kahan, &cvi);
      const float den = ftz(__fadd_rn(ftz(__fsqrt_rn(ftz(__fdiv_rn(vi,
                                                                   sc.c2)))),
                                      sc.eps));
      const float d = ftz(__fmaf_rn(
          sc.wd, xi, ftz(__fdiv_rn(mi, ftz(__fmul_rn(sc.c1, den))))));
      // the chain's words, as fused_qupdate_prng_kernel deals them
      uint32_t q0 = 0u, q1 = 0u, q2 = 0u, unused;
      if (n_stoch > 0) rt::threefry2x32(k0, k1, row, c0 + j, q0, q1);
      if (n_stoch > 2)
        rt::threefry2x32(k0, k1 + rt::kGolden, row, c0 + j, q2, unused);
      uint32_t b1 = 0u, b2 = 0u, b3 = 0u;
      if (need[0]) { b1 = q0; q0 = q1; q1 = q2; }
      if (need[1]) { b2 = q0; q0 = q1; }
      if (need[2]) b3 = q0;
      ox[i] = update_chain(c, xi, d, sc.t, b1, b2, b3);
      store_moment(om, i, mi, ms);
      store_moment(ov, i, vi, vs);
      if (kahan) {
        ocm[i] = cmi;
        ocv[i] = cvi;
      }
    }
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

unsigned grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 64;   // a few waves of resident blocks
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

}  // namespace

// K2'.  sites: int[24], xmax/eps: float[3] (grad, mul, sub).  Launch on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fused_qupdate_prng(const float* x, const float* g, float* out,
                                  int64_t n, float t, uint32_t k0,
                                  uint32_t k1, const int* sites,
                                  const float* xmax, const float* eps,
                                  void* stream) {
  if (n <= 0) return 0;
  const Chain c = make_chain(sites, xmax, eps);
  fused_qupdate_prng_kernel<<<grid_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, g, out, n, t, k0, k1, c);
  return static_cast<int>(cudaGetLastError());
}

// K2.  bits3: uint32 (3, n), row s read only where step s is stochastic.
extern "C" int fused_qupdate_bits(const float* x, const float* g,
                                  const uint32_t* bits3, float* out,
                                  int64_t n, float t, const int* sites,
                                  const float* xmax, const float* eps,
                                  void* stream) {
  if (n <= 0) return 0;
  const Chain c = make_chain(sites, xmax, eps);
  fused_qupdate_bits_kernel<<<grid_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, g, bits3, out, n, t, c);
  return static_cast<int>(cudaGetLastError());
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
extern "C" int fused_qadam_prng(const float* x, const float* g,
                                const void* m, const void* v,
                                const float* cm, const float* cv, float* ox,
                                void* om, void* ov, float* ocm, float* ocv,
                                int64_t n, float t, float c1, float c2,
                                float eps, float wd, float b1, float ob1,
                                float b2, float ob2, uint32_t k0,
                                uint32_t k1, const int* sites,
                                const float* xmax, const float* site_eps,
                                const int* moment, void* stream) {
  if (n <= 0) return 0;
  if ((cm == nullptr) != (ocv == nullptr)) return -1;
  const Chain c = make_chain(sites, xmax, site_eps);
  const AdamScalars sc{t, c1, c2, eps, wd, b1, ob1, b2, ob2};
  fused_qadam_prng_kernel<<<grid_for((n + 3) / 4), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, g, m, v, cm, cv, ox, om, ov, ocm, ocv, n, sc, k0, k1, c,
      make_moment(moment), make_moment(moment + 16));
  return static_cast<int>(cudaGetLastError());
}
