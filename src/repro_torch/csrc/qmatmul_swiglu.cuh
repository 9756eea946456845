// The fused GLU-FFN prefix of K4' and K4 (qmatmul_swiglu_sr.cu describes
// the kernels), templated on the activation (rt::GluAct): h = round_act(
// act(round(x @ wg)) * round(x @ wu)).  Each activation's library is its
// own source, so that the four build side by side: qmatmul_swiglu_sr.cu
// (silu), qmatmul_swiglu_gelu.cu, qmatmul_swiglu_relu.cu,
// qmatmul_swiglu_relu_sq.cu; each exports the same four entry points
// (QMATMUL_SWIGLU_ENTRIES below) for its activation.  The activation is
// the epilogue's template parameter on both routes, so an instance holds
// only its own activation's code, and the silu instances compile as before
// the others existed.  The epilogue is also templated on its rounding
// sites: the first instances (rt::RoundParams: rn, sr, sr_eps on plain FP
// grids; K4 has these alone) and K4''s wide instance (rt::WideParams,
// qmatmul_swiglu_sr_wide / _decode: every scheme x grid pair, the gate and
// up sites saturating as the reference's, the act site overflowing as its
// spec says).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_routes.cuh"
#include "rounding.cuh"

namespace {

struct Bits {           // K4's operands (on = 1); K4' draws (on = 0)
  int on;
  const uint32_t* g;
  const uint32_t* u;
  const uint32_t* act;
};

struct Seeds {          // K4''s word pairs
  uint32_t g0, g1, u0, u1, a0, a1;
};

// K4''s six seed words (null: K4, which reads bits operands).
inline Seeds seeds_of(const uint32_t* seeds) {
  return seeds != nullptr ? Seeds{seeds[0], seeds[1], seeds[2], seeds[3],
                                  seeds[4], seeds[5]}
                          : Seeds{0, 0, 0, 0, 0, 0};
}

// Store four grid values at elements i0 .. i0 + 3 of a tensor stored as
// `f`, or its first n of them (n < 4: the columns at or past N).  vec: the
// four elements start a 16-byte (float32), 4-byte (uint8 codes) or 8-byte
// (uint16 codes) aligned word, stored at once.
__device__ __forceinline__ void store_code4(void* p, size_t i0,
                                            const float (&y)[4],
                                            const rt::CodeFormat& f, int n,
                                            bool vec) {
  if (vec && n >= 4) {
    if (f.bytes == 0) {
      *reinterpret_cast<float4*>(static_cast<float*>(p) + i0) =
          make_float4(y[0], y[1], y[2], y[3]);
      return;
    }
    uint32_t c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = rt::pack_code(y[j], f.pack, f.xmax, f.xmin);
    if (f.bytes == 1) {
      *reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(p) + i0) =
          (c[0] & 0xFFu) | ((c[1] & 0xFFu) << 8) | ((c[2] & 0xFFu) << 16) |
          ((c[3] & 0xFFu) << 24);
    } else {
      *reinterpret_cast<uint2*>(static_cast<uint16_t*>(p) + i0) =
          make_uint2((c[0] & 0xFFFFu) | ((c[1] & 0xFFFFu) << 16),
                     (c[2] & 0xFFFFu) | ((c[3] & 0xFFFFu) << 16));
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) rt::store_code(p, i0 + j, y[j], f);
}

// P: the rounding sites, rt::RoundParams (the first instances) or
// rt::WideParams (the wide instances, K4' only).
template <int kAct, typename P = rt::RoundParams>
struct GluEpilogue {
  Bits bits;
  Seeds sd;
  void* out;
  rt::CodeFormat of;
  void* g_out;          // nullptr: no residuals
  void* u_out;
  rt::CodeFormat rf;
  int N;
  bool vec;             // four-column stores (N % 4 == 0, aligned outputs)
  P fwd;
  P act;

  // h, g_r, u_r of the large-M route's outputs (r, c0 .. c0 + 3)
  __device__ __forceinline__ void four(int r, int c0,
                                       const float (&v)[2][4]) const {
    const rt::RoundParams& fs = rt::site_of(fwd);
    const rt::RoundParams& as = rt::site_of(act);
    uint32_t bg[4], bu[4], ba[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bg[j] = bu[j] = ba[j] = 0u;
    const size_t row = static_cast<size_t>(r) * N;
    const int n = min(4, N - c0);
    if (rt::draws(fs.mode)) {
      if (bits.on) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n) {
            bg[j] = bits.g[row + c0 + j];
            bu[j] = bits.u[row + c0 + j];
          }
      } else {
        rt::element_bits4(sd.g0, sd.g1, 0u, fs.rand_bits, r, c0, bg);
        rt::element_bits4(sd.u0, sd.u1, 0u, fs.rand_bits, r, c0, bu);
      }
    }
    if (as.enabled && rt::draws(as.mode)) {
      if (bits.on) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n) ba[j] = bits.act[row + c0 + j];
      } else {
        rt::element_bits4(sd.a0, sd.a1, 1u, as.rand_bits, r, c0, ba);
      }
    }
    float g[4], u[4], h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      g[j] = rt::round_at(v[0][j], bg[j], fwd);
      u[j] = rt::round_at(v[1][j], bu[j], fwd);
      h[j] = rt::glu_hidden<kAct>(g[j], u[j]);
      if (as.enabled) h[j] = rt::round_at(h[j], ba[j], act);
    }
    store_code4(out, row + c0, h, of, n, vec);
    if (g_out != nullptr) {   // residuals for the backward pass
      store_code4(g_out, row + c0, g, rf, n, vec);
      store_code4(u_out, row + c0, u, rf, n, vec);
    }
  }

  // the decode route's output (r, c)
  __device__ __forceinline__ void one(int r, int c,
                                      const float (&v)[2]) const {
    const rt::RoundParams& fs = rt::site_of(fwd);
    const rt::RoundParams& as = rt::site_of(act);
    const size_t idx = static_cast<size_t>(r) * N + c;
    uint32_t bg = 0u, bu = 0u;
    if (rt::draws(fs.mode)) {
      if (bits.on) {
        bg = bits.g[idx];
        bu = bits.u[idx];
      } else {
        bg = rt::element_bits(sd.g0, sd.g1, 0u, fs.rand_bits, r, c);
        bu = rt::element_bits(sd.u0, sd.u1, 0u, fs.rand_bits, r, c);
      }
    }
    const float g_r = rt::round_at(v[0], bg, fwd);
    const float u_r = rt::round_at(v[1], bu, fwd);
    float h = rt::glu_hidden<kAct>(g_r, u_r);
    if (as.enabled) {
      uint32_t ba = 0u;
      if (rt::draws(as.mode))
        ba = bits.on ? bits.act[idx]
                     : rt::element_bits(sd.a0, sd.a1, 1u, as.rand_bits, r,
                                        c);
      h = rt::round_at(h, ba, act);
    }
    rt::store_code(out, idx, h, of);
    if (g_out != nullptr) {
      rt::store_code(g_out, idx, g_r, rf);
      rt::store_code(u_out, idx, u_r, rf);
    }
  }
};

// Tiles of the large-M route: 64 rows x 64 columns of each branch (256
// threads, three blocks per SM, 3 stages) where the grid fills the resident
// blocks of a wave, else 32 x 64 (128 threads, 6 stages).  The decode
// route's ring: 4 stages of 64 rows.  Each chosen by measurement among
// variants (launch/k3_variants.py --kernel k4, PERF.md): 3 stages and three
// blocks per SM against 4 and two, 1.55 against 1.78 ms at 1024 x 2048 x
// 5632; the small tiles at M = 128, 283 against 306 us; 4 stages against 8,
// 43.6 against 48.9 us at 4 x 2048 x 5632.
constexpr int kBigRG = 1, kBigMinBlocks = 3;
constexpr int kBigStages = 3, kSmallStages = 6;
constexpr int kDecStages = 4;

template <typename SB, typename Epi>
int route(const float* x, bool a_vec, bool vec, const void* wg,
          const void* wu, int M, int N, int K, const Epi& ep,
          cudaStream_t s, bool decode) {
  using Big = gemm::Tile<16, kBigRG, 1, kBigStages, SB, 2, kBigMinBlocks>;
  using Small = gemm::Tile<8, 1, 1, kSmallStages, SB, 2, 1>;
  const gemm::Weights<SB, 2> w{{static_cast<const SB*>(wg),
                                static_cast<const SB*>(wu)}};
  const rt::CodeFormat af = rt::code_format(nullptr);   // x is float32
  if (decode)
    return vec ? gemm::launch_decode<kDecStages, true>(x, af, a_vec, w, M, N,
                                                       K, ep, s)
               : gemm::launch_decode<kDecStages, false>(x, af, a_vec, w, M,
                                                        N, K, ep, s);
  if (!vec) return gemm::launch_gemm<Small, false>(x, af, w, M, N, K, ep, s);
  if (gemm::tiles_of(M, N, Big::BM, Big::BN) >=
      kBigMinBlocks * gemm::kWaveTiles)
    return gemm::launch_gemm<Big, true>(x, af, w, M, N, K, ep, s);
  return gemm::launch_gemm<Small, true>(x, af, w, M, N, K, ep, s);
}

template <int kAct, typename P>
int run(const float* x, const void* wg, const void* wu, int w_is_bf16,
        const Bits& bits, const Seeds& sd, void* out, const int* out_fmt,
        void* g_out, void* u_out, const int* res_fmt, int M, int N, int K,
        const P& fwd, const P& act, void* stream, bool decode) {
  if (M <= 0 || N <= 0) return 0;
  const bool out_vec = N % 4 == 0 && gemm::aligned16(out) &&
                       (g_out == nullptr ||
                        (gemm::aligned16(g_out) && gemm::aligned16(u_out)));
  const GluEpilogue<kAct, P> ep{bits,  sd,  out, rt::code_format(out_fmt),
                                g_out, u_out, rt::code_format(res_fmt),
                                N,     out_vec, fwd, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // vector loads: wg and wu rows of whole 16-byte chunks from 16-byte
  // aligned bases; x 16-byte aligned with K % 4 == 0 (the decode route
  // loads x element by element otherwise, the large-M route takes its
  // element-load instance)
  const bool a_vec = gemm::aligned16(x) && K % 4 == 0;
  const bool vec = gemm::aligned16(wg) && gemm::aligned16(wu) &&
                   N % (w_is_bf16 ? 8 : 4) == 0 && (decode || a_vec);
  if (w_is_bf16)
    return route<gemm::Bf16Bits>(x, a_vec, vec, wg, wu, M, N, K, ep, s,
                                 decode);
  return route<float>(x, a_vec, vec, wg, wu, M, N, K, ep, s, decode);
}

// One entry point's work: K4' (bits.on = 0, the seed words) or K4 (the bits
// operands) on either route, under the library's activation, on the first
// instances.  fwd_site: int[6] {precision, emin, emax, mode, rand_bits,
// eps bits}; act_site: int[7] {enabled, precision, emin, emax, mode,
// rand_bits, eps bits}.
template <int kAct>
int entry(const float* x, const void* wg, const void* wu,
          int w_is_bf16, const Bits& bits, const uint32_t* seeds, void* out,
          const int* out_fmt, void* g_out, void* u_out, const int* res_fmt,
          int M, int N, int K, const int* fwd_site, float xmax,
          const int* act_site, float act_xmax, void* stream, bool decode) {
  const rt::RoundParams fwd{fwd_site[0], fwd_site[1], fwd_site[2], xmax,
                            fwd_site[3], fwd_site[4], 1,
                            rt::float_of_bits(fwd_site[5])};
  const rt::RoundParams act{act_site[1], act_site[2], act_site[3], act_xmax,
                            act_site[4], act_site[5], act_site[0],
                            rt::float_of_bits(act_site[6])};
  return run<kAct>(x, wg, wu, w_is_bf16, bits, seeds_of(seeds), out,
                   out_fmt, g_out, u_out, res_fmt, M, N, K, fwd, act, stream,
                   decode);
}

// K4''s wide instance: fwd and act sites as rows (rt::wide_params): int[8]
// each and float[4] {xmax, eps, scale, mu} each (act's enabled in its slot
// 0; the fwd site saturates, as the reference's does, the act site
// overflows as its spec says).
template <int kAct>
int entry_wide(const float* x, const void* wg, const void* wu,
               int w_is_bf16, const uint32_t* seeds, void* out,
               const int* out_fmt, void* g_out, void* u_out,
               const int* res_fmt, int M, int N, int K, const int* fwd_site,
               const float* fwd_f, const int* act_site, const float* act_f,
               void* stream, bool decode) {
  return run<kAct>(x, wg, wu, w_is_bf16, Bits{0, nullptr, nullptr, nullptr},
                   seeds_of(seeds), out, out_fmt, g_out, u_out, res_fmt, M,
                   N, K, rt::wide_params(fwd_site, fwd_f[0], fwd_f[1],
                                         fwd_f + 2),
                   rt::wide_params(act_site, act_f[0], act_f[1], act_f + 2),
                   stream, decode);
}

}  // namespace

// The six entry points of one activation's library.
//
// K4' (qmatmul_swiglu_sr, large-M route; qmatmul_swiglu_sr_decode, decode
// route).  seeds: {gate k0, gate k1, up k0, up k1, act k0, act k1};
// fwd_site: int[6] {precision, emin, emax, mode, rand_bits, eps bits};
// act_site: int[7] {enabled, precision, emin, emax, mode, rand_bits, eps
// bits}; out_fmt / res_fmt: int[7] storage (null: float32); g_out/u_out:
// nullptr, or (M, N) outputs for the rounded branches.  Launch on
// `stream`; returns cudaGetLastError() (0 on success).
//
// K4 (qmatmul_swiglu_bits, qmatmul_swiglu_bits_decode): the same with
// bits_g, bits_u: (M, N) uint32 on the device (read only under a
// stochastic scheme) and act_bits: (M, N) uint32, read only when the act
// site is stochastic, in place of the seeds.
//
// K4''s wide instance (qmatmul_swiglu_sr_wide, qmatmul_swiglu_sr_wide_
// decode): K4''s arguments with each site as a wide row, int[8] {enabled,
// precision, emin, emax, mode, rand_bits, 0, flags} and float[4] {xmax,
// eps, scale, mu} (entry_wide).
#define QMATMUL_SWIGLU_ENTRY_SR(NAME, ACT, DECODE)                           \
  extern "C" int NAME(const float* x, const void* wg, const void* wu,       \
                      int w_is_bf16, const uint32_t* seeds, void* out,      \
                      const int* out_fmt, void* g_out, void* u_out,         \
                      const int* res_fmt, int M, int N, int K,              \
                      const int* fwd_site, float xmax, const int* act_site, \
                      float act_xmax, void* stream) {                       \
    return entry<ACT>(x, wg, wu, w_is_bf16,                                 \
                      Bits{0, nullptr, nullptr, nullptr}, seeds, out,       \
                      out_fmt, g_out, u_out, res_fmt, M, N, K, fwd_site,    \
                      xmax, act_site, act_xmax, stream, DECODE);            \
  }
#define QMATMUL_SWIGLU_ENTRY_BITS(NAME, ACT, DECODE)                         \
  extern "C" int NAME(const float* x, const void* wg, const void* wu,       \
                      int w_is_bf16, const uint32_t* bits_g,                \
                      const uint32_t* bits_u, const uint32_t* act_bits,     \
                      void* out, const int* out_fmt, void* g_out,           \
                      void* u_out, const int* res_fmt, int M, int N, int K, \
                      const int* fwd_site, float xmax, const int* act_site, \
                      float act_xmax, void* stream) {                       \
    return entry<ACT>(x, wg, wu, w_is_bf16,                                 \
                      Bits{1, bits_g, bits_u, act_bits}, nullptr, out,      \
                      out_fmt, g_out, u_out, res_fmt, M, N, K, fwd_site,    \
                      xmax, act_site, act_xmax, stream, DECODE);            \
  }
#define QMATMUL_SWIGLU_ENTRY_WIDE(NAME, ACT, DECODE)                         \
  extern "C" int NAME(const float* x, const void* wg, const void* wu,       \
                      int w_is_bf16, const uint32_t* seeds, void* out,      \
                      const int* out_fmt, void* g_out, void* u_out,         \
                      const int* res_fmt, int M, int N, int K,              \
                      const int* fwd_site, const float* fwd_f,              \
                      const int* act_site, const float* act_f,              \
                      void* stream) {                                       \
    return entry_wide<ACT>(x, wg, wu, w_is_bf16, seeds, out, out_fmt,       \
                           g_out, u_out, res_fmt, M, N, K, fwd_site, fwd_f, \
                           act_site, act_f, stream, DECODE);                \
  }
#define QMATMUL_SWIGLU_ENTRIES(ACT)                                 \
  QMATMUL_SWIGLU_ENTRY_SR(qmatmul_swiglu_sr, ACT, false)            \
  QMATMUL_SWIGLU_ENTRY_BITS(qmatmul_swiglu_bits, ACT, false)        \
  QMATMUL_SWIGLU_ENTRY_SR(qmatmul_swiglu_sr_decode, ACT, true)      \
  QMATMUL_SWIGLU_ENTRY_BITS(qmatmul_swiglu_bits_decode, ACT, true)  \
  QMATMUL_SWIGLU_ENTRY_WIDE(qmatmul_swiglu_sr_wide, ACT, false)     \
  QMATMUL_SWIGLU_ENTRY_WIDE(qmatmul_swiglu_sr_wide_decode, ACT, true)
