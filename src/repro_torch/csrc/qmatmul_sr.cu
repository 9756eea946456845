// qmatmul_sr / qmatmul_bits: float32 GEMM whose result is rounded onto a
// low-precision grid (the paper's eq. 8a at a GEMM site).
//
// Two flavours share every kernel body, so they run one main loop and sum
// in one order:
//   qmatmul_sr   -- K3', replaces repro/kernels/qmatmul.py:qmatmul_prng_p
//     (body _qmm2d): the rounding bits of out[r, c] are drawn in-kernel
//     from Threefry keyed by the global (r, c) (rounding.cuh:element_bits);
//   qmatmul_bits -- K3, replaces qmatmul.py:qmatmul_p (the explicit-bits
//     "oracle" flavour): out[r, c] takes word (r, c) of an (M, N) uint32
//     bits operand (with rand_bits < 32 its low bits).
// out[r, c] = round(sum_k a[r, k] * b[k, c]).  Fed the words the in-kernel
// draw would make (counter_bits_reduced), K3 equals K3' bit for bit.  Both
// equal the plain twins repro_torch.kernels.qmatmul.qmatmul_plain /
// qmatmul_bits_plain bit for bit on exact sums.
//
// Two routes, chosen by the wrapper by M (kernels/qmatmul.py:
// DECODE_MAX_M = 16, from the routes' device times at M = 4, 8, 16 and 128,
// PERF.md), each with a K3' and a K3 entry point.  Both sum in the first
// version's order: one accumulator per output, one fmaf(a[r, k], b[k, c],
// acc) per k in ascending k from +0, over K rounded up to 16 with zeros
// past K (fmaf(0, 0, -0) is +0: the padding turns a -0 sum into +0, as
// the first version's 16-deep stages did).  So the two routes, and that
// kernel, are bitwise equal on every input, and a row's result depends on
// its A row, B and K alone: never on M, the tile or the co-batched rows.
//
// * Large-M route (qmatmul_sr, qmatmul_bits; prompt absorption, the train
//   step's forward, dgrad and wgrad), bound by the fp32 operations at
//   every train shape (2 M N K flops over 67 TFLOP/s).  Hopper SIMT tiling
//   on the fp32 pipe: 256 threads over 128x64 tiles of 8x4 outputs per
//   thread (two resident blocks per SM), or 64x64 (256 threads) and 32x64
//   (128 threads) tiles of 4x4 where the grid would leave most of the 132
//   SMs idle; a ring of 32-deep shared-memory stages (3 for 128x64, 6 and
//   8 for the small tiles) filled by 16-byte cp.async where the operands
//   are aligned, so the next stages' loads fly while a stage's FMAs run;
//   float4 fragment reads of A (rows of 32 k at a stride of 36 floats:
//   conflict-free), bf16 B kept raw in shared memory and widened at
//   fragment load.  Tensor cores are not used: A and the dgrad's gradient
//   are float32 values that TF32 or bf16 operands would round, and a
//   split-operand (3xTF32) route would leave the accumulation order to
//   the hardware.
//
// * Decode route (qmatmul_sr_decode, qmatmul_bits_decode; M up to the
//   threshold: decode steps, the engine's prefill chunks).  At M = 4 the
//   work is a weight stream of 2 flops per bf16 weight, bound by bytes;
//   the first version's 64x64 tiles had 60 of 64 rows of padding, 4 to 32
//   blocks and a K loop serial in latency.  Here every lane owns one
//   output and its whole chain (a warp: 8 columns x 4 rows, the 4 row
//   lanes of a column reading its B value by broadcast), so the chains of
//   all M N outputs run side by side; a block of 4 warps streams its 32
//   columns of B (64 bytes of each bf16 row) and its A rows through a
//   ring of 8 stages of 64 rows filled by 16-byte cp.async, and loads
//   each 32 rows' operands into registers ahead of their dependent FMAs.
//   An output's floor is its K dependent FMAs (4 cycles each); the route
//   runs at about 25 cycles per k (PERF.md), the cause not yet found.  A
//   split-K version (chains of 32 rows, groups of 8 left-folded, the
//   groups' sums folded by the last block of a column tile) ran 3x faster
//   at decode, but summed in another order than this one, and at one of
//   the GEMM contract's seeded checks it rounded one output of 8192 the
//   other way from the plain twin's cuBLAS sum (PERF.md), so it is not
//   kept.
//
// Epilogue (both routes): draw rt::element_bits(k0, k1, 0, rand_bits, r, c)
// (K3') or read bits[r N + c] (K3), then round and rt::store_code.  Bits are
// keyed by the global (r, c), so neither the tiling nor the route changes
// them.  The epilogue is templated on its rounding site: the first
// instances round with rt::round_value (rn, sr and sr_eps on plain FP grids
// with subnormals; K3 has these alone), K3''s wide instance (entry points
// qmatmul_sr_wide, qmatmul_sr_wide_decode) with rt::round_value_wide: every
// scheme x grid pair of the reference's round_block (rz, ra, rd, ru, SR 2.0,
// the bit trick, fixed-point and shifted grids, formats without
// subnormals), saturating as the reference's GEMMs do.  Both run the same
// main loops, so a wide instance differs only in its epilogue's cost: one
// output per K FMAs (PERF.md).
//
// The two routes' main loops live in gemm_routes.cuh (shared with K4' and
// K4, which run them over two weight operands); this file keeps K3''s
// epilogue, its tiles and its entry points.
//
// Storage (the reference's shared epilogue, qmatmul.py:_emit_value): A may
// be float32 or the code words of a grid (a_fmt), decoded as staged; the
// output may be float32 or the rounded values packed as code words of the
// GEMM's grid (out_packed, rounding.cuh:pack_code).  The wrappers pass each
// storage as an int[7] (rounding.cuh:code_format).  Operands need no
// alignment: where a pointer or a row length does not allow vector loads,
// an instance with element loads runs (kVec = false).
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_routes.cuh"
#include "rounding.cuh"

namespace {

// P: the rounding site, rt::RoundParams (the first instances) or
// rt::WideParams (the wide instances).
template <typename P>
struct Epilogue {
  const uint32_t* bits;   // K3's words; nullptr: draw in-kernel (K3')
  void* out;
  rt::CodeFormat of;
  int M, N;
  uint32_t k0, k1;
  P fwd;

  // the large-M route's outputs (r, c0 .. c0 + 3)
  __device__ __forceinline__ void four(int r, int c0,
                                       const float (&v)[1][4]) const;
  // the decode route's output (r, c)
  __device__ __forceinline__ void one(int r, int c,
                                      const float (&v)[1]) const;
};

// The rounding words of out[r, c0 .. c0 + 3] (c0 % 4 == 0): drawn (K3')
// or read (K3); zero for a deterministic scheme.
template <typename P>
__device__ __forceinline__ void bits4(const Epilogue<P>& e, int r, int c0,
                                      uint32_t (&w)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = 0u;
  const rt::RoundParams& site = rt::site_of(e.fwd);
  if (!rt::draws(site.mode)) return;
  if (e.bits == nullptr) {
    rt::element_bits4(e.k0, e.k1, 0u, site.rand_bits, r, c0, w);
  } else {
    const size_t row = static_cast<size_t>(r) * e.N;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < e.N) w[j] = e.bits[row + c0 + j];
  }
}

// Round four sums with their words and store out[r, c0 .. c0 + 3];
// columns at or past N are dropped.
template <typename P>
__device__ __forceinline__ void round_store4(const Epilogue<P>& e, int r,
                                             int c0, const float (&v)[4],
                                             const uint32_t (&w)[4]) {
  const size_t row = static_cast<size_t>(r) * e.N;
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = rt::round_at(v[j], w[j], e.fwd);
  if (e.of.bytes == 0 && (e.N & 3) == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(e.out) + row + c0) =
        make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < e.N) rt::store_code(e.out, row + c0 + j, y[j], e.of);
  }
}

template <typename P>
__device__ __forceinline__ void Epilogue<P>::four(
    int r, int c0, const float (&v)[1][4]) const {
  uint32_t w[4];
  bits4(*this, r, c0, w);
  round_store4(*this, r, c0, v[0], w);
}

template <typename P>
__device__ __forceinline__ void Epilogue<P>::one(int r, int c,
                                                 const float (&v)[1]) const {
  const size_t idx = static_cast<size_t>(r) * N + c;
  const rt::RoundParams& site = rt::site_of(fwd);
  uint32_t w = 0u;
  if (rt::draws(site.mode))
    w = bits != nullptr ? bits[idx]
                        : rt::element_bits(k0, k1, 0u, site.rand_bits, r, c);
  rt::store_code(out, idx, rt::round_at(v[0], w, fwd), of);
}

// ---------------------------------------------------------------------------
// Tiles of the large-M route (gemm_routes.cuh: gemm_kernel): 128x64 tiles
// of 8x4 outputs per thread where the grid fills the card (two blocks per
// SM; 128x128 tiles measured slower, PERF.md), 64x64 (256 threads) and
// 32x64 (128 threads) tiles of 4x4 where it would not; the ring deeper for
// the small tiles, whose stages compute briefly.
// ---------------------------------------------------------------------------
constexpr int kBigRG = 2, kBigCG = 1;
constexpr int kBigStages = 3, kBigMinBlocks = 2;
constexpr int kMidStages = 6, kSmallStages = 8;

// The largest tile whose grid holds about a wave of blocks; element loads
// (32x64 tiles) where the operands allow no vectors.
template <typename SB, typename Epi>
int route_gemm(const void* a, const rt::CodeFormat& af, bool vec,
               const gemm::Weights<SB, 1>& b, int K, const Epi& ep,
               cudaStream_t s) {
  using Big = gemm::Tile<16, kBigRG, kBigCG, kBigStages, SB, 1,
                         kBigMinBlocks>;
  using Mid = gemm::Tile<16, 1, 1, kMidStages, SB, 1, 1>;
  using Small = gemm::Tile<8, 1, 1, kSmallStages, SB, 1, 1>;
  const int M = ep.M, N = ep.N;
  if (!vec) return gemm::launch_gemm<Small, false>(a, af, b, M, N, K, ep, s);
  if (gemm::tiles_of(M, N, Big::BM, Big::BN) >= gemm::kWaveTiles)
    return gemm::launch_gemm<Big, true>(a, af, b, M, N, K, ep, s);
  if (gemm::tiles_of(M, N, Mid::BM, Mid::BN) >= gemm::kWaveTiles)
    return gemm::launch_gemm<Mid, true>(a, af, b, M, N, K, ep, s);
  return gemm::launch_gemm<Small, true>(a, af, b, M, N, K, ep, s);
}

// The decode route's ring: 8 stages of 64 rows (8 and 12 measured the
// same, PERF.md).
constexpr int kDecStages = 8;

template <typename SB, typename Epi>
int route(const void* a, const rt::CodeFormat& af, bool a_vec, bool vec,
          const void* b, int K, const Epi& ep, cudaStream_t s,
          bool decode) {
  const gemm::Weights<SB, 1> w{{static_cast<const SB*>(b)}};
  if (!decode) return route_gemm<SB>(a, af, vec, w, K, ep, s);
  return vec ? gemm::launch_decode<kDecStages, true>(a, af, a_vec, w, ep.M,
                                                     ep.N, K, ep, s)
             : gemm::launch_decode<kDecStages, false>(a, af, a_vec, w, ep.M,
                                                      ep.N, K, ep, s);
}

template <typename P>
int run(const void* a, const int* a_fmt, const void* b, int b_is_bf16,
        const uint32_t* bits, void* out, const int* out_fmt, int M, int N,
        int K, uint32_t k0, uint32_t k1, const P& fwd, void* stream,
        bool decode) {
  if (M <= 0 || N <= 0) return 0;
  const rt::CodeFormat af = rt::code_format(a_fmt);
  const Epilogue<P> ep{bits, out, rt::code_format(out_fmt), M, N, k0, k1,
                       fwd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // vector loads: B rows of whole 16-byte chunks from a 16-byte aligned
  // base; a float32 A 16-byte aligned with K % 4 == 0 (in the large-M
  // route the vector instance takes code words of A element by element)
  const bool a_vec = af.bytes == 0 && gemm::aligned16(a) && K % 4 == 0;
  const bool vec = gemm::aligned16(b) && N % (b_is_bf16 ? 8 : 4) == 0 &&
                   (decode || af.bytes != 0 || a_vec);
  if (b_is_bf16)
    return route<gemm::Bf16Bits>(a, af, a_vec, vec, b, K, ep, s, decode);
  return route<float>(a, af, a_vec, vec, b, K, ep, s, decode);
}

// The first instances' site: rn, sr or sr_eps on a plain FP grid.
rt::RoundParams fp_site(int precision, int emin, int emax, float xmax,
                        int mode, int rand_bits, float eps) {
  return rt::RoundParams{precision, emin, emax, xmax, mode, rand_bits, 1,
                         eps};
}

}  // namespace

// K3', large-M route.  a: (M, K) float32, or codes per a_fmt (int[7],
// null: float32); out: (M, N) float32, or codes of the GEMM's grid per
// out_fmt.  Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int qmatmul_sr(const void* a, const int* a_fmt, const void* b,
                          int b_is_bf16, void* out, const int* out_fmt,
                          int M, int N, int K, uint32_t k0, uint32_t k1,
                          int precision, int emin, int emax, float xmax,
                          int mode, int rand_bits, float eps, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, nullptr, out, out_fmt, M, N, K, k0, k1,
             fp_site(precision, emin, emax, xmax, mode, rand_bits, eps),
             stream, false);
}

// K3, large-M route.  bits: (M, N) uint32 words on the device (read only
// under a stochastic scheme).
extern "C" int qmatmul_bits(const void* a, const int* a_fmt, const void* b,
                            int b_is_bf16, const uint32_t* bits, void* out,
                            const int* out_fmt, int M, int N, int K,
                            int precision, int emin, int emax, float xmax,
                            int mode, int rand_bits, float eps,
                            void* stream) {
  return run(a, a_fmt, b, b_is_bf16, bits, out, out_fmt, M, N, K, 0u, 0u,
             fp_site(precision, emin, emax, xmax, mode, rand_bits, eps),
             stream, false);
}

// K3', decode route: qmatmul_sr's arguments and result.
extern "C" int qmatmul_sr_decode(const void* a, const int* a_fmt,
                                 const void* b, int b_is_bf16, void* out,
                                 const int* out_fmt, int M, int N, int K,
                                 uint32_t k0, uint32_t k1, int precision,
                                 int emin, int emax, float xmax, int mode,
                                 int rand_bits, float eps, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, nullptr, out, out_fmt, M, N, K, k0, k1,
             fp_site(precision, emin, emax, xmax, mode, rand_bits, eps),
             stream, true);
}

// K3, decode route: qmatmul_bits' arguments and result.
extern "C" int qmatmul_bits_decode(const void* a, const int* a_fmt,
                                   const void* b, int b_is_bf16,
                                   const uint32_t* bits, void* out,
                                   const int* out_fmt, int M, int N, int K,
                                   int precision, int emin, int emax,
                                   float xmax, int mode, int rand_bits,
                                   float eps, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, bits, out, out_fmt, M, N, K, 0u, 0u,
             fp_site(precision, emin, emax, xmax, mode, rand_bits, eps),
             stream, true);
}

// K3''s wide instance (every scheme x grid pair of the reference's
// round_block, saturating: the reference's GEMMs pass no overflow), large-M
// route.  site: int[8] {1, precision, emin, emax, mode, rand_bits, 0,
// flags} and fsite: float[4] {xmax, eps, scale, mu} (rt::wide_params);
// other arguments as qmatmul_sr's.
extern "C" int qmatmul_sr_wide(const void* a, const int* a_fmt,
                               const void* b, int b_is_bf16, void* out,
                               const int* out_fmt, int M, int N, int K,
                               uint32_t k0, uint32_t k1, const int* site,
                               const float* fsite, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, nullptr, out, out_fmt, M, N, K, k0, k1,
             rt::wide_params(site, fsite[0], fsite[1], fsite + 2), stream,
             false);
}

// K3''s wide instance, decode route: qmatmul_sr_wide's arguments.
extern "C" int qmatmul_sr_wide_decode(const void* a, const int* a_fmt,
                                      const void* b, int b_is_bf16,
                                      void* out, const int* out_fmt, int M,
                                      int N, int K, uint32_t k0, uint32_t k1,
                                      const int* site, const float* fsite,
                                      void* stream) {
  return run(a, a_fmt, b, b_is_bf16, nullptr, out, out_fmt, M, N, K, k0, k1,
             rt::wide_params(site, fsite[0], fsite[1], fsite + 2), stream,
             true);
}
