// qmatmul_batched_sr / qmatmul_batched_bits: a batch of float32 GEMMs
// whose results are rounded onto a low-precision grid (the paper's eq. 8a
// at a batched GEMM site: the MoE layer's stacked expert GEMMs).
//
// Two flavours share every kernel body (one main loop, one summation
// order):
//   qmatmul_batched_sr   -- K8', replaces repro/kernels/qmatmul.py:
//     qmatmul_batched_prng_p (body _qmmb): the rounding bits are drawn
//     in-kernel from Threefry keyed by slice e's own seed words seeds[e]
//     and the within-slice (r, c), stream 0 (rounding.cuh:element_bits),
//     so every slice owns an independent stream;
//   qmatmul_batched_bits -- K8, replaces qmatmul.py:qmatmul_batched_p: the
//     words come from an (E, M, N) uint32 operand, one plane per slice
//     (the reference's oracle draws each plane as counter_bits_reduced of
//     the slice's words, which makes K8 equal K8' bit for bit).
// out[e, r, c] = round(sum_k a[e, r, k] * b[e, k, c]); the output does
// not depend on the tiling or the route and equals the plain twins
// repro_torch.kernels.qmatmul.qmatmul_batched_plain /
// qmatmul_batched_bits_plain bit for bit on exact sums.  As in K3, A may be
// float32 or code words (a_fmt, decoded as it is staged) and the output
// float32 or code words of the GEMM's grid (out_packed), element by
// element; B float32 or bfloat16 (stored bf16 expert weights are widened
// in registers, which is exact, so no float32 copy of the experts is made).
//
// Order: every output is one chain, one fmaf(a[r, k], b[k, c], acc) per k
// in ascending k from +0, over exactly K steps: the first version's order,
// so both routes, and that version, are bitwise equal on every input.  The
// routes run their chains over K rounded up to their stage depth with A
// padded by -0 (fmaf(-0, +0, acc) is acc for every acc, -0 included): a
// sum that underflows to -0 keeps its sign for every K.
//
// Two routes, chosen by the wrapper by M (kernels/qmatmul.py:
// BATCHED_STREAM_MAX_M, from the routes' device times, PERF.md):
//
// * Weight-stream route (qmatmul_batched_sr_stream, qmatmul_batched_bits_
//   stream; M up to 96: every MoE decode call, M = 1, and a whole-prompt
//   forward's capacity, M = 10 at batch 4 x prompt 32).  At M = 1 bound by
//   bytes: each expert's weights are read once for 2 flops per weight (E K N
//   bf16 weights: 402.7 MB at the qwen3-moe path's shapes, 0.120 ms at 3.35
//   TB/s).  A block of kSWarps warps per (expert, kSBN columns, row tile);
//   each thread owns kSCols adjacent columns and keeps one accumulator per
//   (row, column) for all the tile's rows, so the weights are read once per
//   tile: M's rows in the fewest tiles of at most 16, an instance for each
//   even row count (and 1), the least that holds a tile.  The expert's
//   weights stream through a ring of kSStages stages of kSK k rows filled by
//   16-byte cp.async (512-byte row pieces of bf16 weights per block), A's
//   rows of the same k rows beside them; per 4 k rows a thread widens its
//   columns' 8 weights, then reads each row's 4 A values (one broadcast
//   float4) and runs their FMAs.  The block's shape is measured
//   (launch/k3_variants.py --kernel k8): fewer warps, more columns or fewer
//   rows per thread, deeper rings and shorter or longer stages were slower
//   at M = 10 and no faster at M = 1 (PERF.md).  With rows the FMAs and
//   shared loads of each k step take more of the time than the stream leaves
//   them: 0.139, 0.164 and 0.244 ms at M = 1, 10 and 16 (2048 -> 768).
//
// * Large-M route (qmatmul_batched_sr, qmatmul_batched_bits; longer
//   prompts, MoE training later): gemm_routes.cuh's SIMT tiles
//   (gemm_batched_kernel: blockIdx.z is the slice), 32x64, 64x64 or 128x64
//   output tiles by M.
//
// Epilogue (both routes): slice e's seed words, then rt::element_bits(w0,
// w1, 0, rand_bits, r, c) (K8') or bits[e, r, c] (K8), rounding and
// rt::store_code.  The epilogue is templated on its rounding site: the
// first instances (rt::round_value: rn, sr, sr_eps on plain FP grids; K8
// has these alone) and K8''s wide instance (qmatmul_batched_sr_wide /
// _wide_stream: rt::round_value_wide, every scheme x grid pair, saturating;
// its weight-stream route compiles the 1- and 16-row instances alone).  Bits are keyed by the within-slice (r, c), so neither
// the tiling nor the route changes them.  Operands need no alignment:
// where a pointer or a row length allows no vector loads, an instance
// with element loads runs (kVec = false).
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "gemm_routes.cuh"
#include "rounding.cuh"

namespace {

// P: the rounding site, rt::RoundParams (the first instances) or
// rt::WideParams (the wide instances, K8' only).
template <typename P>
struct Epilogue {
  const uint32_t* seeds;   // K8': (E, 2) words on the device, else nullptr
  const uint32_t* bits;    // K8's (E, M, N) words; nullptr: draw (K8')
  void* out;
  rt::CodeFormat of;
  int M, N;
  uint32_t w0, w1;         // slice e's words (slice())
  P fwd;

  // this epilogue moved to slice e: its output and bits planes, its words
  __device__ __forceinline__ Epilogue slice(size_t e) const {
    Epilogue s = *this;
    const size_t off = e * M * N;
    s.out = static_cast<char*>(out) + off * (of.bytes != 0 ? of.bytes : 4);
    if (bits != nullptr) s.bits = bits + off;
    if (rt::draws(rt::site_of(fwd).mode) && bits == nullptr) {
      s.w0 = seeds[2 * e];
      s.w1 = seeds[2 * e + 1];
    }
    return s;
  }
  // the large-M route's outputs (r, c0 .. c0 + 3)
  __device__ __forceinline__ void four(int r, int c0,
                                       const float (&v)[1][4]) const;
  // the weight-stream route's outputs (r, c0), (r, c0 + 1); c0 even
  __device__ __forceinline__ void two(int r, int c0,
                                      const float (&v)[2]) const;
};

// element_bits at columns c0 and c0 + 1 of one row (c0 even), from one
// Threefry evaluation: both fields lie in one word pair at r = 32 and in
// one word at r = 16 and 8.
__device__ __forceinline__ void element_bits2(uint32_t k0, uint32_t k1,
                                              int rand_bits, uint32_t row,
                                              uint32_t c0,
                                              uint32_t (&out)[2]) {
  const uint32_t ratio = 32u / static_cast<uint32_t>(rand_bits);
  const uint32_t wc = c0 / ratio;
  uint32_t o0, o1;
  rt::threefry2x32(k0, k1, row, wc >> 1, o0, o1);
  if (rand_bits == 32) {
    out[0] = o0;
    out[1] = o1;
    return;
  }
  const uint32_t w = (wc & 1u) ? o1 : o0;
  const uint32_t f = c0 % ratio, mask = (1u << rand_bits) - 1u;
  out[0] = (w >> (f * rand_bits)) & mask;
  out[1] = (w >> ((f + 1u) * rand_bits)) & mask;
}

template <typename P>
__device__ __forceinline__ void Epilogue<P>::four(
    int r, int c0, const float (&v)[1][4]) const {
  const rt::RoundParams& site = rt::site_of(fwd);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const size_t row = static_cast<size_t>(r) * N;
  if (rt::draws(site.mode)) {
    if (bits == nullptr) {
      rt::element_bits4(w0, w1, 0u, site.rand_bits, r, c0, w);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < N) w[j] = bits[row + c0 + j];
    }
  }
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = rt::round_at(v[0][j], w[j], fwd);
  if (of.bytes == 0 && (N & 3) == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + row + c0) =
        make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < N) rt::store_code(out, row + c0 + j, y[j], of);
  }
}

template <typename P>
__device__ __forceinline__ void Epilogue<P>::two(int r, int c0,
                                                 const float (&v)[2]) const {
  const rt::RoundParams& site = rt::site_of(fwd);
  uint32_t w[2] = {0u, 0u};
  const size_t idx = static_cast<size_t>(r) * N + c0;
  const bool pair = c0 + 1 < N;
  if (rt::draws(site.mode)) {
    if (bits == nullptr) {
      element_bits2(w0, w1, site.rand_bits, r, c0, w);
    } else {
      w[0] = bits[idx];
      if (pair) w[1] = bits[idx + 1];
    }
  }
  const float y0 = rt::round_at(v[0], w[0], fwd);
  const float y1 = rt::round_at(v[1], w[1], fwd);
  if (of.bytes == 0 && (N & 1) == 0) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
        make_float2(y0, y1);
  } else {
    rt::store_code(out, idx, y0, of);
    if (pair) rt::store_code(out, idx + 1, y1, of);
  }
}

// ---------------------------------------------------------------------------
// Weight-stream route
// ---------------------------------------------------------------------------
// The block's shape, from launch/k3_variants.py --kernel k8 (PERF.md): 4
// warps of 2 columns a thread, stages of 32 k rows, a ring of 3.
constexpr int kSWarps = 4;                    // warps per block
constexpr int kSCols = 2;                     // columns per thread
constexpr int kSBN = 32 * kSWarps * kSCols;   // columns per block
constexpr int kSMaxRows = 16;                 // rows per block, at most
constexpr int kSK = 32;                       // k rows per stage
constexpr int kSStages = 3;                   // stages in the ring

template <typename SB, int TM>
struct Stream {
  static constexpr int kRows = TM;
  static constexpr int kThreads = 32 * kSWarps;
  static constexpr int kBBytes = kSK * kSBN * static_cast<int>(sizeof(SB));
  static constexpr int kABytes = TM * kSK * 4;
  static constexpr int kStageBytes = kBBytes + kABytes;
  static constexpr int kSmem = kSStages * kStageBytes;
  static_assert(TM <= kSMaxRows, "rows per block");
  static_assert(kSK % 4 == 0 && kSStages >= 2, "stages of 4-row steps");
  static_assert(kBBytes % 16 == 0 && kABytes % 16 == 0, "16-byte stages");
};

// Two adjacent B values from shared memory (4 or 8 bytes, aligned).
__device__ __forceinline__ void widen2(const float* p, float (&b)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  b[0] = v.x;
  b[1] = v.y;
}
__device__ __forceinline__ void widen2(const gemm::Bf16Bits* p,
                                       float (&b)[2]) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  b[0] = __uint_as_float(v << 16);
  b[1] = __uint_as_float(v & 0xFFFF0000u);
}

// One stage: B rows [k0, k0 + kSK) x the block's kSBN columns into a (kSK,
// kSBN) tile (zeros past N and K), then A's `rows` rows x k [k0, k0 + kSK)
// into a (TM, kSK) float tile (-0 past K).  kVec: 16-byte cp.async for B
// (and for a float32 A, 16-byte aligned with K % 4 == 0: a_vec), else
// element loads stored before the next barrier.
template <typename S, typename SB, bool kVec>
__device__ __forceinline__ void load_stream_stage(char* stage, const void* A,
                                                  const rt::CodeFormat& af,
                                                  bool a_vec, const SB* B,
                                                  int rows, int N, int K,
                                                  int n0, int k0) {
  SB* Bs = reinterpret_cast<SB*>(stage);
  float* As = reinterpret_cast<float*>(stage + S::kBBytes);
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(SB));
    constexpr int kRowChunks = kSBN / kPer, kChunks = kSK * kRowChunks;
#pragma unroll
    for (int i = 0; i < (kChunks + S::kThreads - 1) / S::kThreads; ++i) {
      const int e = tid + i * S::kThreads;
      if (kChunks % S::kThreads != 0 && e >= kChunks) break;
      const int kk = e / kRowChunks, ch = e % kRowChunks;
      const int gk = k0 + kk, gc = n0 + ch * kPer;
      SB* dst = Bs + kk * kSBN + ch * kPer;
      if (gk < K && gc < N)
        gemm::cp_async16(dst, B + static_cast<size_t>(gk) * N + gc);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < kSK * kSBN; e += S::kThreads) {
      const int kk = e / kSBN, c = e % kSBN;
      const int gk = k0 + kk, gc = n0 + c;
      Bs[kk * kSBN + c] =
          (gk < K && gc < N) ? B[static_cast<size_t>(gk) * N + gc] : SB(0);
    }
  }
  if (kVec && a_vec) {
    constexpr int kRowChunks = kSK / 4;
    for (int e = tid; e < rows * kRowChunks; e += S::kThreads) {
      const int r = e / kRowChunks, ch = e % kRowChunks;
      const int gk = k0 + 4 * ch;
      float* dst = As + r * kSK + 4 * ch;
      if (gk < K)
        gemm::cp_async16(dst, static_cast<const float*>(A) +
                                  static_cast<size_t>(r) * K + gk);
      else
        *reinterpret_cast<float4*>(dst) =
            make_float4(-0.f, -0.f, -0.f, -0.f);
    }
  } else {
    for (int e = tid; e < rows * kSK; e += S::kThreads) {
      const int r = e / kSK, kk = e % kSK, gk = k0 + kk;
      As[r * kSK + kk] =
          gk < K ? rt::load_code(A, static_cast<size_t>(r) * K + gk, af)
                 : -0.0f;
    }
  }
}

// Block (x, y, z) = (column tile, row tile, slice): thread t owns columns
// n0 + kSCols t + j of the tile's rows m0 .. m0 + rows - 1 (tile_rows <= TM
// rows per tile) of slice z, each sum one chain over k ascending.
template <typename S, typename SB, bool kVec, typename Epi>
__global__ void __launch_bounds__(S::kThreads)
stream_kernel(const char* __restrict__ A, rt::CodeFormat af, bool a_vec,
              const SB* __restrict__ B, int M, int N, int K, int tile_rows,
              Epi ep) {
  constexpr int TM = S::kRows, St = kSStages;
  extern __shared__ __align__(16) char smem[];
  const int n0 = blockIdx.x * kSBN, m0 = blockIdx.y * tile_rows;
  const size_t e = blockIdx.z;
  const int rows = min(tile_rows, M - m0);
  const size_t a_elt = af.bytes != 0 ? af.bytes : 4;
  const char* Ae = A + (e * M + m0) * K * a_elt;
  const SB* Be = B + e * K * N;
  const int cl = kSCols * threadIdx.x;   // the thread's first column
  const int nt = (K + kSK - 1) / kSK;

  // A's rows past the tile's are never loaded: any finite value will do
  // (their sums are dropped)
  for (int i = threadIdx.x; i < St * (TM - rows) * kSK; i += S::kThreads) {
    const int s = i / ((TM - rows) * kSK), j = i % ((TM - rows) * kSK);
    reinterpret_cast<float*>(smem + s * S::kStageBytes + S::kBBytes)
        [rows * kSK + j] = 0.0f;
  }
#pragma unroll
  for (int s = 0; s < St - 1; ++s) {
    if (s < nt)
      load_stream_stage<S, SB, kVec>(smem + s * S::kStageBytes, Ae, af, a_vec,
                                     Be, rows, N, K, n0, s * kSK);
    gemm::cp_commit();
  }
  float acc[TM][kSCols];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < kSCols; ++j) acc[r][j] = 0.0f;

  for (int t = 0; t < nt; ++t) {
    // stage t has landed, and every thread is done with stage t - 1, which
    // the next load reuses
    gemm::cp_wait<St - 2>();
    __syncthreads();
    const int tn = t + St - 1;
    if (tn < nt)
      load_stream_stage<S, SB, kVec>(smem + (tn % St) * S::kStageBytes, Ae,
                                     af, a_vec, Be, rows, N, K, n0,
                                     tn * kSK);
    gemm::cp_commit();
    const char* stage = smem + (t % St) * S::kStageBytes;
    const SB* Bs = reinterpret_cast<const SB*>(stage) + cl;
    const float* As = reinterpret_cast<const float*>(stage + S::kBBytes);
#pragma unroll
    for (int k4 = 0; k4 < kSK; k4 += 4) {
      float b[4][kSCols];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) widen2(Bs + (k4 + kk) * kSBN, b[kk]);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float4 a4 = *reinterpret_cast<const float4*>(As + r * kSK + k4);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < kSCols; ++j)
            acc[r][j] = fmaf(a[kk], b[kk][j], acc[r][j]);
      }
    }
  }
  gemm::cp_wait<0>();

  const Epi es = ep.slice(e);
  const int c0 = n0 + cl;
  if (c0 >= N) return;
#pragma unroll
  for (int r = 0; r < TM; ++r)
    if (r < rows) es.two(m0 + r, c0, acc[r]);
}

template <typename SB, int TM, bool kVec, typename Epi>
int launch_stream(const void* a, const rt::CodeFormat& af, bool a_vec,
                  const SB* b, int E, int M, int N, int K, int tile_rows,
                  const Epi& ep, cudaStream_t s) {
  using S = Stream<SB, TM>;
  auto kernel = stream_kernel<S, SB, kVec, Epi>;
  if (const int e = gemm::allow_smem(kernel, S::kSmem)) return e;
  const dim3 grid((N + kSBN - 1) / kSBN, (M + tile_rows - 1) / tile_rows, E);
  kernel<<<grid, S::kThreads, S::kSmem, s>>>(static_cast<const char*>(a), af,
                                             a_vec, b, M, N, K, tile_rows,
                                             ep);
  return static_cast<int>(cudaGetLastError());
}

// M's rows in the fewest tiles of at most kSMaxRows, each as even as it
// can be; an instance of the least even TM (or 1) that holds a tile (the
// time grows with TM: PERF.md), element loads (one instance) where the
// operands allow no vectors.  The wide instances compile TM = 1 (every MoE
// decode call) and 16 alone: a tile of fewer rows runs in the 16-row
// instance with the same sums, so the sweep of instances is not doubled.
template <typename SB, typename P>
int route_stream(const void* a, const rt::CodeFormat& af, bool a_vec,
                 bool vec, const SB* b, int E, int M, int N, int K,
                 const Epilogue<P>& ep, cudaStream_t s) {
  const int tiles = (M + kSMaxRows - 1) / kSMaxRows;
  const int rows = (M + tiles - 1) / tiles;
#define K8_STREAM(TM, VEC) \
  launch_stream<SB, TM, VEC>(a, af, a_vec, b, E, M, N, K, rows, ep, s)
  if (!vec) return K8_STREAM(kSMaxRows, false);
  if (rows == 1) return K8_STREAM(1, true);
  if constexpr (std::is_same<P, rt::WideParams>::value) {
    return K8_STREAM(kSMaxRows, true);
  } else {
    switch ((rows + 1) / 2) {
      case 1: return K8_STREAM(2, true);
      case 2: return K8_STREAM(4, true);
      case 3: return K8_STREAM(6, true);
      case 4: return K8_STREAM(8, true);
      case 5: return K8_STREAM(10, true);
      case 6: return K8_STREAM(12, true);
      case 7: return K8_STREAM(14, true);
      default: return K8_STREAM(16, true);
    }
  }
#undef K8_STREAM
}

// ---------------------------------------------------------------------------
// Large-M route: K3''s tiles (qmatmul_sr.cu), the one whose rows fit M best
// once the grid holds a wave of blocks; element loads (32x64 tiles) where
// the operands allow no vectors.
// ---------------------------------------------------------------------------
template <typename SB, typename Epi>
int route_large(const void* a, const rt::CodeFormat& af, bool vec,
                const SB* b, int E, int M, int N, int K, const Epi& ep,
                cudaStream_t s) {
  using Big = gemm::Tile<16, 2, 1, 3, SB, 1, 2>;
  using Mid = gemm::Tile<16, 1, 1, 6, SB, 1, 1>;
  using Small = gemm::Tile<8, 1, 1, 8, SB, 1, 1>;
  if (!vec)
    return gemm::launch_gemm_batched<Small, false>(a, af, b, E, M, N, K, ep,
                                                   s);
  if (M > Mid::BM &&
      E * gemm::tiles_of(M, N, Big::BM, Big::BN) >= gemm::kWaveTiles)
    return gemm::launch_gemm_batched<Big, true>(a, af, b, E, M, N, K, ep, s);
  if (M > Small::BM)
    return gemm::launch_gemm_batched<Mid, true>(a, af, b, E, M, N, K, ep, s);
  return gemm::launch_gemm_batched<Small, true>(a, af, b, E, M, N, K, ep, s);
}

template <typename SB, typename P>
int route(const void* a, const rt::CodeFormat& af, bool a_vec, bool vec,
          const void* b, int E, int K, const Epilogue<P>& ep,
          cudaStream_t s, bool stream) {
  const SB* w = static_cast<const SB*>(b);
  if (stream)
    return route_stream<SB>(a, af, a_vec, vec, w, E, ep.M, ep.N, K, ep, s);
  return route_large<SB>(a, af, vec, w, E, ep.M, ep.N, K, ep, s);
}

template <typename P>
int run(const void* a, const int* a_fmt, const void* b, int b_is_bf16,
        const uint32_t* seeds, const uint32_t* bits, void* out,
        const int* out_fmt, int E, int M, int N, int K, const P& fwd,
        void* stream, bool stream_route) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  const rt::CodeFormat af = rt::code_format(a_fmt);
  const Epilogue<P> ep{seeds, bits, out, rt::code_format(out_fmt), M, N, 0u,
                       0u, fwd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // vector loads: B rows of whole 16-byte chunks from a 16-byte aligned
  // base (so every slice's base is aligned too); a float32 A 16-byte
  // aligned with K % 4 == 0 (the large-M route's vector instance takes
  // code words of A element by element)
  const bool a_vec = af.bytes == 0 && gemm::aligned16(a) && K % 4 == 0;
  const bool vec = gemm::aligned16(b) && N % (b_is_bf16 ? 8 : 4) == 0 &&
                   (stream_route || af.bytes != 0 || a_vec);
  if (b_is_bf16)
    return route<gemm::Bf16Bits>(a, af, a_vec, vec, b, E, K, ep, s,
                                 stream_route);
  return route<float>(a, af, a_vec, vec, b, E, K, ep, s, stream_route);
}

// The first instances' site: rn, sr or sr_eps on a plain FP grid.
rt::RoundParams fp_site(int precision, int emin, int emax, float xmax,
                        int mode, int rand_bits, float eps) {
  return rt::RoundParams{precision, emin, emax, xmax, mode, rand_bits, 1,
                         eps};
}

}  // namespace

// K8', large-M route.  a: (E, M, K) float32, or codes per a_fmt (int[7],
// null: float32); b: (E, K, N) float32 or bf16 (b_is_bf16); seeds: (E, 2)
// uint32 on the device, slice e's words at 2e and 2e + 1; out: (E, M, N)
// float32, or codes per out_fmt.  Launch on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int qmatmul_batched_sr(const void* a, const int* a_fmt,
                                  const void* b, int b_is_bf16,
                                  const uint32_t* seeds, void* out,
                                  const int* out_fmt, int E, int M, int N,
                                  int K, int precision, int emin, int emax,
                                  float xmax, int mode, int rand_bits,
                                  float eps, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, seeds, nullptr, out, out_fmt, E, M, N,
             K, fp_site(precision, emin, emax, xmax, mode, rand_bits, eps),
             stream, false);
}

// K8, large-M route.  bits: (E, M, N) uint32 words on the device (read
// only under a stochastic scheme).
extern "C" int qmatmul_batched_bits(const void* a, const int* a_fmt,
                                    const void* b, int b_is_bf16,
                                    const uint32_t* bits, void* out,
                                    const int* out_fmt, int E, int M, int N,
                                    int K, int precision, int emin, int emax,
                                    float xmax, int mode, int rand_bits,
                                    float eps, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, nullptr, bits, out, out_fmt, E, M, N,
             K, fp_site(precision, emin, emax, xmax, mode, rand_bits, eps),
             stream, false);
}

// K8', weight-stream route: qmatmul_batched_sr's arguments and result.
extern "C" int qmatmul_batched_sr_stream(const void* a, const int* a_fmt,
                                         const void* b, int b_is_bf16,
                                         const uint32_t* seeds, void* out,
                                         const int* out_fmt, int E, int M,
                                         int N, int K, int precision,
                                         int emin, int emax, float xmax,
                                         int mode, int rand_bits, float eps,
                                         void* stream) {
  return run(a, a_fmt, b, b_is_bf16, seeds, nullptr, out, out_fmt, E, M, N,
             K, fp_site(precision, emin, emax, xmax, mode, rand_bits, eps),
             stream, true);
}

// K8, weight-stream route: qmatmul_batched_bits' arguments and result.
extern "C" int qmatmul_batched_bits_stream(const void* a, const int* a_fmt,
                                           const void* b, int b_is_bf16,
                                           const uint32_t* bits, void* out,
                                           const int* out_fmt, int E, int M,
                                           int N, int K, int precision,
                                           int emin, int emax, float xmax,
                                           int mode, int rand_bits,
                                           float eps, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, nullptr, bits, out, out_fmt, E, M, N,
             K, fp_site(precision, emin, emax, xmax, mode, rand_bits, eps),
             stream, true);
}

// K8''s wide instance (every scheme x grid pair of the reference's
// round_block, saturating: the reference's batched GEMM passes no
// overflow), large-M route.  site: int[8] {1, precision, emin, emax, mode,
// rand_bits, 0, flags} and fsite: float[4] {xmax, eps, scale, mu}
// (rt::wide_params); other arguments as qmatmul_batched_sr's.
extern "C" int qmatmul_batched_sr_wide(const void* a, const int* a_fmt,
                                       const void* b, int b_is_bf16,
                                       const uint32_t* seeds, void* out,
                                       const int* out_fmt, int E, int M,
                                       int N, int K, const int* site,
                                       const float* fsite, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, seeds, nullptr, out, out_fmt, E, M, N,
             K, rt::wide_params(site, fsite[0], fsite[1], fsite + 2), stream,
             false);
}

// K8''s wide instance, weight-stream route: qmatmul_batched_sr_wide's
// arguments.
extern "C" int qmatmul_batched_sr_wide_stream(const void* a,
                                              const int* a_fmt,
                                              const void* b, int b_is_bf16,
                                              const uint32_t* seeds,
                                              void* out, const int* out_fmt,
                                              int E, int M, int N, int K,
                                              const int* site,
                                              const float* fsite,
                                              void* stream) {
  return run(a, a_fmt, b, b_is_bf16, seeds, nullptr, out, out_fmt, E, M, N,
             K, rt::wide_params(site, fsite[0], fsite[1], fsite + 2), stream,
             true);
}
