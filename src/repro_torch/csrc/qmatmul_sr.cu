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
// (K3') or read bits[r N + c] (K3), then rt::round_value and
// rt::store_code.  Bits are keyed by the global (r, c), so neither the
// tiling nor the route changes them.
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

#include "rounding.cuh"

namespace {

// B in shared memory: float32 as it is, bf16 as its raw 16 bits.
using Bf16Bits = uint16_t;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(Bf16Bits v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// Four consecutive B values from shared memory (8 or 16 bytes, aligned).
__device__ __forceinline__ void widen4(const float* p, float (&b)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  b[0] = v.x;
  b[1] = v.y;
  b[2] = v.z;
  b[3] = v.w;
}
__device__ __forceinline__ void widen4(const Bf16Bits* p, float (&b)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  b[0] = __uint_as_float(v.x << 16);
  b[1] = __uint_as_float(v.x & 0xFFFF0000u);
  b[2] = __uint_as_float(v.y << 16);
  b[3] = __uint_as_float(v.y & 0xFFFF0000u);
}

// A 16-byte cp.async from global to shared memory (cached in L2 only),
// the commit of a group, and the wait until at most N groups are pending.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :
               : "r"(dst), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

struct Epilogue {
  const uint32_t* bits;   // K3's words; nullptr: draw in-kernel (K3')
  void* out;
  rt::CodeFormat of;
  int M, N;
  uint32_t k0, k1;
  rt::RoundParams fwd;
};

// The rounding words of out[r, c0 .. c0 + 3] (c0 % 4 == 0): drawn (K3')
// or read (K3); zero for rn.
__device__ __forceinline__ void bits4(const Epilogue& e, int r, int c0,
                                      uint32_t (&w)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = 0u;
  if (e.fwd.mode != rt::kSR) return;
  if (e.bits == nullptr) {
    rt::element_bits4(e.k0, e.k1, 0u, e.fwd.rand_bits, r, c0, w);
  } else {
    const size_t row = static_cast<size_t>(r) * e.N;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < e.N) w[j] = e.bits[row + c0 + j];
  }
}

// Round four sums with their words and store out[r, c0 .. c0 + 3];
// columns at or past N are dropped.
__device__ __forceinline__ void round_store4(const Epilogue& e, int r, int c0,
                                             const float (&v)[4],
                                             const uint32_t (&w)[4]) {
  const size_t row = static_cast<size_t>(r) * e.N;
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) y[j] = rt::round_value(v[j], w[j], e.fwd);
  if (e.of.bytes == 0 && (e.N & 3) == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(e.out) + row + c0) =
        make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < e.N) rt::store_code(e.out, row + c0 + j, y[j], e.of);
  }
}

__device__ __forceinline__ void emit4(const Epilogue& e, int r, int c0,
                                      const float (&v)[4]) {
  uint32_t w[4];
  bits4(e, r, c0, w);
  round_store4(e, r, c0, v, w);
}

// ---------------------------------------------------------------------------
// Large-M route
// ---------------------------------------------------------------------------
constexpr int kBK = 32;   // a multiple of 16
constexpr int kAS = kBK + 4;   // A tile row stride in shared memory (floats)

// A block of 16 TY threads; thread (ty, tx) = (tid / 16, tid % 16) owns RG
// x CG groups of 4 x 4 outputs: rows 4 TY g + 4 ty + i, columns 64 h +
// 4 tx + j of a (4 TY RG) x (64 CG) tile.  Stages: the depth of the
// cp.async ring (deeper for small tiles, whose stages compute briefly).
template <int TY, int RG, int CG, int STAGES, typename SB>
struct Tile {
  static constexpr int kThreads = 16 * TY, kStages = STAGES;
  static constexpr int BM = 4 * TY * RG, BN = 64 * CG;
  static constexpr int kABytes = BM * kAS * 4;
  static constexpr int kBBytes = kBK * BN * static_cast<int>(sizeof(SB));
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes;
};
// 128x64 tiles of 8x4 outputs per thread where the grid fills the card
// (two blocks per SM; 128x128 tiles measured slower, PERF.md), 64x64 and
// 32x64 tiles of 4x4 where it would not
constexpr int kBigRG = 2, kBigCG = 1;
using Big = Tile<16, kBigRG, kBigCG, 3, float>;
constexpr int kBigMinBlocks = 2;

// One kBK-deep stage: A rows [m0, m0 + BM) x k [k0, k0 + kBK) into a
// (BM, kAS) float tile, B rows [k0, k0 + kBK) x columns [n0, n0 + BN)
// into a (kBK, BN) tile; zeros past M, N and K.  kVec: 16-byte cp.async (A
// float32 16-byte aligned with K % 4 == 0, B 16-byte aligned with rows of
// whole 16-byte chunks), else element loads stored before the next
// barrier; code words of A are always loaded element by element and
// decoded.
template <typename T, typename SB, bool kVec>
__device__ __forceinline__ void load_stage(char* stage, const void* A,
                                           const rt::CodeFormat& af,
                                           const SB* B, int M, int N, int K,
                                           int m0, int n0, int k0) {
  float* As = reinterpret_cast<float*>(stage);
  SB* Bs = reinterpret_cast<SB*>(stage + T::kABytes);
  const int tid = threadIdx.x;
  if (kVec && af.bytes == 0) {
    constexpr int kRowChunks = kBK / 4;
    for (int e = tid; e < T::BM * kRowChunks; e += T::kThreads) {
      const int r = e / kRowChunks, ch = e % kRowChunks;
      const int gr = m0 + r, gk = k0 + 4 * ch;
      float* dst = As + r * kAS + 4 * ch;
      if (gr < M && gk < K)
        cp_async16(dst, static_cast<const float*>(A) +
                            static_cast<size_t>(gr) * K + gk);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < T::BM * kBK; e += T::kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int gr = m0 + r, gk = k0 + kk;
      As[r * kAS + kk] =
          (gr < M && gk < K)
              ? rt::load_code(A, static_cast<size_t>(gr) * K + gk, af)
              : 0.0f;
    }
  }
  if constexpr (kVec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(SB));
    constexpr int kRowChunks = T::BN / kPer;
    for (int e = tid; e < kBK * kRowChunks; e += T::kThreads) {
      const int kk = e / kRowChunks, ch = e % kRowChunks;
      const int gk = k0 + kk, gc = n0 + ch * kPer;
      SB* dst = Bs + kk * T::BN + ch * kPer;
      if (gk < K && gc < N)
        cp_async16(dst, B + static_cast<size_t>(gk) * N + gc);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < kBK * T::BN; e += T::kThreads) {
      const int kk = e / T::BN, c = e % T::BN;
      const int gk = k0 + kk, gc = n0 + c;
      Bs[kk * T::BN + c] =
          (gk < K && gc < N) ? B[static_cast<size_t>(gk) * N + gc] : SB(0);
    }
  }
}

template <typename T, typename SB, int RG, int CG, bool kVec>
__device__ __forceinline__ void gemm_body(const void* __restrict__ A,
                                          const rt::CodeFormat& af,
                                          const SB* __restrict__ B, int K,
                                          const Epilogue& ep) {
  constexpr int TM = 4 * RG, TN = 4 * CG, kRowStep = T::BM / RG;
  constexpr int S = T::kStages;
  extern __shared__ __align__(16) char smem[];
  const int M = ep.M, N = ep.N;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int nt = (K + kBK - 1) / kBK, K16 = (K + 15) & ~15;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nt)
      load_stage<T, SB, kVec>(smem + s * T::kStageBytes, A, af, B, M, N, K,
                              m0, n0, s * kBK);
    cp_commit();
  }
  for (int t = 0; t < nt; ++t) {
    // stage t has landed (at most S - 2 younger groups pending), and every
    // thread is done with stage t - 1, which the next load reuses
    cp_wait<S - 2>();
    __syncthreads();
    const int tn = t + S - 1;
    if (tn < nt)
      load_stage<T, SB, kVec>(smem + (tn % S) * T::kStageBytes, A, af, B,
                              M, N, K, m0, n0, tn * kBK);
    cp_commit();
    const char* stage = smem + (t % S) * T::kStageBytes;
    const float* As = reinterpret_cast<const float*>(stage);
    const SB* Bs = reinterpret_cast<const SB*>(stage + T::kABytes);
    // the chain runs over K rounded up to 16, not to kBK
    const int kend = min(kBK, K16 - t * kBK);
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      if (k4 % 16 == 0 && k4 >= kend) break;
      float a[TM][4];
#pragma unroll
      for (int g = 0; g < RG; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              As + (kRowStep * g + 4 * ty + i) * kAS + k4);
          a[4 * g + i][0] = v.x;
          a[4 * g + i][1] = v.y;
          a[4 * g + i][2] = v.z;
          a[4 * g + i][3] = v.w;
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[TN];
#pragma unroll
        for (int h = 0; h < CG; ++h) {
          float q[4];
          widen4(Bs + (k4 + kk) * T::BN + 64 * h + 4 * tx, q);
#pragma unroll
          for (int j = 0; j < 4; ++j) b[4 * h + j] = q[j];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int g = 0; g < RG; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + kRowStep * g + 4 * ty + i;
#pragma unroll
      for (int h = 0; h < CG; ++h) {
        const int c0 = n0 + 64 * h + 4 * tx;
        if (r < M && c0 < N) {
          const float v[4] = {acc[4 * g + i][4 * h], acc[4 * g + i][4 * h + 1],
                              acc[4 * g + i][4 * h + 2],
                              acc[4 * g + i][4 * h + 3]};
          emit4(ep, r, c0, v);
        }
      }
    }
}

template <typename SB, bool kVec>
__global__ void __launch_bounds__(Big::kThreads, kBigMinBlocks)
gemm_big_kernel(const void* __restrict__ A, rt::CodeFormat af,
                const SB* __restrict__ B, int K, Epilogue ep) {
  gemm_body<Tile<16, kBigRG, kBigCG, Big::kStages, SB>, SB, kBigRG, kBigCG,
            kVec>(A, af, B, K, ep);
}

template <typename SB, int TY, int STAGES, bool kVec>
__global__ void __launch_bounds__(16 * TY)
gemm_small_kernel(const void* __restrict__ A, rt::CodeFormat af,
                  const SB* __restrict__ B, int K, Epilogue ep) {
  gemm_body<Tile<TY, 1, 1, STAGES, SB>, SB, 1, 1, kVec>(A, af, B, K, ep);
}

// ---------------------------------------------------------------------------
// Decode route
// ---------------------------------------------------------------------------
constexpr int kDRows = 4;               // rows of A per block: 8 lanes each
constexpr int kDWarps = 4;              // warps per block: 8 columns each
constexpr int kDCols = 8 * kDWarps;     // columns per block
constexpr int kDThreads = 32 * kDWarps;
constexpr int kDStage = 64;             // rows of k per stage
constexpr int kDStages = 8;             // stages in the cp.async ring
constexpr int kDAS = kDStage + 4;       // A row stride in a stage (floats)
constexpr int kDBatch = 32;             // k rows whose operands load at once

template <typename SB>
struct Dec {
  static constexpr int kBBytes =
      kDStage * kDCols * static_cast<int>(sizeof(SB));
  static constexpr int kABytes = kDRows * kDAS * 4;
  static constexpr int kStageBytes = kBBytes + kABytes;
  static constexpr int kSmem = kDStages * kStageBytes;
  static_assert(kABytes % 16 == 0 && kBBytes % 16 == 0, "16-byte stages");
};

// One stage: B rows [k0, k0 + kDStage) x the block's kDCols columns into a
// (kDStage, kDCols) tile, A rows [r0, r0 + kDRows) x k [k0, k0 + kDStage)
// into a (kDRows, kDAS) float tile; zeros past M, N and K.  kVec: 16-byte
// cp.async for B (and for a float32 A, 16-byte aligned with K % 4 == 0),
// else element loads stored before the next barrier.
template <typename SB, bool kVec>
__device__ __forceinline__ void load_dec_stage(char* stage, const void* A,
                                               const rt::CodeFormat& af,
                                               bool a_vec, const SB* B,
                                               int M, int N, int K, int r0,
                                               int n0, int k0) {
  using D = Dec<SB>;
  SB* Bs = reinterpret_cast<SB*>(stage);
  float* As = reinterpret_cast<float*>(stage + D::kBBytes);
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(SB));
    constexpr int kRowChunks = kDCols / kPer;
    for (int e = tid; e < kDStage * kRowChunks; e += kDThreads) {
      const int kk = e / kRowChunks, ch = e % kRowChunks;
      const int gk = k0 + kk, gc = n0 + ch * kPer;
      SB* dst = Bs + kk * kDCols + ch * kPer;
      if (gk < K && gc < N)
        cp_async16(dst, B + static_cast<size_t>(gk) * N + gc);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < kDStage * kDCols; e += kDThreads) {
      const int kk = e / kDCols, c = e % kDCols;
      const int gk = k0 + kk, gc = n0 + c;
      Bs[kk * kDCols + c] =
          (gk < K && gc < N) ? B[static_cast<size_t>(gk) * N + gc] : SB(0);
    }
  }
  if (kVec && a_vec) {
    constexpr int kRowChunks = kDStage / 4;
    for (int e = tid; e < kDRows * kRowChunks; e += kDThreads) {
      const int rr = e / kRowChunks, ch = e % kRowChunks;
      const int gr = r0 + rr, gk = k0 + 4 * ch;
      float* dst = As + rr * kDAS + 4 * ch;
      if (gr < M && gk < K)
        cp_async16(dst, static_cast<const float*>(A) +
                            static_cast<size_t>(gr) * K + gk);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < kDRows * kDStage; e += kDThreads) {
      const int rr = e / kDStage, kk = e % kDStage;
      const int gr = r0 + rr, gk = k0 + kk;
      As[rr * kDAS + kk] =
          (gr < M && gk < K)
              ? rt::load_code(A, static_cast<size_t>(gr) * K + gk, af)
              : 0.0f;
    }
  }
}

// acc = fmaf(a[i], b[i * kDCols], acc) for i = 0 .. N - 1, in order, with
// every operand loaded first.
template <int N, typename SB>
__device__ __forceinline__ void chain_batch(const float* a, const SB* b,
                                            float& acc) {
  float av[N], bv[N];
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(a + i);
    av[i] = v.x;
    av[i + 1] = v.y;
    av[i + 2] = v.z;
    av[i + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) bv[i] = widen(b[i * kDCols]);
#pragma unroll
  for (int i = 0; i < N; ++i) acc = fmaf(av[i], bv[i], acc);
}

// Lane (rq, cq) = (lane / 8, lane % 8) of warp w owns out[r0 + rq, n0 +
// 8 w + cq] and its whole chain: the large-M route's order exactly.
template <typename SB, bool kVec>
__global__ void __launch_bounds__(kDThreads)
decode_kernel(const void* __restrict__ A, rt::CodeFormat af, bool a_vec,
              const SB* __restrict__ B, int K, Epilogue ep) {
  using D = Dec<SB>;
  constexpr int S = kDStages;
  extern __shared__ __align__(16) char smem[];
  const int M = ep.M, N = ep.N;
  const int r0 = blockIdx.y * kDRows, n0 = blockIdx.x * kDCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rq = lane / 8, col = 8 * warp + lane % 8;
  const int nt = (K + kDStage - 1) / kDStage, K16 = (K + 15) & ~15;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nt)
      load_dec_stage<SB, kVec>(smem + s * D::kStageBytes, A, af, a_vec, B,
                               M, N, K, r0, n0, s * kDStage);
    cp_commit();
  }
  float acc = 0.0f;
  for (int t = 0; t < nt; ++t) {
    cp_wait<S - 2>();
    __syncthreads();
    const int tn = t + S - 1;
    if (tn < nt)
      load_dec_stage<SB, kVec>(smem + (tn % S) * D::kStageBytes, A, af,
                               a_vec, B, M, N, K, r0, n0, tn * kDStage);
    cp_commit();
    const char* stage = smem + (t % S) * D::kStageBytes;
    const SB* Bs = reinterpret_cast<const SB*>(stage) + col;
    const float* As =
        reinterpret_cast<const float*>(stage + D::kBBytes) + rq * kDAS;
    // the chain runs over K rounded up to 16, not to kDStage; each batch's
    // operands are loaded into registers ahead of its dependent FMAs
    const int kend = min(kDStage, K16 - t * kDStage);
    if (kend == kDStage) {
#pragma unroll
      for (int k0 = 0; k0 < kDStage; k0 += kDBatch) chain_batch<kDBatch>(
          As + k0, Bs + k0 * kDCols, acc);
    } else {
      for (int k0 = 0; k0 < kend; k0 += 16)
        chain_batch<16>(As + k0, Bs + k0 * kDCols, acc);
    }
  }
  cp_wait<0>();

  const int r = r0 + rq, c = n0 + col;
  if (r < M && c < N) {
    const size_t idx = static_cast<size_t>(r) * N + c;
    uint32_t w = 0u;
    if (ep.fwd.mode == rt::kSR)
      w = ep.bits != nullptr
              ? ep.bits[idx]
              : rt::element_bits(ep.k0, ep.k1, 0u, ep.fwd.rand_bits, r, c);
    rt::store_code(ep.out, idx, rt::round_value(acc, w, ep.fwd), ep.of);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

struct Launch {
  const void* a;
  rt::CodeFormat af;
  const void* b;
  int K;
  Epilogue ep;
  bool vec;     // B (and a float32 A, in the large-M route) by cp.async
  bool a_vec;   // a float32 A by cp.async (decode route)
  cudaStream_t s;
};

template <typename T, typename SB, typename Kernel>
int launch_gemm(Kernel kernel, const Launch& l) {
  if (const int e = allow_smem(kernel, T::kSmem)) return e;
  const dim3 grid((l.ep.N + T::BN - 1) / T::BN, (l.ep.M + T::BM - 1) / T::BM);
  kernel<<<grid, T::kThreads, T::kSmem, l.s>>>(
      l.a, l.af, static_cast<const SB*>(l.b), l.K, l.ep);
  return static_cast<int>(cudaGetLastError());
}

// The smaller tiles: 64x64 (256 threads) and 32x64 (128 threads).
constexpr int kMidStages = 6, kSmallStages = 8;

long tiles_of(const Launch& l, int bm, int bn) {
  return static_cast<long>((l.ep.M + bm - 1) / bm) * ((l.ep.N + bn - 1) / bn);
}

// The largest tile whose grid holds about a wave of blocks (120 of the
// 132 SMs); element loads (32x64 tiles) where the operands allow no
// vectors.
template <typename SB>
int route_gemm(const Launch& l) {
  using BigT = Tile<16, kBigRG, kBigCG, Big::kStages, SB>;
  using Mid = Tile<16, 1, 1, kMidStages, SB>;
  using Small = Tile<8, 1, 1, kSmallStages, SB>;
  if (!l.vec)
    return launch_gemm<Small, SB>(
        gemm_small_kernel<SB, 8, kSmallStages, false>, l);
  if (tiles_of(l, BigT::BM, BigT::BN) >= 120)
    return launch_gemm<BigT, SB>(gemm_big_kernel<SB, true>, l);
  if (tiles_of(l, Mid::BM, Mid::BN) >= 120)
    return launch_gemm<Mid, SB>(gemm_small_kernel<SB, 16, kMidStages, true>,
                                l);
  return launch_gemm<Small, SB>(
      gemm_small_kernel<SB, 8, kSmallStages, true>, l);
}

template <typename SB, bool kVec>
int launch_decode(const Launch& l) {
  using D = Dec<SB>;
  auto kernel = decode_kernel<SB, kVec>;
  if (const int e = allow_smem(kernel, D::kSmem)) return e;
  const dim3 grid((l.ep.N + kDCols - 1) / kDCols,
                  (l.ep.M + kDRows - 1) / kDRows);
  kernel<<<grid, kDThreads, D::kSmem, l.s>>>(
      l.a, l.af, l.a_vec, static_cast<const SB*>(l.b), l.K, l.ep);
  return static_cast<int>(cudaGetLastError());
}

template <typename SB>
int route(const Launch& l, bool decode) {
  if (!decode) return route_gemm<SB>(l);
  return l.vec ? launch_decode<SB, true>(l) : launch_decode<SB, false>(l);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int run(const void* a, const int* a_fmt, const void* b, int b_is_bf16,
        const uint32_t* bits, void* out, const int* out_fmt, int M, int N,
        int K, uint32_t k0, uint32_t k1, int precision, int emin, int emax,
        float xmax, int mode, int rand_bits, void* stream, bool decode) {
  if (M <= 0 || N <= 0) return 0;
  Launch l;
  l.a = a;
  l.af = rt::code_format(a_fmt);
  l.b = b;
  l.K = K;
  l.ep = Epilogue{bits, out, rt::code_format(out_fmt), M, N, k0, k1,
                  rt::RoundParams{precision, emin, emax, xmax, mode,
                                  rand_bits, 1}};
  l.s = static_cast<cudaStream_t>(stream);
  // vector loads: B rows of whole 16-byte chunks from a 16-byte aligned
  // base; a float32 A 16-byte aligned with K % 4 == 0 (in the large-M
  // route the vector instance takes code words of A element by element)
  l.a_vec = l.af.bytes == 0 && aligned16(a) && K % 4 == 0;
  l.vec = aligned16(b) && N % (b_is_bf16 ? 8 : 4) == 0 &&
          (decode || l.af.bytes != 0 || l.a_vec);
  if (b_is_bf16) return route<Bf16Bits>(l, decode);
  return route<float>(l, decode);
}

}  // namespace

// K3', large-M route.  a: (M, K) float32, or codes per a_fmt (int[7],
// null: float32); out: (M, N) float32, or codes of the GEMM's grid per
// out_fmt.  Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int qmatmul_sr(const void* a, const int* a_fmt, const void* b,
                          int b_is_bf16, void* out, const int* out_fmt,
                          int M, int N, int K, uint32_t k0, uint32_t k1,
                          int precision, int emin, int emax, float xmax,
                          int mode, int rand_bits, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, nullptr, out, out_fmt, M, N, K, k0, k1,
             precision, emin, emax, xmax, mode, rand_bits, stream, false);
}

// K3, large-M route.  bits: (M, N) uint32 words on the device (read only
// under sr).
extern "C" int qmatmul_bits(const void* a, const int* a_fmt, const void* b,
                            int b_is_bf16, const uint32_t* bits, void* out,
                            const int* out_fmt, int M, int N, int K,
                            int precision, int emin, int emax, float xmax,
                            int mode, int rand_bits, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, bits, out, out_fmt, M, N, K, 0u, 0u,
             precision, emin, emax, xmax, mode, rand_bits, stream, false);
}

// K3', decode route: qmatmul_sr's arguments and result.
extern "C" int qmatmul_sr_decode(const void* a, const int* a_fmt,
                                 const void* b, int b_is_bf16, void* out,
                                 const int* out_fmt, int M, int N, int K,
                                 uint32_t k0, uint32_t k1, int precision,
                                 int emin, int emax, float xmax, int mode,
                                 int rand_bits, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, nullptr, out, out_fmt, M, N, K, k0, k1,
             precision, emin, emax, xmax, mode, rand_bits, stream, true);
}

// K3, decode route: qmatmul_bits' arguments and result.
extern "C" int qmatmul_bits_decode(const void* a, const int* a_fmt,
                                   const void* b, int b_is_bf16,
                                   const uint32_t* bits, void* out,
                                   const int* out_fmt, int M, int N, int K,
                                   int precision, int emin, int emax,
                                   float xmax, int mode, int rand_bits,
                                   void* stream) {
  return run(a, a_fmt, b, b_is_bf16, bits, out, out_fmt, M, N, K, 0u, 0u,
             precision, emin, emax, xmax, mode, rand_bits, stream, true);
}
