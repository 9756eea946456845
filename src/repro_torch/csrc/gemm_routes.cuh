// The two main loops of the rounded GEMMs on an H100, shared by K3'/K3
// (qmatmul_sr.cu, one weight operand) and K4'/K4 (qmatmul_swiglu_sr.cu, two
// weight operands wg and wu read against the same A rows); the large-M
// route also runs K8'/K8's stacks of GEMMs (qmatmul_batched_sr.cu:
// gemm_batched_kernel, one grid plane per slice, A padded with -0 past K so
// that its chains equal chains of exactly K steps, the first K8's order).
//
// Both loops sum in the first version's order: one accumulator per output
// and weight operand, one fmaf(a[r, k], b[k, c], acc) per k in ascending k
// from +0, over K rounded up to 16 with zeros past K (fmaf(0, 0, -0) is +0:
// the padding turns a -0 sum into +0, as the first version's 16-deep stages
// did).  So the two routes, and that version, are bitwise equal on every
// input, and a row's result depends on its A row, the weights and K alone:
// never on M, the tile or the co-batched rows.
//
// * Large-M route (gemm_kernel): SIMT tiling on the fp32 pipe.  A block of
//   16 TY threads; thread (ty, tx) = (tid / 16, tid % 16) owns RG x CG
//   groups of 4 x 4 outputs of every weight operand: rows 4 TY g + 4 ty + i,
//   columns 64 h + 4 tx + j of a (4 TY RG) x (64 CG) tile.  A ring of
//   kBK-deep shared-memory stages filled by 16-byte cp.async where the
//   operands are aligned, so the next stages' loads fly while a stage's FMAs
//   run; float4 fragment reads of A (rows of 32 k at a stride of 36 floats:
//   conflict-free), bf16 B kept raw in shared memory and widened at fragment
//   load.  Each thread holds every operand's sums of the same outputs, so an
//   epilogue that combines them (the GLU) stays in registers.
//
// * Decode route (decode_kernel): every lane owns one output of one weight
//   operand and its whole chain (a warp: 8 columns x 4 rows, the 4 row
//   lanes of a column reading its B values by broadcast), so the chains of
//   all M N NB outputs run side by side; a block of NB groups of kDWarps
//   warps (one group per operand) streams its kDCols columns of every B (64
//   bytes of each bf16 row) and its A rows through a ring of stages of
//   kDStage rows filled by 16-byte cp.async, and loads each
//   kDBatch rows' operands into registers ahead of their dependent FMAs.
//   At M = 4 the route is bound by the latency of each warp's loads and
//   FMAs, not by bytes, so a chain per lane (not NB chains) gives the card
//   NB times the warps to interleave; after the loop the lanes of operands
//   1 .. NB - 1 hand their sums to operand 0's lanes through shared memory,
//   which run the epilogue.
//
// Tensor cores are not used: A is float32 that TF32 or bf16 operands would
// round, and a split-operand (3xTF32) route would leave the accumulation
// order to the hardware.  Operands need no alignment: where a pointer or a
// row length does not allow vector loads, an instance with element loads
// runs (kVec = false).  A may be float32 or the code words of a grid
// (rt::CodeFormat af), decoded as staged.
//
// An epilogue is a type with two members, called once per output group
// with that group's sums of every weight operand:
//   four(r, c0, const float (&v)[NB][4])  outputs (r, c0 .. c0 + 3), c0 % 4
//                                         == 0, r < M and c0 < N (columns
//                                         at or past N to be dropped);
//   one(r, c, const float (&v)[NB])       output (r, c), r < M and c < N.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "rounding.cuh"

namespace gemm {

// B in shared memory: float32 as it is, bf16 as its raw 16 bits.
using Bf16Bits = uint16_t;

// The weight operands of one call, each (K, N) row-major.
template <typename SB, int NB>
struct Weights {
  const SB* b[NB];
};

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

// ---------------------------------------------------------------------------
// Large-M route
// ---------------------------------------------------------------------------
constexpr int kBK = 32;   // a multiple of 16
constexpr int kAS = kBK + 4;   // A tile row stride in shared memory (floats)

// A (4 TY RG) x (64 CG) output tile of NB weight operands; STAGES: the
// depth of the cp.async ring (deeper for small tiles, whose stages compute
// briefly); MINB: the resident blocks per SM the registers must allow.
template <int TY, int RG, int CG, int STAGES, typename SB, int NB, int MINB>
struct Tile {
  static constexpr int kRG = RG, kCG = CG;
  static constexpr int kThreads = 16 * TY, kStages = STAGES;
  static constexpr int kMinBlocks = MINB;
  static constexpr int BM = 4 * TY * RG, BN = 64 * CG;
  static constexpr int kABytes = BM * kAS * 4;
  static constexpr int kBTile = kBK * BN;   // elements of one operand
  static constexpr int kBBytes = NB * kBTile * static_cast<int>(sizeof(SB));
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes;
};

// One kBK-deep stage: A rows [m0, m0 + BM) x k [k0, k0 + kBK) into a
// (BM, kAS) float tile, then for each operand B rows [k0, k0 + kBK) x
// columns [n0, n0 + BN) into a (kBK, BN) tile; zeros past M, N and K (A's
// padding -0 with kNegPad: fmaf(-0, +0, acc) is acc for every acc, -0
// included, so the padded chain equals one of exactly K steps).
// kVec: 16-byte cp.async (A float32 16-byte aligned with K % 4 == 0, B
// 16-byte aligned with rows of whole 16-byte chunks), else element loads
// stored before the next barrier; code words of A are always loaded
// element by element and decoded.
template <typename T, typename SB, int NB, bool kVec, bool kNegPad = false>
__device__ __forceinline__ void load_stage(char* stage, const void* A,
                                           const rt::CodeFormat& af,
                                           const Weights<SB, NB>& B, int M,
                                           int N, int K, int m0, int n0,
                                           int k0) {
  float* As = reinterpret_cast<float*>(stage);
  SB* Bs = reinterpret_cast<SB*>(stage + T::kABytes);
  const int tid = threadIdx.x;
  const float pad = kNegPad ? -0.0f : 0.0f;
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
        *reinterpret_cast<float4*>(dst) = make_float4(pad, pad, pad, pad);
    }
  } else {
    for (int e = tid; e < T::BM * kBK; e += T::kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int gr = m0 + r, gk = k0 + kk;
      As[r * kAS + kk] =
          (gr < M && gk < K)
              ? rt::load_code(A, static_cast<size_t>(gr) * K + gk, af)
              : pad;
    }
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const SB* Bg = B.b[nb];
    SB* Bt = Bs + nb * T::kBTile;
    if constexpr (kVec) {
      constexpr int kPer = 16 / static_cast<int>(sizeof(SB));
      constexpr int kRowChunks = T::BN / kPer;
      for (int e = tid; e < kBK * kRowChunks; e += T::kThreads) {
        const int kk = e / kRowChunks, ch = e % kRowChunks;
        const int gk = k0 + kk, gc = n0 + ch * kPer;
        SB* dst = Bt + kk * T::BN + ch * kPer;
        if (gk < K && gc < N)
          cp_async16(dst, Bg + static_cast<size_t>(gk) * N + gc);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int e = tid; e < kBK * T::BN; e += T::kThreads) {
        const int kk = e / T::BN, c = e % T::BN;
        const int gk = k0 + kk, gc = n0 + c;
        Bt[kk * T::BN + c] =
            (gk < K && gc < N) ? Bg[static_cast<size_t>(gk) * N + gc]
                               : SB(0);
      }
    }
  }
}

template <typename T, bool kVec, bool kNegPad = false, typename SB, int NB,
          typename Epi>
__device__ __forceinline__ void gemm_body(const void* __restrict__ A,
                                          const rt::CodeFormat& af,
                                          const Weights<SB, NB>& B, int M,
                                          int N, int K, const Epi& ep) {
  constexpr int RG = T::kRG, CG = T::kCG;
  constexpr int TM = 4 * RG, TN = 4 * CG, kRowStep = T::BM / RG;
  constexpr int S = T::kStages;
  extern __shared__ __align__(16) char smem[];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float acc[NB][TM][TN];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[nb][i][j] = 0.0f;

  const int nt = (K + kBK - 1) / kBK, K16 = (K + 15) & ~15;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nt)
      load_stage<T, SB, NB, kVec, kNegPad>(smem + s * T::kStageBytes, A, af,
                                           B, M, N, K, m0, n0, s * kBK);
    cp_commit();
  }
  for (int t = 0; t < nt; ++t) {
    // stage t has landed (at most S - 2 younger groups pending), and every
    // thread is done with stage t - 1, which the next load reuses
    cp_wait<S - 2>();
    __syncthreads();
    const int tn = t + S - 1;
    if (tn < nt)
      load_stage<T, SB, NB, kVec, kNegPad>(smem + (tn % S) * T::kStageBytes,
                                           A, af, B, M, N, K, m0, n0,
                                           tn * kBK);
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
        float b[NB][TN];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int h = 0; h < CG; ++h) {
            float q[4];
            widen4(Bs + nb * T::kBTile + (k4 + kk) * T::BN + 64 * h + 4 * tx,
                   q);
#pragma unroll
            for (int j = 0; j < 4; ++j) b[nb][4 * h + j] = q[j];
          }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[nb][i][j] = fmaf(a[i][kk], b[nb][j], acc[nb][i][j]);
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
          float v[NB][4];
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int j = 0; j < 4; ++j) v[nb][j] = acc[nb][4 * g + i][4 * h + j];
          ep.four(r, c0, v);
        }
      }
    }
}

template <typename T, bool kVec, typename SB, int NB, typename Epi>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
gemm_kernel(const void* __restrict__ A, rt::CodeFormat af, Weights<SB, NB> B,
            int M, int N, int K, Epi ep) {
  gemm_body<T, kVec>(A, af, B, M, N, K, ep);
}

// A stack of GEMMs of one weight operand: slice e = blockIdx.z reads A + e M
// K elements (A's storage af), B + e K N and stores through ep.slice(e).
// Every slice sums as gemm_kernel does, with A padded by -0 past K, so each
// chain equals one of exactly K steps (K8, qmatmul_batched_sr.cu).
template <typename T, bool kVec, typename SB, typename Epi>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
gemm_batched_kernel(const char* __restrict__ A, rt::CodeFormat af,
                    const SB* __restrict__ B, int M, int N, int K, Epi ep) {
  const size_t e = blockIdx.z;
  const size_t a_elt = af.bytes != 0 ? af.bytes : 4;
  const Weights<SB, 1> w{{B + e * K * N}};
  gemm_body<T, kVec, true>(A + e * M * K * a_elt, af, w, M, N, K,
                           ep.slice(e));
}

// ---------------------------------------------------------------------------
// Decode route
// ---------------------------------------------------------------------------
constexpr int kDRows = 4;               // rows of A per block: 8 lanes each
constexpr int kDWarps = 4;              // warps per operand: 8 columns each
constexpr int kDCols = 8 * kDWarps;     // columns per block
constexpr int kDStage = 64;             // rows of k per stage
constexpr int kDAS = kDStage + 4;       // A row stride in a stage (floats)
constexpr int kDBatch = 32;             // k rows whose operands load at once

// The decode route's stages of NB operands in a ring of S (each kernel's
// depth, measured: PERF.md).
template <typename SB, int NB, int S>
struct Dec {
  static constexpr int kStages = S;
  static constexpr int kThreads = 32 * kDWarps * NB;
  static constexpr int kBTile = kDStage * kDCols;   // elements per operand
  static constexpr int kBBytes = NB * kBTile * static_cast<int>(sizeof(SB));
  static constexpr int kABytes = kDRows * kDAS * 4;
  static constexpr int kStageBytes = kBBytes + kABytes;
  static constexpr int kSmem = S * kStageBytes;
  static_assert(kABytes % 16 == 0 && kBBytes % 16 == 0, "16-byte stages");
  static_assert(kSmem >= NB * kDRows * kDCols * 4, "room for the hand-off");
};

// One stage: for each operand B rows [k0, k0 + kDStage) x the block's
// kDCols columns into a (kDStage, kDCols) tile, then A rows [r0, r0 +
// kDRows) x k [k0, k0 + kDStage) into a (kDRows, kDAS) float tile; zeros
// past M, N and K.  kVec: 16-byte cp.async for B (and for a float32 A,
// 16-byte aligned with K % 4 == 0: a_vec), else element loads stored
// before the next barrier.
template <typename D, typename SB, int NB, bool kVec>
__device__ __forceinline__ void load_dec_stage(char* stage, const void* A,
                                               const rt::CodeFormat& af,
                                               bool a_vec,
                                               const Weights<SB, NB>& B,
                                               int M, int N, int K, int r0,
                                               int n0, int k0) {
  SB* Bs = reinterpret_cast<SB*>(stage);
  float* As = reinterpret_cast<float*>(stage + D::kBBytes);
  const int tid = threadIdx.x;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const SB* Bg = B.b[nb];
    SB* Bt = Bs + nb * D::kBTile;
    if constexpr (kVec) {
      constexpr int kPer = 16 / static_cast<int>(sizeof(SB));
      constexpr int kRowChunks = kDCols / kPer;
      for (int e = tid; e < kDStage * kRowChunks; e += D::kThreads) {
        const int kk = e / kRowChunks, ch = e % kRowChunks;
        const int gk = k0 + kk, gc = n0 + ch * kPer;
        SB* dst = Bt + kk * kDCols + ch * kPer;
        if (gk < K && gc < N)
          cp_async16(dst, Bg + static_cast<size_t>(gk) * N + gc);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int e = tid; e < kDStage * kDCols; e += D::kThreads) {
        const int kk = e / kDCols, c = e % kDCols;
        const int gk = k0 + kk, gc = n0 + c;
        Bt[kk * kDCols + c] =
            (gk < K && gc < N) ? Bg[static_cast<size_t>(gk) * N + gc]
                               : SB(0);
      }
    }
  }
  if (kVec && a_vec) {
    constexpr int kRowChunks = kDStage / 4;
    for (int e = tid; e < kDRows * kRowChunks; e += D::kThreads) {
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
    for (int e = tid; e < kDRows * kDStage; e += D::kThreads) {
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
// 8 (w % kDWarps) + cq] of operand w / kDWarps and its whole chain: the
// large-M route's order exactly.
template <typename D, bool kVec, typename SB, int NB, typename Epi>
__global__ void __launch_bounds__(D::kThreads)
decode_kernel(const void* __restrict__ A, rt::CodeFormat af, bool a_vec,
              Weights<SB, NB> B, int M, int N, int K, Epi ep) {
  constexpr int S = D::kStages;
  extern __shared__ __align__(16) char smem[];
  const int r0 = blockIdx.y * kDRows, n0 = blockIdx.x * kDCols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int op = NB > 1 ? warp / kDWarps : 0;
  const int rq = lane / 8, col = 8 * (warp % kDWarps) + lane % 8;
  const int nt = (K + kDStage - 1) / kDStage, K16 = (K + 15) & ~15;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nt)
      load_dec_stage<D, SB, NB, kVec>(smem + s * D::kStageBytes, A, af,
                                      a_vec, B, M, N, K, r0, n0,
                                      s * kDStage);
    cp_commit();
  }
  float acc = 0.0f;
  for (int t = 0; t < nt; ++t) {
    cp_wait<S - 2>();
    __syncthreads();
    const int tn = t + S - 1;
    if (tn < nt)
      load_dec_stage<D, SB, NB, kVec>(smem + (tn % S) * D::kStageBytes, A,
                                      af, a_vec, B, M, N, K, r0, n0,
                                      tn * kDStage);
    cp_commit();
    const char* stage = smem + (t % S) * D::kStageBytes;
    const SB* Bs = reinterpret_cast<const SB*>(stage) + op * D::kBTile + col;
    const float* As =
        reinterpret_cast<const float*>(stage + D::kBBytes) + rq * kDAS;
    // the chain runs over K rounded up to 16, not to kDStage; each batch's
    // operands are loaded into registers ahead of its dependent FMAs
    const int kend = min(kDStage, K16 - t * kDStage);
    if (kend == kDStage) {
#pragma unroll
      for (int k0 = 0; k0 < kDStage; k0 += kDBatch)
        chain_batch<kDBatch>(As + k0, Bs + k0 * kDCols, acc);
    } else {
      for (int k0 = 0; k0 < kend; k0 += 16)
        chain_batch<16>(As + k0, Bs + k0 * kDCols, acc);
    }
  }
  cp_wait<0>();

  float v[NB];
  v[0] = acc;
  if constexpr (NB > 1) {
    // operand op's sums to operand 0's lanes, through the drained ring
    float* hand = reinterpret_cast<float*>(smem);
    __syncthreads();
    if (op > 0) hand[(op * kDRows + rq) * kDCols + col] = acc;
    __syncthreads();
    if (op > 0) return;
#pragma unroll
    for (int nb = 1; nb < NB; ++nb)
      v[nb] = hand[(nb * kDRows + rq) * kDCols + col];
  }
  const int r = r0 + rq, c = n0 + col;
  if (r < M && c < N) ep.one(r, c, v);
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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Output tiles of a bm x bn tiling of (M, N).
inline long tiles_of(int M, int N, int bm, int bn) {
  return static_cast<long>((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

// The grids hold about a wave of blocks at this many tiles (of the 132
// SMs): a route takes the largest tile whose grid reaches it.
constexpr long kWaveTiles = 120;

template <typename T, bool kVec, typename SB, int NB, typename Epi>
int launch_gemm(const void* a, const rt::CodeFormat& af,
                const Weights<SB, NB>& b, int M, int N, int K, const Epi& ep,
                cudaStream_t s) {
  auto kernel = gemm_kernel<T, kVec, SB, NB, Epi>;
  if (const int e = allow_smem(kernel, T::kSmem)) return e;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  kernel<<<grid, T::kThreads, T::kSmem, s>>>(a, af, b, M, N, K, ep);
  return static_cast<int>(cudaGetLastError());
}

// gemm_batched_kernel over E slices.
template <typename T, bool kVec, typename SB, typename Epi>
int launch_gemm_batched(const void* a, const rt::CodeFormat& af, const SB* b,
                        int E, int M, int N, int K, const Epi& ep,
                        cudaStream_t s) {
  auto kernel = gemm_batched_kernel<T, kVec, SB, Epi>;
  if (const int e = allow_smem(kernel, T::kSmem)) return e;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, E);
  kernel<<<grid, T::kThreads, T::kSmem, s>>>(static_cast<const char*>(a), af,
                                             b, M, N, K, ep);
  return static_cast<int>(cudaGetLastError());
}

// The decode route with a ring of STAGES stages.
template <int STAGES, bool kVec, typename SB, int NB, typename Epi>
int launch_decode(const void* a, const rt::CodeFormat& af, bool a_vec,
                  const Weights<SB, NB>& b, int M, int N, int K,
                  const Epi& ep, cudaStream_t s) {
  using D = Dec<SB, NB, STAGES>;
  auto kernel = decode_kernel<D, kVec, SB, NB, Epi>;
  if (const int e = allow_smem(kernel, D::kSmem)) return e;
  const dim3 grid((N + kDCols - 1) / kDCols, (M + kDRows - 1) / kDRows);
  kernel<<<grid, D::kThreads, D::kSmem, s>>>(a, af, a_vec, b, M, N, K, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm
