// The float32 GEMM main loop shared by the rounded-GEMM kernels.
//
// One 256-thread block computes a 64x64 output tile; the whole K loop runs
// inside the block (no carry across blocks), staging a 64x16 tile of A and
// one 16x64 tile of each B operand in shared memory per step.  Thread
// (ty, tx) = (tid / 16, tid % 16) owns the 4x4 outputs at rows ty + 16 i and
// columns tx + 16 j, so neighbouring threads store neighbouring columns.
// Ragged M/N/K edges are masked to zero on load; the epilogue masks stores.
//
// Plain fp32 FMAs on the CUDA cores: no TF32 and no tensor cores, because
// TF32 would change the values the reference computes.  B may be float32 or
// bfloat16 (weights rounded to bf16 once at load; the upcast is exact).  A
// may be float32 or the code words of one grid (uint8 or uint16: the
// reference's a_fmt), decoded to their exact float32 values as they are
// staged into shared memory, so a packed A sums exactly as its float32
// values would.  Loads are element by element: any alignment will do.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "rounding.cuh"

namespace rt {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256, kTM = 4, kTN = 4;

__device__ __forceinline__ float load_b(const float* p) { return *p; }
__device__ __forceinline__ float load_b(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// An A element as float32: a float32 as it is, a code word decoded with
// `pack`.  The load itself stays an index of the restrict-qualified A.
__device__ __forceinline__ float decode_a(float v, const PackParams&) {
  return v;
}
__device__ __forceinline__ float decode_a(uint8_t c, const PackParams& p) {
  return unpack(c, p);
}
__device__ __forceinline__ float decode_a(uint16_t c, const PackParams& p) {
  return unpack(c, p);
}

// acc[b][i][j] += sum_k A[m0 + ty + 16 i, k] * B_b[k, n0 + tx + 16 j]
template <typename TA, typename TB, int NB>
__device__ __forceinline__ void gemm_tile(const TA* __restrict__ A,
                                          const PackParams& a_pack,
                                          const TB* const* Bs_global,
                                          int M, int N, int K, int m0, int n0,
                                          float (&acc)[NB][kTM][kTN]) {
  __shared__ float As[kBK][kBM];
  __shared__ float Bs[NB][kBK][kBN];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[b][i][j] = 0.0f;

  constexpr int kLA = (kBM * kBK) / kThreads, kLB = (kBK * kBN) / kThreads;
  for (int kb = 0; kb < K; kb += kBK) {
    // each operand's global loads are all issued before its shared-memory
    // stores, so they are in flight together: with few blocks (decode, M =
    // 4) the loop is bound by their latency (PERF.md, PR 16; the summation
    // order is untouched)
    float av[kLA], bv[NB][kLB];
#pragma unroll
    for (int l = 0; l < kLA; ++l) {
      const int e = tid + kThreads * l;
      const int gr = m0 + e / kBK, gc = kb + e % kBK;
      av[l] = (gr < M && gc < K)
                  ? decode_a(A[static_cast<size_t>(gr) * K + gc], a_pack)
                  : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < kLA; ++l) {
      const int e = tid + kThreads * l;
      As[e % kBK][e / kBK] = av[l];
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int l = 0; l < kLB; ++l) {
        const int e = tid + kThreads * l;
        const int gr = kb + e / kBN, gc = n0 + e % kBN;
        bv[b][l] = (gr < K && gc < N)
            ? load_b(Bs_global[b] + static_cast<size_t>(gr) * N + gc)
            : 0.0f;
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int l = 0; l < kLB; ++l) {
        const int e = tid + kThreads * l;
        Bs[b][e / kBN][e % kBN] = bv[b][l];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const float bv = Bs[b][kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kTM; ++i)
            acc[b][i][j] = fmaf(a[i], bv, acc[b][i][j]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace rt
