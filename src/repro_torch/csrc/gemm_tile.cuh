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
// bfloat16 (weights rounded to bf16 once at load; the upcast is exact).
#pragma once

#include <cuda_bf16.h>

namespace rt {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256, kTM = 4, kTN = 4;

__device__ __forceinline__ float load_b(const float* p) { return *p; }
__device__ __forceinline__ float load_b(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// acc[b][i][j] += sum_k A[m0 + ty + 16 i, k] * B_b[k, n0 + tx + 16 j]
template <typename TB, int NB>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A,
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

  for (int kb = 0; kb < K; kb += kBK) {
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kThreads; ++l) {
      const int e = tid + kThreads * l;
      const int r = e / kBK, c = e % kBK;
      const int gr = m0 + r, gc = kb + c;
      As[c][r] = (gr < M && gc < K) ? A[static_cast<size_t>(gr) * K + gc]
                                    : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int l = 0; l < (kBK * kBN) / kThreads; ++l) {
        const int e = tid + kThreads * l;
        const int r = e / kBN, c = e % kBN;
        const int gr = kb + r, gc = n0 + c;
        Bs[b][r][c] = (gr < K && gc < N)
            ? load_b(Bs_global[b] + static_cast<size_t>(gr) * N + gc)
            : 0.0f;
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
