// qmatmul_sr: float32 GEMM whose result is rounded onto a low-precision grid
// (the paper's eq. 8a at a GEMM site).
//
// Replaces the TPU kernel repro/kernels/qmatmul.py:qmatmul_prng_p (body
// _qmm2d), the q/k/v/o projections, FFN down projection and lm head of the
// serving path.  out[r, c] = round(sum_k a[r, k] * b[k, c]) with the rounding
// bits drawn in-kernel from Threefry keyed by the global (r, c), so the
// output does not depend on the tile size and equals the plain twin
// repro_torch.kernels.qmatmul.qmatmul_plain bit for bit on exact sums.
//
// What bounds it on an H100: at decode (M = 4) it reads every weight once
// and does 2 flops per weight element, so it is bound by bytes (the weight
// stream).  This first version is the simple, right kernel: CUDA-core fp32
// FMAs over 64x64 tiles with a 16-deep shared-memory stage; with M = 4 most
// of each tile's rows are padding.  Faster tilings for small M are later
// work.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "rounding.cuh"

namespace {

template <typename TB>
__global__ void __launch_bounds__(rt::kThreads)
qmatmul_sr_kernel(const float* __restrict__ a, const TB* __restrict__ b,
                  float* __restrict__ out, int M, int N, int K, uint32_t k0,
                  uint32_t k1, rt::RoundParams fwd) {
  const int m0 = blockIdx.y * rt::kBM, n0 = blockIdx.x * rt::kBN;
  const TB* bs[1] = {b};
  float acc[1][rt::kTM][rt::kTN];
  rt::gemm_tile<TB, 1>(a, bs, M, N, K, m0, n0, acc);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < rt::kTM; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < rt::kTN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N) {
        const uint32_t bits =
            fwd.mode == rt::kSR ? rt::element_bits(k0, k1, 0, fwd.rand_bits,
                                                   r, c)
                                : 0u;
        out[static_cast<size_t>(r) * N + c] =
            rt::round_value(acc[0][i][j], bits, fwd);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int qmatmul_sr(const float* a, const void* b, int b_is_bf16,
                          float* out, int M, int N, int K, uint32_t k0,
                          uint32_t k1, int precision, int emin, int emax,
                          float xmax, int mode, int rand_bits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const rt::RoundParams fwd{precision, emin, emax, xmax, mode, rand_bits, 1};
  const dim3 grid((N + rt::kBN - 1) / rt::kBN, (M + rt::kBM - 1) / rt::kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_is_bf16) {
    qmatmul_sr_kernel<__nv_bfloat16><<<grid, rt::kThreads, 0, s>>>(
        a, static_cast<const __nv_bfloat16*>(b), out, M, N, K, k0, k1, fwd);
  } else {
    qmatmul_sr_kernel<float><<<grid, rt::kThreads, 0, s>>>(
        a, static_cast<const float*>(b), out, M, N, K, k0, k1, fwd);
  }
  return static_cast<int>(cudaGetLastError());
}
