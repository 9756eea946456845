// qmatmul_batched_sr: a batch of float32 GEMMs whose results are rounded
// onto a low-precision grid (the paper's eq. 8a at a batched GEMM site: the
// MoE layer's stacked expert GEMMs).
//
// Replaces the TPU kernel repro/kernels/qmatmul.py:qmatmul_batched_prng_p
// (body _qmmb).  out[e, r, c] = round(sum_k a[e, r, k] * b[e, k, c]) with
// the rounding bits drawn in-kernel from Threefry keyed by slice e's own
// seed words seeds[e] and the within-slice (r, c), stream 0
// (rounding.cuh:element_bits), so every slice owns an independent stream
// and the output does not depend on the tiling; it equals the plain twin
// repro_torch.kernels.qmatmul.qmatmul_batched_plain bit for bit on exact
// sums.
//
// What bounds it on an H100: on the serving path every slice is a GEMV
// (M = 1 row per expert at decode), so it streams each expert weight once
// for 2 flops per element: bound by bytes.  This first version is the
// simple kernel for that shape: one 128-thread block per (slice, 128
// columns, TM rows); consecutive threads own consecutive columns, so each
// k row of b is read coalesced; a's TM rows are staged in shared memory in
// chunks of kKC; every thread sums its columns over k ascending with fp32
// FMAs (the order K3' uses), on the CUDA cores.  B may be float32 or
// bfloat16: stored bf16 expert weights are widened in registers, which is
// exact, so no float32 copy of the experts is ever made.  Larger M tiles
// rows TM at a time and re-reads b once per tile; wgmma, TMA and split-K
// are later work.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "rounding.cuh"

namespace {

constexpr int kCols = 128;   // threads per block = columns per block
constexpr int kKC = 256;     // k values of a staged per step

template <typename TB, int TM>
__global__ void __launch_bounds__(kCols)
qmatmul_batched_sr_kernel(const float* __restrict__ a,
                          const TB* __restrict__ b,
                          const uint32_t* __restrict__ seeds,
                          float* __restrict__ out, int M, int N, int K,
                          rt::RoundParams fwd) {
  __shared__ float as[TM][kKC];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * TM;
  const int col = blockIdx.x * kCols + threadIdx.x;
  const float* ae = a + static_cast<size_t>(e) * M * K;
  const TB* be = b + static_cast<size_t>(e) * K * N;

  float acc[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) acc[m] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kc = min(kKC, K - k0);
    for (int idx = threadIdx.x; idx < TM * kKC; idx += kCols) {
      const int m = idx / kKC, kk = idx % kKC;
      as[m][kk] = (m0 + m < M && kk < kc)
                      ? ae[static_cast<size_t>(m0 + m) * K + k0 + kk]
                      : 0.0f;
    }
    __syncthreads();
    if (col < N) {
      const TB* bp = be + static_cast<size_t>(k0) * N + col;
#pragma unroll 8
      for (int kk = 0; kk < kc; ++kk) {
        const float bv = rt::load_b(bp + static_cast<size_t>(kk) * N);
#pragma unroll
        for (int m = 0; m < TM; ++m) acc[m] = fmaf(as[m][kk], bv, acc[m]);
      }
    }
    __syncthreads();
  }

  if (col >= N) return;
  const uint32_t w0 = seeds[2 * e], w1 = seeds[2 * e + 1];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = m0 + m;
    if (r < M) {
      const uint32_t bits =
          fwd.mode == rt::kSR
              ? rt::element_bits(w0, w1, 0, fwd.rand_bits, r, col)
              : 0u;
      out[(static_cast<size_t>(e) * M + r) * N + col] =
          rt::round_value(acc[m], bits, fwd);
    }
  }
}

template <typename TB, int TM>
void launch(const float* a, const void* b, const uint32_t* seeds, float* out,
            int E, int M, int N, int K, const rt::RoundParams& fwd,
            cudaStream_t s) {
  const dim3 grid((N + kCols - 1) / kCols, (M + TM - 1) / TM, E);
  qmatmul_batched_sr_kernel<TB, TM><<<grid, kCols, 0, s>>>(
      a, static_cast<const TB*>(b), seeds, out, M, N, K, fwd);
}

template <typename TB>
void launch_rows(const float* a, const void* b, const uint32_t* seeds,
                 float* out, int E, int M, int N, int K,
                 const rt::RoundParams& fwd, cudaStream_t s) {
  if (M == 1) {
    launch<TB, 1>(a, b, seeds, out, E, M, N, K, fwd, s);
  } else {
    launch<TB, 4>(a, b, seeds, out, E, M, N, K, fwd, s);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// seeds: (E, 2) uint32 on the device, slice e's words at 2e and 2e + 1.
extern "C" int qmatmul_batched_sr(const float* a, const void* b,
                                  int b_is_bf16, const uint32_t* seeds,
                                  float* out, int E, int M, int N, int K,
                                  int precision, int emin, int emax,
                                  float xmax, int mode, int rand_bits,
                                  void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  const rt::RoundParams fwd{precision, emin, emax, xmax, mode, rand_bits, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_is_bf16) {
    launch_rows<__nv_bfloat16>(a, b, seeds, out, E, M, N, K, fwd, s);
  } else {
    launch_rows<float>(a, b, seeds, out, E, M, N, K, fwd, s);
  }
  return static_cast<int>(cudaGetLastError());
}
