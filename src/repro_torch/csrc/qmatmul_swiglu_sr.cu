// qmatmul_swiglu_sr: the fused GLU-FFN prefix with rounded results,
//   h = round_act(silu(round(x @ wg)) * round(x @ wu)).
//
// Replaces the TPU kernel repro/kernels/qmatmul.py:qmatmul_swiglu_prng_p
// (body _qmm_swiglu), the FFN gate/up GEMMs + SiLU + activation-site
// rounding of the serving path.  Two accumulators share each staged x tile;
// the epilogue rounds the gate with seed pair 0 (stream 0), the up branch
// with seed pair 1 (stream 0), applies SiLU and the product, and rounds the
// hidden with seed pair 2 (stream 1) when the activation site is not the
// identity.  Bits are keyed by the global (row, col), as in qmatmul_sr.cu.
// For the backward pass (residuals) it also writes the rounded branches
// g_r and u_r as float32 (the reference's g_r/u_r outputs,
// repro/kernels/qmatmul.py:678-699).
//
// What bounds it on an H100: at decode it streams both weight matrices once
// (bytes); this first version uses the same simple CUDA-core tiling as
// qmatmul_sr and keeps the (M, d_ff) intermediates out of device memory.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "rounding.cuh"

namespace {

template <typename TB>
__global__ void __launch_bounds__(rt::kThreads)
qmatmul_swiglu_sr_kernel(const float* __restrict__ x,
                         const TB* __restrict__ wg, const TB* __restrict__ wu,
                         float* __restrict__ out, float* __restrict__ g_out,
                         float* __restrict__ u_out, int M, int N, int K,
                         uint32_t g0, uint32_t g1, uint32_t u0, uint32_t u1,
                         uint32_t a0, uint32_t a1, rt::RoundParams fwd,
                         rt::RoundParams act) {
  const int m0 = blockIdx.y * rt::kBM, n0 = blockIdx.x * rt::kBN;
  const TB* bs[2] = {wg, wu};
  float acc[2][rt::kTM][rt::kTN];
  rt::gemm_tile<TB, 2>(x, bs, M, N, K, m0, n0, acc);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool sr = fwd.mode == rt::kSR;
  const bool act_sr = act.enabled && act.mode == rt::kSR;
#pragma unroll
  for (int i = 0; i < rt::kTM; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < rt::kTN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N) {
        const uint32_t bg =
            sr ? rt::element_bits(g0, g1, 0, fwd.rand_bits, r, c) : 0u;
        const uint32_t bu =
            sr ? rt::element_bits(u0, u1, 0, fwd.rand_bits, r, c) : 0u;
        const float g_r = rt::round_value(acc[0][i][j], bg, fwd);
        const float u_r = rt::round_value(acc[1][i][j], bu, fwd);
        float h = __fmul_rn(rt::silu(g_r), u_r);
        if (act.enabled) {
          const uint32_t ba =
              act_sr ? rt::element_bits(a0, a1, 1, act.rand_bits, r, c) : 0u;
          h = rt::round_value(h, ba, act);
        }
        const size_t idx = static_cast<size_t>(r) * N + c;
        out[idx] = h;
        if (g_out != nullptr) {   // residuals for the backward pass
          g_out[idx] = g_r;
          u_out[idx] = u_r;
        }
      }
    }
  }
}

}  // namespace

// seeds: {gate k0, gate k1, up k0, up k1, act k0, act k1}; g_out/u_out:
// nullptr, or (M, N) float32 outputs for the rounded branches.  Launch on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int qmatmul_swiglu_sr(
    const float* x, const void* wg, const void* wu, int w_is_bf16, float* out,
    float* g_out, float* u_out, int M, int N, int K, uint32_t g0, uint32_t g1,
    uint32_t u0, uint32_t u1, uint32_t a0, uint32_t a1, int precision,
    int emin, int emax, float xmax, int mode, int rand_bits, int act_enabled,
    int act_precision, int act_emin, int act_emax, float act_xmax,
    int act_mode, int act_rand_bits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const rt::RoundParams fwd{precision, emin, emax, xmax, mode, rand_bits, 1};
  const rt::RoundParams act{act_precision, act_emin, act_emax, act_xmax,
                            act_mode, act_rand_bits, act_enabled};
  const dim3 grid((N + rt::kBN - 1) / rt::kBN, (M + rt::kBM - 1) / rt::kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    qmatmul_swiglu_sr_kernel<__nv_bfloat16><<<grid, rt::kThreads, 0, s>>>(
        x, static_cast<const __nv_bfloat16*>(wg),
        static_cast<const __nv_bfloat16*>(wu), out, g_out, u_out, M, N, K, g0,
        g1, u0, u1, a0, a1, fwd, act);
  } else {
    qmatmul_swiglu_sr_kernel<float><<<grid, rt::kThreads, 0, s>>>(
        x, static_cast<const float*>(wg), static_cast<const float*>(wu), out,
        g_out, u_out, M, N, K, g0, g1, u0, u1, a0, a1, fwd, act);
  }
  return static_cast<int>(cudaGetLastError());
}
