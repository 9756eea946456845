// qmatmul_swiglu_sr / qmatmul_swiglu_bits: the fused GLU-FFN prefix with
// rounded results,
//   h = round_act(silu(round(x @ wg)) * round(x @ wu)).
//
// Two entry points share one kernel body (one main loop, one summation
// order):
//   qmatmul_swiglu_sr   -- K4', replaces repro/kernels/qmatmul.py:
//     qmatmul_swiglu_prng_p (body _qmm_swiglu): the gate rounds with seed
//     pair 0 (stream 0), the up branch with seed pair 1 (stream 0), the
//     hidden with seed pair 2 (stream 1), each bit keyed by the global
//     (row, col) as in qmatmul_sr.cu;
//   qmatmul_swiglu_bits -- K4, replaces qmatmul.py:qmatmul_swiglu_p: the
//     words come from (M, N) uint32 operands bits_g, bits_u and, when the
//     activation site is stochastic, act_bits.
// Two accumulators share each staged x tile; the epilogue rounds both
// branches, applies SiLU and the product, and rounds the hidden when the
// activation site is not the identity.  For the backward pass (residuals)
// it also writes the rounded branches g_r and u_r (the reference's
// outputs, repro/kernels/qmatmul.py:678-699).
//
// Storage: h may leave as float32 or packed as code words of the act grid
// (out_packed, the reference's _resolve_epilogue); g_r and u_r as float32
// or code words of the GEMM grid (residuals_packed).  Every stored value
// is already on its grid, so packing loses nothing.  Stores are element
// by element: no output needs any alignment.
//
// What bounds it on an H100: at decode it streams both weight matrices once
// (bytes); K4's bits add 8 bytes per output element (12 with a stochastic
// act site), small beside the weights at decode.  This first version uses
// the same simple CUDA-core tiling as qmatmul_sr and keeps the (M, d_ff)
// intermediates out of device memory.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
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

template <typename TB>
__global__ void __launch_bounds__(rt::kThreads)
qmatmul_swiglu_kernel(const float* __restrict__ x,
                      const TB* __restrict__ wg, const TB* __restrict__ wu,
                      Bits bits, Seeds sd, void* __restrict__ out,
                      rt::CodeFormat out_fmt, void* __restrict__ g_out,
                      void* __restrict__ u_out, rt::CodeFormat res_fmt,
                      int M, int N, int K, rt::RoundParams fwd,
                      rt::RoundParams act) {
  const int m0 = blockIdx.y * rt::kBM, n0 = blockIdx.x * rt::kBN;
  const TB* bs[2] = {wg, wu};
  float acc[2][rt::kTM][rt::kTN];
  rt::gemm_tile<float, TB, 2>(x, rt::PackParams{0, 0, 0, 0}, bs, M, N, K,
                              m0, n0, acc);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool sr = fwd.mode == rt::kSR;
  const bool act_sr = act.enabled && act.mode == rt::kSR;
  const bool explicit_bits = bits.on != 0;
#pragma unroll
  for (int i = 0; i < rt::kTM; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < rt::kTN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N) {
        const size_t idx = static_cast<size_t>(r) * N + c;
        uint32_t bg = 0u, bu = 0u;
        if (sr && explicit_bits) {
          bg = bits.g[idx];
          bu = bits.u[idx];
        } else if (sr) {
          bg = rt::element_bits(sd.g0, sd.g1, 0, fwd.rand_bits, r, c);
          bu = rt::element_bits(sd.u0, sd.u1, 0, fwd.rand_bits, r, c);
        }
        const float g_r = rt::round_value(acc[0][i][j], bg, fwd);
        const float u_r = rt::round_value(acc[1][i][j], bu, fwd);
        float h = __fmul_rn(rt::silu(g_r), u_r);
        if (act.enabled) {
          uint32_t ba = 0u;
          if (act_sr) {
            ba = explicit_bits
                     ? bits.act[idx]
                     : rt::element_bits(sd.a0, sd.a1, 1, act.rand_bits, r,
                                        c);
          }
          h = rt::round_value(h, ba, act);
        }
        rt::store_code(out, idx, h, out_fmt);
        if (g_out != nullptr) {   // residuals for the backward pass
          rt::store_code(g_out, idx, g_r, res_fmt);
          rt::store_code(u_out, idx, u_r, res_fmt);
        }
      }
    }
  }
}

int run(const float* x, const void* wg, const void* wu, int w_is_bf16,
        const Bits& bits, const Seeds& sd, void* out, const int* out_fmt,
        void* g_out, void* u_out, const int* res_fmt, int M, int N, int K,
        const int* fwd_site, float xmax, const int* act_site, float act_xmax,
        void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const rt::RoundParams fwd{fwd_site[0], fwd_site[1], fwd_site[2], xmax,
                            fwd_site[3], fwd_site[4], 1};
  const rt::RoundParams act{act_site[1], act_site[2], act_site[3], act_xmax,
                            act_site[4], act_site[5], act_site[0]};
  const rt::CodeFormat of = rt::code_format(out_fmt);
  const rt::CodeFormat rf = rt::code_format(res_fmt);
  const dim3 grid((N + rt::kBN - 1) / rt::kBN, (M + rt::kBM - 1) / rt::kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    qmatmul_swiglu_kernel<__nv_bfloat16><<<grid, rt::kThreads, 0, s>>>(
        x, static_cast<const __nv_bfloat16*>(wg),
        static_cast<const __nv_bfloat16*>(wu), bits, sd, out, of, g_out,
        u_out, rf, M, N, K, fwd, act);
  } else {
    qmatmul_swiglu_kernel<float><<<grid, rt::kThreads, 0, s>>>(
        x, static_cast<const float*>(wg), static_cast<const float*>(wu),
        bits, sd, out, of, g_out, u_out, rf, M, N, K, fwd, act);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4'.  seeds: {gate k0, gate k1, up k0, up k1, act k0, act k1};
// fwd_site: int[5] {precision, emin, emax, mode, rand_bits}; act_site:
// int[6] {enabled, precision, emin, emax, mode, rand_bits}; out_fmt /
// res_fmt: int[7] storage (null: float32); g_out/u_out: nullptr, or (M, N)
// outputs for the rounded branches.  Launch on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int qmatmul_swiglu_sr(
    const float* x, const void* wg, const void* wu, int w_is_bf16,
    const uint32_t* seeds, void* out, const int* out_fmt, void* g_out,
    void* u_out, const int* res_fmt, int M, int N, int K,
    const int* fwd_site, float xmax, const int* act_site, float act_xmax,
    void* stream) {
  const Seeds sd{seeds[0], seeds[1], seeds[2], seeds[3], seeds[4], seeds[5]};
  return run(x, wg, wu, w_is_bf16, Bits{0, nullptr, nullptr, nullptr}, sd,
             out, out_fmt, g_out, u_out, res_fmt, M, N, K, fwd_site, xmax,
             act_site, act_xmax, stream);
}

// K4.  bits_g, bits_u: (M, N) uint32 on the device (read only under sr);
// act_bits: (M, N) uint32, read only when the act site is stochastic.
extern "C" int qmatmul_swiglu_bits(
    const float* x, const void* wg, const void* wu, int w_is_bf16,
    const uint32_t* bits_g, const uint32_t* bits_u, const uint32_t* act_bits,
    void* out, const int* out_fmt, void* g_out, void* u_out,
    const int* res_fmt, int M, int N, int K, const int* fwd_site, float xmax,
    const int* act_site, float act_xmax, void* stream) {
  return run(x, wg, wu, w_is_bf16, Bits{1, bits_g, bits_u, act_bits},
             Seeds{0, 0, 0, 0, 0, 0}, out, out_fmt, g_out, u_out, res_fmt, M,
             N, K, fwd_site, xmax, act_site, act_xmax, stream);
}
