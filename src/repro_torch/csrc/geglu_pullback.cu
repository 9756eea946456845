// geglu_pullback: the GeGLU FFN's backward at its activation, one thread
// per element.  From the rounded gate g_r, the rounded up branch u_r and
// the hidden's cotangent dh (float32, one shape):
//   ct    = dh * u_r
//   dgate = the pullback of jax.nn.gelu at g_r, applied to ct
//   dup   = dh * gelu(g_r)
// as the reference's _qffn_glu_bwd computes them (repro/precision/fused.py:
// jax.vjp(ACT_FNS["gelu"], g_v) in its compiled step, XLA's CPU float32
// code).  The plain twin:
// repro_torch/kernels/geglu_pullback.py:geglu_pullback_plain.
//
// Replaces no Pallas kernel: the reference leaves this elementwise pullback
// to XLA.  It is a kernel because its twin emulates XLA's fused
// multiply-adds in float64 passes (core/fma.py) that synchronise with the
// host on every call, over 1024 x 24576 elements per layer of a gemma-7b
// train step.
//
// The float operations are XLA's, found bitwise on 350,000 inputs: with
// x = g_r, c = float32(sqrt(2 / pi)), x2 = x x and t = tanh(fma(0.044715,
// x2 x, x) c) (XLA's tanh, rounding.cuh:tanh_xla), cdf = (t + 1) 0.5,
//   m6 = ((x ct) 0.5) (1 - t),  a2 = fma(m6, t, m6),
//   a1 = fma(ct, cdf, a2 c),    dx = fma(a2 k, x2 3, a1),
// k = float32(c 0.044715) (XLA folds the two constants into one); every
// operand and result flushed below 2^-126, as XLA's CPU backend does.
//
// What bounds it on an H100: 20 bytes per element (three reads, two
// writes) against ~40 float operations and a division, so bytes; a grid-
// stride loop of 4-byte accesses.
#include <cuda_runtime.h>

#include <cstdint>

#include "rounding.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kC = 0x1.988454p-1f;    // float32(sqrt(2 / pi))
constexpr float kCK = 0x1.2444f2p-5f;   // float32(kC * 0.044715f)

using rt::ftz;

__global__ void __launch_bounds__(kThreads)
geglu_pullback_kernel(const float* __restrict__ g,
                      const float* __restrict__ u,
                      const float* __restrict__ dh, float* dgate, float* dup,
                      int64_t n) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x = ftz(g[i]);
    const float h = ftz(dh[i]);
    const float ct = ftz(__fmul_rn(h, ftz(u[i])));
    const float x2 = ftz(__fmul_rn(x, x));
    const float inner = ftz(__fmaf_rn(0.044715f, ftz(__fmul_rn(x2, x)), x));
    const float t = rt::tanh_xla(ftz(__fmul_rn(inner, kC)));
    const float cdf = ftz(__fmul_rn(ftz(__fadd_rn(t, 1.0f)), 0.5f));
    const float m6 = ftz(__fmul_rn(ftz(__fmul_rn(ftz(__fmul_rn(x, ct)), 0.5f)),
                                   ftz(__fsub_rn(1.0f, t))));
    const float a2 = ftz(__fmaf_rn(m6, t, m6));
    const float a1 = ftz(__fmaf_rn(ct, cdf, ftz(__fmul_rn(a2, kC))));
    dgate[i] = ftz(__fmaf_rn(ftz(__fmul_rn(a2, kCK)),
                             ftz(__fmul_rn(x2, 3.0f)), a1));
    dup[i] = ftz(__fmul_rn(h, ftz(__fmul_rn(x, cdf))));
  }
}

}  // namespace

// dgate and dup from g, u, dh, all float32 of n elements.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int geglu_pullback(const float* g, const float* u,
                              const float* dh, float* dgate, float* dup,
                              int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  geglu_pullback_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(g, u, dh,
                                                               dgate, dup, n);
  return static_cast<int>(cudaGetLastError());
}
