// fused_qupdate: the paper's eq.-8 rounded gradient-descent update over a
// flat float32 parameter vector, in one pass:
//
//   g_hat = Q1(g)              (8a)
//   upd   = Q2(t * g_hat)      (8b)
//   x_new = Q3(x - upd)        (8c, signed-SRe biased by sign(g_hat))
//
// Two entry points:
//   fused_qupdate_prng -- K2', replaces repro/kernels/fused_update.py:
//     fused_qupdate_prng_p.  The random bits are drawn in-kernel: element n
//     sits at (row, col) = (n / 128, n % 128) of the reference's (rows, 128)
//     layout, and the stochastic steps take, in order, word 0 and word 1 of
//     threefry(k0, k1, row, col), then word 0 of
//     threefry(k0, k1 + golden, row, col) (kernel_bits3's pair streams), so
//     the result equals the plain twin and the reference's interpret mode.
//   fused_qupdate_bits -- K2, replaces fused_update.py:fused_qupdate_p.  The
//     three bit planes are an explicit uint32 (3, n) operand.
//
// and the optimizer's momentum step beside them:
//   momentum_fma -- out = a * m + g with one rounding (__fmaf_rn), as the
//     reference's compiled step contracts `momentum * m + g`
//     (repro/optim/sgd.py); float32 subnormal operands count as zero and
//     subnormal results flush to zero, as on XLA's CPU backend.
//
// The chain uses __fmul_rn / __fadd_rn so that t * g_hat and x - upd are
// two roundings, never one FMA.  Indices are 64-bit (n reaches ~1.1e9).
//
// What bounds it on an H100: K2' moves 12 bytes per element (x, g in, x_new
// out) and K2 24; K2' also runs one Threefry-2x32 (~80 integer operations)
// per element for every two stochastic steps, which at the card's int32
// rate costs about as much as the bytes.  This first version is one thread
// per element in a grid-stride loop with plain 4-byte loads.
#include <cuda_runtime.h>

#include <cstdint>

#include "rounding.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;   // the reference's (rows, 128) flat layout

// Bias-direction sources of GDRounding's *_v fields.
enum VSource : int { kSelf = 0, kGrad = 1, kNegGrad = 2 };

struct Chain {
  rt::RoundParams grad, mul, sub;
  int grad_v, mul_v, sub_v;
};

__device__ __forceinline__ float sign_v(int source, float g) {
  if (source == kGrad) return rt::sign_of(g);
  if (source == kNegGrad) return rt::sign_of(-g);
  return 0.0f;
}

__device__ __forceinline__ bool stochastic(const rt::RoundParams& p) {
  return p.enabled && p.mode != rt::kRN;
}

__device__ __forceinline__ float update_chain(const Chain& c, float x,
                                              float g, float t, uint32_t b1,
                                              uint32_t b2, uint32_t b3) {
  const float g_hat = rt::apply_site(g, b1, c.grad, sign_v(c.grad_v, g));
  const float upd = rt::apply_site(__fmul_rn(t, g_hat), b2, c.mul,
                                   sign_v(c.mul_v, g_hat));
  const float z = __fadd_rn(x, -upd);
  return rt::apply_site(z, b3, c.sub, sign_v(c.sub_v, g_hat));
}

__global__ void __launch_bounds__(kThreads)
fused_qupdate_prng_kernel(const float* x,
                          const float* __restrict__ g, float* out, int64_t n,
                          float t, uint32_t k0, uint32_t k1, Chain c) {
  const bool need[3] = {stochastic(c.grad), stochastic(c.mul),
                        stochastic(c.sub)};
  const int n_stoch = int(need[0]) + int(need[1]) + int(need[2]);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t row = static_cast<uint32_t>(i / kLanes);
    const uint32_t col = static_cast<uint32_t>(i % kLanes);
    // words in the order the stochastic steps consume them
    uint32_t q0 = 0u, q1 = 0u, q2 = 0u, unused;
    if (n_stoch > 0) rt::threefry2x32(k0, k1, row, col, q0, q1);
    if (n_stoch > 2)
      rt::threefry2x32(k0, k1 + rt::kGolden, row, col, q2, unused);
    uint32_t b1 = 0u, b2 = 0u, b3 = 0u;
    if (need[0]) { b1 = q0; q0 = q1; q1 = q2; }
    if (need[1]) { b2 = q0; q0 = q1; }
    if (need[2]) b3 = q0;
    out[i] = update_chain(c, x[i], g[i], t, b1, b2, b3);
  }
}

__global__ void __launch_bounds__(kThreads)
fused_qupdate_bits_kernel(const float* x,
                          const float* __restrict__ g,
                          const uint32_t* __restrict__ bits3, float* out,
                          int64_t n, float t, Chain c) {
  const bool need[3] = {stochastic(c.grad), stochastic(c.mul),
                        stochastic(c.sub)};
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t b1 = need[0] ? bits3[i] : 0u;
    const uint32_t b2 = need[1] ? bits3[n + i] : 0u;
    const uint32_t b3 = need[2] ? bits3[2 * n + i] : 0u;
    out[i] = update_chain(c, x[i], g[i], t, b1, b2, b3);
  }
}

__device__ __forceinline__ float flush_subnormal(float v) {
  return fabsf(v) < rt::kTiny ? __fmul_rn(v, 0.0f) : v;   // keeps the sign
}

__global__ void __launch_bounds__(kThreads)
momentum_fma_kernel(const float* __restrict__ m,
                    const float* __restrict__ g, float* out, int64_t n,
                    float a) {
  a = flush_subnormal(a);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = flush_subnormal(
        __fmaf_rn(a, flush_subnormal(m[i]), flush_subnormal(g[i])));
}

// site[8] = {enabled, precision, emin, emax, mode, rand_bits, v_source,
//            unused}; xmax[i] / eps[i] alongside.
Chain make_chain(const int* sites, const float* xmax, const float* eps) {
  Chain c;
  rt::RoundParams* ps[3] = {&c.grad, &c.mul, &c.sub};
  int* vs[3] = {&c.grad_v, &c.mul_v, &c.sub_v};
  for (int s = 0; s < 3; ++s) {
    const int* q = sites + 8 * s;
    *ps[s] = rt::RoundParams{q[1], q[2], q[3], xmax[s], q[4], q[5], q[0],
                             eps[s]};
    *vs[s] = q[6];
  }
  return c;
}

unsigned grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 64;   // a few waves of resident blocks
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

}  // namespace

// K2'.  sites: int[24], xmax/eps: float[3] (grad, mul, sub).  Launch on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fused_qupdate_prng(const float* x, const float* g, float* out,
                                  int64_t n, float t, uint32_t k0,
                                  uint32_t k1, const int* sites,
                                  const float* xmax, const float* eps,
                                  void* stream) {
  if (n <= 0) return 0;
  const Chain c = make_chain(sites, xmax, eps);
  fused_qupdate_prng_kernel<<<grid_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, g, out, n, t, k0, k1, c);
  return static_cast<int>(cudaGetLastError());
}

// K2.  bits3: uint32 (3, n), row s read only where step s is stochastic.
extern "C" int fused_qupdate_bits(const float* x, const float* g,
                                  const uint32_t* bits3, float* out,
                                  int64_t n, float t, const int* sites,
                                  const float* xmax, const float* eps,
                                  void* stream) {
  if (n <= 0) return 0;
  const Chain c = make_chain(sites, xmax, eps);
  fused_qupdate_bits_kernel<<<grid_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, g, bits3, out, n, t, c);
  return static_cast<int>(cudaGetLastError());
}

// out = a * m + g, one rounding (m, g, out: float32 of n elements).
extern "C" int momentum_fma(const float* m, const float* g, float* out,
                            int64_t n, float a, void* stream) {
  if (n <= 0) return 0;
  momentum_fma_kernel<<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(m, g, out, n, a);
  return static_cast<int>(cudaGetLastError());
}
