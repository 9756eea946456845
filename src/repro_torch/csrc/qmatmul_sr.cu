// qmatmul_sr / qmatmul_bits: float32 GEMM whose result is rounded onto a
// low-precision grid (the paper's eq. 8a at a GEMM site).
//
// Two entry points share one kernel body, so they run one main loop and
// sum in one order:
//   qmatmul_sr   -- K3', replaces repro/kernels/qmatmul.py:qmatmul_prng_p
//     (body _qmm2d): the rounding bits of out[r, c] are drawn in-kernel
//     from Threefry keyed by the global (r, c) (rounding.cuh:element_bits);
//   qmatmul_bits -- K3, replaces qmatmul.py:qmatmul_p (the explicit-bits
//     "oracle" flavour): out[r, c] takes word (r, c) of an (M, N) uint32
//     bits operand (with rand_bits < 32 its low bits).
// out[r, c] = round(sum_k a[r, k] * b[k, c]).  Fed the words the in-kernel
// draw would make (counter_bits_reduced), K3 equals K3' bit for bit.  The
// output does not depend on the tile size, and equals the plain twins
// repro_torch.kernels.qmatmul.qmatmul_plain / qmatmul_bits_plain bit for
// bit on exact sums.
//
// Storage (the reference's shared epilogue, qmatmul.py:_emit_value): A may
// be float32 or the code words of a grid (a_fmt), decoded as it is staged
// (gemm_tile.cuh); the output may be float32 or the rounded values packed
// as code words of the GEMM's grid (out_packed, rounding.cuh:pack_code).
// The wrappers pass each storage as an int[7] (rounding.cuh:code_format).
// Loads and stores are element by element, so no operand needs any
// alignment.
//
// What bounds it on an H100: at decode (M = 4) it reads every weight once
// and does 2 flops per weight element, so it is bound by bytes (the weight
// stream); K3's bits add 4 bytes per output element, small beside the
// weights.  This first version is the simple, right kernel: CUDA-core fp32
// FMAs over 64x64 tiles with a 16-deep shared-memory stage; with M = 4 most
// of each tile's rows are padding.  Faster tilings for small M are later
// work.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "rounding.cuh"

namespace {

// bits == nullptr: draw in-kernel (K3'); else read word (r, c) (K3).
template <typename TA, typename TB>
__global__ void __launch_bounds__(rt::kThreads)
qmatmul_kernel(const TA* __restrict__ a, rt::PackParams a_pack,
               const TB* __restrict__ b, const uint32_t* __restrict__ bits,
               void* __restrict__ out, rt::CodeFormat out_fmt, int M, int N,
               int K, uint32_t k0, uint32_t k1, rt::RoundParams fwd) {
  const int m0 = blockIdx.y * rt::kBM, n0 = blockIdx.x * rt::kBN;
  const TB* bs[1] = {b};
  float acc[1][rt::kTM][rt::kTN];
  rt::gemm_tile<TA, TB, 1>(a, a_pack, bs, M, N, K, m0, n0, acc);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool sr = fwd.mode == rt::kSR;
#pragma unroll
  for (int i = 0; i < rt::kTM; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < rt::kTN; ++j) {
      const int c = n0 + tx + 16 * j;
      if (r < M && c < N) {
        const size_t idx = static_cast<size_t>(r) * N + c;
        uint32_t w = 0u;
        if (sr) {
          w = bits != nullptr
                  ? bits[idx]
                  : rt::element_bits(k0, k1, 0, fwd.rand_bits, r, c);
        }
        rt::store_code(out, idx, rt::round_value(acc[0][i][j], w, fwd),
                       out_fmt);
      }
    }
  }
}

template <typename TA, typename TB>
void launch(const void* a, const rt::CodeFormat& af, const void* b,
            const uint32_t* bits, void* out, const rt::CodeFormat& of, int M,
            int N, int K, uint32_t k0, uint32_t k1, const rt::RoundParams& fwd,
            cudaStream_t s) {
  const dim3 grid((N + rt::kBN - 1) / rt::kBN, (M + rt::kBM - 1) / rt::kBM);
  qmatmul_kernel<TA, TB><<<grid, rt::kThreads, 0, s>>>(
      static_cast<const TA*>(a), af.pack, static_cast<const TB*>(b), bits,
      out, of, M, N, K, k0, k1, fwd);
}

template <typename TB>
void launch_a(const void* a, const rt::CodeFormat& af, const void* b,
              const uint32_t* bits, void* out, const rt::CodeFormat& of,
              int M, int N, int K, uint32_t k0, uint32_t k1,
              const rt::RoundParams& fwd, cudaStream_t s) {
  if (af.bytes == 1) {
    launch<uint8_t, TB>(a, af, b, bits, out, of, M, N, K, k0, k1, fwd, s);
  } else if (af.bytes == 2) {
    launch<uint16_t, TB>(a, af, b, bits, out, of, M, N, K, k0, k1, fwd, s);
  } else {
    launch<float, TB>(a, af, b, bits, out, of, M, N, K, k0, k1, fwd, s);
  }
}

int run(const void* a, const int* a_fmt, const void* b, int b_is_bf16,
        const uint32_t* bits, void* out, const int* out_fmt, int M, int N,
        int K, uint32_t k0, uint32_t k1, int precision, int emin, int emax,
        float xmax, int mode, int rand_bits, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const rt::RoundParams fwd{precision, emin, emax, xmax, mode, rand_bits, 1};
  const rt::CodeFormat af = rt::code_format(a_fmt);
  const rt::CodeFormat of = rt::code_format(out_fmt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_is_bf16) {
    launch_a<__nv_bfloat16>(a, af, b, bits, out, of, M, N, K, k0, k1, fwd,
                            s);
  } else {
    launch_a<float>(a, af, b, bits, out, of, M, N, K, k0, k1, fwd, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3'.  a: (M, K) float32, or codes per a_fmt (int[7], null: float32);
// out: (M, N) float32, or codes of the GEMM's grid per out_fmt.  Launch on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int qmatmul_sr(const void* a, const int* a_fmt, const void* b,
                          int b_is_bf16, void* out, const int* out_fmt,
                          int M, int N, int K, uint32_t k0, uint32_t k1,
                          int precision, int emin, int emax, float xmax,
                          int mode, int rand_bits, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, nullptr, out, out_fmt, M, N, K, k0, k1,
             precision, emin, emax, xmax, mode, rand_bits, stream);
}

// K3.  bits: (M, N) uint32 words on the device (read only under sr).
extern "C" int qmatmul_bits(const void* a, const int* a_fmt, const void* b,
                            int b_is_bf16, const uint32_t* bits, void* out,
                            const int* out_fmt, int M, int N, int K,
                            int precision, int emin, int emax, float xmax,
                            int mode, int rand_bits, void* stream) {
  return run(a, a_fmt, b, b_is_bf16, bits, out, out_fmt, M, N, K, 0u, 0u,
             precision, emin, emax, xmax, mode, rand_bits, stream);
}
