// qmatmul_batched_sr / qmatmul_batched_bits: a batch of float32 GEMMs
// whose results are rounded onto a low-precision grid (the paper's eq. 8a
// at a batched GEMM site: the MoE layer's stacked expert GEMMs).
//
// Two entry points share one kernel body (one main loop, one summation
// order):
//   qmatmul_batched_sr   -- K8', replaces repro/kernels/qmatmul.py:
//     qmatmul_batched_prng_p (body _qmmb): the rounding bits are drawn
//     in-kernel from Threefry keyed by slice e's own seed words seeds[e]
//     and the within-slice (r, c), stream 0 (rounding.cuh:element_bits),
//     so every slice owns an independent stream;
//   qmatmul_batched_bits -- K8, replaces qmatmul.py:qmatmul_batched_p: the
//     words come from an (E, M, N) uint32 operand, one plane per slice
//     (the reference's oracle draws each plane as counter_bits_reduced of
//     the slice's words, which makes K8 equal K8' bit for bit).
// out[e, r, c] = round(sum_k a[e, r, k] * b[e, k, c]); the output does
// not depend on the tiling and equals the plain twins
// repro_torch.kernels.qmatmul.qmatmul_batched_plain /
// qmatmul_batched_bits_plain bit for bit on exact sums.  As in K3, A may be
// float32 or code words (a_fmt, decoded as it is staged) and the output
// float32 or code words of the GEMM's grid (out_packed), element by
// element.
//
// What bounds it on an H100: on the serving path every slice is a GEMV
// (M = 1 row per expert at decode), so it streams each expert weight once
// for 2 flops per element: bound by bytes (K8's bits add 4 bytes per
// output element).  This first version is the simple kernel for that
// shape: one 128-thread block per (slice, 128 columns, TM rows);
// consecutive threads own consecutive columns, so each k row of b is read
// coalesced; a's TM rows are staged in shared memory in chunks of kKC;
// every thread sums its columns over k ascending with fp32 FMAs (the
// order K3' uses), on the CUDA cores.  B may be float32 or bfloat16:
// stored bf16 expert weights are widened in registers, which is exact, so
// no float32 copy of the experts is ever made.  Larger M tiles rows TM at
// a time and re-reads b once per tile; wgmma, TMA and split-K are later
// work.
#include <cuda_runtime.h>

#include "gemm_tile.cuh"
#include "rounding.cuh"

namespace {

constexpr int kCols = 128;   // threads per block = columns per block
constexpr int kKC = 256;     // k values of a staged per step

// bits == nullptr: draw in-kernel from seeds (K8'); else read word
// (e, r, c) (K8).
template <typename TA, typename TB, int TM>
__global__ void __launch_bounds__(kCols)
qmatmul_batched_kernel(const TA* __restrict__ a, rt::PackParams a_pack,
                       const TB* __restrict__ b,
                       const uint32_t* __restrict__ seeds,
                       const uint32_t* __restrict__ bits,
                       void* __restrict__ out, rt::CodeFormat out_fmt, int M,
                       int N, int K, rt::RoundParams fwd) {
  __shared__ float as[TM][kKC];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * TM;
  const int col = blockIdx.x * kCols + threadIdx.x;
  const TA* ae = a + static_cast<size_t>(e) * M * K;
  const TB* be = b + static_cast<size_t>(e) * K * N;

  float acc[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) acc[m] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kc = min(kKC, K - k0);
    for (int idx = threadIdx.x; idx < TM * kKC; idx += kCols) {
      const int m = idx / kKC, kk = idx % kKC;
      as[m][kk] = (m0 + m < M && kk < kc)
                      ? rt::decode_a(
                            ae[static_cast<size_t>(m0 + m) * K + k0 + kk],
                            a_pack)
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
  const bool sr = fwd.mode == rt::kSR;
  const uint32_t w0 = sr && bits == nullptr ? seeds[2 * e] : 0u;
  const uint32_t w1 = sr && bits == nullptr ? seeds[2 * e + 1] : 0u;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = m0 + m;
    if (r < M) {
      const size_t idx = (static_cast<size_t>(e) * M + r) * N + col;
      uint32_t w = 0u;
      if (sr) {
        w = bits != nullptr ? bits[idx]
                            : rt::element_bits(w0, w1, 0, fwd.rand_bits, r,
                                               col);
      }
      rt::store_code(out, idx, rt::round_value(acc[m], w, fwd), out_fmt);
    }
  }
}

template <typename TA, typename TB, int TM>
void launch(const void* a, const rt::CodeFormat& af, const void* b,
            const uint32_t* seeds, const uint32_t* bits, void* out,
            const rt::CodeFormat& of, int E, int M, int N, int K,
            const rt::RoundParams& fwd, cudaStream_t s) {
  const dim3 grid((N + kCols - 1) / kCols, (M + TM - 1) / TM, E);
  qmatmul_batched_kernel<TA, TB, TM><<<grid, kCols, 0, s>>>(
      static_cast<const TA*>(a), af.pack, static_cast<const TB*>(b), seeds,
      bits, out, of, M, N, K, fwd);
}

template <typename TA, typename TB>
void launch_rows(const void* a, const rt::CodeFormat& af, const void* b,
                 const uint32_t* seeds, const uint32_t* bits, void* out,
                 const rt::CodeFormat& of, int E, int M, int N, int K,
                 const rt::RoundParams& fwd, cudaStream_t s) {
  if (M == 1) {
    launch<TA, TB, 1>(a, af, b, seeds, bits, out, of, E, M, N, K, fwd, s);
  } else {
    launch<TA, TB, 4>(a, af, b, seeds, bits, out, of, E, M, N, K, fwd, s);
  }
}

template <typename TB>
void launch_a(const void* a, const rt::CodeFormat& af, const void* b,
              const uint32_t* seeds, const uint32_t* bits, void* out,
              const rt::CodeFormat& of, int E, int M, int N, int K,
              const rt::RoundParams& fwd, cudaStream_t s) {
  if (af.bytes == 1) {
    launch_rows<uint8_t, TB>(a, af, b, seeds, bits, out, of, E, M, N, K, fwd,
                             s);
  } else if (af.bytes == 2) {
    launch_rows<uint16_t, TB>(a, af, b, seeds, bits, out, of, E, M, N, K,
                              fwd, s);
  } else {
    launch_rows<float, TB>(a, af, b, seeds, bits, out, of, E, M, N, K, fwd,
                           s);
  }
}

int run(const void* a, const int* a_fmt, const void* b, int b_is_bf16,
        const uint32_t* seeds, const uint32_t* bits, void* out,
        const int* out_fmt, int E, int M, int N, int K, int precision,
        int emin, int emax, float xmax, int mode, int rand_bits,
        void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  const rt::RoundParams fwd{precision, emin, emax, xmax, mode, rand_bits, 1};
  const rt::CodeFormat af = rt::code_format(a_fmt);
  const rt::CodeFormat of = rt::code_format(out_fmt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b_is_bf16) {
    launch_a<__nv_bfloat16>(a, af, b, seeds, bits, out, of, E, M, N, K, fwd,
                            s);
  } else {
    launch_a<float>(a, af, b, seeds, bits, out, of, E, M, N, K, fwd, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8'.  a: (E, M, K) float32, or codes per a_fmt (int[7], null: float32);
// seeds: (E, 2) uint32 on the device, slice e's words at 2e and 2e + 1;
// out: (E, M, N) float32, or codes per out_fmt.  Launch on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int qmatmul_batched_sr(const void* a, const int* a_fmt,
                                  const void* b, int b_is_bf16,
                                  const uint32_t* seeds, void* out,
                                  const int* out_fmt, int E, int M, int N,
                                  int K, int precision, int emin, int emax,
                                  float xmax, int mode, int rand_bits,
                                  void* stream) {
  return run(a, a_fmt, b, b_is_bf16, seeds, nullptr, out, out_fmt, E, M, N,
             K, precision, emin, emax, xmax, mode, rand_bits, stream);
}

// K8.  bits: (E, M, N) uint32 words on the device (read only under sr).
extern "C" int qmatmul_batched_bits(const void* a, const int* a_fmt,
                                    const void* b, int b_is_bf16,
                                    const uint32_t* bits, void* out,
                                    const int* out_fmt, int E, int M, int N,
                                    int K, int precision, int emin, int emax,
                                    float xmax, int mode, int rand_bits,
                                    void* stream) {
  return run(a, a_fmt, b, b_is_bf16, nullptr, bits, out, out_fmt, E, M, N,
             K, precision, emin, emax, xmax, mode, rand_bits, stream);
}
