// qmatmul_swiglu_sr / qmatmul_swiglu_bits: the fused GLU-FFN prefix with
// rounded results,
//   h = round_act(act(round(x @ wg)) * round(x @ wu)),
// here with act = silu; qmatmul_swiglu_gelu.cu, qmatmul_swiglu_relu.cu and
// qmatmul_swiglu_relu_sq.cu build the same kernels for the reference's
// other activations (ACT_FNS), each its own library (qmatmul_swiglu.cuh).
//
// Two flavours share every kernel body (one main loop, one summation
// order):
//   qmatmul_swiglu_sr   -- K4', replaces repro/kernels/qmatmul.py:
//     qmatmul_swiglu_prng_p (body _qmm_swiglu): the gate rounds with seed
//     pair 0 (stream 0), the up branch with seed pair 1 (stream 0), the
//     hidden with seed pair 2 (stream 1), each bit keyed by the global
//     (row, col) as in qmatmul_sr.cu;
//   qmatmul_swiglu_bits -- K4, replaces qmatmul.py:qmatmul_swiglu_p: the
//     words come from (M, N) uint32 operands bits_g, bits_u and, when the
//     activation site is stochastic, act_bits.
// Fed the words K4' draws (counter_bits_reduced), K4 equals K4' bit for
// bit.  The epilogue rounds both branches, applies the activation and the
// product, and rounds the hidden when the activation site is not the
// identity.  For
// the backward pass (residuals) it also writes the rounded branches g_r and
// u_r (the reference's outputs, repro/kernels/qmatmul.py:678-699).
//
// Both branches run K3''s two routes (gemm_routes.cuh) over two weight
// operands read against the same staged x rows, so they sum in the first
// version's order (one fmaf per k in ascending k from +0, over K rounded up
// to 16 with zeros), and the routes and that version are bitwise equal on
// every input.  The wrapper picks the route by M (kernels/qmatmul.py:
// DECODE_MAX_M, PERF.md):
//
// * Decode route (qmatmul_swiglu_sr_decode, qmatmul_swiglu_bits_decode;
//   decode steps, the engine's prefill chunks): one lane per output and
//   branch, a group of four warps per branch, so a block of eight warps
//   runs the gate's and the up branch's chains of 4 rows x 32 columns side
//   by side; each stage of the cp.async ring holds the block's 32 columns
//   of both wg and wu and its x rows; the up lanes hand their sums to the
//   gate lanes, which run the epilogue.
//
// * Large-M route (qmatmul_swiglu_sr, qmatmul_swiglu_bits; prompt
//   absorption, the train step's forward with residuals): K3''s 128x64 tile
//   turned for two operands, 64 rows x 64 columns of each branch per
//   256-thread block, 4x4 outputs of each branch per thread (32
//   accumulators, three blocks per SM), so the GLU epilogue stays in
//   registers; 32x64 tiles of 128 threads where that grid would not fill a
//   wave of resident blocks (M = 128), and with element loads where x, wg
//   or wu is not 16-byte aligned or a row length allows no vectors.
//
// Storage: h may leave as float32 or packed as code words of the act grid
// (out_packed, the reference's _resolve_epilogue); g_r and u_r as float32
// or code words of the GEMM grid (residuals_packed).  Every stored value
// is already on its grid, so packing loses nothing.  The large-M route
// stores four columns at a time where N % 4 == 0 and the outputs are
// 16-byte aligned, else element by element: no output needs alignment.
#include "qmatmul_swiglu.cuh"

QMATMUL_SWIGLU_ENTRIES(rt::kSilu)
