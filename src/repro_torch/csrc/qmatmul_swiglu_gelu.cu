// qmatmul_swiglu_sr / qmatmul_swiglu_bits with act = gelu: K4' and K4
// (qmatmul_swiglu_sr.cu describes them) under the reference's "gelu"
// activation, jax.nn.gelu's tanh form over XLA's tanh (rounding.cuh: gelu).
// Replaces the same TPU kernels as qmatmul_swiglu_sr.cu,
// repro/kernels/qmatmul.py:qmatmul_swiglu_prng_p and qmatmul_swiglu_p, with
// act="gelu".
#include "qmatmul_swiglu.cuh"

QMATMUL_SWIGLU_ENTRIES(rt::kGelu)
