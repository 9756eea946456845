// qmatmul_swiglu_sr / qmatmul_swiglu_bits with act = relu_sq: K4' and K4
// (qmatmul_swiglu_sr.cu describes them) under the reference's "relu_sq"
// activation, jnp.square(jax.nn.relu(x)) (rounding.cuh: relu_sq). Replaces the
// same TPU kernels as qmatmul_swiglu_sr.cu,
// repro/kernels/qmatmul.py:qmatmul_swiglu_prng_p and qmatmul_swiglu_p, with
// act="relu_sq".
#include "qmatmul_swiglu.cuh"

QMATMUL_SWIGLU_ENTRIES(rt::kReluSq)
