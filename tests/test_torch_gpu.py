"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``; each test decides in a fixture whether there is a card and
skips without one.  This file imports neither jax nor the JAX package, so
it runs on a machine that has only PyTorch:

  python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: bitwise on exact-sum inputs (dyadic values, every partial sum
exact); on N(0, 1) inputs at most 1e-4 of the elements may differ (the
summation order differs from the twin's torch.matmul).  A qmatmul output
then differs by one grid step (``rounding.grid_flips``); in the fused
kernel a flip of a rounded branch propagates through silu(g) * u, so only
the share is bounded for its hidden.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.rounding import grid_flips, spec
from repro_torch.kernels import qmatmul as tq

SEEDS = ((0x12345678, 0x9ABCDEF0), (7, 0xFFFFFFFF), (0xDEADBEEF, 3))
ACT_SPECS = {"binary8-sr": spec("binary8", "sr"),
             "binary8-rn": spec("binary8", "rn"), "none": None}


@pytest.fixture
def cuda():
    """Decided at run time (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _exact(shape, div, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.integers(-8, 9, shape) / div).astype(np.float32))


def _normal(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


def _assert_flips(ref, got, fmt, adjacent_only=True, share=1e-4):
    n, adjacent = grid_flips(ref, got, fmt)
    assert n <= share * ref.numel(), (n, ref.numel())
    assert adjacent or not adjacent_only


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4, 2048, 256), (37, 45, 70),
                                   (128, 5632, 2048), (4, 2048, 32000)])
def test_qmatmul_kernel_matches_plain(cuda, M, K, N):
    a = _exact((M, K), 8.0, M).to(cuda)
    b = _exact((K, N), 4.0, N).to(cuda)
    for fmt, mode, rb in (("binary8", "sr", 32), ("binary8", "rn", 32),
                          ("e4m3", "sr", 16), ("binary8", "sr", 8),
                          ("binary16", "rn", 32), ("bfloat16", "sr", 32)):
        got = tq.qmatmul_prng(a, b.to(torch.bfloat16), SEEDS[0], fmt, mode,
                              rb)
        ref = tq.qmatmul_plain(a, b, SEEDS[0], fmt, mode, rb)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
            (fmt, mode, rb)
    a = _normal((M, K), M + 1).to(cuda)
    b = _normal((K, N), N + 1, K ** -0.5).to(cuda)
    got = tq.qmatmul_prng(a, b, SEEDS[1], "binary8")
    ref = tq.qmatmul_plain(a, b, SEEDS[1], "binary8")
    _assert_flips(ref, got, "binary8")


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4, 2048, 5632), (37, 45, 70),
                                   (128, 2048, 5632)])
def test_swiglu_kernel_matches_plain(cuda, M, K, N):
    x = _normal((M, K), M).to(cuda)
    wg = _normal((K, N), 1, K ** -0.5).to(cuda)
    wu = _normal((K, N), 2, K ** -0.5).to(cuda)
    for act in ACT_SPECS:
        got = tq.qmatmul_swiglu_prng(x, wg, wu, SEEDS, "binary8",
                                     act_spec=ACT_SPECS[act])
        ref = tq.qmatmul_swiglu_plain(x, wg, wu, SEEDS, "binary8",
                                      act_spec=ACT_SPECS[act])
        torch.cuda.synchronize()
        if act == "none":
            # unrounded hidden: float32 ulps apart, except where a branch
            # rounding flipped
            far = (got - ref).abs() > 1e-5 * ref.abs() + 1e-6
            assert int(far.sum()) <= 1e-4 * ref.numel()
        else:
            _assert_flips(ref, got, "binary8", adjacent_only=False)


@pytest.mark.gpu
def test_kernels_count_their_launches(cuda):
    tq.reset_launches()
    a = _normal((4, 64), 0).to(cuda)
    b = _normal((64, 32), 1).to(cuda)
    tq.qmatmul_prng(a, b, SEEDS[0], "binary8")
    tq.qmatmul_swiglu_prng(a, b, b, SEEDS, "binary8")
    tq.qmatmul_plain(a, b, SEEDS[0], "binary8")
    empty = tq.qmatmul_prng(a[:0], b, SEEDS[0], "binary8")
    assert empty.shape == (0, 32)
    assert tq.LAUNCHES == {"qmatmul_sr": 1, "qmatmul_swiglu_sr": 1}
