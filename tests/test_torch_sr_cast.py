"""K1''s and K1's launch plans on the CPU: which compiled instance a spec
runs, and how their threads split a tensor.

Each K1' thread rounds ``prng_group(rand_bits)`` consecutive elements and
evaluates one Threefry for them (``csrc/sr_cast.cu:sr_cast_prng_kernel``).
The tests hold that plan to the reference's keying: the threads cover
every element once, a thread's elements share one counter (row, pair)
of the flat 128-lane layout, and the fields one evaluation gives are the
reference's ``counter_bits_reduced`` at those elements (bitwise).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as jcommon
from repro_torch.core.prng import M32, threefry2x32
from repro_torch.kernels import sr_cast as tsr

WORDS = (0x6A09E667, 0xBB67AE85)


@pytest.mark.parametrize("mode,rand_bits,has_v,want", [
    ("sr", 32, False, "sr_r32"), ("sr", 16, False, "generic"),
    ("sr", 8, False, "generic"), ("rn", 32, False, "generic"),
    ("sr_eps", 32, False, "generic"), ("signed_sr_eps", 32, True, "generic"),
    ("sr", 32, True, "generic")])
def test_instance_choice(mode, rand_bits, has_v, want):
    assert tsr.sr_cast_instance(mode, rand_bits, has_v) == want
    assert want in tsr.SR_CAST_INSTANCES


@pytest.mark.parametrize("mode,rand_bits,has_v,want", [
    ("sr", 32, False, "sr_r32"), ("sr", 16, False, "generic"),
    ("sr", 8, False, "generic"), ("rn", 32, False, "generic"),
    ("sr_eps", 32, False, "generic"), ("signed_sr_eps", 32, True, "generic"),
    ("sr", 32, True, "generic")])
def test_bits_instance_choice(mode, rand_bits, has_v, want):
    """K1's instances: ``sr_r32`` for the oracle act site's spec, the
    generic one for everything else."""
    assert tsr.sr_cast_bits_instance(mode, rand_bits, has_v) == want
    assert want in tsr.SR_CAST_INSTANCES


def test_bits_path_spec_takes_the_path_instance():
    """The act site of ``binary8-paper`` (whose oracle form the MoE serve
    runs through K1) is the spec the ``sr_r32`` instance fixes."""
    from repro_torch.precision import get_policy
    act = get_policy("binary8-paper").act
    assert tsr.sr_cast_bits_instance(act.mode, act.rand_bits,
                                     False) == "sr_r32"


def test_bits_instance_override_refused_where_it_does_not_fit():
    x = torch.linspace(-3, 3, 11)
    bits = torch.arange(11, dtype=torch.int64) * 0x1F3D5B79
    with pytest.raises(ValueError, match="sr_r32"):
        tsr.sr_cast(x, bits, "binary8", "sr", rand_bits=16,
                    instance="sr_r32")
    # the generic instance takes every spec; on the CPU the twin runs
    ref = tsr.sr_cast(x, bits, "binary8", "sr")
    out = tsr.sr_cast(x, bits, "binary8", "sr", instance="generic")
    assert torch.equal(out, ref)
    assert torch.equal(out, tsr.sr_cast_plain(x, bits, "binary8", "sr"))


def test_instance_override_refused_where_it_does_not_fit():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="sr_r32"):
        tsr.sr_cast_prng(x, WORDS, "binary8", "sr", rand_bits=16,
                         instance="sr_r32")
    # the generic instance takes every spec; on the CPU the twin runs
    out = tsr.sr_cast_prng(x, WORDS, "binary8", "sr", instance="generic")
    assert torch.equal(out, x)


def _thread_fields(k0, k1, t, rand_bits):
    """The fields one K1' thread draws: one Threefry at (row, pair) of its
    first element, word j // (g / 2) of it, field j % (g / 2)."""
    g = tsr.prng_group(rand_bits)
    i0 = t * g
    o = threefry2x32(k0, k1, i0 // 128, (i0 % 128) // g)
    ratio = g // 2
    mask = M32 if rand_bits == 32 else (1 << rand_bits) - 1
    return [(o[j // ratio] >> ((j % ratio) * rand_bits)) & mask
            for j in range(g)]


@pytest.mark.parametrize("rand_bits", [32, 16, 8])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 98304 + 3])
def test_thread_partition_and_counters(n, rand_bits):
    g = tsr.prng_group(rand_bits)
    assert g * rand_bits == 64 and 128 % g == 0
    n_threads = -(-n // g)
    owner = np.arange(n) // g                 # thread of each element
    counts = np.bincount(owner, minlength=n_threads)
    assert counts[:-1].tolist() == [g] * (n_threads - 1)
    assert 1 <= counts[-1] <= g               # every element exactly once
    i = np.arange(n)
    ratio = 32 // rand_bits
    counter = (i // 128) * 64 + (i % 128) // ratio // 2   # (row, pair)
    assert np.array_equal(counter, counter[owner * g])   # the first's
    # one evaluation per thread gives the reference's fields
    rows = -(-n // 128)
    ref = np.asarray(jcommon.counter_bits_reduced(
        jnp.uint32(WORDS[0]), jnp.uint32(WORDS[1]), (rows, 128),
        rand_bits)).reshape(-1)[:n].astype(np.int64)
    step = max(1, n_threads // 64)            # a sample of the threads
    for t in list(range(0, n_threads, step)) + [n_threads - 1]:
        got = _thread_fields(*WORDS, t, rand_bits)[:counts[t]]
        assert got == ref[t * g:t * g + counts[t]].tolist(), t
