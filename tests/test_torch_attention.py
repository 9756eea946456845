"""The port's rounded flash attention against the JAX reference: the four
kernels' plain twins (K6, K7, K7', K9), the packed KV-cache codecs and
store, ``qattention``'s gradients, and reduced tinyllama served and
trained under ``binary8-paper-attn``.

Inputs come from numpy seeds; the same arrays and seed words go to both
packages.

Tolerances:
* Exact-sum inputs (small dyadic values, every q·k partial sum exact):
  the rounded logits' row max ``m`` is bitwise equal.
* ``l`` (a float32 sum of exps in another order, and torch's ``exp``
  against XLA's): relative 1e-5 (reads <= 4.2e-7 on these cases).
* ``out``, dq, dk, dv: at most max(1, 1e-4 · n) elements differ.  The
  float32 sums (q·k, p·v, the row sums) run in another order and ``exp``
  differs by float32 ulps, so a value within an ulp of a rounding decision
  may round the other way.  Where that value is one site's rounding of the
  output itself (a single logical block), the two sides are one grid step
  apart; a flip at an intermediate site (an av partial, a kv block's dq
  contribution) moves the output by that site's step, so there only the
  count is bounded.
* The packed cache codecs and the KV-store rounding are elementwise:
  bitwise.
* Model level (reduced tinyllama, teacher-forced serving and two train
  steps): limits set from the readings written beside them.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.core.rounding import parse_spec as jparse
from repro.kernels import common as jcommon
from repro.kernels import flash_attention as JF
from repro.precision import attention as jpa
from repro.precision import policy as jp
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.rounding import grid_flips, parse_spec
from repro_torch.core.rounding import spec as tr_spec
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import flash_attention as TF
from repro_torch.models import build_model
from repro_torch.precision import attention as tpa
from repro_torch.precision import policy as tp

B, H, KV, DK = 1, 8, 2, 16          # H / KV = 4 (GQA)


@pytest.fixture
def interpret_params(monkeypatch):
    """The reference kernels build ``pltpu.TPUCompilerParams``, which newer
    jax names ``CompilerParams``; alias it only where it is missing."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _inputs(shape, exact: bool, rng):
    if exact:
        return (rng.integers(-4, 5, shape) / 4).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _seeds(rows, cols, rng):
    return rng.integers(0, 2 ** 32, (rows, cols), dtype=np.uint64) \
        .astype(np.uint32)


def _specs(name):
    return [jparse(name)] * 3, [parse_spec(name)] * 3


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _assert_flips(ref, got, fmt, adjacent: bool):
    ref = _t(ref)
    n, adj = grid_flips(ref, got, fmt)
    assert n <= max(1, 1e-4 * ref.numel()), (n, ref.numel())
    assert adj or not adjacent


def _bits_equal(ref, got):
    return np.array_equal(np.asarray(ref, np.float32).view(np.int32),
                          got.numpy().view(np.int32))


# ----------------------------------------------------------- kernel twins --
# (spec, causal, q_offset, q_block, kv_block, S): multi-block cases have
# ragged tails (S = 50 over blocks of 16 / 32)
CASES = [
    ("binary8-sr", True, 0, 16, 32, 50),
    ("binary8-sr", False, 0, 16, 32, 50),
    ("binary8-sr", True, 5, 16, 32, 50),
    ("e4m3-sr-r16", True, 0, 16, 32, 50),
    ("binary8-sr-r8", True, 0, 32, 16, 50),
    ("binary8-rn", True, 0, 64, 64, 50),
    ("e4m3-sr", True, 0, 1024, 1024, 24),
]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name,causal,q_offset,qb,kb,S", CASES)
def test_flash_twins_match_reference(exact, name, causal, q_offset, qb, kb,
                                     S):
    """K6, K7 and K7''s twins against the reference's blocked replays."""
    rng = np.random.default_rng(zlib.crc32(repr((name, causal, q_offset, qb,
                                                 kb, exact)).encode()))
    Skv = S + q_offset
    q = _inputs((B * H, S, DK), exact, rng)
    k, v = (_inputs((B * KV, Skv, DK), exact, rng) for _ in range(2))
    do = _inputs((B * H, S, DK), exact, rng)
    seeds = _seeds(B * H, 6, rng)
    js, ts = _specs(name)
    fmt = name.split("-")[0]
    kw = dict(scale=0.125, n_heads=H, n_kv=KV, causal=causal, q_block=qb,
              kv_block=kb, q_offset=q_offset)
    ro, rm, rl = JF.flash_fwd_reference(*map(jnp.asarray, (q, k, v, seeds)),
                                        js, **kw)
    go, gm, gl = TF.flash_fwd(_t(q), _t(k), _t(v), seeds, ts, **kw)
    single = Skv <= kb
    if exact:
        assert _bits_equal(rm, gm)
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), rtol=1e-5)
    _assert_flips(ro, go, fmt, adjacent=single)

    ro = np.asarray(ro)
    d = np.sum(do * ro, axis=-1).astype(np.float32)
    res = [np.asarray(x) for x in (rm, rl)]
    seeds_dq = np.concatenate([seeds[:, :2], seeds[:, 2:4]], axis=1)
    rdq = JF.flash_bwd_dq_reference(
        *map(jnp.asarray, (q, k, v, do, *res, d, seeds_dq)), js[0], js[0],
        **kw)
    gdq = TF.flash_bwd_dq(*map(_t, (q, k, v, do, *res, d)), seeds_dq, ts[0],
                          ts[0], **kw)
    _assert_flips(rdq, gdq, fmt, adjacent=single)
    rdk, rdv = JF.flash_bwd_dkv_reference(
        *map(jnp.asarray, (q, k, v, do, *res, d, seeds)), js[0], js[0], js[1],
        **kw)
    gdk, gdv = TF.flash_bwd_dkv(*map(_t, (q, k, v, do, *res, d)), seeds,
                                ts[0], ts[0], ts[1], **kw)
    _assert_flips(rdk, gdk, fmt, adjacent=S <= qb)
    _assert_flips(rdv, gdv, fmt, adjacent=S <= qb)


@pytest.mark.parametrize("kv_fmt", [None, "e4m3"])
@pytest.mark.parametrize("name,kb", [("binary8-sr", 16), ("e4m3-sr-r16", 32),
                                     ("binary8-sr-r8", 1024)])
def test_flash_decode_twin_matches_reference(kv_fmt, name, kb):
    """K9's twin over a float or packed e4m3 cache, lengths 1, 17 and
    S_max, multi-block with a ragged tail (S_max = 41)."""
    rng = np.random.default_rng(7 + kb)
    G, Smax = H // KV, 41
    q = _inputs((B * KV, G, DK), False, rng)
    k, v = (_inputs((B * KV, Smax, DK), False, rng) for _ in range(2))
    if kv_fmt is not None:
        k, v = (np.asarray(jcommon.pack_block(
            jparse("e4m3-rn")(jnp.asarray(x)), kv_fmt)) for x in (k, v))
    seeds = _seeds(B * KV, 6, rng)
    js, ts = _specs(name)
    for length in (1, 17, Smax):
        kw = dict(scale=0.25, kv_block=kb, kv_fmt=kv_fmt)
        ref = JF.flash_decode_reference(*map(jnp.asarray, (q, k, v, seeds)),
                                        length, js, **kw)
        got = TF.flash_decode(_t(q), torch.from_numpy(k.copy()),
                              torch.from_numpy(v.copy()), seeds, length, ts,
                              **kw)
        _assert_flips(ref, got, name.split("-")[0],
                      adjacent=length <= kb)


def test_packed_decode_equals_unpacked_decode():
    """K9's twin over code words is bitwise K9's twin over the same values
    unpacked (decoding is exact)."""
    rng = np.random.default_rng(3)
    G, Smax = H // KV, 48
    q = _t(_inputs((B * KV, G, DK), False, rng))
    codes = [tcommon.pack_block(parse_spec("e4m3-rn")(
        _t(_inputs((B * KV, Smax, DK), False, rng))), "e4m3")
        for _ in range(2)]
    floats = [tcommon.unpack_block(c, "e4m3") for c in codes]
    seeds = _seeds(B * KV, 6, rng)
    specs = [parse_spec("binary8-sr")] * 3
    for length in (1, 17, 48):
        a = TF.flash_decode(q, *codes, seeds, length, specs, scale=0.125,
                            kv_fmt="e4m3")
        b = TF.flash_decode(q, *floats, seeds, length, specs, scale=0.125)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_twins_match_interpret_kernels(interpret_params):
    """One forward and one packed decode against the interpret-mode Pallas
    kernels themselves (the reference twins above equal them bit for bit,
    tests/test_flash_kernels.py)."""
    rng = np.random.default_rng(11)
    S = 40
    q = _inputs((B * H, S, DK), True, rng)
    k, v = (_inputs((B * KV, S, DK), True, rng) for _ in range(2))
    seeds = _seeds(B * H, 6, rng)
    js, ts = _specs("binary8-sr")
    kw = dict(scale=0.125, n_heads=H, n_kv=KV, causal=True, q_block=16,
              kv_block=16)
    ro, rm, rl = JF.flash_fwd_p(*map(jnp.asarray, (q, k, v, seeds)), js,
                                interpret=True, **kw)
    go, gm, gl = TF.flash_fwd(_t(q), _t(k), _t(v), seeds, ts, **kw)
    assert _bits_equal(rm, gm)
    np.testing.assert_allclose(gl.numpy(), np.asarray(rl), rtol=1e-5)
    _assert_flips(ro, go, "binary8", adjacent=False)

    G = H // KV
    qd = _inputs((B * KV, G, DK), False, rng)
    kd, vd = (np.asarray(jcommon.pack_block(jparse("e4m3-sr")(
        jnp.asarray(_inputs((B * KV, S, DK), False, rng)),
        key=jax.random.PRNGKey(i)), "e4m3")) for i in range(2))
    seeds = _seeds(B * KV, 6, rng)
    ref = JF.flash_decode_p(*map(jnp.asarray, (qd, kd, vd, seeds)), 29, js,
                            scale=0.25, kv_block=16, kv_fmt="e4m3",
                            interpret=True)
    got = TF.flash_decode(_t(qd), torch.tensor(kd), torch.tensor(vd),
                          seeds, 29, ts, scale=0.25, kv_block=16,
                          kv_fmt="e4m3")
    _assert_flips(ref, got, "binary8", adjacent=False)


# ------------------------------------------ K9 on the decode kernel --
# K9's card route runs K10's decode kernel over the contiguous cache read
# as pages of kv_block keys.  Its twin is K10's twin over that view; these
# cases hold it to K9's twin and to the reference's interpret kernel.
# (S_max, kv_block, lengths, window): the serve shape's one block of 48,
# blocks of 64 with a ragged last block of 8, and a window
K9_PAGED_CASES = [(48, 48, (1, 17, 48), 0),
                  (200, 64, (1, 63, 64, 65, 200), 0),
                  (200, 64, (30, 65, 200), 50)]


def _contiguous_as_pages(x, n_kv: int, kb: int):
    """A (B·KV, S_max, d) cache as a (P·KV, kb, d) pool of kb-key pages,
    the ragged last block padded with zeros (code 0 is +0); page j of
    request b is physical page b·n_max + j, so the tables count up."""
    BKV, Smax, d = x.shape
    n_max = -(-Smax // kb)
    pad = x.new_zeros((BKV, n_max * kb - Smax, d))
    xp = torch.cat([x, pad], 1).view(BKV // n_kv, n_kv, n_max, kb, d)
    pages = xp.permute(0, 2, 1, 3, 4).reshape(-1, kb, d)
    tables = np.arange(BKV // n_kv * n_max, dtype=np.int32).reshape(
        BKV // n_kv, n_max)
    return pages, tables


def _exact_decode_inputs(BKV, G, Smax, rng):
    """q of quarters; each row's keys one key repeated, a signed 1 or 2 on
    one dim, so with scale 1/4 every logit is on the binary8 and e4m3 grids
    and equal along the row (every exp 0 or 1); v of eighths: every sum
    exact, so the three sides agree bit for bit whatever their orders."""
    q = rng.integers(-4, 5, (BKV, G, DK)) / 4
    k = np.zeros((BKV, 1, DK))
    k[np.arange(BKV), 0, rng.integers(0, DK, BKV)] = rng.choice(
        [-2, -1, 1, 2], BKV)
    v = rng.integers(-8, 9, (BKV, Smax, DK)) / 8
    return [x.astype(np.float32) for x in (q, np.repeat(k, Smax, 1), v)]


@pytest.mark.parametrize("kv_fmt", [None, "e4m3"])
@pytest.mark.parametrize("Smax,kb,lengths,window", K9_PAGED_CASES)
def test_decode_paged_twin_over_contiguous_cache(interpret_params, Smax, kb,
                                                 lengths, window, kv_fmt):
    """K10's twin over the contiguous cache viewed as pages of ``kb`` keys
    (tables counting up, the ragged last block padded) equals K9's twin
    bit for bit on any input, and the reference's interpret kernel bit for
    bit on exact inputs (within the attention contract on N(0, 1)): the
    equality K9's card route rests on."""
    G = H // KV
    js, ts = _specs("binary8-sr")
    for exact in (True, False):
        rng = np.random.default_rng(Smax + kb + window + int(exact))
        if exact:
            q, k, v = _exact_decode_inputs(B * KV, G, Smax, rng)
        else:
            q = _inputs((B * KV, G, DK), False, rng)
            k, v = (_inputs((B * KV, Smax, DK), False, rng)
                    for _ in range(2))
        if kv_fmt is not None:
            k, v = (np.asarray(jcommon.pack_block(
                jparse("e4m3-rn")(jnp.asarray(x)), kv_fmt)) for x in (k, v))
        seeds = _seeds(B * KV, 6, rng)
        kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        kp, tables = _contiguous_as_pages(kt, KV, kb)
        vp, _ = _contiguous_as_pages(vt, KV, kb)
        kw = dict(scale=0.25, window=window, kv_fmt=kv_fmt)
        for length in lengths:
            flat = TF.flash_decode_plain(_t(q), kt, vt, seeds, length, ts,
                                         kv_block=kb, **kw)
            paged = TF.flash_decode_paged_plain(
                _t(q), kp, vp, seeds, np.full(B, length, np.int32), tables,
                ts, n_kv=KV, **kw)
            assert torch.equal(flat.view(torch.int32),
                               paged.view(torch.int32)), (exact, length)
            ref = JF.flash_decode_p(*map(jnp.asarray, (q, k, v, seeds)),
                                    length, js, kv_block=kb, interpret=True,
                                    **kw)
            if exact:
                assert _bits_equal(ref, paged), length
            else:
                _assert_flips(ref, paged, "binary8", adjacent=False)


# (S_max, kv_block, head dim, cache element bytes, the kernel K9 launches):
# the decode kernel where the logits of one kv block fit in its shared
# memory (decode_smem_bytes with no table), else the tiled kernel
DECODE_PLANS = [
    (48, 512, 64, 1, "flash_decode"),             # the serve shape
    (200, 64, 64, 4, "flash_decode"),
    (4096, 4096, 128, 4, "flash_decode"),
    (60000, 53888, 64, 1, "flash_decode"),        # the last that fits
    (60000, 53889, 64, 1, "flash_decode_tiled"),
    (60000, 47744, 64, 4, "flash_decode"),
    (60000, 47745, 64, 4, "flash_decode_tiled"),
    (60000, 60000, 16, 2, "flash_decode_tiled"),
    (10, 0, 64, 1, "flash_decode_tiled"),         # no keys per block
]


@pytest.mark.parametrize("Smax,kb,d,elt,want", DECODE_PLANS)
def test_decode_kernel_choice(Smax, kb, d, elt, want):
    assert TF.decode_kernel_for(Smax, kb, d, d, elt) == want
    if kb:
        fits = TF.decode_smem_bytes(min(kb, Smax), d, d, elt, 0) \
            <= TF.SMEM_MAX
        assert fits == (want == "flash_decode")


def test_decode_smem_bytes():
    """V rows of a 128-key round, q, the logits of a round (or of one
    longer page), 32 pages' maxima, sums and P.V partials, the table."""
    assert TF.decode_smem_bytes(48, 64, 64, 1, 0) == 128 * 64 + 4 * (
        64 + 128 + 64 + 32 * 64)
    assert TF.decode_smem_bytes(48, 64, 64, 1, 3) \
        == TF.decode_smem_bytes(48, 64, 64, 1, 0) + 12
    assert TF.decode_smem_bytes(300, 64, 64, 4, 0) \
        == TF.decode_smem_bytes(128, 64, 64, 4, 0) + 4 * 172


def test_flash_decode_kernel_override_is_checked():
    """``kernel`` may name the tiled kernel for any shape, the decode
    kernel only where it fits; anything else raises before any work."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(
        np.float32)) for _ in range(2))
    seeds = rng.integers(0, 2 ** 32, (2, 6), dtype=np.uint64)
    specs = [parse_spec("binary8-sr")] * 3
    ref = TF.flash_decode(q, k, v, seeds, 7, specs, scale=0.25, kv_block=4)
    for kernel in ("flash_decode", "flash_decode_tiled"):
        got = TF.flash_decode(q, k, v, seeds, 7, specs, scale=0.25,
                              kv_block=4, kernel=kernel)
        assert torch.equal(ref, got)
    with pytest.raises(ValueError, match="cannot launch"):
        TF.flash_decode(q, k, v, seeds, 7, specs, scale=0.25, kv_block=4,
                        kernel="fwd_kernel")
    big = torch.zeros((1, 60000, 16))
    assert TF.decode_kernel_for(60000, 60000, 16, 16, 4) \
        == "flash_decode_tiled"
    with pytest.raises(ValueError, match="cannot launch"):
        TF.flash_decode(q[:1], big, big, seeds[:1], 3, specs, scale=0.25,
                        kv_block=60000, kernel="flash_decode")


# ------------------------------------------------------- packed KV cache --
@pytest.mark.parametrize("fmt", ["binary8", "e4m3", "bfloat16", "binary16"])
def test_pack_block_matches_reference(fmt):
    """Codes and decoded values bitwise for every packable grid, with
    ±0, e4m3's ±480 and ±inf/NaN in the mix (inputs are grid values, as
    the cache stores them: the rounding flushes below 2^-126, so bfloat16
    subnormals never reach the codec)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(4000) * 4.0 ** rng.integers(-12, 6, 4000)
    x = np.concatenate([x, [0.0, -0.0, 480.0, -480.0, 1e30, -1e30]])
    g = np.asarray(jparse(f"{fmt}-rn")(jnp.asarray(x.astype(np.float32))))
    g = np.concatenate([g, [np.inf, -np.inf, np.nan]]).astype(np.float32)
    ref = np.asarray(jcommon.pack_block(jnp.asarray(g), fmt))
    got = tcommon.pack_block(torch.from_numpy(g), fmt)
    assert got.dtype == tcommon.pack_dtype(fmt)
    assert tcommon.pack_bytes(fmt) == jcommon.pack_bytes(fmt)
    assert np.array_equal(ref, got.numpy())
    back = tcommon.unpack_block(got, fmt)
    assert _bits_equal(jcommon.unpack_block(jnp.asarray(ref), fmt), back)


@pytest.mark.parametrize("preset", ["binary8-paper-attn", "e4m3-attn"])
def test_kv_store_matches_reference(preset):
    """The stored codes of a chunked append equal the reference's, and
    token-by-token appends write the same codes as one chunk."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, KV, DK)).astype(np.float32)
    words = (0x1234ABCD, 0x9E3779B9)
    jq = jp.QuantCtx(jp.PRESETS[preset], jnp.asarray(np.array(words,
                                                              np.uint32)))
    tq = tp.QuantCtx(tp.PRESETS[preset], words)
    for stream in (0, 1):
        ref = np.asarray(jpa.kv_store(jnp.asarray(x), jq, pos0=3,
                                      stream=stream))
        got = tpa.kv_store(_t(x), tq, pos0=3, stream=stream)
        assert got.dtype == torch.uint8
        assert np.array_equal(ref, got.numpy())
        steps = torch.cat([tpa.kv_store(_t(x[:, i:i + 1]), tq, pos0=3 + i,
                                        stream=stream) for i in range(6)], 1)
        assert torch.equal(steps, got)
    # k and v stored in one pass (the model's call) equal two calls
    both = tpa.kv_store(torch.stack([_t(x), _t(-x)]), tq, pos0=3,
                        stream=(0, 1))
    assert torch.equal(both[0], tpa.kv_store(_t(x), tq, pos0=3, stream=0))
    assert torch.equal(both[1], tpa.kv_store(_t(-x), tq, pos0=3, stream=1))


def test_presets_resolve_and_unported_raise():
    for name in ("binary8-paper-attn", "e4m3-attn"):
        ref, pol = jp.PRESETS[name], tp.get_policy(name)
        assert (pol.attn_qk, pol.attn_av, pol.attn_out) == tuple(
            parse_spec(str(s)) for s in (ref.attn_qk, ref.attn_av,
                                         ref.attn_out))
        # the reference's preset packs its cache, as the port always does
        assert pol.kv_cache_fmt == ref.kv_cache_fmt and ref.kv_cache_packed
        assert not pol.attn_identity and not pol.is_identity
    assert tp.PRESETS["binary8-paper"].attn_identity
    for name in ("binary8-paper-packed", "e4m3-sr-oracle"):
        ref, pol = jp.PRESETS[name], tp.get_policy(name)
        assert (pol.oracle, pol.packed) == (ref.oracle, ref.packed)
        assert pol.attn_identity
    with pytest.raises(NotImplementedError, match="attn_qk"):
        tp.make_policy(fmt="binary8", attn=tr_spec("binary8", "sr_eps",
                                                   eps=0.1))
    with pytest.raises(ValueError):
        tp.make_policy(fmt="binary8", kv_cache_fmt="binary32-rn")
    assert (tp.TAG_ATTN_QK, tp.TAG_ATTN_AV, tp.TAG_ATTN_OUT,
            tp.TAG_ATTN_KV) == (jp.TAG_ATTN_QK, jp.TAG_ATTN_AV,
                                jp.TAG_ATTN_OUT, jp.TAG_ATTN_KV)
    ref = np.asarray(jp.slice_words(jnp.asarray(np.array(
        (5, 0xFFFFFFF0), np.uint32)), 7))
    assert np.array_equal(ref, tp.slice_words((5, 0xFFFFFFF0), 7))


# ------------------------------------------------------------- qattention --
def test_qattention_grads_match_reference_vjp():
    """Forward and (dq, dk, dv) of ``qattention`` against the reference's
    custom VJP (its oracle twins, bit-identical to the interpret kernels),
    GQA group-sum included."""
    rng = np.random.default_rng(21)
    S = 20
    q = rng.standard_normal((B, S, H, DK)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, DK)).astype(np.float32)
            for _ in range(2))
    ct = rng.standard_normal((B, S, H, DK)).astype(np.float32)
    words = (0xCAFEF00D, 0x0BADBEEF)
    jpol = dataclasses.replace(jp.PRESETS["binary8-paper-attn"], oracle=True)
    jq = jp.QuantCtx(jpol, jnp.asarray(np.array(words, np.uint32)))
    kw = dict(scale=0.25, q_block=8, kv_block=16)
    out, vjp = jax.vjp(lambda *a: jpa.qattention(*a, jq, **kw),
                       *map(jnp.asarray, (q, k, v)))
    refs = vjp(jnp.asarray(ct))
    ts = [_t(x).requires_grad_() for x in (q, k, v)]
    got = tpa.qattention(*ts, tp.QuantCtx(
        tp.PRESETS["binary8-paper-attn"], words), **kw)
    got.backward(_t(ct))
    _assert_flips(out, got.detach(), "binary8", adjacent=False)
    for r, t in zip(refs, ts):
        _assert_flips(r, t.grad, "binary8", adjacent=False)


def test_qattn_decode_matches_reference():
    """The decode wrapper over a packed cache: the head grouping as the
    reference's (its oracle twin), over the port's (B, KV, S_max, d)
    layout of the reference's (B, S_max, KV, d) cache."""
    rng = np.random.default_rng(31)
    Bq, Smax = 2, 12
    q = rng.standard_normal((Bq, 1, H, DK)).astype(np.float32)
    k, v = (np.asarray(jcommon.pack_block(jparse("e4m3-rn")(jnp.asarray(
        rng.standard_normal((Bq, Smax, KV, DK)).astype(np.float32))),
        "e4m3")) for _ in range(2))
    words = (0x51ED2701, 0x77)
    jpol = dataclasses.replace(jp.PRESETS["binary8-paper-attn"], oracle=True)
    ref = jpa.qattn_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 9,
                           jp.QuantCtx(jpol, jnp.asarray(np.array(
                               words, np.uint32))), scale=0.25,
                           kv_fmt="e4m3", kv_block=8)
    got = tpa.qattn_decode(_t(q), *(torch.tensor(c).transpose(1, 2)
                                    .contiguous() for c in (k, v)),
                           9, tp.QuantCtx(tp.PRESETS["binary8-paper-attn"],
                                          words), scale=0.25, kv_fmt="e4m3",
                           kv_block=8)
    _assert_flips(ref, got, "binary8", adjacent=False)


# ------------------------------------------------------------ model level --
PROMPT, GEN = 6, 3


def _serve_params(jparams):
    """The reference's initial distributions (norm scales 0, embedding and
    lm head N(0, 0.02²), projections N(0, 1/fan_in)) drawn by numpy: its
    own init folds ``hash()`` of a block name, which Python salts per
    process."""
    rng = np.random.default_rng(23)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return jnp.zeros(leaf.shape, jnp.float32)
        std = 0.02 if ("embed" in name or "lm_head" in name) \
            else 1 / np.sqrt(leaf.shape[-2])
        return jnp.asarray((rng.standard_normal(leaf.shape) * std)
                           .astype(np.float32))
    return jax.tree_util.tree_map_with_path(draw, jparams)


def _jax_serve(prompts):
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.models import build_model as jbuild
    cfg = dataclasses.replace(jreduced(jget("tinyllama-1.1b")),
                              gemm_policy="binary8-paper-attn")
    model = jbuild(cfg)
    params = _serve_params(model.init(jax.random.PRNGKey(0)))
    step = jax.jit(model.decode_step, static_argnames=("compute_logits",))
    caches = model.init_decode_cache(prompts.shape[0], PROMPT + GEN)
    p = jnp.asarray(prompts)
    for pos in range(PROMPT):
        _, caches = step(params, caches, p[:, pos:pos + 1], jnp.int32(pos),
                         compute_logits=False)
    tok, picks, logits = p[:, -1:], [], []
    for t in range(GEN):
        lg, caches = step(params, caches, tok, jnp.int32(PROMPT + t))
        tok = jnp.argmax(lg[:, -1, :], axis=-1)[:, None]
        picks.append(np.asarray(tok))
        logits.append(np.asarray(lg[:, -1, :].astype(jnp.float32)))
    return (jax.device_get(params), np.concatenate(picks, 1),
            np.stack(logits, 1), caches["attn"])


def _port_serve(jparams, prompts, forced):
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              gemm_policy="binary8-paper-attn")
    model = build_model(cfg)
    params = convert.params_from_jax(jparams)
    caches = model.init_decode_cache(prompts.shape[0], PROMPT + GEN)
    p = torch.from_numpy(prompts)
    with torch.inference_mode():
        for pos in range(PROMPT):
            _, caches = model.decode_step(params, caches, p[:, pos:pos + 1],
                                          pos, compute_logits=False)
        tok, logits = p[:, -1:], []
        for t in range(GEN):
            lg, caches = model.decode_step(params, caches, tok, PROMPT + t)
            logits.append(lg[:, -1, :].float())
            tok = torch.from_numpy(forced[:, t:t + 1])
    return torch.stack(logits, 1).numpy(), caches["attn"]


def test_serve_binary8_paper_attn_matches_reference(interpret_params):
    """Reduced tinyllama, 6 prompt tokens absorbed and 3 decoded
    (teacher-forced on the reference's picks).  Readings: layer 0's uint8
    cache codes equal (layer 1's differ in 175 / 576 k and 176 / 576 v
    codes: its inputs went through layer 0's stochastic roundings, where a
    float32-ulp difference upstream flips a decision by a grid step, as
    the binary8-paper serving test finds), median |dlogit| 0.0156, 5.9 %
    of logits off by more than 0.05, picks equal.  Limits: layer 0's codes
    equal; median < 0.02 and at most 10 % of logits off by more than 0.05
    (tests/test_torch_serve.py's); picks within 0.1 of the reference's
    best logit."""
    prompts = np.random.default_rng(0).integers(0, 128, (2, PROMPT))
    jparams, picks, ref, jcache = _jax_serve(prompts)
    got, cache = _port_serve(jparams, prompts, picks)
    assert cache.k.dtype == torch.uint8
    for r, g in ((jcache.k, cache.k), (jcache.v, cache.v)):
        # the port's cache is (B, KV, S_max, d) per layer
        assert np.array_equal(np.asarray(r)[0], g[0].transpose(1, 2).numpy())
    d = np.abs(got - ref)
    assert np.all(np.isfinite(got))
    assert np.median(d) < 0.02, float(np.median(d))
    assert np.mean(d > 0.05) <= 0.10, float(np.mean(d > 0.05))
    chosen = np.take_along_axis(ref, got.argmax(-1)[..., None], -1)[..., 0]
    assert np.all(chosen >= ref.max(-1) - 0.1)


def _numpy_params(jparams):
    rng = np.random.default_rng(17)
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    out = []
    for leaf in leaves:
        if leaf.ndim == 1 or (leaf.ndim == 2 and leaf.shape[0] == 2):
            v = rng.standard_normal(leaf.shape) * 0.1       # norm scales
        else:
            v = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        out.append(jnp.asarray(v.astype(np.float32)))
    return jax.tree_util.tree_unflatten(treedef, out)


def test_train_steps_binary8_paper_attn_match_reference(interpret_params):
    """Two QSGD steps of reduced tinyllama under ``binary8-paper-attn``
    from one numpy parameter draw (seed 17; the reference compiled without
    XLA excess precision, as tests/test_torch_train.py does).  Readings:
    see the limits' comments."""
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.launch import steps as jsteps
    from repro.launch.train import rounding_config as jrounding
    from repro.models import build_model as jbuild
    from repro.optim import qsgd as jqsgd
    from repro_torch.core import prng
    from repro_torch.kernels.tree_update import tree_leaves
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.train import rounding_config
    from repro_torch.optim import qsgd

    jcfg = dataclasses.replace(jreduced(jget("tinyllama-1.1b")),
                               gemm_policy="binary8-paper-attn")
    jparams = _numpy_params(jbuild(jcfg).init(jax.random.PRNGKey(0)))
    toks = np.random.default_rng(0).integers(0, 128, (2, 2, 9))
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    jopt = jqsgd(lr=0.05, momentum=0.9,
                 cfg=jrounding("signed_sr_eps", "binary8", 0.1),
                 update_path="fused")
    state = jopt.init(jparams, jax.random.PRNGKey(1))
    step = jax.jit(jsteps.make_train_step(jbuild(jcfg), jopt))
    ref, ref_losses = jparams, []
    for batch in batches:
        jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
        compiled = step.lower(ref, state, jb).compile(
            compiler_options={"xla_allow_excess_precision": False})
        ref, state, metrics = compiled(ref, state, jb)
        ref_losses.append(float(metrics["loss"]))

    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              gemm_policy="binary8-paper-attn")
    opt = qsgd(lr=0.05, momentum=0.9,
               cfg=rounding_config("signed_sr_eps", "binary8", 0.1),
               update_path="fused")
    params = convert.master_params_from_jax(jax.device_get(jparams))
    tstate = opt.init(params, prng.PRNGKey(1))
    tstep = tsteps.make_train_step(build_model(cfg), opt)
    losses = []
    for batch in batches:
        params, tstate, metrics = tstep(
            params, tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    # reading: losses within 9.0e-8 relative (limit as the binary8-paper
    # train test: 5e-7, a few float32 ulps of the cross-entropy sum)
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-7)
    n_diff = n = 0
    for r, g in zip(jax.tree_util.tree_leaves(ref), tree_leaves(params)):
        r = np.asarray(r, np.float32)
        n_diff += int(np.sum(r.view(np.int32) != g.numpy().view(np.int32)))
        n += r.size
    # reading: 0 of 90,432 parameters differ (limit 8, as the
    # binary8-paper train test)
    assert n_diff <= 8, (n_diff, n)


def test_attention_launches_per_path(monkeypatch, tmp_path):
    """The launch arithmetic the chip run checks, counted at the plain
    twins' call sites: serving runs K9 once per layer per token (prompt
    absorption and decode alike), training K6, K7 and K7' once per layer
    per step; neither runs the paged decode (K10)."""
    from repro_torch.launch import serve as tserve, train as ttrain
    calls = {k: 0 for k in TF.LAUNCHES}
    for name, fn in (("flash_fwd", "flash_fwd_plain"),
                     ("flash_bwd_dq", "flash_bwd_dq_plain"),
                     ("flash_bwd_dkv", "flash_bwd_dkv_plain"),
                     ("flash_decode", "flash_decode_plain"),
                     ("flash_decode_paged", "flash_decode_paged_plain")):
        def counted(*a, _n=name, _f=getattr(TF, fn), **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(TF, fn, counted)
    L = reduced(get_config("tinyllama-1.1b")).n_layers
    out = tserve.run("tinyllama-1.1b", reduced=True, batch=2, prompt_len=5,
                     gen=3, gemm_policy="binary8-paper-attn", device="cpu")
    assert calls == {"flash_fwd": 0, "flash_fwd_two_pass": 0,
                     "flash_bwd_dq": 0, "flash_bwd_dq_simple": 0,
                     "flash_bwd_dkv": 0, "flash_bwd_dkv_simple": 0,
                     "flash_decode": L * (5 + 3), "flash_decode_tiled": 0,
                     "flash_decode_paged": 0}
    assert out["cache_dtype"] == torch.uint8
    assert out["cache_bytes"] == 2 * L * 2 * 8 * 2 * 16
    calls.update({k: 0 for k in calls})
    hist = ttrain.run("tinyllama-1.1b", reduced=True, steps=2, batch=2,
                      seq=8, gemm_policy="binary8-paper-attn",
                      rounding_kind="signed_sr_eps", fmt="binary8",
                      update_path="fused", device="cpu", verbose=False,
                      ckpt_dir=str(tmp_path))
    assert calls == {"flash_fwd": 2 * L, "flash_fwd_two_pass": 0,
                     "flash_bwd_dq": 2 * L, "flash_bwd_dq_simple": 0,
                     "flash_bwd_dkv": 2 * L, "flash_bwd_dkv_simple": 0,
                     "flash_decode": 0, "flash_decode_tiled": 0,
                     "flash_decode_paged": 0}
    assert all(np.isfinite(h["loss"]) for h in hist["history"])


# (Skv, head dim, kv_block, the forward kernel K6 launches): the single
# pass where the head dim is compiled and a block's logits fit in shared
# memory, else the two-pass kernel
FWD_PLANS = [
    (256, 64, 1024, "flash_fwd"),            # the train step: one block
    (1024, 64, 1024, "flash_fwd"),
    (2048, 64, 2048, "flash_fwd_two_pass"),  # 2048 keys' logits: 329 KB
    (2048, 64, 1024, "flash_fwd"),           # blocks of 1024 keys
    (256, 128, 1024, "flash_fwd"),
    (1024, 128, 1024, "flash_fwd_two_pass"),
    (512, 128, 512, "flash_fwd"),
    (200, 16, 64, "flash_fwd"),              # the reduced model's head dim
    (200, 32, 200, "flash_fwd"),
    (256, 48, 64, "flash_fwd_two_pass"),     # a head dim not compiled
    (0, 64, 512, "flash_fwd_two_pass"),      # no keys
]


@pytest.mark.parametrize("Skv,d,kb,want", FWD_PLANS)
def test_fwd_kernel_choice(Skv, d, kb, want):
    assert TF.fwd_kernel_for(Skv, d, d, kb) == want
    if d in TF.FWD_DIMS and Skv:
        fits = TF.fwd_smem_bytes(min(kb, Skv), d) <= TF.SMEM_MAX
        assert fits == (want == "flash_fwd")


def test_fwd_kernel_choice_needs_equal_head_dims():
    assert TF.fwd_kernel_for(256, 64, 32, 256) == "flash_fwd_two_pass"
    assert TF.fwd_kernel_for(256, 32, 32, 256) == "flash_fwd"


def test_fwd_smem_bytes():
    """q rows, two 128-key k/v tiles, the logits at a stride of whole
    tiles plus 4, four row statistics: 105 KB at the train shape, and
    blocks up to 1152 keys fit at d = 64."""
    assert TF.fwd_smem_bytes(256, 64) == 4 * (32 * 64 + 2 * 128 * 64
                                              + 32 * 260 + 4 * 32)
    assert TF.fwd_smem_bytes(256, 64) == 107520
    assert TF.fwd_smem_bytes(1152, 64) <= TF.SMEM_MAX \
        < TF.fwd_smem_bytes(1153, 64)
    assert TF.fwd_smem_bytes(129, 64) == TF.fwd_smem_bytes(256, 64)


def test_flash_fwd_kernel_override_is_checked():
    """``kernel`` may name the two-pass kernel for any shape, the single
    pass only where it fits; anything else raises before any work."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(
        np.float32)) for _ in range(3))
    seeds = rng.integers(0, 2 ** 32, (2, 6), dtype=np.uint64)
    specs = [parse_spec("binary8-sr")] * 3
    kw = dict(scale=0.25, n_heads=2, n_kv=2, kv_block=4)
    ref = TF.flash_fwd(q, k, v, seeds, specs, **kw)
    for kernel in ("flash_fwd", "flash_fwd_two_pass"):
        got = TF.flash_fwd(q, k, v, seeds, specs, kernel=kernel, **kw)
        assert all(torch.equal(a, b) for a, b in zip(ref, got))
    with pytest.raises(ValueError, match="cannot launch"):
        TF.flash_fwd(q, k, v, seeds, specs, kernel="fwd_kernel", **kw)
    q3, k3, v3 = (x.repeat(1, 1, 3) for x in (q, k, v))   # head dim 48
    with pytest.raises(ValueError, match="cannot launch"):
        TF.flash_fwd(q3, k3, v3, seeds, specs, kernel="flash_fwd", **kw)


# (dk, dv, the kernels K7 and K7' launch): the tiled kernels where dk ==
# dv is compiled, else the first kernels
BWD_PLANS = [
    (64, 64, "flash_bwd_dq", "flash_bwd_dkv"),     # the train step's
    (16, 16, "flash_bwd_dq", "flash_bwd_dkv"),     # the reduced model's
    (32, 32, "flash_bwd_dq", "flash_bwd_dkv"),
    (128, 128, "flash_bwd_dq", "flash_bwd_dkv"),
    (48, 48, "flash_bwd_dq_simple", "flash_bwd_dkv_simple"),
    (8, 8, "flash_bwd_dq_simple", "flash_bwd_dkv_simple"),
    (64, 32, "flash_bwd_dq_simple", "flash_bwd_dkv_simple"),
    (32, 64, "flash_bwd_dq_simple", "flash_bwd_dkv_simple"),
]


@pytest.mark.parametrize("dk,dv,want_dq,want_dkv", BWD_PLANS)
def test_bwd_kernel_choice(dk, dv, want_dq, want_dkv):
    assert TF.bwd_kernel_for(dk, dv, "dq") == want_dq
    assert TF.bwd_kernel_for(dk, dv, "dkv") == want_dkv


def test_bwd_smem_bytes():
    """K7's block: q and dO rows, two k and two v tiles, ds, three row
    statistics; K7''s: k and v rows, a q and a dO tile, p and ds, the
    statistics.  At the train step's d = 64 two blocks of each fit an SM's
    233,472 bytes (1 KB of them reserved per block); every compiled head
    dim fits one block."""
    assert TF.bwd_smem_bytes("dq", 64) == 4 * (2 * 64 * 64 + 4 * 64 * 64
                                               + 64 * 64 + 3 * 64)
    assert TF.bwd_smem_bytes("dq", 64) == 115456
    assert TF.bwd_smem_bytes("dkv", 64) == 4 * (4 * 64 * 64 + 2 * 64 * 64
                                                + 3 * 64)
    assert TF.bwd_smem_bytes("dkv", 64) == 99072
    for grads in ("dq", "dkv"):
        assert 2 * (TF.bwd_smem_bytes(grads, 64) + 1024) <= 233472
        for d in TF.FWD_DIMS:
            assert TF.bwd_smem_bytes(grads, d) <= TF.SMEM_MAX
    with pytest.raises(ValueError, match="grads"):
        TF.bwd_smem_bytes("dx", 64)


def test_flash_bwd_kernel_override_is_checked():
    """``kernel`` may name the first kernel for any shape, the tiled one
    only where it is compiled; anything else raises before any work.  On
    the CPU every choice is the plain twin."""
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(
        np.float32)) for _ in range(4))
    m, l = (torch.from_numpy(rng.random((2, 9)).astype(np.float32) + 1)
            for _ in range(2))
    d = torch.from_numpy(rng.standard_normal((2, 9)).astype(np.float32))
    seeds = rng.integers(0, 2 ** 32, (2, 6), dtype=np.uint64)
    sp = parse_spec("binary8-sr")
    kw = dict(scale=0.25, n_heads=2, n_kv=2, kv_block=4, q_block=4)
    ref_dq = TF.flash_bwd_dq(q, k, v, do, m, l, d, seeds[:, :4], sp, sp,
                             **kw)
    ref_dkv = TF.flash_bwd_dkv(q, k, v, do, m, l, d, seeds, sp, sp, sp, **kw)
    for suffix in ("", "_simple"):
        got = TF.flash_bwd_dq(q, k, v, do, m, l, d, seeds[:, :4], sp, sp,
                              kernel="flash_bwd_dq" + suffix, **kw)
        assert torch.equal(got, ref_dq)
        got = TF.flash_bwd_dkv(q, k, v, do, m, l, d, seeds, sp, sp, sp,
                               kernel="flash_bwd_dkv" + suffix, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, ref_dkv))
    with pytest.raises(ValueError, match="cannot launch"):
        TF.flash_bwd_dq(q, k, v, do, m, l, d, seeds[:, :4], sp, sp,
                        kernel="flash_bwd_dkv", **kw)
    q3, k3, v3 = (x.repeat(1, 1, 3) for x in (q, k, v))   # head dim 48
    with pytest.raises(ValueError, match="cannot launch"):
        TF.flash_bwd_dq(q3, k3, v3, do, m, l, d, seeds[:, :4], sp, sp,
                        kernel="flash_bwd_dq", **kw)
    with pytest.raises(ValueError, match="cannot launch"):
        TF.flash_bwd_dkv(q3, k3, v3, do, m, l, d, seeds, sp, sp, sp,
                         kernel="flash_bwd_dkv", **kw)


def test_profile_serve_needs_a_card():
    """The serving profiler measures the device: with no card it raises
    rather than timing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the profile would run")
    from repro_torch.launch import profile_serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_serve.main([])
