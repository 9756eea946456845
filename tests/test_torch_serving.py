"""The port's serving slice against the JAX reference: the paged decode
twin (K10's plain version), the request-keyed seeds and KV rounding, the
page pool, and the continuous-batching engine on reduced tinyllama.

Inputs come from numpy seeds; the same arrays and seed words go to both
packages.  No fixture outlives its test: the reference's engine is built
inside the test that runs it, with its step functions jitted by the test
(``_reference_engine``), so no compiled step reaches another test.

Tolerances:
* Exact-sum inputs: q and k dyadic and every key of a request the same,
  so each row's logits are equal and exact, every ``exp`` is exp(0) = 1,
  and every sum (q·k, p·v, the row sums) is exact: bitwise.
* N(0, 1) inputs: the float32 sums run in another order and torch's
  ``exp`` differs from XLA's by float32 ulps, so at most max(1, 1e-4 · n)
  output elements may differ (the attention contract).
* Seeds, KV rounding, the pool's scatter and gather: elementwise, bitwise.
* Engine: the token streams of the 5 requests of the reference's engine
  tests (``tests/test_serving.py``) equal the reference engine's, and the
  port's own streams are equal across its three schedules.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core.rounding import parse_spec as jparse
from repro.kernels import common as jcommon
from repro.kernels import flash_attention as JF
from repro.models import build_model as jbuild_model
from repro.precision import attention as jpa
from repro.precision import policy as jp
from repro.serving import engine as jengine
from repro.serving import paged_cache as jpc
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.rounding import grid_flips, parse_spec
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import flash_attention as TF
from repro_torch.models import attention as tattn, build_model
from repro_torch.precision import attention as tpa
from repro_torch.precision import policy as tp
from repro_torch.serving import engine as tengine
from repro_torch.serving import paged_cache as tpc

KV, G, DK = 2, 4, 16
N_MAX, P = 3, 12


@pytest.fixture
def interpret_params(monkeypatch):
    """The reference kernels build ``pltpu.TPUCompilerParams``, which newer
    jax names ``CompilerParams``; alias it only where it is missing."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _bits_equal(ref, got):
    return np.array_equal(np.asarray(ref, np.float32).view(np.int32),
                          got.numpy().view(np.int32))


def _assert_flips(ref, got, fmt):
    n, _ = grid_flips(_t(ref), got, fmt)
    assert n <= max(1, 1e-4 * got.numel()), (n, got.numel())


def _placement(rng, lengths, page):
    """A block table per request: its pages drawn at random from 1..P-1
    (no two requests share one), filler entries 0."""
    free = list(rng.permutation(np.arange(1, P)))
    tables = np.zeros((len(lengths), N_MAX), np.int32)
    for b, n in enumerate(lengths):
        for j in range(-(-n // page)):
            tables[b, j] = free.pop()
    return tables


def _pool(content, tables, page, fill):
    """The logical caches ``content`` (B·KV, N_MAX·page, d) scattered into
    a (P·KV, page, d) pool at ``tables``; unused pages hold ``fill``."""
    B = tables.shape[0]
    pool = np.full((P * KV, page, DK), fill, dtype=content.dtype)
    for b in range(B):
        for j in range(N_MAX):
            if tables[b, j]:
                for h in range(KV):
                    pool[tables[b, j] * KV + h] = \
                        content[b * KV + h, j * page:(j + 1) * page]
    return pool


def _case(rng, page, exact: bool, packed: bool):
    """q, the logical k/v caches and lengths 1, page-1, page, page+1 and
    the full table for five requests.  Exact: dyadic q, k constant along
    each request's positions, dyadic v."""
    lengths = np.array([1, page - 1, page, page + 1, N_MAX * page], np.int32)
    B = len(lengths)
    S = N_MAX * page
    if exact:
        q = (rng.integers(-4, 5, (B * KV, G, DK)) / 4).astype(np.float32)
        k = np.repeat((rng.integers(-4, 5, (B * KV, 1, DK)) / 4), S, axis=1)
        v = rng.integers(-8, 9, (B * KV, S, DK)) / 8
    else:
        q = rng.standard_normal((B * KV, G, DK)).astype(np.float32)
        k = rng.standard_normal((B * KV, S, DK))
        v = rng.standard_normal((B * KV, S, DK))
    k, v = (np.asarray(jparse("e4m3-rn")(jnp.asarray(x.astype(np.float32))))
            for x in (k, v))
    if packed:
        k, v = (np.asarray(jcommon.pack_block(jnp.asarray(x), "e4m3"))
                for x in (k, v))
    return q, k, v, lengths


def _seeds(rng, n):
    return rng.integers(0, 2 ** 32, (n, 6), dtype=np.uint64) \
        .astype(np.uint32)


# ------------------------------------------------------- K10's plain twin --
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name,page,kv_fmt", [("binary8-sr", 8, None),
                                              ("binary8-sr", 16, "e4m3"),
                                              ("binary8-sr-r16", 16, None),
                                              ("binary8-sr-r8", 8, "e4m3")])
def test_paged_twin_matches_reference(exact, name, page, kv_fmt):
    """``flash_decode_paged_plain`` against the reference's jnp replay
    ``flash_decode_paged_reference``: five requests at lengths 1, page-1,
    page, page+1 and the full table, pages at random places, filler
    entries on scratch page 0 (which holds garbage)."""
    rng = np.random.default_rng(page + 3 * exact)
    q, k, v, lengths = _case(rng, page, exact, kv_fmt is not None)
    tables = _placement(rng, lengths, page)
    fill = k.flat[0] if kv_fmt else np.float32(3.0)
    kp, vp = (_pool(x, tables, page, fill) for x in (k, v))
    seeds = _seeds(rng, q.shape[0])
    kw = dict(scale=0.25, n_kv=KV, kv_fmt=kv_fmt)
    ref = JF.flash_decode_paged_reference(
        *map(jnp.asarray, (q, kp, vp, seeds, lengths, tables)),
        [jparse(name)] * 3, **kw)
    got = TF.flash_decode_paged(_t(q), torch.from_numpy(kp),
                                torch.from_numpy(vp), seeds, lengths, tables,
                                [parse_spec(name)] * 3, **kw)
    if exact:
        assert _bits_equal(ref, got)
    else:
        _assert_flips(ref, got, "binary8")


@pytest.mark.parametrize("kv_fmt", [None, "e4m3"])
def test_paged_twin_matches_interpret_kernel(interpret_params, kv_fmt):
    """The twin against ``flash_decode_paged_p`` itself in interpret mode,
    bitwise on exact-sum inputs, at two placements of the same content
    (filler entries on scratch page 0)."""
    rng = np.random.default_rng(41)
    page = 8
    q, k, v, lengths = _case(rng, page, True, kv_fmt is not None)
    seeds = _seeds(rng, q.shape[0])
    specs = [jparse("binary8-sr")] * 3
    for _ in range(2):
        tables = _placement(rng, lengths, page)
        kp, vp = (_pool(x, tables, page, 0) for x in (k, v))
        ref = JF.flash_decode_paged_p(
            *map(jnp.asarray, (q, kp, vp, seeds, lengths, tables)), specs,
            scale=0.25, n_kv=KV, kv_fmt=kv_fmt, interpret=True)
        got = TF.flash_decode_paged(
            _t(q), torch.from_numpy(kp), torch.from_numpy(vp), seeds,
            lengths, tables, [parse_spec("binary8-sr")] * 3, scale=0.25,
            n_kv=KV, kv_fmt=kv_fmt)
        assert _bits_equal(ref, got)


def test_paged_twin_placement_codes_and_contiguous():
    """On N(0, 1) inputs: two placements of the same content give the
    same bits; over code words the same bits as over their values; with
    ``page == kv_block`` the same bits as K9's twin on each request's
    contiguous cache."""
    rng = np.random.default_rng(5)
    page = 16
    q, codes_k, codes_v, lengths = _case(rng, page, False, True)
    seeds = _seeds(rng, q.shape[0])
    specs = [parse_spec("binary8-sr")] * 3
    kw = dict(scale=0.25, n_kv=KV)
    outs = []
    for _ in range(2):
        tables = _placement(rng, lengths, page)
        kp, vp = (torch.from_numpy(_pool(x, tables, page, 0))
                  for x in (codes_k, codes_v))
        codes = TF.flash_decode_paged(_t(q), kp, vp, seeds, lengths, tables,
                                      specs, kv_fmt="e4m3", **kw)
        values = TF.flash_decode_paged(
            _t(q), tcommon.unpack_block(kp, "e4m3"),
            tcommon.unpack_block(vp, "e4m3"), seeds, lengths, tables, specs,
            **kw)
        assert torch.equal(codes.view(torch.int32), values.view(torch.int32))
        outs.append(codes)
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
    for b, n in enumerate(lengths):
        sl = slice(b * KV, (b + 1) * KV)
        contiguous = TF.flash_decode(
            _t(q)[sl], torch.from_numpy(codes_k[sl].copy()),
            torch.from_numpy(codes_v[sl].copy()), seeds[sl], int(n), specs,
            scale=0.25, kv_block=page, kv_fmt="e4m3")
        assert torch.equal(contiguous.view(torch.int32),
                           outs[0][sl].view(torch.int32))


@pytest.mark.parametrize("kv_fmt,dk,dv", [("bfloat16", 16, 8),
                                           ("binary8", 20, 24)])
def test_paged_twin_codes_and_head_dims_match_k9_twin(kv_fmt, dk, dv):
    """The twin over 2-byte codes or binary8's, with dk != dv: bitwise
    K9's twin with ``page == kv_block`` on each request's contiguous
    cache of the same codes (the shapes K10's kernel reads its head dims
    at run time for)."""
    rng = np.random.default_rng(13)
    page, n_max = 5, 3
    lengths = np.array([1, page, page + 1, n_max * page], np.int32)
    B, S = len(lengths), n_max * page
    q = _t(rng.standard_normal((B * KV, G, dk)))
    k, v = (tcommon.pack_block(parse_spec(f"{kv_fmt}-rn")(
        _t(rng.standard_normal((B * KV, S, d)))), kv_fmt) for d in (dk, dv))
    tables = np.arange(1, B * n_max + 1, dtype=np.int32).reshape(B, n_max)
    pool_k, pool_v = (torch.zeros(((B * n_max + 1) * KV, page, x.shape[-1]),
                                  dtype=x.dtype) for x in (k, v))
    for b in range(B):
        for j in range(n_max):
            for h in range(KV):
                row = tables[b, j] * KV + h
                pool_k[row] = k[b * KV + h, j * page:(j + 1) * page]
                pool_v[row] = v[b * KV + h, j * page:(j + 1) * page]
    seeds = _seeds(rng, B * KV)
    specs = [parse_spec("binary8-sr")] * 3
    got = TF.flash_decode_paged(q, pool_k, pool_v, seeds, lengths, tables,
                                specs, scale=dk ** -0.5, n_kv=KV,
                                kv_fmt=kv_fmt)
    assert got.shape == (B * KV, G, dv)
    for b, n in enumerate(lengths):
        sl = slice(b * KV, (b + 1) * KV)
        want = TF.flash_decode(q[sl], k[sl], v[sl], seeds[sl], int(n), specs,
                               scale=dk ** -0.5, kv_block=page,
                               kv_fmt=kv_fmt)
        assert torch.equal(want.view(torch.int32), got[sl].view(torch.int32))


@pytest.mark.parametrize("window", [0, 5])
def test_paged_twin_pages_past_the_length_close_once(window):
    """K10's kernel closes the pages past a request's length once (the
    close maps acc to acc * corr + 0 with corr 1 or 0, which repeats to
    the same bits); the twin replays every one.  Filler entries after the
    last page leave the twin's bits as they are, and the close repeated
    on float32 special values gives what it gives once."""
    rng = np.random.default_rng(9)
    page = 8
    q, codes_k, codes_v, lengths = _case(rng, page, False, True)
    seeds = _seeds(rng, q.shape[0])
    specs = [parse_spec("binary8-sr")] * 3
    tables = _placement(rng, lengths, page)
    kp, vp = (torch.from_numpy(_pool(x, tables, page, 0))
              for x in (codes_k, codes_v))
    kw = dict(scale=0.25, n_kv=KV, window=window, kv_fmt="e4m3")
    base = TF.flash_decode_paged_plain(_t(q), kp, vp, seeds, lengths, tables,
                                       specs, **kw)
    wide = TF.flash_decode_paged_plain(
        _t(q), kp, vp, seeds, lengths,
        np.concatenate([tables, np.zeros((len(lengths), 3), np.int32)], 1),
        specs, **kw)
    assert torch.equal(base.view(torch.int32), wide.view(torch.int32))
    x = torch.tensor([-0.0, 0.0, 1.5, -2.25, 1e-40, float("inf"),
                      -float("inf"), float("nan")])
    for corr in (0.0, 1.0):
        once = x * corr + 0.0
        assert torch.equal((once * corr + 0.0).view(torch.int32),
                           once.view(torch.int32))


def test_paged_kernel_shared_memory():
    """K10's block at the engine's shape (pages of 64, d = 64, e4m3 codes)
    fits the 48 KB a launch takes without opting in.  A page whose logits
    overflow the card's shared memory is refused only on the card: on the
    CPU the twin computes it, bitwise K9's twin with ``kv_block == page``
    on the same cache."""
    assert TF.decode_smem_bytes(64, 64, 64, 1, 4) == \
        128 * 64 + 4 * (64 + 128 + 2 * 32 + 32 * 64 + 4)
    assert TF.decode_smem_bytes(64, 64, 64, 1, 4) <= 48 * 1024
    assert TF.decode_smem_bytes(128, 128, 128, 4, 1024) <= TF.SMEM_MAX
    page = 60000
    assert TF.decode_smem_bytes(page, DK, DK, 4, 1) > TF.SMEM_MAX
    rng = np.random.default_rng(0)
    q = _t(rng.standard_normal((KV, G, DK)))
    pool = [parse_spec("e4m3-rn")(_t(rng.standard_normal((KV, page, DK))))
            for _ in range(2)]
    seeds = _seeds(rng, KV)
    specs = [parse_spec("binary8-sr")] * 3
    got = TF.flash_decode_paged(q, *pool, seeds, [5], [[0]], specs,
                                scale=0.25, n_kv=KV)
    want = TF.flash_decode_plain(q, *pool, seeds, 5, specs, scale=0.25,
                                 kv_block=page)
    assert got.shape == (KV, G, DK)
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# -------------------------------------------------- request-keyed seeds ---
def test_request_words_and_seeds_match_reference():
    rng = np.random.default_rng(9)
    seeds = [0, 7, 100, 2 ** 31 - 1]
    req = np.stack([tpc.request_words(s) for s in seeds])
    ref_req = np.stack([np.asarray(jpc.request_words(s)) for s in seeds])
    assert np.array_equal(req, ref_req)
    lw = tpa.request_layer_words(req, 3)
    assert np.array_equal(lw, np.asarray(jpa.request_layer_words(
        jnp.asarray(ref_req), 3)))
    tags = rng.integers(0, 2 ** 32, (4,), dtype=np.uint64)
    assert np.array_equal(
        tpa.fold_words_vec(req, tags),
        np.asarray(jpa.fold_words_vec(jnp.asarray(ref_req),
                                      jnp.asarray(tags.astype(np.uint32)))))
    positions = np.array([0, 5, 131071, -1])        # -1: an empty slot
    for n_kv in (1, 4):
        got = tpa.request_site_seeds(lw[1], positions, n_kv)
        ref = jpa.request_site_seeds(jnp.asarray(lw[1].astype(np.uint32)),
                                     jnp.asarray(positions, jnp.int32), n_kv)
        assert got.shape == (4 * n_kv, 6)
        assert np.array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("name", ["e4m3-sr", "binary8-sr-r16", "e4m3-rn"])
def test_round_kv_request_matches_reference(name):
    """Bitwise, and the same values for a chunked append and for another
    slot order (each request's bits ride with its words)."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((3, 8, KV, DK)).astype(np.float32)
    words = rng.integers(0, 2 ** 32, (3, 2), dtype=np.uint64)
    pos0 = np.array([0, 5, 17], np.int32)
    ref = jpa.round_kv_request(jnp.asarray(x), jparse(name),
                               jnp.asarray(words.astype(np.uint32)),
                               jnp.asarray(pos0))
    spec = parse_spec(name)
    got = tpa.round_kv_request(_t(x), spec, words, pos0)
    assert _bits_equal(ref, got)
    lo = tpa.round_kv_request(_t(x[:, :3]), spec, words, pos0)
    hi = tpa.round_kv_request(_t(x[:, 3:]), spec, words, pos0 + 3)
    assert torch.equal(torch.cat([lo, hi], 1), got)
    perm = tpa.round_kv_request(_t(x[::-1].copy()), spec, words[::-1],
                                pos0[::-1])
    assert torch.equal(perm.flip(0), got)
    both = tpa.round_kv_request(_t(np.stack([x, x])), spec, words, pos0,
                                stream=(0, 1))
    assert torch.equal(both[0], got)
    assert not torch.equal(both[1], got) or not spec.stochastic


# ------------------------------------------------------------ page pool ---
def test_paged_append_and_gather_match_reference():
    """Appends of a chunk (slot 1 inactive: scratch page 0 row 0) into a
    packed pool, bitwise, and the gathered logical view."""
    rng = np.random.default_rng(17)
    page, n_pages = 8, 10
    pages = rng.integers(0, 256, (n_pages, KV, page, DK)).astype(np.uint8)
    tables = np.array([[3, 7, 0], [5, 0, 0], [2, 9, 4]], np.int32)
    lengths = np.array([6, 2, 13], np.int32)
    append = np.array([True, False, True])
    vals = rng.integers(0, 256, (3, 4, KV, DK)).astype(np.uint8)
    ref = jpc.paged_append(*map(jnp.asarray,
                                (pages, tables, lengths, append, vals)))
    got = tpc.paged_append(torch.from_numpy(pages.copy()),
                           torch.from_numpy(tables), lengths, append,
                           torch.from_numpy(vals))
    mask = np.ones(pages.shape, bool)
    mask[0, :, 0] = False       # duplicate scratch writes: either may win
    assert np.array_equal(np.asarray(ref)[mask], got.numpy()[mask])
    assert np.array_equal(np.asarray(jpc.paged_gather(ref, tables)),
                          tpc.paged_gather(got, torch.from_numpy(tables))
                          .numpy())


def test_block_allocator():
    alloc = tpc.BlockAllocator(total_pages=6)
    assert alloc.free_pages == 5          # page 0 is the scratch page
    a, b = alloc.alloc(2), alloc.alloc(3)
    assert 0 not in a + b and len(set(a + b)) == 5
    assert alloc.alloc(1) is None         # exhausted: the caller waits
    alloc.free(a)
    with pytest.raises(ValueError, match="double free"):
        alloc.free(a)
    with pytest.raises(ValueError, match="out of range"):
        alloc.free([0])                   # the scratch page is never owned
    assert set(alloc.alloc(2)) == set(a)
    with pytest.raises(ValueError):
        tpc.BlockAllocator(1)


def test_kv_fmt_api_and_unpacked_cache():
    assert tp.resolve_kv_cache_fmt(None) is None
    assert tp.resolve_kv_cache_fmt("fp32") is None
    assert tp.resolve_kv_cache_fmt("e4m3-sr") == "e4m3-sr"
    with pytest.raises(Exception):
        tp.resolve_kv_cache_fmt("not-a-spec")
    pol = tp.policy_with_kv_fmt("binary8-paper", "e4m3-sr")
    ref = jp.policy_with_kv_fmt("binary8-paper", "e4m3-sr")
    assert pol.kv_cache_fmt == ref.kv_cache_fmt == "e4m3-sr"
    assert tp.policy_with_kv_fmt(None, None).kv_cache_fmt is None
    unpacked = tp.make_policy(attn=parse_spec("binary8-sr"),
                              kv_cache_fmt="e4m3-sr", kv_cache_packed=False)
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              gemm_policy=unpacked)
    assert tattn.cache_dtype(cfg) == torch.float32
    cfg = dataclasses.replace(cfg, gemm_policy=dataclasses.replace(
        unpacked, kv_cache_packed=True))
    assert tattn.cache_dtype(cfg) == torch.uint8


# --------------------------------------------------------------- engine ---
def _engine_policy(pkg):
    return pkg.make_policy(attn=(jparse if pkg is jp else parse_spec)(
        "binary8-sr"), kv_cache_fmt="e4m3-sr")


def _numpy_params(jparams):
    """The reference's initial distributions drawn by numpy (norm scales
    0, embedding and lm head N(0, 0.02²), projections N(0, 1/fan_in)): its
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


def _requests(pkg, n=5):
    """The reference's engine-test requests (``tests/test_serving.py``)."""
    rng = np.random.default_rng(1)
    return [pkg.Request(rid=i, prompt=rng.integers(1, 128, 5 + 3 * i)
                        .tolist(), max_new_tokens=3 + i, tenant="ab"[i % 2],
                        seed=100 + i) for i in range(n)]


def _engine_cfg(pkg, n_slots, pages):
    return pkg.EngineConfig(n_slots=n_slots, page_size=8, total_pages=pages,
                            max_pages_per_request=4, prefill_chunk=4,
                            token_budget=8)


def _reference_engine(model, params, ecfg):
    """The reference's engine with its two step functions jitted here, as
    its ``_jitted_step`` does, but compiled without XLA's excess precision
    (as every parity test of the port compiles the reference) and from
    functions of this test alone, so no compiled step is shared with
    another test."""
    eng = jengine.ContinuousBatchingEngine(model, params, ecfg)
    opts = {"xla_allow_excess_precision": False}

    def step(params, caches, tokens, pos, rng=None, compute_logits=True):
        return model.decode_step(params, caches, tokens, pos, rng=rng,
                                 compute_logits=compute_logits)

    def decode(params, k_pages, v_pages, tables, lengths, words, append,
               tokens, pos, rng):
        cache = jpc.PagedKVCache(k_pages=k_pages, v_pages=v_pages,
                                 tables=tables, lengths=lengths,
                                 words=words, append=append)
        logits, nc = model.decode_step(params, {"attn": cache}, tokens, pos,
                                       rng=rng, compute_logits=True)
        return (jnp.argmax(logits[:, -1], axis=-1), nc["attn"].k_pages,
                nc["attn"].v_pages)

    eng._step_fn = jax.jit(step, static_argnames=("compute_logits",),
                           compiler_options=opts)
    eng._decode_fn = jax.jit(decode, compiler_options=opts)
    return eng


def _streams(results):
    return {rid: r.tokens for rid, r in results.items()}


def _port_model():
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              gemm_policy=_engine_policy(tp))
    return build_model(cfg)


def test_engine_streams_match_reference(interpret_params):
    """Reduced tinyllama, the same weights in both packages: the port's
    engine serves the 5 requests with the token streams of the
    reference's engine (3 slots, 12 pages, arrivals 0, 0, 1, 4, 6)."""
    cfg = dataclasses.replace(jreduced(jget_config("tinyllama-1.1b")),
                              gemm_policy=_engine_policy(jp))
    jmodel = jbuild_model(cfg)
    jparams = _numpy_params(jax.eval_shape(jmodel.init,
                                           jax.random.PRNGKey(0)))
    arrivals = [0, 0, 1, 4, 6]
    ref = _reference_engine(jmodel, jparams, _engine_cfg(jengine, 3, 12)) \
        .run(_requests(jengine), arrivals=arrivals)
    eng = tengine.ContinuousBatchingEngine(
        _port_model(), convert.params_from_jax(jax.device_get(jparams)),
        _engine_cfg(tengine, 3, 12))
    got = eng.run(_requests(tengine), arrivals=arrivals)
    assert _streams(got) == _streams(ref)
    assert eng.free_pages == 11


def test_engine_streams_bit_identical_across_schedules():
    """The determinism contract on the port: batch widths, page pools,
    arrival orders and co-tenants change nothing in any stream; a
    one-slot replay and a pool smaller than the demand give the same
    streams, and every page comes back."""
    model = _port_model()
    params = model.init(torch.Generator().manual_seed(3))
    reqs = _requests(tengine)
    runs = []
    for n_slots, pages, arrivals in ((3, 12, [0, 0, 1, 4, 6]),
                                     (2, 9, [2, 0, 5, 0, 1]),
                                     (3, 5, [0] * 5),
                                     (1, 5, [0, 1, 2, 3, 4])):
        eng = tengine.ContinuousBatchingEngine(
            model, params, _engine_cfg(tengine, n_slots, pages))
        res = eng.run([dataclasses.replace(r) for r in reqs],
                      arrivals=arrivals)
        assert eng.free_pages == pages - 1
        assert all(len(res[r.rid].tokens) == r.max_new_tokens for r in reqs)
        runs.append(_streams(res))
    assert all(r == runs[0] for r in runs[1:])


def test_engine_submit_validation():
    model = _port_model()
    params = model.init(torch.Generator().manual_seed(0))
    eng = tengine.ContinuousBatchingEngine(model, params, tengine.EngineConfig(
        n_slots=2, page_size=8, total_pages=8, max_pages_per_request=2))
    eng.submit(tengine.Request(rid=1, prompt=[3, 4], max_new_tokens=2))
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(tengine.Request(rid=1, prompt=[3], max_new_tokens=1))
    with pytest.raises(ValueError):
        eng.submit(tengine.Request(rid=2, prompt=[], max_new_tokens=1))
    with pytest.raises(ValueError, match="pages"):
        # needs ceil((20 + 20) / 8) = 5 pages > table width 2
        eng.submit(tengine.Request(rid=3, prompt=list(range(1, 21)),
                                   max_new_tokens=20))
    assert eng.cancel(1)
    assert not eng.cancel(99)


def test_qattn_decode_paged_matches_reference():
    """The paged decode wrapper of the precision layer: request×layer
    words -> per-(request, position, kv head) site seeds -> K10's twin,
    against the reference's (its oracle branch, the jnp replay), bitwise
    on exact-sum inputs."""
    rng = np.random.default_rng(29)
    page = 8
    q, k, v, lengths = _case(rng, page, True, True)
    B = len(lengths)
    tables = _placement(rng, lengths, page)
    kp, vp = (_pool(x, tables, page, 0).reshape(P, KV, page, DK)
              for x in (k, v))
    q4 = q.reshape(B, 1, KV * G, DK)
    words = rng.integers(0, 2 ** 32, (B, 2), dtype=np.uint64)
    jpol = jp.make_policy(attn=jparse("binary8-sr"), kv_cache_fmt="e4m3-sr",
                          oracle=True)
    ref = jpa.qattn_decode_paged(
        *map(jnp.asarray, (q4, kp, vp, lengths, tables)),
        jnp.asarray(words.astype(np.uint32)), jpol, scale=0.25,
        kv_fmt="e4m3")
    got = tpa.qattn_decode_paged(_t(q4), torch.from_numpy(kp),
                                 torch.from_numpy(vp), lengths, tables,
                                 words, _engine_policy(tp), scale=0.25,
                                 kv_fmt="e4m3")
    assert _bits_equal(ref, got)


def test_prefill_matches_reference():
    """``Model.prefill`` on reduced tinyllama with an e4m3-SR KV cache (the
    cache store is what prefill adds; the rounded attention sites are
    ``qattention``'s, tested in tests/test_torch_attention.py): the
    emitted cache's codes (layer 0 bitwise; layer 1's inputs went through
    layer 0's SR roundings, as in the serving test) and the next-token
    logits against the reference's, and ``prime_cache_lengths``."""
    cfg = dataclasses.replace(jreduced(jget_config("tinyllama-1.1b")),
                              gemm_policy=jp.make_policy(
                                  kv_cache_fmt="e4m3-sr"))
    jmodel = jbuild_model(cfg)
    jparams = _numpy_params(jax.eval_shape(jmodel.init,
                                           jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(2).integers(0, 128, (2, 7))
    jlogits, jcaches = jax.jit(
        lambda p, t: jmodel.prefill(p, {"tokens": t}, max_len=10),
        compiler_options={"xla_allow_excess_precision": False})(
            jparams, jnp.asarray(tokens))
    model = build_model(dataclasses.replace(
        reduced(get_config("tinyllama-1.1b")),
        gemm_policy=tp.make_policy(kv_cache_fmt="e4m3-sr")))
    logits, caches = model.prefill(
        convert.params_from_jax(jax.device_get(jparams)),
        {"tokens": torch.from_numpy(tokens)}, max_len=10)
    c = caches["attn"]
    assert c.length == 7 and c.k.dtype == torch.uint8
    assert np.array_equal(np.asarray(jcaches["attn"].k)[0],
                          c.k[0].transpose(1, 2).numpy())
    assert np.array_equal(np.asarray(jcaches["attn"].v)[0],
                          c.v[0].transpose(1, 2).numpy())
    d = np.abs(logits.float().numpy() - np.asarray(jlogits, np.float32))
    assert d.max() < 0.02, float(d.max())
    assert model.prime_cache_lengths(caches, 9)["attn"].length == 9


def test_engine_profile_needs_a_card():
    """The engine's trace measures the device: with no card it raises
    rather than timing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the profile would run")
    from repro_torch.launch import profile_serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_serve.main(["--engine"])


def test_run_engine_reports_the_run():
    """``serve.run_engine`` on the CPU at a tiny size: every request gets
    its tokens, the pool is the policy's uint8 codes of every layer, and
    the run's numbers are reported."""
    from repro_torch.launch import serve as tserve
    ec = tengine.EngineConfig(n_slots=2, page_size=8, total_pages=6,
                              max_pages_per_request=2, prefill_chunk=4,
                              token_budget=8)
    out = tserve.run_engine("tinyllama-1.1b", reduced=True, device="cpu",
                            n_short=2, n_long=1, short=(3, 2), long=(9, 3),
                            long_every=0, engine=ec, verbose=False)
    cfg = reduced(get_config("tinyllama-1.1b"))
    assert {rid: len(t) for rid, t in out["tokens"].items()} == \
        {0: 2, 1: 2, 2: 3}
    assert out["engine"].free_pages == 5
    assert out["pool_bytes"] == 2 * cfg.n_layers * 6 * cfg.n_kv_heads * 8 \
        * cfg.resolved_head_dim
    assert out["tokps"] > 0 and out["ttft_p99_s"] >= out["ttft_p50_s"] > 0
    assert out["decode_steps"] == out["engine"].decode_steps > 0
