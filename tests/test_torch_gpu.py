"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``; each test decides in a fixture whether there is a card and
skips without one.  This file imports neither jax nor the JAX package, so
it runs on a machine that has only PyTorch:

  python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: the update kernels (K2', K2) and the momentum FMA are bitwise
equal to their twins on any input; the GEMM kernels are bitwise on exact-sum inputs (dyadic
values, every partial sum exact); on N(0, 1) inputs at most 1e-4 of the
elements may differ (the summation order differs from the twin's
torch.matmul).  A qmatmul output then differs by one grid step
(``rounding.grid_flips``); in the fused kernel a flip of a rounded branch
propagates through silu(g) * u, so only the share is bounded for its
hidden.  K3' and K3 are held so on both their routes (the decode route and
the large-M route, a route forced by setting ``qmatmul.DECODE_MAX_M``),
which sum in one order: they agree bitwise on any input, the decode
route's rows are bit for bit the same whatever rows share the call, and a
sum that underflows to -0 keeps its sign exactly where K is a multiple of
16 (each chain's zero padding).  K4' and K4 run the same two routes and are
held so too: their routes bitwise equal in h and the residuals, float32 or
packed, through unaligned views, and for K below 16.  The attention kernels: the rounded
logits and their row max bitwise on exact-sum inputs; out, dq, dk, dv at most max(1, 1e-4 n)
elements different on N(0, 1) inputs (float32 sums in another order, a
value within an ulp of a rounding decision); K9 over packed codes bitwise
K9 over the same values unpacked; K6's single pass bitwise equal to its
two-pass kernel in every output on any input (the same operations in the
same order); K9 on the decode kernel bitwise equal to its tiled kernel
(``kernel="flash_decode_tiled"``) on any input, blocks that do not fit
the decode kernel going to the tiled one; K7 and K7' on their tiled
kernels bitwise equal to their first kernels (``kernel=
"flash_bwd_dq_simple"`` / ``"flash_bwd_dkv_simple"``) in dq, dk and dv
on any input, head dims the tiled kernels are not compiled for going to
the first ones.  K10 (paged decode) bitwise equal to its
twin on exact-sum inputs (every key of a request equal: each logit of a
row equal, every exp exactly 1, every sum exact), within the attention
contract on N(0, 1) inputs, bitwise equal to K9's tiled kernel on each
request's contiguous cache with ``kv_block == page`` (pages of 5 to 128 keys, head
dims 16 to 128, G = 1 to 8, windows, codes and float32 pools, and every
compiled instance of its kernel: 2-byte codes, head dims outside 16, 32,
64 and 128, dk != dv, pools off 16-byte boundaries), the same bits at
two placements of the same content and over codes as over their values;
pages whose logits overflow shared memory are refused on the card.
The SR cast (K1') is bitwise on any input, its path instance bitwise its
generic one; the batched GEMM (K8') is held
to the GEMM contract on both its routes (the weight-stream route and the
large-M route, a route forced by setting ``qmatmul.BATCHED_STREAM_MAX_M``),
which sum in one order: they agree bitwise on any input, and a sum that
underflows to -0 keeps its sign for every K.  K5 (the
fused QAdam step), both its compiled instances, is bitwise equal to its
twin in x, the moment codes or values and the Kahan carries, on any
input.  The reduced
qwen3-moe decoder on the card against the CPU twins: the serve test's
statistical logit bound (a GEMM sum flipped upstream moves an SR
decision by a grid ulp, which propagates).  The explicit-bits kernels
(K3, K4, K8) are bitwise equal to their in-kernel-bits kernels fed the
same words on any input (one main loop), and to their twins under the
GEMM contract; K1 and K1''s signed-SRe branch bitwise on any input, K1's
path instance bitwise its generic one;
packed outputs are bitwise the codes of the float outputs, packed
operands sum bitwise as their values.  K7 and K7' at head dim 256
(32-row blocks) are held as at the other head dims; the GeGLU pullback
kernel is bitwise its twin on any input (any NaN equal to any NaN).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import gd
from repro_torch.core.prng import int32_words
from repro_torch.core.rounding import grid_flips, parse_spec, spec
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_update as tfu
from repro_torch.kernels import qmatmul as tq
from repro_torch.kernels import sr_cast as tsr

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


def _route(monkeypatch, route):
    """K3'/K3's route: "auto" as the wrapper picks it by M, "decode" or
    "large" (the large-M route) forced."""
    if route == "decode":
        monkeypatch.setattr(tq, "DECODE_MAX_M", 1 << 30)
    elif route == "large":
        monkeypatch.setattr(tq, "DECODE_MAX_M", 0)


# (route, M, K, N): the decode and train shapes, the threshold's
# neighbours (DECODE_MAX_M = 16), ragged and single-chunk shapes, and each
# route forced where the wrapper would pick the other
QMATMUL_CASES = [
    ("auto", 4, 2048, 256), ("auto", 37, 45, 70), ("auto", 128, 5632, 2048),
    ("auto", 4, 2048, 32000), ("auto", 4, 2048, 2048),
    ("auto", 4, 5632, 2048), ("auto", 1, 2048, 256), ("auto", 8, 520, 70),
    ("auto", 15, 2048, 256), ("auto", 16, 2048, 256),
    ("auto", 17, 2048, 256), ("auto", 1024, 2048, 256),
    ("auto", 1024, 256, 2048), ("decode", 37, 45, 70),
    ("decode", 128, 600, 136), ("decode", 5, 1000, 9),
    ("decode", 6, 3000, 70), ("large", 4, 2048, 256), ("large", 16, 520, 70)]


@pytest.mark.gpu
@pytest.mark.parametrize("route,M,K,N", QMATMUL_CASES)
def test_qmatmul_kernel_matches_plain(cuda, monkeypatch, route, M, K, N):
    """K3' on both routes: bitwise the twin on exact sums (bf16 and
    float32 B), the GEMM contract on N(0, 1) inputs."""
    _route(monkeypatch, route)
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
    got = tq.qmatmul_prng(a, b, SEEDS[0], "binary8")
    assert _same(got, tq.qmatmul_plain(a, b, SEEDS[0], "binary8"))
    a = _normal((M, K), M + 1).to(cuda)
    b = _normal((K, N), N + 1, K ** -0.5).to(cuda)
    got = tq.qmatmul_prng(a, b, SEEDS[1], "binary8")
    ref = tq.qmatmul_plain(a, b, SEEDS[1], "binary8")
    _assert_flips(ref, got, "binary8")
    again = tq.qmatmul_prng(a, b, SEEDS[1], "binary8")
    assert _same(got, again)                     # deterministic
    bf = b.to(torch.bfloat16)
    _assert_flips(tq.qmatmul_plain(a, bf, SEEDS[1], "binary8"),
                  tq.qmatmul_prng(a, bf, SEEDS[1], "binary8"), "binary8")


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", [(2048, 256), (5632, 2048), (600, 70),
                                 (64, 130), (3000, 4)])
def test_qmatmul_decode_rows_independent_of_m(cuda, K, N):
    """The decode route's rows are bit for bit the same whatever rows share
    the call: the same A rows at M = 1, 2, 4, 8 and at the threshold."""
    m_max = tq.DECODE_MAX_M
    a = _normal((m_max, K), K).to(cuda)
    b = _normal((K, N), N, K ** -0.5).to(cuda).to(torch.bfloat16)
    full = tq.qmatmul_prng(a, b, SEEDS[2], "binary8")
    bits = _bits(cuda, SEEDS[2], (m_max, N), 32)
    full_bits = tq.qmatmul(a, b, bits, "binary8")
    assert _same(full, full_bits)
    for m in (1, 2, 3, 4, 5, 8, m_max - 1):
        got = tq.qmatmul_prng(a[:m], b, SEEDS[2], "binary8")
        assert _same(got, full[:m]), m
        assert _same(tq.qmatmul(a[:m], b, bits[:m], "binary8"), full[:m]), m
    # one A row at every position of the call (bits are keyed by the row,
    # so round to nearest): every row sums the same
    rows = a[2:3].expand(m_max, K).contiguous()
    got = tq.qmatmul_prng(rows, b, SEEDS[2], "binary16", "rn")
    assert all(_same(got[i], got[0]) for i in range(m_max))


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 16, 45, 64, 2048, 5632])
def test_qmatmul_routes_agree(cuda, monkeypatch, K):
    """The two routes sum each output in the same order: bitwise equal on
    N(0, 1) inputs, for K3' and K3."""
    M, N = 9, 200
    a = _normal((M, K), K).to(cuda)
    b = _normal((K, N), K + 1, K ** -0.5).to(cuda).to(torch.bfloat16)
    bits = _bits(cuda, SEEDS[0], (M, N), 32)
    outs = {}
    for route in ("decode", "large"):
        _route(monkeypatch, route)
        outs[route] = (tq.qmatmul_prng(a, b, SEEDS[0], "binary8"),
                       tq.qmatmul(a, b, bits, "binary8"))
    assert _same(outs["decode"][0], outs["large"][0])
    assert _same(outs["decode"][1], outs["large"][1])
    assert _same(outs["decode"][0], outs["decode"][1])


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["decode", "large"])
def test_qmatmul_negative_zero_sums(cuda, monkeypatch, route):
    """Sums that underflow to -0 leave as -0 where K is a multiple of 16
    and as +0 otherwise (each chain runs over K rounded up to 16 with
    zeros, and fmaf(0, 0, -0) is +0), on both routes and on both sides of
    their stage depths."""
    _route(monkeypatch, route)
    for K in (16, 45, 48, 300, 2048, 2050, 2064, 3001):
        a = torch.full((5, K), -1e-30, device=cuda)
        b = torch.full((K, 40), 1e-20, device=cuda)
        got = tq.qmatmul_prng(a, b, SEEDS[0], "binary16", "rn")
        torch.cuda.synchronize()
        assert bool((got == 0).all()), K
        assert bool(torch.signbit(got).all()) == (K % 16 == 0), K
        assert bool(torch.signbit(got).any()) == (K % 16 == 0), K


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["decode", "large"])
@pytest.mark.parametrize("M,K,N,bdt", [(4, 2048, 256, "bf16"),
                                       (6, 600, 70, "bf16"),
                                       (40, 300, 136, "f32"),
                                       (40, 301, 70, "f32")])
def test_qmatmul_routes_unaligned_views(cuda, monkeypatch, route, M, K, N,
                                        bdt):
    """Views at a 4-byte offset (A, B, both) and row lengths that allow no
    vector loads run the element-load instances: bitwise the aligned
    call."""
    _route(monkeypatch, route)
    dt = torch.bfloat16 if bdt == "bf16" else torch.float32
    a = _normal((M, K), 1).to(cuda)
    b = _normal((K, N), 2, K ** -0.5).to(cuda).to(dt)
    ref = tq.qmatmul_prng(a, b, SEEDS[1], "e4m3")
    av = torch.empty(M * K + 1, device=cuda)[1:].view(M, K)
    av.copy_(a)
    step = 2 if dt == torch.bfloat16 else 1      # 4 bytes
    bv = torch.empty(K * N + step, dtype=dt, device=cuda)[step:].view(K, N)
    bv.copy_(b)
    assert av.data_ptr() % 16 and bv.data_ptr() % 16
    for x, y in ((av, b), (a, bv), (av, bv)):
        got = tq.qmatmul_prng(x, y, SEEDS[1], "e4m3")
        torch.cuda.synchronize()
        assert _same(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["decode", "large"])
@pytest.mark.parametrize("M,K,N", [(4, 2048, 5632), (37, 45, 70),
                                   (128, 2048, 5632)])
def test_swiglu_kernel_matches_plain(cuda, monkeypatch, route, M, K, N):
    """K4' on both routes: the GEMM contract on N(0, 1) inputs."""
    _route(monkeypatch, route)
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
    assert tq.LAUNCHES == dict(dict.fromkeys(tq.LAUNCHES, 0), qmatmul_sr=1,
                               qmatmul_swiglu_sr=1)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["decode", "large"])
@pytest.mark.parametrize("M,K,N", [(37, 45, 70), (256, 2048, 5632),
                                   (4, 8, 70), (1024, 96, 5632)])
def test_swiglu_kernel_residuals_match_plain(cuda, monkeypatch, route, M, K,
                                             N):
    """The rounded branches g_r, u_r the backward needs: bitwise on
    exact-sum inputs, on both routes (K = 8: the chains pad past K)."""
    _route(monkeypatch, route)
    x = _exact((M, K), 8.0, 3).to(cuda)
    wg = _exact((K, N), 4.0, 4).to(cuda).to(torch.bfloat16)
    wu = _exact((K, N), 4.0, 5).to(cuda).to(torch.bfloat16)
    act = ACT_SPECS["binary8-sr"]
    got = tq.qmatmul_swiglu_prng(x, wg, wu, SEEDS, "binary8", act_spec=act,
                                 residuals=True)
    ref = tq.qmatmul_swiglu_plain(x, wg, wu, SEEDS, "binary8", act_spec=act,
                                  residuals=True)
    torch.cuda.synchronize()
    for r, g in zip(ref[1:], got[1:]):
        assert torch.equal(r.view(torch.int32), g.view(torch.int32))
    _assert_flips(ref[0], got[0], "binary8", adjacent_only=False)


UPDATE_CONFIGS = [
    ("binary8-rn", "binary8-sr", "binary8-signed_sr_eps-e0.1", "self"),
    ("binary8-rn", "binary8-sr_eps-e0.1", "binary8-sr", "self"),
    ("binary8-sr-r16", "binary8-sr-r16", "binary8-sr-r16", "self"),
    ("binary8-rn", "binary8-rn", "binary8-rn", "self"),
    ("bf16-rn", "bf16-sr", "bf16-signed_sr_eps-e0.1", "self"),
    ("e4m3-signed_sr_eps-e0.3", "fp32", "e4m3-sr", "neg_grad"),
    ("e4m3-rn", "e4m3-sr", "e4m3-signed_sr_eps-e0.2", "self"),
]


def _update_inputs(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 0.05).astype(np.float32)
    g = (rng.standard_normal(n) * 0.3).astype(np.float32)
    g[::13] = 0.0
    x[2::23] = 1e-40          # float32 subnormals: flushed by the rounding
    g[4::31] = 7e4            # beyond binary8's xmax: saturates
    return torch.from_numpy(x), torch.from_numpy(g)


def _off_boundary(t, cuda, offset):
    """``t`` on the card, starting ``offset`` elements past a 16-byte
    boundary (a view of a larger buffer)."""
    if not offset:
        return t.to(cuda)
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype)
    buf[offset:] = t.reshape(-1)
    return buf.to(cuda)[offset:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 5, 129, 128 * 3 + 5, 2 ** 20 + 37])
@pytest.mark.parametrize("names", UPDATE_CONFIGS,
                         ids=["-".join(c[:3]) for c in UPDATE_CONFIGS])
def test_update_kernels_match_plain(cuda, n, names, offset):
    """K2' and K2 bitwise their twins under every compiled instance the
    config fits (the generic and wide ones; the trainer's chain: all
    three), tails of 1 to 3 elements past
    the last group of four, and (``offset`` 1) x, g and the bit rows off a
    16-byte boundary."""
    cfg = gd.GDRounding(*(parse_spec(s) for s in names[:3]),
                        grad_v=names[3])
    instances = ["generic", "wide"] + (["trainer"] if tfu.k2_instance(cfg)
                                       == "trainer" else [])
    x, g = _update_inputs(n, n)
    seed = (0x1234ABCD, 0x0BADF00D)
    bits3 = torch.from_numpy(np.random.default_rng(n).integers(
        0, 2 ** 32, (3, n), dtype=np.uint64).astype(np.int64))
    words = int32_words(bits3)
    ref_prng = tfu.fused_qupdate_prng(x, g, 0.05, seed, cfg)
    ref_bits = tfu.fused_qupdate(x, g, 0.05, bits3, cfg)
    xc, gc = _off_boundary(x, cuda, offset), _off_boundary(g, cuda, offset)
    wc = _off_boundary(words, cuda, offset)
    for instance in instances:
        got = tfu.fused_qupdate_prng(xc, gc, 0.05, seed, cfg,
                                     instance=instance)
        torch.cuda.synchronize()
        assert torch.equal(ref_prng.view(torch.int32),
                           got.cpu().view(torch.int32)), instance
        got = tfu.fused_qupdate(xc, gc, 0.05, wc, cfg, instance=instance)
        torch.cuda.synchronize()
        assert torch.equal(ref_bits.view(torch.int32),
                           got.cpu().view(torch.int32)), instance
    if offset == 0:   # K2 fed int64 words as well
        got = tfu.fused_qupdate(xc, gc, 0.05, bits3.to(cuda), cfg)
        torch.cuda.synchronize()
        assert torch.equal(ref_bits.view(torch.int32),
                           got.cpu().view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("names", UPDATE_CONFIGS[1:6],
                         ids=["-".join(c[:3]) for c in UPDATE_CONFIGS[1:6]])
def test_update_trainer_instance_refuses_generic_config(cuda, names):
    """The trainer entry of K2' and K2 refuses a chain that is not the
    trainer's (the C entry's check, not the wrapper's choice)."""
    cfg = gd.GDRounding(*(parse_spec(s) for s in names[:3]),
                        grad_v=names[3])
    assert tfu.k2_instance(cfg) == "generic"
    x, g = (t.to(cuda) for t in _update_inputs(300, 2))
    bits3 = torch.zeros((3, 300), dtype=torch.int32, device=cuda)
    tfu.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        tfu.fused_qupdate_prng(x, g, 0.05, (1, 2), cfg, instance="trainer")
    with pytest.raises(RuntimeError, match="launch failed"):
        tfu.fused_qupdate(x, g, 0.05, bits3, cfg, instance="trainer")
    assert tfu.LAUNCHES["fused_qupdate_prng"] == 0
    assert tfu.LAUNCHES["fused_qupdate_bits"] == 0


# the wide instance's spec families (chip_smoke.py's phase 4): fixed
# point, sr2 at r = 8, 16 and 32, the bit trick (bf16's integer path and
# the complemented draw elsewhere), the directed roundings, overflow to
# +-inf on overflowing inputs, a shifted grid, a format without
# subnormals, signed-SRe under overflow to +-inf
WIDE_UPDATE_CONFIGS = [
    ("fxp16.8-sr2", "fxp16.8-sr", "fxp8.4-rn", "self", 1.0),
    ("binary8-rn", "binary8-sr2", "binary8-sr2-r16", "self", 1.0),
    ("binary8-sr2-r32", "binary8-sr2-r32", "binary8-sr", "self", 1.0),
    ("bf16-rn", "bf16-sr-bittrick", "bf16-sr-bittrick-r8", "self", 1.0),
    ("binary8-rz", "binary8-ra", "binary8-rd", "self", 1.0),
    ("binary8-ru", "fp32", "binary8-ru", "self", 1.0),
    ("binary8-rn-inf", "binary8-sr-inf", "binary8-rn-inf", "self", 3e5),
    ("shift8-rn", "shift8-sr", "shift8-signed_sr_eps-e0.2", "grad", 1.0),
    ("b8nosub-sr", "b8nosub-rn", "b8nosub-sr_eps-e0.1", "self", 1e-3),
    ("e4m3-rn", "e4m3-sr", "e4m3-signed_sr_eps-e0.3-inf", "grad", 3e3),
]


def register_wide_grids():
    """The shifted grid and the format without subnormals of
    ``WIDE_UPDATE_CONFIGS`` (idempotent)."""
    from repro_torch.core import formats, grids
    grids.register_grid(grids.shifted_grid("binary8", 0.5, 0.25,
                                           name="shift8"))
    formats.register_format(formats.FPFormat("b8nosub", 3, -14, 15,
                                             subnormals=False))


def _wide_cfg(names):
    register_wide_grids()
    return gd.GDRounding(*(parse_spec(s) for s in names[:3]),
                         sub_v=names[3])


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 5, 129, 128 * 3 + 5, 2 ** 20 + 37])
@pytest.mark.parametrize("names", WIDE_UPDATE_CONFIGS,
                         ids=["-".join(c[:3]) for c in WIDE_UPDATE_CONFIGS])
def test_update_wide_instance_matches_plain(cuda, n, names, offset):
    """K2' and K2 on their wide instance (every scheme x grid x overflow
    pair of the reference's round_block) bitwise their twins, at ragged
    tails and off a 16-byte boundary; K2 fed the words K2' draws bitwise
    K2'."""
    cfg = _wide_cfg(names)
    assert tfu.k2_instance(cfg) == "wide"
    x, g = _update_inputs(n, n)
    x[5::19] = -0.0
    g = g * names[4]
    seed = (0x1234ABCD, 0x0BADF00D)
    bits3 = torch.from_numpy(np.random.default_rng(n).integers(
        0, 2 ** 32, (3, n), dtype=np.uint64).astype(np.int64))
    ref_prng = tfu.fused_qupdate_prng(x, g, 0.05, seed, cfg)
    ref_bits = tfu.fused_qupdate(x, g, 0.05, bits3, cfg)
    xc, gc = _off_boundary(x, cuda, offset), _off_boundary(g, cuda, offset)
    wc = _off_boundary(int32_words(bits3), cuda, offset)
    got = tfu.fused_qupdate_prng(xc, gc, 0.05, seed, cfg)
    torch.cuda.synchronize()
    assert torch.equal(ref_prng.view(torch.int32), got.cpu().view(torch.int32))
    got = tfu.fused_qupdate(xc, gc, 0.05, wc, cfg)
    torch.cuda.synchronize()
    assert torch.equal(ref_bits.view(torch.int32), got.cpu().view(torch.int32))
    # K2 on K2''s own words: kernel_bits3's planes of the flat layout
    rows = -(-n // tfu.LANES)
    planes = tcommon.kernel_bits3(seed, (rows, tfu.LANES), 0, tfu.need(cfg))
    own = torch.stack([torch.zeros(n, dtype=torch.int64) if p is None
                       else p.reshape(-1)[:n] for p in planes])
    got = tfu.fused_qupdate(xc, gc, 0.05,
                            _off_boundary(int32_words(own), cuda, offset),
                            cfg)
    torch.cuda.synchronize()
    assert torch.equal(ref_prng.view(torch.int32), got.cpu().view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("instance", ["generic", "trainer"])
def test_update_narrow_instances_refuse_wide_chain(cuda, instance):
    """The generic and trainer entries of K2' and K2 refuse a chain that
    needs the wide instance (the C entry's check)."""
    cfg = _wide_cfg(WIDE_UPDATE_CONFIGS[0])
    x, g = (t.to(cuda) for t in _update_inputs(300, 2))
    bits3 = torch.zeros((3, 300), dtype=torch.int32, device=cuda)
    tfu.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        tfu.fused_qupdate_prng(x, g, 0.05, (1, 2), cfg, instance=instance)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfu.fused_qupdate(x, g, 0.05, bits3, cfg, instance=instance)
    assert tfu.LAUNCHES["fused_qupdate_prng"] == 0
    assert tfu.LAUNCHES["fused_qupdate_bits"] == 0


@pytest.mark.gpu
def test_update_kernels_count_their_launches(cuda):
    tfu.reset_launches()
    cfg = gd.make_config("binary8")
    x, g = (t.to(cuda) for t in _update_inputs(300, 1))
    tfu.fused_qupdate_prng(x, g, 0.1, (1, 2), cfg)
    tfu.fused_qupdate_prng_plain(x, g, 0.1, (1, 2), cfg)
    bits3 = torch.zeros((3, 300), dtype=torch.int32, device=cuda)
    tfu.fused_qupdate(x, g, 0.1, bits3, cfg)
    tfu.fused_qupdate(x[:0], g[:0], 0.1, bits3[:, :0], cfg)
    tfu.momentum_fma(0.9, x, g)
    tfu.momentum_fma_plain(0.9, x, g)
    assert tfu.LAUNCHES == {"fused_qupdate_prng": 1, "fused_qupdate_bits": 1,
                            "momentum_fma": 1, "fused_qadam_prng": 0}
    assert tfu.INSTANCE_LAUNCHES == {"generic": 2, "trainer": 0, "wide": 0}
    tfu.fused_qupdate_prng(x, g, 0.1, (1, 2), _wide_cfg(
        WIDE_UPDATE_CONFIGS[0]))
    assert tfu.INSTANCE_LAUNCHES == {"generic": 2, "trainer": 0, "wide": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 128 * 3 + 5, 2 ** 20 + 37])
def test_momentum_fma_kernel_matches_plain(cuda, n):
    """One rounding of 0.9 * m + g, subnormal operands and results
    flushed, as the float64 emulation computes it."""
    m, g = _update_inputs(n, n + 1)
    m[5::41] = 2e-38              # normal operands, subnormal results
    g[5::41] = -1.7e-38
    ref = tfu.momentum_fma(0.9, m, g)
    got = tfu.momentum_fma(0.9, m.to(cuda), g.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(ref.view(torch.int32), got.cpu().view(torch.int32))


# (B·H, B·KV, S, q_block, kv_block, q_offset, causal, spec): one logical
# block; multi-block with ragged tails; r16 / r8 draws; e4m3 sites
FLASH_CASES = [
    (16, 4, 50, 1024, 1024, 0, True, "binary8-sr"),
    (16, 4, 50, 16, 32, 0, True, "binary8-sr"),
    (8, 2, 200, 64, 64, 5, True, "binary8-sr-r16"),
    (8, 8, 77, 32, 16, 0, False, "binary8-sr-r8"),
    (16, 4, 64, 64, 64, 0, True, "e4m3-rn"),
]


def _flash_inputs(BH, BKV, S, q_offset, exact, dev):
    make = (lambda sh, sd: _exact(sh, 8.0, sd)) if exact else _normal
    return [make(sh, sd).to(dev) for sd, sh in enumerate((
        (BH, S, 64), (BKV, S + q_offset, 64), (BKV, S + q_offset, 64),
        (BH, S, 64)))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_flash_kernels_match_plain(cuda, case):
    BH, BKV, S, qb, kb, q_offset, causal, name = case
    fmt = name.split("-")[0]
    specs = [parse_spec(name)] * 3
    seeds = np.random.default_rng(S).integers(0, 2 ** 32, (BH, 6),
                                              dtype=np.uint64)
    kw = dict(scale=0.125, n_heads=BH // 2, n_kv=BKV // 2, causal=causal,
              q_block=qb, kv_block=kb, q_offset=q_offset)   # batch 2
    # exact sums: the rounded logits and their row max bitwise
    q, k, v, _ = _flash_inputs(BH, BKV, S, q_offset, True, cuda)
    got = tfa.flash_fwd(q, k, v, seeds, specs, return_logits=True, **kw)
    ref = tfa.flash_fwd_plain(q, k, v, seeds, specs, return_logits=True,
                              **kw)
    torch.cuda.synchronize()
    for i in (1, 3):
        assert torch.equal(got[i].view(torch.int32), ref[i].view(torch.int32))
    # N(0, 1) inputs: forward and both backward kernels
    q, k, v, do = _flash_inputs(BH, BKV, S, q_offset, False, cuda)
    out, m, l = tfa.flash_fwd(q, k, v, seeds, specs, **kw)
    r_out, r_m, r_l = tfa.flash_fwd_plain(q, k, v, seeds, specs, **kw)
    torch.cuda.synchronize()
    _assert_flips(r_out, out, fmt, adjacent_only=False,
                  share=max(1e-4, 1.0 / out.numel()))
    assert torch.allclose(l, r_l, rtol=1e-5, atol=0)
    d = (do * r_out).sum(-1)
    sq = np.concatenate([seeds[:, :2], seeds[:, 4:]], axis=1)
    dq = tfa.flash_bwd_dq(q, k, v, do, r_m, r_l, d, sq, specs[0], specs[0],
                          **kw)
    r_dq = tfa.flash_bwd_dq_plain(q, k, v, do, r_m, r_l, d, sq, specs[0],
                                  specs[0], **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, r_m, r_l, d, seeds, specs[0],
                               specs[0], specs[1], **kw)
    r_dk, r_dv = tfa.flash_bwd_dkv_plain(q, k, v, do, r_m, r_l, d, seeds,
                                         specs[0], specs[0], specs[1], **kw)
    torch.cuda.synchronize()
    for r, g in ((r_dq, dq), (r_dk, dk), (r_dv, dv)):
        _assert_flips(r, g, fmt, adjacent_only=False,
                      share=max(1e-4, 1.0 / g.numel()))


@pytest.mark.gpu
@pytest.mark.parametrize("kb", [16, 1024])
def test_flash_decode_kernel_matches_plain(cuda, kb):
    BKV, G, Smax = 16, 8, 48
    specs = [parse_spec("binary8-sr")] * 3
    seeds = np.random.default_rng(kb).integers(0, 2 ** 32, (BKV, 6),
                                               dtype=np.uint64)
    q = _normal((BKV, G, 64), 1).to(cuda)
    codes = [tcommon.pack_block(parse_spec("e4m3-rn")(
        _normal((BKV, Smax, 64), s)), "e4m3").to(cuda) for s in (2, 3)]
    floats = [tcommon.unpack_block(c, "e4m3") for c in codes]
    for length in (1, 17, 48):
        got = tfa.flash_decode(q, *codes, seeds, length, specs, scale=0.125,
                               kv_block=kb, kv_fmt="e4m3")
        unpacked = tfa.flash_decode(q, *floats, seeds, length, specs,
                                    scale=0.125, kv_block=kb)
        ref = tfa.flash_decode_plain(q, *codes, seeds, length, specs,
                                     scale=0.125, kv_block=kb, kv_fmt="e4m3")
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), unpacked.view(torch.int32))
        _assert_flips(ref, got, "binary8", adjacent_only=False,
                      share=max(1e-4, 1.0 / got.numel()))


# K9's two routes: (S_max, kv_block, lengths, window); the serve shape's
# one block of 48 keys (not a power of two), blocks of 64 with a ragged
# last block of 8, a window, blocks longer than one 128-key round
K9_ROUTE_CASES = [(48, 48, (1, 17, 48), 0),
                  (200, 64, (1, 63, 64, 65, 200), 0),
                  (200, 64, (30, 65, 200), 50),
                  (300, 256, (1, 129, 256, 257, 300), 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,offset", [("e4m3", False), (None, False),
                                        ("binary8", False), ("e4m3", True),
                                        (None, True)])
@pytest.mark.parametrize("name", ["binary8-sr", "binary8-sr-r16",
                                  "binary8-sr-r8"])
@pytest.mark.parametrize("Smax,kb,lengths,window", K9_ROUTE_CASES)
def test_flash_decode_routes_agree(cuda, Smax, kb, lengths, window, name,
                                   fmt, offset):
    """K9 on the decode kernel bitwise its tiled kernel on N(0, 1) inputs
    (on ``fmt``'s grid: a cache of ``fmt`` codes, or float32 where None;
    off a 16-byte boundary with ``offset``), each launch counted on its
    route."""
    BKV, G, d = 16, 8, 64
    specs = [parse_spec(name)] * 3
    q = _normal((BKV, G, d), Smax).to(cuda)
    k, v = (_normal((BKV, Smax, d), Smax + s).to(cuda) for s in (1, 2))
    if fmt is not None:
        k, v = (tcommon.pack_block(parse_spec(f"{fmt}-rn")(x), fmt)
                for x in (k, v))
    if offset:
        k, v = _off16(k), _off16(v)
    seeds = np.random.default_rng(kb).integers(0, 2 ** 32, (BKV, 6),
                                               dtype=np.uint64)
    assert tfa.decode_kernel_for(Smax, kb, d, d, 1) == "flash_decode"
    kw = dict(scale=0.125, window=window, kv_block=kb, kv_fmt=fmt)
    for length in lengths:
        tfa.reset_launches()
        got = tfa.flash_decode(q, k, v, seeds, length, specs, **kw)
        tiled = tfa.flash_decode(q, k, v, seeds, length, specs,
                                 kernel="flash_decode_tiled", **kw)
        torch.cuda.synchronize()
        assert _bitwise(got, tiled), length
        assert tfa.LAUNCHES == dict(dict.fromkeys(tfa.LAUNCHES, 0),
                                    flash_decode=1, flash_decode_tiled=1)


@pytest.mark.gpu
def test_flash_decode_tiled_when_block_does_not_fit(cuda):
    """A kv_block whose logits overflow the decode kernel's shared memory
    runs the tiled kernel, counted apart, within the contract of the twin;
    forcing the decode kernel there raises before any launch."""
    Smax, G, d = 60000, 4, 16
    assert tfa.decode_kernel_for(Smax, Smax, d, d, 4) == "flash_decode_tiled"
    specs = [parse_spec("binary8-sr")] * 3
    q = _normal((2, G, d), 1).to(cuda)
    k, v = (_normal((2, Smax, d), s).to(cuda) for s in (2, 3))
    seeds = np.random.default_rng(2).integers(0, 2 ** 32, (2, 6),
                                              dtype=np.uint64)
    tfa.reset_launches()
    got = tfa.flash_decode(q, k, v, seeds, 59000, specs, scale=0.25,
                           kv_block=Smax)
    ref = tfa.flash_decode_plain(q, k, v, seeds, 59000, specs, scale=0.25,
                                 kv_block=Smax)
    torch.cuda.synchronize()
    _assert_flips(ref, got, "binary8", adjacent_only=False,
                  share=max(1e-4, 1.0 / got.numel()))
    assert tfa.LAUNCHES["flash_decode_tiled"] == 1
    assert tfa.LAUNCHES["flash_decode"] == 0
    with pytest.raises(ValueError, match="cannot launch"):
        tfa.flash_decode(q, k, v, seeds, 59000, specs, scale=0.25,
                         kv_block=Smax, kernel="flash_decode")
    assert tfa.LAUNCHES["flash_decode"] == 0


@pytest.mark.gpu
def test_flash_kernels_count_their_launches(cuda):
    tfa.reset_launches()
    specs = [parse_spec("binary8-sr")] * 3
    q, k, v, do = _flash_inputs(4, 2, 10, 0, False, cuda)
    seeds = np.zeros((4, 6), np.int64)
    kw = dict(scale=0.125, n_heads=2, n_kv=1)
    out, m, l = tfa.flash_fwd(q, k, v, seeds, specs, **kw)
    tfa.flash_fwd_plain(q, k, v, seeds, specs, **kw)
    d = (do * out).sum(-1)
    tfa.flash_bwd_dq(q, k, v, do, m, l, d, seeds[:, :4], specs[0], specs[0],
                     **kw)
    tfa.flash_bwd_dkv(q, k, v, do, m, l, d, seeds, *specs, **kw)
    tfa.flash_decode(q[:2, :3], k, v, seeds[:2], 5, specs, scale=0.125)
    tfa.flash_decode_paged(q[:2, :3], k.reshape(-1, 5, k.shape[-1]),
                           v.reshape(-1, 5, v.shape[-1]), seeds[:2],
                           np.array([5, 3], np.int32),
                           np.array([[1, 0], [0, 1]], np.int32), specs,
                           scale=0.125, n_kv=1)
    tfa.flash_decode_paged_plain(q[:2, :3], k.reshape(-1, 5, k.shape[-1]),
                                 v.reshape(-1, 5, v.shape[-1]), seeds[:2],
                                 np.array([5, 3], np.int32),
                                 np.array([[1, 0], [0, 1]], np.int32), specs,
                                 scale=0.125, n_kv=1)
    assert tfa.LAUNCHES == {"flash_fwd": 1, "flash_fwd_two_pass": 0,
                            "flash_bwd_dq": 1, "flash_bwd_dq_simple": 0,
                            "flash_bwd_dkv": 1, "flash_bwd_dkv_simple": 0,
                            "flash_decode": 1, "flash_decode_tiled": 0,
                            "flash_decode_paged": 1}


# K7 and K7''s two routes: (H, KV, batch, S, d, q_block, kv_block,
# q_offset, causal, window, spec, inputs).  Logical blocks of 64 at S = 200
# (several streams, ragged last tiles), one block at S = 256 (the train
# step's), every compiled head dim, G = 8 and G = 1, 32/16/8-bit draws and
# rn, an offset, blocks off 32 and off 4 rows, a window, no causal mask,
# partials that underflow to -0, and one infinite key, query row and dO
# row (a chain that took a term the first version did not, or left one
# out, would move a NaN).
BWD_CASES = [
    (8, 1, 1, 200, 16, 64, 64, 0, True, 0, "binary8-sr", "normal"),
    (8, 1, 1, 200, 32, 64, 64, 0, True, 0, "binary8-sr", "normal"),
    (8, 1, 2, 200, 64, 64, 64, 0, True, 0, "binary8-sr", "normal"),
    (8, 1, 1, 200, 128, 64, 64, 0, True, 0, "binary8-sr", "normal"),
    (32, 4, 2, 256, 64, 1024, 1024, 0, True, 0, "binary8-sr", "normal"),
    (4, 4, 2, 200, 64, 64, 64, 0, True, 0, "binary8-sr-r16", "normal"),
    (4, 4, 1, 200, 64, 64, 64, 0, True, 0, "binary8-sr-r8", "normal"),
    (8, 1, 1, 200, 64, 64, 64, 0, True, 0, "binary8-rn", "normal"),
    (8, 2, 1, 150, 32, 48, 30, 7, True, 0, "binary8-sr", "normal"),
    (8, 2, 1, 130, 64, 40, 100, 3, True, 37, "binary8-sr-r16", "normal"),
    (8, 2, 1, 77, 16, 32, 16, 0, False, 0, "binary8-sr-r8", "normal"),
    (4, 1, 1, 120, 128, 16, 32, 0, False, 0, "e4m3-rn", "normal"),
    (8, 1, 1, 200, 64, 64, 64, 0, True, 0, "binary8-sr", "negzero"),
    (8, 1, 1, 200, 64, 64, 64, 5, True, 0, "binary8-sr", "inf"),
    (8, 1, 1, 200, 32, 48, 30, 70, True, 0, "binary8-sr", "inf"),
    # head dim 256 (gemma-7b's: 32-row blocks and tiles): the train step's
    # one block of 256 (MHA), ragged blocks, 32/16/8-bit draws and rn, an
    # offset, blocks off 32 rows, a window, no causal mask, -0 partials and
    # the infinite rows
    (16, 16, 1, 256, 256, 1024, 1024, 0, True, 0, "binary8-sr", "normal"),
    (4, 1, 1, 200, 256, 64, 64, 0, True, 0, "binary8-sr", "normal"),
    (4, 2, 1, 200, 256, 64, 64, 0, True, 0, "binary8-sr-r16", "normal"),
    (4, 2, 1, 200, 256, 64, 64, 0, True, 0, "binary8-sr-r8", "normal"),
    (4, 2, 1, 200, 256, 64, 64, 0, True, 0, "binary8-rn", "normal"),
    (4, 4, 1, 150, 256, 48, 30, 7, True, 0, "binary8-sr", "normal"),
    (4, 2, 1, 130, 256, 40, 100, 3, True, 37, "binary8-sr-r16", "normal"),
    (4, 2, 1, 77, 256, 32, 16, 0, False, 0, "binary8-sr-r8", "normal"),
    (4, 1, 1, 200, 256, 64, 64, 0, True, 0, "binary8-sr", "negzero"),
    (4, 1, 1, 200, 256, 64, 64, 5, True, 0, "binary8-sr", "inf"),
    (4, 1, 1, 200, 256, 48, 30, 70, True, 0, "binary8-sr", "inf"),
]


def _bwd_case(H, KV, B, S, d, q_offset, kind, cuda, seed, dv=None):
    """q, k, v, dO for the backward; ``kind``: N(0, 1), +-1e-30 (every
    product underflows) or N(0, 1) with key 100, query row 40 and dO row
    45 infinite."""
    dv = d if dv is None else dv
    rng = np.random.default_rng(seed)
    shapes = ((B * H, S, d), (B * KV, S + q_offset, d),
              (B * KV, S + q_offset, dv), (B * H, S, dv))
    if kind == "negzero":
        xs = [np.where(rng.random(sh) < 0.5, 1e-30, -1e-30) for sh in shapes]
    else:
        xs = [rng.standard_normal(sh) for sh in shapes]
    if kind == "inf":
        xs[1][:, 100] = xs[0][:, 40] = xs[3][:, 45] = np.inf
    return [torch.from_numpy(x.astype(np.float32)).to(cuda) for x in xs]


def _bwd_both(q, k, v, do, seeds, specs, kw, kernels=(None, None)):
    """dq, dk, dv of K7 and K7' (``kernels``: their ``kernel=``), on the
    forward kernel's residuals."""
    out, m, l = tfa.flash_fwd(q, k, v, seeds, specs, **kw)
    d = (do * out).sum(-1)
    sq = np.concatenate([seeds[:, :2], seeds[:, 4:]], axis=1)
    dq = tfa.flash_bwd_dq(q, k, v, do, m, l, d, sq, specs[0], specs[0],
                          kernel=kernels[0], **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, m, l, d, seeds, specs[0],
                               specs[0], specs[1], kernel=kernels[1], **kw)
    return dq, dk, dv


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_flash_bwd_tiled_matches_first_version(cuda, case):
    """The tiled K7 and K7' give the first kernels' dq, dk and dv bit for
    bit (each forced through ``kernel=``), each launch counted on its
    route.  Every sum starts at +0, so a -0 partial leaves as +0 from both."""
    H, KV, B, S, d, qb, kb, q_offset, causal, window, name, kind = case
    assert tfa.bwd_kernel_for(d, d, "dq") == "flash_bwd_dq"
    assert tfa.bwd_kernel_for(d, d, "dkv") == "flash_bwd_dkv"
    specs = [parse_spec(name)] * 3
    q, k, v, do = _bwd_case(H, KV, B, S, d, q_offset, kind, cuda, S + d)
    seeds = np.random.default_rng(kb).integers(0, 2 ** 32, (B * H, 6),
                                               dtype=np.uint64)
    kw = dict(scale=d ** -0.5, n_heads=H, n_kv=KV, causal=causal,
              window=window, q_block=qb, kv_block=kb, q_offset=q_offset)
    tfa.reset_launches()
    tiled = _bwd_both(q, k, v, do, seeds, specs, kw)
    first = _bwd_both(q, k, v, do, seeds, specs, kw,
                      ("flash_bwd_dq_simple", "flash_bwd_dkv_simple"))
    torch.cuda.synchronize()
    for nm, a, b in zip(("dq", "dk", "dv"), tiled, first):
        assert _bitwise(a, b), nm
    fwd = tfa.fwd_kernel_for(S + q_offset, d, d, kb)
    assert tfa.LAUNCHES == dict(dict.fromkeys(tfa.LAUNCHES, 0), **{fwd: 2},
                                flash_bwd_dq=1, flash_bwd_dq_simple=1,
                                flash_bwd_dkv=1, flash_bwd_dkv_simple=1)
    if kind == "negzero":
        assert all(bool((x == 0).all()) for x in tiled)


@pytest.mark.gpu
@pytest.mark.parametrize("dk,dv", [(48, 48), (64, 32), (256, 128),
                                   (128, 256), (200, 200)])
def test_flash_bwd_first_kernels_where_not_compiled(cuda, dk, dv):
    """Head dims the tiled kernels are not compiled for (d = 48, dk != dv,
    d = 200; above 128 the first kernels' wide instances) launch the first
    kernels, counted under their own names, within the attention contract
    of the twins; forcing the tiled kernel there raises before any
    launch."""
    H, KV, S = 4, 2, 90
    specs = [parse_spec("binary8-sr")] * 3
    q, k, v, do = _bwd_case(H, KV, 1, S, dk, 0, "normal", cuda, 3, dv=dv)
    seeds = np.random.default_rng(4).integers(0, 2 ** 32, (H, 6),
                                              dtype=np.uint64)
    kw = dict(scale=dk ** -0.5, n_heads=H, n_kv=KV, q_block=64, kv_block=64)
    out, m, l = tfa.flash_fwd_plain(q.cpu(), k.cpu(), v.cpu(), seeds, specs,
                                    **kw)
    m, l, out = m.to(cuda), l.to(cuda), out.to(cuda)
    d = (do * out).sum(-1)
    sq = np.concatenate([seeds[:, :2], seeds[:, 4:]], axis=1)
    args = (q, k, v, do, m, l, d)
    tfa.reset_launches()
    dq = tfa.flash_bwd_dq(*args, sq, specs[0], specs[0], **kw)
    dkv = tfa.flash_bwd_dkv(*args, seeds, *specs, **kw)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == dict(dict.fromkeys(tfa.LAUNCHES, 0),
                                flash_bwd_dq_simple=1,
                                flash_bwd_dkv_simple=1)
    cpu = [x.cpu() for x in args]
    r_dq = tfa.flash_bwd_dq_plain(*cpu, sq, specs[0], specs[0], **kw)
    r_dkv = tfa.flash_bwd_dkv_plain(*cpu, seeds, *specs, **kw)
    for r, g in zip((r_dq, *r_dkv), (dq, *dkv)):
        _assert_flips(r, g.cpu(), "binary8", adjacent_only=False,
                      share=max(1e-4, 1.0 / g.numel()))
    with pytest.raises(ValueError, match="cannot launch"):
        tfa.flash_bwd_dq(*args, sq, specs[0], specs[0],
                         kernel="flash_bwd_dq", **kw)
    with pytest.raises(ValueError, match="cannot launch"):
        tfa.flash_bwd_dkv(*args, seeds, *specs, kernel="flash_bwd_dkv",
                          **kw)
    assert tfa.LAUNCHES["flash_bwd_dq"] == tfa.LAUNCHES["flash_bwd_dkv"] == 0


def _fwd_case(H, KV, S, d, exact, cuda, seed=0):
    make = (lambda sh, sd: _exact(sh, 8.0, sd)) if exact \
        else (lambda sh, sd: _normal(sh, sd))
    return [make(sh, seed + i).to(cuda) for i, sh in enumerate(
        ((H, S, d), (KV, S, d), (KV, S, d)))]


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV", [(8, 1), (32, 4)])
@pytest.mark.parametrize("mask", ["causal", "window"])   # window: causal too
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kb", [64, 128, 256, 1024])
@pytest.mark.parametrize("S", [200, 256])
def test_flash_fwd_single_pass_matches_plain(cuda, S, kb, d, mask, H, KV):
    """K6's single pass on exact-sum inputs: the rounded logits and m
    bitwise equal to the twin; out within the attention contract."""
    assert tfa.fwd_kernel_for(S, d, d, kb) == "flash_fwd"
    specs = [parse_spec("binary8-sr")] * 3
    seeds = np.random.default_rng(S + kb).integers(0, 2 ** 32, (H, 6),
                                                   dtype=np.uint64)
    kw = dict(scale=d ** -0.5, n_heads=H, n_kv=KV, causal=True,
              window=37 if mask == "window" else 0, kv_block=kb)
    q, k, v = _fwd_case(H, KV, S, d, True, cuda)
    tfa.reset_launches()
    got = tfa.flash_fwd(q, k, v, seeds, specs, return_logits=True, **kw)
    assert tfa.LAUNCHES["flash_fwd"] == 1
    assert tfa.LAUNCHES["flash_fwd_two_pass"] == 0
    ref = tfa.flash_fwd_plain(q, k, v, seeds, specs, return_logits=True,
                              **kw)
    torch.cuda.synchronize()
    for i in (1, 3):
        assert torch.equal(got[i].view(torch.int32), ref[i].view(torch.int32))
    _assert_flips(ref[0], got[0], "binary8", adjacent_only=False,
                  share=max(1e-4, 1.0 / got[0].numel()))


@pytest.mark.gpu
@pytest.mark.parametrize("S,kb,d,causal,qoff,name", [
    (256, 1024, 64, True, 0, "binary8-sr"),       # the train step's
    (200, 64, 64, True, 3, "binary8-sr-r16"),
    (200, 30, 32, True, 0, "binary8-sr-r8"),      # blocks off 4 keys
    (130, 128, 128, False, 0, "e4m3-rn"),
    (100, 32, 16, True, 0, "binary8-sr"),         # the reduced head dim
])
def test_flash_fwd_single_pass_matches_two_pass(cuda, S, kb, d, causal,
                                                qoff, name):
    """On N(0, 1) inputs K6's single pass gives the two-pass kernel's
    out, m, l and logits bit for bit: each value is computed by the same
    operations in the same order."""
    H, KV = 8, 2
    specs = [parse_spec(name)] * 3
    seeds = np.random.default_rng(S).integers(0, 2 ** 32, (H, 6),
                                              dtype=np.uint64)
    q = _normal((H, S, d), 1).to(cuda)
    k, v = (_normal((KV, S + qoff, d), sd).to(cuda) for sd in (2, 3))
    kw = dict(scale=d ** -0.5, n_heads=H, n_kv=KV, causal=causal,
              kv_block=kb, q_offset=qoff, return_logits=True)
    one = tfa.flash_fwd(q, k, v, seeds, specs, **kw)
    two = tfa.flash_fwd(q, k, v, seeds, specs, kernel="flash_fwd_two_pass",
                        **kw)
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
def test_flash_fwd_two_pass_when_block_does_not_fit(cuda):
    """1024 keys of d = 128 in one logical block do not fit the single
    pass: the two-pass kernel runs, counted under its own name, and holds
    the twin's contract."""
    H, S, d = 4, 1024, 128
    assert tfa.fwd_kernel_for(S, d, d, S) == "flash_fwd_two_pass"
    specs = [parse_spec("binary8-sr")] * 3
    seeds = np.random.default_rng(9).integers(0, 2 ** 32, (H, 6),
                                              dtype=np.uint64)
    q, k, v = _fwd_case(H, 1, S, d, True, cuda)
    kw = dict(scale=d ** -0.5, n_heads=H, n_kv=1, kv_block=S,
              return_logits=True)
    tfa.reset_launches()
    got = tfa.flash_fwd(q, k, v, seeds, specs, **kw)
    assert tfa.LAUNCHES["flash_fwd_two_pass"] == 1
    assert tfa.LAUNCHES["flash_fwd"] == 0
    ref = tfa.flash_fwd_plain(q, k, v, seeds, specs, **kw)
    torch.cuda.synchronize()
    for i in (1, 3):
        assert torch.equal(got[i].view(torch.int32), ref[i].view(torch.int32))


def _paged_case(page, exact, seed, n_kv=4, G=8, d=64, n_max=4, B=8,
                dv=None):
    """K10's inputs: B requests of n_kv kv heads at lengths 1, page-1,
    page, page+1, the full table and three random ones; pages placed at
    random among 1..P-1 (filler entries 0).  Returns q, the logical k/v
    (B·KV, n_max·page, d / dv, dv defaulting to d) as e4m3 grid values,
    lengths and a function that scatters a logical cache into a pool for
    a given placement."""
    dv = d if dv is None else dv
    rng = np.random.default_rng(seed)
    S = n_max * page
    lengths = np.array([1, max(1, page - 1), page, page + 1, S]
                       + list(rng.integers(1, S + 1, B - 5)), np.int32)
    if exact:
        q = (rng.integers(-4, 5, (B * n_kv, G, d)) / 4).astype(np.float32)
        k = np.repeat(rng.integers(-4, 5, (B * n_kv, 1, d)) / 4, S, axis=1)
        v = rng.integers(-8, 9, (B * n_kv, S, dv)) / 8
    else:
        q = rng.standard_normal((B * n_kv, G, d)).astype(np.float32)
        k = rng.standard_normal((B * n_kv, S, d))
        v = rng.standard_normal((B * n_kv, S, dv))
    grid = parse_spec("e4m3-rn")
    k, v = (grid(torch.from_numpy(x.astype(np.float32))) for x in (k, v))
    P = B * n_max + 3

    def place(pl_seed):
        r = np.random.default_rng(pl_seed)
        free = list(r.permutation(np.arange(1, P)))
        tables = np.zeros((B, n_max), np.int32)
        for b, n in enumerate(lengths):
            for j in range(-(-int(n) // page)):
                tables[b, j] = free.pop()
        return tables

    def pool(x, tables):
        out = torch.zeros((P * n_kv, page, x.shape[-1]), dtype=x.dtype)
        for b in range(B):
            for j in range(n_max):
                if tables[b, j]:
                    for h in range(n_kv):
                        out[tables[b, j] * n_kv + h] = \
                            x[b * n_kv + h, j * page:(j + 1) * page]
        return out
    return torch.from_numpy(q), k, v, lengths, place, pool


@pytest.mark.gpu
@pytest.mark.parametrize("page", [8, 16, 64])
@pytest.mark.parametrize("name", ["binary8-sr", "binary8-sr-r16",
                                  "binary8-sr-r8"])
def test_flash_decode_paged_kernel_matches_plain(cuda, page, name):
    specs = [parse_spec(name)] * 3
    n_kv = 4
    for exact in (True, False):
        q, k, v, lengths, place, pool = _paged_case(page, exact, page)
        seeds = np.random.default_rng(page + 1).integers(
            0, 2 ** 32, (q.shape[0], 6), dtype=np.uint64)
        outs = []
        for pl_seed in (0, 1):
            tables = place(pl_seed)
            kp, vp = (pool(x, tables).to(cuda) for x in (k, v))
            codes = [tcommon.pack_block(x, "e4m3") for x in (kp, vp)]
            kw = dict(scale=0.125, n_kv=n_kv)
            got = tfa.flash_decode_paged(q.to(cuda), *codes, seeds,
                                         lengths, tables, specs,
                                         kv_fmt="e4m3", **kw)
            values = tfa.flash_decode_paged(
                q.to(cuda), kp, vp, seeds,
                torch.from_numpy(lengths).to(cuda),
                torch.from_numpy(tables).to(cuda), specs, **kw)
            ref = tfa.flash_decode_paged_plain(q.to(cuda), *codes, seeds,
                                               lengths, tables, specs,
                                               kv_fmt="e4m3", **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32),
                               values.view(torch.int32))
            if exact:
                assert torch.equal(got.view(torch.int32),
                                   ref.view(torch.int32))
            else:
                _assert_flips(ref, got, "binary8", adjacent_only=False,
                              share=max(1e-4, 1.0 / got.numel()))
            outs.append(got)
        assert torch.equal(outs[0].view(torch.int32),
                           outs[1].view(torch.int32))
        for b, n in enumerate(lengths):
            sl = slice(b * n_kv, (b + 1) * n_kv)
            k9 = tfa.flash_decode(q[sl].to(cuda), k[sl].to(cuda),
                                  v[sl].to(cuda), seeds[sl], int(n), specs,
                                  scale=0.125, kv_block=page,
                                  kernel="flash_decode_tiled")
            torch.cuda.synchronize()
            assert torch.equal(k9.view(torch.int32),
                               outs[0][sl].view(torch.int32))


def _bitwise(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _off16(t):
    """A copy of ``t`` whose data starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


# K10's own kernel against K9's tiled kernel (fwd_kernel) with kv_block ==
# page: pages of
# 5 to 128 keys (128 spans two 64-key chunks), head dims 16, 64 and 128,
# G = 1, 3 and 8, windows, e4m3 codes and float32 pools; then every other
# compiled instance of K10's kernel: 2-byte codes (kCode: bfloat16,
# binary16), 1-byte codes with a non-finite field (binary8), the head dim
# fixed at compile time at 32, and the instances that read it at run time
# (DK = 0: head dims outside 16/32/64/128, dk != dv, rows or pools off
# 16-byte boundaries)
@pytest.mark.gpu
@pytest.mark.parametrize("page,dk,dv,G,window,fmt,offset", [
    (5, 64, 64, 3, 0, "e4m3", False), (8, 64, 64, 8, 0, "e4m3", False),
    (16, 64, 64, 8, 0, "e4m3", False), (64, 64, 64, 8, 0, "e4m3", False),
    (128, 64, 64, 8, 0, "e4m3", False), (8, 16, 16, 1, 0, "e4m3", False),
    (16, 16, 16, 3, 0, "e4m3", False), (16, 128, 128, 8, 0, "e4m3", False),
    (128, 128, 128, 1, 0, "e4m3", False), (16, 64, 64, 8, 11, "e4m3", False),
    (64, 64, 64, 3, 40, "e4m3", False), (128, 64, 64, 8, 100, "e4m3", False),
    (16, 64, 64, 8, 0, None, False), (128, 128, 128, 3, 0, None, False),
    (5, 16, 16, 8, 3, None, False),
    (16, 64, 64, 8, 0, "bfloat16", False),
    (8, 48, 48, 3, 5, "binary16", False),
    (128, 128, 128, 3, 0, "bfloat16", True),
    (16, 64, 64, 8, 0, "binary8", False),
    (5, 20, 20, 3, 0, "binary8", False),
    (16, 32, 32, 8, 0, "e4m3", False),
    (16, 32, 32, 3, 0, None, False),
    (8, 48, 48, 3, 0, "e4m3", False),
    (128, 80, 80, 8, 50, "e4m3", False),
    (16, 80, 80, 8, 0, None, False),
    (16, 64, 32, 8, 0, "e4m3", False),
    (5, 32, 64, 3, 0, None, False),
    (64, 128, 16, 1, 0, "binary8", False),
    (16, 64, 64, 8, 0, "e4m3", True),
    (64, 64, 64, 8, 0, None, True),
    (16, 16, 16, 3, 7, "binary8", True)])
def test_flash_decode_paged_kernel_matches_k9(cuda, page, dk, dv, G, window,
                                              fmt, offset):
    """K10 bitwise K9's tiled kernel (fwd_kernel) with kv_block == page
    on N(0, 1)
    inputs on ``fmt``'s grid (pools of ``fmt`` codes, or float32 values
    where None; off a 16-byte boundary with ``offset``), and bitwise at
    two placements of the same content."""
    specs = [parse_spec("binary8-sr")] * 3
    n_kv = 2
    q, k, v, lengths, place, pool = _paged_case(page, False, page + dk + G,
                                                n_kv=n_kv, G=G, d=dk,
                                                n_max=3, B=6, dv=dv)
    if fmt is not None:
        k, v = (parse_spec(f"{fmt}-rn")(x) for x in (k, v))
    seeds = np.random.default_rng(page + dk).integers(
        0, 2 ** 32, (q.shape[0], 6), dtype=np.uint64)
    kw = dict(scale=dk ** -0.5, window=window)
    outs = []
    for pl_seed in (0, 1):
        tables = place(pl_seed)
        kp, vp = (pool(x, tables).to(cuda) for x in (k, v))
        if fmt is not None:
            kp, vp = (tcommon.pack_block(x, fmt) for x in (kp, vp))
        if offset:
            kp, vp = _off16(kp), _off16(vp)
        outs.append(tfa.flash_decode_paged(q.to(cuda), kp, vp, seeds,
                                           lengths, tables, specs, n_kv=n_kv,
                                           kv_fmt=fmt, **kw))
    torch.cuda.synchronize()
    assert _bitwise(outs[0], outs[1])
    for b, n in enumerate(lengths):
        sl = slice(b * n_kv, (b + 1) * n_kv)
        k9 = tfa.flash_decode(q[sl].to(cuda), k[sl].to(cuda), v[sl].to(cuda),
                              seeds[sl], int(n), specs, kv_block=page,
                              kernel="flash_decode_tiled", **kw)
        torch.cuda.synchronize()
        assert _bitwise(k9, outs[0][sl]), (b, int(n))


@pytest.mark.gpu
def test_flash_decode_paged_refuses_pages_past_shared_memory(cuda):
    """A page whose logits overflow the card's shared memory is refused on
    the card (the CPU twin computes it: test_torch_serving) and counts no
    launch."""
    page = 60000
    q = torch.zeros((2, 4, 16), device=cuda)
    pool = torch.zeros((2, page, 16), device=cuda)
    seeds = np.zeros((2, 6), np.uint64)
    tfa.reset_launches()
    with pytest.raises(NotImplementedError, match="shared memory"):
        tfa.flash_decode_paged(q, pool, pool, seeds, [1], [[0]],
                               [parse_spec("binary8-sr")] * 3, scale=0.25,
                               n_kv=2)
    assert tfa.LAUNCHES["flash_decode_paged"] == 0


# ---------------------------------------------------------------------------
# K1' (sr_cast_prng) and K8' (qmatmul_batched_prng): the MoE serve path
# ---------------------------------------------------------------------------
SR_CAST_CASES = [("binary8", "sr", 32), ("binary8", "sr", 16),
                 ("binary8", "sr", 8), ("binary8", "rn", 32),
                 ("e4m3", "sr", 16), ("bfloat16", "sr", 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1,), (5,), (3, 7, 11), (128, 1, 768),
                                   (2 ** 24 + 37,)],
                         ids=lambda s: "x".join(map(str, s)))
def test_sr_cast_kernel_matches_plain(cuda, shape):
    x = _normal(shape, 9, 4.0).to(cuda)
    for fmt, mode, rb in SR_CAST_CASES:
        got = tsr.sr_cast_prng(x, SEEDS[0], fmt, mode, rand_bits=rb)
        ref = tsr.sr_cast_prng_plain(x, SEEDS[0], fmt, mode, rb)
        torch.cuda.synchronize()
        assert got.shape == x.shape
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
            (fmt, mode, rb)


@pytest.mark.gpu
def test_sr_cast_kernel_unaligned_and_counted(cuda):
    """A view that starts off a 16-byte boundary takes the scalar path."""
    tsr.reset_launches()
    x = _normal((1 + 128 * 5 + 3,), 10, 4.0).to(cuda)[1:]
    assert x.data_ptr() % 16 != 0
    got = tsr.sr_cast_prng(x, SEEDS[1], "binary8", "sr", rand_bits=8)
    ref = tsr.sr_cast_prng_plain(x, SEEDS[1], "binary8", "sr", 8)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert tsr.sr_cast_prng(x[:0], SEEDS[1], "binary8").numel() == 0
    assert tsr.LAUNCHES == {"sr_cast_prng": 1, "sr_cast_bits": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 129, 98304 + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_sr_cast_path_instance_matches_generic(cuda, n, offset):
    """K1''s sr_r32 instance (the MoE act site's spec) bitwise its generic
    instance and the twin, on ragged n and on a view off a 16-byte
    boundary (scalar accesses)."""
    x = _normal((n + offset,), 11, 4.0).to(cuda)[offset:]
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    assert tsr.sr_cast_instance("sr", 32, False) == "sr_r32"
    path = tsr.sr_cast_prng(x, SEEDS[2], "binary8", "sr")
    generic = tsr.sr_cast_prng(x, SEEDS[2], "binary8", "sr",
                               instance="generic")
    ref = tsr.sr_cast_prng_plain(x, SEEDS[2], "binary8", "sr", 32)
    torch.cuda.synchronize()
    assert _bitwise(path, ref)
    assert _bitwise(generic, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 129, 98304 + 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_sr_cast_generic_instance_matches_plain(cuda, n, offset):
    """16- and 8-bit draws and signed_sr_eps through K1''s generic
    instance, bitwise the twin."""
    x = _normal((n + offset,), 12, 4.0).to(cuda)[offset:]
    v = _normal((n,), 13).to(cuda)
    for mode, rb, eps, vv in (("sr", 16, 0.0, None), ("sr", 8, 0.0, None),
                              ("sr_eps", 8, 0.1, None),
                              ("signed_sr_eps", 32, 0.1, v)):
        assert tsr.sr_cast_instance(mode, rb, vv is not None) == "generic"
        got = tsr.sr_cast_prng(x, SEEDS[0], "binary8", mode, eps, vv,
                               rand_bits=rb)
        ref = tsr.sr_cast_prng_plain(x, SEEDS[0], "binary8", mode, rb, eps,
                                     vv)
        torch.cuda.synchronize()
        assert _bitwise(got, ref), (mode, rb)


def _batched_seeds(E):
    return np.random.default_rng(E).integers(0, 2 ** 32, (E, 2),
                                             dtype=np.int64)


def _batched_route(monkeypatch, route):
    """K8'/K8's route forced: "stream" (the weight-stream route) or "large"
    (the large-M route), whatever M."""
    monkeypatch.setattr(tq, "BATCHED_STREAM_MAX_M",
                        1 << 30 if route == "stream" else 0)


# (E, M, K, N): the MoE path's decode (M = 1) and whole-prompt (M = 10) shapes,
# ragged ones, and M on both sides of the weight-stream route's 16-row
# tiles and of the route threshold (BATCHED_STREAM_MAX_M = 96) at a K past
# whole stages and an N that is not a whole block; every case runs on both
# routes
BATCHED_CASES = [(128, 1, 2048, 768), (128, 1, 768, 2048),
                 (128, 10, 2048, 768), (128, 10, 768, 2048), (5, 3, 70, 50),
                 (4, 9, 300, 130)] + [(8, m, 520, 136)
                                      for m in (1, 4, 10, 16, 17, 96, 97)]


@pytest.mark.gpu
@pytest.mark.parametrize("E,M,K,N", BATCHED_CASES)
def test_qmatmul_batched_kernel_matches_plain(cuda, monkeypatch, E, M, K, N):
    """K8' on both routes, bf16 and float32 experts: bitwise its twin on
    exact sums, within the GEMM contract on N(0, 1) inputs, and the two
    routes bitwise equal there."""
    seeds = _batched_seeds(E)
    a = _exact((E, M, K), 8.0, M).to(cuda)
    b = _exact((E, K, N), 4.0, N).to(cuda)
    an = _normal((E, M, K), M + 1).to(cuda)
    bn = _normal((E, K, N), N + 1, K ** -0.5).to(cuda).to(torch.bfloat16)
    ref = tq.qmatmul_batched_plain(an, bn, seeds, "binary8")
    outs = {}
    for route in ("stream", "large"):
        _batched_route(monkeypatch, route)
        for b_dtype in (torch.bfloat16, torch.float32):
            for fmt, mode, rb in (("binary8", "sr", 32), ("binary8", "rn", 32),
                                  ("e4m3", "sr", 16), ("binary8", "sr", 8)):
                got = tq.qmatmul_batched_prng(a, b.to(b_dtype), seeds, fmt,
                                              mode, rb)
                want = tq.qmatmul_batched_plain(a, b, seeds, fmt, mode, rb)
                torch.cuda.synchronize()
                assert _same(got, want), (route, b_dtype, fmt, mode)
        outs[route] = tq.qmatmul_batched_prng(an, bn, seeds, "binary8")
        _assert_flips(ref, outs[route], "binary8")
    assert _same(outs["stream"], outs["large"])


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["stream", "large"])
def test_qmatmul_batched_negative_zero_sums(cuda, monkeypatch, route):
    """Sums that underflow to -0 leave as -0 for every K, as the first
    version's chains of exactly K steps did: both routes pad A with -0
    past K (fmaf(-0, +0, acc) is acc), on both sides of their stage
    depths, K8' and K8."""
    _batched_route(monkeypatch, route)
    for M, K in ((1, 1), (10, 16), (17, 45), (4, 48), (64, 300), (1, 2048),
                 (10, 2050), (3, 2064), (1, 3001)):
        a = torch.full((3, M, K), -1e-30, device=cuda)
        b = torch.full((3, K, 40), 1e-20, device=cuda)
        for got in (tq.qmatmul_batched_prng(a, b, _batched_seeds(3),
                                            "binary16", "rn"),
                    tq.qmatmul_batched(a, b, None, "binary16", "rn")):
            torch.cuda.synchronize()
            assert bool((got == 0).all()), (M, K)
            assert bool(torch.signbit(got).all()), (M, K)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["stream", "large"])
@pytest.mark.parametrize("E,M,K,N,bdt", [(4, 1, 2048, 256, "bf16"),
                                         (3, 10, 600, 70, "bf16"),
                                         (2, 40, 300, 136, "f32"),
                                         (2, 10, 301, 70, "f32")])
def test_qmatmul_batched_unaligned_views(cuda, monkeypatch, route, E, M, K,
                                         N, bdt):
    """Views at a 4-byte offset (A, B, both) and row lengths that allow no
    vector loads run the element-load instances: bitwise the aligned
    call, K8' and K8."""
    _batched_route(monkeypatch, route)
    dt = torch.bfloat16 if bdt == "bf16" else torch.float32
    seeds = _batched_seeds(E)
    bits = tcommon.counter_bits_batch(seeds, (E, M, N), 32, device=cuda)
    a = _normal((E, M, K), 1).to(cuda)
    b = _normal((E, K, N), 2, K ** -0.5).to(cuda).to(dt)
    ref = tq.qmatmul_batched_prng(a, b, seeds, "e4m3")

    def off(t):
        step = 4 // t.element_size()                 # 4 bytes
        v = torch.empty(t.numel() + step, dtype=t.dtype,
                        device=cuda)[step:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16
        return v
    for x, y in ((off(a), b), (a, off(b)), (off(a), off(b))):
        got = tq.qmatmul_batched_prng(x, y, seeds, "e4m3")
        got_bits = tq.qmatmul_batched(x, y, bits, "e4m3")
        torch.cuda.synchronize()
        assert _same(got, ref) and _same(got_bits, ref)


@pytest.mark.gpu
def test_batched_kernel_counts_its_launches(cuda):
    tq.reset_launches()
    a = _normal((3, 2, 16), 0).to(cuda)
    b = _normal((3, 16, 8), 1).to(cuda)
    tq.qmatmul_batched_prng(a, b, _batched_seeds(3), "binary8")
    tq.qmatmul_batched_plain(a, b, _batched_seeds(3), "binary8")
    assert tq.qmatmul_batched_prng(a[:, :0], b, _batched_seeds(3),
                                   "binary8").numel() == 0
    assert tq.LAUNCHES == dict(dict.fromkeys(tq.LAUNCHES, 0),
                               qmatmul_batched_sr=1)


@pytest.mark.gpu
def test_moe_decode_card_matches_cpu(cuda):
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduced(get_config("qwen3-moe-30b-a3b")),
                              gemm_policy="binary8-paper")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(5))
    prompts = torch.randint(0, cfg.vocab_size, (2, 6),
                            generator=torch.Generator().manual_seed(6))
    cpu = serve.serve_batch(model, params, prompts, 3)

    def to_cuda(t):
        if isinstance(t, dict):
            return {k: to_cuda(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cuda(v) for v in t]
        return t.to(cuda)

    tq.reset_launches()
    tsr.reset_launches()
    card = serve.serve_batch(model, to_cuda(params), prompts.to(cuda), 3,
                             forced=cpu["tokens"].to(cuda))
    torch.cuda.synchronize()
    steps, L = 6 + 3, cfg.n_layers
    assert tq.LAUNCHES == dict(dict.fromkeys(tq.LAUNCHES, 0),
                               qmatmul_sr=5 * L * steps + 3,
                               qmatmul_batched_sr=3 * L * steps)
    assert tsr.LAUNCHES == {"sr_cast_prng": L * steps, "sr_cast_bits": 0}
    d = (card["logits"].cpu() - cpu["logits"]).abs()
    assert float(d.median()) < 0.02
    assert float((d > 0.05).float().mean()) <= 0.10


K5_CASES = [  # (m spec, v spec, packed, kahan)
    ("bf16-sr", "bf16-sr", True, False),
    ("bf16-sr", "e4m3-sr", True, False),
    ("bf16-sr-bittrick", "bf16-sr", True, False),
    ("bf16-sr", "bf16-sr", True, True),
    ("bf16-rn", "bf16-rn", False, True),
    ("fp32", "fp32", False, False),
    ("binary8-sr-r8", "e4m3-sr-r16", True, False),
]


def _k5_inputs(n, m_spec, v_spec, packed, kahan, offset=0, seed=3):
    x = _normal((n + offset,), seed)[offset:]
    g = _normal((n + offset,), seed + 1, 0.3)[offset:]
    g[3::83] = 2e-39                       # float32 subnormals: zero
    g[5::79] = 1e-20                       # g * g below 2**-126

    def start(sp, vals):
        return vals if sp.is_identity else parse_spec(f"{sp.fmt}-rn")(vals)
    m = start(m_spec, _normal((n,), seed + 2, 0.03))
    v = start(v_spec, 0.05 * g * g + 1e-4)
    if packed:
        m = tcommon.pack_block(m, m_spec.fmt)
        v = tcommon.pack_block(v, v_spec.fmt)
    comp = [_normal((n,), seed + 3, 1e-6), _normal((n,), seed + 4, 1e-9)] \
        if kahan else [None, None]
    return x, g, m, v, comp


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [(1, 0), (7, 0), (128 * 3 + 5, 0),
                                      (2 ** 20 + 37, 0), (2 ** 20 + 37, 1)])
@pytest.mark.parametrize("case", K5_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("chain", [UPDATE_CONFIGS[i] for i in (0, 2, 5)],
                         ids=lambda c: "-".join(c[:3]))
def test_fused_qadam_kernel_matches_plain(cuda, n, offset, case, chain):
    """K5 against its twin, bitwise; ``offset`` 1: views off a 16-byte
    boundary."""
    m_spec, v_spec = parse_spec(case[0]), parse_spec(case[1])
    packed, kahan = case[2], case[3]
    cfg = gd.GDRounding(*(parse_spec(s) for s in chain[:3]),
                        grad_v=chain[3])
    x, g, m, v, (cm, cv) = _k5_inputs(n, m_spec, v_spec, packed, kahan,
                                      offset)
    scal = [0.01, 1 - 0.9 ** 3, 1 - 0.999 ** 3, 1e-8, 0.01]
    kw = dict(m_spec=m_spec, v_spec=v_spec, b1=0.9, b2=0.999, packed=packed)
    ref = tfu.fused_qadam_prng_plain(x, g, m, v, scal, SEEDS[0], cfg,
                                     cm=cm, cv=cv, **kw)

    def dev(t):
        return None if t is None else t.to(cuda)
    if offset:      # the card tensors themselves off the boundary
        x = torch.cat([torch.zeros(1), x]).to(cuda)[1:]
        g = torch.cat([torch.zeros(1), g]).to(cuda)[1:]
    got = tfu.fused_qadam_prng(dev(x), dev(g), dev(m), dev(v), scal,
                               SEEDS[0], cfg, cm=dev(cm), cv=dev(cv), **kw)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == (5 if kahan else 3)
    for r, k in zip(ref, got):
        assert k.dtype == r.dtype and k.is_cuda
        k = k.cpu()
        if r.dtype == torch.float32:
            r, k = r.view(torch.int32), k.view(torch.int32)
        assert torch.equal(r, k)


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [(7, 0), (128 * 3 + 5, 0),
                                      (2 ** 20 + 37, 0), (2 ** 20 + 37, 1)])
def test_fused_qadam_trainer_instance_matches_plain(cuda, n, offset):
    """The trainer's instance (train.ADAM_RUN's case: bf16-sr codes, the
    rn / sr / signed-SRe chain with sub_v = grad) bitwise equal to the
    twin, tails and views off a 16-byte boundary included."""
    from repro_torch.launch.train import rounding_config
    m_spec = parse_spec("bf16-sr")
    cfg = rounding_config("signed_sr_eps", "binary8", 0.1)
    assert tfu.k5_instance(cfg, m_spec, m_spec, True, False) == "trainer"
    x, g, m, v, _ = _k5_inputs(n, m_spec, m_spec, True, False, offset,
                               seed=11)
    scal = [4e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3, 1e-8, 0.0]
    kw = dict(m_spec=m_spec, v_spec=m_spec, b1=0.9, b2=0.999, packed=True)
    ref = tfu.fused_qadam_prng_plain(x, g, m, v, scal, SEEDS[2], cfg, **kw)
    if offset:
        x = torch.cat([torch.zeros(1), x]).to(cuda)[1:]
        g = torch.cat([torch.zeros(1), g]).to(cuda)[1:]
    got = tfu.fused_qadam_prng(x.to(cuda), g.to(cuda), m.to(cuda),
                               v.to(cuda), scal, SEEDS[2], cfg, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ref[0].view(torch.int32), got[0].cpu().view(
        torch.int32))
    assert torch.equal(ref[1], got[1].cpu()) and torch.equal(ref[2],
                                                             got[2].cpu())


@pytest.mark.gpu
def test_fused_qadam_kernel_counts_its_launches(cuda):
    m_spec = parse_spec("bf16-sr")
    cfg = gd.GDRounding(*(parse_spec(s) for s in UPDATE_CONFIGS[0][:3]))
    x, g, m, v, _ = _k5_inputs(1000, m_spec, m_spec, True, False)
    tfu.reset_launches()
    tfu.fused_qadam_prng(x.to(cuda), g.to(cuda), m.to(cuda), v.to(cuda),
                         [0.1, 0.1, 0.001, 1e-8, 0.0], SEEDS[1], cfg,
                         m_spec=m_spec, v_spec=m_spec, b1=0.9, b2=0.999,
                         packed=True)
    assert tfu.LAUNCHES["fused_qadam_prng"] == 1
    tfu.fused_qadam_prng(x, g, m, v, [0.1, 0.1, 0.001, 1e-8, 0.0], SEEDS[1],
                         cfg, m_spec=m_spec, v_spec=m_spec, b1=0.9, b2=0.999,
                         packed=True)
    assert tfu.LAUNCHES["fused_qadam_prng"] == 1


# ---------------------------------------------------------------------------
# The explicit-bits kernels K3, K4, K8, K1 and the packed storage options
# ---------------------------------------------------------------------------
GEMM_VARIANTS = [("binary8", "sr", 32), ("binary8", "rn", 32),
                 ("e4m3", "sr", 16), ("binary8", "sr", 8),
                 ("bfloat16", "sr", 32)]


def _bits(cuda, words, shape, rb, stream=0):
    return tcommon.counter_bits_reduced(words[0], words[1], shape, rb,
                                        stream=stream, device=cuda)


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("route,M,K,N", [
    ("auto", 4, 2048, 256), ("auto", 37, 45, 70), ("auto", 4, 5632, 2048),
    ("auto", 16, 2048, 32000), ("auto", 128, 2048, 2048),
    ("decode", 37, 45, 70), ("decode", 64, 1000, 70),
    ("large", 4, 5632, 2048)])
def test_qmatmul_bits_kernel_matches_plain_and_prng(cuda, monkeypatch, route,
                                                    M, K, N):
    """K3 equals its twin on exact sums, and K3' bitwise on any input when
    fed the words K3' draws (one main loop, one summation order), on both
    routes."""
    _route(monkeypatch, route)
    a = _exact((M, K), 8.0, M).to(cuda)
    b = _exact((K, N), 4.0, N).to(cuda).to(torch.bfloat16)
    for fmt, mode, rb in GEMM_VARIANTS:
        bits = _bits(cuda, SEEDS[0], (M, N), rb)
        got = tq.qmatmul(a, b, bits, fmt, mode, rb)
        ref = tq.qmatmul_bits_plain(a, b, bits, fmt, mode, rb)
        prng = tq.qmatmul_prng(a, b, SEEDS[0], fmt, mode, rb)
        torch.cuda.synchronize()
        assert _same(got, ref) and _same(got, prng), (fmt, mode, rb)
    a = _normal((M, K), M + 1).to(cuda)
    b = _normal((K, N), N + 1, K ** -0.5).to(cuda).to(torch.bfloat16)
    bits = _bits(cuda, SEEDS[1], (M, N), 32)
    got = tq.qmatmul(a, b, bits, "binary8")
    assert _same(got, tq.qmatmul_prng(a, b, SEEDS[1], "binary8"))
    _assert_flips(tq.qmatmul_bits_plain(a, b, bits, "binary8"), got,
                  "binary8")


@pytest.mark.gpu
@pytest.mark.parametrize("route,M,K,N", [("auto", 5, 70, 37),
                                         ("decode", 5, 700, 136),
                                         ("large", 5, 700, 136),
                                         ("auto", 128, 520, 136)])
@pytest.mark.parametrize("fmt", ["binary8", "e4m3", "bfloat16"])
def test_qmatmul_packed_operand_and_output(cuda, monkeypatch, fmt, route, M,
                                           K, N):
    """out_packed: the codes of the float result (e4m3 saturating at 480);
    a_fmt: codes decoded on load sum as their values, read through a view
    off a 16-byte boundary (and with a ragged row length), on both
    routes."""
    _route(monkeypatch, route)
    a = (_exact((M, K), 8.0, 1) * 64).to(cuda)       # reaches e4m3's xmax
    b = _exact((K, N), 4.0, 2).to(cuda)
    for flavour in ("prng", "bits"):
        bits = _bits(cuda, SEEDS[2], (M, N), 32)

        def run(x, **kw):
            if flavour == "prng":
                return tq.qmatmul_prng(x, b, SEEDS[2], fmt, **kw)
            return tq.qmatmul(x, b, bits, fmt, **kw)
        flt = run(a)
        codes = run(a, out_packed=True)
        torch.cuda.synchronize()
        assert codes.dtype == tcommon.pack_dtype(fmt)
        assert torch.equal(codes, tcommon.pack_block(flt, fmt))
        # codes of a (with -0.0 words) as the A operand, unaligned
        width = tcommon.pack_bytes(fmt)
        ac = tcommon.pack_block(tcommon.round_block(
            _normal((M, K), 3).to(cuda), None, fmt, "rn"), fmt)
        ac[0, :3] = 1 << (8 * width - 1)                 # -0.0
        buf = torch.empty(M * K + 1, dtype=ac.dtype, device=cuda)
        view = buf[1:].view(M, K)
        view.copy_(ac)
        assert view.data_ptr() % 16 != 0
        got = run(view, a_fmt=fmt)
        ref = run(tcommon.unpack_block(ac, fmt))
        torch.cuda.synchronize()
        assert _same(got, ref), flavour


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["decode", "large"])
@pytest.mark.parametrize("M,K,N", [(4, 2048, 5632), (37, 45, 70)])
def test_swiglu_bits_kernel_matches_prng_and_packs(cuda, monkeypatch, route,
                                                   M, K, N):
    """K4 fed K4''s words equals K4' bitwise (h and the residuals); the
    packed h and residuals are the codes of the float ones; on exact sums
    the residuals equal the twin's; on both routes."""
    _route(monkeypatch, route)
    x = _exact((M, K), 8.0, 5).to(cuda)
    wg = _exact((K, N), 4.0, 6).to(cuda).to(torch.bfloat16)
    wu = _exact((K, N), 4.0, 7).to(cuda).to(torch.bfloat16)
    for act_name, rb in (("binary8-sr", 32), ("binary8-rn", 16),
                         ("binary8-sr", 8)):
        act = ACT_SPECS[act_name]
        bg = _bits(cuda, SEEDS[0], (M, N), rb)
        bu = _bits(cuda, SEEDS[1], (M, N), rb)
        ab = _bits(cuda, SEEDS[2], (M, N), 32, stream=1)
        kw = dict(act_spec=act, rand_bits=rb, residuals=True)
        got = tq.qmatmul_swiglu(x, wg, wu, bg, bu, "binary8", act_bits=ab,
                                **kw)
        prng = tq.qmatmul_swiglu_prng(x, wg, wu, SEEDS, "binary8", **kw)
        ref = tq.qmatmul_swiglu_bits_plain(x, wg, wu, bg, bu, "binary8",
                                           "sr", rb, act, ab, True)
        packed = tq.qmatmul_swiglu(x, wg, wu, bg, bu, "binary8",
                                   act_bits=ab, out_packed=True,
                                   residuals_packed=True, **kw)
        torch.cuda.synchronize()
        assert all(_same(p, g) for p, g in zip(prng, got)), act_name
        assert all(_same(r, g) for r, g in zip(ref[1:], got[1:]))
        _assert_flips(ref[0], got[0], "binary8", adjacent_only=False)
        assert all(p.dtype == torch.uint8 for p in packed)
        assert all(torch.equal(p, tcommon.pack_block(g, "binary8"))
                   for p, g in zip(packed, got))
        prng_packed = tq.qmatmul_swiglu_prng(
            x, wg, wu, SEEDS, "binary8", out_packed=True,
            residuals_packed=True, **kw)
        assert all(torch.equal(p, q) for p, q in zip(prng_packed, packed))


def _glu_outputs(x, wg, wu, bits, residuals, packed):
    """K4' and K4 (on K4''s words) with the binary8 act site; each a tuple
    of its outputs."""
    kw = dict(act_spec=ACT_SPECS["binary8-sr"], residuals=residuals,
              out_packed=packed, residuals_packed=packed)
    outs = []
    for o in (tq.qmatmul_swiglu_prng(x, wg, wu, SEEDS, "binary8", **kw),
              tq.qmatmul_swiglu(x, wg, wu, *bits[:2], "binary8",
                                act_bits=bits[2], **kw)):
        outs.append(o if isinstance(o, tuple) else (o,))
    return outs


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("M,K,N", [(4, 2048, 5632), (16, 2048, 5632),
                                   (128, 2048, 5632), (37, 45, 70),
                                   (6, 8, 136), (1024, 256, 5632)])
def test_swiglu_routes_agree(cuda, monkeypatch, M, K, N, residuals, packed):
    """K4''s two routes sum every output in the same order: h and the
    residuals bitwise equal on N(0, 1) inputs, float32 or packed, and K4 on
    K4''s words bitwise K4' on both."""
    x = _normal((M, K), M + K).to(cuda)
    wg = _normal((K, N), 1, K ** -0.5).to(cuda).to(torch.bfloat16)
    wu = _normal((K, N), 2, K ** -0.5).to(cuda).to(torch.bfloat16)
    bits = (_bits(cuda, SEEDS[0], (M, N), 32),
            _bits(cuda, SEEDS[1], (M, N), 32),
            _bits(cuda, SEEDS[2], (M, N), 32, stream=1))
    outs = {}
    for route in ("decode", "large"):
        _route(monkeypatch, route)
        outs[route] = _glu_outputs(x, wg, wu, bits, residuals, packed)
    torch.cuda.synchronize()
    want = outs["decode"][0]
    assert len(want) == (3 if residuals else 1)
    for route in ("decode", "large"):
        for flavour in outs[route]:
            assert all(_same(w, g) for w, g in zip(want, flavour)), route


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["decode", "large"])
@pytest.mark.parametrize("M,K,N,wdt", [(4, 2048, 256, "bf16"),
                                       (6, 600, 70, "bf16"),
                                       (40, 300, 136, "f32"),
                                       (40, 301, 70, "f32")])
def test_swiglu_routes_unaligned_views(cuda, monkeypatch, route, M, K, N,
                                       wdt):
    """x, wg or wu through views at a 4-byte offset, and row lengths that
    allow no vector loads, run the element-load instances: bitwise the
    aligned call (h and residuals)."""
    _route(monkeypatch, route)
    dt = torch.bfloat16 if wdt == "bf16" else torch.float32
    x = _normal((M, K), 1).to(cuda)
    wg = _normal((K, N), 2, K ** -0.5).to(cuda).to(dt)
    wu = _normal((K, N), 3, K ** -0.5).to(cuda).to(dt)

    def off(t):
        step = 4 // t.element_size()                 # 4 bytes
        v = torch.empty(t.numel() + step, dtype=t.dtype,
                        device=cuda)[step:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16
        return v

    def run(*ops):
        return tq.qmatmul_swiglu_prng(*ops, SEEDS, "e4m3", residuals=True,
                                      act_spec=ACT_SPECS["binary8-sr"])
    ref = run(x, wg, wu)
    for ops in ((off(x), wg, wu), (x, off(wg), wu), (x, wg, off(wu)),
                (off(x), off(wg), off(wu))):
        got = run(*ops)
        torch.cuda.synchronize()
        assert all(_same(r, g) for r, g in zip(ref, got))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["decode", "large"])
def test_swiglu_negative_zero_sums(cuda, monkeypatch, route):
    """Branch sums that underflow to -0 leave the residuals as -0 where K
    is a multiple of 16 and as +0 otherwise (each chain runs over K rounded
    up to 16 with zeros), on both routes, K = 8 included."""
    _route(monkeypatch, route)
    for K in (8, 16, 45, 48, 300, 2048, 2050, 2064):
        x = torch.full((5, K), -1e-30, device=cuda)
        w = torch.full((K, 40), 1e-20, device=cuda)
        _, g, u = tq.qmatmul_swiglu_prng(x, w, w, SEEDS, "binary16", "rn",
                                         residuals=True)
        torch.cuda.synchronize()
        for t in (g, u):
            assert bool((t == 0).all()), K
            assert bool(torch.signbit(t).all()) == (K % 16 == 0), K
            assert bool(torch.signbit(t).any()) == (K % 16 == 0), K


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["stream", "large"])
@pytest.mark.parametrize("E,M,K,N", [(128, 1, 2048, 768), (128, 1, 768, 2048),
                                     (5, 3, 70, 50), (128, 10, 2048, 768)]
                         + [(8, m, 520, 136) for m in (1, 4, 16, 17, 64)])
def test_qmatmul_batched_bits_kernel_matches_plain_and_prng(cuda, monkeypatch,
                                                            route, E, M, K,
                                                            N):
    """K8 on each route: bitwise its twin on exact sums and K8' on the
    same words on any input; packed outputs the codes of the float ones,
    packed A (through a view off a 16-byte boundary, -0 codes among them)
    summing as its values."""
    _batched_route(monkeypatch, route)
    seeds = _batched_seeds(E)
    a = _exact((E, M, K), 8.0, M).to(cuda)
    b = _exact((E, K, N), 4.0, N).to(cuda).to(torch.bfloat16)
    for fmt, mode, rb in GEMM_VARIANTS:
        bits = tcommon.counter_bits_batch(seeds, (E, M, N), rb, device=cuda)
        got = tq.qmatmul_batched(a, b, bits, fmt, mode, rb)
        ref = tq.qmatmul_batched_bits_plain(a, b, bits, fmt, mode, rb)
        prng = tq.qmatmul_batched_prng(a, b, seeds, fmt, mode, rb)
        torch.cuda.synchronize()
        assert _same(got, ref) and _same(got, prng), (fmt, mode, rb)
    bits = tcommon.counter_bits_batch(seeds, (E, M, N), 32, device=cuda)
    codes = tq.qmatmul_batched(a, b, bits, "binary8", out_packed=True)
    flt = tq.qmatmul_batched(a, b, bits, "binary8")
    assert torch.equal(codes, tcommon.pack_block(flt, "binary8"))
    ac = tcommon.pack_block(a, "binary8")            # dyadic: on the grid
    ac.view(-1)[:3] = 0x80                           # -0.0 codes
    view = torch.empty(ac.numel() + 1, dtype=ac.dtype,
                       device=cuda)[1:].view(ac.shape)
    view.copy_(ac)
    assert view.data_ptr() % 16
    assert _same(tq.qmatmul_batched(view, b, bits, "binary8",
                                    a_fmt="binary8"),
                 tq.qmatmul_batched(tcommon.unpack_block(ac, "binary8"), b,
                                    bits, "binary8"))
    a = _normal((E, M, K), M + 2).to(cuda)
    got = tq.qmatmul_batched(a, b, bits, "binary8")
    assert _same(got, tq.qmatmul_batched_prng(a, b, seeds, "binary8"))


SR_CAST_BITS_CASES = SR_CAST_CASES + [("binary8", "sr_eps", 32),
                                      ("binary8", "signed_sr_eps", 32),
                                      ("e4m3", "signed_sr_eps", 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(5,), (3, 7, 11), (128, 1, 768),
                                   (2 ** 20 + 37,)],
                         ids=lambda s: "x".join(map(str, s)))
def test_sr_cast_bits_kernel_matches_plain(cuda, shape):
    """K1 and K1''s v branch bitwise equal their twins on any input."""
    x = _normal(shape, 11, 4.0).to(cuda)
    v = _normal(shape, 12).to(cuda)
    v.view(-1)[::7] = 0.0
    n = x.numel()
    for fmt, mode, rb in SR_CAST_BITS_CASES:
        eps = 0.1 if "eps" in mode else 0.0
        vv = v if mode == "signed_sr_eps" else None
        bits = tcommon.counter_bits_reduced(*SEEDS[1], (n, 1), rb,
                                            device=cuda).reshape(shape)
        got = tsr.sr_cast(x, bits, fmt, mode, eps, vv, rand_bits=rb)
        ref = tsr.sr_cast_plain(x, bits, fmt, mode, 32 if vv is not None
                                else rb, eps, vv)
        prng = tsr.sr_cast_prng(x, SEEDS[1], fmt, mode, eps, vv,
                                rand_bits=rb)
        prng_ref = tsr.sr_cast_prng_plain(x, SEEDS[1], fmt, mode,
                                          32 if vv is not None else rb, eps,
                                          vv)
        torch.cuda.synchronize()
        assert _same(got, ref), (fmt, mode, rb)
        assert _same(prng, prng_ref), (fmt, mode, rb)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,offset", [((128, 1, 768), 0),
                                          ((2 ** 20 + 37,), 0),
                                          ((98304 + 3,), 1), ((129,), 1)],
                         ids=lambda x: str(x))
def test_sr_cast_bits_path_instance_matches_generic(cuda, shape, offset):
    """K1's sr_r32 instance (the oracle act site's spec) bitwise its
    generic instance and the twin, at the path's shape, a ragged length
    and views off a 16-byte boundary (scalar accesses)."""
    n = math.prod(shape)
    x = _normal((n + offset,), 15, 4.0).to(cuda)[offset:].view(shape)
    bits = int32_words(tcommon.counter_bits_reduced(
        *SEEDS[2], (n + offset, 1), 32, device=cuda).reshape(-1))[offset:]
    bits = bits.view(shape)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    assert tsr.sr_cast_bits_instance("sr", 32, False) == "sr_r32"
    path = tsr.sr_cast(x, bits, "binary8", "sr")
    generic = tsr.sr_cast(x, bits, "binary8", "sr", instance="generic")
    ref = tsr.sr_cast_plain(x, bits, "binary8", "sr", 32)
    torch.cuda.synchronize()
    assert _same(path, ref)
    assert _same(generic, ref)


@pytest.mark.gpu
def test_bits_kernels_unaligned_and_counted(cuda):
    """K1 through views off a 16-byte boundary; every bits kernel counts
    its launches, and none counts a CPU call."""
    tq.reset_launches()
    tsr.reset_launches()
    n = 128 * 5 + 3
    x = _normal((n + 1,), 13, 4.0).to(cuda)[1:]
    bits = tcommon.counter_bits_reduced(*SEEDS[0], (n + 1, 1), 16,
                                        device=cuda).reshape(-1)[1:]
    v = _normal((n + 1,), 14).to(cuda)[1:]
    got = tsr.sr_cast(x, bits, "binary8", "signed_sr_eps", 0.2, v)
    ref = tsr.sr_cast_plain(x, bits, "binary8", "signed_sr_eps", 32, 0.2, v)
    torch.cuda.synchronize()
    assert _same(got, ref)
    a = _normal((4, 64), 0).to(cuda)
    b = _normal((64, 32), 1).to(cuda)
    tq.qmatmul(a, b, _bits(cuda, SEEDS[0], (4, 32), 32), "binary8")
    tq.qmatmul_swiglu(a, b, b, None, None, "binary8", "rn")
    tq.qmatmul_batched(a[None], b[None], None, "binary8", "rn")
    tq.qmatmul(a.cpu(), b.cpu(), None, "binary8", "rn")
    assert tq.LAUNCHES == dict(dict.fromkeys(tq.LAUNCHES, 0), qmatmul_bits=1,
                               qmatmul_swiglu_bits=1, qmatmul_batched_bits=1)
    assert tsr.LAUNCHES == {"sr_cast_prng": 0, "sr_cast_bits": 1}


# ---------------------------------------------------------------------------
# The GLU kernels' other activations (K4', K4: gelu, relu, relu_sq) and head
# dim 256 in K6, K9 and K10 (gemma-7b)
# ---------------------------------------------------------------------------
GLU_ACTS = ("silu", "gelu", "relu", "relu_sq")


@pytest.mark.gpu
@pytest.mark.parametrize("act", GLU_ACTS)
@pytest.mark.parametrize("route", ["decode", "large"])
@pytest.mark.parametrize("M,K,N", [(4, 3072, 640), (37, 45, 70),
                                   (128, 512, 640), (4, 8, 70)])
def test_glu_act_kernels_match_plain(cuda, monkeypatch, act, route, M, K, N):
    """K4' under each activation, on both routes: on exact-sum inputs the
    residuals bitwise and the hidden bitwise too (within the act grid's
    flips for SiLU, whose exp differs by ulps), rounded or not; K4 fed
    K4''s words bitwise K4'; each launch counted under its activation."""
    _route(monkeypatch, route)
    x = _exact((M, K), 8.0, M).to(cuda)
    wg = _exact((K, N), 4.0, 1).to(cuda).to(torch.bfloat16)
    wu = _exact((K, N), 4.0, 2).to(cuda).to(torch.bfloat16)
    for name in ("binary8-sr", "none"):
        kw = dict(act=act, act_spec=ACT_SPECS[name], residuals=True)
        tq.reset_launches()
        got = tq.qmatmul_swiglu_prng(x, wg, wu, SEEDS, "binary8", **kw)
        assert tq.ACT_LAUNCHES == dict(dict.fromkeys(GLU_ACTS, 0),
                                       **{act: 1})
        ref = tq.qmatmul_swiglu_plain(x, wg, wu, SEEDS, "binary8", **kw)
        words = [tcommon.counter_bits_reduced(*SEEDS[i], (M, N), 32,
                                              stream=i // 2, device=cuda)
                 for i in range(3)]
        bits = tq.qmatmul_swiglu(x, wg, wu, words[0], words[1], "binary8",
                                 act_bits=words[2] if name != "none"
                                 else None, **kw)
        torch.cuda.synchronize()
        for r, g in zip(ref[1:], got[1:]):
            assert _bitwise(r, g)
        for g, b in zip(got, bits):
            assert _bitwise(g, b)
        if act != "silu":
            assert _bitwise(ref[0], got[0]), name
        elif name != "none":
            _assert_flips(ref[0], got[0], "binary8", adjacent_only=False)


@pytest.mark.gpu
@pytest.mark.parametrize("act", GLU_ACTS[1:])
@pytest.mark.parametrize("M,K,N", [(4, 3072, 24576), (128, 3072, 2048),
                                   (37, 45, 70), (16, 520, 136)])
def test_glu_act_routes_agree(cuda, monkeypatch, act, M, K, N):
    """On N(0, 1) inputs the two routes give the same h, g_r and u_r bit
    for bit under every activation (gemma-7b's decode and prompt shapes
    among them), packed outputs the codes of the float ones."""
    x = _normal((M, K), M).to(cuda)
    wg = _normal((K, N), 1, K ** -0.5).to(cuda).to(torch.bfloat16)
    wu = _normal((K, N), 2, K ** -0.5).to(cuda).to(torch.bfloat16)
    act_spec = ACT_SPECS["binary8-sr"]
    outs = {}
    for route in ("decode", "large"):
        _route(monkeypatch, route)
        outs[route] = tq.qmatmul_swiglu_prng(x, wg, wu, SEEDS, "binary8",
                                             act=act, act_spec=act_spec,
                                             residuals=True)
    packed = tq.qmatmul_swiglu_prng(x, wg, wu, SEEDS, "binary8", act=act,
                                    act_spec=act_spec, residuals=True,
                                    out_packed=True, residuals_packed=True)
    torch.cuda.synchronize()
    for a, b in zip(outs["decode"], outs["large"]):
        assert _bitwise(a, b)
    for p, f in zip(packed, outs["large"]):
        assert torch.equal(p, tcommon.pack_block(f, "binary8"))


@pytest.mark.gpu
@pytest.mark.parametrize("act", GLU_ACTS[1:])
@pytest.mark.parametrize("route", ["decode", "large"])
@pytest.mark.parametrize("fmt", ["binary32", "bfloat16"])
def test_glu_act_functions_bitwise_on_a_sweep(cuda, monkeypatch, act, route,
                                              fmt):
    """The card's activation (rounding.cuh: gelu over tanh_xla, relu,
    relu_sq) bitwise the twin on 131,072 values between -10 and 10 and
    tiny ones (signed zeros, powers of two down to the subnormals, both
    sides of tanh's 0.0004 edge and its clamp at 7.99881172), on the
    binary32 grid (the float32 values themselves) and on bfloat16's: x is
    the identity, so g_r is wg's row rounded, and u = 1 leaves act(g_r) as
    the unrounded hidden."""
    _route(monkeypatch, route)
    edges = np.array([0.0, -0.0, 0.0004, -0.0004, 7.99881172180175781,
                      -7.99881172180175781, 8.0, -8.0], np.float32)
    edges = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                            np.nextafter(edges, np.float32(-np.inf))])
    vals = np.concatenate([
        edges, np.float32(2.0) ** -np.arange(1, 150, dtype=np.float32),
        -np.float32(2.0) ** -np.arange(1, 150, dtype=np.float32),
        np.linspace(-10, 10, 8192 * 16, dtype=np.float32)])
    N = 8192
    vals = vals[:16 * N].reshape(16, N)
    wg = torch.from_numpy(vals).to(cuda)
    x = torch.eye(16, device=cuda)
    wu = torch.ones((16, N), device=cuda)
    got = tq.qmatmul_swiglu_prng(x, wg, wu, SEEDS, fmt, "rn", act=act)
    ref = tq.qmatmul_swiglu_plain(x, wg, wu, SEEDS, fmt, "rn", act=act)
    torch.cuda.synchronize()
    assert _bitwise(ref, got)


@pytest.mark.gpu
def test_glu_unknown_act_refused(cuda):
    x = _normal((4, 16), 0).to(cuda)
    w = _normal((16, 8), 1).to(cuda)
    with pytest.raises(ValueError, match="unknown GLU activation"):
        tq.qmatmul_swiglu_prng(x, w, w, SEEDS, "binary8", act="tanh")


D256_FWD = [(512, 512, True, 0, "binary8-sr"), (300, 1024, True, 0,
                                                "binary8-sr-r16"),
            (200, 64, True, 5, "binary8-sr-r8"), (130, 128, False, 0,
                                                  "e4m3-rn")]


@pytest.mark.gpu
@pytest.mark.parametrize("S,kb,causal,qoff,name", D256_FWD)
def test_flash_fwd_d256_matches_plain_and_two_pass(cuda, S, kb, causal,
                                                   qoff, name):
    """K6 at head dim 256 (fwd1_kernel<256>, 64-key tiles): on exact-sum
    inputs the logits and m bitwise the twin, out within the contract; on
    N(0, 1) inputs bitwise the two-pass kernel (its wide instance) in out,
    m, l and the logits."""
    H, KV, d = 4, 2, 256
    assert tfa.fwd_kernel_for(S, d, d, kb) == "flash_fwd"
    specs = [parse_spec(name)] * 3
    seeds = np.random.default_rng(S).integers(0, 2 ** 32, (H, 6),
                                              dtype=np.uint64)
    kw = dict(scale=d ** -0.5, n_heads=H, n_kv=KV, causal=causal,
              kv_block=kb, q_offset=qoff, return_logits=True)
    q = _exact((H, S, d), 8.0, 1).to(cuda)
    k, v = (_exact((KV, S + qoff, d), 8.0, sd).to(cuda) for sd in (2, 3))
    tfa.reset_launches()
    got = tfa.flash_fwd(q, k, v, seeds, specs, **kw)
    assert tfa.LAUNCHES["flash_fwd"] == 1
    ref = tfa.flash_fwd_plain(q, k, v, seeds, specs, **kw)
    torch.cuda.synchronize()
    for i in (1, 3):
        assert _bitwise(got[i], ref[i])
    _assert_flips(ref[0], got[0], name.split("-")[0], adjacent_only=False,
                  share=max(1e-4, 1.0 / got[0].numel()))
    q = _normal((H, S, d), 1).to(cuda)
    k, v = (_normal((KV, S + qoff, d), sd).to(cuda) for sd in (2, 3))
    one = tfa.flash_fwd(q, k, v, seeds, specs, **kw)
    two = tfa.flash_fwd(q, k, v, seeds, specs, kernel="flash_fwd_two_pass",
                        **kw)
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert _bitwise(a, b)


@pytest.mark.gpu
def test_flash_fwd_d256_two_pass_when_block_does_not_fit(cuda):
    """A logical block of 1024 keys at d = 256 (295,936 B of logits and
    tiles) runs the two-pass kernel, within the twin's contract."""
    H, S, d = 2, 1024, 256
    assert tfa.fwd_kernel_for(S, d, d, S) == "flash_fwd_two_pass"
    specs = [parse_spec("binary8-sr")] * 3
    seeds = np.random.default_rng(4).integers(0, 2 ** 32, (H, 6),
                                              dtype=np.uint64)
    q, k, v = _fwd_case(H, 1, S, d, True, cuda)
    kw = dict(scale=d ** -0.5, n_heads=H, n_kv=1, kv_block=S,
              return_logits=True)
    tfa.reset_launches()
    got = tfa.flash_fwd(q, k, v, seeds, specs, **kw)
    assert tfa.LAUNCHES["flash_fwd_two_pass"] == 1
    ref = tfa.flash_fwd_plain(q, k, v, seeds, specs, **kw)
    torch.cuda.synchronize()
    for i in (1, 3):
        assert _bitwise(got[i], ref[i])


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,offset", [("e4m3", False), (None, False),
                                        ("e4m3", True), (None, True)])
@pytest.mark.parametrize("Smax,kb,lengths", [(48, 1024, (1, 17, 48)),
                                             (300, 256, (1, 129, 300))])
def test_flash_decode_d256_routes_agree(cuda, Smax, kb, lengths, fmt,
                                        offset):
    """K9 at d = 256 (the serve shape: B.KV 64, G 1, one block of 48
    keys): the decode kernel's d = 256 instance (or, off a 16-byte
    boundary, its generic one) bitwise the tiled kernel (its wide
    instance), within the twin's contract, over codes as over values."""
    BKV, G, d = 64, 1, 256
    specs = [parse_spec("binary8-sr")] * 3
    q = _normal((BKV, G, d), Smax).to(cuda)
    k, v = (_normal((BKV, Smax, d), Smax + s).to(cuda) for s in (1, 2))
    if fmt is not None:
        k, v = (tcommon.pack_block(parse_spec(f"{fmt}-rn")(t), fmt)
                for t in (k, v))
    if offset:
        k, v = _off16(k), _off16(v)
    seeds = np.random.default_rng(kb).integers(0, 2 ** 32, (BKV, 6),
                                               dtype=np.uint64)
    kw = dict(scale=d ** -0.5, kv_block=kb, kv_fmt=fmt)
    for length in lengths:
        tfa.reset_launches()
        got = tfa.flash_decode(q, k, v, seeds, length, specs, **kw)
        tiled = tfa.flash_decode(q, k, v, seeds, length, specs,
                                 kernel="flash_decode_tiled", **kw)
        ref = tfa.flash_decode_plain(q, k, v, seeds, length, specs, **kw)
        torch.cuda.synchronize()
        assert tfa.LAUNCHES["flash_decode"] == 1
        assert _bitwise(got, tiled), length
        _assert_flips(ref, got, "binary8", adjacent_only=False,
                      share=max(1e-4, 1.0 / got.numel()))


@pytest.mark.gpu
@pytest.mark.parametrize("page,G,window,fmt", [
    (64, 1, 0, "e4m3"), (16, 1, 0, "e4m3"), (128, 2, 0, None),
    (64, 1, 40, None), (8, 3, 0, "binary8"), (200, 1, 0, "e4m3")])
def test_flash_decode_paged_d256(cuda, page, G, window, fmt):
    """K10 at d = 256: the compiled d = 256 instance bitwise its generic
    instance (the pool off a 16-byte boundary) and K9's tiled kernel with
    kv_block == page, at two placements; on exact-sum inputs bitwise the
    twin."""
    specs = [parse_spec("binary8-sr")] * 3
    n_kv, d = 2, 256
    for exact in (False, True):
        q, k, v, lengths, place, pool = _paged_case(
            page, exact, page + G, n_kv=n_kv, G=G, d=d, n_max=3, B=6)
        if fmt is not None:
            k, v = (parse_spec(f"{fmt}-rn")(x) for x in (k, v))
        seeds = np.random.default_rng(page).integers(
            0, 2 ** 32, (q.shape[0], 6), dtype=np.uint64)
        kw = dict(scale=d ** -0.5, window=window)
        outs = []
        for pl_seed, offset in ((0, False), (1, False), (0, True)):
            tables = place(pl_seed)
            kp, vp = (pool(x, tables).to(cuda) for x in (k, v))
            if fmt is not None:
                kp, vp = (tcommon.pack_block(x, fmt) for x in (kp, vp))
            if offset:
                kp, vp = _off16(kp), _off16(vp)
            outs.append(tfa.flash_decode_paged(
                q.to(cuda), kp, vp, seeds, lengths, tables, specs,
                n_kv=n_kv, kv_fmt=fmt, **kw))
        torch.cuda.synchronize()
        assert _bitwise(outs[0], outs[1]) and _bitwise(outs[0], outs[2])
        for b, n in enumerate(lengths):
            sl = slice(b * n_kv, (b + 1) * n_kv)
            k9 = tfa.flash_decode(q[sl].to(cuda), k[sl].to(cuda),
                                  v[sl].to(cuda), seeds[sl], int(n), specs,
                                  kv_block=page, kernel="flash_decode_tiled",
                                  **kw)
            torch.cuda.synchronize()
            assert _bitwise(k9, outs[0][sl]), (b, int(n))
        if exact and window == 0:
            tables = place(0)
            kp, vp = (pool(x, tables).to(cuda) for x in (k, v))
            ref = tfa.flash_decode_paged_plain(q.to(cuda), kp, vp, seeds,
                                               lengths, tables, specs,
                                               n_kv=n_kv, **kw)
            torch.cuda.synchronize()
            assert _bitwise(ref, outs[0])


@pytest.mark.gpu
def test_flash_bwd_refuses_d256(cuda):
    """K7 and K7' refuse head dims above 256 (gemma-7b's is the widest
    ported), before any launch; at 256 they launch their tiled kernels."""
    q = torch.zeros((2, 4, 512), device=cuda)
    st = torch.ones((2, 4), device=cuda)
    sp = parse_spec("binary8-sr")
    seeds = np.zeros((2, 6), np.uint64)
    kw = dict(scale=0.0625, n_heads=2, n_kv=2)
    tfa.reset_launches()
    with pytest.raises(NotImplementedError, match="above 256"):
        tfa.flash_bwd_dq(q, q, q, q, st, st, st, seeds[:, :4], sp, sp, **kw)
    with pytest.raises(NotImplementedError, match="above 256"):
        tfa.flash_bwd_dkv(q, q, q, q, st, st, st, seeds, sp, sp, sp, **kw)
    assert tfa.LAUNCHES == dict.fromkeys(tfa.LAUNCHES, 0)
    q = q[..., :256].contiguous()
    tfa.flash_bwd_dq(q, q, q, q, st, st, st, seeds[:, :4], sp, sp, **kw)
    tfa.flash_bwd_dkv(q, q, q, q, st, st, st, seeds, sp, sp, sp, **kw)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == dict(dict.fromkeys(tfa.LAUNCHES, 0),
                                flash_bwd_dq=1, flash_bwd_dkv=1)


@pytest.mark.gpu
@pytest.mark.parametrize("exact", [True, False])
def test_flash_bwd_d256_matches_plain(cuda, exact):
    """K7 and K7' at head dim 256 against their twins: one MHA block of
    the train step's 256 rows and a ragged multi-block GQA case, on
    exact-sum and N(0, 1) inputs, within the attention contract (p comes
    from exp, so dq, dk and dv are not exact sums on either)."""
    specs = [parse_spec("binary8-sr")] * 3
    for H, KV, S, blk in ((4, 4, 256, 1024), (4, 1, 200, 64)):
        if exact:
            q, do = (_exact((H, S, 256), 16.0, i) for i in (1, 2))
            k, v = (_exact((KV, S, 256), 16.0, i) for i in (3, 4))
        else:
            q, do = (_normal((H, S, 256), i) for i in (1, 2))
            k, v = (_normal((KV, S, 256), i) for i in (3, 4))
        seeds = np.random.default_rng(S).integers(0, 2 ** 32, (H, 6),
                                                  dtype=np.uint64)
        kw = dict(scale=1 / 16, n_heads=H, n_kv=KV, q_block=blk,
                  kv_block=blk)
        out, m, l = tfa.flash_fwd_plain(q, k, v, seeds, specs, **kw)
        d = (do * out).sum(-1)
        sq = np.concatenate([seeds[:, :2], seeds[:, 4:]], axis=1)
        args = (q, k, v, do, m, l, d)
        ref = (tfa.flash_bwd_dq_plain(*args, sq, specs[0], specs[0], **kw),
               *tfa.flash_bwd_dkv_plain(*args, seeds, *specs, **kw))
        card = [x.to(cuda) for x in args]
        got = (tfa.flash_bwd_dq(*card, sq, specs[0], specs[0], **kw),
               *tfa.flash_bwd_dkv(*card, seeds, *specs, **kw))
        torch.cuda.synchronize()
        for r, g in zip(ref, got):
            _assert_flips(r, g.cpu(), "binary8", adjacent_only=False,
                          share=max(1e-4, 1.0 / g.numel()))


def _gelu_sweep(n_random, seed):
    """XLA tanh's edges, powers of two down to the subnormals, zeros,
    huge values and infinities, then N(0, 9) and ~1e-3 draws."""
    edges = np.array([0.0, -0.0, 0.0004, -0.0004, 7.99881172180175781,
                      -7.99881172180175781, 8.0, -8.0, 1e30, -1e30, np.inf,
                      -np.inf], np.float32)
    edges = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                            np.nextafter(edges, np.float32(-np.inf))])
    p2 = np.float32(2.0) ** -np.arange(1, 150, dtype=np.float32)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.concatenate([
        edges, p2, -p2, rng.normal(0, 3, n_random // 2),
        rng.normal(0, 1e-3, n_random // 2)]).astype(np.float32))


def _same_nan(a, b):
    """Bitwise equal, any NaN equal to any NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.mark.gpu
def test_geglu_pullback_kernel_matches_plain(cuda):
    """The GeGLU pullback kernel bitwise its twin (NaNs as NaNs) on the
    sweep with random cotangents and up branches, one launch counted."""
    from repro_torch.kernels import geglu_pullback as tgp
    g = _gelu_sweep(131_072, 5)
    rng = np.random.default_rng(6)
    dh, u = (torch.from_numpy(rng.standard_normal(g.numel()).astype(
        np.float32)) for _ in range(2))
    ref = tgp.geglu_pullback_plain(g, u, dh)
    tgp.reset_launches()
    got = tgp.geglu_pullback(g.to(cuda), u.to(cuda), dh.to(cuda))
    torch.cuda.synchronize()
    assert tgp.LAUNCHES == {"geglu_pullback": 1}
    assert _same_nan(ref[0], got[0].cpu()) and _same_nan(ref[1], got[1].cpu())


# ---------------------------------------------------------------------------
# The wide instances of K3', K4', K8' and K1': every scheme x grid pair of
# the reference's round_block (the families of tests/test_torch_wide_gemm.py
# and chip_smoke.py's kernel sweep), held to the twins on both routes.  On
# N(0, 1) inputs the 8-bit grids keep the GEMM contract; the fixed-point
# and bfloat16 grids (quantum 2^-8 absolute, 2^-8 relative) lie within
# reach of the float32 summation-order error, so there at most 1 % of the
# outputs may flip, and a flip need not be one grid step (a sum on the other
# side of a power of two has the other binade's neighbours).
# ---------------------------------------------------------------------------
WIDE_GEMM_FAMILIES = {
    "fxp": ("fxp16.8-sr2", "fxp8.4-rn"),
    "sr2": ("binary8-sr2", "binary8-sr2-r16", "binary8-sr2-r32"),
    "bittrick": ("bf16-sr-bittrick", "binary8-sr-bittrick-r8"),
    "directed": ("binary8-rz", "binary8-ra", "binary8-rd", "binary8-ru"),
    "inf": ("binary8-rn-inf", "e4m3-sr-inf"),
    "shifted": ("shift8-sr", "shift8-rn"),
    "nosub": ("b8nosub-sr", "b8nosub-rn"),
    "sr_eps": ("binary8-sr_eps-e0.1", "binary8-sr_eps-e0.25"),
}
# the GEMM contract on N(0, 1) inputs (chip_smoke.py's wide_contract): at
# most 1e-4 of the outputs flipped (4e-3 on the grids whose quantum lies
# nearer the float32 sums' order error), each by one grid step, or by one
# step plus 4 standard deviations of each sum's error (a random-walk model,
# u sqrt(K) sqrt(sum_k (a_k b_k)^2)) where a sum cancels near zero
FINE_GRIDS = ("fxp16.8", "bfloat16")


def _gemm_site(name):
    """A spec's GEMM result site: (fmt, mode, rand_bits, eps), saturating
    (the GEMM sites take no overflow)."""
    s = parse_spec(name)
    return s.fmt, s.mode, s.rand_bits, s.eps


def _assert_wide_contract(ref, got, fmt, a, b):
    from repro_torch.core.grids import get_grid
    slack = 8 * 2.0 ** -24 * math.sqrt(a.shape[-1]) * torch.sqrt(
        a.float().square() @ b.float().square())
    n, explained = grid_flips(ref, got, fmt, slack)
    share = 4e-3 if get_grid(fmt).fmt.name in FINE_GRIDS else 1e-4
    assert n <= max(1, share * ref.numel()) and explained, (n, ref.numel())


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["decode", "large"])
@pytest.mark.parametrize("family", sorted(WIDE_GEMM_FAMILIES))
def test_wide_qmatmul_matches_plain(cuda, monkeypatch, route, family):
    """K3' and K8' on the instance each site takes (the wide one but for
    sr_eps and the saturating -inf specs), both routes forced: bitwise the
    twins on exact sums, the contract on N(0, 1); each launch counted on
    its instance."""
    register_wide_grids()
    _route(monkeypatch, route)
    monkeypatch.setattr(tq, "BATCHED_STREAM_MAX_M",
                        1 << 30 if route == "decode" else 0)
    e_seeds = np.array(SEEDS, dtype=np.int64)
    for name in WIDE_GEMM_FAMILIES[family]:
        fmt, mode, rb, eps = _gemm_site(name)
        instance = tq.gemm_instance(fmt, mode, rb, eps)
        for M, K, N, seed in ((16, 520, 70, 1), (4, 2048, 256, 2)):
            a = _exact((M, K), 8.0, seed).to(cuda)
            b = _exact((K, N), 4.0, seed + 1).to(cuda).to(torch.bfloat16)
            tq.reset_launches()
            got = tq.qmatmul_prng(a, b, SEEDS[0], fmt, mode, rb, eps=eps)
            ref = tq.qmatmul_plain(a, b, SEEDS[0], fmt, mode, rb, eps=eps)
            assert tq.INSTANCE_LAUNCHES["qmatmul_sr"][instance] == 1
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
                (name, M, K, N)
            a3, b3 = a[:3].reshape(3, 1, K), b.float()[None].expand(
                3, K, N).contiguous()
            got = tq.qmatmul_batched_prng(a3, b3, e_seeds, fmt, mode, rb,
                                          eps=eps)
            ref = tq.qmatmul_batched_plain(a3, b3, e_seeds, fmt, mode, rb,
                                           eps=eps)
            assert tq.INSTANCE_LAUNCHES["qmatmul_batched_sr"][instance] == 1
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
        a = _normal((16, 2048), 3).to(cuda)
        b = _normal((2048, 256), 4, 2048 ** -0.5).to(cuda)
        _assert_wide_contract(
            tq.qmatmul_plain(a, b, SEEDS[1], fmt, mode, rb, eps=eps),
            tq.qmatmul_prng(a, b, SEEDS[1], fmt, mode, rb, eps=eps), fmt, a,
            b)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["decode", "large"])
@pytest.mark.parametrize("name", ["binary8-sr", "binary8-rn", "e4m3-sr-r16",
                                  "binary8-sr_eps-e0.1", "bf16-sr-r8"])
def test_wide_instances_equal_the_first_ones(cuda, monkeypatch, route, name):
    """On the sites the first instances take, the wide instances (forced by
    the modules' ``FORCE_WIDE``) give their bits on any input: K3', K8' and
    K4' (with residuals) on N(0, 1) inputs, K1' on values past xmax."""
    _route(monkeypatch, route)
    monkeypatch.setattr(tq, "BATCHED_STREAM_MAX_M",
                        1 << 30 if route == "decode" else 0)
    fmt, mode, rb, eps = _gemm_site(name)
    a = _normal((12, 2048), 5).to(cuda)
    b = _normal((2048, 264), 6, 2048 ** -0.5).to(cuda).to(torch.bfloat16)
    e_seeds = np.array(SEEDS, dtype=np.int64)
    a3 = a[:6].reshape(3, 2, 2048)
    b3 = b[None].expand(3, 2048, 264).contiguous()
    act = spec(fmt, mode, eps, rb)
    x = _normal((3 * 128 + 37,), 7, 3e4).to(cuda)
    outs = []
    for forced in (False, True):
        monkeypatch.setattr(tq, "FORCE_WIDE", forced)
        monkeypatch.setattr(tsr, "FORCE_WIDE", forced)
        tq.reset_launches()
        tsr.reset_launches()
        outs.append((
            tq.qmatmul_prng(a, b, SEEDS[0], fmt, mode, rb, eps=eps),
            tq.qmatmul_batched_prng(a3, b3, e_seeds, fmt, mode, rb, eps=eps),
            *tq.qmatmul_swiglu_prng(a, b, b, SEEDS, fmt, mode, act_spec=act,
                                    rand_bits=rb, eps=eps, residuals=True),
            tsr.sr_cast_prng(x, SEEDS[1], fmt, mode, eps, rand_bits=rb)))
        want = "wide" if forced else "fp"
        for kernel in ("qmatmul_sr", "qmatmul_batched_sr",
                       "qmatmul_swiglu_sr"):
            assert tq.INSTANCE_LAUNCHES[kernel][want] == 1, kernel
        assert tsr.INSTANCE_LAUNCHES["wide"] == int(forced)
    for o1, o2 in zip(*outs):
        assert torch.equal(o1.view(torch.int32), o2.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["decode", "large"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("family", sorted(WIDE_GEMM_FAMILIES))
def test_wide_swiglu_matches_plain(cuda, monkeypatch, route, act, family):
    """K4' with residuals on the instance its sites take: the family's
    first spec at the GEMM sites, its last at the act site (overflow as the
    spec says); on exact sums the residuals bitwise and the hidden bitwise
    (gelu) or within SiLU's act-grid flips, on N(0, 1) the contract."""
    register_wide_grids()
    _route(monkeypatch, route)
    names = WIDE_GEMM_FAMILIES[family]
    fmt, mode, rb, eps = _gemm_site(names[0])
    act_spec = parse_spec(names[-1])
    x = _exact((8, 520), 4.0, 11).to(cuda)
    wg = _exact((520, 72), 8.0, 12).to(cuda)
    wu = _exact((520, 72), 8.0, 13).to(cuda)
    kw = dict(act=act, act_spec=act_spec, rand_bits=rb, eps=eps,
              residuals=True)
    tq.reset_launches()
    got = tq.qmatmul_swiglu_prng(x, wg, wu, SEEDS, fmt, mode, **kw)
    ref = tq.qmatmul_swiglu_plain(x, wg, wu, SEEDS, fmt, mode, rb, act_spec,
                                  True, act=act, eps=eps)
    want = tq.swiglu_instance(fmt, mode, rb, eps, act_spec)
    assert tq.INSTANCE_LAUNCHES["qmatmul_swiglu_sr"][want] == 1
    for r, g in zip(ref[1:], got[1:]):
        assert torch.equal(r.view(torch.int32), g.view(torch.int32))
    if act == "gelu":
        assert torch.equal(ref[0].view(torch.int32), got[0].view(torch.int32))
    else:
        n, adjacent = grid_flips(ref[0], got[0], act_spec.fmt)
        assert n <= max(1, 1e-4 * ref[0].numel()) and adjacent
    x = _normal((8, 2048), 14).to(cuda)
    wg = _normal((2048, 256), 15, 2048 ** -0.5).to(cuda)
    wu = _normal((2048, 256), 16, 2048 ** -0.5).to(cuda)
    got = tq.qmatmul_swiglu_prng(x, wg, wu, SEEDS, fmt, mode, **kw)
    ref = tq.qmatmul_swiglu_plain(x, wg, wu, SEEDS, fmt, mode, rb, act_spec,
                                  True, act=act, eps=eps)
    for r, g, w in zip(ref[1:], got[1:], (wg, wu)):
        _assert_wide_contract(r, g, fmt, x, w)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 5, 129, 128 * 3 + 5, 2 ** 20 + 37])
@pytest.mark.parametrize("family", sorted(WIDE_GEMM_FAMILIES))
def test_wide_sr_cast_matches_plain(cuda, family, n, offset):
    """K1' on the instance each spec takes (the wide one for every family
    but sr_eps), overflow as the spec says, bitwise its twin on any input
    (values past xmax, -0s), aligned and one element off a 16-byte
    boundary; each launch counted on its instance."""
    register_wide_grids()
    base = _normal((n + offset,), n, 4.0)
    base[::17] *= 3e4
    base[3::29] = -0.0
    x = base.to(cuda)[offset:]
    for name in WIDE_GEMM_FAMILIES[family]:
        s = parse_spec(name)
        tsr.reset_launches()
        got = tsr.sr_cast_prng(x, SEEDS[2], s.fmt, s.mode, s.eps,
                               rand_bits=s.rand_bits, overflow=s.overflow)
        ref = tsr.sr_cast_prng_plain(x, SEEDS[2], s.fmt, s.mode, s.rand_bits,
                                     s.eps, overflow=s.overflow)
        want = tsr.sr_cast_instance(s.mode, s.rand_bits, False, s.fmt, s.eps,
                                    s.overflow)
        assert tsr.INSTANCE_LAUNCHES[want] == 1
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
            name
