"""Rounded flash attention: wrappers, plain twins, launch counts
(counterpart of ``repro.kernels.flash_attention``).

``flash_fwd``     -> ``csrc/flash_attention.cu:flash_fwd``, replacing
                     ``repro/kernels/flash_attention.py:flash_fwd_p`` (K6):
                     the single-pass kernel, or ``flash_fwd_two_pass``
                     where a block's logits do not fit in shared memory
                     (``fwd_kernel_for``; counted apart);
``flash_bwd_dq``  -> ``flash_bwd_dq``, replacing ``flash_bwd_dq_p`` (K7),
                     and ``flash_bwd_dkv`` -> ``flash_bwd_dkv``, replacing
                     ``flash_bwd_dkv_p`` (K7'): the tiled kernels, or
                     ``flash_bwd_dq_simple`` / ``flash_bwd_dkv_simple``
                     (the first kernels) where the head dims are not
                     compiled (``bwd_kernel_for``; counted apart).  The
                     two give the same bits;
``flash_decode``  -> ``flash_decode``, replacing ``flash_decode_p`` (K9):
                     K10's decode kernel over the contiguous cache read
                     as pages of ``kv_block`` keys, or
                     ``flash_decode_tiled`` (K9's first kernel, two passes
                     per 64-key tile) where a block's logits do not fit
                     in its shared memory (``decode_kernel_for``; counted
                     apart).  The two give the same bits;
``flash_decode_paged`` -> ``flash_decode_paged``, replacing
                     ``flash_decode_paged_p`` (K10): the decode kernel,
                     one block per (request, kv head, query row), whose
                     float operations run in the tiled kernel's order, so
                     it equals ``flash_decode_tiled`` with ``kv_block ==
                     page`` bit for bit.

Three rounding sites per attention op: the QKᵀ logits (``qk``), each
logical kv block's P·V partial product (``av``) and the normalised output
(``out``).  The qk draw is keyed by the element's global (q position, k
position), the out draw by (q position, column), the av draw by (q
position, column) on stream = kv-block index, so the av bits depend on
``kv_block`` but not on ``q_block``.  The backward recomputes the rounded
logits from the forward's qk words (stream 0, global coordinates) and
rounds dq per kv block, dk and dv per q block.  Decode rows are the G
query heads of one kv group: its draws are keyed by (head in group, k
position), its out draw by (head in group, column).  Paged decode (K10)
keys its draws by the *logical* kv block (one page): stream = logical page
index, column = logical position, never the physical page, so a request's
result does not depend on where its pages lie in the pool.

Seeds are (rows, 2·sites) uint32 words (int64 tensors or numpy arrays
holding them): site ``s`` of row ``bh`` reads ``seeds[bh, 2s:2s+2]``.

A tensor on the CPU goes to the plain PyTorch twin (``*_plain``): the
reference's blocked math (``_fwd_block``, ``_bwd_p_ds``) over all rows at
once, one logical block pair at a time, drawing the kernels' counter bits
(``common.element_bits``).  A CUDA tensor launches the kernel; what the
kernel does not take raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.grids import get_grid
from repro_torch.core.prng import M32
from repro_torch.core.rounding import RoundingSpec
from repro_torch.core.schemes import get_scheme
from repro_torch.kernels import build, common

SITE_QK, SITE_AV, SITE_OUT = 0, 1, 2
SITE_BWD_A, SITE_BWD_B = 1, 2
_DEF_BLOCK = 512
_MODES = {"rn": 0, "sr": 1}
# head dims each kernel takes (the reference's take any): up to 256,
# gemma-7b's
D_MAX = {"flash_fwd": 256, "flash_decode": 256, "flash_decode_paged": 256,
         "flash_bwd_dq": 256, "flash_bwd_dkv": 256}

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_fwd_two_pass": 0,
                            "flash_bwd_dq": 0, "flash_bwd_dq_simple": 0,
                            "flash_bwd_dkv": 0, "flash_bwd_dkv_simple": 0,
                            "flash_decode": 0, "flash_decode_tiled": 0,
                            "flash_decode_paged": 0}
# K6's single-pass kernel: head dims it is compiled for, query rows per
# block, and the shared memory a block may take
FWD_DIMS = (16, 32, 64, 128, 256)
FWD_ROWS = 32
SMEM_MAX = 232448
# the tiled backward (K7, K7'): head dims it is compiled for, and rows a
# block owns (query rows, keys) and a tile holds (keys, query rows) at each
# (``bwd_rows``)
BWD_DIMS = (16, 32, 64, 128, 256)
# the decode kernel (K10, K9): keys a round holds (V rows staged per
# piece), pages a round takes at most
DEC_KEYS = 128
DEC_PAGES = 32


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class AttnSpecs(NamedTuple):
    """One RoundingSpec per forward attention site."""
    qk: RoundingSpec
    av: RoundingSpec
    out: RoundingSpec


def _kv_of(bh, n_heads: int, n_kv: int):
    """Query-head row -> kv-head row (grouped GQA)."""
    return bh // n_heads * n_kv + (bh % n_heads) // (n_heads // n_kv)


def _blocks(size: int, block: int):
    b = min(block, size)
    return b, -(-size // b)


def _seeds(seeds, n: int, cols: int, device) -> torch.Tensor:
    """Seed words as an int64 tensor of uint32 values on ``device``."""
    if isinstance(seeds, np.ndarray):
        seeds = torch.from_numpy(seeds.astype(np.int64))
    seeds = seeds.to(device=device, dtype=torch.int64) & M32
    if tuple(seeds.shape) != (n, cols):
        raise ValueError(f"seeds must be ({n}, {cols}) uint32 site words, "
                         f"got {tuple(seeds.shape)}")
    return seeds


def _draw(seeds, site: int, rows, cols, spec: RoundingSpec, stream):
    """(n, R, C) bits of every row's site words at global (rows, cols),
    or None for a deterministic site."""
    if not spec.stochastic:
        return None
    return common.element_bits(seeds[:, 2 * site, None, None],
                               seeds[:, 2 * site + 1, None, None],
                               rows[None, :, None], cols[None, None, :],
                               spec.rand_bits, stream)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[1] == n:
        return x
    pad = x.new_zeros((x.shape[0], n - x.shape[1]) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def _position_mask(rows, cols, *, q_len: int, kv_len: int, causal: bool,
                   window: int):
    """Validity of each (query, key) pair in global positions."""
    valid = (rows[:, None] < q_len) & (cols[None, :] < kv_len)
    if causal:
        valid &= cols[None, :] <= rows[:, None]
    if window:
        valid &= cols[None, :] > rows[:, None] - window
    return valid


def _fwd_block(specs: AttnSpecs, scale, q_blk, k_blk, v_blk, valid, rows,
               cols, kv_limit: int, av_stream: int, seeds, m, l, acc):
    """One (q block, kv block) online-softmax update over all rows: the
    reference's ``_fwd_block``.  ``rows``/``cols``: the block's global
    draw coordinates.  Returns (m, l, acc, rounded logits)."""
    s = torch.matmul(q_blk, k_blk.transpose(1, 2)) * scale
    s = common.apply_spec_block(
        specs.qk, s, _draw(seeds, SITE_QK, rows, cols, specs.qk, 0))
    s = torch.where(valid, s, -float("inf"))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe), 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    v_blk = torch.where((cols < kv_limit)[None, :, None], v_blk, 0.0)
    pv = torch.matmul(p, v_blk)
    dcols = torch.arange(pv.shape[-1], device=pv.device)
    pv = common.apply_spec_block(
        specs.av, pv, _draw(seeds, SITE_AV, rows, dcols, specs.av,
                            av_stream))
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    return m_new, l_new, acc * corr + pv, s


def _fwd_finish(specs: AttnSpecs, acc, l, rows, seeds):
    out = acc / torch.clamp(l, min=1e-30)
    dcols = torch.arange(out.shape[-1], device=out.device)
    return common.apply_spec_block(
        specs.out, out, _draw(seeds, SITE_OUT, rows, dcols, specs.out, 0))


def _bwd_p_ds(spec_qk: RoundingSpec, scale, q_blk, k_blk, v_blk, do_blk,
              m_col, l_col, d_col, valid, rows, cols, seeds):
    """The forward's rounded logits recomputed (same qk words, stream 0,
    global coordinates), the normalised probabilities and the softmax
    backward ``ds``, both masked: the reference's ``_bwd_p_ds``."""
    s = torch.matmul(q_blk, k_blk.transpose(1, 2)) * scale
    s = common.apply_spec_block(
        spec_qk, s, _draw(seeds, SITE_QK, rows, cols, spec_qk, 0))
    m_safe = torch.where(torch.isfinite(m_col), m_col, 0.0)
    linv = torch.where(l_col > 0, 1.0 / l_col, 0.0)
    p = torch.where(valid, torch.exp(s - m_safe) * linv, 0.0)
    dp = torch.matmul(do_blk, v_blk.transpose(1, 2))
    ds = torch.where(valid, p * (dp - d_col) * scale, 0.0)
    return p, ds


# ---------------------------------------------------------------------------
# Plain twins.
# ---------------------------------------------------------------------------
def flash_fwd_plain(q, k, v, seeds, specs, *, scale, n_heads: int,
                    n_kv: int, causal: bool = True, window: int = 0,
                    q_block: int = _DEF_BLOCK, kv_block: int = _DEF_BLOCK,
                    q_offset: int = 0, return_logits: bool = False):
    """The forward over all B·H rows at once.  Returns (out, m, l), and
    the rounded masked logits (B·H, Sq, Skv) with ``return_logits``."""
    specs = AttnSpecs(*specs)
    q, k, v = q.float(), k.float(), v.float()
    BH, Sq, _ = q.shape
    Skv, dv = k.shape[1], v.shape[-1]
    dev = q.device
    seeds = _seeds(seeds, BH, 6, dev)
    qb, n_q = _blocks(Sq, q_block)
    kb, n_k = _blocks(Skv, kv_block)
    q_len = q_offset + Sq
    kv = _kv_of(torch.arange(BH, device=dev), n_heads, n_kv)
    qp = _pad_rows(q, n_q * qb)
    kp, vp = _pad_rows(k, n_k * kb)[kv], _pad_rows(v, n_k * kb)[kv]
    outs, ms, ls, logits = [], [], [], []
    for i in range(n_q):
        rows = torch.arange(qb, device=dev) + q_offset + i * qb
        m = torch.full((BH, qb, 1), -float("inf"), device=dev)
        l = torch.zeros((BH, qb, 1), device=dev)
        acc = torch.zeros((BH, qb, dv), device=dev)
        s_row = []
        for j in range(n_k):
            cols = torch.arange(kb, device=dev) + j * kb
            valid = _position_mask(rows, cols, q_len=q_len, kv_len=Skv,
                                   causal=causal, window=window)
            m, l, acc, s = _fwd_block(
                specs, scale, qp[:, i * qb:(i + 1) * qb],
                kp[:, j * kb:(j + 1) * kb], vp[:, j * kb:(j + 1) * kb],
                valid, rows, cols, Skv, j, seeds, m, l, acc)
            s_row.append(s)
        outs.append(_fwd_finish(specs, acc, l, rows, seeds))
        ms.append(m[..., 0])
        ls.append(l[..., 0])
        if return_logits:
            logits.append(torch.cat(s_row, dim=2)[:, :, :Skv])
    res = (torch.cat(outs, 1)[:, :Sq], torch.cat(ms, 1)[:, :Sq],
           torch.cat(ls, 1)[:, :Sq])
    if return_logits:
        res += (torch.cat(logits, 1)[:, :Sq],)
    return res


def flash_bwd_dq_plain(q, k, v, do, m, l, d, seeds, spec_qk, spec_dq, *,
                       scale, n_heads: int, n_kv: int, causal: bool = True,
                       window: int = 0, q_block: int = _DEF_BLOCK,
                       kv_block: int = _DEF_BLOCK, q_offset: int = 0):
    """dq (B·H, Sq, dk): each kv block's contribution rounded on
    ``spec_dq`` (stream = kv-block index), then summed."""
    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    BH, Sq, dk = q.shape
    Skv = k.shape[1]
    dev = q.device
    seeds = _seeds(seeds, BH, 4, dev)
    qb, n_q = _blocks(Sq, q_block)
    kb, n_k = _blocks(Skv, kv_block)
    q_len = q_offset + Sq
    kv = _kv_of(torch.arange(BH, device=dev), n_heads, n_kv)
    qp, dop = _pad_rows(q, n_q * qb), _pad_rows(do, n_q * qb)
    kp, vp = _pad_rows(k, n_k * kb)[kv], _pad_rows(v, n_k * kb)[kv]
    mp, lp, dpp = (_pad_rows(x.float()[..., None], n_q * qb)
                   for x in (m, l, d))
    dcols = torch.arange(dk, device=dev)
    out = []
    for i in range(n_q):
        sl = slice(i * qb, (i + 1) * qb)
        rows = torch.arange(qb, device=dev) + q_offset + i * qb
        acc = torch.zeros((BH, qb, dk), device=dev)
        for j in range(n_k):
            cols = torch.arange(kb, device=dev) + j * kb
            valid = _position_mask(rows, cols, q_len=q_len, kv_len=Skv,
                                   causal=causal, window=window)
            k_blk = kp[:, j * kb:(j + 1) * kb]
            _, ds = _bwd_p_ds(spec_qk, scale, qp[:, sl], k_blk,
                              vp[:, j * kb:(j + 1) * kb], dop[:, sl],
                              mp[:, sl], lp[:, sl], dpp[:, sl], valid, rows,
                              cols, seeds)
            dq_c = torch.matmul(ds, k_blk)
            acc = acc + common.apply_spec_block(
                spec_dq, dq_c, _draw(seeds, SITE_BWD_A, rows, dcols, spec_dq,
                                     j))
        out.append(acc)
    return torch.cat(out, 1)[:, :Sq]


def flash_bwd_dkv_plain(q, k, v, do, m, l, d, seeds, spec_qk, spec_dk,
                        spec_dv, *, scale, n_heads: int, n_kv: int,
                        causal: bool = True, window: int = 0,
                        q_block: int = _DEF_BLOCK,
                        kv_block: int = _DEF_BLOCK, q_offset: int = 0):
    """Per-query-head dk (B·H, Skv, dk) and dv (B·H, Skv, dv), each q
    block's contribution rounded (dk on ``spec_dk``, dv on ``spec_dv``,
    stream = q-block index), then summed."""
    q, k, v, do = q.float(), k.float(), v.float(), do.float()
    BH, Sq, dk = q.shape
    Skv, dv = k.shape[1], v.shape[-1]
    dev = q.device
    seeds = _seeds(seeds, BH, 6, dev)
    qb, n_q = _blocks(Sq, q_block)
    kb, n_k = _blocks(Skv, kv_block)
    q_len = q_offset + Sq
    kv = _kv_of(torch.arange(BH, device=dev), n_heads, n_kv)
    qp, dop = _pad_rows(q, n_q * qb), _pad_rows(do, n_q * qb)
    kp, vp = _pad_rows(k, n_k * kb)[kv], _pad_rows(v, n_k * kb)[kv]
    mp, lp, dpp = (_pad_rows(x.float()[..., None], n_q * qb)
                   for x in (m, l, d))
    kcols, vcols = torch.arange(dk, device=dev), torch.arange(dv, device=dev)
    dks, dvs = [], []
    for j in range(n_k):
        ksl = slice(j * kb, (j + 1) * kb)
        cols = torch.arange(kb, device=dev) + j * kb
        acc_dk = torch.zeros((BH, kb, dk), device=dev)
        acc_dv = torch.zeros((BH, kb, dv), device=dev)
        for i in range(n_q):
            sl = slice(i * qb, (i + 1) * qb)
            rows = torch.arange(qb, device=dev) + q_offset + i * qb
            valid = _position_mask(rows, cols, q_len=q_len, kv_len=Skv,
                                   causal=causal, window=window)
            q_blk, do_blk = qp[:, sl], dop[:, sl]
            p, ds = _bwd_p_ds(spec_qk, scale, q_blk, kp[:, ksl], vp[:, ksl],
                              do_blk, mp[:, sl], lp[:, sl], dpp[:, sl],
                              valid, rows, cols, seeds)
            dv_c = torch.matmul(p.transpose(1, 2), do_blk)
            acc_dv = acc_dv + common.apply_spec_block(
                spec_dv, dv_c, _draw(seeds, SITE_BWD_B, cols, vcols, spec_dv,
                                     i))
            dk_c = torch.matmul(ds.transpose(1, 2), q_blk)
            acc_dk = acc_dk + common.apply_spec_block(
                spec_dk, dk_c, _draw(seeds, SITE_BWD_A, cols, kcols, spec_dk,
                                     i))
        dks.append(acc_dk)
        dvs.append(acc_dv)
    return torch.cat(dks, 1)[:, :Skv], torch.cat(dvs, 1)[:, :Skv]


def flash_decode_plain(q, k, v, seeds, length: int, specs, *, scale,
                       window: int = 0, kv_block: int = _DEF_BLOCK,
                       kv_fmt=None):
    """One-token decode: q (B·KV, G, dk); k/v (B·KV, S_max, d) float, or
    code words of ``kv_fmt``; ``length`` valid rows including the new
    token.  Returns (B·KV, G, dv) float32."""
    specs = AttnSpecs(*specs)
    q = q.float()
    if kv_fmt is not None:
        k, v = common.unpack_block(k, kv_fmt), common.unpack_block(v, kv_fmt)
    k, v = k.float(), v.float()
    BKV, G, _ = q.shape
    Smax, dv = k.shape[1], v.shape[-1]
    dev = q.device
    seeds = _seeds(seeds, BKV, 6, dev)
    kb, n_k = _blocks(Smax, kv_block)
    kp, vp = _pad_rows(k, n_k * kb), _pad_rows(v, n_k * kb)
    rows = torch.arange(G, device=dev)
    qpos = torch.full((G,), length - 1, dtype=torch.int64, device=dev)
    m = torch.full((BKV, G, 1), -float("inf"), device=dev)
    l = torch.zeros((BKV, G, 1), device=dev)
    acc = torch.zeros((BKV, G, dv), device=dev)
    for j in range(n_k):
        cols = torch.arange(kb, device=dev) + j * kb
        valid = _position_mask(qpos, cols, q_len=length, kv_len=length,
                               causal=True, window=window)
        m, l, acc, _ = _fwd_block(
            specs, scale, q, kp[:, j * kb:(j + 1) * kb],
            vp[:, j * kb:(j + 1) * kb], valid, rows, cols, length, j, seeds,
            m, l, acc)
    return _fwd_finish(specs, acc, l, rows, seeds)


def _int_rows(x, shape, what: str, device) -> torch.Tensor:
    """An int32 operand (numpy array, sequence or tensor) on ``device``."""
    if isinstance(x, torch.Tensor):
        t = x.to(device=device, dtype=torch.int32)
    else:
        t = common.host_to_device(np.asarray(x, dtype=np.int32), device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t


def flash_decode_paged_plain(q, k_pages, v_pages, seeds, lengths, tables,
                             specs, *, scale, n_kv: int, window: int = 0,
                             kv_fmt=None):
    """One-token decode over a paged cache: q (B·KV, G, dk); k/v pages
    (P·KV, page, d), float values or code words of ``kv_fmt``, page ``p``
    of kv head ``h`` at row ``p·KV + h``; lengths (B,) valid rows per
    request including the new token; tables (B, n_max) logical ->
    physical page ids.  Each request's logical blocks (one page each) are
    replayed through the reference's ``_fwd_block`` / ``_fwd_finish``.
    Returns (B·KV, G, dv) float32."""
    specs = AttnSpecs(*specs)
    q = q.float()
    if kv_fmt is not None:
        k_pages = common.unpack_block(k_pages, kv_fmt)
        v_pages = common.unpack_block(v_pages, kv_fmt)
    k_pages, v_pages = k_pages.float(), v_pages.float()
    BKV, G, _ = q.shape
    page, dv = k_pages.shape[1], v_pages.shape[-1]
    dev = q.device
    B = BKV // n_kv
    seeds = _seeds(seeds, BKV, 6, dev)
    lens = _int_rows(lengths, (B,), "lengths", dev).long()
    tables = torch.as_tensor(tables, device=dev).long()
    n_max = tables.shape[1]
    b_of = torch.arange(BKV, device=dev) // n_kv
    lens_r = lens[b_of][:, None, None]                 # (B·KV, 1, 1)
    rows = torch.arange(G, device=dev)
    m = torch.full((BKV, G, 1), -float("inf"), device=dev)
    l = torch.zeros((BKV, G, 1), device=dev)
    acc = torch.zeros((BKV, G, dv), device=dev)
    for j in range(n_max):
        phys = tables[b_of, j] * n_kv + torch.arange(BKV, device=dev) % n_kv
        cols = torch.arange(page, device=dev) + j * page
        valid = cols[None, None, :] < lens_r            # (B·KV, 1, page)
        if window:
            valid = valid & (cols[None, None, :] > lens_r - 1 - window)
        valid = valid.expand(BKV, G, page)
        v_blk = torch.where((cols[None, :, None] < lens_r), v_pages[phys],
                            0.0)
        m, l, acc, _ = _fwd_block(
            specs, scale, q, k_pages[phys], v_blk, valid, rows, cols,
            (j + 1) * page, j, seeds, m, l, acc)
    return _fwd_finish(specs, acc, l, rows, seeds)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------
def _site_args(specs):
    """(int[6·n], float[n]) rounding parameters of each site: precision,
    emin, emax, mode, rand_bits, enabled; xmax.  Raises on what the
    kernels do not implement."""
    ints, xmax = [], []
    for s in specs:
        if s.is_identity:
            ints += [0, 0, 0, 0, 32, 0]
            xmax.append(0.0)
            continue
        grid = get_grid(s.fmt)
        scheme = get_scheme(s.mode).name
        if grid.kind != "fp" or grid.transformed or not grid.fmt.subnormals:
            raise NotImplementedError(f"attention site grid {grid.name!r} "
                                      "is not ported yet (plain FP grids)")
        if scheme not in _MODES or s.eps or s.overflow != "saturate":
            raise NotImplementedError(f"attention site spec {s} is not "
                                      "ported yet (rn and sr, saturating)")
        f = grid.fmt
        ints += [f.precision, f.emin, f.emax, _MODES[scheme], s.rand_bits, 1]
        xmax.append(f.xmax)
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(xmax))(*xmax))


def _check(tensors, what: str, d_max: int):
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: operands on different devices")
    if d_max > D_MAX[what]:
        raise NotImplementedError(f"{what}: head dims above {D_MAX[what]} "
                                  "are not ported yet")
    return dev.type == "cpu"


def _check_gqa(BH, BKV, n_heads, n_kv):
    if n_heads % n_kv or BH % n_heads or BH // n_heads * n_kv != BKV:
        raise ValueError(f"bad GQA shapes: BH={BH} BKV={BKV} H={n_heads} "
                         f"KV={n_kv}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _dev_seeds(seeds, n: int, cols: int, dev) -> torch.Tensor:
    """Seed words as int32 bit patterns on the card (an int32 tensor there
    already is taken as it is)."""
    if isinstance(seeds, torch.Tensor):
        if seeds.device == dev and seeds.dtype == torch.int32 \
                and tuple(seeds.shape) == (n, cols):
            return seeds.contiguous()
        seeds = seeds.cpu().numpy()
    arr = np.asarray(seeds).astype(np.int64).astype(np.uint32).view(np.int32)
    if arr.shape != (n, cols):
        raise ValueError(f"seeds must be ({n}, {cols}) uint32 site words, "
                         f"got {arr.shape}")
    return common.host_to_device(arr, dev)


def _launch(name: str, *args) -> None:
    fn = getattr(build.load("flash_attention"), name)
    fn.restype = ctypes.c_int
    rc = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _common_args(BH, Sq, Skv, dk, dv, n_heads, n_kv, q_block, kv_block,
                 q_offset, causal, window, scale):
    return [ctypes.c_int(x) for x in (BH, Sq, Skv, dk, dv, n_heads, n_kv,
                                       min(q_block, Sq), min(kv_block, Skv),
                                       q_offset, int(causal), window)] \
        + [ctypes.c_float(scale)]


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def fwd_tile_keys(d: int) -> int:
    """Keys per staged tile of K6's single-pass kernel (``csrc/
    flash_attention.cu:fwd1_tile_keys``): 128, or 64 at d = 256."""
    return 64 if d > 128 else 128


def fwd_smem_bytes(kb: int, d: int) -> int:
    """Shared memory of one block of K6's single-pass kernel
    (``csrc/flash_attention.cu:fwd1_smem``): q rows, two staged k/v tiles,
    the logits over a logical block of ``kb`` keys (in whole tiles),
    row statistics."""
    tk = fwd_tile_keys(d)
    stride = -(-kb // tk) * tk + 4
    return 4 * (FWD_ROWS * d + 2 * tk * d + FWD_ROWS * stride
                + 4 * FWD_ROWS)


def fwd_kernel_for(Skv: int, dk: int, dv: int, kv_block: int) -> str:
    """The kernel K6 launches for a shape: ``"flash_fwd"``, the single
    pass, where ``dk == dv`` is one of ``FWD_DIMS`` and a block's logits
    over a logical kv block fit in shared memory; else
    ``"flash_fwd_two_pass"``, which recomputes each logit in a second pass
    instead of holding it.  Both give the same bits."""
    kb = min(kv_block, Skv)
    if dk != dv or dk not in FWD_DIMS or kb < 1 \
            or fwd_smem_bytes(kb, dk) > SMEM_MAX:
        return "flash_fwd_two_pass"
    return "flash_fwd"


def bwd_rows(d: int) -> int:
    """Rows of a tiled backward block and of its tiles at head dim ``d``
    (``csrc/flash_attention.cu:bwd_rows``): 64, or 32 at d = 256, where
    64-row blocks would not fit in shared memory."""
    return 32 if d > 128 else 64


def bwd_smem_bytes(grads: str, d: int) -> int:
    """Shared memory of one block of the tiled backward kernels
    (``csrc/flash_attention.cu:dq_tile_smem``, ``dkv_tile_smem``) at
    ``bwd_rows(d)`` rows: for ``"dq"`` (K7) the block's q and dO rows, two
    k and two v tiles, the tile's ds and three row statistics; for
    ``"dkv"`` (K7') the block's k and v rows, one q and one dO tile, the
    tile's p and ds, the tile's row statistics."""
    r = bwd_rows(d)
    if grads == "dq":
        return 4 * (2 * r * d + 4 * r * d + r * r + 3 * r)
    if grads == "dkv":
        return 4 * (2 * r * d + 2 * r * d + 2 * r * r + 3 * r)
    raise ValueError(f"grads must be 'dq' or 'dkv', got {grads!r}")


def bwd_kernel_for(dk: int, dv: int, grads: str) -> str:
    """The kernel K7 (``grads="dq"``) or K7' (``"dkv"``) launches for a
    shape: the tiled kernel (``"flash_bwd_dq"``, ``"flash_bwd_dkv"``)
    where ``dk == dv`` is one of ``BWD_DIMS`` and its block fits in shared
    memory, else the first kernel (``"flash_bwd_dq_simple"``,
    ``"flash_bwd_dkv_simple"``).  Both give the same bits."""
    name = f"flash_bwd_{grads}"
    if dk != dv or dk not in BWD_DIMS \
            or bwd_smem_bytes(grads, dk) > SMEM_MAX:
        return name + "_simple"
    return name


def _bwd_kernel(name: str, dk: int, dv: int, kernel: Optional[str]) -> str:
    """The kernel a backward wrapper launches: ``bwd_kernel_for``'s, or
    ``kernel`` where it names that one or the first kernel."""
    want = bwd_kernel_for(dk, dv, name.rsplit("_", 1)[1])
    if kernel not in (None, want, name + "_simple"):
        raise ValueError(f"{name}: cannot launch {kernel!r} for this shape "
                         f"(it takes {want!r})")
    return kernel or want


def decode_smem_bytes(page: int, dk: int, dv: int, elt_bytes: int,
                      n_max: int) -> int:
    """Shared memory of one decode-kernel block (``csrc/flash_attention.cu:
    decode_smem``): staged V rows, q, a round's logits (a whole page's
    where pages are longer than ``DEC_KEYS``), the pages' maxima and sums,
    their rounded P.V partials and the request's block table (``n_max =
    0`` for K9's contiguous cache)."""
    def up(x, m):
        return -(-x // m) * m
    return up(DEC_KEYS * dv * elt_bytes, 16) + 4 * (
        up(dk, 4) + max(page, DEC_KEYS) + 2 * DEC_PAGES + DEC_PAGES * dv
        + n_max)


def decode_kernel_for(Smax: int, kv_block: int, dk: int, dv: int,
                      elt_bytes: int) -> str:
    """The kernel K9 launches for a shape: ``"flash_decode"``, the decode
    kernel reading the cache as pages of ``min(kv_block, Smax)`` keys,
    where a block's logits over one such page fit in shared memory
    (``decode_smem_bytes`` with no table); else ``"flash_decode_tiled"``,
    which walks a block in 64-key tiles twice instead of holding its
    logits.  ``elt_bytes``: 4 for a float32 cache, else the code width.
    Both give the same bits."""
    kb = min(kv_block, Smax)
    if kb < 1 or decode_smem_bytes(kb, dk, dv, elt_bytes, 0) > SMEM_MAX:
        return "flash_decode_tiled"
    return "flash_decode"


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its data does not start on 16 bytes (the
    single-pass kernel stages k and v rows with 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_fwd(q, k, v, seeds, specs, *, scale, n_heads: int, n_kv: int,
              causal: bool = True, window: int = 0,
              q_block: int = _DEF_BLOCK, kv_block: int = _DEF_BLOCK,
              q_offset: int = 0, return_logits: bool = False,
              kernel: Optional[str] = None):
    """Rounded flash-attention forward.  q: (B·H, Sq, dk); k/v: (B·KV,
    Skv, dk/dv); seeds: (B·H, 6) [qk | av | out] words.  Returns (out
    (B·H, Sq, dv), m (B·H, Sq), l (B·H, Sq)) float32, and with
    ``return_logits`` the rounded masked logits (B·H, Sq, Skv) (-inf
    where masked), which the checks compare bitwise.  ``kernel``: on the
    card, ``"flash_fwd_two_pass"`` launches the two-pass kernel whatever
    ``fwd_kernel_for`` chooses (the checks hold the two against each
    other)."""
    specs = AttnSpecs(*specs)
    BH, Sq, dk = q.shape
    BKV, Skv, _ = k.shape
    dv = v.shape[-1]
    _check_gqa(BH, BKV, n_heads, n_kv)
    site_ints, site_xmax = _site_args(specs)
    name = fwd_kernel_for(Skv, dk, dv, kv_block)
    if kernel not in (None, name, "flash_fwd_two_pass"):
        raise ValueError(f"flash_fwd: cannot launch {kernel!r} for this "
                         f"shape (it takes {name!r})")
    if _check((q, k, v), "flash_fwd", max(dk, dv)):
        return flash_fwd_plain(q, k, v, seeds, specs, scale=scale,
                               n_heads=n_heads, n_kv=n_kv, causal=causal,
                               window=window, q_block=q_block,
                               kv_block=kv_block, q_offset=q_offset,
                               return_logits=return_logits)
    dev = q.device
    q, k, v = _f32(q), _aligned16(_f32(k)), _aligned16(_f32(v))
    out = torch.empty((BH, Sq, dv), device=dev)
    m = torch.empty((BH, Sq), device=dev)
    l = torch.empty((BH, Sq), device=dev)
    s_out = torch.full((BH, Sq, Skv), -float("inf"), device=dev) \
        if return_logits else None
    if out.numel():
        _launch(kernel or name, _ptr(q), _ptr(k), _ptr(v),
                _ptr(_dev_seeds(seeds, BH, 6, dev)), _ptr(out), _ptr(m),
                _ptr(l), _ptr(s_out),
                *_common_args(BH, Sq, Skv, dk, dv, n_heads, n_kv, q_block,
                              kv_block, q_offset, causal, window, scale),
                site_ints, site_xmax)
    return (out, m, l, s_out) if return_logits else (out, m, l)


def _bwd_operands(q, k, v, do, m, l, d):
    """The backward's float32 operands; q, k, v and dO on 16-byte
    boundaries (the tiled kernels stage their rows with 16-byte copies)."""
    return [_aligned16(_f32(t)) for t in (q, k, v, do)] \
        + [_f32(t) for t in (m, l, d)]


def flash_bwd_dq(q, k, v, do, m, l, d, seeds, spec_qk: RoundingSpec,
                 spec_dq: RoundingSpec, *, scale, n_heads: int, n_kv: int,
                 causal: bool = True, window: int = 0,
                 q_block: int = _DEF_BLOCK, kv_block: int = _DEF_BLOCK,
                 q_offset: int = 0, kernel: Optional[str] = None):
    """dq backward.  seeds: (B·H, 4) [qk | dq] words, the qk pair the
    forward's; m, l: the forward's residuals; d = rowwise sum(do·out).
    ``kernel``: on the card, ``"flash_bwd_dq_simple"`` launches the first
    kernel whatever ``bwd_kernel_for`` chooses (the checks hold the two
    against each other)."""
    BH, Sq, dk = q.shape
    BKV, Skv, _ = k.shape
    dv = v.shape[-1]
    _check_gqa(BH, BKV, n_heads, n_kv)
    site_ints, site_xmax = _site_args((spec_qk, spec_dq))
    name = _bwd_kernel("flash_bwd_dq", dk, dv, kernel)
    if _check((q, k, v, do, m, l, d), "flash_bwd_dq", max(dk, dv)):
        return flash_bwd_dq_plain(q, k, v, do, m, l, d, seeds, spec_qk,
                                  spec_dq, scale=scale, n_heads=n_heads,
                                  n_kv=n_kv, causal=causal, window=window,
                                  q_block=q_block, kv_block=kv_block,
                                  q_offset=q_offset)
    dev = q.device
    dq = torch.empty((BH, Sq, dk), device=dev)
    if dq.numel():
        ops = _bwd_operands(q, k, v, do, m, l, d)
        _launch(name, *map(_ptr, ops),
                _ptr(_dev_seeds(seeds, BH, 4, dev)), _ptr(dq),
                *_common_args(BH, Sq, Skv, dk, dv, n_heads, n_kv, q_block,
                              kv_block, q_offset, causal, window, scale),
                site_ints, site_xmax)
    return dq


def flash_bwd_dkv(q, k, v, do, m, l, d, seeds, spec_qk: RoundingSpec,
                  spec_dk: RoundingSpec, spec_dv: RoundingSpec, *, scale,
                  n_heads: int, n_kv: int, causal: bool = True,
                  window: int = 0, q_block: int = _DEF_BLOCK,
                  kv_block: int = _DEF_BLOCK, q_offset: int = 0,
                  kernel: Optional[str] = None):
    """dk/dv backward, per query head: (B·H, Skv, dk), (B·H, Skv, dv).
    seeds: (B·H, 6) [qk | dk | dv] words.  The GQA group-sum to kv heads
    happens outside, in float32.  ``kernel``: on the card,
    ``"flash_bwd_dkv_simple"`` launches the first kernel whatever
    ``bwd_kernel_for`` chooses."""
    BH, Sq, dk = q.shape
    BKV, Skv, _ = k.shape
    dv = v.shape[-1]
    _check_gqa(BH, BKV, n_heads, n_kv)
    site_ints, site_xmax = _site_args((spec_qk, spec_dk, spec_dv))
    name = _bwd_kernel("flash_bwd_dkv", dk, dv, kernel)
    if _check((q, k, v, do, m, l, d), "flash_bwd_dkv", max(dk, dv)):
        return flash_bwd_dkv_plain(q, k, v, do, m, l, d, seeds, spec_qk,
                                   spec_dk, spec_dv, scale=scale,
                                   n_heads=n_heads, n_kv=n_kv, causal=causal,
                                   window=window, q_block=q_block,
                                   kv_block=kv_block, q_offset=q_offset)
    dev = q.device
    dk_h = torch.empty((BH, Skv, dk), device=dev)
    dv_h = torch.empty((BH, Skv, dv), device=dev)
    if dk_h.numel():
        ops = _bwd_operands(q, k, v, do, m, l, d)
        _launch(name, *map(_ptr, ops),
                _ptr(_dev_seeds(seeds, BH, 6, dev)), _ptr(dk_h), _ptr(dv_h),
                *_common_args(BH, Sq, Skv, dk, dv, n_heads, n_kv, q_block,
                              kv_block, q_offset, causal, window, scale),
                site_ints, site_xmax)
    return dk_h, dv_h


def flash_decode(q, k, v, seeds, length: int, specs, *, scale,
                 window: int = 0, kv_block: int = _DEF_BLOCK, kv_fmt=None,
                 kernel: Optional[str] = None):
    """Rounded one-token decode over the whole cache.  q: (B·KV, G, dk),
    the G query heads of each kv group; k/v: (B·KV, S_max, dk/dv), float
    values or, with ``kv_fmt``, code words of that grid (decoded on load);
    ``length``: valid cache rows including the new token.  Returns (B·KV,
    G, dv) float32.  ``kernel``: on the card, ``"flash_decode_tiled"``
    launches the tiled kernel whatever ``decode_kernel_for`` chooses (the
    checks hold the two against each other)."""
    specs = AttnSpecs(*specs)
    BKV, G, dk = q.shape
    Smax, dv = k.shape[1], v.shape[-1]
    length = int(length)
    if not 0 < length <= Smax:
        raise ValueError(f"length {length} outside 1..{Smax}")
    site_ints, site_xmax = _site_args(specs)
    if kv_fmt is not None:
        want = common.pack_dtype(kv_fmt)
        if k.dtype != want or v.dtype != want:
            raise ValueError(f"packed {kv_fmt} cache must hold {want} codes")
        ebits, mbits, width, has_nf = common.pack_spec(kv_fmt)
        pack = (ctypes.c_int * 5)(width, ebits, mbits,
                                  get_grid(kv_fmt).fmt.emin, int(has_nf))
    else:
        pack = (ctypes.c_int * 5)(0, 0, 0, 0, 0)
    name = decode_kernel_for(Smax, kv_block, dk, dv, pack[0] or 4)
    if kernel not in (None, name, "flash_decode_tiled"):
        raise ValueError(f"flash_decode: cannot launch {kernel!r} for this "
                         f"shape (it takes {name!r})")
    if _check((q, k, v), "flash_decode", max(dk, dv)):
        return flash_decode_plain(q, k, v, seeds, length, specs, scale=scale,
                                  window=window, kv_block=kv_block,
                                  kv_fmt=kv_fmt)
    dev = q.device
    q = _f32(q)
    if kv_fmt is None:
        k, v = _f32(k), _f32(v)
    else:
        k, v = k.contiguous(), v.contiguous()
    out = torch.empty((BKV, G, dv), device=dev)
    if out.numel():
        _launch(kernel or name, _ptr(q), _ptr(k), _ptr(v), pack,
                _ptr(_dev_seeds(seeds, BKV, 6, dev)), _ptr(out),
                *[ctypes.c_int(x) for x in (BKV, G, Smax, dk, dv, length,
                                            min(kv_block, Smax), window)],
                ctypes.c_float(scale), site_ints, site_xmax)
    return out


def flash_decode_paged(q, k_pages, v_pages, seeds, lengths, tables, specs, *,
                       scale, n_kv: int, window: int = 0, kv_fmt=None):
    """Rounded one-token decode over a paged cache (K10).  q: (B·KV, G,
    dk); k/v pages (P·KV, page, dk/dv), float values or code words of
    ``kv_fmt``, page ``p`` of kv head ``h`` at row ``p·KV + h``; lengths
    (B,) valid rows per request including the new token; tables (B,
    n_max) logical -> physical page ids, every entry a page of the pool
    (filler entries past a request's pages point at scratch page 0, whose
    rows are masked).  lengths and tables may be int32 tensors on the card
    (the kernel reads them there: no host round trip per step) or host
    arrays.  Returns (B·KV, G, dv) float32.  On the card, pages whose
    logits overflow the kernel's shared memory (``decode_smem_bytes``)
    raise NotImplementedError; the CPU twin takes any page."""
    specs = AttnSpecs(*specs)
    BKV, G, dk = q.shape
    PKV, page, _ = k_pages.shape
    dv = v_pages.shape[-1]
    if BKV % n_kv or PKV % n_kv:
        raise ValueError(f"B·KV={BKV} / P·KV={PKV} not multiples of "
                         f"n_kv={n_kv}")
    B = BKV // n_kv
    site_ints, site_xmax = _site_args(specs)
    pack = (ctypes.c_int * 5)(0, 0, 0, 0, 0)
    if kv_fmt is not None:
        want = common.pack_dtype(kv_fmt)
        if k_pages.dtype != want or v_pages.dtype != want:
            raise ValueError(f"packed {kv_fmt} pages must hold {want} codes")
        ebits, mbits, width, has_nf = common.pack_spec(kv_fmt)
        pack = (ctypes.c_int * 5)(width, ebits, mbits,
                                  get_grid(kv_fmt).fmt.emin, int(has_nf))
    if _check((q, k_pages, v_pages), "flash_decode_paged", max(dk, dv)):
        return flash_decode_paged_plain(q, k_pages, v_pages, seeds, lengths,
                                        tables, specs, scale=scale,
                                        n_kv=n_kv, window=window,
                                        kv_fmt=kv_fmt)
    dev = q.device
    lens = _int_rows(lengths, (B,), "lengths", dev).contiguous()
    if not isinstance(tables, torch.Tensor):
        tables = np.asarray(tables, dtype=np.int32)
    if len(tables.shape) != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be ({B}, n_max), got "
                         f"{tuple(tables.shape)}")
    n_max = tables.shape[1]
    tbl = _int_rows(tables, (B, n_max), "tables", dev).contiguous()
    if decode_smem_bytes(page, dk, dv, pack[0] or 4, n_max) > SMEM_MAX:
        raise NotImplementedError(f"flash_decode_paged: pages of {page} "
                                  f"keys in tables of {n_max} do not fit "
                                  "the kernel's shared memory")
    q = _f32(q)
    if kv_fmt is None:
        k_pages, v_pages = _f32(k_pages), _f32(v_pages)
    else:
        k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    out = torch.empty((BKV, G, dv), device=dev)
    if out.numel():
        _launch("flash_decode_paged", _ptr(q), _ptr(k_pages), _ptr(v_pages),
                pack, _ptr(_dev_seeds(seeds, BKV, 6, dev)), _ptr(lens),
                _ptr(tbl), _ptr(out),
                *[ctypes.c_int(x) for x in (BKV, G, n_kv, n_max, page, dk,
                                            dv, window)],
                ctypes.c_float(scale), site_ints, site_xmax)
    return out
