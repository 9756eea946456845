"""Paged quantized KV cache: the serving side's storage (counterpart of
``repro.serving.paged_cache``).

The decode cache is a pool of fixed-size pages shared by every request in
flight.  Each request owns a logical sequence of pages named by its block
table; the pool holds the same rounded values (code words, or float32
values without ``kv_cache_packed``) the contiguous cache does.

Layout (what K10, ``kernels.flash_attention.flash_decode_paged``, reads):
the per-layer pool is ``(P, KV, page, d)``, which the kernel views as
``(P·KV, page, d)``: physical page ``p`` of kv head ``h`` is row
``p·KV + h``.  Page 0 is the allocator's scratch page: every unused
block-table entry points at it, and appends of inactive batch slots are
sent to its row 0.  Its rows are never read as valid positions (masked,
or skipped by K10), so placement and slot occupancy never reach the
numbers a request sees.

Randomness rides the request, not the slot: ``words`` holds request×layer
words (``precision.attention.request_layer_words``), and every KV-store
and attention-site draw is keyed by (request seed, layer, absolute
position, kv head, site).

The reference stacks every leaf over layers because its scan over layers
slices them all; the port loops over layers in Python, so only the pools
and the words are stacked, and the block tables, lengths and append flags
(the same for every layer) are held once.  The host keeps its own copies
of the lengths and append flags: the rounding bits and the append indices
are computed from them without reading the card.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels import common


@dataclasses.dataclass
class PagedKVCache:
    """The page pools of every layer and the slots' state for one model
    call.

    k_pages/v_pages: (L, P, KV, page, d) on the device;
    tables:  (B, n_max) int32 on the device, logical -> physical page ids
             (page 0 filler);
    lengths: (B,) tokens already cached per slot (host);
    words:   (L, B, 2) request×layer words (host, uint32 values in int64);
    append:  (B,) bool (host): slots whose new tokens really append
             (inactive slots write into scratch page 0 row 0 and keep their
             length).
    """
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    tables: torch.Tensor
    lengths: np.ndarray
    words: np.ndarray
    append: np.ndarray
    _index: dict = dataclasses.field(default_factory=dict, repr=False)

    def new_lengths(self, S: int) -> np.ndarray:
        """Lengths after appending S tokens to every appending slot."""
        return (self.lengths + np.where(self.append, S, 0)).astype(np.int32)

    def device_lengths(self, S: int) -> torch.Tensor:
        """``new_lengths(S)`` on the device, copied once per call."""
        key = ("lengths", S)
        if key not in self._index:
            self._index[key] = common.host_to_device(self.new_lengths(S),
                                                     self.k_pages.device)
        return self._index[key]

    def site_seeds(self, layer: int, n_kv: int) -> torch.Tensor:
        """Layer ``layer``'s (B·KV, 6) K10 seeds for a one-token call, as
        int32 bit patterns on the device; every layer's are derived and
        copied at once, on first use."""
        key = ("seeds", n_kv)
        if key not in self._index:
            from repro_torch.precision import attention as PA
            seeds = PA.request_site_seeds(self.words,
                                          self.new_lengths(1) - 1, n_kv)
            self._index[key] = common.host_to_device(
                seeds.astype(np.uint32).view(np.int32), self.k_pages.device)
        return self._index[key][layer]

    def kv_bits(self, layer: int, spec, S: int, F: int) -> torch.Tensor:
        """Layer ``layer``'s KV-store bits (k and v streams) of an
        S-token append, (2, B, S, F) on the device; every layer's are
        drawn there at once, on first use."""
        key = ("kv", spec.rand_bits, S, F)
        if key not in self._index:
            from repro_torch.precision import attention as PA
            from repro_torch.precision.policy import TAG_ATTN_KV
            w_kv = PA.fold_words_vec(self.words, TAG_ATTN_KV)
            self._index[key] = PA.kv_request_bits(
                w_kv, self.lengths, S, F, spec.rand_bits, (0, 1),
                device=self.k_pages.device)
        return self._index[key][layer]

    def append_index(self, S: int):
        """(page, row) device indices of S appended tokens per slot, the
        same for every layer: computed once per call."""
        key = ("append", S)
        if key not in self._index:
            self._index[key] = append_index(self.tables, self.lengths,
                                            self.append, S,
                                            self.k_pages.shape[3])
        return self._index[key]


def request_words(seed: int) -> prng.Key:
    """The root words of one request's rounding streams: a pure function
    of the request's integer seed."""
    return prng.derive_seed(prng.PRNGKey(seed))


def init_paged_cache(cfg, n_slots: int, total_pages: int, page_size: int,
                     n_max: int, device=None) -> PagedKVCache:
    """A zeroed page pool of every layer and empty slots.  The pool's dtype
    follows ``cfg.gemm_policy``'s ``kv_cache_fmt`` as the contiguous
    cache's does (code words, float32 grid values, or bf16)."""
    from repro_torch.models import attention as MA   # MA imports us
    nl = cfg.n_layers
    shape = (nl, total_pages, cfg.n_kv_heads, page_size,
             cfg.resolved_head_dim)
    dt = MA.cache_dtype(cfg)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dt, device=device),
        v_pages=torch.zeros(shape, dtype=dt, device=device),
        tables=torch.zeros((n_slots, n_max), dtype=torch.int32,
                           device=device),
        lengths=np.zeros((n_slots,), np.int32),
        words=np.zeros((nl, n_slots, 2), np.int64),
        append=np.zeros((n_slots,), bool))


def append_index(tables, lengths, append, S: int, page: int):
    """Where S appended tokens of each slot land: token ``s`` of slot
    ``b`` goes to logical position ``lengths[b] + s``, i.e. page
    ``tables[b, pos // page]``, row ``pos % page``; slots with
    ``append[b]`` False go to scratch page 0 row 0.  ``tables`` is a
    device tensor, the rest host arrays.  Returns (page, row) int64
    tensors of shape (B, S) on the tables' device."""
    dev = tables.device
    n_max = tables.shape[1]
    pos = np.asarray(lengths, np.int64)[:, None] + np.arange(S)[None]
    on = np.asarray(append, bool)[:, None]
    logical = np.minimum(pos // page, n_max - 1)
    off = np.where(on, pos % page, 0)
    logical_t = common.host_to_device(logical, dev)
    phys = torch.gather(tables.long(), 1, logical_t)
    phys = torch.where(common.host_to_device(on, dev), phys,
                       torch.zeros_like(phys))
    return phys, common.host_to_device(off, dev)


def paged_append(pages: torch.Tensor, tables, lengths, append,
                 vals: torch.Tensor, index=None) -> torch.Tensor:
    """Scatter an appended chunk into one layer's pool, in place: pages
    (P, KV, page, d); tables (B, n_max) on the pool's device; lengths,
    append (B,) on the host; vals (B, S, KV, d) rounded (and possibly
    packed) values.  ``index``: their ``append_index``, when the caller
    has it.  One ``index_put_``: the advanced indices (B, S) on axes 0 and
    2 with the kv axis between them give the (B, S, KV, d) layout of
    ``vals``.  Returns ``pages``."""
    if index is None:
        index = append_index(tables, lengths, append, vals.shape[1],
                             pages.shape[2])
    phys, off = index
    kv = torch.arange(pages.shape[1], device=pages.device)
    return pages.index_put_((phys[..., None], kv[None, None], off[..., None]),
                            vals.to(pages.dtype))


def paged_gather(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Each slot's logical cache view (one layer): (P, KV, page, d) +
    (B, n_max) -> (B, n_max·page, KV, d), the layout attention's gathered
    path takes.  Filler entries surface scratch-page values at positions
    at or past the slot's length, which every consumer masks."""
    B, n_max = tables.shape
    g = pages[tables.long()]                 # (B, n_max, KV, page, d)
    return g.transpose(2, 3).reshape(B, n_max * pages.shape[2],
                                     pages.shape[1], pages.shape[3])


class BlockAllocator:
    """Host-side free-list page allocator.  Page 0 is never handed out:
    it is the scratch page filler table entries point at."""

    def __init__(self, total_pages: int):
        if total_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is scratch)")
        self.total_pages = total_pages
        self._free: List[int] = list(range(total_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages, or None (the caller defers admission) when short."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            if not 0 < p < self.total_pages:
                raise ValueError(f"free({p}) out of range")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)
