"""Continuous-batching serving engine over the paged quantized KV cache
(counterpart of ``repro.serving.engine``).

An iteration loop on ``models.Model.decode_step``:

* **admission**: per-tenant round-robin over FIFO queues, gated on a free
  batch slot and a page reservation for the whole request (prompt +
  ``max_new_tokens``; no preemption, so an admitted request can always
  finish).  The first request that does not fit stops admission for the
  iteration, so a big request is never starved by later small ones.
* **chunked prefill**: each admitted prompt is absorbed in chunks of
  ``prefill_chunk`` tokens at batch width 1 (its own slot's view of the
  shared pool).  Chunk boundaries depend only on (prompt length,
  ``prefill_chunk``); the token budget decides how many whole chunks run,
  never where they split.
* **decode**: one batched single-token step per iteration over all slots
  (empty slots ride along: token 0 in, their append sent to the scratch
  page, their output dropped).  The greedy pick is an argmax on the
  device; one copy of the picks to the host per iteration.
* **completion and eviction**: a request's pages and slot are freed the
  moment it has its tokens; ``cancel`` evicts early.

Determinism contract: under a GEMM-identity policy (attention sites and
``kv_cache_fmt`` only, e.g. ``make_policy(attn=..., kv_cache_fmt=...)``)
every rounded value a request sees is keyed by (request seed, layer,
position, kv head, site), so its token stream is the same, bit for bit,
under any arrival schedule, slot, co-tenants and batch width.  Policies
that also round the GEMMs are deterministic per engine configuration but
depend on the schedule, as the fixed-batch driver does.

The host keeps the slots' tables, lengths and request×layer words; the
block tables go to the card as one small copy, made again only when a
request is admitted or released.  Everything runs under
``torch.inference_mode()``.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.prng import M32
from repro_torch.kernels import common
from repro_torch.precision import attention as PA
from repro_torch.serving.paged_cache import (BlockAllocator, PagedKVCache,
                                             init_paged_cache, request_words)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    tenant: str = "default"
    seed: int = 0


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: List[int]
    arrival_time: float
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    prompt_len: int = 0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_slots: int = 4
    page_size: int = 8
    total_pages: int = 64          # incl. the reserved scratch page 0
    max_pages_per_request: int = 8  # block-table width n_max
    prefill_chunk: int = 8
    token_budget: int = 16         # decode + prefill tokens per iteration
    max_queue: int = 256


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: List[int]
    layer_words: np.ndarray        # (L, 2) uint32 values
    prefilled: int = 0             # prompt tokens absorbed so far
    length: int = 0                # tokens in the cache
    cur_token: int = -1            # next decode input (last picked token)
    generated: int = 0


@functools.lru_cache(maxsize=4096)
def _layer_words(seed: int, n_layers: int) -> np.ndarray:
    """Per-layer request words, (L, 2): a pure function of (seed,
    n_layers), cached so an admission costs no Threefry."""
    return PA.request_layer_words(np.asarray([request_words(seed)]),
                                  n_layers)[:, 0]


class ContinuousBatchingEngine:
    def __init__(self, model, params, engine_cfg: EngineConfig = None,
                 clock=time.perf_counter):
        cfg = model.cfg
        if set(cfg.plan()) != {"attn"}:
            raise ValueError("continuous batching supports pure attention "
                             f"decoder plans (got {sorted(set(cfg.plan()))})")
        self.model = model
        self.params = params
        self.cfg = engine_cfg or EngineConfig()
        self.clock = clock
        ec = self.cfg
        self.device = params["embed"].device
        self._n_layers = cfg.n_layers
        self._alloc = BlockAllocator(ec.total_pages)
        pool = init_paged_cache(cfg, ec.n_slots, ec.total_pages,
                                ec.page_size, ec.max_pages_per_request,
                                device=self.device)
        self._k_pages, self._v_pages = pool.k_pages, pool.v_pages
        self.hbm_bytes = (self._k_pages.numel() * self._k_pages.itemsize
                          + self._v_pages.numel() * self._v_pages.itemsize)
        self._slots: List[Optional[_Slot]] = [None] * ec.n_slots
        self._queues: Dict[str, collections.deque] = {}
        self._tenant_rr: List[str] = []
        self._rr = 0
        self._ticks = 0           # model calls issued (rng decorrelation)
        self.iterations = 0
        self.decode_steps = 0     # batched decode calls
        self.prefill_calls = 0    # prefill chunk calls
        self.single_token_chunks = 0   # prefill chunks of one token
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.results: Dict[int, RequestResult] = {}
        self._mirror = None       # (device tables, host words) of all slots

    # ------------------------------------------------------------- intake --
    def _pages_needed(self, req: Request) -> int:
        return math.ceil((len(req.prompt) + req.max_new_tokens)
                         / self.cfg.page_size)

    def submit(self, req: Request) -> None:
        if req.rid in self.results:
            raise ValueError(f"duplicate rid {req.rid}")
        if not len(req.prompt) or req.max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens>=1")
        if self._pages_needed(req) > self.cfg.max_pages_per_request:
            raise ValueError(
                f"request {req.rid} needs {self._pages_needed(req)} pages "
                f"> table width {self.cfg.max_pages_per_request}")
        if sum(len(q) for q in self._queues.values()) >= self.cfg.max_queue:
            raise ValueError("queue full")
        if req.tenant not in self._queues:
            self._queues[req.tenant] = collections.deque()
            self._tenant_rr.append(req.tenant)
        self._queues[req.tenant].append(req)
        self.results[req.rid] = RequestResult(
            rid=req.rid, tokens=[], arrival_time=self.clock(),
            prompt_len=len(req.prompt))

    def cancel(self, rid: int) -> bool:
        """Evict a request: drop it from its queue, or free its slot and
        pages mid-flight.  Returns True if it was still live."""
        for q in self._queues.values():
            for r in list(q):
                if r.rid == rid:
                    q.remove(r)
                    return True
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.req.rid == rid:
                self._release(i, finished=False)
                return True
        return False

    def _admit(self) -> None:
        n_t = len(self._tenant_rr)
        if not n_t:
            return
        scanned = 0
        while scanned < n_t:
            tenant = self._tenant_rr[self._rr % n_t]
            q = self._queues[tenant]
            if not q:
                self._rr += 1
                scanned += 1
                continue
            free_slots = [i for i, s in enumerate(self._slots) if s is None]
            if not free_slots:
                return
            req = q[0]
            pages = self._alloc.alloc(self._pages_needed(req))
            if pages is None:
                return              # head-of-line blocks: no starvation
            q.popleft()
            lw = _layer_words(req.seed, self._n_layers)
            self._slots[free_slots[0]] = _Slot(req=req, pages=pages,
                                               layer_words=lw)
            self._mirror = None
            self._rr += 1
            scanned = 0             # fresh round after a successful admit

    def _release(self, i: int, finished: bool) -> None:
        slot = self._slots[i]
        self._alloc.free(slot.pages)
        self._slots[i] = None
        self._mirror = None
        if finished:
            self.results[slot.req.rid].finish_time = self.clock()

    # ------------------------------------------------------- device plumbing
    def _host_state(self, idx: Sequence[int]):
        """(tables (B, n_max), words (L, B, 2)) of slots ``idx`` on the
        host; empty slots get scratch tables and zero words."""
        ec = self.cfg
        tables = np.zeros((len(idx), ec.max_pages_per_request), np.int32)
        words = np.zeros((self._n_layers, len(idx), 2), np.int64)
        for j, i in enumerate(idx):
            slot = self._slots[i]
            if slot is not None:
                tables[j, :len(slot.pages)] = slot.pages
                words[:, j] = slot.layer_words
        return tables, words

    def _tick_rng(self):
        """The per-call key.  Only uniqueness per call matters (under the
        determinism contract no rounded site uses it: every site is keyed
        by the request words)."""
        t = self._ticks
        self._ticks += 1
        return ((t >> 32) & M32, t & M32)

    def _run_model(self, idx, tables_dev, words, append, tokens,
                   compute_logits):
        lengths = np.array([self._slots[i].length if self._slots[i] else 0
                            for i in idx], np.int32)
        cache = PagedKVCache(k_pages=self._k_pages, v_pages=self._v_pages,
                             tables=tables_dev, lengths=lengths, words=words,
                             append=append)
        logits, _ = self.model.decode_step(
            self.params, {"attn": cache},
            common.host_to_device(tokens, self.device), lengths,
            rng=self._tick_rng(), compute_logits=compute_logits)
        return logits

    def _pick(self, logits: torch.Tensor,
              rows: Sequence[Optional[int]]) -> np.ndarray:
        """The next token of every row: the greedy argmax of its last
        logits, taken on the device and copied to the host.  ``rows``
        names each row's slot (None: an empty row whose pick is
        dropped)."""
        return torch.argmax(logits[:, -1], dim=-1).cpu().numpy()

    # --------------------------------------------------------------- step --
    def _prefill_chunks(self, budget: int) -> int:
        """Run whole prefill chunks round-robin until the budget is spent.
        At least one chunk runs when any prefill is pending, so a chunk
        larger than the leftover budget cannot livelock."""
        spent = 0
        progressed = True
        while progressed:
            progressed = False
            for i, slot in enumerate(self._slots):
                if slot is None or slot.prefilled >= len(slot.req.prompt):
                    continue
                chunk = min(self.cfg.prefill_chunk,
                            len(slot.req.prompt) - slot.prefilled)
                if spent and spent + chunk > budget:
                    continue
                lo, hi = slot.prefilled, slot.prefilled + chunk
                last = hi == len(slot.req.prompt)
                toks = np.asarray(slot.req.prompt[lo:hi], np.int64)[None]
                tables, words = self._host_state([i])
                logits = self._run_model(
                    [i], common.host_to_device(tables, self.device), words,
                    np.ones((1,), bool), toks, compute_logits=last)
                self.prefill_calls += 1
                self.single_token_chunks += chunk == 1
                slot.prefilled = hi
                slot.length += chunk
                spent += chunk
                self.prefill_tokens += chunk
                progressed = True
                if last:
                    self._emit(i, int(self._pick(logits, [i])[0]))
        return spent

    def _emit(self, i: int, tok: int) -> None:
        slot = self._slots[i]
        res = self.results[slot.req.rid]
        if res.first_token_time is None:
            res.first_token_time = self.clock()
        res.tokens.append(tok)
        slot.generated += 1
        slot.cur_token = tok
        if slot.generated >= slot.req.max_new_tokens:
            self._release(i, finished=True)

    def _decode_batch(self) -> None:
        idx = list(range(self.cfg.n_slots))
        active = np.array([s is not None and s.cur_token >= 0
                           for s in self._slots], bool)
        if not active.any():
            return
        tokens = np.array([[s.cur_token if s is not None and s.cur_token >= 0
                            else 0] for s in self._slots], np.int64)
        # the tables and words change only on admit and release
        if self._mirror is None:
            tables, words = self._host_state(idx)
            self._mirror = (common.host_to_device(tables, self.device),
                            words)
        logits = self._run_model(idx, *self._mirror, active, tokens,
                                 compute_logits=True)
        self.decode_steps += 1
        nxt = self._pick(logits, [i if active[i] else None for i in idx])
        for i in idx:
            if active[i]:
                self._slots[i].length += 1
                self.decode_tokens += 1
                self._emit(i, int(nxt[i]))

    @torch.inference_mode()
    def step(self) -> List[int]:
        """One engine iteration: admit, batched decode, prefill chunks.
        Returns the rids finished in this iteration."""
        before = {rid for rid, r in self.results.items()
                  if r.finish_time is not None}
        self._admit()
        n_active = sum(1 for s in self._slots
                       if s is not None and s.cur_token >= 0)
        self._decode_batch()
        self._prefill_chunks(max(0, self.cfg.token_budget - n_active))
        self.iterations += 1
        return [rid for rid, r in self.results.items()
                if r.finish_time is not None and rid not in before]

    @property
    def busy(self) -> bool:
        return any(s is not None for s in self._slots) or \
            any(self._queues[t] for t in self._queues)

    def run(self, requests: Sequence[Request], arrivals=None,
            max_iterations: int = 100_000) -> Dict[int, RequestResult]:
        """Drive to completion.  ``arrivals`` gives each request's arrival
        iteration (default: all at 0), the knob that moves the batching
        schedule."""
        if arrivals is None:
            arrivals = [0] * len(requests)
        order = sorted(range(len(requests)), key=lambda i: arrivals[i])
        cursor = 0
        for it in range(max_iterations):
            while cursor < len(order) and arrivals[order[cursor]] <= it:
                self.submit(requests[order[cursor]])
                cursor += 1
            self.step()
            if cursor == len(order) and not self.busy:
                return self.results
        raise RuntimeError(f"engine did not drain in {max_iterations} "
                           "iterations")

    # ---------------------------------------------------------------- stats
    @property
    def free_pages(self) -> int:
        return self._alloc.free_pages

    def utilization(self) -> Dict[str, float]:
        used = self._alloc.total_pages - 1 - self._alloc.free_pages
        n_used = sum(s is not None for s in self._slots)
        return {"pages_used": used,
                "page_util": used / (self._alloc.total_pages - 1),
                "slots_used": n_used,
                "slot_util": n_used / self.cfg.n_slots,
                "hbm_bytes": self.hbm_bytes}
