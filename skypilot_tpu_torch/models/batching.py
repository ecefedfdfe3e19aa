"""Continuous batching: a slot-based decode engine for LM serving (port
of skypilot_tpu/models/batching.py).

A fixed pool of `num_slots` decode slots shares one paged KV pool.
Requests are admitted into free slots (prefix-cache lookup + page
allocation, host only), their prompt suffix prefills in
`prefill_chunk`-token chunks under a per-iteration token budget, and
they then ride the shared decode loop, leaving as they finish; new
requests join without waiting for the batch to drain. One scheduler
thread owns every device call and all slot state.

Ported: `PrefixCache`, `submit`/`cancel`, deadlines, bounded-queue
shedding, the scheduler thread and admission, chunked prefill, page
growth with preemption, trash page 0, multi-LoRA serving over an
`adapter_store` (inference/adapters.py), and the reference's decode
modes: the plain loop, the pipelined loop (on by default: round N+1 is
dispatched before round N is fetched and committed), `decode_chunk` (N
steps a dispatch) and `speculative_k` (prompt-lookup drafts verified in
one [slots, K+1] chunk). Single-token rounds run on the static buffers
of `models/decode_graph.py`, one CUDA-graph replay a step on the card
(`cuda_graphs=False` runs them eagerly); the verify chunk runs eagerly.
Not ported yet (the constructor raises when asked for them): meshes and
pipeline stages, spill/cold tiers and chain export/import/evacuation,
and the flight recorder and Prometheus metrics.

The reference donated its cache to each jitted call; here the pool is
preallocated once (`PagedKVCache`) and updated in place.
"""
from __future__ import annotations

import collections
import hashlib
import queue
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from skypilot_tpu_torch.errors import (AdapterNotFoundError,
                                       DeadlineExceededError,
                                       EngineDeadError, QueueSaturatedError)
from skypilot_tpu_torch.models import decode_graph
from skypilot_tpu_torch.models.llama import PagedKVCache
from skypilot_tpu_torch.ops import paged_attention as paged_ops

#: Prompt-lookup drafting for --speculative: the n-gram matched, and how
#: many trailing tokens the match is searched over (the reference
#: engine's defaults, skypilot_tpu/models/batching.py:300-301).
SPEC_NGRAM = 2
SPEC_LOOKBACK = 512


def _bucket(n: int, cap: int) -> int:
    """Next power of two >= n (min 8), bounded by cap."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


class PrefixCache:
    """Content-addressed KV page reuse across requests.

    Every FULL page of a prompt gets a chain key (hash of all tokens up
    to and including that page), so requests sharing a prompt prefix
    map their common full pages to the same physical pages: admission
    skips recomputing them and the pool holds one copy. Pages of
    finished prompts stay resident but unreferenced (LRU), evicted back
    to the allocator only under pool pressure. Shared pages are never
    written: later writes land past the cached region or in the trash
    page.
    """

    def __init__(self, page_size: int) -> None:
        self.page_size = page_size
        self.by_key: Dict[bytes, int] = {}
        self.key_of: Dict[int, bytes] = {}
        self.refs: Dict[int, int] = {}
        # Resident-but-unreferenced pages, oldest first (evictable).
        self.lru: 'collections.OrderedDict[int, None]' = \
            collections.OrderedDict()
        self.hits = 0       # pages served from cache
        self.misses = 0     # full prompt pages that had to be computed
        self.evictions = 0  # cached pages returned under pool pressure

    @staticmethod
    def chain_keys(tokens, page_size: int,
                   salt: bytes = b'') -> List[bytes]:
        """One key per FULL page; key_i commits to ALL tokens through
        page i (sha256 over int32 bytes, optionally salted). Byte for
        byte the keys of skypilot_tpu/inference/affinity.py, which the
        load balancer routes on."""
        keys = []
        h = hashlib.sha256()
        if salt:
            h.update(salt)
        for i in range(len(tokens) // page_size):
            chunk = tokens[i * page_size:(i + 1) * page_size]
            h.update(np.asarray(chunk, np.int32).tobytes())
            keys.append(h.digest())
        return keys

    def lookup_acquire(self, keys: List[bytes],
                       record: bool = True) -> List[int]:
        """Longest cached prefix of `keys`; takes a reference on each
        returned page (pinned against eviction)."""
        pages = []
        for key in keys:
            page = self.by_key.get(key)
            if page is None:
                break
            pages.append(page)
            self.refs[page] = self.refs.get(page, 0) + 1
            self.lru.pop(page, None)
        if record:
            self.record_lookup(len(pages), len(keys) - len(pages))
        return pages

    def record_lookup(self, n_hits: int, n_misses: int) -> None:
        self.hits += n_hits
        self.misses += n_misses

    def release(self, pages: List[int]) -> None:
        for page in pages:
            self.refs[page] -= 1
            if self.refs[page] == 0:
                del self.refs[page]
                self.lru[page] = None  # newest evictable

    def insert(self, key: bytes, page: int) -> bool:
        """Adopt ownership of `page` under `key`; False = key already
        cached (caller keeps the page and releases it normally)."""
        if key in self.by_key:
            return False
        self.by_key[key] = page
        self.key_of[page] = key
        self.lru[page] = None
        return True

    def evict_into(self, allocator, need: int) -> None:
        """Return unreferenced cached pages to the allocator until it
        can serve `need` pages (or nothing evictable is left)."""
        while allocator.free_pages < need and self.lru:
            page, _ = self.lru.popitem(last=False)
            del self.by_key[self.key_of.pop(page)]
            allocator.release([page])
            self.evictions += 1


class ContinuousBatchingEngine:
    """Slot engine over a port `Llama` (which owns its weights; the
    pool is allocated on the model's device)."""

    def __init__(self, model, *, num_slots: int = 8,
                 max_total_len: int = 256, temperature: float = 0.0,
                 eos_id: Optional[int] = None,
                 prefix_caching: bool = True,
                 prefill_chunk: int = 0,
                 prefill_budget: int = 0,
                 max_queue_requests: int = 0,
                 max_queue_tokens: int = 0,
                 seed: int = 0,
                 speculative_k: int = 0,
                 decode_chunk: int = 1,
                 pipeline_decode: Optional[bool] = None,
                 adapter_store=None,
                 kv_spill_bytes: int = 0,
                 kv_cold_dir: Optional[str] = None,
                 mesh=None,
                 cuda_graphs: bool = True) -> None:
        asked = [name for name, on in (
            ('kv_spill_bytes', kv_spill_bytes), ('kv_cold_dir', kv_cold_dir),
            ('mesh', mesh is not None)) if on]
        if asked:
            raise ValueError(f'not supported by the PyTorch engine yet: '
                             f'{", ".join(asked)}')
        cfg = model.config
        if max_total_len > cfg.max_seq_len:
            raise ValueError(f'max_total_len {max_total_len} > model '
                             f'max_seq_len {cfg.max_seq_len}')
        # Chunked decode: N single-token steps a dispatch, committed by
        # the host afterwards (truncated at limit/eos/stop); the steps
        # past a finishing request write junk that the next owner of
        # those positions overwrites before attending.
        if decode_chunk < 1:
            raise ValueError(f'decode_chunk must be >= 1, got '
                             f'{decode_chunk}')
        if decode_chunk > 1 and speculative_k:
            raise ValueError(
                'decode_chunk composes with the plain decode loop only; '
                'speculative verify chunks already commit multiple tokens '
                'per dispatch')
        if decode_chunk > 1 and max_total_len + decode_chunk > \
                cfg.max_seq_len:
            raise ValueError(
                f'decode_chunk={decode_chunk} writes up to that many '
                f'positions past a finishing request: max_total_len'
                f'({max_total_len}) + chunk must be <= max_seq_len'
                f'({cfg.max_seq_len})')
        if speculative_k < 0:
            raise ValueError(f'speculative_k must be >= 0, got '
                             f'{speculative_k}')
        if speculative_k and max_total_len + speculative_k > \
                cfg.max_seq_len:
            raise ValueError(
                f'speculative_k={speculative_k} needs headroom: '
                f'max_total_len({max_total_len}) + K must be <= '
                f'max_seq_len({cfg.max_seq_len})')
        if prefill_chunk < 0:
            raise ValueError(
                f'prefill_chunk must be >= 0, got {prefill_chunk}')
        if prefill_chunk and 0 < prefill_budget < prefill_chunk:
            raise ValueError(
                f'prefill_budget={prefill_budget} < prefill_chunk='
                f'{prefill_chunk}: the budget is spent in whole chunks')
        # One-step pipelining composes with the plain loop only: verify
        # and decode chunks are committed synchronously. None = on
        # exactly when the plain loop runs.
        if pipeline_decode and (speculative_k or decode_chunk > 1):
            raise ValueError(
                'pipeline_decode composes with the plain decode loop '
                'only; speculative_k and decode_chunk dispatch '
                'multi-token rounds that are committed synchronously '
                '(set pipeline_decode=None/False with those modes)')
        self.pipeline_decode = (not speculative_k and decode_chunk == 1
                                if pipeline_decode is None
                                else bool(pipeline_decode))
        self.spec_k = int(speculative_k)
        self.decode_chunk = int(decode_chunk)
        # Verify chunks write K tokens, and decode chunks N-1, past the
        # last committed one: the pool and each table row carry that.
        self._write_lookahead = max(self.spec_k, self.decode_chunk - 1)
        # The pool must hold one full-depth sequence; page 0 is trash.
        usable = (cfg.kv_total_pages - 1) * cfg.kv_page_size
        if usable < max_total_len + self._write_lookahead:
            raise ValueError(
                f'kv_total_pages={cfg.kv_total_pages} x kv_page_size='
                f'{cfg.kv_page_size} cannot hold one max_total_len='
                f'{max_total_len} sequence (+{self._write_lookahead} '
                f'chunk-write headroom; usable {usable} tokens; page 0 is '
                f'reserved)')
        self.model = model
        self.device = model.device
        # Multi-LoRA serving (inference/adapters.py): each slot may carry
        # an adapter id into the shared forward.
        self.adapter_store = adapter_store
        self.num_slots = num_slots
        self.max_total_len = max_total_len
        self.temperature = temperature
        self.eos_id = eos_id
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = ((prefill_budget or prefill_chunk)
                               if prefill_chunk else 0)
        self.kv_dtype = cfg.kv_dtype
        self.page_size = cfg.kv_page_size
        self.total_pages = cfg.kv_total_pages
        self.pages_per_seq = -(-(max_total_len + self._write_lookahead)
                               // self.page_size)
        self.prefix_caching = bool(prefix_caching)
        self.prefix_cache: Optional[PrefixCache] = None  # set per reset
        self.cache = PagedKVCache(cfg, self.device)
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._reset_paging()
        # Single-token rounds (plain, pipelined, chunked) on static
        # buffers; captured into CUDA graphs on the card unless
        # `cuda_graphs` is False. The base variants are captured here,
        # so a capture that fails stops the engine before it serves;
        # LoRA variants once the adapter stack exists.
        self._round = decode_graph.DecodeRound(
            model, self.cache, num_slots, self.pages_per_seq,
            max_steps=self.decode_chunk, generator=self._generator,
            use_graphs=cuda_graphs, attend_len=max_total_len)
        self.cuda_graphs = self._round.use_graphs
        if self.cuda_graphs and not self.spec_k:
            with torch.no_grad():
                for selection in decode_graph.SELECTIONS:
                    self._round.capture(selection, None)
        # The pipelined loop's dispatched-but-uncommitted round.
        self._inflight: Optional[Dict[str, object]] = None

        # Host-side slot bookkeeping. A slot is OCCUPIED when
        # `prefilling` (admitted, prompt suffix still being written) or
        # `active` (riding the shared decode loop).
        self.cur_token = np.zeros((num_slots,), np.int64)
        self.pos = np.zeros((num_slots,), np.int32)
        self.active = np.zeros((num_slots,), bool)
        self.prefilling = np.zeros((num_slots,), bool)
        # Next prompt position a slot's prefill writes; while a slot
        # prefills, `pos` rides this frontier, so the decode loop's junk
        # write for the lane lands where the next chunk writes first.
        self.prefill_frontier = np.zeros((num_slots,), np.int32)
        self.prompt_len = np.zeros((num_slots,), np.int32)
        self.outputs: List[List[int]] = [[] for _ in range(num_slots)]
        self.futures: List[Optional[Future]] = [None] * num_slots
        self.limits = np.zeros((num_slots,), np.int32)
        self.temps = np.zeros((num_slots,), np.float32)
        self.top_ks = np.zeros((num_slots,), np.int32)   # 0 = off
        self.top_ps = np.ones((num_slots,), np.float32)  # 1 = off
        self.stop_ids: List[frozenset] = [frozenset()] * num_slots
        self.on_tokens: List[Optional[Callable[[int], None]]] = \
            [None] * num_slots
        self.deadlines = np.zeros((num_slots,), np.float64)  # 0 = none
        # Per-slot adapter: device-store row id (0 = base model) and name.
        self.slot_adapter = np.zeros((num_slots,), np.int32)
        self.slot_adapter_name: List[Optional[str]] = [None] * num_slots
        self._prefill_order: 'collections.deque' = collections.deque()

        self.decode_calls = 0
        self.tokens_committed = 0
        self.preemptions = 0
        self.prefill_chunks_run = 0
        self.decode_stall_s = 0.0   # host blocked fetching tokens
        self.steady_decode_s = 0.0
        self.steady_decode_rounds = 0
        self.steady_decode_tokens = 0

        self.max_queue_requests = int(max_queue_requests)
        self.max_queue_tokens = int(max_queue_tokens)
        self._shed_lock = threading.Lock()
        self._queued_tokens_n = 0
        self.requests_shed = 0
        self.deadline_exceeded = 0
        self.engine_restarts = 0
        self._dead = threading.Event()
        self._cancel_requests: set = set()
        self._cancel_lock = threading.Lock()
        self._queue: 'queue.Queue' = queue.Queue()
        # FCFS admission order, owned by the scheduler thread; stalled
        # or preempted requests return to the HEAD.
        self._ready: 'collections.deque' = collections.deque()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='engine-scheduler')
        self._thread.start()

    def _reset_paging(self) -> None:
        self.allocator = paged_ops.PageAllocator(self.total_pages,
                                                 self.pages_per_seq)
        # Physical page 0 is the TRASH page: unallocated table entries
        # point at it, so junk writes (inactive slots, padded prefill
        # tails) never touch a live page.
        trash = self.allocator.allocate(1)
        assert trash == [0], trash
        self.page_table = np.zeros((self.num_slots, self.pages_per_seq),
                                   np.int32)
        self.owned_pages: List[List[int]] = [
            [] for _ in range(self.num_slots)]
        self.allocated_tokens = np.zeros((self.num_slots,), np.int32)
        self.prefix_cache = (PrefixCache(self.page_size)
                             if self.prefix_caching else None)
        self.shared_pages: List[List[int]] = [
            [] for _ in range(self.num_slots)]
        self.slot_keys: List[List[bytes]] = [
            [] for _ in range(self.num_slots)]

    # -- public API ---------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 64,
               temperature: Optional[float] = None,
               top_k: int = 0, top_p: float = 1.0,
               stop_token_ids: Optional[List[int]] = None,
               on_token: Optional[Callable[[int], None]] = None,
               deadline_s: Optional[float] = None,
               adapter: Optional[str] = None) -> 'Future':
        """Queue a request; the Future resolves to prompt ++ generated
        tokens. `temperature` overrides the engine default (0 =
        greedy); `top_k`/`top_p` filter sampling (0 / 1.0 = off);
        `stop_token_ids` end this request on any listed token (kept in
        the output). `deadline_s` bounds the request's whole life from
        now (DeadlineExceededError). `on_token` is called once per
        committed generated token, on the scheduler thread. `adapter`
        names a LoRA adapter of the engine's adapter store (None = the
        base model): its factors join the shared forward, its KV pages
        are keyed per adapter in the prefix cache, and it stays pinned
        in the store while the request holds a slot. Raises
        AdapterNotFoundError for an unknown adapter,
        QueueSaturatedError when the bounded queue is full and
        EngineDeadError when the scheduler thread died."""
        if self._dead.is_set():
            raise EngineDeadError(
                'engine scheduler thread is dead; restart the server')
        if len(prompt) >= self.max_total_len:
            raise ValueError(f'prompt len {len(prompt)} >= max_total_len '
                             f'{self.max_total_len}')
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f'top_p must be in (0, 1], got {top_p}')
        if top_k < 0:
            raise ValueError(f'top_k must be >= 0, got {top_k}')
        if adapter is not None:
            if self.adapter_store is None:
                raise AdapterNotFoundError(
                    f'adapter {adapter!r} requested but this engine '
                    f'has no adapter store (serve_lm --adapter-dir)')
            # Inventory check only (404 fast); the load happens at
            # admission on the scheduler thread.
            self.adapter_store.resolve(adapter)
        with self._shed_lock:
            if self.max_queue_requests and \
                    self._queue.qsize() + len(self._ready) >= \
                    self.max_queue_requests:
                self.requests_shed += 1
                raise QueueSaturatedError(
                    f'queue full ({self.max_queue_requests} requests '
                    f'waiting); retry later')
            if self.max_queue_tokens and \
                    self._queued_tokens_n + len(prompt) > \
                    self.max_queue_tokens:
                self.requests_shed += 1
                raise QueueSaturatedError(
                    f'queued prompt tokens would exceed '
                    f'{self.max_queue_tokens}; retry later')
            self._queued_tokens_n += len(prompt)
        temp = self.temperature if temperature is None else temperature
        deadline = (time.monotonic() + float(deadline_s)
                    if deadline_s is not None else 0.0)
        fut: Future = Future()
        # item[0] is the prompt, item[-2] the deadline, item[-1] the
        # future: the rest of the scheduler relies on those positions.
        self._queue.put((list(prompt), int(max_new_tokens), float(temp),
                         int(top_k), float(top_p),
                         frozenset(stop_token_ids or ()), adapter,
                         on_token, deadline, fut))
        return fut

    def cancel(self, futs) -> None:
        """Best-effort cancel (client hung up): an occupied slot
        finishes now with its output so far; a queued request resolves
        with its prompt. Applied between decode rounds."""
        with self._cancel_lock:
            self._cancel_requests.update(futs)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def healthy(self) -> bool:
        return not self._dead.is_set() and self._thread.is_alive()

    def queued_requests(self) -> int:
        return self._queue.qsize() + len(self._ready)

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens admitted but not yet prefilled (racy numpy
        reads from other threads, as in the reference)."""
        return int(((self.prompt_len - self.prefill_frontier)
                    * self.prefilling).sum())

    def queued_tokens(self) -> int:
        with self._shed_lock:
            return self._queued_tokens_n

    def saturated(self) -> bool:
        """Admission control would shed a request right now."""
        if self.max_queue_requests and \
                self.queued_requests() >= self.max_queue_requests:
            return True
        return bool(self.max_queue_tokens and
                    self.queued_tokens() >= self.max_queue_tokens)

    def kv_cache_bytes(self) -> int:
        return self.cache.num_bytes()

    def stats(self) -> Dict[str, object]:
        """Racy snapshot of the counters (read from other threads)."""
        pc = self.prefix_cache
        return {
            'num_slots': self.num_slots,
            'active_slots': int(self.active.sum()),
            'prefilling_slots': int(self.prefilling.sum()),
            'queued_requests': self.queued_requests(),
            'decode_calls': self.decode_calls,
            'tokens_committed': self.tokens_committed,
            'speculative_k': self.spec_k,
            'decode_chunk': self.decode_chunk,
            'pipeline_decode': self.pipeline_decode,
            'cuda_graphs': self.cuda_graphs,
            'graph_replays': self._round.replays,
            'graph_captures': self._round.graphs_captured(),
            'prefill_chunks': self.prefill_chunks_run,
            'preemptions': self.preemptions,
            'requests_shed': self.requests_shed,
            'deadline_exceeded': self.deadline_exceeded,
            'engine_restarts': self.engine_restarts,
            'decode_stall_s': self.decode_stall_s,
            'steady_decode_s': self.steady_decode_s,
            'steady_decode_rounds': self.steady_decode_rounds,
            'steady_decode_tokens': self.steady_decode_tokens,
            'prefix_cache': ({'hits': pc.hits, 'misses': pc.misses,
                              'evictions': pc.evictions}
                             if pc is not None else None),
        }

    # -- scheduler thread ---------------------------------------------------
    def _loop(self) -> None:
        """Run iterations until stopped. If the thread dies for any
        other reason it first flips the dead flag and fails every
        pending future, so clients never hang on it."""
        try:
            if self.device.type == 'cuda':
                torch.cuda.set_device(self.device)
            with torch.no_grad():
                while not self._stop.is_set():
                    try:
                        self._iterate()
                    except Exception as e:  # pylint: disable=broad-except
                        self._recover_from_error(e)
        finally:
            if not self._stop.is_set():
                self._dead.set()
                died = EngineDeadError('engine scheduler thread died')
                for slot in range(self.num_slots):
                    fut = self.futures[slot]
                    self.futures[slot] = None
                    self.active[slot] = False
                    self.prefilling[slot] = False
                    if fut is not None and not fut.done():
                        fut.set_exception(died)
                self._fail_all_pending(died)

    def _iterate(self) -> None:
        """Admit (host only) -> apply cancellations -> reap deadlines ->
        up to `prefill_budget` tokens of chunked prefill -> one decode
        round for the active slots."""
        progressed = self._admit()
        self._apply_cancellations()
        self._reap_deadlines()
        prefilled = bool(self._prefill_order)
        if prefilled:
            self._prefill_work()
            progressed = True
        if self.active.any() or self._inflight is not None:
            t0 = time.perf_counter()
            committed = self.tokens_committed
            self._decode_step()
            if not prefilled:
                # Rounds with no prefill chunk queued before them: the
                # inter-token time a decoding request sees.
                self.steady_decode_s += time.perf_counter() - t0
                self.steady_decode_rounds += 1
                self.steady_decode_tokens += \
                    self.tokens_committed - committed
            progressed = True
        if not progressed and self._queue.empty() and not self._ready:
            # Idle: block briefly for the next request, straight into
            # _ready (a get + put-back would break FCFS order).
            try:
                self._ready.append(self._queue.get(timeout=0.05))
            except queue.Empty:
                pass

    def _recover_from_error(self, e: Exception) -> None:
        """A failed device call may have left the pool half-written:
        fail every in-flight and queued request loudly, reset the slots
        and the pool, keep serving."""
        traceback.print_exc()
        self.engine_restarts += 1
        self._inflight = None
        for slot in range(self.num_slots):
            self._release_adapter(slot)
            fut = self.futures[slot]
            self.futures[slot] = None
            self.active[slot] = False
            self.prefilling[slot] = False
            self.on_tokens[slot] = None
            if fut is not None and not fut.done():
                fut.set_exception(e)
        self._prefill_order.clear()
        for arr in (self.prefill_frontier, self.prompt_len, self.pos,
                    self.cur_token, self.temps, self.top_ks,
                    self.deadlines):
            arr[:] = 0
        self.top_ps[:] = 1.0
        self._fail_all_pending(e)
        self.cache.zero_()
        self._reset_paging()

    def _fail_all_pending(self, e: Exception) -> None:
        while self._ready:
            item = self._ready.popleft()
            self._queued_tokens_sub(len(item[0]))
            item[-1].set_exception(e)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            self._queued_tokens_sub(len(item[0]))
            item[-1].set_exception(e)

    def _queued_tokens_sub(self, n: int) -> None:
        with self._shed_lock:
            self._queued_tokens_n -= n

    def _queued_tokens_add(self, n: int) -> None:
        with self._shed_lock:
            self._queued_tokens_n += n

    def _apply_cancellations(self) -> None:
        with self._cancel_lock:
            if not self._cancel_requests:
                return
            cancels = self._cancel_requests
            self._cancel_requests = set()
        for slot in range(self.num_slots):
            if (self.active[slot] or self.prefilling[slot]) and \
                    self.futures[slot] in cancels:
                self._finish_slot(slot)
        while True:
            try:
                self._ready.append(self._queue.get_nowait())
            except queue.Empty:
                break
        keep: 'collections.deque' = collections.deque()
        while self._ready:
            item = self._ready.popleft()
            if item[-1] in cancels:
                self._queued_tokens_sub(len(item[0]))
                item[-1].set_result(list(item[0]))  # prompt only
            else:
                keep.append(item)
        self._ready = keep

    def _fail_slot(self, slot: int, e: Exception) -> None:
        """Fail ONE slot's request; every other slot keeps running.
        Mid-prefill pages are never promoted (half-written)."""
        fut = self.futures[slot]
        self.futures[slot] = None
        self.active[slot] = False
        self.on_tokens[slot] = None
        self.deadlines[slot] = 0.0
        self._release_adapter(slot)
        if self.prefilling[slot]:
            self.prefilling[slot] = False
            try:
                self._prefill_order.remove(slot)
            except ValueError:
                pass
        self._release_slot_pages(slot, promote=False)
        if fut is not None:
            fut.set_exception(e)

    def _reap_deadlines(self) -> None:
        now = time.monotonic()
        for slot in range(self.num_slots):
            dl = float(self.deadlines[slot])
            if dl and now > dl and (self.active[slot] or
                                    self.prefilling[slot]):
                self.deadline_exceeded += 1
                n_gen = len(self.outputs[slot]) - int(self.prompt_len[slot])
                self._fail_slot(slot, DeadlineExceededError(
                    f'request deadline exceeded after {n_gen} generated '
                    f'tokens'))
        if not self._ready:
            return
        keep: 'collections.deque' = collections.deque()
        while self._ready:
            item = self._ready.popleft()
            deadline = item[-2]
            if deadline and now > deadline:
                self.deadline_exceeded += 1
                self._queued_tokens_sub(len(item[0]))
                item[-1].set_exception(DeadlineExceededError(
                    'request deadline exceeded while queued'))
            else:
                keep.append(item)
        self._ready = keep

    def _occupied(self) -> np.ndarray:
        return self.active | self.prefilling

    def _admit(self) -> bool:
        """Drain ready requests into free slots: prefix-cache lookup,
        page allocation and slot bookkeeping only, no device work."""
        admitted = False
        while True:
            try:
                self._ready.append(self._queue.get_nowait())
            except queue.Empty:
                break
        reserve = self._growth_reserve()
        while self._ready and not self._occupied().all():
            item = self._ready.popleft()
            (prompt, max_new, temp, top_k, top_p, stops, adapter,
             on_token, deadline, fut) = item
            self._queued_tokens_sub(len(prompt))
            if deadline and time.monotonic() > deadline:
                self.deadline_exceeded += 1
                fut.set_exception(DeadlineExceededError(
                    'request deadline exceeded while queued'))
                continue
            if max_new <= 0:
                fut.set_result(list(prompt))
                continue
            slot = int(np.argmin(self._occupied()))  # first free slot
            # Adapter before page work: the store pins it for the slot's
            # lifetime and the prefix-cache keys are salted with it.
            aid = 0
            salt = b''
            if adapter is not None:
                try:
                    aid = self.adapter_store.acquire(adapter)
                except Exception as e:  # pylint: disable=broad-except
                    # Missing or unloadable artifact: fail THIS request
                    # (404/503 at the HTTP layer); the engine keeps going.
                    fut.set_exception(e)
                    continue
                if aid is None:
                    # Every store slot is pinned by a running request:
                    # back to the HEAD until one frees.
                    self._queued_tokens_add(len(prompt))
                    self._ready.appendleft(item)
                    break
                salt = self.adapter_store.cache_salt(adapter)
            plen = len(prompt)
            shared: List[int] = []
            keys: List[bytes] = []
            if self.prefix_cache is not None:
                keys = PrefixCache.chain_keys(prompt, self.page_size,
                                              salt=salt)
                shared = self.prefix_cache.lookup_acquire(keys)
                # At least ONE token must prefill (the continuation
                # samples from its logits).
                if len(shared) * self.page_size >= plen:
                    self.prefix_cache.release([shared.pop()])
            n_cached = len(shared) * self.page_size
            # The real suffix needs pages (+1 for the first generated
            # token); a padded tail past them hits the trash page.
            need = self.allocator.pages_needed(plen + 1, self.page_size) \
                - len(shared)
            if self.prefix_cache is not None:
                self.prefix_cache.evict_into(self.allocator, need + reserve)
            if not self.allocator.can_allocate(need + reserve):
                # Pool exhausted: back to the HEAD, stop admitting.
                if self.prefix_cache is not None:
                    self.prefix_cache.release(shared)
                if aid:
                    self.adapter_store.release(aid)
                self._queued_tokens_add(len(prompt))
                self._ready.appendleft(item)
                break
            pages = self.allocator.allocate(need)
            self.owned_pages[slot] = pages
            self.shared_pages[slot] = shared
            self.slot_keys[slot] = keys
            self.page_table[slot, :] = 0
            self.page_table[slot, :len(shared)] = shared
            self.page_table[slot, len(shared):len(shared) + need] = pages
            self.allocated_tokens[slot] = (len(shared) + need) * \
                self.page_size
            # Claim the slot before any device work.
            self.futures[slot] = fut
            self.outputs[slot] = list(prompt)
            self.prompt_len[slot] = plen
            self.prefill_frontier[slot] = n_cached
            self.pos[slot] = n_cached
            self.cur_token[slot] = 0
            # The pool bounds the deepest a sequence can get, less the
            # chunk-write lookahead.
            self.limits[slot] = min(plen + max_new, self.max_total_len,
                                    (self.total_pages - 1) * self.page_size
                                    - self._write_lookahead)
            self.temps[slot] = temp
            self.top_ks[slot] = top_k
            self.top_ps[slot] = top_p
            self.stop_ids[slot] = stops
            self.on_tokens[slot] = on_token
            self.deadlines[slot] = deadline
            self.slot_adapter[slot] = aid
            self.slot_adapter_name[slot] = adapter if aid else None
            self.prefilling[slot] = True
            self._prefill_order.append(slot)
            admitted = True
        return admitted

    # -- chunked prefill ----------------------------------------------------
    def _chunk_shape(self, n: int, offset: int) -> int:
        """Padded length of an n-real-token chunk at `offset`: full
        chunks use the prefill_chunk shape, a partial one buckets to a
        power of two, capped so the padded tail stays inside the
        page-table row (an out-of-range logical page would clamp onto
        a real page holding the prompt tail)."""
        cap = self.prefill_chunk or self.max_total_len
        shape = min(_bucket(n, cap), cap)
        if offset:
            shape = min(shape, self.pages_per_seq * self.page_size - offset)
            assert shape >= n
        return shape

    def _run_prefill_chunk(self, slot: int, offset: int,
                           n: int) -> torch.Tensor:
        """One prefill chunk: n real tokens of the slot's prompt at
        absolute position `offset`. Returns the f32 logits of the
        chunk's last real token. The first chunk (offset 0) attends its
        own K/V; later ones the row's paged history."""
        shape = self._chunk_shape(n, offset)
        chunk = self.outputs[slot][offset:offset + n] + [0] * (shape - n)
        dev = self.device
        tokens = torch.tensor([chunk], dtype=torch.long, device=dev)
        positions = torch.arange(offset, offset + shape, dtype=torch.int32,
                                 device=dev)[None]
        page_row = torch.from_numpy(self.page_table[slot:slot + 1]).to(dev)
        hidden = self.model.hidden(tokens, positions, self.cache, page_row,
                                   prefill=offset == 0,
                                   attend_len=self.max_total_len,
                                   **self._slot_lora_args(slot))
        self.prefill_chunks_run += 1
        return self.model.logits(hidden[0, n - 1])

    def _sample_first(self, slot: int, last_logits: torch.Tensor
                      ) -> torch.Tensor:
        """The continuation token (a device scalar) from the final
        chunk's last-position logits."""
        return self._select(last_logits[None], slice(slot, slot + 1))[0]

    def _select(self, logits: torch.Tensor, lanes: slice,
                selection: Optional[str] = None) -> torch.Tensor:
        """Eager token selection over logits [n, ...] for the slots
        `lanes`; by default their host settings pick the selection."""
        dev = self.device
        temps, top_ks, top_ps = (self.temps[lanes], self.top_ks[lanes],
                                 self.top_ps[lanes])
        if selection is None:
            selection = decode_graph.selection_for(temps, top_ks, top_ps)
        return decode_graph.select_tokens(
            logits, selection, torch.from_numpy(temps).to(dev),
            torch.from_numpy(top_ks).to(dev),
            torch.from_numpy(top_ps).to(dev), self._generator)

    def _prefill_work(self) -> None:
        """At most `prefill_budget` suffix tokens of prefill, in
        prefill_chunk-sized calls, oldest admission first. Slots whose
        prompt completes take their first token (one host fetch for
        all of them) and join the decode loop."""
        budget = self.prefill_budget if self.prefill_chunk else None
        spent = 0
        done = []    # (slot, first-token device scalar)
        while self._prefill_order:
            slot = self._prefill_order[0]
            plen = int(self.prompt_len[slot])
            offset = int(self.prefill_frontier[slot])
            n = plen - offset
            if self.prefill_chunk:
                n = min(n, self.prefill_chunk)
            if budget is not None and spent + n > budget:
                break   # budget spent: decode steps run first
            try:
                last = self._run_prefill_chunk(slot, offset, n)
            except Exception as e:  # pylint: disable=broad-except
                # Only this slot's own pages (and the trash page) were
                # written: fail just its request.
                print(f'engine: prefill chunk for slot {slot} failed '
                      f'({type(e).__name__}: {e}); failing only that '
                      f'request', flush=True)
                self._fail_slot(slot, e)
                continue
            spent += n
            offset += n
            self.prefill_frontier[slot] = offset
            self.pos[slot] = offset
            if offset >= plen:
                self._prefill_order.popleft()
                done.append((slot, self._sample_first(slot, last)))
        if not done:
            return
        firsts = torch.stack([first for _, first in done]).cpu().tolist()
        for (slot, _), first in zip(done, firsts):
            self.cur_token[slot] = int(first)
            self.pos[slot] = int(self.prompt_len[slot])
            self.prefilling[slot] = False
            self.active[slot] = True

    # -- paging -------------------------------------------------------------
    def _grow_pages(self, lookahead=1) -> None:
        """Before a decode step: every active slot about to write past
        its allocated tokens gets another page (`lookahead` tokens past
        its position: an int, or one per slot). On pool exhaustion the
        slot is PREEMPTED: its pages are released and the request
        re-queued at the head with everything generated so far as its
        prompt (recomputed on re-admission; greedy output unchanged)."""
        preempted = []
        for slot in range(self.num_slots):
            if not self.active[slot]:
                continue
            ahead = int(lookahead[slot] if np.ndim(lookahead) else lookahead)
            need_tokens = min(int(self.pos[slot]) + ahead,
                              self.pages_per_seq * self.page_size)
            exhausted = False
            while int(self.allocated_tokens[slot]) < need_tokens:
                logical = int(self.allocated_tokens[slot]) // self.page_size
                if not self.allocator.can_allocate(1) and \
                        self.prefix_cache is not None:
                    self.prefix_cache.evict_into(self.allocator, 1)
                if not self.allocator.can_allocate(1):
                    exhausted = True
                    break
                page = self.allocator.allocate(1)[0]
                self.owned_pages[slot].append(page)
                self.page_table[slot, logical] = page
                self.allocated_tokens[slot] += self.page_size
            if not exhausted:
                continue
            # The request keeps its adapter name; the store ref drops
            # with the slot and is re-acquired (reloaded if evicted
            # meanwhile) at re-admission.
            fut = self.futures[slot]
            adapter_name = self.slot_adapter_name[slot]
            remaining = int(self.limits[slot]) - len(self.outputs[slot])
            self.futures[slot] = None
            self.active[slot] = False
            self.preemptions += 1
            self._release_adapter(slot)
            self._release_slot_pages(slot, promote=False)
            if fut is not None:
                preempted.append((list(self.outputs[slot]),
                                  max(remaining, 1),
                                  float(self.temps[slot]),
                                  int(self.top_ks[slot]),
                                  float(self.top_ps[slot]),
                                  self.stop_ids[slot], adapter_name,
                                  self.on_tokens[slot],
                                  float(self.deadlines[slot]), fut))
                self._queued_tokens_add(len(self.outputs[slot]))
        # Back to the HEAD in pass order.
        self._ready.extendleft(reversed(preempted))

    def _growth_reserve(self) -> int:
        """Pages the decoding slots need before their next dispatch can
        write (pos + 1, + the chunk-write lookahead, + 1 for a lane that
        continues a pipelined round). Admission leaves them free: a
        request it took them for would preempt a running slot, and a
        preempted request re-admitted straight away can take them back
        from the other, round after round, with neither committing."""
        ahead = self._write_lookahead + 1 + int(self.pipeline_decode)
        cap = self.pages_per_seq * self.page_size
        need = 0
        for slot in np.flatnonzero(self.active):
            tokens = min(int(self.pos[slot]) + ahead, cap)
            need += max(0, -(-tokens // self.page_size)
                        - int(self.allocated_tokens[slot]) // self.page_size)
        return need

    def _release_slot_pages(self, slot: int, promote: bool) -> None:
        """Return a slot's pages: shared refs drop, own PROMPT-full pages
        are promoted into the prefix cache when `promote` (their
        contents are final), the rest go back to the allocator."""
        cache = self.prefix_cache
        if cache is not None:
            own = self.owned_pages[slot]
            # Promote leaves before releasing the shared prefix refs, so
            # LRU eviction drops a chain leaf-first.
            if promote and own:
                keys = self.slot_keys[slot]
                n_shared = len(self.shared_pages[slot])
                for i, page in enumerate(reversed(own)):
                    logical = n_shared + len(own) - 1 - i
                    if logical < len(keys) and \
                            cache.insert(keys[logical], page):
                        continue  # cache owns it now
                    self.allocator.release([page])
            else:
                self.allocator.release(own)
            cache.release(self.shared_pages[slot])
            self.shared_pages[slot] = []
            self.slot_keys[slot] = []
        else:
            self.allocator.release(self.owned_pages[slot])
        self.owned_pages[slot] = []
        self.page_table[slot, :] = 0
        self.allocated_tokens[slot] = 0

    def _release_adapter(self, slot: int) -> None:
        """Unpin the slot's adapter (if any) and account its committed
        tokens. Idempotent: the slot's adapter id is cleared on the
        first call."""
        aid = int(self.slot_adapter[slot])
        if not aid:
            return
        self.slot_adapter[slot] = 0
        self.slot_adapter_name[slot] = None
        n_gen = max(len(self.outputs[slot]) - int(self.prompt_len[slot]), 0)
        self.adapter_store.release(aid, tokens=n_gen)

    def _lora_args(self) -> Dict[str, object]:
        """LoRA kwargs of a decode round: the stacked factors and one
        adapter id per lane, where free and prefilling lanes carry 0.
        {} while every decoding lane is the base model, so base-only
        rounds run no LoRA code at all."""
        ids = np.where(self.active, self.slot_adapter, 0).astype(np.int32)
        lora = self._round_lora(ids)
        if lora is None:
            return {}
        return {'lora': lora,
                'adapter_ids': torch.from_numpy(ids).to(self.device)}

    def _slot_lora_args(self, slot: int) -> Dict[str, object]:
        """LoRA kwargs of a batch-1 prefill chunk of `slot`."""
        aid = int(self.slot_adapter[slot])
        if not aid:
            return {}
        return {'lora': self.adapter_store.model_lora(),
                'adapter_ids': torch.tensor([aid], dtype=torch.int32,
                                            device=self.device)}

    # -- decode -------------------------------------------------------------
    def _emit(self, slot: int, tok: int) -> None:
        """Streaming callback; a broken consumer is dropped, never
        allowed to take down the scheduler loop."""
        cb = self.on_tokens[slot]
        if cb is None:
            return
        try:
            cb(tok)
        except Exception:  # pylint: disable=broad-except
            self.on_tokens[slot] = None

    def _finish_slot(self, slot: int) -> None:
        fut = self.futures[slot]
        self.futures[slot] = None
        self.active[slot] = False
        self.on_tokens[slot] = None
        self.deadlines[slot] = 0.0
        self._release_adapter(slot)
        was_prefilling = bool(self.prefilling[slot])
        if was_prefilling:
            # Cancelled mid-prefill: resolve with the prompt as-is.
            self.prefilling[slot] = False
            try:
                self._prefill_order.remove(slot)
            except ValueError:
                pass
        # A half-prefilled prompt's pages are never promoted.
        self._release_slot_pages(slot, promote=not was_prefilling)
        if fut is not None:
            fut.set_result(list(self.outputs[slot]))

    def _commit_token(self, slot: int, next_tok: int) -> bool:
        """Commit the slot's pending cur_token and install `next_tok`;
        finish the slot (returning True) on limit/eos/stop."""
        tok = int(self.cur_token[slot])
        self.outputs[slot].append(tok)
        self._emit(slot, tok)
        self.tokens_committed += 1
        self.pos[slot] += 1
        self.cur_token[slot] = int(next_tok)
        done = len(self.outputs[slot]) >= int(self.limits[slot])
        if self.eos_id is not None and tok == self.eos_id:
            done = True
        if tok in self.stop_ids[slot]:
            done = True
        if done:
            self._finish_slot(slot)
        return done

    def _fetch_tokens(self, pending) -> np.ndarray:
        """Wait for a dispatched round's tokens (a `decode_graph.Pending`,
        or a device tensor), accounting the wall time the host spends
        blocked: the serial host/device bubble pipelining hides."""
        t0 = time.perf_counter()
        if isinstance(pending, decode_graph.Pending):
            out = pending.wait()
        else:
            out = pending.cpu().numpy()
        self.decode_stall_s += time.perf_counter() - t0
        return out

    def _round_lora(self, ids: np.ndarray) -> Optional[dict]:
        """The stacked factors a round over lane adapter ids `ids` runs
        with; None (no LoRA code) while every lane is the base model."""
        if self.adapter_store is None or not ids.any():
            return None
        return self.adapter_store.model_lora()

    def _dispatch(self, cont: np.ndarray,
                  steps: int = 1) -> decode_graph.Pending:
        """Stage the slots' host state and dispatch `steps` single-token
        steps; `cont` lanes take the previous step's token at position
        +1 on the device instead of the host's. Inactive lanes decode as
        no-ops: their page-table rows are zero, so their writes land in
        the trash page; prefilling lanes write at their frontier, which
        the next chunk overwrites before attending."""
        ids = np.where(self.active, self.slot_adapter, 0)
        lanes = self.active
        return self._round.dispatch(
            tok=self.cur_token, pos=self.pos, cont=cont, ids=ids,
            top_k=self.top_ks, temp=self.temps, top_p=self.top_ps,
            table=self.page_table,
            selection=decode_graph.selection_for(
                self.temps[lanes], self.top_ks[lanes], self.top_ps[lanes]),
            lora=self._round_lora(ids), steps=steps)

    def _decode_step(self) -> None:
        if self.spec_k:
            self._spec_decode_step()
            return
        if self.decode_chunk > 1:
            self._chunk_decode_step()
            return
        if self.pipeline_decode:
            self._pipelined_decode_step()
            return
        self._grow_pages()
        if not self.active.any():
            return  # _grow_pages may have preempted the last slot
        pending = self._dispatch(np.zeros(self.num_slots, bool))
        sampled = self._fetch_tokens(pending)[0]   # the one host fetch
        self.decode_calls += 1
        for slot in range(self.num_slots):
            if self.active[slot]:
                self._commit_token(slot, int(sampled[slot]))

    # -- pipelined decode ---------------------------------------------------
    def _dispatch_round(self, inflight: Optional[Dict[str, object]]
                        ) -> Optional[Dict[str, object]]:
        """Dispatch the next round WITHOUT waiting for the in-flight one:
        continuing lanes feed the in-flight round's device-resident
        tokens back at position +1; lanes that joined since take their
        host-side first token. A lane the pending commit will retire
        gets a junk write one past its last position (write-before-read
        keeps it harmless)."""
        # Continuing lanes write at pos+1 (their round N is uncommitted):
        # they grow one token further than lanes that joined since. (One
        # lookahead for all, as the reference grows, can preempt a lane
        # that rejoins at a page boundary before it commits anything,
        # again and again.)
        self._grow_pages(lookahead=1 + self._continuing(inflight))
        if not self.active.any():
            return None
        cont = self._continuing(inflight)
        pos = (self.pos.copy() if inflight is None else np.where(
            cont, inflight['pos'] + 1, self.pos).astype(np.int32))
        pending = self._dispatch(cont)
        self.decode_calls += 1
        return {'pending': pending, 'mask': self.active.copy(),
                'pos': pos, 'futs': list(self.futures)}

    def _continuing(self, inflight: Optional[Dict[str, object]]
                    ) -> np.ndarray:
        """Lanes whose request rode the in-flight round and still holds
        the slot: they feed its tokens back on the device."""
        if inflight is None:
            return np.zeros(self.num_slots, bool)
        return np.array([bool(inflight['mask'][s]) and bool(self.active[s])
                         and self.futures[s] is inflight['futs'][s]
                         for s in range(self.num_slots)])

    def _commit_round(self, inflight: Dict[str, object]) -> None:
        """Fetch and commit a dispatched round. Lanes whose request
        finished, was preempted or was replaced since dispatch are
        discarded (their token belongs to nobody)."""
        sampled = self._fetch_tokens(inflight['pending'])[0]
        for slot in range(self.num_slots):
            if not inflight['mask'][slot]:
                continue
            if not self.active[slot] or \
                    self.futures[slot] is not inflight['futs'][slot]:
                continue
            self._commit_token(slot, int(sampled[slot]))

    def _pipelined_decode_step(self) -> None:
        """Dispatch round N+1 first, then fetch and commit round N while
        N+1 runs: stop detection, streaming callbacks and future
        resolution overlap device work. Greedy outputs are token for
        token the unpipelined loop's; only the trailing round after a
        drain is wasted."""
        inflight = self._inflight
        nxt = self._dispatch_round(inflight) if self.active.any() \
            else None
        if inflight is not None:
            self._commit_round(inflight)
        self._inflight = nxt

    # -- chunked and speculative decode -------------------------------------
    def _chunk_decode_step(self) -> None:
        """`decode_chunk` tokens for every active slot in one dispatch
        (N steps, one fetch); the host commits them, truncating each slot
        at its limit/eos/stop (a finished slot's remaining tokens are
        discarded)."""
        n = self.decode_chunk
        # The chunk writes positions pos..pos+n-1.
        self._grow_pages(lookahead=n)
        if not self.active.any():
            return
        was_active = self.active.copy()
        toks = self._fetch_tokens(
            self._dispatch(np.zeros(self.num_slots, bool), steps=n))
        self.decode_calls += 1
        for slot in range(self.num_slots):
            if not was_active[slot]:
                continue
            for i in range(n):
                if self._commit_token(slot, int(toks[i, slot])):
                    break   # finished: discard the chunk's tail

    def _draft(self) -> np.ndarray:
        """Prompt-lookup drafts [slots, K]: for each active slot, the K
        tokens that followed the most recent earlier occurrence of the
        trailing SPEC_NGRAM tokens (context = committed output ++ the
        pending token), searched over the trailing SPEC_LOOKBACK
        tokens; no match (or inactive) repeats the last token."""
        k, ngram = self.spec_k, SPEC_NGRAM
        drafts = np.zeros((self.num_slots, k), np.int32)
        for slot in range(self.num_slots):
            if not self.active[slot]:
                continue
            ctx = self.outputs[slot] + [int(self.cur_token[slot])]
            drafts[slot, :] = ctx[-1]
            if len(ctx) <= ngram:
                continue
            pattern = ctx[-ngram:]
            floor = max(0, len(ctx) - SPEC_LOOKBACK)
            # Most recent strictly-earlier occurrence of the pattern.
            for start in range(len(ctx) - ngram - 1, floor - 1, -1):
                if ctx[start:start + ngram] == pattern:
                    cont = ctx[start + ngram:start + ngram + k]
                    if cont:
                        drafts[slot, :len(cont)] = cont
                        drafts[slot, len(cont):] = cont[-1]
                    break
        return drafts

    def _spec_decode_step(self) -> None:
        """One speculative round: draft K tokens per slot, verify the
        [current ++ drafts] chunk in one eager model call at per-row
        positions pos..pos+K, commit the confirmed prefix (1..K+1 tokens
        a call). Rejected drafts leave stale entries above the new
        position; the next chunk overwrites them before attending."""
        k = self.spec_k
        drafts = self._draft()
        # The chunk writes positions pos..pos+K.
        self._grow_pages(lookahead=k + 1)
        if not self.active.any():
            return
        dev = self.device
        chunk = np.concatenate([self.cur_token[:, None], drafts], axis=1)
        positions = self.pos[:, None] + np.arange(k + 1, dtype=np.int32)
        hidden = self.model.hidden(
            torch.from_numpy(chunk).to(dev).long(),
            torch.from_numpy(positions).to(dev), self.cache,
            torch.from_numpy(self.page_table).to(dev),
            attend_len=self.max_total_len, **self._lora_args())
        live = self.active
        y = self._select(self.model.logits(hidden), slice(None),
                         decode_graph.selection_for(
                             self.temps[live], self.top_ks[live],
                             self.top_ps[live]))
        y = self._fetch_tokens(y)                      # [slots, K+1]
        self.decode_calls += 1
        for slot in range(self.num_slots):
            if not self.active[slot]:
                continue
            accept = 0
            while accept < k and int(drafts[slot, accept]) == \
                    int(y[slot, accept]):
                accept += 1
            # Commit the pending token, then each accepted draft; each
            # commit's successor is the model's own token for that
            # position, so the last pending token is the first
            # correction.
            for nxt in y[slot, :accept + 1]:
                if self._commit_token(slot, int(nxt)):
                    break
