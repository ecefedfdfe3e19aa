"""Continuous batching: a slot-based decode engine for LM serving (port
of skypilot_tpu/models/batching.py).

A fixed pool of `num_slots` decode slots shares one paged KV pool, or,
on the dense path, holds one dense cache row each. Requests are
admitted into free slots (prefix-cache lookup + page allocation, host
only), their prompt suffix prefills in
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
KV page chains: `export_chain` / `import_chain` move a prompt's
full-page chain between engines in the reference's wire format
(inference/kv_transfer.py), `evacuate_chains` hands every session's
committed chain back to its HTTP thread for live migration, and with
`kv_spill_bytes` / `kv_cold_dir` evicted prefix-cache pages spill to
host RAM (and a local directory) and restore on a later hit. All of it
runs on the scheduler thread between rounds (`run_on_scheduler`), on
the stream the rounds run on, so a gather follows the KV writes of
every round dispatched before it.

Observability, as the reference's: each engine has its catalog bundle
(`EngineMetrics`, label engine=<id>, unique in the process), counters
and histograms tick at their event sites on the scheduler thread and
`update_metric_gauges()` refreshes the snapshot gauges from host state
at scrape time; a flight recorder (`flight`) keeps the last scheduler
events; a request submitted with a trace context gets the spans
engine.queue_wait, engine.admit, engine.prefill_chunk,
engine.decode_round and engine.device_get. The fault points
engine.prefill_chunk, engine.decode_step and engine.device_get fire on
the host, before a chunk's dispatch, before a round's graph replay and
at the token fetch (never inside a graph capture).

Errors are contained in two tiers, as the reference's: an error raised
while the pool is intact is a soft error (logged, counted, recorded;
every slot goes on serving), and a third in a row or one raised while
the pool may be half-written resets the engine. On the card a pool
cannot be checked for that (it is never donated, and a CUDA fault is
sticky for the whole context), so the engine marks the interval from a
round's or a chunk's dispatch to its commit (`_pool_at_risk`): an
exception inside it counts as a lost pool. A reset zeroes the pool in
place (its storage stays, so the captured graphs replay on it).

The dense slot path (the reference's, `paged=False`): a config whose
pool cannot hold one `max_total_len` sequence plus the write lookahead,
or that declares no pool at all (DeepSeek's latent cache), runs from the
model's dense cache (`model.dense_cache(num_slots)`: [num_slots,
max_seq_len, ...] a layer, allocated once). A slot's prefill chunks run
on its row view; the first zeroes the row and attends chunk-locally,
later ones the row's whole history. Decode rounds run every slot at its
own position (the captured round has no page table). No page allocator,
prefix cache, spill tier or KV chain on this path: prefix caching turns
itself off, the spill flags and `import_chain` raise as the reference's
do, and `attention_impl()` is 'dense'.

Tensor x pipeline serving (the reference's `mesh=`): a model split over
a grid of devices (`parallel/serving.py` GridModel) is served as is. The
engine stays one scheduler, one page table and one prefix cache for
every device; its pool is the grid's (`GridCache`: each shard's kv
heads, each stage's layers), and KV chains gather every head from the
shards on export and scatter them on import. With `stages` > 1 (the
Llama family, paged, bf16 weights, num_slots a multiple of stages, no
decode chunks, as the reference's) the pipelined loop becomes the
reference's decode ring: the slots split into `stages` groups, each
with its own round and graphs, and every iteration dispatches each
group's next round before committing the previous ones, so the S
rounds in flight occupy different stages. Successive prefill chunks
pipeline over the stages the same way, by dispatching before they are
fetched. The rounds replay CUDA graphs, one a distinct card of the
grid (models/decode_graph.py), on one card named several times and over
distinct cards alike.

The reference donated its cache to each jitted call; here the pool is
preallocated once (`PagedKVCache`) and updated in place.
"""
from __future__ import annotations

import collections
import itertools
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
                                       EngineDeadError, QueueSaturatedError,
                                       SessionMigratedError)
from skypilot_tpu_torch.inference import affinity, kv_transfer, quant
from skypilot_tpu_torch.models import decode_graph
from skypilot_tpu_torch.models import lora as lora_lib
from skypilot_tpu_torch.models.llama import (PagedKVCache, kv_dtype_of,
                                             kv_heads, wire_kv_heads)
from skypilot_tpu_torch.observability import catalog as _obs
from skypilot_tpu_torch.observability import flight as flight_lib
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.ops import paged_attention as paged_ops
from skypilot_tpu_torch.ops import paged_kernel
from skypilot_tpu_torch.parallel import pipeline_schedule
from skypilot_tpu_torch.robustness import faults

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

    def __init__(self, page_size: int,
                 spill: Optional[kv_transfer.HostSpillTier] = None,
                 fetch_pages: Optional[Callable] = None,
                 metrics: Optional[_obs.EngineMetrics] = None,
                 flight: Optional[flight_lib.FlightRecorder] = None
                 ) -> None:
        self.page_size = page_size
        # The owning engine's catalog bundle and flight recorder.
        self._metrics = metrics
        self._flight = flight
        self.by_key: Dict[bytes, int] = {}
        self.key_of: Dict[int, bytes] = {}
        self.refs: Dict[int, int] = {}
        # Resident-but-unreferenced pages, oldest first (evictable).
        self.lru: 'collections.OrderedDict[int, None]' = \
            collections.OrderedDict()
        self.hits = 0       # pages served from cache
        self.misses = 0     # full prompt pages that had to be computed
        self.evictions = 0  # cached pages returned under pool pressure
        # Tiered cache: evicted pages spill (their exact device bytes,
        # fetched by the engine's `fetch_pages(pages) -> {leaf path:
        # page-major tensor}`) and restore on a later chain-key hit.
        # None keeps the drop-on-evict behavior.
        self.spill = spill
        self._fetch_pages = fetch_pages
        self.spilled_pages = 0

    #: One key per FULL page; key_i commits to ALL tokens through page i
    #: (sha256 over int32 bytes, optionally salted): the keys the load
    #: balancer routes on (inference/affinity.py).
    chain_keys = staticmethod(affinity.chain_keys)

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
        if self._metrics is not None:
            self._metrics.prefix_hits.inc(n_hits)
            self._metrics.prefix_misses.inc(n_misses)

    def acquire_page(self, key: bytes, page: int) -> None:
        """Adopt and reference a page the engine just restored into the
        pool under `key` (insert then acquire, minus the LRU trip)."""
        if not self.insert(key, page):
            raise ValueError(f'key already cached: {key.hex()[:12]}')
        self.lru.pop(page, None)
        self.refs[page] = self.refs.get(page, 0) + 1

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
        can serve `need` pages (or nothing evictable is left). With a
        spill tier the victims' device bytes are fetched in ONE batched
        gather and spilled before their pages are released, so a later
        restore is bit-identical to the fresh compute."""
        deficit = need - allocator.free_pages
        if deficit <= 0:
            return
        victims = []
        while len(victims) < deficit and self.lru:
            page, _ = self.lru.popitem(last=False)
            key = self.key_of.pop(page)
            del self.by_key[key]
            victims.append((key, page))
        if not victims:
            return
        if self.spill is not None and self._fetch_pages is not None:
            try:
                blobs = self._fetch_pages([p for _, p in victims])
                per_page = kv_transfer.split_pages(blobs, len(victims))
                for (key, _page), blob in zip(victims, per_page):
                    self.spill.put(key, blob)
                    self.spilled_pages += 1
                    if self._metrics is not None:
                        self._metrics.kv_spill_pages.inc()
                if self._flight is not None:
                    self._flight.record('spill', pages=len(per_page))
            except Exception as e:  # pylint: disable=broad-except
                # Spilling is an optimization: a failed gather degrades
                # to drop-on-evict and never blocks the admission that
                # triggered the eviction.
                print(f'prefix cache: spill of {len(victims)} pages '
                      f'failed ({type(e).__name__}: {e}); dropping them '
                      f'instead', flush=True)
        for _, page in victims:
            allocator.release([page])
            self.evictions += 1
            if self._metrics is not None:
                self._metrics.prefix_evictions.inc()
        if self._flight is not None:
            self._flight.record('evict', pages=len(victims))


class ContinuousBatchingEngine:
    """Slot engine over a port model (`Llama`, `GPT`, `Mixtral` or
    `Deepseek`, which owns its weights; the pool is allocated on the
    model's device, [kv heads, pages, page size, head dim] a layer, or
    the dense cache on the dense path). `paged` None picks the paged
    pool when the config declares one that holds a `max_total_len`
    sequence plus the write lookahead, as the reference does."""

    #: Engine ids of this process: each engine's metric label.
    _instance_ids = itertools.count()

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
                 cuda_graphs: bool = True,
                 paged: Optional[bool] = None) -> None:
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
        # The paged pool must hold one full-depth sequence (page 0 is
        # trash); otherwise, and for a config with no pool, the dense
        # path serves with no such cap.
        cfg_page = getattr(cfg, 'kv_page_size', 0)
        cfg_pool = getattr(cfg, 'kv_total_pages', 0)
        pool_ok = (cfg_page > 0 and cfg_pool > 0 and
                   (cfg_pool - 1) * cfg_page >=
                   max_total_len + self._write_lookahead)
        if paged is None:
            paged = pool_ok
        elif paged and not pool_ok:
            raise ValueError(
                f'paged=True but kv_total_pages={cfg_pool} x '
                f'kv_page_size={cfg_page} cannot hold one '
                f'max_total_len={max_total_len} sequence '
                f'(+{self._write_lookahead} chunk-write headroom; '
                f'usable {(max(cfg_pool - 1, 0)) * cfg_page} tokens; '
                f'page 0 is reserved).')
        self.paged = bool(paged)
        # A grid model (parallel/serving.py): its devices, its stages,
        # and the ways its pool's kv heads split (1: whole on every
        # device, or one device).
        self.grid = getattr(model, 'grid', None)
        self.mesh_devices = self.grid.size if self.grid is not None else 1
        self.stages = self.grid.stages if self.grid is not None else 1
        self.kv_shard_ways = getattr(model, 'kv_shard_ways', 1)
        if self.stages > 1:
            # The reference engine's refusals (models/batching.py:491-514).
            if not self.paged:
                raise ValueError(
                    'stages > 1 requires the paged KV cache: the '
                    'per-stage pool split is a split of the page '
                    'pool (declare kv_page_size/kv_total_pages)')
            if decode_chunk > 1:
                raise ValueError(
                    'decode_chunk > 1 does not compose with stages '
                    '(use pipeline_decode, the staged engine overlaps '
                    'rounds across stages instead)')
            if num_slots % self.stages:
                raise ValueError(
                    f'num_slots={num_slots} must divide evenly '
                    f'into stages={self.stages} slot groups (the '
                    f'S-deep decode ring partitions slots per stage)')
            if getattr(model, 'weight_dtype', 'bf16') == 'int8':
                raise ValueError(
                    'int8 WEIGHTS do not compose with stages yet '
                    '(int8 KV pages do): serve quantized weights '
                    'tensor-only, or bf16 weights staged')
        self.kv_dtype = kv_dtype_of(cfg)
        if self.kv_dtype == 'int8' and not self.paged:
            raise ValueError(
                'kv_dtype=int8 requires the paged KV cache: the '
                'dense per-slot cache has no scale storage (size the '
                'kv page pool to hold max_total_len, or serve bf16)')
        self.prefix_caching = bool(prefix_caching) and self.paged
        if (kv_spill_bytes or kv_cold_dir) and not self.prefix_caching:
            raise ValueError(
                'kv_spill_bytes/kv_cold_dir need the paged engine '
                'with prefix caching enabled (the spill tier stores '
                'evicted prefix-cache pages)')
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
        self.page_size = cfg_page
        self.total_pages = cfg_pool
        # Dense rows carry no page table (a round's table is [B, 0]).
        self.pages_per_seq = (-(-(max_total_len + self._write_lookahead)
                                // self.page_size) if self.paged else 0)
        self.prefix_cache: Optional[PrefixCache] = None  # set per reset
        # Tiered prefix cache: it outlives engine resets (content-
        # addressed host bytes stay valid across a pool rebuild).
        self.spill_tier = kv_transfer.make_spill_tier(kv_spill_bytes,
                                                      kv_cold_dir)
        # The engine-level restore outcome (the tier counts its own
        # host lookups).
        self.kv_restored_pages = 0
        self.kv_restore_lookups = 0
        self.kv_restore_hits = 0
        self.sessions_evacuated = 0
        self.chains_evacuated = 0
        # Catalog instruments labeled by engine id: counters tick at the
        # event sites, gauges refresh in update_metric_gauges().
        self.engine_id = str(next(self._instance_ids))
        self.metrics = _obs.EngineMetrics(self.engine_id)
        self.metrics.num_slots.set(num_slots)
        self._weight_bytes: Optional[int] = None   # lazy (roofline)
        # Every scheduler decision lands in this bounded ring, served at
        # /debug/flight and written to a file on a reset or a death.
        self.flight = flight_lib.FlightRecorder(
            name=f'engine{self.engine_id}')
        if not self.paged:
            self.cache = model.dense_cache(num_slots)
        elif self.grid is not None:
            self.cache = model.paged_cache()
        else:
            self.cache = PagedKVCache(cfg, self.device)
        self._generator = torch.Generator(self.device).manual_seed(seed)
        self._reset_paging()
        # Single-token rounds (plain, pipelined, chunked) on static
        # buffers; captured into CUDA graphs on the card unless
        # `cuda_graphs` is False. The base variants are captured here,
        # so a capture that fails stops the engine before it serves;
        # LoRA variants once the adapter stack exists. A staged
        # pipelined engine has one round a slot group (the decode
        # ring), every other engine one round over all slots.
        self._groups = (self.stages if self.stages > 1 and
                        self.pipeline_decode else 1)
        self._rounds = [decode_graph.DecodeRound(
            model, self.cache, num_slots // self._groups,
            self.pages_per_seq, max_steps=self.decode_chunk,
            generator=self._generator, use_graphs=cuda_graphs,
            attend_len=max_total_len) for _ in range(self._groups)]
        self.cuda_graphs = self._rounds[0].use_graphs
        if self.cuda_graphs and not self.spec_k:
            with torch.no_grad():
                for rnd in self._rounds:
                    for selection in decode_graph.SELECTIONS:
                        rnd.capture(selection, None)
        # The pipelined loop's dispatched-but-uncommitted round of each
        # slot group (one group unless the engine is staged).
        self._group_inflight: List[Optional[Dict[str, object]]] = \
            [None] * self._groups

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
        self._prefill_t0 = [0.0] * num_slots
        # Per-slot tracing context (None = the request is not sampled).
        self._slot_ctx: List[Optional[tracing.Ctx]] = [None] * num_slots

        self.decode_calls = 0
        self.tokens_committed = 0
        self.preemptions = 0
        self.prefill_chunks_run = 0
        # The closed-form fill/drain bubble of the last prefill pass over
        # the stages: M chunks through S stages idle (S-1)/(M+S-1) of
        # the stage slots (0 with one stage).
        self.prefill_bubble_fraction = 0.0
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
        # Two-tier error containment: consecutive soft errors (the fuse
        # resets the engine at 3), and whether the pool may be
        # half-written (a round or a chunk is between its dispatch and
        # its commit).
        self._soft_errors = 0
        self._pool_at_risk = False
        self._dead = threading.Event()
        self._cancel_requests: set = set()
        self._cancel_lock = threading.Lock()
        self._queue: 'queue.Queue' = queue.Queue()
        # Control operations (chain export / import / evacuation) hop
        # onto the scheduler thread here: all pool reads and writes run
        # between rounds on the thread that owns the slots.
        self._control: 'queue.Queue' = queue.Queue()
        # FCFS admission order, owned by the scheduler thread; stalled
        # or preempted requests return to the HEAD.
        self._ready: 'collections.deque' = collections.deque()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name='engine-scheduler')
        self._thread.start()

    def _reset_paging(self) -> None:
        self.allocator = None
        if self.paged:
            self.allocator = paged_ops.PageAllocator(self.total_pages,
                                                     self.pages_per_seq)
            # Physical page 0 is the TRASH page: unallocated table
            # entries point at it, so junk writes (inactive slots, padded
            # prefill tails) never touch a live page.
            trash = self.allocator.allocate(1)
            assert trash == [0], trash
        self.page_table = np.zeros((self.num_slots, self.pages_per_seq),
                                   np.int32)
        self.owned_pages: List[List[int]] = [
            [] for _ in range(self.num_slots)]
        self.allocated_tokens = np.zeros((self.num_slots,), np.int32)
        # Spilled blobs live on in the tier: pageable host memory.
        self.prefix_cache = (PrefixCache(
            self.page_size, spill=self.spill_tier,
            fetch_pages=lambda pages: self._gather_page_blobs(
                pages, pinned=False),
            metrics=self.metrics, flight=self.flight)
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
               adapter: Optional[str] = None,
               trace_ctx: Optional[tracing.Ctx] = None) -> 'Future':
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
        in the store while the request holds a slot. `trace_ctx` (a
        sampled request's tracing context) makes the scheduler record
        the request's engine spans under it. Raises
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
        # `tref` = (ctx, enqueue perf_counter) for the queue-wait span,
        # None for an unsampled request (no clock read). item[0] is the
        # prompt, item[-2] the deadline, item[-1] the future: the rest
        # of the scheduler relies on those positions.
        tref = ((trace_ctx, time.perf_counter())
                if trace_ctx is not None else None)
        self._queue.put((list(prompt), int(max_new_tokens), float(temp),
                         int(top_k), float(top_p),
                         frozenset(stop_token_ids or ()), adapter,
                         tref, on_token, deadline, fut))
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
        """Device bytes of the KV cache: the paged pool (scales
        included), or the dense rows; on a grid, the pool's logical
        bytes (every kv head once, whole leaves once)."""
        return self.cache.num_bytes()

    def kv_cache_bytes_per_device(self) -> int:
        """Bytes of the KV cache resident on ONE device: a grid's
        largest shard (one kv-heads shard of the widest stage, whole
        leaves in full), the whole cache on one device — the figure
        --kv-pool-bytes budgets."""
        if self.grid is None:
            return self.cache.num_bytes()
        return self.cache.bytes_per_device()

    def stage_pool_stats(self) -> List[Dict[str, object]]:
        """Per-stage view of a staged pool for /stats: one allocator
        drives every stage, so each holds the same page indices, for its
        own [lo, hi) layers only. Empty when stages == 1."""
        if self.stages <= 1:
            return []
        return [{'stage': s, 'layers': [lo, hi], 'pages': self.total_pages,
                 'pool_bytes_per_device': max(
                     shard.num_bytes() for shard in self.cache.shards[s])}
                for s, (lo, hi) in enumerate(self.model.ranges)]

    def attention_impl(self) -> str:
        """The paged-attention implementation this engine's calls
        resolve to ('cuda' on the card, 'torch' on the CPU or under an
        `impl_scope('torch')`), or 'dense' on the dense path (no paged
        kernel in play): the attention_impl_info gauge and /stats.
        """
        if not self.paged:
            return 'dense'
        return paged_kernel.resolve_impl('auto', self.device)

    def attention_bytes_per_token(self) -> Dict[str, object]:
        """Modeled HBM bytes one decode step moves per generated token at
        the current decode batch (`paged_kernel.bytes_per_token_model`
        fed this engine's page geometry, dtypes and adapter store): the
        serving roofline's denominator. A dense engine walks
        `max_total_len` tokens of its row, `values_per_token` values a
        token a layer (2 x Hkv x D for K/V, d_c + d_rope for MLA's
        latents), with no scales. Host state only: the weight bytes are
        counted once from tensor metadata, the batch from the numpy
        `active`."""
        cfg = self.model.config
        if self._weight_bytes is None:
            # A staged engine streams one stage's weights a token: the
            # widest stage bounds the roofline.
            self._weight_bytes = (max(self.model.stage_weight_bytes())
                                  if self.stages > 1 else
                                  quant.weight_num_bytes(self.model))
        lora_bytes = 0
        store = self.adapter_store
        if store is not None:
            rank = int(getattr(store, '_rank', 0) or 0)
            targets = tuple(getattr(store, '_targets', ()) or ())
            if rank > 0 and targets:
                lora_bytes = lora_lib.adapter_num_bytes(cfg, rank, targets)
        quantized = self.paged and self.kv_dtype == 'int8'
        if self.paged:
            page_size, pages_per_seq = self.page_size, self.pages_per_seq
            kv_values = 2 * kv_heads(cfg) * cfg.head_dim
        else:
            page_size, pages_per_seq = 1, self.max_total_len
            kv_values = self.cache.values_per_token
        return paged_kernel.bytes_per_token_model(
            num_layers=-(-cfg.num_layers // self.stages),
            kv_values_per_token=kv_values,
            num_q_heads=cfg.num_heads,
            head_dim=getattr(cfg, 'head_dim', 0),
            page_size=page_size,
            pages_per_seq=pages_per_seq,
            kv_elem_bytes=1 if quantized else cfg.dtype.itemsize,
            quantized=quantized,
            impl=self.attention_impl(),
            weight_bytes=self._weight_bytes,
            batch=max(int(self.active.sum()), 1),
            lora_bytes_per_row=lora_bytes)

    def update_metric_gauges(self) -> None:
        """Refresh the snapshot gauges from live engine state (the
        /metrics and /stats handlers call it). Reads race the scheduler
        thread harmlessly: numpy and allocator counts, one round old at
        worst; nothing reads the device."""
        m = self.metrics
        m.queue_depth.set(self._queue.qsize() + len(self._ready))
        m.active_slots.set(int(self.active.sum()))
        m.num_slots.set(self.num_slots)
        m.prefill_backlog.set(self.prefill_backlog_tokens())
        m.kv_pool_bytes.set(self.kv_cache_bytes())
        m.kv_pool_bytes_per_device.set(self.kv_cache_bytes_per_device())
        if self.paged:
            free = int(self.allocator.free_pages)
            m.pages_free.set(free)
            m.pages_used.set(self.total_pages - free)
        if self.kv_restore_lookups:
            m.kv_restore_hit_ratio.set(self.kv_restore_hits /
                                       self.kv_restore_lookups)
        m.pipeline_stages.set(self.stages)
        m.prefill_bubble_fraction.set(self.prefill_bubble_fraction)
        m.set_attention_info(self.attention_impl(), self.kv_dtype)
        m.attention_bytes_per_token.set(
            self.attention_bytes_per_token()['total_bytes_per_token'])

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
            'graph_replays': sum(r.replays for r in self._rounds),
            'graph_captures': sum(r.graphs_captured()
                                  for r in self._rounds),
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
                              'evictions': pc.evictions,
                              'spilled_pages': pc.spilled_pages}
                             if pc is not None else None),
            'kv_restore_lookups': self.kv_restore_lookups,
            'kv_restore_hits': self.kv_restore_hits,
            'kv_restored_pages': self.kv_restored_pages,
            'sessions_evacuated': self.sessions_evacuated,
            'chains_evacuated': self.chains_evacuated,
        }

    # -- KV page chains -------------------------------------------------------
    def run_on_scheduler(self, fn, timeout: float = 120.0):
        """Run `fn()` on the scheduler thread between rounds and return
        its result (exceptions re-raise here): the one way other threads
        touch the pool. Calls made on the scheduler thread run inline."""
        if threading.current_thread() is self._thread:
            return fn()
        if self._dead.is_set():
            raise EngineDeadError(
                'engine scheduler thread is dead; restart the server')
        fut: Future = Future()
        self._control.put((fn, fut))
        return fut.result(timeout=timeout)

    def _run_control_ops(self) -> bool:
        """Drain pending control operations (the top of each iteration).
        An op's failure resolves only its caller's future: the pool is
        written in place, and a failed scatter wrote only pages it had
        allocated (and releases)."""
        ran = False
        while True:
            try:
                fn, fut = self._control.get_nowait()
            except queue.Empty:
                return ran
            ran = True
            try:
                fut.set_result(fn())
            except Exception as e:  # pylint: disable=broad-except
                fut.set_exception(e)

    def _cache_leaves(self) -> List:
        """(path, (one page's row shape, dtype)) of every cache leaf, in
        the cache's gather order, under the reference's keystr paths
        (`['layer_{i}']['attn']['k_pages']`, GPT's `['h_{i}']...`, and
        k_scales / v_scales for int8), so chains cross frameworks. A
        grid's pool gives every kv head of a page (its shards' heads
        gathered), so chains cross grids too."""
        prefix = self.model.CACHE_PREFIX
        return [(f"['{prefix}{i}']['attn']['{name}']", (shape, dtype))
                for i, name, shape, dtype in self.cache.page_leaf_specs()]

    def _gather_page_blobs(self, pages: List[int], pinned: bool = True
                           ) -> Dict[str, torch.Tensor]:
        """Exact pool bytes of physical pages `pages`, as {leaf path:
        page-major CPU tensor}: the export side of handoff, spill and
        migration. int8 pools gather the int8 payload and the f32
        scales; nothing is dequantized. Every leaf's rows go to the
        host in ONE copy (pinned memory, which the caching allocator
        reuses, for a transient export; pageable for blobs the spill
        tier keeps). Scheduler thread only: the gathers queue on the
        rounds' stream behind every dispatched KV write."""
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        rows = self.cache.gather_pages(idx)
        flat = torch.cat([r.reshape(-1).view(torch.uint8) for r in rows])
        cuda = self.device.type == 'cuda'
        host = torch.empty(flat.shape, dtype=torch.uint8,
                           pin_memory=cuda and pinned)
        host.copy_(flat, non_blocking=cuda and pinned)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        out, off = {}, 0
        for (path, _), r in zip(self._cache_leaves(), rows):
            nbytes = r.numel() * r.element_size()
            out[path] = host[off:off + nbytes].view(r.dtype).view(r.shape)
            off += nbytes
        return out

    def _scatter_page_blobs(self, pages: List[int],
                            blobs: Dict[str, torch.Tensor]) -> None:
        """Write page-major host blobs into physical pages `pages`
        (import / restore), in place. The chain pads to a power of two
        (the reference's compile ladder); pad rows go to trash page 0.
        Scheduler thread only."""
        specs = self._cache_leaves()
        paths = sorted(path for path, _ in specs)
        if paths != sorted(blobs):
            raise ValueError(
                f'KV chain leaves do not match this engine\'s cache '
                f'layout (chain: {sorted(blobs)[:3]}..., cache: '
                f'{paths[:3]}...)')
        n = len(pages)
        m = 1
        while m < n:
            m *= 2
        idx = torch.zeros(m, dtype=torch.long)
        idx[:n] = torch.tensor(pages, dtype=torch.long)
        idx = idx.to(self.device)
        staged = []
        for path, (shape, dtype) in specs:
            arr = blobs[path]
            want = (n,) + tuple(shape)
            if tuple(arr.shape) != want or arr.dtype != dtype:
                raise ValueError(
                    f'KV chain leaf {path} is '
                    f'{kv_transfer.dtype_name(arr.dtype)}{tuple(arr.shape)}'
                    f', pool expects '
                    f'{kv_transfer.dtype_name(dtype)}{want}')
            rows = arr.to(self.device)
            if m != n:
                rows = torch.cat([rows, rows.new_zeros(
                    (m - n,) + tuple(rows.shape[1:]))])
            staged.append(rows)
        # Every leaf validated before the first write.
        self.cache.scatter_pages(idx, staged)

    def _chain_meta(self, keys: List[bytes], salt: bytes
                    ) -> Dict[str, object]:
        cfg = self.model.config
        return {'kind': 'kv_chain', 'kv_dtype': self.kv_dtype,
                'page_size': self.page_size,
                'num_kv_heads': wire_kv_heads(cfg),
                'head_dim': int(cfg.head_dim),
                'num_layers': int(cfg.num_layers),
                'keys': [k.hex() for k in keys], 'salt': salt.hex()}

    def _salt(self, adapter: Optional[str]) -> bytes:
        if adapter is None:
            return b''
        if self.adapter_store is None:
            raise AdapterNotFoundError(
                f'adapter {adapter!r} requested for export but this '
                f'engine has no adapter store')
        return self.adapter_store.cache_salt(adapter)

    def export_chain(self, tokens: List[int],
                     adapter: Optional[str] = None) -> Optional[bytes]:
        """The prompt's cached full-page KV chain (payload, scales,
        adapter-salted chain keys, geometry), packed for another
        replica: the longest cached prefix of its chain, or None when
        nothing is cached or prefix caching is off. Thread-safe; the
        chain is reference-pinned during the gather."""
        if not self.prefix_caching:
            return None
        toks = [int(t) for t in tokens]

        def op():
            cache = self.prefix_cache
            salt = self._salt(adapter)
            keys = PrefixCache.chain_keys(toks, self.page_size, salt=salt)
            if not keys:
                return None
            pages = cache.lookup_acquire(keys, record=False)
            try:
                if not pages:
                    return None
                blobs = self._gather_page_blobs(pages)
            finally:
                cache.release(pages)
            packed = kv_transfer.pack_pages(
                blobs, self._chain_meta(keys[:len(pages)], salt))
            self.flight.record('handoff_export', pages=len(pages),
                               bytes=len(packed))
            return packed

        return self.run_on_scheduler(op)

    def import_chain(self, data: bytes) -> Dict[str, int]:
        """Scatter a packed chain into this pool and register it in the
        prefix cache: the next submit of the same prompt (same adapter
        salt) admits against the imported pages. Pages already cached
        are skipped; pages that do not fit, after eviction and beside
        the pages decoding slots reserve for their next dispatch
        (`_growth_reserve`), are dropped in chain order and counted.
        Raises ValueError on a geometry or dtype mismatch. Thread-safe."""
        if not self.prefix_caching:
            raise ValueError('import_chain needs the paged engine with '
                             'prefix caching enabled')

        def op():
            meta, blobs = kv_transfer.unpack_pages(data)
            if meta.get('kind') != 'kv_chain':
                raise ValueError('not a KV chain payload')
            if meta.get('kv_dtype') != self.kv_dtype:
                raise ValueError(
                    f'kv_dtype mismatch: chain is '
                    f'{meta.get("kv_dtype")!r}, pool is {self.kv_dtype!r}')
            if int(meta.get('page_size', 0)) != self.page_size:
                raise ValueError(
                    f'page_size mismatch: chain is '
                    f'{meta.get("page_size")}, pool is {self.page_size}')
            cfg = self.model.config
            for field, want in (('num_kv_heads', wire_kv_heads(cfg)),
                                ('head_dim', cfg.head_dim),
                                ('num_layers', cfg.num_layers)):
                got = meta.get(field)
                if got is not None and int(got) and want and \
                        int(got) != want:
                    raise ValueError(f'{field} mismatch: chain is {got}, '
                                     f'pool is {want}')
            keys = [bytes.fromhex(k) for k in meta.get('keys', [])]
            if len(keys) != int(meta.get('n_pages', -1)):
                raise ValueError('chain key count != page count')
            cache = self.prefix_cache
            todo = [(i, key) for i, key in enumerate(keys)
                    if key not in cache.by_key]
            already = len(keys) - len(todo)
            reserve = self._growth_reserve()
            if todo:
                cache.evict_into(self.allocator, len(todo) + reserve)
            fit = todo[:max(self.allocator.free_pages - reserve, 0)]
            dropped = len(todo) - len(fit)
            if fit:
                pages = self.allocator.allocate(len(fit))
                rows = blobs
                if len(fit) < len(keys):
                    sel = torch.tensor([i for i, _ in fit], dtype=torch.long)
                    rows = {path: arr.index_select(0, sel)
                            for path, arr in blobs.items()}
                try:
                    self._scatter_page_blobs(pages, rows)
                except Exception:
                    self.allocator.release(pages)
                    raise
                for (_i, key), page in zip(fit, pages):
                    cache.insert(key, page)
            self.flight.record('kv_import', pages=len(keys),
                               imported=len(fit), already_cached=already,
                               dropped=dropped)
            return {'pages': len(keys), 'imported': len(fit),
                    'already_cached': already, 'dropped': dropped}

        return self.run_on_scheduler(op)

    def _evacuate_slot(self, slot: int, reason: str) -> Dict[str, object]:
        """Evacuate one occupied slot (scheduler thread): pack its
        committed-token KV chain, tear the slot down, and resolve its
        future with SessionMigratedError carrying what a peer needs to
        finish the session. The chain is gathered from the slot's live
        page table (prompt + generated), and `slot_keys` is rewritten
        to the full committed chain first, so the teardown promotes
        every exported page into the local prefix cache: a failed ship
        resumes on warm pages. Mid-prefill slots ship no payload and
        promote nothing (pages past the frontier are unwritten).

        Pipelined decode: a round may be in flight. Its token for this
        slot is dropped by `_commit_round` (the slot's future is no
        longer the one it was dispatched for), so it is neither emitted
        nor committed; its KV write lands at the first uncommitted
        position, past every page exported here, and the gather queues
        behind it on the same stream."""
        committed = [int(t) for t in self.outputs[slot]]
        adapter = self.slot_adapter_name[slot]
        was_prefilling = bool(self.prefilling[slot])
        payload = None
        n_chain = 0
        if self.prefix_cache is not None and not was_prefilling:
            salt = self._salt(adapter)
            keys = PrefixCache.chain_keys(committed, self.page_size,
                                          salt=salt)
            if keys:
                try:
                    phys = [int(p) for p in self.page_table[slot, :len(keys)]]
                    payload = kv_transfer.pack_pages(
                        self._gather_page_blobs(phys),
                        self._chain_meta(keys, salt))
                    n_chain = len(keys)
                except Exception:  # pylint: disable=broad-except
                    payload = None   # ship nothing; the peer re-prefills
                self.slot_keys[slot] = keys
        deadline = float(self.deadlines[slot])
        record = {
            'reason': reason,
            'tokens': committed,
            'prompt_len': int(self.prompt_len[slot]),
            'limit': int(self.limits[slot]),
            'temperature': float(self.temps[slot]),
            'top_k': int(self.top_ks[slot]),
            'top_p': float(self.top_ps[slot]),
            'stop_token_ids': sorted(self.stop_ids[slot]),
            'adapter': adapter,
            'deadline_s': (max(deadline - time.monotonic(), 0.5)
                           if deadline else 0.0),
            'payload': payload,
            'pages': n_chain,
        }
        fut = self.futures[slot]
        self.futures[slot] = None
        self.active[slot] = False
        self.on_tokens[slot] = None
        self.deadlines[slot] = 0.0
        self._slot_ctx[slot] = None
        self._release_adapter(slot)
        if was_prefilling:
            self.prefilling[slot] = False
            try:
                self._prefill_order.remove(slot)
            except ValueError:
                pass
        self._release_slot_pages(slot, promote=not was_prefilling)
        self.sessions_evacuated += 1
        if payload is not None:
            self.chains_evacuated += 1
        self.flight.record('evacuate', slot=slot, reason=reason,
                           pages=n_chain,
                           bytes=len(payload) if payload else 0)
        if fut is not None:
            fut.set_exception(SessionMigratedError(record))
        return record

    def _evacuate_queued(self, reason: str) -> int:
        """Fail every queued (not yet admitted) request with a
        payload-less SessionMigratedError, so its caller resubmits
        elsewhere at once. Scheduler thread only."""
        while True:
            try:
                self._ready.append(self._queue.get_nowait())
            except queue.Empty:
                break
        n = 0
        while self._ready:
            (prompt, max_new, temp, top_k, top_p, stops, adapter,
             _tref, _on_token, deadline, fut) = self._ready.popleft()
            self._queued_tokens_sub(len(prompt))
            fut.set_exception(SessionMigratedError({
                'reason': reason,
                'tokens': [int(t) for t in prompt],
                'prompt_len': len(prompt),
                'limit': min(len(prompt) + int(max_new),
                             self.max_total_len),
                'temperature': float(temp),
                'top_k': int(top_k),
                'top_p': float(top_p),
                'stop_token_ids': sorted(stops),
                'adapter': adapter,
                'deadline_s': (max(deadline - time.monotonic(), 0.5)
                               if deadline else 0.0),
                'payload': None,
                'pages': 0,
            }))
            n += 1
        return n

    def evacuate_chains(self, max_sessions: Optional[int] = None,
                        reason: str = 'drain') -> Dict[str, int]:
        """Evacuate sessions for live migration (drain, preemption
        notice or rebalance): each occupied slot's committed tokens and
        packed chain go back to its waiting HTTP thread as a
        SessionMigratedError record, and its pages stay promoted in the
        local prefix cache. `max_sessions=None` evacuates everything,
        the queue included; a bound (rebalance) takes the deepest
        chains first (the most recompute saved) and leaves the queue.
        Thread-safe. Returns {'evacuated', 'chains', 'queued'}."""

        def op():
            evacuated = chains = 0
            limit_n = (self.num_slots if max_sessions is None
                       else max(int(max_sessions), 0))
            order = sorted((s for s in range(self.num_slots)
                            if self.active[s] or self.prefilling[s]),
                           key=lambda s: -len(self.outputs[s]))
            for slot in order[:limit_n]:
                rec = self._evacuate_slot(slot, reason)
                evacuated += 1
                if rec['payload'] is not None:
                    chains += 1
            queued = (self._evacuate_queued(reason)
                      if max_sessions is None else 0)
            return {'evacuated': evacuated, 'chains': chains,
                    'queued': queued}

        return self.run_on_scheduler(op)

    def _restore_from_spill(self, keys: List[bytes], shared: List[int],
                            reserve: int) -> None:
        """Extend the resident chain prefix `shared` from the spill tier,
        in place: for each key past it (in chain order, to the first
        miss), allocate a page, scatter the spilled bytes back and
        acquire it like a resident hit. Only what can land is fetched:
        free pages plus the evictable LRU, less the pages decoding
        slots reserve for their next dispatch."""
        cache = self.prefix_cache
        budget = self.allocator.free_pages + len(cache.lru) - reserve
        found_blobs = []
        found_keys = []
        for key in keys[len(shared):]:
            if len(found_blobs) >= budget:
                break
            self.kv_restore_lookups += 1
            blob = self.spill_tier.get(key)
            if blob is None:
                break
            self.kv_restore_hits += 1
            found_blobs.append(blob)
            found_keys.append(key)
        if not found_blobs:
            return
        cache.evict_into(self.allocator, len(found_blobs) + reserve)
        n_fit = min(len(found_blobs), self.allocator.free_pages - reserve)
        if n_fit <= 0:
            return
        pages = self.allocator.allocate(n_fit)
        self._pool_at_risk = True    # the scatter writes the pool
        try:
            self._scatter_page_blobs(
                pages, kv_transfer.join_pages(found_blobs[:n_fit]))
        except Exception:
            self.allocator.release(pages)
            raise
        self._pool_at_risk = False
        for key, page in zip(found_keys[:n_fit], pages):
            cache.acquire_page(key, page)
        shared.extend(pages)
        self.kv_restored_pages += n_fit
        self.metrics.kv_restore_pages.inc(n_fit)
        self.flight.record('restore', pages=n_fit)

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
                        self._soft_errors = 0
                    except Exception as e:  # pylint: disable=broad-except
                        self._recover_from_error(e)
        finally:
            if not self._stop.is_set():
                self._dead.set()
                self.flight.record('death')
                self.flight.snapshot('death')
                died = EngineDeadError('engine scheduler thread died')
                for slot in range(self.num_slots):
                    fut = self.futures[slot]
                    self.futures[slot] = None
                    self.active[slot] = False
                    self.prefilling[slot] = False
                    if fut is not None and not fut.done():
                        fut.set_exception(died)
                self._fail_all_pending(died)
                while True:
                    try:
                        _fn, cfut = self._control.get_nowait()
                    except queue.Empty:
                        break
                    cfut.set_exception(died)

    def _iterate(self) -> None:
        """Control ops -> admit (host only) -> apply cancellations ->
        reap deadlines -> up to `prefill_budget` tokens of chunked
        prefill -> one decode round for the active slots."""
        progressed = self._run_control_ops()
        progressed = self._admit() or progressed
        self._apply_cancellations()
        self._reap_deadlines()
        prefilled = bool(self._prefill_order)
        if prefilled:
            self._prefill_work()
            progressed = True
        if self.active.any() or self._in_flight():
            t0 = time.perf_counter()
            committed = self.tokens_committed
            self._decode_step()
            dt = time.perf_counter() - t0
            self.metrics.decode_step_seconds.observe(dt)
            self.flight.record('round_commit',
                               tokens=self.tokens_committed - committed,
                               active=int(self.active.sum()))
            if tracing.enabled():
                self._trace_decode_round(dt)
            if not prefilled:
                # Rounds with no prefill chunk queued before them: the
                # inter-token time a decoding request sees (the round's
                # metrics, flight record and spans included).
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

    def _trace_decode_round(self, dur: float) -> None:
        """One 'engine.decode_round' span for each traced slot riding
        this round (a slot that finished inside it already cleared its
        context)."""
        batch = int(self.active.sum())
        for slot in range(self.num_slots):
            ctx = self._slot_ctx[slot]
            if ctx is None or not (self.active[slot] or
                                   self.prefilling[slot]):
                continue
            tracing.record_span('engine.decode_round', ctx, dur,
                                slot=slot, pos=int(self.pos[slot]),
                                batch=batch)

    def _cache_lost(self) -> bool:
        """True when the error came between a dispatch and its commit:
        the pool may be half-written (or the device context broken) and
        only a reset can continue. False means it was raised before any
        device work of the round or chunk (an injected fault, a host
        error): the state is consistent."""
        return self._pool_at_risk

    def _recover_from_error(self, e: Exception) -> None:
        """Two-tier error containment (the reference's).

        POOL INTACT: log, count, record a soft_error; every slot goes on
        serving and nothing is failed (a pipelined round in flight stays
        in `_group_inflight`, so the next iteration commits it). Three soft
        errors in a row escalate, so a deterministic host failure cannot
        spin the loop forever.

        POOL LOST (or the third strike): record the reset and write a
        flight snapshot, fail every in-flight and queued request with
        the error, reset the slots and zero the pool in place (its
        storage stays, so the captured graphs replay on it), count the
        restart and keep serving."""
        traceback.print_exc()
        self._soft_errors += 1
        victims = [s for s in range(self.num_slots)
                   if self.active[s] or self.prefilling[s]]
        self.flight.record('soft_error', error=type(e).__name__,
                           message=str(e)[:200],
                           strikes=self._soft_errors, slots=victims)
        if not self._cache_lost() and self._soft_errors < 3:
            print(f'engine {self.engine_id}: transient scheduler error '
                  f'({type(e).__name__}: {e}); state intact, continuing',
                  flush=True)
            return
        self.flight.record('reset', error=type(e).__name__,
                           strikes=self._soft_errors, slots=victims,
                           restarts=self.engine_restarts + 1)
        self.flight.snapshot('reset')
        self.engine_restarts += 1
        self.metrics.engine_restarts.inc()
        self._soft_errors = 0
        self._pool_at_risk = False
        self._group_inflight = [None] * self._groups
        for slot in range(self.num_slots):
            self._release_adapter(slot)
            fut = self.futures[slot]
            self.futures[slot] = None
            self.active[slot] = False
            self.prefilling[slot] = False
            self.on_tokens[slot] = None
            self._slot_ctx[slot] = None
            if fut is not None and not fut.done():
                fut.set_exception(e)
        self._prefill_order.clear()
        for arr in (self.prefill_frontier, self.prompt_len, self.pos,
                    self.cur_token, self.temps, self.top_ks,
                    self.deadlines):
            arr[:] = 0
        self.top_ps[:] = 1.0
        self._fail_all_pending(e)
        try:
            self.cache.zero_()
        except Exception:  # pylint: disable=broad-except
            traceback.print_exc()   # the device is truly gone
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
        self._slot_ctx[slot] = None
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
             tref, on_token, deadline, fut) = item
            t_adm = time.perf_counter() if tref is not None else 0.0
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
                shared = self.prefix_cache.lookup_acquire(keys,
                                                          record=False)
                # Tiered cache: spilled pages extend the resident prefix
                # before the hit / miss accounting (a restored page saved
                # the recompute exactly as a resident hit does).
                if self.spill_tier is not None and len(shared) < len(keys):
                    n_res0 = len(shared)
                    t_res = time.perf_counter()
                    self._restore_from_spill(keys, shared, reserve)
                    if tref is not None and len(shared) > n_res0:
                        tracing.record_span(
                            'engine.kv_restore', tref[0],
                            time.perf_counter() - t_res,
                            pages=len(shared) - n_res0)
                self.prefix_cache.record_lookup(len(shared),
                                                len(keys) - len(shared))
                # At least ONE token must prefill (the continuation
                # samples from its logits).
                if len(shared) * self.page_size >= plen:
                    self.prefix_cache.release([shared.pop()])
            n_cached = len(shared) * self.page_size
            if self.paged and not self._allocate_slot(slot, plen, shared,
                                                      keys, reserve, tref):
                # Pool exhausted: back to the HEAD, stop admitting.
                if aid:
                    self.adapter_store.release(aid)
                self._queued_tokens_add(len(prompt))
                self._ready.appendleft(item)
                break
            # Claim the slot before any device work.
            self.futures[slot] = fut
            self.outputs[slot] = list(prompt)
            self.prompt_len[slot] = plen
            self.prefill_frontier[slot] = n_cached
            self.pos[slot] = n_cached
            self.cur_token[slot] = 0
            limit = min(plen + max_new, self.max_total_len)
            if self.paged:
                # The pool bounds the deepest a sequence can get, less
                # the chunk-write lookahead.
                limit = min(limit, (self.total_pages - 1) * self.page_size
                            - self._write_lookahead)
            self.limits[slot] = limit
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
            self._prefill_t0[slot] = time.perf_counter()
            self._slot_ctx[slot] = tref[0] if tref is not None else None
            if tref is not None:
                tracing.record_span('engine.queue_wait', tref[0],
                                    t_adm - tref[1], slot=slot)
                tracing.record_span('engine.admit', tref[0],
                                    time.perf_counter() - t_adm,
                                    slot=slot, prompt_len=plen,
                                    cached_tokens=n_cached)
            self.flight.record('admit', slot=slot, prompt_len=plen,
                               cached_tokens=n_cached,
                               queued=len(self._ready))
            self.metrics.admissions.inc()
            admitted = True
        return admitted

    def _allocate_slot(self, slot: int, plen: int, shared: List[int],
                       keys: List[bytes], reserve: int, tref) -> bool:
        """Pages for an admission's prompt suffix (+1 for the first
        generated token; a padded tail past them hits the trash page)
        and the slot's page-table row. False (the shared prefix
        released) when the pool cannot serve them beside `reserve`."""
        need = self.allocator.pages_needed(plen + 1, self.page_size) \
            - len(shared)
        if self.prefix_cache is not None:
            self._evict_for(need + reserve, tref)
        if not self.allocator.can_allocate(need + reserve):
            if self.prefix_cache is not None:
                self.prefix_cache.release(shared)
            return False
        pages = self.allocator.allocate(need)
        self.owned_pages[slot] = pages
        self.shared_pages[slot] = shared
        self.slot_keys[slot] = keys
        self.page_table[slot, :] = 0
        self.page_table[slot, :len(shared)] = shared
        self.page_table[slot, len(shared):len(shared) + need] = pages
        self.allocated_tokens[slot] = (len(shared) + need) * self.page_size
        return True

    def _evict_for(self, need: int, tref) -> None:
        """Prefix-cache eviction for an admission, with an
        'engine.kv_spill' span when the admitting request is traced and
        the eviction ran (an untraced request reads no clock)."""
        cache = self.prefix_cache
        if tref is None:
            cache.evict_into(self.allocator, need)
            return
        ev0, sp0 = cache.evictions, cache.spilled_pages
        t0 = time.perf_counter()
        cache.evict_into(self.allocator, need)
        if cache.evictions > ev0:
            tracing.record_span(
                'engine.kv_spill', tref[0], time.perf_counter() - t0,
                evicted=cache.evictions - ev0,
                spilled=cache.spilled_pages - sp0)

    # -- chunked prefill ----------------------------------------------------
    def _chunk_shape(self, n: int, offset: int) -> int:
        """Padded length of an n-real-token chunk at `offset`: full
        chunks use the prefill_chunk shape, a partial one buckets to a
        power of two, capped so the padded tail stays inside the
        page-table row (an out-of-range logical page would clamp onto
        a real page holding the prompt tail)."""
        cap = self.prefill_chunk or self.max_total_len
        shape = min(_bucket(n, cap), cap)
        if offset and self.paged:
            shape = min(shape, self.pages_per_seq * self.page_size - offset)
            assert shape >= n
        return shape

    def _run_prefill_chunk(self, slot: int, offset: int,
                           n: int) -> torch.Tensor:
        """One prefill chunk: n real tokens of the slot's prompt at
        absolute position `offset`. Returns the f32 logits of the
        chunk's last real token. The first chunk (offset 0) attends its
        own K/V; later ones the row's paged history. On the dense path
        the chunk runs on the slot's row view, which the first chunk
        zeroes. The `engine.prefill_chunk` point fires before any device
        work."""
        faults.point('engine.prefill_chunk')
        shape = self._chunk_shape(n, offset)
        chunk = self.outputs[slot][offset:offset + n] + [0] * (shape - n)
        dev = self.device
        tokens = torch.tensor([chunk], dtype=torch.long, device=dev)
        positions = torch.arange(offset, offset + shape, dtype=torch.int32,
                                 device=dev)[None]
        self._pool_at_risk = True    # the chunk writes the pool from here
        if self.paged:
            cache = self.cache
            page_row = torch.from_numpy(
                self.page_table[slot:slot + 1]).to(dev)
        else:
            cache, page_row = self.cache.row(slot), None
            if offset == 0:
                cache.zero_()
        hidden = self.model.hidden(tokens, positions, cache, page_row,
                                   prefill=offset == 0,
                                   attend_len=self.max_total_len,
                                   **self._slot_lora_args(slot))
        last = self.model.logits(hidden[0, n - 1])
        self._pool_at_risk = False
        self.prefill_chunks_run += 1
        return last

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
        chunks0 = self.prefill_chunks_run
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
            self.flight.record('chunk_dispatch', slot=slot, offset=offset,
                               n=n)
            t0 = time.perf_counter()
            try:
                last = self._run_prefill_chunk(slot, offset, n)
            except Exception as e:  # pylint: disable=broad-except
                if self._cache_lost():
                    raise   # the pool may be half-written: reset
                # Raised before the chunk's dispatch (an injected
                # engine.prefill_chunk fault): fail just its request.
                print(f'engine {self.engine_id}: prefill chunk for slot '
                      f'{slot} failed ({type(e).__name__}: {e}); failing '
                      f'only that request', flush=True)
                self._fail_slot(slot, e)
                continue
            dt = time.perf_counter() - t0
            self.metrics.prefill_chunk_seconds.observe(dt)
            tracing.record_span('engine.prefill_chunk', self._slot_ctx[slot],
                                dt, slot=slot, offset=offset, n=n)
            spent += n
            offset += n
            self.prefill_frontier[slot] = offset
            self.pos[slot] = offset
            if offset >= plen:
                self._prefill_order.popleft()
                done.append((slot, self._sample_first(slot, last)))
        if budget:
            self.metrics.prefill_budget_utilization.set(spent / budget)
        chunks = self.prefill_chunks_run - chunks0
        if self.stages > 1 and chunks:
            # The fill/drain bubble of this pass's chunks as microbatches
            # over the stage chain, read from the schedule module as the
            # reference reads it.
            self.prefill_bubble_fraction = \
                pipeline_schedule.make_inference_schedule(
                    self.stages, chunks).bubble_fraction
        if not done:
            return
        # The one host fetch of the chunks' first tokens is where a
        # device fault in them surfaces.
        self._pool_at_risk = True
        firsts = torch.stack([first for _, first in done]).cpu().tolist()
        self._pool_at_risk = False
        for (slot, _), first in zip(done, firsts):
            self.cur_token[slot] = int(first)
            self.pos[slot] = int(self.prompt_len[slot])
            self.prefilling[slot] = False
            self.active[slot] = True
            self.metrics.prefill_seconds.observe(
                time.perf_counter() - self._prefill_t0[slot])

    # -- paging -------------------------------------------------------------
    def _grow_pages(self, lookahead=1) -> None:
        """Before a decode step: every active slot about to write past
        its allocated tokens gets another page (`lookahead` tokens past
        its position: an int, or one per slot). On pool exhaustion the
        slot is PREEMPTED: its pages are released and the request
        re-queued at the head with everything generated so far as its
        prompt (recomputed on re-admission; greedy output unchanged).
        Dense rows hold every position: nothing to do."""
        if not self.paged:
            return
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
            self.metrics.preemptions.inc()
            self.flight.record(
                'preempt', slot=slot,
                generated=len(self.outputs[slot]) -
                int(self.prompt_len[slot]))
            ctx = self._slot_ctx[slot]
            self._slot_ctx[slot] = None
            self._release_adapter(slot)
            self._release_slot_pages(slot, promote=False)
            if fut is not None:
                # The trace context rides the re-queued request: its
                # re-admission records a second queue-wait span.
                tref = ((ctx, time.perf_counter())
                        if ctx is not None else None)
                preempted.append((list(self.outputs[slot]),
                                  max(remaining, 1),
                                  float(self.temps[slot]),
                                  int(self.top_ks[slot]),
                                  float(self.top_ps[slot]),
                                  self.stop_ids[slot], adapter_name,
                                  tref, self.on_tokens[slot],
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
        from the other, round after round, with neither committing.
        None on the dense path."""
        if not self.paged:
            return 0
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
        contents are final), the rest go back to the allocator. Dense
        rows have none."""
        if not self.paged:
            return
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
        self._slot_ctx[slot] = None
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
        self.metrics.tokens_committed.inc()
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
        blocked: the serial host/device bubble pipelining hides. The
        `engine.device_get` point fires first (a delay there models a
        host/device stall)."""
        faults.point('engine.device_get')
        t0 = time.perf_counter()
        if isinstance(pending, decode_graph.Pending):
            out = pending.wait()
        else:
            out = pending.cpu().numpy()
        stall = time.perf_counter() - t0
        self.decode_stall_s += stall
        self.metrics.decode_stall_seconds.inc(stall)
        if tracing.enabled():
            # The stall is the whole round's: one span, on the first
            # traced active slot.
            for slot in range(self.num_slots):
                ctx = self._slot_ctx[slot]
                if ctx is not None and self.active[slot]:
                    tracing.record_span('engine.device_get', ctx, stall,
                                        stall_ms=round(stall * 1e3, 3))
                    break
        return out

    def _round_lora(self, ids: np.ndarray) -> Optional[dict]:
        """The stacked factors a round over lane adapter ids `ids` runs
        with; None (no LoRA code) while every lane is the base model."""
        if self.adapter_store is None or not ids.any():
            return None
        return self.adapter_store.model_lora()

    def _group_slice(self, g: int) -> slice:
        """The lanes of slot group `g` (all of them with one group)."""
        width = self.num_slots // self._groups
        return slice(g * width, (g + 1) * width)

    def _in_flight(self) -> bool:
        return any(f is not None for f in self._group_inflight)

    def _dispatch(self, cont: np.ndarray, steps: int = 1,
                  g: int = 0) -> decode_graph.Pending:
        """Stage slot group `g`'s host state and dispatch `steps`
        single-token steps on its round; `cont` lanes take the previous
        step's token at position +1 on the device instead of the host's.
        Inactive lanes decode as no-ops: their page-table rows are zero,
        so their writes land in the trash page; prefilling lanes write at
        their frontier, which the next chunk overwrites before
        attending."""
        sl = self._group_slice(g)
        lanes = self.active[sl]
        ids = np.where(lanes, self.slot_adapter[sl], 0)
        temps, top_ks, top_ps = self.temps[sl], self.top_ks[sl], \
            self.top_ps[sl]
        return self._rounds[g].dispatch(
            tok=self.cur_token[sl], pos=self.pos[sl], cont=cont, ids=ids,
            top_k=top_ks, temp=temps, top_p=top_ps,
            table=self.page_table[sl],
            selection=decode_graph.selection_for(
                temps[lanes], top_ks[lanes], top_ps[lanes]),
            lora=self._round_lora(ids), steps=steps)

    def _decode_step(self) -> None:
        """One decode round in the engine's mode. The
        `engine.decode_step` point fires before any dispatch and before
        the round draws from the generator: a raised fault leaves the
        state as it was (with a pipelined round still in flight), so the
        retried round gives the same tokens. From the dispatch to the
        commit the pool may be half-written (`_pool_at_risk`)."""
        faults.point('engine.decode_step')
        self._pool_at_risk = True
        self._decode_round()
        self._pool_at_risk = False

    def _decode_round(self) -> None:
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
        self.metrics.decode_steps.inc()
        for slot in range(self.num_slots):
            if self.active[slot]:
                self._commit_token(slot, int(sampled[slot]))

    # -- pipelined decode ---------------------------------------------------
    def _dispatch_round(self, inflight: Optional[Dict[str, object]],
                        g: int = 0) -> Optional[Dict[str, object]]:
        """Dispatch slot group `g`'s next round WITHOUT waiting for its
        in-flight one: continuing lanes feed the in-flight round's
        device-resident tokens back at position +1; lanes that joined
        since take their host-side first token. A lane the pending
        commit will retire gets a junk write one past its last position
        (write-before-read keeps it harmless)."""
        sl = self._group_slice(g)
        if not self.active[sl].any():
            return None
        cont = self._continuing(inflight, g)
        pos = (self.pos[sl].copy() if inflight is None else np.where(
            cont, inflight['pos'] + 1, self.pos[sl]).astype(np.int32))
        pending = self._dispatch(cont, g=g)
        self.decode_calls += 1
        self.metrics.decode_steps.inc()
        return {'pending': pending, 'mask': self.active[sl].copy(),
                'pos': pos, 'futs': list(self.futures[sl])}

    def _continuing(self, inflight: Optional[Dict[str, object]],
                    g: int = 0) -> np.ndarray:
        """Lanes of group `g` whose request rode the in-flight round and
        still holds the slot: they feed its tokens back on the device."""
        sl = self._group_slice(g)
        if inflight is None:
            return np.zeros(sl.stop - sl.start, bool)
        return np.array([bool(inflight['mask'][i]) and bool(self.active[s])
                         and self.futures[s] is inflight['futs'][i]
                         for i, s in enumerate(range(sl.start, sl.stop))])

    def _commit_round(self, inflight: Dict[str, object],
                      g: int = 0) -> None:
        """Fetch and commit group `g`'s dispatched round. Lanes whose
        request finished, was preempted or was replaced since dispatch
        are discarded (their token belongs to nobody)."""
        sampled = self._fetch_tokens(inflight['pending'])[0]
        base = self._group_slice(g).start
        for i in range(len(sampled)):
            slot = base + i
            if not inflight['mask'][i]:
                continue
            if not self.active[slot] or \
                    self.futures[slot] is not inflight['futs'][i]:
                continue
            self._commit_token(slot, int(sampled[i]))

    def _pipelined_decode_step(self) -> None:
        """Dispatch round N+1 first, then fetch and commit round N while
        N+1 runs: stop detection, streaming callbacks and future
        resolution overlap device work. A staged engine does it for each
        slot group in turn (the reference's S-deep decode ring,
        models/batching.py:3108-3125): every group's next round is
        dispatched before any is committed, so the S rounds in flight
        occupy different stages. Greedy outputs are token for token the
        unpipelined loop's; only the trailing round after a drain is
        wasted."""
        inflight = self._group_inflight
        # Continuing lanes write at pos+1 (their round N is uncommitted):
        # they grow one token further than lanes that joined since. (One
        # lookahead for all, as the reference grows, can preempt a lane
        # that rejoins at a page boundary before it commits anything,
        # again and again.)
        if self.active.any():
            self._grow_pages(lookahead=1 + np.concatenate(
                [self._continuing(inflight[g], g)
                 for g in range(self._groups)]))
        nxt = [self._dispatch_round(inflight[g], g)
               for g in range(self._groups)]
        for g in range(self._groups):
            if inflight[g] is not None:
                self._commit_round(inflight[g], g)
        self._group_inflight = nxt

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
        self.metrics.decode_steps.inc()
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
            torch.from_numpy(self.page_table).to(dev) if self.paged
            else None,
            attend_len=self.max_total_len, **self._lora_args())
        live = self.active
        y = self._select(self.model.logits(hidden), slice(None),
                         decode_graph.selection_for(
                             self.temps[live], self.top_ks[live],
                             self.top_ps[live]))
        y = self._fetch_tokens(y)                      # [slots, K+1]
        self.decode_calls += 1
        self.metrics.decode_steps.inc()
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
