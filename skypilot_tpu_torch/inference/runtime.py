"""Serving runtime: the model, its engines and the request-path numbers
the HTTP front reports (port of skypilot_tpu/inference/runtime.py
`ServingMetrics`, `StreamHandle`, `iter_interleaved`,
`InferenceRuntime` and `build_runtime`, restricted to the flags this
port supports).

Two modes, as in the reference: with `--continuous-batching` every
request runs on the slot engine; without it (the one-shot engine) each
request runs alone through `models/generate.py`'s functions over a
dense per-request cache, in power-of-two length buckets, and streamed
or adapter requests run on a small slot engine built at their first
use (`stream_engine`, sharing the weights). Text endpoints take the
tokenizer of the `--hf` checkpoint (`get_tokenizer`).

Disaggregated serving and live migration: the runtime carries the
replica's `role` ('' unified, 'prefill' or 'decode'), the decode peers a
prefill replica hands prompts off to (pushed by the fleet through
POST /kv/peers or set by --decode-peers; picked through the load
balancer's consistent-hash ring), the evacuation hint a controller's
POST /kv/evacuate leaves, and the handoff and migration counts /stats
serves, also fed to the catalog's KV-chain series as the reference's.

Observability (the reference's): `ServingMetrics` keeps the rolling
windows /stats reports (linear-interpolated percentiles) and feeds the
process registry's request series and, under --slo, the SLO tracker;
`build_runtime` sets the weight-bytes and storage-info gauges,
configures head-sampled tracing (--trace-sample / --trace-seed) and
builds the `SloTracker`.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.errors import AdapterNotFoundError
from skypilot_tpu_torch.inference import affinity, kv_transfer, quant
from skypilot_tpu_torch.inference.adapters import AdapterRegistry
from skypilot_tpu_torch.models import convert, registry
from skypilot_tpu_torch.models import generate as gen
from skypilot_tpu_torch.models.batching import ContinuousBatchingEngine
from skypilot_tpu_torch.models.llama import (LlamaConfig, kv_dtype_of,
                                             kv_heads)
from skypilot_tpu_torch.models.gpt import GPTConfig
from skypilot_tpu_torch.observability import catalog as obs_catalog
from skypilot_tpu_torch.observability import slo as slo_lib
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.parallel import serving
from skypilot_tpu_torch.parallel.mesh import MeshConfig
from skypilot_tpu_torch.robustness import faults


class ServingMetrics:
    """Request metrics, thread-safe, exported twice (the reference's):

      - /stats percentiles over a ROLLING WINDOW of the last `window`
        (default 1024) requests, linear-interpolated;
      - the process registry's histograms and counters on GET /metrics
        (observability/catalog.py `RequestMetrics`), over the process
        lifetime.

    TTFT is the first COMMITTED token: streamed requests latch it at
    the first streamed token, non-streamed engine requests at the first
    decode commit (catalog.FirstTokenLatch); one-shot requests record
    none. Inter-token gaps come from streamed rows, measured at engine
    commit time. With --slo, `slo` is the SloTracker every record also
    feeds."""

    def __init__(self, window: int = 1024) -> None:
        self._lock = threading.Lock()
        self.window = window
        self.ttft_ms: 'collections.deque' = collections.deque(
            maxlen=window)
        self.itl_ms: 'collections.deque' = collections.deque(
            maxlen=window)
        self.latency_ms: 'collections.deque' = collections.deque(
            maxlen=window)
        self.completion_tokens: 'collections.deque' = collections.deque(
            maxlen=window)
        self.requests = 0
        self.requests_shed = 0
        self.deadline_exceeded = 0
        self.prom = obs_catalog.RequestMetrics()
        self.slo = None

    def record(self, latency_s: float, n_tokens: int,
               ttft_s: Optional[float] = None,
               n_prompt_tokens: int = 0) -> None:
        with self._lock:
            self.requests += 1
            self.latency_ms.append(latency_s * 1000.0)
            self.completion_tokens.append(n_tokens)
            if ttft_s is not None:
                self.ttft_ms.append(ttft_s * 1000.0)
        self.prom.requests.inc()
        self.prom.e2e_latency_seconds.observe(latency_s)
        self.prom.completion_tokens.inc(max(n_tokens, 0))
        self.prom.prompt_tokens.inc(max(n_prompt_tokens, 0))
        if ttft_s is not None:
            self.prom.ttft_seconds.observe(ttft_s)
        if self.slo is not None:
            self.slo.record_request(
                ttft_ms=(ttft_s * 1000.0 if ttft_s is not None
                         else None))

    def record_shed(self) -> None:
        """One request refused 429 by admission control."""
        with self._lock:
            self.requests_shed += 1
        self.prom.requests_shed.inc()
        if self.slo is not None:
            self.slo.record_request(shed=True)

    def record_deadline_exceeded(self) -> None:
        """One request answered 504 (expired queued or mid-decode)."""
        with self._lock:
            self.deadline_exceeded += 1
        self.prom.deadline_exceeded.inc()
        if self.slo is not None:
            self.slo.record_request(error=True)

    def record_inter_token(self, gap_s: float) -> None:
        """One gap between consecutive committed tokens of a streamed
        row, taken on the scheduler thread as the engine commits
        (`StreamHandle.on_token`), not at SSE delivery."""
        with self._lock:
            self.itl_ms.append(gap_s * 1000.0)
        self.prom.inter_token_seconds.observe(gap_s)
        if self.slo is not None:
            self.slo.record_itl(gap_s * 1000.0)

    @staticmethod
    def _pct(values: List[float], q: float) -> Optional[float]:
        """Linear-interpolated percentile (numpy's default method),
        rounded to 0.01."""
        if not values:
            return None
        s = sorted(values)
        pos = q * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return round(s[lo] * (1.0 - frac) + s[hi] * frac, 2)

    def snapshot(self) -> Dict[str, object]:
        """The /stats `serving` block, the reference's keys: the
        percentiles and `gen_tokens_per_sec` cover the last `window`
        requests, `requests` the process lifetime."""
        with self._lock:
            lat = list(self.latency_ms)
            ttft = list(self.ttft_ms)
            itl = list(self.itl_ms)
            toks = list(self.completion_tokens)
            n = self.requests
            shed = self.requests_shed
            expired = self.deadline_exceeded
        total_s = sum(lat) / 1000.0
        return {
            'requests': n,
            'requests_shed': shed,
            'deadline_exceeded': expired,
            'window': self.window,
            'ttft_ms_n': len(ttft),
            'itl_ms_n': len(itl),
            'latency_ms_n': len(lat),
            'ttft_ms_p50': self._pct(ttft, 0.50),
            'ttft_ms_p95': self._pct(ttft, 0.95),
            'ttft_ms_p99': self._pct(ttft, 0.99),
            'itl_ms_p50': self._pct(itl, 0.50),
            'itl_ms_p95': self._pct(itl, 0.95),
            'itl_ms_p99': self._pct(itl, 0.99),
            'latency_ms_p50': self._pct(lat, 0.50),
            'latency_ms_p95': self._pct(lat, 0.95),
            'completion_tokens_total': sum(toks),
            'gen_tokens_per_sec': round(sum(toks) / total_s, 2)
            if total_s > 0 else None,
        }


class StreamHandle:
    """Consumer side of one streamed row: committed tokens arrive on
    `q` from the engine's scheduler thread; `future` resolves to
    prompt ++ generated. Built before the submit, so the first
    committed token always finds the queue."""

    def __init__(self, metrics: Optional[ServingMetrics] = None) -> None:
        self.q: 'queue.Queue' = queue.Queue()
        self.future: Optional[Future] = None   # set right after submit
        self.t0 = time.monotonic()
        self.first_token_s: Optional[float] = None
        self._metrics = metrics
        self._last_token_t: Optional[float] = None

    def on_token(self, tok: int) -> None:
        now = time.monotonic()
        if self.first_token_s is None:
            self.first_token_s = now - self.t0
        elif self._metrics is not None:
            self._metrics.record_inter_token(now - self._last_token_t)
        self._last_token_t = now
        self.q.put(tok)


def iter_interleaved(handles: List[StreamHandle]):
    """Yield (row index, token) across streams in arrival order until
    every stream completes; re-raises a row's engine exception. Done
    detection checks the queue again after the future resolves, which
    closes the commit / resolve race."""
    done = [False] * len(handles)
    while not all(done):
        progressed = False
        for i, h in enumerate(handles):
            if done[i]:
                continue
            try:
                tok = h.q.get_nowait()
            except queue.Empty:
                if h.future.done() and h.q.empty():
                    h.future.result()   # raise to the caller on error
                    done[i] = True
                    progressed = True
                continue
            progressed = True
            yield i, int(tok)
        if not progressed:
            time.sleep(0.005)


def bucket_len(want: int, limit: int) -> int:
    """The one-shot bucket of a row of `want` tokens: the next power of
    two >= want (min 8), bounded by limit."""
    bucket = 8
    while bucket < want:
        bucket *= 2
    return min(bucket, limit)


class InferenceRuntime:
    """Everything needed to execute generation requests.

    `engine` is the continuous-batching engine when the server runs in
    that mode, else None (one-shot mode: pass `model`); then
    `stream_engine()` builds a small slot engine on first use, since
    streaming needs per-token commit callbacks and adapters per-slot
    LoRA, which only the slot engine has. `adapters` is the registry of
    --adapter-dir (None without it); `tokenizer_dir` the --hf checkpoint
    directory when it ships tokenizer files."""

    #: Slots of the one-shot mode's stream engine (the reference's).
    STREAM_SLOTS = 2

    def __init__(self, *, model_name: str,
                 engine: Optional[ContinuousBatchingEngine] = None,
                 model=None, max_total_len: Optional[int] = None,
                 speculative: int = 0, spec_total: Optional[int] = None,
                 engine_total: Optional[int] = None,
                 tokenizer_dir: Optional[str] = None,
                 prefill_chunk: int = 0,
                 prefill_budget: int = 0,
                 pipeline_decode: Optional[bool] = None,
                 max_queue_requests: int = 0, max_queue_tokens: int = 0,
                 request_timeout: float = 600.0, zone: str = '',
                 adapters: Optional[AdapterRegistry] = None,
                 cuda_graphs: bool = True, role: str = '',
                 decode_peers: Optional[List[str]] = None) -> None:
        if engine is None and model is None:
            raise ValueError('pass the continuous engine or, for the '
                             'one-shot mode, the model')
        # '' = a unified replica, 'decode' labels a decode-pool member,
        # 'prefill' also hands finished prompts' KV chains to a decode
        # peer instead of decoding them.
        if role not in ('', 'unified', 'prefill', 'decode'):
            raise ValueError(f'unknown serving role {role!r}')
        self.role = '' if role == 'unified' else role
        self._peers_lock = threading.Lock()
        self._decode_peers: List[str] = []
        self._peer_ring: Optional[affinity.PeerRing] = None
        self._handoff_lock = threading.Lock()
        self.handoffs_total = 0
        self.handoff_failures = 0
        self.handoff_bytes_total = 0
        self.handoff_seconds_total = 0.0
        self.kv_imports_total = 0
        self.kv_imported_pages_total = 0
        self._handoff_seconds = obs_catalog.histogram(
            'skypilot_serving_kv_handoff_seconds')
        self._handoff_bytes = obs_catalog.counter(
            'skypilot_serving_kv_handoff_bytes_total')
        self._migration_seconds = obs_catalog.histogram(
            'skypilot_serving_migration_seconds')
        self._chains_evacuated = obs_catalog.counter(
            'skypilot_serving_chains_evacuated_total')
        self._tokens_recomputed = obs_catalog.counter(
            'skypilot_serving_tokens_recomputed_total')
        # Live migration: out-migrations by trigger reason, evacuation
        # totals, and the bounded ring of affinity keys migrated IN
        # (/stats serves it, so the fleet pins those sessions' follow-ups
        # to this replica).
        self._migration_lock = threading.Lock()
        self.migrations_by_reason: Dict[str, int] = {}
        self.migration_failures = 0
        self.migration_seconds_total = 0.0
        self.sessions_evacuated_total = 0
        self.chains_evacuated_total = 0
        self.tokens_recomputed_total = 0
        self.migrations_in_total = 0
        self._migrated_in_keys: 'collections.OrderedDict[str, None]' = \
            collections.OrderedDict()
        # Set by POST /kv/evacuate (reason, controller's target), read by
        # the HTTP threads whose futures resolve with
        # SessionMigratedError moments later; it expires.
        self._evac_hint: Optional[Dict[str, object]] = None
        if decode_peers:
            self.set_decode_peers(decode_peers)
        self.engine = engine
        self.adapters = adapters
        self.model = engine.model if engine is not None else model
        cfg = self.model.config
        self.model_name = model_name
        self.vocab_size = cfg.vocab_size
        self.kv_dtype = kv_dtype_of(cfg)
        # /stats `storage`: the reference's keys; the devices a grid
        # model spans and its stages (tensor ways = mesh_devices /
        # stages).
        self.weight_dtype = getattr(self.model, 'weight_dtype', 'bf16')
        self.weight_bytes = quant.weight_num_bytes(self.model)
        grid = getattr(self.model, 'grid', None)
        self.mesh_devices = grid.size if grid is not None else 1
        self.stages = grid.stages if grid is not None else 1
        # Built by build_runtime under --slo (also wired into metrics).
        self.slo_tracker: Optional[slo_lib.SloTracker] = None
        self.max_total_len = (max_total_len if max_total_len is not None
                              else engine.max_total_len)
        self.speculative = int(speculative)
        self.spec_total = (spec_total if spec_total is not None
                           else self.max_total_len)
        # What engine.submit accepts (the speculative / decode-chunk
        # clamps): streaming validates against it.
        if engine_total is None:
            engine_total = (engine.max_total_len if engine is not None
                            else self.spec_total if self.speculative
                            else self.max_total_len)
        self.engine_total = engine_total
        self.tokenizer_dir = tokenizer_dir
        self.request_timeout = float(request_timeout)
        self.zone = zone
        self.metrics = ServingMetrics()
        self._fns: Dict[Tuple, object] = {}
        self._lock = threading.Lock()
        # One-shot calls run one at a time (each holds its own dense
        # cache); the lazy stream engine is built under the same lock,
        # so its CUDA-graph capture never overlaps a one-shot call.
        self._one_shot_lock = threading.Lock()
        self._generator = torch.Generator(self.model.device).manual_seed(0)
        self._tok_holder: Dict[str, object] = {}
        self._tok_lock = threading.Lock()
        self._stream_engine: Optional[ContinuousBatchingEngine] = None
        self._prefill_chunk = prefill_chunk
        self._prefill_budget = prefill_budget
        self._pipeline_decode = pipeline_decode
        self._max_queue_requests = max_queue_requests
        self._max_queue_tokens = max_queue_tokens
        self._cuda_graphs = cuda_graphs

    # -- capacity -----------------------------------------------------------
    def limit_for(self, temperature: float = 0.0,
                  streaming: bool = False) -> int:
        """Max total length (prompt + generated) the request class runs
        at: the slot engine's for engine-backed and streamed requests,
        else the one-shot bucket's (the speculative clamp for greedy)."""
        if self.engine is not None or streaming:
            return self.engine_total
        if self.speculative > 0 and temperature == 0.0:
            return self.spec_total
        return self.max_total_len

    # -- disaggregated prefill/decode ---------------------------------------
    def set_decode_peers(self, peers: List[str]) -> None:
        """Install the decode pool this replica hands off (and migrates)
        to ('host:port' strings), over the load balancer's ring."""
        peers = list(dict.fromkeys(str(p) for p in peers if p))
        ring = affinity.PeerRing(peers) if peers else None
        with self._peers_lock:
            self._decode_peers = peers
            self._peer_ring = ring

    def decode_peers(self) -> List[str]:
        with self._peers_lock:
            return list(self._decode_peers)

    def pick_decode_peer(self, key: Optional[str]) -> Optional[str]:
        """The ring's owner of an affinity key (the replica the load
        balancer would pick for the session), else the first peer."""
        with self._peers_lock:
            peers = list(self._decode_peers)
            ring = self._peer_ring
        if not peers:
            return None
        if key is not None and ring is not None:
            target = ring.affinity_target(key)
            if target is not None:
                return target
        return peers[0]

    def record_handoff(self, seconds: float, nbytes: int,
                       ok: bool) -> None:
        with self._handoff_lock:
            self.handoffs_total += 1
            if not ok:
                self.handoff_failures += 1
            self.handoff_bytes_total += nbytes
            self.handoff_seconds_total += seconds
        self._handoff_seconds.observe(seconds)
        if nbytes:
            self._handoff_bytes.inc(nbytes)

    def record_kv_import(self, summary: Dict[str, int]) -> None:
        with self._handoff_lock:
            self.kv_imports_total += 1
            self.kv_imported_pages_total += int(summary.get('imported', 0))

    def handoff_stats(self) -> Dict[str, object]:
        with self._handoff_lock:
            return {'decode_peers': self.decode_peers(),
                    'handoffs': self.handoffs_total,
                    'failures': self.handoff_failures,
                    'bytes': self.handoff_bytes_total,
                    'seconds': round(self.handoff_seconds_total, 6),
                    'kv_imports': self.kv_imports_total,
                    'kv_imported_pages': self.kv_imported_pages_total}

    # -- live KV-chain migration ----------------------------------------------
    #: migrated-in affinity keys retained for the fleet's pins
    MIGRATED_KEYS_MAX = 1024
    #: how long an evacuation hint stays actionable
    EVAC_HINT_TTL_S = 30.0

    def set_evacuation_hint(self, reason: str,
                            target: Optional[str]) -> None:
        """Why the engines are about to evacuate, and where the
        controller wants the chains to go; expires after
        EVAC_HINT_TTL_S, so a stale rebalance target cannot redirect a
        later drain."""
        with self._migration_lock:
            self._evac_hint = {'reason': str(reason or 'drain'),
                               'target': target or None,
                               'expires': time.monotonic() +
                               self.EVAC_HINT_TTL_S}

    def evacuation_hint(self) -> Tuple[str, Optional[str]]:
        """(reason, target) of the live hint; ('drain', None) (the ring
        picks) when none is set."""
        with self._migration_lock:
            hint = self._evac_hint
            if hint and time.monotonic() < float(hint['expires']):
                return str(hint['reason']), hint['target']
        return 'drain', None

    def record_evacuation(self, summary: Dict[str, int]) -> None:
        """Account one engine's evacuate_chains() result."""
        n_chains = int(summary.get('chains', 0))
        with self._migration_lock:
            self.sessions_evacuated_total += (int(summary.get('evacuated', 0))
                                              + int(summary.get('queued', 0)))
            self.chains_evacuated_total += n_chains
        if n_chains:
            self._chains_evacuated.inc(n_chains)

    def record_migration(self, reason: str, seconds: float,
                         ok: bool) -> None:
        """One out-migration attempt (chain POST + tail proxy), counted
        under its reason; a failed ship also counts a failure (the local
        resume that follows counts as 'local_fallback')."""
        with self._migration_lock:
            self.migrations_by_reason[reason] = \
                self.migrations_by_reason.get(reason, 0) + 1
            if not ok:
                self.migration_failures += 1
            self.migration_seconds_total += seconds
        if ok:
            obs_catalog.counter('skypilot_serving_migrations_total').labels(
                reason=reason).inc()
        self._migration_seconds.observe(seconds)

    def record_migrated_in(self, affinity_key: Optional[str],
                           tokens_recomputed: int) -> None:
        """One migrated-in session: the committed tokens its imported
        pages did not cover, and its affinity key."""
        with self._migration_lock:
            self.migrations_in_total += 1
            self.tokens_recomputed_total += int(tokens_recomputed)
            if affinity_key:
                self._migrated_in_keys.pop(affinity_key, None)
                self._migrated_in_keys[affinity_key] = None
                while len(self._migrated_in_keys) > self.MIGRATED_KEYS_MAX:
                    self._migrated_in_keys.popitem(last=False)
        if tokens_recomputed:
            self._tokens_recomputed.inc(int(tokens_recomputed))

    def migration_stats(self) -> Dict[str, object]:
        with self._migration_lock:
            return {'migrations': dict(self.migrations_by_reason),
                    'failures': self.migration_failures,
                    'seconds': round(self.migration_seconds_total, 6),
                    'sessions_evacuated': self.sessions_evacuated_total,
                    'chains_evacuated': self.chains_evacuated_total,
                    'migrations_in': self.migrations_in_total,
                    'tokens_recomputed': self.tokens_recomputed_total,
                    'migrated_in_keys': list(self._migrated_in_keys)}

    def deadline_for(self, req: dict) -> float:
        """The request's `timeout` field clamped into
        (0, --request-timeout]."""
        try:
            t = float(req.get('timeout', self.request_timeout))
        except (TypeError, ValueError) as e:
            raise ValueError(f'invalid timeout field: {e}') from e
        if t <= 0:
            raise ValueError(f'timeout must be > 0, got {t}')
        return min(t, self.request_timeout)

    # -- model / adapter resolution -------------------------------------------
    def resolve_model(self, model_field) -> Optional[str]:
        """Map a request's `model` field to an adapter name (None = the
        base model: its name, 'base', 'default' or empty). Anything
        else that is not a known adapter raises AdapterNotFoundError,
        also when no adapters are configured."""
        if model_field is None or model_field == '':
            return None
        name = str(model_field)
        if name in (self.model_name, 'base', 'default'):
            return None
        if self.adapters is not None and self.adapters.exists(name):
            return name
        known = ([self.model_name] +
                 (self.adapters.inventory()
                  if self.adapters is not None else []))
        raise AdapterNotFoundError(
            f'model {name!r} does not exist (known models: {known})')

    def engine_for(self, adapter: Optional[str] = None
                   ) -> Optional[ContinuousBatchingEngine]:
        """The engine that runs this request: the main engine; in
        one-shot mode the stream engine for an adapter request (the
        one-shot functions have no per-slot LoRA); None = one-shot."""
        if self.engine is not None:
            return self.engine
        if adapter is not None:
            return self.stream_engine()
        return None

    # -- tokenizer ----------------------------------------------------------
    def get_tokenizer(self):
        with self._tok_lock:
            if 'tok' not in self._tok_holder:
                if self.tokenizer_dir is None:
                    raise ValueError(
                        'no tokenizer available: text endpoints need '
                        'a --hf checkpoint with tokenizer files; use '
                        '/generate with token ids instead')
                from skypilot_tpu_torch.models.hf_import import \
                    load_tokenizer
                self._tok_holder['tok'] = load_tokenizer(
                    self.tokenizer_dir)
            return self._tok_holder['tok']

    # -- one-shot path ------------------------------------------------------
    def get_fn(self, batch: int, temperature: float, total: int = 0):
        """One generate fn per (batch, temperature, total length)
        bucket; `total` defaults to the request class's full capacity.
        Greedy requests under --speculative take the speculative fn."""
        if total <= 0:
            total = self.limit_for(temperature)
        key = (batch, temperature, total)
        with self._lock:
            if key not in self._fns:
                if self.speculative > 0 and temperature == 0.0:
                    self._fns[key] = gen.make_speculative_generate_fn(
                        self.model, total, draft_k=self.speculative)
                else:
                    self._fns[key] = gen.make_generate_fn(
                        self.model, total, temperature=temperature)
            return self._fns[key]

    def run_one_shot(self, fn, rows: List[List[int]]) -> List[List[int]]:
        """fn (from `get_fn`) over equal-length prompt rows; the full
        bucket rows as lists."""
        prompt = torch.tensor(rows, dtype=torch.long)
        with self._one_shot_lock:
            out = fn(prompt.to(self.model.device), self._generator)
            return out.cpu().tolist()

    def one_shot_rows(self, rows: List[List[int]], max_new: int,
                      temperature: float) -> List[List[int]]:
        """Run ragged rows, each alone, through power-of-two buckets;
        each comes back trimmed to prompt + max_new."""
        limit = self.limit_for(temperature)
        out_rows = []
        for ids in rows:
            want = len(ids) + max_new
            bucket = bucket_len(want, limit)
            out = self.run_one_shot(self.get_fn(1, temperature, bucket),
                                    [ids])
            out_rows.append(out[0][:min(want, bucket)])
        return out_rows

    def _score_fn(self, bucket: int):
        """Teacher-forced full-sequence log-softmax (f32) over a padded
        bucket: the /v1/completions logprobs / echo pass. On the card a
        bucket of 2048 or more runs the flash forward."""
        key = ('score', bucket)
        with self._lock:
            if key not in self._fns:
                model = self.model

                @torch.no_grad()
                def score(tokens: torch.Tensor) -> torch.Tensor:
                    # hidden, then logits: Mixtral's training forward
                    # would return (logits, aux).
                    logits = model.logits(model.hidden(tokens))
                    return torch.log_softmax(logits.float(), dim=-1)

                self._fns[key] = score
            return self._fns[key]

    def score_logprobs(self, ids: List[int], n_top: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """For i in 1..T-1: log P(ids[i] | ids[:i]), and the `n_top`
        most likely tokens at that position with their log-probs, best
        first. Returns (chosen [T-1], top_ids [T-1, n_top], top_values
        [T-1, n_top]) as numpy. The values are the reference's (its
        score pass returns the whole [T, vocab] matrix); here they are
        selected on the device, so only O(T * n_top) numbers cross to
        the host."""
        bucket = bucket_len(len(ids), self.max_total_len)
        padded = list(ids) + [0] * (bucket - len(ids))
        tokens = torch.tensor([padded], dtype=torch.long,
                              device=self.model.device)
        with self._one_shot_lock:
            lp = self._score_fn(bucket)(tokens)[0, :len(ids) - 1]
            nxt = tokens[0, 1:len(ids), None]
            chosen = lp.gather(-1, nxt)[:, 0]
            top = torch.topk(lp, n_top, dim=-1) if n_top > 0 else None
            return (chosen.cpu().numpy(),
                    (top.indices.cpu().numpy() if top is not None
                     else np.zeros((len(ids) - 1, 0), np.int64)),
                    (top.values.cpu().numpy() if top is not None
                     else np.zeros((len(ids) - 1, 0), np.float32)))

    # -- streaming path -----------------------------------------------------
    def stream_engine(self) -> ContinuousBatchingEngine:
        """The engine behind streamed requests: the main engine, or in
        one-shot mode a small one built on first use, sharing the
        weights (its cost is its own KV pool)."""
        if self.engine is not None:
            return self.engine
        with self._one_shot_lock:
            if self._stream_engine is None:
                self._stream_engine = ContinuousBatchingEngine(
                    self.model, num_slots=self.STREAM_SLOTS,
                    max_total_len=self.engine_total,
                    speculative_k=self.speculative,
                    prefill_chunk=self._prefill_chunk,
                    prefill_budget=self._prefill_budget,
                    pipeline_decode=(None if self.speculative
                                     else self._pipeline_decode),
                    max_queue_requests=self._max_queue_requests,
                    max_queue_tokens=self._max_queue_tokens,
                    adapter_store=self.adapters,
                    cuda_graphs=self._cuda_graphs)
            return self._stream_engine

    def submit_stream(self, ids: List[int], max_new: int,
                      temperature: float, top_k: int = 0,
                      top_p: float = 1.0,
                      stop_token_ids: Optional[List[int]] = None,
                      deadline_s: Optional[float] = None,
                      adapter: Optional[str] = None,
                      trace_ctx: Optional[tracing.Ctx] = None
                      ) -> StreamHandle:
        eng = self.stream_engine()
        handle = StreamHandle(metrics=self.metrics)
        handle.future = eng.submit(
            ids, max_new_tokens=max_new, temperature=temperature,
            top_k=top_k, top_p=top_p, stop_token_ids=stop_token_ids,
            on_token=handle.on_token,
            deadline_s=(self.request_timeout if deadline_s is None
                        else deadline_s),
            adapter=adapter, trace_ctx=trace_ctx)
        return handle

    def cancel_streams(self, handles: List[StreamHandle]) -> None:
        """Abandon streamed rows whose consumer went away: the engine
        frees their slots instead of generating unread tokens. No-op
        for rows that already completed."""
        futs = [h.future for h in handles
                if h.future is not None and not h.future.done()]
        eng = self.engine if self.engine is not None \
            else self._stream_engine
        if futs and eng is not None:
            eng.cancel(futs)

    def live_engines(self) -> List[ContinuousBatchingEngine]:
        """Engines built so far (the main and / or the stream engine)."""
        return [e for e in (self.engine, self._stream_engine)
                if e is not None]

    def stop(self) -> None:
        for eng in self.live_engines():
            eng.stop()


#: serve_lm flags this port does not implement yet, with the value
#: that means "not asked for" (none left).
_UNSUPPORTED_DEFAULTS = ()


def staged_refusal(args) -> Optional[str]:
    """The reference's refusals of --stages
    (skypilot_tpu/recipes/serve_lm.py:318-337), word for word, or None."""
    if args.stages <= 1:
        return None
    if not args.continuous_batching:
        return ('--stages requires --continuous-batching '
                '(pipeline serving runs the paged slot '
                'engine; the one-shot path has no microbatch '
                'stream to fill the stage bubble)')
    if args.weight_dtype == 'int8':
        return ('--stages does not compose with '
                '--weight-dtype int8 (the quantized wrapper '
                'has no per-stage split; use int8 KV pages '
                'via --kv-dtype int8 instead)')
    if args.decode_chunk > 1:
        return ('--stages does not compose with '
                '--decode-chunk > 1 (the in-flight group '
                'ring feeds one token per slot per round)')
    if args.num_slots % args.stages != 0:
        return (f'--num-slots {args.num_slots} must divide '
                f'evenly into --stages {args.stages} slot '
                f'groups (the decode ring assigns '
                f'num_slots/stages slots per group)')
    return None

#: The reference's refusals around int8 projection weights
#: (skypilot_tpu/inference/runtime.py:866-877), word for word.
INT8_WEIGHTS_NO_CKPT = (
    '--weight-dtype int8 does not compose with '
    '--ckpt-dir (the restore template predates '
    'quantization); restore bf16 or convert first')


def int8_weights_none_found(targets) -> str:
    return (f'--weight-dtype int8 found no quantizable '
            f'projection kernels ({targets}) in '
            f'this model; the Llama family is supported')

#: The reference's refusals of the KV-chain flags without the slot
#: engine (skypilot_tpu/recipes/serve_lm.py:308-317), word for word.
SPILL_NEEDS_CONTINUOUS = (
    '--kv-spill-bytes/--kv-cold-dir require '
    '--continuous-batching (the spill tier stores '
    'evicted prefix-cache pages of the paged slot '
    'engine)')
PREFILL_NEEDS_CONTINUOUS = (
    '--role prefill requires --continuous-batching '
    '(the handoff exports KV page chains from the '
    'slot engine\'s prefix cache)')


def kv_chain_refusal(args) -> Optional[str]:
    """The refusal of --role / --kv-spill-bytes / --kv-cold-dir as
    given, or None: the spill flags and the prefill role need the slot
    engine, and a cold dir must be local."""
    if (args.kv_spill_bytes or args.kv_cold_dir) and \
            not args.continuous_batching:
        return SPILL_NEEDS_CONTINUOUS
    if args.role == 'prefill' and not args.continuous_batching:
        return PREFILL_NEEDS_CONTINUOUS
    if args.kv_cold_dir and args.kv_cold_dir.startswith('gs://'):
        return kv_transfer.REMOTE_COLD_DIR
    return None

#: The reference's refusal of int8 KV pages in the one-shot mode
#: (skypilot_tpu/inference/runtime.py:798-802), word for word.
INT8_NEEDS_CONTINUOUS = (
    '--kv-dtype int8 requires --continuous-batching: the '
    'one-shot engine decodes through the dense per-slot '
    'cache, which has no scale storage')


#: The reference's refusal of KV-pool flags for a config without a
#: kv_dtype field (skypilot_tpu/inference/runtime.py:790-797), word for
#: word but for the config's name.
def kv_flags_need_kv_dtype(config_name: str) -> str:
    return (f'--kv-dtype/--kv-pool-bytes need a paged-KV model '
            f'config with a kv_dtype field (the Llama family); '
            f'{config_name} has none')


def source_config_type(args) -> type:
    """The config class of the model `args` asks for: the --hf
    checkpoint's model_type, else --model's registry entry."""
    if args.hf:
        from skypilot_tpu_torch.models import hf_import
        return hf_import.config_type(args.hf)
    return type(registry.model_config(args.model, args.max_total_len))


def family_refusal(args, config_type: type) -> Optional[str]:
    """The refusal of a flag the model's family lacks, or None, as in
    the reference: the KV-pool flags need a config with a kv_dtype field
    (the Llama family), and int8 weights a family with quantizable
    projections (GPT names none; Mixtral quantizes its attention,
    DeepSeek wq / wo / the SwiGLU). --adapter-dir on the other families
    is refused by `AdapterRegistry`, with the reference's message."""
    if config_type is LlamaConfig:
        return None
    if args.kv_dtype != 'bf16' or args.kv_pool_bytes:
        return kv_flags_need_kv_dtype(config_type.__name__)
    if args.weight_dtype == 'int8' and config_type is GPTConfig:
        return int8_weights_none_found(quant.WEIGHT_TARGETS)
    return None


def _pool_fields(cfg, kv_dtype: str, pages: int) -> dict:
    """The config fields that size a KV pool: kv_total_pages, and
    kv_dtype where the config has the field (the Llama family); none
    for a config without a pool (DeepSeek)."""
    if not hasattr(cfg, 'kv_total_pages'):
        return {}
    fields = {'kv_total_pages': pages}
    if isinstance(cfg, LlamaConfig):
        fields['kv_dtype'] = kv_dtype
    return fields


def unsupported_flags(args) -> List[str]:
    """The `serve_lm` flags in `args` that this port cannot honor (as
    `--flag` names); empty when everything asked for is supported."""
    return [f'--{name.replace("_", "-")}'
            for name, default in _UNSUPPORTED_DEFAULTS
            if getattr(args, name, default) != default]


def spec_total_len(args, max_seq_len: int) -> int:
    """--max-total-len clamped so a verify chunk (--speculative K) has
    its headroom below the model's max_seq_len, with the reference's
    messages (skypilot_tpu/inference/runtime.py:836-856)."""
    total = args.max_total_len
    if args.speculative > 0:
        total = min(args.max_total_len, max_seq_len - args.speculative)
        if total <= 1:
            raise SystemExit(
                f'--speculative {args.speculative} needs headroom in '
                f'the model context: max_seq_len={max_seq_len} leaves no '
                f'room for the verify chunk. Use a smaller K or a '
                f'longer-context model.')
        if total < args.max_total_len:
            print(f'speculative decoding: clamping max_total_len '
                  f'{args.max_total_len} -> {total} (verify chunk '
                  f'needs K={args.speculative} tokens of headroom '
                  f'below max_seq_len={max_seq_len})', flush=True)
    return total


def engine_total_len(args, max_seq_len: int) -> int:
    """The max total length the continuous engine runs at (what
    `limit_for` advertises): `spec_total_len`, clamped again so a
    decode chunk (--decode-chunk N) has its headroom, with the
    reference's message (:1005-1024)."""
    total = spec_total_len(args, max_seq_len)
    if args.decode_chunk > 1:
        clamped = min(total, max_seq_len - args.decode_chunk)
        if clamped < total:
            print(f'decode chunking: clamping max_total_len {total} -> '
                  f'{clamped} (chunk writes need N={args.decode_chunk} '
                  f'tokens of headroom below max_seq_len={max_seq_len})',
                  flush=True)
        total = clamped
    return total


_TOKENIZER_FILES = ('tokenizer.json', 'tokenizer_config.json',
                    'tokenizer.model')


def _source_model(args, model, device: torch.device):
    """(model, tokenizer dir) from the weight source: --hf, the given
    `model`'s tensors (shared, not copied), or the seeded init; then
    --ckpt-dir's newest full-parameter step, when it has one. Weights
    are stored as --param-dtype says (f32: f32 masters cast to the
    compute dtype per use); with --weight-dtype int8 the projections
    are quantized from the source's f32 values and --param-dtype
    applies to the leaves that stay dense."""
    param_dtype = torch.float32 if args.param_dtype == 'f32' else None
    tokenizer_dir = None
    if args.hf:
        if model is not None:
            raise ValueError('pass --hf or a model, not both')
        from skypilot_tpu_torch.models import hf_import
        cfg, model = hf_import.load_hf_checkpoint(
            args.hf, max_seq_len=args.max_total_len, device=device,
            weight_dtype=args.weight_dtype, param_dtype=param_dtype)
        print(f'loaded HF checkpoint from {args.hf} '
              f'({type(model).__name__}, vocab={cfg.vocab_size})',
              flush=True)
        if any(os.path.exists(os.path.join(args.hf, f))
               for f in _TOKENIZER_FILES):
            tokenizer_dir = args.hf
    elif model is None:
        cfg = dataclasses.replace(
            registry.model_config(args.model, args.max_total_len),
            param_dtype=param_dtype)
        model = convert.init_params(cfg, seed=0, device=device,
                                    weight_dtype=args.weight_dtype)
    else:
        # A model cut in depth (fewer layers of --model's widths) is
        # served as given: configurations too deep for one card run so.
        want = dataclasses.replace(
            registry.model_config(args.model, args.max_total_len),
            num_layers=model.config.num_layers)
        widths = dataclasses.replace(
            model.config, **_pool_fields(want, kv_dtype_of(want),
                                         getattr(want, 'kv_total_pages', 0)))
        if widths != want or model.device != device or \
                model.weight_dtype != args.weight_dtype:
            raise ValueError(f'the given model does not match --model '
                             f'{args.model} --weight-dtype '
                             f'{args.weight_dtype} on {device}')
    if args.ckpt_dir:
        from skypilot_tpu_torch.parallel.checkpoints import \
            CheckpointManager
        mgr = CheckpointManager(args.ckpt_dir)
        if mgr.latest_step() is not None:
            params = mgr.restore_params()
            names = set(model.state_dict())
            if set(params) != names:
                raise ValueError(
                    f'checkpoint in {args.ckpt_dir} does not match the '
                    f'served model: missing '
                    f'{sorted(names - set(params))[:5]}, extra '
                    f'{sorted(set(params) - names)[:5]}')
            model = convert.assemble(model.config, convert.cast_to_layout(
                model.config, params, device))
            print(f'loaded checkpoint step {mgr.last_restored_step}',
                  flush=True)
    return model, tokenizer_dir


def build_runtime(args, model=None, cuda_graphs: bool = True,
                  devices: Optional[List] = None) -> InferenceRuntime:
    """Construct the runtime from serve_lm CLI args: the fault plan of
    --fault-plan (installed first), the weights (`_source_model`), the
    KV pool sized by --kv-dtype / --kv-pool-bytes, the adapter registry
    of --adapter-dir, the continuous engine (--continuous-batching) or
    the one-shot mode, then tracing (--trace-sample / --trace-seed) and
    the SLO tracker (--slo).
    `model`'s weight tensors are shared when given (two runtimes that
    differ only in their KV pool need one copy of the weights); it must
    have --model's widths, and may have fewer layers.
    `cuda_graphs=False` runs the decode rounds eagerly on the card
    (serve_lm never sets it; the chip_smoke.py and profile_decode.py
    A/Bs do).
    --tensor / --stages serve over a grid of --stages x --tensor devices
    (parallel/serving.py): the first that many distinct CUDA cards, too
    few exiting at startup, or `devices` (a list that may name one
    device several times; serve_lm has no such flag). The weights are
    made on the grid's device when it has one, else on the CPU, and
    split onto it; the pool is sized per device. Over distinct cards the
    grid's collective is set up here (peer access between every pair of
    cards, its exchange buffers): a pair without peer access stops the
    server at startup with the reason."""
    bad = unsupported_flags(args)
    if bad:
        raise ValueError('not supported by the PyTorch port yet: '
                         + ', '.join(bad))
    refusal = staged_refusal(args)
    if refusal:
        raise SystemExit(refusal)
    grid = None
    if args.tensor > 1 or args.stages > 1 or devices is not None:
        grid = serving.make_grid(
            MeshConfig(stage=args.stages, tensor=args.tensor),
            cpu=args.cpu, devices=devices)
    if args.kv_dtype == 'int8' and not args.continuous_batching:
        raise SystemExit(INT8_NEEDS_CONTINUOUS)
    if args.weight_dtype == 'int8' and args.ckpt_dir:
        raise SystemExit(INT8_WEIGHTS_NO_CKPT)
    refusal = kv_chain_refusal(args)
    if refusal:
        raise SystemExit(refusal)
    if getattr(args, 'fault_plan', None):
        # Armed before the engine starts (serve_lm's --fault-plan, as the
        # reference's serve_lm arms it); a bad plan raises ValueError.
        faults.install_plan(args.fault_plan)
        print(f'serve_lm: FAULT PLAN ARMED ({sorted(faults.stats())}) — '
              f'chaos mode', flush=True)
    refusal = family_refusal(args, source_config_type(args))
    if refusal:
        raise SystemExit(refusal)
    if grid is None:
        device = resolve_device(cpu=args.cpu)
    else:
        # One device named throughout: the weights are made there and
        # the shards view them; distinct devices take their shards from
        # the CPU.
        device = (grid.first if grid.distinct_devices() == 1
                  else torch.device('cpu'))
    model, tokenizer_dir = _source_model(args, model, device)
    if args.weight_dtype == 'int8':
        if convert.weight_dtype_of(model.state_dict()) != 'int8':
            raise SystemExit(int8_weights_none_found(quant.WEIGHT_TARGETS))
        print('weights: int8 per-output-channel projections '
              '(dequant-on-read)', flush=True)
    cfg = model.config
    if hasattr(cfg, 'kv_total_pages'):
        # --kv-pool-bytes is per device: a pool whose kv heads split
        # over --tensor, and whose layers split over --stages, buys about
        # that many times the pages at the same per-device bytes.
        ways = serving.kv_shard_ways(kv_heads(cfg), args.tensor)
        pages = (quant.pool_pages_for_bytes(cfg, args.kv_dtype,
                                            args.kv_pool_bytes, ways,
                                            args.stages)
                 if args.kv_pool_bytes else cfg.kv_total_pages)
        cfg = dataclasses.replace(cfg, **_pool_fields(cfg, args.kv_dtype,
                                                      pages))
        split = (f', kv heads split {ways} ways' if ways > 1 else '') + (
            f', over {args.stages} stages' if args.stages > 1 else '')
        print(f'kv cache: dtype={args.kv_dtype} pages={pages} '
              f'({quant.kv_page_bytes(cfg, args.kv_dtype, ways, args.stages)}'
              f' bytes/page/device across layers{split})', flush=True)
    else:
        print(f'kv cache: {type(cfg).__name__} declares no page pool; '
              f'dense rows of max_seq_len={cfg.max_seq_len} on {device}',
              flush=True)
    # Serving never takes gradients, f32 masters included.
    model = convert.assemble(cfg, model.state_dict()).requires_grad_(False)
    if grid is not None:
        model = serving.GridModel(model, grid)
        print(f'serving over {grid.size} devices ({args.stages} stages x '
              f'{args.tensor}-way tensor): '
              f'{[[str(d) for d in row] for row in grid.devices]}; '
              f'collectives: {grid.collective_route()}', flush=True)
    # Multi-LoRA adapter registry: scanned at startup, hot-loaded on
    # demand; every engine of the runtime shares its store.
    adapters = None
    if args.adapter_dir:
        adapters = AdapterRegistry(args.adapter_dir, model,
                                   max_adapters=args.max_adapters,
                                   max_rank=args.max_lora_rank,
                                   mesh=getattr(model, 'grid', None))
        inv = adapters.inventory()
        print(f'adapter registry: {len(inv)} adapters in '
              f'{args.adapter_dir} (max {adapters.max_adapters} '
              f'device-resident): {inv}', flush=True)
    pipeline_decode = False if args.no_pipeline_decode else None
    engine = None
    spec_total = spec_total_len(args, cfg.max_seq_len)
    engine_total = spec_total
    if args.continuous_batching:
        engine_total = engine_total_len(args, cfg.max_seq_len)
        engine = ContinuousBatchingEngine(
            model, num_slots=args.num_slots, max_total_len=engine_total,
            prefix_caching=not args.no_prefix_caching,
            prefill_chunk=args.prefill_chunk,
            prefill_budget=args.prefill_budget,
            max_queue_requests=args.max_queue_requests,
            max_queue_tokens=args.max_queue_tokens, adapter_store=adapters,
            speculative_k=args.speculative, decode_chunk=args.decode_chunk,
            pipeline_decode=pipeline_decode, cuda_graphs=cuda_graphs,
            kv_spill_bytes=args.kv_spill_bytes, kv_cold_dir=args.kv_cold_dir)
    decode_peers = [p for p in (args.decode_peers or '').split(',') if p]
    rt = InferenceRuntime(
        engine=engine, model=model,
        model_name=(f'hf:{os.path.basename(args.hf)}' if args.hf
                    else args.model),
        max_total_len=args.max_total_len, speculative=args.speculative,
        spec_total=spec_total, engine_total=engine_total,
        tokenizer_dir=tokenizer_dir, prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget, pipeline_decode=pipeline_decode,
        max_queue_requests=args.max_queue_requests,
        max_queue_tokens=args.max_queue_tokens,
        request_timeout=args.request_timeout, zone=args.zone,
        adapters=adapters, cuda_graphs=cuda_graphs, role=args.role,
        decode_peers=decode_peers)
    obs_catalog.gauge('skypilot_serving_weight_bytes').set(rt.weight_bytes)
    obs_catalog.gauge('skypilot_serving_storage_info').labels(
        kv_dtype=rt.kv_dtype, weight_dtype=rt.weight_dtype).set(1)
    # Head-sampled tracing at the configured rate; the process tag makes
    # this node's spans a row of their own in a merged trace.
    trace_sample = float(getattr(args, 'trace_sample', 0.0) or 0.0)
    if trace_sample > 0.0:
        tracing.configure(sample=trace_sample,
                          seed=getattr(args, 'trace_seed', None),
                          process=rt.role or 'replica')
    # One SLO tracker feeds /stats' `slo` block and the
    # skypilot_serving_slo_* gauges, through the ServingMetrics hooks.
    slo_spec = getattr(args, 'slo', None)
    if slo_spec:
        rt.slo_tracker = slo_lib.SloTracker(slo_lib.parse_slo(slo_spec))
        rt.metrics.slo = rt.slo_tracker
    return rt
