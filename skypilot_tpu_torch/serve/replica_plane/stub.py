"""Stub replica: serve_lm's control surface without the model (port of
skypilot_tpu/serve/replica_plane/stub.py; the same answers, counters
and drain contract, its peer POSTs through `http_client`).

Speaks exactly the subset of the inference server the replica plane
depends on — `GET /readyz` (503 while draining), `GET /healthz`,
`GET /stats` (queued / prefill_backlog_tokens / requests_shed /
prefix_cache), `POST /generate` with SSE streaming, and the SIGTERM
drain contract (readyz flips 503, in-flight requests finish, process
exits 0) — with real prefix-cache accounting: prompts are paged with
the SAME chain-key hash the engine uses (inference/affinity.py), hit
against a bounded per-replica LRU. Affinity routing therefore wins
measurably on stubs for the same reason it wins on real replicas:
pinning a prefix group to one replica stops every replica from
paying (and caching) the same pages.

Chaos knob: `--die-after-tokens K` crashes the process (exit 1) the
moment its K-th token is emitted — a replica death mid-stream, with
deterministic timing. Tier-1 chaos tests run the whole
kill -> reroute -> replace -> no-extra-5xx loop on stubs; the slow
e2e repeats it on real serve_lm processes.

Run as a process: `python -m skypilot_tpu_torch.serve.replica_plane.stub
--port 0 --seed 3`. In-process (tests): `in_process_stub_factory()`
returns a ReplicaManager-compatible factory whose handles expose
`poll/send_signal/kill/wait` plus a `.die()` crash helper.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import signal
import threading
import time
import uuid as uuid_lib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from skypilot_tpu_torch.inference import affinity
from skypilot_tpu_torch.inference import sse
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.robustness import faults
from skypilot_tpu_torch.serve.replica_plane import http_client


class _StubDied(Exception):
    """Raised inside a handler to abort its stream when the stub
    'crashes' (in-process mode; subprocess mode just _exits)."""


class StubState:
    """Shared state of one stub replica (thread-safe via `lock`)."""

    def __init__(self, *, seed: int, page_size: int, cache_pages: int,
                 token_sleep_s: float, die_after_tokens: int,
                 on_die: Optional[Callable[[], None]],
                 instance_uuid: Optional[str] = None,
                 role: str = '',
                 prefill_ms_per_token: float = 0.0,
                 zone: str = '',
                 migrate: bool = True) -> None:
        self.seed = seed
        # Spot placement label: echoed in /stats and matched against
        # zone-scoped `serve.preempt_notice` fault rules (the
        # decode_zone_storm plan preempts exactly one zone's pool).
        self.zone = zone
        # Live migration: with `migrate` off this stub is
        # the full-replay A/B arm — a preemption just kills it and
        # the client replays the whole prompt elsewhere.
        self.migrate_enabled = migrate
        self.evacuate = threading.Event()
        self.evac_reason = 'drain'
        self.evac_target: Optional[str] = None
        self.evac_budget: Optional[int] = None  # None = all sessions
        self.migrations: Dict[str, int] = {}
        self.migration_failures = 0
        self.sessions_evacuated = 0
        self.chains_evacuated = 0
        self.migrations_in = 0
        self.tokens_recomputed = 0
        self.migrated_in_keys: List[str] = []
        # Disaggregation model (mirrors serve_lm --role): one
        # "engine" lock serializes prefill chunks and token emission
        # — a long prompt's simulated prefill delays every other
        # stream's tokens exactly like the real single-engine
        # replica, UNLESS the pages arrived via /kv/import (cache
        # hits cost no prefill). prefill stubs hand the chain keys
        # off to a decode peer and proxy its response.
        self.role = role
        self.prefill_ms_per_token = prefill_ms_per_token
        self.engine_lock = threading.Lock()
        self.decode_peers: List[str] = []
        self.handoffs = 0
        self.handoff_failures = 0
        self.kv_imports = 0
        # Identity echoed in /stats; the replica plane's adoption
        # path matches it against the journaled UUID (same contract
        # as the real serve_lm server).
        self.instance_uuid = (
            instance_uuid or
            os.environ.get('STPU_REPLICA_INSTANCE_UUID') or
            uuid_lib.uuid4().hex)
        self.page_size = page_size
        self.cache_pages = cache_pages
        self.token_sleep_s = token_sleep_s
        self.die_after_tokens = die_after_tokens
        self.on_die = on_die
        self.lock = threading.Lock()
        self.draining = threading.Event()
        self.aborted = threading.Event()
        self.inflight = 0
        self.tokens_emitted = 0
        self.requests_served = 0
        # Prefix "page cache": chain key -> None, LRU order, bounded
        # like the real page pool (evictions make duplicated prefixes
        # expensive, exactly the pressure affinity routing removes).
        self.cache: 'collections.OrderedDict[bytes, None]' = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Engine-side inter-token gaps (seconds), per stream row —
        # the commit-time ITL signal the real engine reports; client
        # SSE timing rides TCP buffering and can't see ms-scale
        # contention. /stats ships the recent raw gaps so a bench
        # can compute true fleet-wide percentiles.
        self.itl_gaps: 'collections.deque' = collections.deque(
            maxlen=4096)
        # Tests inject autoscaler pressure here (merged last into
        # /stats): e.g. {'prefill_backlog_tokens': 99999}.
        self.stats_overrides: Dict[str, Any] = {}

    def account_pages(self, tokens: List[int]) -> int:
        """Record the prompt's chain keys against the bounded page
        cache; returns the number of MISSED pages (the pages this
        replica would have to prefill — imported/cached pages cost
        nothing, which is exactly the disaggregation win)."""
        keys = affinity.chain_keys(tokens, self.page_size)
        n_miss = 0
        with self.lock:
            for key in keys:
                if key in self.cache:
                    self.cache.move_to_end(key)
                    self.hits += 1
                else:
                    self.cache[key] = None
                    self.misses += 1
                    n_miss += 1
                    while len(self.cache) > self.cache_pages:
                        self.cache.popitem(last=False)
                        self.evictions += 1
        return n_miss

    def begin_evacuation(self, reason: str,
                         target: Optional[str] = None,
                         max_sessions: Optional[int] = None) -> None:
        """Arm evacuation: in-flight streams start migrating out at
        their next token boundary. `max_sessions` bounds how many
        (rebalance); None evacuates everything (drain/preempt)."""
        with self.lock:
            self.evac_reason = reason or 'drain'
            self.evac_target = target or None
            self.evac_budget = (int(max_sessions)
                                if max_sessions is not None else None)
        self.evacuate.set()

    def take_evac_slot(self) -> Optional[tuple]:
        """Claim one evacuation slot: (reason, target) when this
        stream should migrate out now, else None. Bounded
        evacuations hand out `max_sessions` slots then disarm."""
        with self.lock:
            if not self.evacuate.is_set():
                return None
            if self.evac_budget is not None:
                if self.evac_budget <= 0:
                    self.evacuate.clear()
                    return None
                self.evac_budget -= 1
                if self.evac_budget == 0:
                    self.evacuate.clear()
            return self.evac_reason, self.evac_target

    def fully_evacuating(self) -> bool:
        """An unbounded evacuation is in progress (drain/preempt):
        readyz flips 503 so the LB stops sending fresh sessions to a
        replica that is emptying itself."""
        with self.lock:
            return (self.evacuate.is_set() and
                    self.evac_budget is None)

    def import_keys(self, keys: List[bytes]) -> int:
        """Decode side of a stub handoff: adopt the chain keys as
        resident pages (no hit/miss accounting — the import is the
        transfer, not a lookup)."""
        n = 0
        with self.lock:
            for key in keys:
                if key not in self.cache:
                    self.cache[key] = None
                    n += 1
                self.cache.move_to_end(key)
                while len(self.cache) > self.cache_pages:
                    self.cache.popitem(last=False)
                    self.evictions += 1
            self.kv_imports += 1
        return n

    def simulate_prefill(self, n_miss_pages: int) -> None:
        """Model compute-bound prefill: one engine-lock hold per
        missed page (chunked prefill — decode tokens of OTHER
        streams interleave between chunks but wait out the chunk in
        flight, like the real scheduler)."""
        if self.prefill_ms_per_token <= 0:
            return
        per_page_s = self.prefill_ms_per_token * self.page_size / 1e3
        for _ in range(n_miss_pages):
            with self.engine_lock:
                time.sleep(per_page_s)

    def emit_token(self) -> None:
        """One token committed; fires the crash knob exactly at the
        configured count."""
        if self.aborted.is_set():
            raise _StubDied()
        with self.lock:
            self.tokens_emitted += 1
            fire = (self.die_after_tokens > 0 and
                    self.tokens_emitted == self.die_after_tokens)
        if fire:
            self.aborted.set()
            if self.on_die is not None:
                self.on_die()
                raise _StubDied()
            os._exit(1)
        if self.token_sleep_s > 0:
            # Decode rides the same engine lock as prefill chunks:
            # a concurrent long prefill stretches THIS stream's
            # inter-token gaps (the unified-replica tail damage the
            # disaggregated arm removes).
            with self.engine_lock:
                time.sleep(self.token_sleep_s)

    def stats(self) -> Dict[str, Any]:
        with self.lock:
            body = {
                'engine': 'stub',
                'instance_uuid': self.instance_uuid,
                'pid': os.getpid(),
                'healthy': not self.aborted.is_set(),
                'role': self.role,
                'zone': self.zone,
                'queued': self.inflight,
                'prefill_backlog_tokens': 0,
                'requests_shed': 0,
                'requests_served': self.requests_served,
                'tokens_emitted': self.tokens_emitted,
                'handoff': {
                    'decode_peers': list(self.decode_peers),
                    'handoffs': self.handoffs,
                    'failures': self.handoff_failures,
                    'kv_imports': self.kv_imports,
                },
                'itl_gaps_ms': [round(g * 1000.0, 3)
                                for g in self.itl_gaps],
                'prefix_cache': {
                    'hits': self.hits,
                    'misses': self.misses,
                    'hit_rate': round(
                        self.hits / max(self.hits + self.misses, 1),
                        4),
                    'evictions': self.evictions,
                },
            }
            if (self.migrations or self.sessions_evacuated or
                    self.migrations_in or self.migration_failures):
                body['migration'] = {
                    'migrations': dict(self.migrations),
                    'failures': self.migration_failures,
                    'sessions_evacuated': self.sessions_evacuated,
                    'chains_evacuated': self.chains_evacuated,
                    'migrations_in': self.migrations_in,
                    'tokens_recomputed': self.tokens_recomputed,
                    'migrated_in_keys': list(self.migrated_in_keys),
                }
            body.update(self.stats_overrides)
        return body


def make_stub_server(port: int, *, seed: int = 0, page_size: int = 16,
                     cache_pages: int = 64,
                     token_sleep_s: float = 0.0,
                     die_after_tokens: int = 0,
                     on_die: Optional[Callable[[], None]] = None,
                     instance_uuid: Optional[str] = None,
                     role: str = '',
                     prefill_ms_per_token: float = 0.0,
                     zone: str = '',
                     migrate: bool = True
                     ) -> ThreadingHTTPServer:
    state = StubState(seed=seed, page_size=page_size,
                      cache_pages=cache_pages,
                      token_sleep_s=token_sleep_s,
                      die_after_tokens=die_after_tokens,
                      on_die=on_die, instance_uuid=instance_uuid,
                      role=role,
                      prefill_ms_per_token=prefill_ms_per_token,
                      zone=zone, migrate=migrate)

    class Handler(BaseHTTPRequestHandler):

        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == '/healthz':
                self._json({'status': 'alive'})
                return
            if self.path == '/readyz':
                reasons = []
                if state.draining.is_set():
                    reasons.append('draining')
                if state.aborted.is_set():
                    reasons.append('engine dead')
                if state.fully_evacuating():
                    reasons.append('evacuating')
                self._json({'ready': not reasons, 'reasons': reasons},
                           200 if not reasons else 503)
                return
            if self.path in ('/stats', '/v1/stats'):
                self._json(state.stats())
                return
            if self.path.startswith('/debug/trace/'):
                trace_id = self.path.rsplit('/', 1)[-1]
                trace = tracing.get_trace(trace_id)
                if trace is None:
                    self._json({'error': f'unknown trace {trace_id}'},
                               404)
                else:
                    self._json(trace)
                return
            self._json({'status': 'ok', 'model': 'stub',
                        'vocab_size': 50000, 'max_total_len': 4096})

        def do_POST(self):  # noqa: N802
            if self.path == '/kv/peers':
                length = int(self.headers.get('Content-Length', 0))
                req = json.loads(self.rfile.read(length))
                with state.lock:
                    state.decode_peers = [
                        str(p) for p in (req.get('decode') or [])]
                self._json({'decode': state.decode_peers})
                return
            if self.path == '/kv/evacuate':
                length = int(self.headers.get('Content-Length', 0))
                req = json.loads(self.rfile.read(length)) \
                    if length else {}
                reason = str(req.get('reason') or 'drain')
                state.begin_evacuation(
                    reason, req.get('target'),
                    req.get('max_sessions'))
                with state.lock:
                    inflight = state.inflight
                self._json({'evacuated': inflight,
                            'chains': inflight, 'queued': 0,
                            'reason': reason})
                return
            if self.path not in ('/generate', '/v1/generate',
                                 '/kv/import', '/kv/migrate'):
                self._json({'error': 'stub serves POST /generate'},
                           404)
                return
            with state.lock:
                state.inflight += 1
            try:
                # Adopt the caller's trace (LB header or a prefill
                # peer's handoff POST): the stub never head-samples —
                # in a fleet the LB owns that decision. Role-tagged
                # process rows make the merged trace read
                # lb -> prefill -> decode.
                ctx = tracing.parse_header(
                    self.headers.get(tracing.HEADER))
                with tracing.span('replica.request', ctx,
                                  process=state.role or 'replica',
                                  path=self.path) as root:
                    self._trace_ctx = root.ctx
                    if self.path == '/kv/import':
                        self._kv_import()
                    elif self.path == '/kv/migrate':
                        self._kv_migrate()
                    else:
                        self._generate()
            except _StubDied:
                # Crash simulation: the connection just breaks —
                # the client sees a reset/truncation, as with a
                # killed process.
                self.close_connection = True
            finally:
                with state.lock:
                    state.inflight -= 1
                    state.requests_served += 1

        def _kv_import(self):
            """Decode side of a stub handoff: adopt the chain keys
            (imported pages = resident pages, no prefill cost), then
            serve the embedded request like a direct /generate."""
            length = int(self.headers.get('Content-Length', 0))
            req = json.loads(self.rfile.read(length))
            keys = [bytes.fromhex(k) for k in (req.get('keys') or [])]
            state.import_keys(keys)
            inner = req.get('request')
            if not inner:
                self._json({'imported': len(keys)})
                return
            self._generate(inner)

        def _kv_migrate(self):
            """Receiving side of a live session migration: adopt the
            shipped chain keys (warm pages — the continuation prefill
            costs only the uncovered tail), account the tokens this
            replica did NOT have to recompute, then continue the
            embedded request exactly where the sender stopped."""
            length = int(self.headers.get('Content-Length', 0))
            req = json.loads(self.rfile.read(length))
            keys = [bytes.fromhex(k) for k in (req.get('keys') or [])]
            state.import_keys(keys)
            inner = req.get('request') or {}
            rows = inner.get('tokens') or [[]]
            row = [int(t) for t in (rows[0] if rows else [])]
            covered = len(keys) * state.page_size
            recomputed = max(0, len(row) - covered)
            key = affinity.token_affinity_key(row, state.page_size)
            with state.lock:
                state.migrations_in += 1
                state.tokens_recomputed += recomputed
                if key is not None:
                    state.migrated_in_keys.append(key)
                    del state.migrated_in_keys[:-1024]
            self._generate(inner)

        def _migrate_out(self, reason: str, target: Optional[str],
                         produced: List[int], base_len: int,
                         gen_seed: int, j_next: int, j_end: int,
                         stream: bool) -> Optional[List[int]]:
            """Ship this stream's committed tokens + chain keys to a
            peer and take over its response: stream mode pipes the
            peer's SSE tail through verbatim (returns []), non-stream
            returns the peer's final full row. None on any failure —
            the caller finishes locally (a migration must never
            become a client error)."""
            with state.lock:
                peers = list(state.decode_peers)
            peer = target
            if peer is None:
                if not peers:
                    return None
                key = affinity.token_affinity_key(produced,
                                                  state.page_size)
                peer = peers[0]
                if key is not None and len(peers) > 1:
                    idx = int.from_bytes(bytes.fromhex(key)[:4],
                                         'big')
                    peer = peers[idx % len(peers)]
            keys = affinity.chain_keys(produced, state.page_size)
            body = {
                'keys': [k.hex() for k in keys],
                'reason': reason,
                'request': {
                    'tokens': [list(produced)],
                    'max_new_tokens': j_end - j_next,
                    'stream': stream,
                    # The receiver re-derives the SAME greedy token
                    # sequence the origin would have produced: token
                    # j of a prompt of base_len under gen_seed, not
                    # its own seed over the longer committed row.
                    '_continuation': {'prompt_len': base_len,
                                      'j_start': j_next,
                                      'seed': gen_seed},
                },
            }
            ctx = getattr(self, '_trace_ctx', None)
            hdrs = {'Content-Type': 'application/json'}
            if ctx is not None:
                hdrs[tracing.HEADER] = tracing.format_header(ctx)
            try:
                with tracing.span('kv.migrate', ctx, peer=peer,
                                  reason=reason, pages=len(keys)):
                    upstream = http_client.request(
                        'POST', f'http://{peer}/kv/migrate',
                        json.dumps(body).encode(), hdrs,
                        timeout=(2.0, 600.0))
                if upstream.status_code != 200:
                    upstream.close()
                    raise RuntimeError(
                        f'peer answered {upstream.status_code}')
            except (*http_client.ERRORS, RuntimeError) as e:
                with state.lock:
                    state.migration_failures += 1
                print(f'stub: migration to {peer} failed ({e}); '
                      f'finishing locally', flush=True)
                return None
            with state.lock:
                state.migrations[reason] = \
                    state.migrations.get(reason, 0) + 1
                state.sessions_evacuated += 1
                state.chains_evacuated += 1
            with upstream:
                if stream:
                    # Arrival-granular tail piping (sse.pipe): the
                    # client keeps seeing tokens the moment the new
                    # owner emits them; truncation looks like a
                    # replica death and is already logged there.
                    sse.pipe(upstream, self.wfile)
                    return []
                try:
                    rows = upstream.json().get('tokens') or [[]]
                    return [int(t) for t in rows[0]]
                except (ValueError, IndexError, *http_client.ERRORS) as e:
                    print(f'stub: migrated response unparsable '
                          f'({e}); finishing locally', flush=True)
                    with state.lock:
                        state.migration_failures += 1
                    return None

        def _handoff(self, req, rows) -> bool:
            """Prefill-role stub: pay the prefill locally, ship the
            chain keys to the first decode peer, proxy its response.
            False on any failure — the caller serves locally (same
            graceful-fallback contract as the real server)."""
            with state.lock:
                peers = list(state.decode_peers)
            if not peers or len(rows) != 1:
                return False
            row = [int(t) for t in rows[0]]
            n_miss = state.account_pages(row)
            state.simulate_prefill(n_miss)
            keys = affinity.chain_keys(row, state.page_size)
            key = affinity.token_affinity_key(row, state.page_size)
            peer = peers[0]
            if key is not None and len(peers) > 1:
                idx = int.from_bytes(bytes.fromhex(key)[:4], 'big')
                peer = peers[idx % len(peers)]
            ctx = getattr(self, '_trace_ctx', None)
            hdrs = {'Content-Type': 'application/json'}
            if ctx is not None:
                hdrs[tracing.HEADER] = tracing.format_header(ctx)
            try:
                with tracing.span('kv.post', ctx, peer=peer,
                                  pages=len(keys)):
                    upstream = http_client.request(
                        'POST', f'http://{peer}/kv/import',
                        json.dumps({'keys': [k.hex() for k in keys],
                                    'request': req}).encode(),
                        hdrs, timeout=(2.0, 600.0))
                if upstream.status_code >= 429:
                    upstream.close()
                    raise RuntimeError(
                        f'decode stub answered '
                        f'{upstream.status_code}')
            except (*http_client.ERRORS, RuntimeError) as e:
                with state.lock:
                    state.handoffs += 1
                    state.handoff_failures += 1
                print(f'stub handoff failed ({e}); serving locally',
                      flush=True)
                return False
            with state.lock:
                state.handoffs += 1
            with upstream:
                self.send_response(upstream.status_code)
                ctype = upstream.headers.get('Content-Type',
                                             'application/json')
                self.send_header('Content-Type', ctype)
                body_bytes = None
                if 'text/event-stream' not in ctype:
                    body_bytes = upstream.read()
                    self.send_header('Content-Length',
                                     str(len(body_bytes)))
                self.end_headers()
                if body_bytes is not None:
                    self.wfile.write(body_bytes)
                    return True
                # Arrival-granular SSE pass-through; truncation is
                # bounded and logged by the pipe itself.
                sse.pipe(upstream, self.wfile)
            return True

        def _generate(self, req=None):
            if req is None:
                length = int(self.headers.get('Content-Length', 0))
                req = json.loads(self.rfile.read(length))
            rows = req.get('tokens') or [[]]
            if rows and not isinstance(rows[0], list):
                rows = [rows]
            max_new = int(req.get('max_new_tokens', 8))
            stream = bool(req.get('stream'))
            if state.role == 'prefill' and self.path not in (
                    '/kv/import', '/kv/migrate'):
                if self._handoff(req, rows):
                    return
            for row in rows:
                n_miss = state.account_pages([int(t) for t in row])
                state.simulate_prefill(n_miss)
            out_rows = []
            if stream:
                self.send_response(200)
                self.send_header('Content-Type', 'text/event-stream')
                self.send_header('Cache-Control', 'no-cache')
                self.send_header('Connection', 'close')
                self.end_headers()
            # Migration continuations re-derive the origin's token
            # stream: token j of a base_len prompt under the ORIGIN
            # replica's seed (bit-identity across the migration).
            cont = req.get('_continuation') or {}
            for i, row in enumerate(rows):
                produced = list(row)
                base_len = int(cont.get('prompt_len', len(row)))
                j_start = int(cont.get('j_start', 0))
                gen_seed = int(cont.get('seed', state.seed))
                j_end = j_start + max_new
                last_t = None
                migrate_tried = False
                for j in range(j_start, j_end):
                    if (state.migrate_enabled and len(rows) == 1 and
                            not migrate_tried and
                            state.evacuate.is_set()):
                        slot = state.take_evac_slot()
                        if slot is not None:
                            migrate_tried = True
                            result = self._migrate_out(
                                slot[0], slot[1], produced,
                                base_len, gen_seed, j, j_end,
                                stream)
                            if result is not None:
                                if stream:
                                    return  # peer piped the tail
                                self._json({'tokens': [result]})
                                return
                    tok = (gen_seed * 1000003 + base_len * 31 +
                           j) % 50000
                    state.emit_token()
                    now = time.monotonic()
                    if last_t is not None:
                        with state.lock:
                            state.itl_gaps.append(now - last_t)
                    last_t = now
                    produced.append(tok)
                    if stream:
                        self.wfile.write(
                            b'data: ' +
                            json.dumps({'index': i,
                                        'token': tok}).encode() +
                            b'\n\n')
                        self.wfile.flush()
                out_rows.append(produced)
            if stream:
                self.wfile.write(
                    b'data: ' + json.dumps(
                        {'done': True, 'tokens': out_rows}).encode() +
                    b'\n\n')
                self.wfile.write(b'data: [DONE]\n\n')
                self.wfile.flush()
            else:
                self._json({'tokens': out_rows})

    server = ThreadingHTTPServer(('127.0.0.1', port), Handler)
    server.stub = state  # type: ignore[attr-defined]
    return server


class InProcessStubReplica:
    """Popen-shaped handle over a threaded stub server, so
    ReplicaManager drives in-process stubs exactly like subprocesses
    — deterministically and without per-process interpreter costs in
    tier-1."""

    def __init__(self, port: int, **stub_kwargs: Any) -> None:
        stub_kwargs.setdefault('on_die', self._die_from_handler)
        self.server = make_stub_server(port, **stub_kwargs)
        self.state: StubState = self.server.stub
        self.port = self.server.server_address[1]
        self._rc: Optional[int] = None
        self._rc_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self._thread.start()

    # -- Popen surface ---------------------------------------------------
    def poll(self) -> Optional[int]:
        with self._rc_lock:
            return self._rc

    def send_signal(self, sig: int) -> None:
        if sig != signal.SIGTERM:
            self.kill()
            return
        if self.poll() is not None:
            return
        threading.Thread(target=self._drain, daemon=True).start()

    def terminate(self) -> None:
        self.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        self._stop(-9)

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError('stub did not exit')
            time.sleep(0.01)
        return self.poll()

    # -- crash + drain helpers -------------------------------------------
    def die(self, rc: int = 1) -> None:
        """Abrupt death (test chaos helper): in-flight streams break,
        new connections are refused."""
        self.state.aborted.set()
        self._stop(rc)

    def _die_from_handler(self) -> None:
        # Called from inside a handler thread when die_after_tokens
        # fires: stop the server from ANOTHER thread (shutdown()
        # joins the serve loop) and let the handler raise.
        threading.Thread(target=self._stop, args=(1,),
                         daemon=True).start()

    def _drain(self) -> None:
        """The serve_lm SIGTERM contract: readyz flips 503, in-flight
        requests finish (migrating out when the controller armed
        evacuation or peers are known), then exit 0."""
        self.state.begin_evacuation('drain')
        self.state.draining.set()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            with self.state.lock:
                if self.state.inflight == 0:
                    break
            time.sleep(0.02)
        self._stop(0)

    def _stop(self, rc: int) -> None:
        with self._rc_lock:
            if self._rc is not None:
                return
            self._rc = rc
        try:
            self.server.shutdown()
            self.server.server_close()
        except OSError:
            pass  # already closed


def in_process_stub_factory(**stub_kwargs: Any
                            ) -> Callable[[int, int],
                                          InProcessStubReplica]:
    """ReplicaManager factory for in-process stubs.
    `per_replica` (optional: {replica_id: {kwargs}}) overrides knobs
    for specific replicas — e.g. give replica 2 a die_after_tokens."""
    per_replica = stub_kwargs.pop('per_replica', {})

    def spawn(replica_id: int, port: int,
              instance_uuid: str = '',
              role: str = '',
              zone: str = '') -> InProcessStubReplica:
        kwargs = dict(stub_kwargs)
        kwargs.update(per_replica.get(replica_id, {}))
        kwargs.setdefault('seed', replica_id)
        if instance_uuid:
            kwargs.setdefault('instance_uuid', instance_uuid)
        if role:
            kwargs.setdefault('role', role)
        if zone:
            kwargs.setdefault('zone', zone)
        return InProcessStubReplica(port, **kwargs)

    return spawn


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--port', type=int, default=0)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--page-size', type=int, default=16)
    parser.add_argument('--cache-pages', type=int, default=64)
    parser.add_argument('--token-sleep-ms', type=float, default=1.0)
    parser.add_argument('--die-after-tokens', type=int, default=0)
    parser.add_argument('--role', choices=['', 'prefill', 'decode'],
                        default='')
    parser.add_argument('--zone', default='',
                        help='spot placement label: echoed in /stats '
                             'and matched against zone-scoped '
                             'serve.preempt_notice fault rules')
    parser.add_argument('--no-migrate', action='store_true',
                        help='full-replay A/B arm: a preemption '
                             'kills this stub instead of migrating '
                             'its sessions out')
    parser.add_argument('--prefill-ms-per-token', type=float,
                        default=0.0,
                        help='simulated compute-bound prefill: each '
                             'missed prompt page holds the engine '
                             'lock page_size*this ms (decode tokens '
                             'of other streams wait it out, like the '
                             'real chunked-prefill scheduler)')
    args = parser.parse_args()

    server = make_stub_server(
        args.port, seed=args.seed, page_size=args.page_size,
        cache_pages=args.cache_pages,
        token_sleep_s=args.token_sleep_ms / 1000.0,
        die_after_tokens=args.die_after_tokens, on_die=None,
        role=args.role,
        prefill_ms_per_token=args.prefill_ms_per_token,
        zone=args.zone, migrate=not args.no_migrate)
    state: StubState = server.stub

    def _drain_loop():
        state.begin_evacuation('drain')
        state.draining.set()
        time.sleep(0.2)  # stragglers
        server.shutdown()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            with state.lock:
                if state.inflight == 0:
                    break
            time.sleep(0.02)
        os._exit(0)

    _term = threading.Event()
    threading.Thread(target=lambda: (_term.wait(), _drain_loop()),
                     daemon=True).start()
    signal.signal(signal.SIGTERM, lambda *_: _term.set())

    def _preempt_watch():
        """Spot preemption watcher: an injected zone-scoped notice
        (the decode_zone_storm plan) gives this replica its ~30s
        grace window. Migration arm: evacuate every live session to
        peers, then exit. Full-replay arm (--no-migrate): streams
        break and the process dies, like a kill without notice."""
        while not _term.is_set():
            outcome = None
            try:
                outcome = faults.point('serve.preempt_notice',
                                       zone=args.zone)
            except faults.InjectedFault:
                outcome = faults.DROP
            if outcome is not faults.DROP:
                if _term.wait(0.25):
                    return
                continue
            if args.no_migrate:
                print(f'stub: preemption notice (zone={args.zone}); '
                      f'no-migrate arm — dying.', flush=True)
                state.aborted.set()
                time.sleep(0.5)
                os._exit(1)
            print(f'stub: preemption notice (zone={args.zone}); '
                  f'evacuating sessions to peers.', flush=True)
            state.begin_evacuation('preempt')
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                with state.lock:
                    if state.inflight == 0:
                        break
                time.sleep(0.05)
            os._exit(0)

    if faults.active():
        threading.Thread(target=_preempt_watch,
                         daemon=True).start()
    print(f'stub replica listening on '
          f':{server.server_address[1]} seed={args.seed}', flush=True)
    server.serve_forever()


if __name__ == '__main__':
    main()
