"""Streaming HTTP load balancer for the replica plane (port of
skypilot_tpu/serve/replica_plane/lb.py; its upstream calls go through
`http_client` where the reference's use `requests`).

Routes `/generate*` and `/v1/*` POSTs across the fleet:

  - prefix-cache / session affinity: the request body's chain-key
    hash (inference/affinity.py — the PrefixCache page hash of the
    prompt's first full KV page) is passed to the policy as the
    routing key; under PrefixAffinityPolicy, requests sharing a
    system prompt land on the replica already holding those pages,
    falling back to least-backlog when the target is saturated or
    not ready;
  - retry-on-death: a replica that refuses the connection, drops it
    before responding, or answers 503 (draining / engine dead) gets
    the request retried on another replica — but ONLY while nothing
    has been streamed to the client (once response headers are out,
    a retry would corrupt the stream; the client sees truncation
    instead, bounded to the dead replica's in-flight requests);
  - streaming pass-through: SSE responses are forwarded chunk by
    chunk as they arrive (TTFT through the LB is TTFT of the
    replica, not of the full generation).

Deliberately synchronous (ThreadingHTTPServer + http.client), matching
the replica's own server: one OS thread per in-flight proxied
request is the honest cost model at local-fleet scale, and it keeps
the hot path out of the async-blocking lint's reach by construction.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from skypilot_tpu_torch.inference import affinity
from skypilot_tpu_torch.inference import sse
from skypilot_tpu_torch.observability import catalog as obs_catalog
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.observability.metrics import REGISTRY
from skypilot_tpu_torch.serve.replica_plane import http_client
from skypilot_tpu_torch.utils import ux_utils

#: Hop-by-hop headers never forwarded in either direction.
_HOP_HEADERS = frozenset((
    'connection', 'keep-alive', 'proxy-authenticate',
    'proxy-authorization', 'te', 'trailers', 'transfer-encoding',
    'upgrade', 'host', 'content-length'))

#: Upstream statuses that mean "this replica cannot take the request
#: right now" (draining, engine dead) rather than "the request is
#: bad" — safe to retry elsewhere before anything was streamed.
_RETRYABLE_STATUS = frozenset((502, 503))


class LBMetrics:
    """The LB's instrument bundle (one per policy label)."""

    def __init__(self, policy_name: str) -> None:
        self.routed = obs_catalog.counter(
            'skypilot_lb_requests_routed_total').labels(
                policy=policy_name)
        self.retried = obs_catalog.counter(
            'skypilot_lb_requests_retried_total').labels(
                policy=policy_name)
        self.affinity_requests = obs_catalog.counter(
            'skypilot_lb_affinity_requests_total')
        self.affinity_hits = obs_catalog.counter(
            'skypilot_lb_affinity_hits_total')
        # User-perceived latency, anchored at the FIRST attempt: a
        # retry after a replica death keeps the original clock, so
        # these reflect what the client waited, not the last hop.
        self.ttft_seconds = obs_catalog.histogram(
            'skypilot_lb_ttft_seconds')
        self.request_seconds = obs_catalog.histogram(
            'skypilot_lb_request_seconds')
        # Window counters for /fleet/status (Prometheus children keep
        # lifetime process totals across LB instances; these are THIS
        # LB's, so the bench's affinity ratio is per-run).
        self._lock = threading.Lock()
        self.n_routed = 0
        self.n_retried = 0
        self.n_affinity = 0
        self.n_affinity_hits = 0
        self.routed_per_replica: Dict[str, int] = {}

    def record_routed(self, replica: str) -> None:
        self.routed.inc()
        with self._lock:
            self.n_routed += 1
            self.routed_per_replica[replica] = \
                self.routed_per_replica.get(replica, 0) + 1

    def record_retried(self) -> None:
        self.retried.inc()
        with self._lock:
            self.n_retried += 1

    def record_affinity(self, hit: bool) -> None:
        self.affinity_requests.inc()
        with self._lock:
            self.n_affinity += 1
            if hit:
                self.n_affinity_hits += 1
        if hit:
            self.affinity_hits.inc()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                'routed': self.n_routed,
                'retried': self.n_retried,
                'affinity_requests': self.n_affinity,
                'affinity_hits': self.n_affinity_hits,
                'affinity_hit_ratio': round(
                    self.n_affinity_hits / max(self.n_affinity, 1), 4),
                'routed_per_replica': dict(self.routed_per_replica),
            }


class PrefillPool:
    """The LB's view of the prefill pool (disaggregated serving):
    a round-robin rotation over the prefill-role ready set. Long
    prompts route here; everything else rides the decode-pool policy
    — including long prompts when this pool is empty or exhausted
    (the LB never fails a request because disaggregation is down)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._replicas: list = []
        self._i = 0

    def set_ready_replicas(self, replicas) -> None:
        with self._lock:
            self._replicas = list(replicas)

    @property
    def ready_replicas(self) -> list:
        with self._lock:
            return list(self._replicas)

    def select(self, exclude=None) -> Optional[str]:
        with self._lock:
            cands = [r for r in self._replicas
                     if not exclude or r not in exclude]
            if not cands:
                return None
            self._i += 1
            return cands[self._i % len(cands)]


def merge_migration_stats(views) -> Dict[str, Any]:
    """Fleet-level live-migration rollup for /fleet/status: sum the
    numeric counters (and the per-reason `migrations` dict) scraped
    from every replica's /stats `migration` block. Key lists
    (`migrated_in_keys`) are routing state, not dashboard material —
    skipped."""
    total: Dict[str, Any] = {}
    for view in views:
        part = getattr(view, 'migration', None) or {}
        for key, value in part.items():
            if isinstance(value, dict):
                sub = total.setdefault(key, {})
                for reason, count in value.items():
                    try:
                        sub[reason] = sub.get(reason, 0) + int(count)
                    except (TypeError, ValueError):
                        continue
            elif isinstance(value, (int, float)):
                total[key] = total.get(key, 0) + int(value)
    return total


def estimate_prompt_tokens(path: str, body: Dict[str, Any]) -> int:
    """Request prompt length in tokens, as well as the LB can know
    it: exact for token endpoints, chars/4 for text (the routing
    threshold only needs long-vs-short, not a tokenizer)."""
    try:
        if path in ('/generate', '/v1/generate'):
            rows = body.get('tokens') or []
            if rows and not isinstance(rows[0], list):
                rows = [rows]
            return max((len(r) for r in rows), default=0)
        if path in ('/generate_text', '/v1/generate_text'):
            prompts = body.get('prompts', '')
            if isinstance(prompts, list):
                prompts = max((str(p) for p in prompts), key=len,
                              default='')
            return len(str(prompts)) // 4
        if path == '/v1/completions':
            prompt = body.get('prompt', '')
            if isinstance(prompt, list):
                prompt = max((str(p) for p in prompt), key=len,
                             default='')
            return len(str(prompt)) // 4
        if path == '/v1/chat/completions':
            return sum(len(str(m.get('content', '')))
                       for m in (body.get('messages') or [])) // 4
    except (TypeError, ValueError, AttributeError):
        return 0
    return 0


def make_lb_server(policy, port: int, *, policy_name: str,
                   manager=None, page_size: int = 16,
                   max_retries: int = 2,
                   upstream_timeout_s: float = 660.0,
                   connect_timeout_s: float = 3.0,
                   disagg_threshold: int = 0,
                   prefill_pool: Optional[PrefillPool] = None,
                   trace_sample: float = 0.0,
                   trace_seed: Optional[int] = None,
                   slo_targets: Optional[Dict[str, float]] = None
                   ) -> ThreadingHTTPServer:
    """Build (not yet serving) the LB. `policy` is a
    LoadBalancingPolicy whose ready set the fleet controller keeps
    current; `manager` (optional) feeds the /fleet/status surface.
    The server exposes `.lb_metrics` for the bench harness.

    Disaggregated routing: with `disagg_threshold` > 0 and a
    `prefill_pool`, generation requests whose estimated prompt
    length is >= the threshold route to the prefill pool (whose
    replicas prefill and hand the KV chain to a decode replica);
    shorter requests keep prefix-affinity routing over the decode
    pool — the pool that actually holds the pages."""
    metrics = LBMetrics(policy_name)
    if trace_sample > 0:
        # The LB is the trace head: it makes the sampling decision
        # for headerless requests. Replicas inherit the decision via
        # the propagated header, whatever their own sample rate.
        tracing.configure(sample=trace_sample, seed=trace_seed)
    slo_tracker = None
    if slo_targets:
        from skypilot_tpu_torch.observability import slo as slo_mod
        slo_tracker = slo_mod.SloTracker(slo_targets)

    class Handler(BaseHTTPRequestHandler):
        # Runs on ThreadingHTTPServer worker threads. LB shared state
        # (LBMetrics, PrefillPool, the policy's ready set) is
        # lock-disciplined: many http threads legitimately write it.

        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # -- GET: plane surfaces + pass-through -------------------------
        def do_GET(self):  # noqa: N802
            if self.path == '/readyz':
                ready = bool(policy.ready_replicas)
                self._json({'ready': ready,
                            'reasons': [] if ready
                            else ['no ready replicas']},
                           200 if ready else 503)
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
            if self.path == '/fleet/status':
                views = ([v.to_dict() for v in manager.views()]
                         if manager is not None else [])
                body = {'replicas': views,
                        'policy': policy_name,
                        'lb': metrics.snapshot()}
                if manager is not None:
                    migration = merge_migration_stats(
                        manager.views())
                    if migration:
                        body['migration'] = migration
                if slo_tracker is not None:
                    body['slo'] = slo_tracker.snapshot()
                if disagg_threshold > 0:
                    body['disagg'] = {
                        'prompt_threshold': disagg_threshold,
                        'prefill_pool':
                            (prefill_pool.ready_replicas
                             if prefill_pool is not None else []),
                    }
                self._json(body)
                return
            if self.path == '/metrics':
                body = REGISTRY.render().encode()
                self.send_response(200)
                self.send_header('Content-Type',
                                 REGISTRY.CONTENT_TYPE)
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            # Anything else (/, /stats, /v1/models): pass through to
            # one ready replica — fleet replicas are homogeneous.
            self._proxy(body_bytes=None, key=None)

        # -- POST: routed generation requests ---------------------------
        def do_POST(self):  # noqa: N802
            length = int(self.headers.get('Content-Length', 0))
            body_bytes = self.rfile.read(length) if length else b''
            key = None
            try:
                parsed = json.loads(body_bytes) if body_bytes else {}
            except ValueError:
                parsed = None  # replica's 400 to give; route keyless
            long_prompt = False
            if isinstance(parsed, dict):
                key = affinity.request_affinity_key(
                    self.path, parsed, page_size=page_size)
                if disagg_threshold > 0 and prefill_pool is not None:
                    long_prompt = estimate_prompt_tokens(
                        self.path, parsed) >= disagg_threshold
            self._proxy(body_bytes=body_bytes, key=key,
                        long_prompt=long_prompt)

        def _proxy(self, body_bytes: Optional[bytes],
                   key: Optional[str],
                   long_prompt: bool = False) -> None:
            # First-attempt anchor: every retry after a replica death
            # keeps this clock, so LB-side TTFT/latency is what the
            # CLIENT waited, not the last attempt's slice of it.
            t0 = time.monotonic()
            ctx = tracing.parse_header(
                self.headers.get(tracing.HEADER))
            if ctx is None:
                ctx = tracing.new_ctx()
            root = tracing.start_span('lb.request', ctx,
                                      process='lb', path=self.path)
            status: Optional[int] = None
            ttft_s: Optional[float] = None
            try:
                tried = set()
                for attempt in range(max_retries + 1):
                    from_prefill = False
                    replica = None
                    with tracing.span('lb.route', root.ctx,
                                      process='lb') as route_span:
                        if long_prompt and prefill_pool is not None:
                            # Long prompts go to the prefill pool
                            # (their replicas hand the KV chain to
                            # the decode pool); an empty/exhausted
                            # pool falls back to normal decode
                            # routing — disaggregation being down
                            # degrades, it never 5xxes.
                            replica = prefill_pool.select(
                                exclude=tried)
                            from_prefill = replica is not None
                        if replica is None:
                            replica = policy.select_replica(
                                key=key, exclude=tried)
                        route_span.add(attempt=attempt,
                                       replica=replica or '',
                                       prefill=from_prefill)
                    if replica is None:
                        status = 503
                        self._json({'error': 'no ready replicas'},
                                   503)
                        return
                    if attempt == 0 and key is not None and \
                            not from_prefill and \
                            hasattr(policy, 'affinity_target'):
                        target = policy.affinity_target(key)
                        metrics.record_affinity(hit=replica == target)
                    metrics.record_routed(replica)
                    try:
                        done, status, ttft_s = self._forward(
                            replica, body_bytes, t0, root)
                    finally:
                        if not from_prefill:
                            policy.request_done(replica)
                    if done:
                        root.add(replica=replica,
                                 attempts=attempt + 1)
                        return
                    # Not-yet-streamed failure: retry elsewhere.
                    tried.add(replica)
                    metrics.record_retried()
                    ux_utils.log(f'LB: replica {replica} failed '
                                 f'before streaming; retrying '
                                 f'({attempt + 1}/{max_retries}).')
                status = 502
                self._json({'error': 'all replicas failed'}, 502)
            finally:
                root.end(status=status if status is not None else -1)
                if body_bytes is not None:
                    # Routed generation POSTs only — GET pass-through
                    # would pollute the latency distributions.
                    metrics.request_seconds.observe(
                        time.monotonic() - t0)
                    if ttft_s is not None:
                        metrics.ttft_seconds.observe(ttft_s)
                    if slo_tracker is not None:
                        slo_tracker.record_request(
                            error=(status is None or status >= 500),
                            shed=(status == 429),
                            ttft_ms=(ttft_s * 1000.0
                                     if ttft_s is not None else None))

        def _forward(self, replica: str,
                     body_bytes: Optional[bytes], t0: float, root
                     ) -> tuple:
            """Proxy one attempt. Returns (done, status, ttft_s):
            done = the client got an answer (including a truncated
            stream — headers are out) so no retry; status is the
            upstream code when one arrived; ttft_s is first response
            byte relative to `t0` (the FIRST attempt's start)."""
            url = f'http://{replica}{self.path}'
            headers = {k: v for k, v in self.headers.items()
                       if k.lower() not in _HOP_HEADERS}
            if root.ctx is not None:
                headers[tracing.HEADER] = tracing.format_header(
                    root.ctx)
            try:
                upstream = http_client.request(
                    'GET' if body_bytes is None else 'POST', url,
                    body=body_bytes, headers=headers,
                    timeout=(connect_timeout_s, upstream_timeout_s))
            except http_client.ERRORS as e:
                ux_utils.log(f'LB: upstream {replica} unreachable '
                             f'({type(e).__name__}: {e}).')
                return False, None, None
            with upstream:
                if upstream.status_code in _RETRYABLE_STATUS:
                    return False, upstream.status_code, None
                is_stream = 'text/event-stream' in \
                    upstream.headers.get('Content-Type', '')
                if not is_stream:
                    try:
                        content = upstream.read()
                    except http_client.ERRORS as e:
                        ux_utils.log(f'LB: upstream {replica} died '
                                     f'mid-response ({e}).')
                        return False, None, None
                    ttft_s = time.monotonic() - t0
                    self.send_response(upstream.status_code)
                    for k, v in upstream.headers.items():
                        if k.lower() not in _HOP_HEADERS:
                            self.send_header(k, v)
                    self.send_header('Content-Length',
                                     str(len(content)))
                    self.end_headers()
                    self.wfile.write(content)
                    return True, upstream.status_code, ttft_s
                # SSE: headers out first, then bytes as they ARRIVE
                # (sse.pipe reads what the socket holds: buffering to
                # EOF would flatten TTFT/ITL through the LB).
                self.send_response(upstream.status_code)
                for k, v in upstream.headers.items():
                    if k.lower() not in _HOP_HEADERS:
                        self.send_header(k, v)
                self.end_headers()
                eof, first_at = sse.pipe(upstream, self.wfile)
                if not eof:
                    # Mid-stream replica death: the stream truncates
                    # (bounded blast radius — exactly the in-flight
                    # requests of the dead replica); never re-spliced.
                    ux_utils.log(f'LB: stream from {replica} '
                                 f'truncated.')
                ttft_s = (first_at - t0
                          if first_at is not None else None)
                return True, upstream.status_code, ttft_s

    server = ThreadingHTTPServer(('0.0.0.0', port), Handler)
    server.lb_metrics = metrics  # type: ignore[attr-defined]
    server.slo_tracker = slo_tracker  # type: ignore[attr-defined]
    return server
