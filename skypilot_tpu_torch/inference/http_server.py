"""HTTP front of the port's inference runtime (port of
skypilot_tpu/inference/http_server.py `make_server` / `serve`):

  GET  /                       readiness + capacity
  GET  /healthz                liveness
  GET  /readyz                 readiness (503 while draining, engine
                               dead or queue saturated, with reasons)
  GET  /stats                  the reference's body (serving
                               percentiles, storage, page_pool, the
                               engine's counters top-level, adapters,
                               slo under --slo), plus the port's
                               kernel launch counts (paged_attention,
                               qkv_lora), engine_stats, device, zone
                               and model
  GET  /metrics, /v1/metrics   Prometheus text exposition 0.0.4 of the
                               process registry (observability/
                               catalog.py); snapshot gauges refresh
                               from the engines first
  GET  /debug/trace/<id>       the spans this process recorded for a
                               trace, as Chrome-trace JSON (404 with
                               the `known` ids otherwise)
  GET  /debug/flight           every live engine's flight-recorder
                               dump
  GET  /v1/models              the base model plus the adapters
  POST /generate               token ids in/out ({"tokens": [[...]],
                               "max_new_tokens", "temperature",
                               "top_k", "top_p", "stop_token_ids",
                               "timeout", "model"}); `stream` = SSE
                               of {"index", "token"} events, then
                               {"done": true, "tokens": rows}
  POST /generate_text          text in/out through the --hf
                               tokenizer; `stream` = SSE of
                               {"index", "delta"} events
  POST /v1/completions         OpenAI completions: text prompts
                               (stop, n, stream, logprobs, echo), or
                               token-id prompts (each choice then
                               carries its ids in "tokens")
  POST /v1/chat/completions    OpenAI chat (+SSE, n > 1)
  POST /kv/import              decode side of a handoff: a packed KV
                               chain ({"payload": base64}), and
                               optionally the request to serve on it
                               ({"path", "request"})
  POST /kv/peers               the fleet's push of the decode pool
                               ({"decode": ["host:port", ...]})
  POST /kv/evacuate            evacuate the sessions ({"reason",
                               "target", "max_sessions"}); their HTTP
                               threads ship the chains to a peer
  POST /kv/migrate             receiving side of a live migration

The `model` field selects a LoRA adapter by name (the base model's
name, 'base', 'default' or no field = the base model); an unknown
model is a 404 (OpenAI code `model_not_found`), an adapter that fails
to load a 503. SSE streams end with `data: [DONE]`; a client that
disconnects mid-stream cancels its rows, freeing their slots. Without
--continuous-batching, /generate and the text endpoints run the
one-shot engine; streams and adapter requests run on the runtime's
stream engine.

Disaggregated serving and live migration (the reference's contract):
a prefill-role replica prefills each single-row /generate prompt with
one local token, exports the prompt's KV chain, POSTs it with the
request to the decode peer the ring picks, and proxies the answer
(JSON body or SSE tail); any failure serves the request locally from
the warm pages. An evacuated session (POST /kv/evacuate, SIGTERM or a
preemption notice) ships its committed chain and the continuation to a
peer's /kv/migrate and proxies the tail; a failed ship resumes locally.
Peer POSTs go through http.client (connect timeout 3 s, read timeout
the request deadline + 60 s); 429, 500, 502 and 503 fail a handoff.

Tracing and chaos (the reference's): every POST first runs the
`http.handler` fault point, then adopts the `x-skypilot-trace` header
(or takes the head-sampling decision) and, when traced, runs under a
`replica.request` span whose context the engine spans and the
`kv.export` / `kv.post` / `kv.import` / `kv.migrate` spans parent to;
handoff and migration POSTs forward the header, so one trace id
crosses the prefill and decode replicas.
"""
from __future__ import annotations

import base64
import binascii
import http.client
import json
import os
import re
import signal
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Tuple

from skypilot_tpu_torch.errors import (AdapterLoadError,
                                       AdapterNotFoundError,
                                       DeadlineExceededError,
                                       EngineDeadError, QueueSaturatedError,
                                       SessionMigratedError)
from skypilot_tpu_torch.inference import affinity, sse
from skypilot_tpu_torch.inference import openai_compat as oai
from skypilot_tpu_torch.inference.runtime import (InferenceRuntime,
                                                  iter_interleaved)
from skypilot_tpu_torch.observability import catalog as obs_catalog
from skypilot_tpu_torch.observability import tracing
from skypilot_tpu_torch.observability.metrics import REGISTRY
from skypilot_tpu_torch.ops import lora_kernel, paged_kernel
from skypilot_tpu_torch.robustness import faults, train_guard


#: The environment variable through which the replica plane hands a
#: spawned replica its instance identity (the reference's
#: replica_manager.INSTANCE_UUID_ENV).
INSTANCE_UUID_ENV = 'STPU_REPLICA_INSTANCE_UUID'
#: This process's replica identity, echoed in `GET /stats`: the manager
#: adopts a journaled pid/port after a restart only if the echo matches.
#: A standalone server mints its own.
INSTANCE_UUID = os.environ.get(INSTANCE_UUID_ENV) or uuid.uuid4().hex


def classify_error(e: Exception):
    """(http_status, retry_after_s) for a request-path exception."""
    if isinstance(e, QueueSaturatedError):
        return 429, e.retry_after_s
    if isinstance(e, DeadlineExceededError):
        return 504, None
    if isinstance(e, SessionMigratedError):
        # The peer ship and the local resume both failed: 503 is
        # retryable, so the load balancer resubmits elsewhere.
        return 503, 0.5
    if isinstance(e, (EngineDeadError, AdapterLoadError)):
        return 503, None
    if isinstance(e, AdapterNotFoundError):
        return 404, None
    return 400, None


def _submit_all(engine, rows: List[List[int]], **kw):
    """Submit one request's rows; if submission k is shed, cancel the
    k-1 already submitted (they would decode for a client getting a
    429)."""
    futs = []
    try:
        for row in rows:
            futs.append(engine.submit(row, **kw))
    except Exception:
        if futs:
            engine.cancel(futs)
        raise
    return futs


def _run_rows(rt: InferenceRuntime, rows: List[List[int]], *,
              max_new: int, temperature: float, top_k: int, top_p: float,
              stop_ids: List[int], deadline_s: float,
              adapter: Optional[str],
              resume: Callable[[dict], List[int]],
              trace_ctx: Optional[tracing.Ctx] = None
              ) -> Tuple[List[List[int]], Optional[float]]:
    """(rows of prompt ++ generated, TTFT) of ragged rows: on the
    engine that serves them, or each alone through the one-shot
    buckets (no TTFT then). A row whose slot was evacuated is finished
    by `resume(record)` (on a peer, or locally on the warm pages).
    `trace_ctx` parents the rows' engine spans."""
    eng = rt.engine_for(adapter)
    if eng is None:
        return rt.one_shot_rows(rows, max_new, temperature), None
    latch = obs_catalog.FirstTokenLatch()
    futs = _submit_all(eng, rows, max_new_tokens=max_new,
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       stop_token_ids=stop_ids, on_token=latch,
                       deadline_s=deadline_s, adapter=adapter,
                       trace_ctx=trace_ctx)
    # The engine reaps expired requests; the host timeout is a backstop.
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=deadline_s + 30.0))
        except SessionMigratedError as me:
            out.append(resume(me.record))
    return out, latch.first_token_s


#: Peer POSTs (handoff, migration): the reference's connect timeout.
PEER_CONNECT_TIMEOUT_S = 3.0
#: Decode-peer answers that fail a handoff (the request then serves
#: locally).
HANDOFF_REFUSED = (429, 500, 502, 503)


def chain_body(data: Optional[bytes], rest: dict) -> bytes:
    """`json.dumps({'payload': base64(data), **rest})`, byte for byte
    (the reference's /kv/import and /kv/migrate bodies), spliced around
    the base64 payload: JSON-encoding a chain's ~350 MB string takes
    seconds, and base64 needs no escaping. No data: no payload key."""
    if not data:
        return json.dumps(rest).encode()
    tail = json.dumps(rest).encode()
    return b''.join([b'{"payload": "',
                     binascii.b2a_base64(data, newline=False),
                     b'", ' + tail[1:] if rest else b'"}'])


_PAYLOAD_KEY = re.compile(rb'"payload"\s*:\s*"')


def split_chain_body(body: bytes) -> Tuple[dict, bytes]:
    """Inverse of `chain_body` for any JSON object: (the object without
    its payload, the decoded payload, b'' when absent). The payload is
    cut out of the raw body (base64 holds no quote) and decoded from
    bytes; the rest must parse with the payload's value emptied, else
    the whole body is parsed."""
    m = _PAYLOAD_KEY.search(body)
    if m is not None:
        end = body.find(b'"', m.end())
        if end >= 0:
            try:
                rest = json.loads(body[:m.end()] + body[end:])
            except ValueError:
                rest = None
            if isinstance(rest, dict) and rest.get('payload') == '':
                rest.pop('payload')
                return rest, binascii.a2b_base64(
                    memoryview(body)[m.end():end])
    req = json.loads(body)
    payload = req.pop('payload', None) if isinstance(req, dict) else None
    return req, base64.b64decode(payload) if payload else b''


def post_peer(peer: str, path: str, body: bytes, read_timeout: float,
              trace_ctx: Optional[tracing.Ctx] = None
              ) -> http.client.HTTPResponse:
    """POST the JSON `body` to http://`peer``path` and return the open
    response (headers read, body not; a response that closes the
    connection takes its socket over): the connection gets
    PEER_CONNECT_TIMEOUT_S, every later read `read_timeout`. A traced
    request forwards its context in the trace header."""
    host, _, port = peer.rpartition(':')
    conn = http.client.HTTPConnection(host, int(port),
                                      timeout=PEER_CONNECT_TIMEOUT_S)
    headers = {'Content-Type': 'application/json'}
    if trace_ctx is not None:
        headers[tracing.HEADER] = tracing.format_header(trace_ctx)
    try:
        conn.connect()
        conn.sock.settimeout(read_timeout)
        conn.request('POST', path, body=body, headers=headers)
        return conn.getresponse()
    except BaseException:
        conn.close()
        raise


def _token_rows(value, field: str) -> List[List[int]]:
    if not isinstance(value, list) or not value:
        raise ValueError(f'{field} must be a non-empty list of token ids '
                         f'(or of such lists)')
    rows = value if isinstance(value[0], list) else [value]
    return [[int(t) for t in row] for row in rows]


def _is_token_prompt(prompt) -> bool:
    return isinstance(prompt, list) and bool(prompt) and isinstance(
        prompt[0], (int, list))


def make_server(rt: InferenceRuntime, port: int) -> ThreadingHTTPServer:
    """Build the (not yet serving) HTTP server for `rt`; tests run it
    on an ephemeral port from a thread. The in-flight POST count rides
    on the server as `.inflight` / `.inflight_lock`, the drain flag as
    `.draining`."""
    inflight = {'n': 0}
    inflight_lock = threading.Lock()
    draining = threading.Event()

    class Handler(BaseHTTPRequestHandler):

        def log_message(self, *a):  # quiet
            pass

        # -- writer surface (also used by openai_compat) ----------------
        def _json(self, obj, code=200, headers=None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def sse_start(self):
            self.send_response(200)
            self.send_header('Content-Type', 'text/event-stream')
            self.send_header('Cache-Control', 'no-cache')
            self.send_header('Connection', 'close')
            self.end_headers()
            self._sse_open = True

        def sse_send(self, obj):
            self.wfile.write(b'data: ' + json.dumps(obj).encode() +
                             b'\n\n')
            self.wfile.flush()

        def sse_done(self):
            self.wfile.write(b'data: [DONE]\n\n')
            self.wfile.flush()

        def _accounted(self, e: Exception):
            """(code, headers) of a failed request, with the shed and
            deadline counters (windows and series); a 503 (engine dead,
            adapter load failure) burns SLO error budget, a client error
            does not."""
            code, retry_after = classify_error(e)
            if code == 429:
                rt.metrics.record_shed()
            elif code == 504:
                rt.metrics.record_deadline_exceeded()
            elif code == 503 and rt.metrics.slo is not None:
                rt.metrics.slo.record_request(error=True)
            headers = ({'Retry-After': str(max(1, int(retry_after)))}
                       if retry_after is not None else None)
            return code, headers

        def _close_stream(self) -> bool:
            """Mid-stream failure: the headers are out, so end the
            stream (the client sees it truncated). False when no
            stream is open."""
            if not self._sse_open:
                return False
            try:
                self.sse_done()
            except OSError:   # the client is gone
                pass
            return True

        def _plain_error(self, e: Exception):
            code, headers = self._accounted(e)
            if not self._close_stream():
                self._json({'error': f'{type(e).__name__}: {e}'}, code,
                           headers=headers)

        def _oai_error(self, e: Exception):
            code, headers = self._accounted(e)
            if self._close_stream():
                return
            err = {'message': f'{type(e).__name__}: {e}',
                   'type': {429: 'rate_limit_exceeded',
                            503: 'service_unavailable',
                            504: 'timeout'}.get(code,
                                                'invalid_request_error')}
            if code == 404:
                err['code'] = 'model_not_found'
            self._json({'error': err}, code, headers=headers)

        # -- GET ----------------------------------------------------------
        def do_GET(self):  # noqa: N802
            if self.path == '/healthz':
                self._json({'status': 'alive'})
            elif self.path == '/readyz':
                reasons = []
                if draining.is_set():
                    reasons.append('draining')
                for eng in rt.live_engines():
                    if not eng.healthy():
                        reasons.append('engine dead')
                    if eng.saturated():
                        reasons.append('queue saturated')
                self._json({'ready': not reasons, 'reasons': reasons},
                           200 if not reasons else 503)
            elif self.path in ('/stats', '/v1/stats'):
                self._json(self._stats())
            elif self.path in ('/metrics', '/v1/metrics'):
                self._prometheus_metrics()
            elif self.path.startswith('/debug/trace/'):
                trace_id = self.path[len('/debug/trace/'):].strip('/')
                body = tracing.get_trace(trace_id)
                if body is None:
                    self._json({'error': f'unknown trace {trace_id!r}',
                                'known': tracing.trace_ids()[-16:]}, 404)
                else:
                    self._json(body)
            elif self.path == '/debug/flight':
                # The last scheduler events of every live engine: the
                # post-mortem readout when a replica wedges or dies.
                self._json({'instance_uuid': INSTANCE_UUID,
                            'pid': os.getpid(), 'role': rt.role,
                            'engines': [eng.flight.dump()
                                        for eng in rt.live_engines()]})
            elif self.path == '/v1/models':
                names = [rt.model_name]
                if rt.adapters is not None:
                    names += rt.adapters.inventory()
                self._json({'object': 'list',
                            'data': [{'id': name, 'object': 'model',
                                      'owned_by': 'skypilot-tpu'}
                                     for name in names]})
            elif self.path == '/':
                # The smallest capacity across request classes, so a
                # client sizing prompts by it is never refused.
                self._json({'status': 'ok', 'model': rt.model_name,
                            'vocab_size': rt.vocab_size,
                            'max_total_len': min(rt.limit_for(0.0),
                                                 rt.limit_for(1.0))})
            else:
                self._json({'error': f'GET {self.path} is not served '
                                     f'by this port'}, 404)

        def _prometheus_metrics(self):
            """Text exposition of the process registry. The snapshot
            gauges (queue depth, slots, page pool) refresh from live
            engine state first; counters and histograms tick at their
            event sites."""
            for eng in rt.live_engines():
                eng.update_metric_gauges()
            body = REGISTRY.render().encode()
            self.send_response(200)
            self.send_header('Content-Type', REGISTRY.CONTENT_TYPE)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stats(self):
            """The reference's /stats body, key for key (serving window
            percentiles, storage, the engine's counters top-level,
            page_pool, prefix_cache, kv_spill, handoff, migration,
            adapters, slo), plus the port's own keys: the kernels'
            launch counts, the engine's full stats() dict, the device,
            the zone and the model name."""
            body = {
                'serving': rt.metrics.snapshot(),
                'instance_uuid': INSTANCE_UUID,
                'pid': os.getpid(),
                # Disaggregated serving: '' = a unified replica.
                'role': rt.role,
                'storage': {
                    'kv_dtype': rt.kv_dtype,
                    'weight_dtype': rt.weight_dtype,
                    'weight_bytes': rt.weight_bytes,
                    'mesh_devices': rt.mesh_devices,
                    'stages': rt.stages,
                    # Why the CUDA kernel cannot run here, or None.
                    'attention_kernel_unavailable_reason':
                        paged_kernel.unavailable_reason(),
                },
                'model': rt.model_name,
                'device': str(rt.model.device),
                'zone': rt.zone,
                'paged_attention': {
                    'kernel_launches': paged_kernel.launches,
                    'plain_calls': paged_kernel.plain_calls,
                    'routes': dict(paged_kernel.route_launches)},
                'qkv_lora': {'kernel_launches': lora_kernel.launches,
                             'plain_calls': lora_kernel.plain_calls},
            }
            if rt.role or rt.handoffs_total or rt.kv_imports_total:
                body['handoff'] = rt.handoff_stats()
            mig = rt.migration_stats()
            if mig['sessions_evacuated'] or mig['migrations'] or \
                    mig['migrations_in']:
                # Out / in counts, recompute cost, and the migrated-in
                # affinity keys the fleet pins at the load balancer.
                body['migration'] = mig
            if rt.adapters is not None:
                body['adapters'] = rt.adapters.stats()
            if rt.slo_tracker is not None:
                body['slo'] = rt.slo_tracker.snapshot()
            eng = rt.engine
            if eng is None:
                # One-shot mode; the stream engine, once built, serves
                # streamed and adapter requests. The fleet's scrape keys
                # come from it.
                live = rt.live_engines()
                body.update({
                    'engine': 'simple',
                    'queued': sum(e.queued_requests() for e in live),
                    'prefill_backlog_tokens': sum(
                        e.prefill_backlog_tokens() for e in live),
                    'requests_shed': sum(e.requests_shed for e in live),
                    'healthy': all(e.healthy() for e in live)})
                return body
            eng.update_metric_gauges()
            body.update({
                'engine': 'continuous',
                'num_slots': eng.num_slots,
                'active_slots': int(eng.active.sum()),
                'queued': eng.queued_requests(),
                'decode_calls': eng.decode_calls,
                'tokens_committed': eng.tokens_committed,
                'tokens_per_call': round(
                    eng.tokens_committed / max(eng.decode_calls, 1), 3),
                'speculative_k': eng.spec_k,
                'preemptions': eng.preemptions,
                'prefill_chunk': eng.prefill_chunk,
                'prefill_token_budget': eng.prefill_budget,
                'pipeline_decode': eng.pipeline_decode,
                'prefill_chunks_run': eng.prefill_chunks_run,
                'prefill_backlog_tokens': eng.prefill_backlog_tokens(),
                'decode_stall_s': round(eng.decode_stall_s, 4),
                # Pipeline stages and the last prefill pass's
                # fill/drain bubble over them.
                'pipeline_stages': eng.stages,
                'prefill_bubble_fraction': round(
                    eng.prefill_bubble_fraction, 6),
                # The kernel route and the analytic roofline inputs.
                'attention_impl': eng.attention_impl(),
                'attention_bytes_per_token':
                    eng.attention_bytes_per_token(),
                'healthy': eng.healthy(),
                'requests_shed': eng.requests_shed,
                'deadline_exceeded': eng.deadline_exceeded,
                'engine_restarts': eng.engine_restarts,
                'queued_tokens': eng.queued_tokens(),
                'max_queue_requests': eng.max_queue_requests,
                'max_queue_tokens': eng.max_queue_tokens,
                'engine_stats': eng.stats(),
            })
            if eng.paged:
                # A dense engine has no page pool (nor the reference's
                # block for one).
                free = int(eng.allocator.free_pages)
                body['page_pool'] = {
                    'total': eng.total_pages,
                    'free': free,
                    'used': eng.total_pages - free,
                    'utilization': round((eng.total_pages - free) /
                                         max(eng.total_pages, 1), 3),
                    'kv_dtype': eng.kv_dtype,
                    'pool_bytes': eng.kv_cache_bytes(),
                    'pool_bytes_per_device': eng.kv_cache_bytes_per_device(),
                    'shard_ways': eng.kv_shard_ways,
                }
                if eng.stages > 1:
                    body['page_pool']['stages'] = eng.stage_pool_stats()
            pc = eng.prefix_cache
            if pc is not None:
                body['prefix_cache'] = {
                    'hits': pc.hits, 'misses': pc.misses,
                    'hit_rate': round(pc.hits / max(pc.hits + pc.misses,
                                                    1), 3),
                    'evictions': pc.evictions,
                    'resident_unreferenced': len(pc.lru)}
            if eng.spill_tier is not None:
                # The tier's own accounting and the engine-level restore
                # outcome.
                spill = eng.spill_tier.stats()
                spill.update({'restore_lookups': eng.kv_restore_lookups,
                              'restore_hits': eng.kv_restore_hits,
                              'restored_into_pool': eng.kv_restored_pages})
                body['kv_spill'] = spill
            return body

        # -- POST ---------------------------------------------------------
        def do_POST(self):  # noqa: N802
            self._sse_open = False
            self._injected_body = None
            self._body_error = None
            self._trace_ctx = None
            with inflight_lock:
                inflight['n'] += 1
            try:
                self._do_post()
            finally:
                with inflight_lock:
                    inflight['n'] -= 1

        def _do_post(self):
            if faults.point('http.handler') is faults.DROP:
                return   # an injected blackhole: the client sees a reset
            # Adopt the caller's trace (a load balancer or a prefill peer
            # sent the header) or take the head-sampling decision here;
            # an unsampled request costs one float compare.
            ctx = tracing.parse_header(self.headers.get(tracing.HEADER))
            if ctx is None:
                ctx = tracing.new_ctx()
            if ctx is None:
                self._dispatch_post()
                return
            with tracing.span('replica.request', ctx,
                              process=rt.role or 'replica',
                              path=self.path) as root:
                # Engine and handoff spans parent to this request root.
                self._trace_ctx = root.ctx
                self._dispatch_post()

        def _read_body(self):
            # The handoff paths re-dispatch a body already read (or an
            # embedded request) into the normal handlers.
            if self._body_error is not None:
                raise self._body_error
            injected = self._injected_body
            if injected is not None:
                self._injected_body = None
                return injected
            return json.loads(self._read_raw())

        def _read_raw(self) -> bytes:
            return self.rfile.read(int(self.headers.get('Content-Length',
                                                        0)))

        def _route_generation(self, path):
            """The generation handler of `path`, or None: shared by the
            POST dispatch and the /kv/import and /kv/migrate embedded
            requests."""
            return {
                '/generate': self._generate,
                '/v1/generate': self._generate,
                '/generate_text': self._generate_text,
                '/v1/generate_text': self._generate_text,
                '/v1/completions': self._openai_completions,
                '/v1/chat/completions': self._openai_chat,
            }.get(path)

        def _dispatch_post(self):
            kv = {'/kv/import': self._kv_import,
                  '/kv/peers': self._kv_peers,
                  '/kv/evacuate': self._kv_evacuate,
                  '/kv/migrate': self._kv_migrate}.get(self.path)
            if kv is not None:
                kv()
                return
            handler = self._route_generation(self.path)
            if handler is None:
                self._json({'error': 'POST /generate, /generate_text, '
                                     'or /v1/completions'}, 404)
                return
            if rt.role == 'prefill':
                try:
                    body = self._read_body()
                except (ValueError, OSError) as e:
                    # Malformed: the handler's 400 to give.
                    self._body_error = e
                    body = None
                if body is not None:
                    if self._maybe_handoff(self.path, body):
                        return
                    self._injected_body = body
            handler()

        def _serve_embedded(self, req, what: str):
            """Serve the request a /kv/import or /kv/migrate body
            embeds ({"path", "request"}) through its handler."""
            inner_path = str(req.get('path') or '/generate')
            handler = self._route_generation(inner_path)
            if handler is None:
                self._json({'error': f'unroutable {what} path '
                                     f'{inner_path!r}'}, 400)
                return
            self.path = inner_path
            self._injected_body = req['request']
            handler()

        # -- disaggregated prefill / decode handoff -----------------------
        def _kv_peers(self):
            """The fleet controller's push of the decode pool this
            prefill replica hands off to."""
            try:
                req = self._read_body()
                peers = [str(p) for p in (req.get('decode') or [])]
                rt.set_decode_peers(peers)
                self._json({'decode': peers})
            except Exception as e:  # pylint: disable=broad-except
                self._json({'error': f'{type(e).__name__}: {e}'}, 400)

        def _kv_import(self):
            """Decode side of a handoff: scatter the POSTed chain into
            the pool and prefix cache, and serve the embedded request
            (if any) at once: its admission finds every full prompt
            page resident, so only the sub-page tail prefills."""
            try:
                req, data = split_chain_body(self._read_raw())
                with tracing.span('kv.import', self._trace_ctx,
                                  bytes=len(data)):
                    summary = rt.stream_engine().import_chain(data)
                rt.record_kv_import(summary)
            except Exception as e:  # pylint: disable=broad-except
                self._plain_error(e)
                return
            if not req.get('request'):
                self._json({'imported': summary})
                return
            self._serve_embedded(req, 'handoff')

        def _maybe_handoff(self, path, req) -> bool:
            """Prefill role: prefill the prompt locally (one generated
            token promotes its full pages into the prefix cache), export
            the chain, POST it with the request to the ring's decode
            peer and proxy the answer. True = the client was answered
            from the decode pool. Any failure (an injected kv.handoff
            fault, an unreachable peer, a peer's 429/500/502/503)
            returns False, and the request serves locally from the
            warm pages."""
            peers = rt.decode_peers()
            eng = rt.engine
            if not peers or eng is None or not eng.prefix_caching:
                return False
            if path not in ('/generate', '/v1/generate'):
                # Text endpoints have no token ids here: they serve
                # locally on the prefill replica.
                return False
            rows = req.get('tokens') or []
            if not rows or not isinstance(rows[0], list) or len(rows) != 1:
                return False   # batch rows: local (no chain per row)
            ctx = self._trace_ctx
            t0 = time.monotonic()
            nbytes = 0
            try:
                if faults.point('kv.handoff') is faults.DROP:
                    raise RuntimeError('injected kv.handoff drop')
                row = [int(t) for t in rows[0]]
                adapter = rt.resolve_model(req.get('model'))
                deadline_s = rt.deadline_for(req)
                if len(row) >= rt.limit_for(0.0, streaming=True):
                    return False   # the handler's 400 to give
                eng.submit(row, max_new_tokens=1, temperature=0.0,
                           deadline_s=deadline_s, adapter=adapter,
                           trace_ctx=ctx).result(timeout=deadline_s + 30.0)
                with tracing.span('kv.export', ctx) as sp:
                    data = eng.export_chain(row, adapter=adapter)
                    sp.add(bytes=len(data) if data else 0)
                if not data:
                    return False   # a sub-page prompt: nothing to ship
                key = affinity.token_affinity_key(
                    row, eng.page_size,
                    salt=affinity.adapter_salt(req.get('model')))
                peer = rt.pick_decode_peer(key)
                if peer is None:
                    return False
                nbytes = len(data)
                # The trace rides the handoff: the decode peer's root
                # span adopts this trace id.
                with tracing.span('kv.post', ctx, peer=peer, bytes=nbytes):
                    upstream = post_peer(
                        peer, '/kv/import',
                        chain_body(data, {'path': path, 'request': req}),
                        read_timeout=deadline_s + 60.0, trace_ctx=ctx)
                if upstream.status in HANDOFF_REFUSED:
                    code = upstream.status
                    upstream.close()
                    raise RuntimeError(f'decode replica {peer} answered '
                                       f'{code}')
            except Exception as e:  # pylint: disable=broad-except
                rt.record_handoff(time.monotonic() - t0, nbytes, ok=False)
                print(f'kv handoff failed ({type(e).__name__}: {e}); '
                      f'serving locally', flush=True)
                return False
            # Headers out = the handoff is committed: a mid-stream death
            # truncates as a direct replica death would.
            rt.record_handoff(time.monotonic() - t0, nbytes, ok=True)
            with upstream:
                self.send_response(upstream.status)
                ctype = upstream.getheader('Content-Type',
                                           'application/json')
                self.send_header('Content-Type', ctype)
                body_bytes = None
                if 'text/event-stream' not in ctype:
                    body_bytes = upstream.read()
                    self.send_header('Content-Length', str(len(body_bytes)))
                self.end_headers()
                if body_bytes is not None:
                    self.wfile.write(body_bytes)
                    return True
                self._sse_open = True
                eof, _first = sse.pipe(upstream, self.wfile)
                if not eof:
                    print('kv handoff stream truncated', flush=True)
            return True

        # -- live KV-chain migration --------------------------------------
        def _kv_evacuate(self):
            """Controller-initiated evacuation: a scale-down drain POSTs
            {reason: 'drain'} before SIGTERM, a rebalance {reason:
            'rebalance', target, max_sessions}. Every evacuated
            session's future resolves with SessionMigratedError and its
            HTTP thread ships the chain (to `target`, else the ring's
            pick); this answers with the counts at once."""
            try:
                req = self._read_body()
            except (ValueError, OSError):
                req = {}
            reason = str(req.get('reason') or 'drain')
            max_sessions = req.get('max_sessions')
            if max_sessions is not None:
                max_sessions = int(max_sessions)
            rt.set_evacuation_hint(reason, req.get('target') or None)
            total = {'evacuated': 0, 'chains': 0, 'queued': 0}
            try:
                for eng in rt.live_engines():
                    got = eng.evacuate_chains(max_sessions=max_sessions,
                                              reason=reason)
                    for k in total:
                        total[k] += int(got.get(k, 0))
                rt.record_evacuation(total)
            except Exception as e:  # pylint: disable=broad-except
                self._json({'error': f'{type(e).__name__}: {e}'}, 500)
                return
            self._json(dict(total, reason=reason))

        def _kv_migrate(self):
            """Receiving side of a live migration: import the committed
            chain (when one shipped), count the recompute and the
            session's affinity key, then serve the continuation:
            admission finds the committed full pages resident, so only
            the sub-page tail prefills."""
            try:
                req, data = split_chain_body(self._read_raw())
                inner = req.get('request') or {}
                rows = inner.get('tokens') or []
                row = ([int(t) for t in rows[0]]
                       if rows and isinstance(rows[0], list) else [])
                eng = rt.stream_engine()
                summary = {'pages': 0, 'imported': 0, 'already_cached': 0,
                           'dropped': 0}
                if data:
                    with tracing.span('kv.import', self._trace_ctx,
                                      bytes=len(data)):
                        summary = eng.import_chain(data)
                    rt.record_kv_import(summary)
                covered = (summary['imported'] + summary['already_cached']
                           ) * eng.page_size
                recomputed = max(0, len(row) - covered) if row else 0
                key = (affinity.token_affinity_key(
                    row, eng.page_size,
                    salt=affinity.adapter_salt(inner.get('model')))
                    if row else None)
                rt.record_migrated_in(key, recomputed)
            except Exception as e:  # pylint: disable=broad-except
                self._plain_error(e)
                return
            if not inner:
                self._json({'imported': summary})
                return
            self._serve_embedded(req, 'migration')

        def _migrate_record(self, rec,
                            stream) -> Optional[http.client.HTTPResponse]:
            """Ship one evacuated session to a peer: POST the chain and
            the continuation request to /kv/migrate and return the open
            response (the caller proxies its body or SSE tail). None on
            any failure (an injected kv.migrate fault, no peer, a
            refusal): the caller resumes locally on the warm pages."""
            reason = str(rec.get('reason') or 'drain')
            _hint_reason, target = rt.evacuation_hint()
            t0 = time.monotonic()
            try:
                if faults.point('kv.migrate', reason=reason) is faults.DROP:
                    raise RuntimeError('injected kv.migrate drop')
                tokens = [int(t) for t in rec.get('tokens') or []]
                if not tokens:
                    raise RuntimeError('empty migration record')
                remaining = int(rec.get('limit', 0)) - len(tokens)
                if remaining <= 0:
                    raise RuntimeError('no generation budget left')
                peer = target
                if peer is None:
                    eng = next(iter(rt.live_engines()), None)
                    key = (affinity.token_affinity_key(
                        tokens, eng.page_size,
                        salt=affinity.adapter_salt(rec.get('adapter')))
                        if eng is not None else None)
                    peer = rt.pick_decode_peer(key)
                if not peer:
                    raise RuntimeError('no migration peer available')
                inner = {'tokens': [tokens], 'max_new_tokens': remaining,
                         'temperature': rec.get('temperature', 0.0),
                         'top_k': rec.get('top_k', 0),
                         'top_p': rec.get('top_p', 1.0),
                         'stop_token_ids': rec.get('stop_token_ids') or [],
                         'stream': bool(stream)}
                if rec.get('adapter'):
                    inner['model'] = rec['adapter']
                if rec.get('deadline_s'):
                    inner['timeout'] = rec['deadline_s']
                body = chain_body(rec.get('payload'),
                                  {'path': '/generate', 'request': inner,
                                   'reason': reason})
                read_timeout = float(rec.get('deadline_s') or
                                     rt.request_timeout) + 60.0
                ctx = self._trace_ctx
                with tracing.span('kv.migrate', ctx, peer=peer,
                                  reason=reason):
                    upstream = post_peer(peer, '/kv/migrate', body,
                                         read_timeout=read_timeout,
                                         trace_ctx=ctx)
                if upstream.status != 200:
                    code = upstream.status
                    upstream.close()
                    raise RuntimeError(f'migration peer {peer} answered '
                                       f'{code}')
            except Exception as e:  # pylint: disable=broad-except
                rt.record_migration(reason, time.monotonic() - t0, ok=False)
                print(f'kv migrate failed ({type(e).__name__}: {e}); '
                      f'resuming locally', flush=True)
                return None
            rt.record_migration(reason, time.monotonic() - t0, ok=True)
            return upstream

        def _resume_record(self, rec, depth: int = 0) -> List[int]:
            """Finish one evacuated (non-streamed) row: the peer ship,
            else a local warm resume. Returns prompt ++ generated."""
            upstream = self._migrate_record(rec, stream=False)
            if upstream is not None:
                try:
                    with upstream:
                        rows = json.loads(upstream.read()).get('tokens') or []
                    if rows and isinstance(rows[0], list):
                        return [int(t) for t in rows[0]]
                except Exception as e:  # pylint: disable=broad-except
                    print(f'kv migrate response unusable '
                          f'({type(e).__name__}: {e}); resuming locally',
                          flush=True)
            return self._resume_locally(rec, depth=depth)

        def _continuation(self, rec) -> Tuple[List[int], int, float]:
            """(committed tokens, tokens left to generate, deadline s) of
            an evacuated session's record."""
            tokens = [int(t) for t in rec.get('tokens') or []]
            return (tokens, max(int(rec.get('limit', 0)) - len(tokens), 1),
                    float(rec.get('deadline_s') or 0) or rt.request_timeout)

        def _resume_locally(self, rec, depth: int = 0) -> List[int]:
            """Local warm resume: resubmit the committed tokens (their
            full pages were promoted at evacuation, so admission is a
            prefix-cache hit and only the sub-page tail recomputes). A
            second evacuation mid-resume retries the whole ladder
            (bounded); success counts as a 'local_fallback' migration."""
            tokens, remaining, deadline_s = self._continuation(rec)
            adapter = rec.get('adapter')
            eng = rt.engine_for(adapter)
            if eng is None:
                return tokens   # one-shot runtime: nothing to resume
            t0 = time.monotonic()
            try:
                row = eng.submit(
                    tokens, max_new_tokens=remaining,
                    temperature=rec.get('temperature', 0.0),
                    top_k=rec.get('top_k', 0),
                    top_p=rec.get('top_p', 1.0),
                    stop_token_ids=list(rec.get('stop_token_ids') or []),
                    deadline_s=deadline_s, adapter=adapter,
                    trace_ctx=self._trace_ctx).result(
                        timeout=deadline_s + 30.0)
            except SessionMigratedError as me:
                if depth >= 2:
                    raise
                return self._resume_record(me.record, depth=depth + 1)
            rt.record_migration('local_fallback', time.monotonic() - t0,
                                ok=True)
            return row

        def _generate(self):
            try:
                req = self._read_body()
                tokens = _token_rows(req.get('tokens'), 'tokens')
                temperature = float(req.get('temperature', 0.0))
                top_k = int(req.get('top_k', 0))
                top_p = float(req.get('top_p', 1.0))
                stop_ids = [int(t) for t in req.get('stop_token_ids', [])]
                stream = bool(req.get('stream'))
                adapter = rt.resolve_model(req.get('model'))
                deadline_s = rt.deadline_for(req)
                limit = rt.limit_for(temperature, streaming=stream)
                for row in tokens:
                    if len(row) >= limit:
                        raise ValueError(f'prompt len {len(row)} >= '
                                         f'max_total_len {limit}')
                max_new = int(req.get('max_new_tokens', rt.engine_total))
                if stream:
                    self._generate_stream(tokens, max_new, temperature,
                                          top_k, top_p, stop_ids,
                                          deadline_s, adapter)
                    return
                t0 = time.monotonic()
                ttft = None
                if rt.engine_for(adapter) is not None:
                    rows, ttft = _run_rows(
                        rt, tokens, max_new=max_new,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        stop_ids=stop_ids, deadline_s=deadline_s,
                        adapter=adapter, resume=self._resume_record,
                        trace_ctx=self._trace_ctx)
                else:
                    # One-shot: the rows run together ([batch, prompt
                    # len]) and come back as the whole bucket.
                    rows = rt.run_one_shot(
                        rt.get_fn(len(tokens), temperature), tokens)
                # The count decoded is bounded by max_new, not by the
                # one-shot bucket's tail.
                n_gen = sum(min(max(len(r) - len(p), 0), max_new)
                            for r, p in zip(rows, tokens))
                rt.metrics.record(time.monotonic() - t0, n_gen, ttft_s=ttft,
                                  n_prompt_tokens=sum(len(p)
                                                      for p in tokens))
                self._json({'tokens': rows})
            except Exception as e:  # pylint: disable=broad-except
                self._plain_error(e)

        def _submit_streams(self, rows, max_new, temperature, **kw):
            handles = []
            try:
                for row in rows:
                    handles.append(rt.submit_stream(
                        row, max_new, temperature,
                        trace_ctx=self._trace_ctx, **kw))
            except Exception:
                rt.cancel_streams(handles)
                raise
            return handles

        def _generate_stream(self, tokens, max_new, temperature, top_k,
                             top_p, stop_ids, deadline_s, adapter):
            """SSE of {"index": row, "token": id} events, one per
            committed token across all rows, interleaved by arrival;
            then the full rows, as the non-streamed answer has them."""
            t0 = time.monotonic()
            handles = self._submit_streams(
                tokens, max_new, temperature, top_k=top_k, top_p=top_p,
                stop_token_ids=stop_ids, deadline_s=deadline_s,
                adapter=adapter)
            self.sse_start()
            n_gen = 0
            ttft = None
            migrated = False
            # ITL is recorded at commit time by the handles' on_token.
            try:
                try:
                    for i, t in iter_interleaved(handles):
                        if ttft is None:
                            ttft = time.monotonic() - t0
                        n_gen += 1
                        self.sse_send({'index': i, 'token': t})
                except SessionMigratedError:
                    # The engine evacuated the slots mid-stream, after
                    # the interleaver drained every committed token: the
                    # client is caught up; the tail comes from a peer
                    # (or from here) below.
                    migrated = True
            finally:
                rt.cancel_streams(handles)   # no-op when completed
            if migrated:
                final_rows = self._finish_migrated_stream(handles)
                if final_rows is None:
                    # Proxied whole: the peer's SSE tail (terminal event
                    # and [DONE] included) already went out.
                    rt.metrics.record(time.monotonic() - t0, n_gen,
                                      ttft_s=ttft,
                                      n_prompt_tokens=sum(
                                          len(row) for row in tokens))
                    return
            else:
                final_rows = [h.future.result() for h in handles]
            self.sse_send({'done': True, 'tokens': final_rows})
            self.sse_done()
            rt.metrics.record(time.monotonic() - t0, n_gen, ttft_s=ttft,
                              n_prompt_tokens=sum(len(row)
                                                  for row in tokens))

        def _finish_migrated_stream(self, handles):
            """Finish an SSE /generate stream whose slots were evacuated.
            A single-row stream proxies the peer's SSE tail (the same
            {'index': 0, ...} frames, terminal event included) and
            returns None. Multi-row streams, and a failed ship, resume
            locally: new tokens stream under their rows' indices and the
            full rows come back for the terminal event."""
            outcomes = []
            for h in handles:
                try:
                    outcomes.append(('done', h.future.result(timeout=0.001)))
                except SessionMigratedError as me:
                    outcomes.append(('rec', me.record))
            recs = [(i, o[1]) for i, o in enumerate(outcomes)
                    if o[0] == 'rec']
            if len(handles) == 1 and recs:
                upstream = self._migrate_record(recs[0][1], stream=True)
                if upstream is not None:
                    with upstream:
                        eof, _first = sse.pipe(upstream, self.wfile)
                        if not eof:
                            print('migration stream truncated', flush=True)
                    return None
            rows = [o[1] if o[0] == 'done' else None for o in outcomes]
            for i, rec in recs:
                rows[i] = self._resume_stream_locally(i, rec)
            return rows

        def _resume_stream_locally(self, index, rec) -> List[int]:
            """Local warm resume of one evacuated streamed row: resubmit
            the committed tokens and stream the new ones under the row's
            index. Returns the full row; a failure returns the committed
            row (the stream truncates there, as at a replica death)."""
            tokens, remaining, deadline_s = self._continuation(rec)
            t0 = time.monotonic()
            try:
                h = rt.submit_stream(
                    tokens, remaining, rec.get('temperature', 0.0),
                    top_k=rec.get('top_k', 0), top_p=rec.get('top_p', 1.0),
                    stop_token_ids=list(rec.get('stop_token_ids') or []),
                    deadline_s=deadline_s, adapter=rec.get('adapter'),
                    trace_ctx=self._trace_ctx)
            except Exception as e:  # pylint: disable=broad-except
                print(f'local stream resume failed to submit '
                      f'({type(e).__name__}: {e}); stream truncates at '
                      f'the committed point', flush=True)
                return tokens
            try:
                for _j, t in iter_interleaved([h]):
                    self.sse_send({'index': index, 'token': t})
                row = h.future.result(timeout=deadline_s + 30.0)
            except Exception as e:  # pylint: disable=broad-except
                print(f'local stream resume failed ({type(e).__name__}: '
                      f'{e}); stream truncates at the committed point',
                      flush=True)
                rt.cancel_streams([h])
                return tokens
            rt.record_migration('local_fallback', time.monotonic() - t0,
                                ok=True)
            return row

        def _generate_text(self):
            try:
                tok = rt.get_tokenizer()
                req = self._read_body()
                prompts = req['prompts']
                if isinstance(prompts, str):
                    prompts = [prompts]
                temperature = float(req.get('temperature', 0.0))
                top_k = int(req.get('top_k', 0))
                top_p = float(req.get('top_p', 1.0))
                stop_strings = req.get('stop') or []
                if isinstance(stop_strings, str):
                    stop_strings = [stop_strings]
                max_new = int(req.get('max_new_tokens', 64))
                stream = bool(req.get('stream'))
                adapter = rt.resolve_model(req.get('model'))
                deadline_s = rt.deadline_for(req)
                encoded = [tok(p)['input_ids'] for p in prompts]
                limit = rt.limit_for(temperature, streaming=stream)
                for ids in encoded:
                    if len(ids) >= limit:
                        raise ValueError(f'prompt tokenizes to {len(ids)} '
                                         f'>= max_total_len {limit}')
                if stream:
                    self._generate_text_stream(
                        encoded, max_new, temperature, top_k, top_p,
                        stop_strings, deadline_s, adapter)
                    return
                t0 = time.monotonic()
                rows, ttft = _run_rows(
                    rt, encoded, max_new=max_new, temperature=temperature,
                    top_k=top_k, top_p=top_p, stop_ids=[],
                    deadline_s=deadline_s, adapter=adapter,
                    resume=self._resume_record, trace_ctx=self._trace_ctx)
                texts = [oai.trim_stops(tok.decode(
                    row[len(ids):], skip_special_tokens=True),
                    stop_strings)[0] for ids, row in zip(encoded, rows)]
                n_gen = sum(len(r) - len(p) for r, p in zip(rows, encoded))
                rt.metrics.record(time.monotonic() - t0, n_gen, ttft_s=ttft,
                                  n_prompt_tokens=sum(len(p)
                                                      for p in encoded))
                self._json({'texts': texts})
            except Exception as e:  # pylint: disable=broad-except
                self._plain_error(e)

        def _generate_text_stream(self, encoded, max_new, temperature,
                                  top_k, top_p, stop_strings, deadline_s,
                                  adapter):
            """SSE of {"index": i, "delta": text} events (incremental
            detokenization and stop-string holdback per row)."""
            tok = rt.get_tokenizer()
            t0 = time.monotonic()
            handles = self._submit_streams(
                encoded, max_new, temperature, top_k=top_k, top_p=top_p,
                deadline_s=deadline_s, adapter=adapter)
            self.sse_start()
            decs = [oai.IncrementalDecoder(tok) for _ in encoded]
            scans = [oai.StopStringScanner(stop_strings) for _ in encoded]
            n_gen = 0
            ttft = None
            migrated = False
            try:
                try:
                    for i, t in iter_interleaved(handles):
                        if ttft is None:
                            ttft = time.monotonic() - t0
                        n_gen += 1
                        if scans[i].hit:
                            continue
                        out = scans[i].push(decs[i].push(t))
                        if out:
                            self.sse_send({'index': i, 'delta': out})
                except SessionMigratedError:
                    migrated = True
            finally:
                rt.cancel_streams(handles)   # no-op when completed
            if migrated:
                # Evacuated mid-stream: the committed deltas went out;
                # each migrated row finishes here on the warm pages
                # (text requests never ship: the peer path takes token
                # requests only).
                for i, h in enumerate(handles):
                    try:
                        h.future.result(timeout=0.001)
                    except SessionMigratedError as me:
                        self._resume_text_stream_locally(i, me.record, decs,
                                                         scans)
                    except Exception as e:  # pylint: disable=broad-except
                        print(f'text stream row {i} failed during '
                              f'evacuation ({type(e).__name__}: {e})',
                              flush=True)
            for i in range(len(handles)):
                if not scans[i].hit:
                    out = scans[i].push(decs[i].flush()) + scans[i].flush()
                    if out:
                        self.sse_send({'index': i, 'delta': out})
            self.sse_done()
            rt.metrics.record(time.monotonic() - t0, n_gen, ttft_s=ttft,
                              n_prompt_tokens=sum(len(ids)
                                                  for ids in encoded))

        def _resume_text_stream_locally(self, index, rec, decs, scans):
            """Local warm resume of one evacuated text-stream row: the
            continuation runs through the row's incremental decoder and
            stop scanner, so the deltas pick up where they stopped."""
            tokens, remaining, deadline_s = self._continuation(rec)
            t0 = time.monotonic()
            try:
                h = rt.submit_stream(
                    tokens, remaining, rec.get('temperature', 0.0),
                    top_k=rec.get('top_k', 0), top_p=rec.get('top_p', 1.0),
                    deadline_s=deadline_s, adapter=rec.get('adapter'),
                    trace_ctx=self._trace_ctx)
            except Exception as e:  # pylint: disable=broad-except
                print(f'local text-stream resume failed to submit '
                      f'({type(e).__name__}: {e}); row {index} truncates '
                      f'at the committed point', flush=True)
                return
            try:
                for _j, t in iter_interleaved([h]):
                    if scans[index].hit:
                        continue
                    out = scans[index].push(decs[index].push(t))
                    if out:
                        self.sse_send({'index': index, 'delta': out})
            except Exception as e:  # pylint: disable=broad-except
                print(f'local text-stream resume failed '
                      f'({type(e).__name__}: {e}); row {index} truncates '
                      f'at the committed point', flush=True)
                rt.cancel_streams([h])
                return
            rt.record_migration('local_fallback', time.monotonic() - t0,
                                ok=True)

        def _replaying(self, run: Callable[[], None]) -> None:
            """Run an OpenAI request; evacuated before its headers went
            out, replay it on the promoted warm pages (its prefill is a
            prefix-cache hit). Mid-stream there is no replay: the error
            handler truncates the stream."""
            try:
                run()
            except SessionMigratedError:
                if self._sse_open:
                    raise
                run()

        def _openai_completions(self):
            try:
                body = self._read_body()
                prompts = body.get('prompt', '')
                if _is_token_prompt(prompts):
                    self._replaying(
                        lambda: self._token_completions(body, prompts))
                    return
                if isinstance(prompts, str):
                    prompts = [prompts]
                req = oai.CompletionRequest(
                    prompts=prompts,
                    max_new=int(body.get('max_tokens', 16)),
                    temperature=float(body.get('temperature', 1.0)),
                    top_p=float(body.get('top_p', 1.0)),
                    stop_strings=body.get('stop') or [],
                    n=int(body.get('n', 1)),
                    stream=bool(body.get('stream')),
                    logprobs=body.get('logprobs'),
                    echo=bool(body.get('echo')),
                    deadline_s=rt.deadline_for(body),
                    adapter=rt.resolve_model(body.get('model')),
                    model=body.get('model'))
                if req.stream:
                    self._replaying(
                        lambda: oai.stream_completion(rt, req, self))
                else:
                    self._replaying(
                        lambda: self._json(oai.run_completion(rt, req)))
            except Exception as e:  # pylint: disable=broad-except
                self._oai_error(e)

        def _token_completions(self, body, prompt):
            """Completions of token-id prompts (no tokenizer needed):
            each choice carries its generated ids in "tokens" and an
            empty "text"."""
            adapter = rt.resolve_model(body.get('model'))
            asked = [k for k in ('stream', 'stop', 'logprobs', 'echo')
                     if body.get(k)]
            if asked:
                raise ValueError(f'{", ".join(asked)} take text prompts; '
                                 f'token-id prompts answer ids only')
            prompts = _token_rows(prompt, 'prompt')
            n = int(body.get('n', 1))
            if not 1 <= n <= 16:
                raise ValueError(f'n must be in [1, 16], got {n}')
            max_new = int(body.get('max_tokens', 16))
            temperature = float(body.get('temperature', 1.0))
            limit = rt.limit_for(temperature)
            for row in prompts:
                if len(row) >= limit:
                    raise ValueError(f'prompt len {len(row)} >= '
                                     f'max_total_len {limit}')
            t0 = time.monotonic()
            fanned = [p for p in prompts for _ in range(n)]
            rows, ttft = _run_rows(
                rt, fanned, max_new=max_new, temperature=temperature,
                top_k=0, top_p=float(body.get('top_p', 1.0)), stop_ids=[],
                deadline_s=rt.deadline_for(body), adapter=adapter,
                resume=self._resume_record, trace_ctx=self._trace_ctx)
            choices = []
            n_gen = 0
            for i, (ids, row) in enumerate(zip(fanned, rows)):
                gen = row[len(ids):]
                n_gen += len(gen)
                choices.append({'index': i, 'text': '', 'tokens': gen,
                                'logprobs': None,
                                'finish_reason': 'length'
                                if len(gen) >= max_new else 'stop'})
            # Each prompt counts once, however many choices it fans out
            # to (the OpenAI usage contract).
            n_prompt = sum(len(p) for p in prompts)
            rt.metrics.record(time.monotonic() - t0, n_gen, ttft_s=ttft,
                              n_prompt_tokens=n_prompt)
            self._json({'object': 'text_completion',
                        'model': body.get('model') or rt.model_name,
                        'choices': choices,
                        'usage': {'prompt_tokens': n_prompt,
                                  'completion_tokens': n_gen,
                                  'total_tokens': n_prompt + n_gen}})

        def _openai_chat(self):
            try:
                body = self._read_body()
                # An unknown model is a 404 before prompt rendering can
                # fail 400 on tokenizer details.
                adapter = rt.resolve_model(body.get('model'))
                prompt = oai.render_chat_prompt(rt, body['messages'])
                # Chat's logprobs: a bool plus a top_logprobs count
                # (clamped to 5).
                chat_lp = None
                if body.get('logprobs'):
                    chat_lp = min(int(body.get('top_logprobs', 0)), 5)
                req = oai.CompletionRequest(
                    prompts=[prompt],
                    max_new=int(body.get('max_tokens', 16)),
                    temperature=float(body.get('temperature', 1.0)),
                    top_p=float(body.get('top_p', 1.0)),
                    stop_strings=body.get('stop') or [],
                    n=int(body.get('n', 1)),
                    stream=bool(body.get('stream')),
                    logprobs=chat_lp,
                    deadline_s=rt.deadline_for(body),
                    adapter=adapter,
                    model=body.get('model'))
                if req.stream:
                    self._replaying(lambda: oai.stream_completion(
                        rt, req, self, chat=True))
                else:
                    self._replaying(lambda: self._json(
                        oai.to_chat_response(oai.run_completion(rt, req))))
            except Exception as e:  # pylint: disable=broad-except
                self._oai_error(e)

    server = ThreadingHTTPServer(('0.0.0.0', port), Handler)
    server.daemon_threads = True
    server.inflight = inflight
    server.inflight_lock = inflight_lock
    server.draining = draining
    return server


class ServePreemptionNotice(train_guard.PreemptionNotice):
    """Serving-side preemption watcher: the trainer's metadata poll and
    injectable notice (robustness/train_guard.py), firing the
    `serve.preempt_notice` fault point instead of the trainer's. SIGTERM
    stays with serve()'s own drain handler (install_sigterm=False),
    which evacuates too; this covers the notice a spot VM gets BEFORE
    its SIGTERM."""

    def _poll_loop(self) -> None:
        while not self._stop.is_set() and not self.notice.is_set():
            self.polls += 1
            if faults.point('serve.preempt_notice',
                            **self.ctx) is faults.DROP:
                self.trigger('injected')
                break
            if self._probe_metadata():
                self.trigger('metadata')
                break
            self._stop.wait(self.poll_interval_s)


def evacuate_for_exit(rt: InferenceRuntime, reason: str = 'drain') -> dict:
    """Evacuate every live engine's sessions ahead of an exit (SIGTERM
    drain or preemption notice): their futures resolve with
    SessionMigratedError, and their HTTP threads ship the chains to
    peers or finish locally on the promoted pages. Failures are logged,
    never raised: a broken engine must not stop the drain."""
    total = {'evacuated': 0, 'chains': 0, 'queued': 0}
    for eng in rt.live_engines():
        try:
            got = eng.evacuate_chains(reason=reason)
        except Exception as e:  # pylint: disable=broad-except
            print(f'evacuation failed on an engine ({type(e).__name__}: '
                  f'{e}); its sessions finish locally', flush=True)
            continue
        for k in total:
            total[k] += int(got.get(k, 0))
    if total['evacuated'] or total['queued']:
        rt.record_evacuation(total)
        print(f'serve_lm: evacuated {total["evacuated"]} active + '
              f'{total["queued"]} queued sessions ({total["chains"]} KV '
              f'chains packed, reason={reason})', flush=True)
    return total


def drain(server: ThreadingHTTPServer, rt: InferenceRuntime,
          drain_grace: float, straggler_grace: float = 0.5,
          exit_fn=os._exit) -> None:
    """Graceful drain: /readyz turns 503, every active KV chain is
    evacuated (the owning HTTP threads migrate the sessions to peers or
    finish them here), the accept loop takes stragglers for
    `straggler_grace` seconds and stops, in-flight POSTs get up to
    `drain_grace` seconds, then exit 0. `exit_fn` is injectable, so the
    contract is testable without killing the process."""
    server.draining.set()
    print('serve_lm: SIGTERM — draining in-flight requests', flush=True)
    # Idempotent: a controller that already POSTed /kv/evacuate left the
    # engines empty, and this finds nothing.
    evacuate_for_exit(rt, reason='drain')
    time.sleep(straggler_grace)
    server.shutdown()
    deadline = time.monotonic() + drain_grace
    while time.monotonic() < deadline:
        with server.inflight_lock:
            if server.inflight['n'] == 0:
                break
        time.sleep(0.05)
    rt.stop()
    exit_fn(0)


def serve(rt: InferenceRuntime, port: int, drain_grace: float = 630.0,
          zone: str = '', watch_preemption: bool = True) -> None:
    """Run the HTTP server until killed. SIGTERM drains first; the
    preemption watcher turns a spot notice (or an injected
    `serve.preempt_notice` drop, scoped by `zone`) into a mass chain
    evacuation followed by the same drain. The watcher polls the GCE
    metadata server unless STPU_PREEMPT_METADATA_URL points elsewhere."""
    server = make_server(rt, port)
    term = threading.Event()

    def _drain_loop():
        term.wait()
        drain(server, rt, drain_grace)

    threading.Thread(target=_drain_loop, daemon=True).start()
    signal.signal(signal.SIGTERM, lambda *_: term.set())
    if watch_preemption:
        notice = ServePreemptionNotice(poll_interval_s=2.0,
                                       install_sigterm=False,
                                       ctx={'zone': zone} if zone else {})
        notice.start()

        def _preempt_watch():
            notice.notice.wait()
            print(f'serve_lm: preemption notice ({notice.reason}) — '
                  f'evacuating active sessions', flush=True)
            rt.set_evacuation_hint('preempt', None)
            evacuate_for_exit(rt, reason='preempt')
            term.set()   # the drain loop finishes the exit

        threading.Thread(target=_preempt_watch, daemon=True).start()
    print(f'serve_lm listening on :{port} model={rt.model_name} '
          f'device={rt.model.device}', flush=True)
    server.serve_forever()
