"""HTTP front of the port's inference runtime (port of
skypilot_tpu/inference/http_server.py `make_server` / `serve`):

  GET  /                       readiness + capacity
  GET  /healthz                liveness
  GET  /readyz                 readiness (503 while draining, engine
                               dead or queue saturated, with reasons)
  GET  /stats                  slots, queue, KV pool, kernel launches,
                               adapters, request metrics (TTFT, ITL);
                               the top-level keys the replica plane's
                               ReplicaManager scrapes, as the
                               reference names them
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

The `model` field selects a LoRA adapter by name (the base model's
name, 'base', 'default' or no field = the base model); an unknown
model is a 404 (OpenAI code `model_not_found`), an adapter that fails
to load a 503. SSE streams end with `data: [DONE]`; a client that
disconnects mid-stream cancels its rows, freeing their slots. Without
--continuous-batching, /generate and the text endpoints run the
one-shot engine; streams and adapter requests run on the runtime's
stream engine. /metrics and the /kv/* endpoints are not ported yet
(ROADMAP A6).
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from skypilot_tpu_torch.errors import (AdapterLoadError,
                                       AdapterNotFoundError,
                                       DeadlineExceededError,
                                       EngineDeadError, QueueSaturatedError)
from skypilot_tpu_torch.inference import openai_compat as oai
from skypilot_tpu_torch.inference.runtime import (FirstTokenLatch,
                                                  InferenceRuntime,
                                                  iter_interleaved)
from skypilot_tpu_torch.ops import lora_kernel, paged_kernel


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
              adapter: Optional[str]) -> Tuple[List[List[int]],
                                                Optional[float]]:
    """(rows of prompt ++ generated, TTFT) of ragged rows: on the
    engine that serves them, or each alone through the one-shot
    buckets (no TTFT then)."""
    eng = rt.engine_for(adapter)
    if eng is None:
        return rt.one_shot_rows(rows, max_new, temperature), None
    latch = FirstTokenLatch()
    futs = _submit_all(eng, rows, max_new_tokens=max_new,
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       stop_token_ids=stop_ids, on_token=latch,
                       deadline_s=deadline_s, adapter=adapter)
    # The engine reaps expired requests; the host timeout is a backstop.
    out = [f.result(timeout=deadline_s + 30.0) for f in futs]
    return out, latch.first_token_s


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
            """(code, headers) of a failed request; counts the error."""
            code, retry_after = classify_error(e)
            rt.metrics.record_error()
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

        def _stats(self):
            live = rt.live_engines()
            body = {
                # The keys ReplicaManager scrapes, at the top level as
                # the reference serves them. This port serves unified
                # replicas only: its role is ''.
                'instance_uuid': INSTANCE_UUID,
                'queued': sum(e.queued_requests() for e in live),
                'prefill_backlog_tokens': sum(e.prefill_backlog_tokens()
                                              for e in live),
                'requests_shed': sum(e.requests_shed for e in live),
                'healthy': all(e.healthy() for e in live),
                'role': '',
                'model': rt.model_name,
                'device': str(rt.model.device),
                'zone': rt.zone,
                'paged_attention': {
                    'kernel_launches': paged_kernel.launches,
                    'plain_calls': paged_kernel.plain_calls},
                'qkv_lora': {'kernel_launches': lora_kernel.launches,
                             'plain_calls': lora_kernel.plain_calls},
                'requests': rt.metrics.snapshot(),
            }
            if rt.adapters is not None:
                body['adapters'] = rt.adapters.stats()
            eng = rt.engine
            if eng is None:
                # One-shot mode; the stream engine, once built, serves
                # streamed and adapter requests.
                body['engine'] = 'simple'
                return body
            cfg = eng.model.config
            body.update({
                # The decode loop's health, top-level as the reference
                # serves it (skypilot_tpu/inference/http_server.py:313-333).
                'decode_calls': eng.decode_calls,
                'tokens_committed': eng.tokens_committed,
                'tokens_per_call': round(
                    eng.tokens_committed / max(eng.decode_calls, 1), 3),
                'speculative_k': eng.spec_k,
                'pipeline_decode': eng.pipeline_decode,
                'prefill_chunk': eng.prefill_chunk,
                'prefill_chunks_run': eng.prefill_chunks_run,
                'decode_stall_s': round(eng.decode_stall_s, 4),
                'engine': eng.stats(),
                'kv_pool': {'dtype': eng.kv_dtype,
                            'pages': eng.total_pages,
                            'free_pages': eng.allocator.free_pages,
                            'page_size': eng.page_size,
                            'bytes': eng.kv_cache_bytes(),
                            'layers': cfg.num_layers}})
            pc = eng.prefix_cache
            if pc is not None:
                body['prefix_cache'] = {
                    'hits': pc.hits, 'misses': pc.misses,
                    'hit_rate': round(pc.hits / max(pc.hits + pc.misses,
                                                    1), 3),
                    'evictions': pc.evictions,
                    'resident_unreferenced': len(pc.lru)}
            return body

        # -- POST ---------------------------------------------------------
        def do_POST(self):  # noqa: N802
            self._sse_open = False
            with inflight_lock:
                inflight['n'] += 1
            try:
                handler = {
                    '/generate': self._generate,
                    '/v1/generate': self._generate,
                    '/generate_text': self._generate_text,
                    '/v1/generate_text': self._generate_text,
                    '/v1/completions': self._openai_completions,
                    '/v1/chat/completions': self._openai_chat,
                }.get(self.path)
                if handler is None:
                    self._json({'error': 'POST /generate, /generate_text, '
                                         'or /v1/completions'}, 404)
                else:
                    handler()
            finally:
                with inflight_lock:
                    inflight['n'] -= 1

        def _read_body(self):
            length = int(self.headers.get('Content-Length', 0))
            return json.loads(self.rfile.read(length))

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
                        adapter=adapter)
                else:
                    # One-shot: the rows run together ([batch, prompt
                    # len]) and come back as the whole bucket.
                    rows = rt.run_one_shot(
                        rt.get_fn(len(tokens), temperature), tokens)
                # The count decoded is bounded by max_new, not by the
                # one-shot bucket's tail.
                n_gen = sum(min(max(len(r) - len(p), 0), max_new)
                            for r, p in zip(rows, tokens))
                rt.metrics.record(time.monotonic() - t0, n_gen,
                                  sum(len(p) for p in tokens), ttft)
                self._json({'tokens': rows})
            except Exception as e:  # pylint: disable=broad-except
                self._plain_error(e)

        def _submit_streams(self, rows, max_new, temperature, **kw):
            handles = []
            try:
                for row in rows:
                    handles.append(rt.submit_stream(row, max_new,
                                                    temperature, **kw))
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
            # ITL is recorded at commit time by the handles' on_token.
            try:
                for i, t in iter_interleaved(handles):
                    if ttft is None:
                        ttft = time.monotonic() - t0
                    n_gen += 1
                    self.sse_send({'index': i, 'token': t})
            finally:
                rt.cancel_streams(handles)   # no-op when completed
            final_rows = [h.future.result() for h in handles]
            self.sse_send({'done': True, 'tokens': final_rows})
            self.sse_done()
            rt.metrics.record(time.monotonic() - t0, n_gen,
                              sum(len(row) for row in tokens), ttft)

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
                    deadline_s=deadline_s, adapter=adapter)
                texts = [oai.trim_stops(tok.decode(
                    row[len(ids):], skip_special_tokens=True),
                    stop_strings)[0] for ids, row in zip(encoded, rows)]
                n_gen = sum(len(r) - len(p) for r, p in zip(rows, encoded))
                rt.metrics.record(time.monotonic() - t0, n_gen,
                                  sum(len(p) for p in encoded), ttft)
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
            finally:
                rt.cancel_streams(handles)   # no-op when completed
            for i in range(len(handles)):
                if not scans[i].hit:
                    out = scans[i].push(decs[i].flush()) + scans[i].flush()
                    if out:
                        self.sse_send({'index': i, 'delta': out})
            self.sse_done()
            rt.metrics.record(time.monotonic() - t0, n_gen,
                              sum(len(ids) for ids in encoded), ttft)

        def _openai_completions(self):
            try:
                body = self._read_body()
                prompts = body.get('prompt', '')
                if _is_token_prompt(prompts):
                    self._token_completions(body, prompts)
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
                    oai.stream_completion(rt, req, self)
                else:
                    self._json(oai.run_completion(rt, req))
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
                deadline_s=rt.deadline_for(body), adapter=adapter)
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
            rt.metrics.record(time.monotonic() - t0, n_gen, n_prompt, ttft)
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
                    oai.stream_completion(rt, req, self, chat=True)
                else:
                    self._json(oai.to_chat_response(
                        oai.run_completion(rt, req)))
            except Exception as e:  # pylint: disable=broad-except
                self._oai_error(e)

    server = ThreadingHTTPServer(('0.0.0.0', port), Handler)
    server.daemon_threads = True
    server.inflight = inflight
    server.inflight_lock = inflight_lock
    server.draining = draining
    return server


def drain(server: ThreadingHTTPServer, rt: InferenceRuntime,
          drain_grace: float, exit_fn=os._exit) -> None:
    """Graceful drain: /readyz turns 503, the accept loop stops,
    in-flight POSTs get up to `drain_grace` seconds, then exit 0."""
    server.draining.set()
    print('serve_lm: SIGTERM — draining in-flight requests', flush=True)
    server.shutdown()
    deadline = time.monotonic() + drain_grace
    while time.monotonic() < deadline:
        with server.inflight_lock:
            if server.inflight['n'] == 0:
                break
        time.sleep(0.05)
    rt.stop()
    exit_fn(0)


def serve(rt: InferenceRuntime, port: int,
          drain_grace: float = 630.0) -> None:
    """Run the HTTP server until killed; SIGTERM drains first."""
    server = make_server(rt, port)
    term = threading.Event()

    def _drain_loop():
        term.wait()
        drain(server, rt, drain_grace)

    threading.Thread(target=_drain_loop, daemon=True).start()
    signal.signal(signal.SIGTERM, lambda *_: term.set())
    print(f'serve_lm listening on :{port} model={rt.model_name} '
          f'device={rt.model.device}', flush=True)
    server.serve_forever()
