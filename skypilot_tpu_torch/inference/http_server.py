"""HTTP front of the port's inference runtime (port of
skypilot_tpu/inference/http_server.py `make_server` / `serve`, the
token-id endpoints):

  GET  /                   readiness + capacity
  GET  /healthz            liveness
  GET  /readyz             readiness (503 while draining, engine dead
                           or queue saturated, with the reasons)
  GET  /stats              slots, queue, KV pool, kernel launches,
                           adapters, request metrics (JSON)
  GET  /v1/models          the base model plus the adapter inventory
  POST /generate           {"tokens": [[...]], "max_new_tokens": N,
                           "temperature", "top_k", "top_p",
                           "stop_token_ids", "timeout", "model"} ->
                           {"tokens": [[prompt ++ generated]]}
  POST /v1/completions     OpenAI completions with token prompts
                           ("prompt": [ids] or [[ids], ...]),
                           non-streaming; each choice carries the
                           generated ids in "tokens" ("text" is empty:
                           no tokenizer is loaded)

The `model` field selects a LoRA adapter by name (the base model's name,
'base', 'default' or no field = the base model); an unknown model is a
404 with the OpenAI code `model_not_found`, an adapter that fails to
load a 503.

Streaming, text prompts, chat and /metrics are not ported yet and
answer 400/404 saying so.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from skypilot_tpu_torch.errors import (AdapterLoadError,
                                       AdapterNotFoundError,
                                       DeadlineExceededError,
                                       EngineDeadError, QueueSaturatedError)
from skypilot_tpu_torch.inference.runtime import InferenceRuntime
from skypilot_tpu_torch.ops import lora_kernel, paged_kernel


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


class _FirstToken:
    """on_token callback recording the time of a request's first
    committed token (any row)."""

    def __init__(self) -> None:
        self.t0 = time.monotonic()
        self.first_token_s: Optional[float] = None

    def __call__(self, _tok: int) -> None:
        if self.first_token_s is None:
            self.first_token_s = time.monotonic() - self.t0


def _run_rows(rt: InferenceRuntime, rows: List[List[int]], *,
              max_new: int, temperature: float, top_k: int, top_p: float,
              stop_ids: List[int], deadline_s: float,
              adapter: Optional[str]):
    """Submit every row to the engine (cancelling the submitted ones if
    a later submission is shed) and wait for all. Returns (rows, ttft)."""
    limit = rt.limit_for()
    for row in rows:
        if len(row) >= limit:
            raise ValueError(f'prompt len {len(row)} >= max_total_len '
                             f'{limit}')
    latch = _FirstToken()
    futs = []
    try:
        for row in rows:
            futs.append(rt.engine.submit(
                row, max_new_tokens=max_new, temperature=temperature,
                top_k=top_k, top_p=top_p, stop_token_ids=stop_ids,
                on_token=latch, deadline_s=deadline_s, adapter=adapter))
    except Exception:
        if futs:
            rt.engine.cancel(futs)
        raise
    # The engine reaps expired requests; the host timeout is a backstop.
    out = [f.result(timeout=deadline_s + 30.0) for f in futs]
    return out, latch.first_token_s


def _token_rows(value, field: str) -> List[List[int]]:
    if not isinstance(value, list) or not value:
        raise ValueError(f'{field} must be a non-empty list of token ids '
                         f'(or of such lists)')
    rows = value if isinstance(value[0], list) else [value]
    return [[int(t) for t in row] for row in rows]


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

        def _json(self, obj, code=200, headers=None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, e: Exception, openai: bool = False):
            code, retry_after = classify_error(e)
            rt.metrics.record_error()
            headers = ({'Retry-After': str(max(1, int(retry_after)))}
                       if retry_after is not None else None)
            msg = f'{type(e).__name__}: {e}'
            if openai:
                err = {'message': msg,
                       'type': 'invalid_request_error'
                       if code in (400, 404) else 'server_error'}
                if code == 404:
                    err['code'] = 'model_not_found'
                body = {'error': err}
            else:
                body = {'error': msg}
            self._json(body, code, headers=headers)

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
                self._json({'status': 'ok', 'model': rt.model_name,
                            'vocab_size': rt.vocab_size,
                            'max_total_len': rt.limit_for()})
            else:
                self._json({'error': f'GET {self.path} is not served '
                                     f'by this port'}, 404)

        def _stats(self):
            eng = rt.engine
            cfg = eng.model.config
            body = {
                'model': rt.model_name,
                'device': str(eng.device),
                'zone': rt.zone,
                'engine': eng.stats(),
                'kv_pool': {'dtype': eng.kv_dtype,
                            'pages': eng.total_pages,
                            'free_pages': eng.allocator.free_pages,
                            'page_size': eng.page_size,
                            'bytes': eng.kv_cache_bytes(),
                            'layers': cfg.num_layers},
                'paged_attention': {
                    'kernel_launches': paged_kernel.launches,
                    'plain_calls': paged_kernel.plain_calls},
                'qkv_lora': {'kernel_launches': lora_kernel.launches,
                             'plain_calls': lora_kernel.plain_calls},
                'requests': rt.metrics.snapshot(),
            }
            if rt.adapters is not None:
                body['adapters'] = rt.adapters.stats()
            return body

        # -- POST ---------------------------------------------------------
        def do_POST(self):  # noqa: N802
            with inflight_lock:
                inflight['n'] += 1
            try:
                if self.path in ('/generate', '/v1/generate'):
                    self._generate()
                elif self.path == '/v1/completions':
                    self._completions()
                else:
                    self._json({'error': 'POST /generate or '
                                         '/v1/completions'}, 404)
            finally:
                with inflight_lock:
                    inflight['n'] -= 1

        def _read_body(self):
            length = int(self.headers.get('Content-Length', 0))
            return json.loads(self.rfile.read(length))

        def _generate(self):
            try:
                req = self._read_body()
                adapter = rt.resolve_model(req.get('model'))
                if req.get('stream'):
                    raise ValueError('stream=true is not supported by '
                                     'the PyTorch port yet')
                prompts = _token_rows(req.get('tokens'), 'tokens')
                max_new = int(req.get('max_new_tokens', rt.limit_for()))
                t0 = time.monotonic()
                rows, ttft = _run_rows(
                    rt, prompts, max_new=max_new,
                    temperature=float(req.get('temperature', 0.0)),
                    top_k=int(req.get('top_k', 0)),
                    top_p=float(req.get('top_p', 1.0)),
                    stop_ids=[int(t) for t in req.get('stop_token_ids',
                                                      [])],
                    deadline_s=rt.deadline_for(req), adapter=adapter)
                rt.metrics.record(time.monotonic() - t0,
                                  sum(len(r) - len(p)
                                      for r, p in zip(rows, prompts)),
                                  sum(len(p) for p in prompts), ttft)
                self._json({'tokens': rows})
            except Exception as e:  # pylint: disable=broad-except
                self._error(e)

        def _completions(self):
            try:
                body = self._read_body()
                adapter = rt.resolve_model(body.get('model'))
                if body.get('stream'):
                    raise ValueError('stream=true is not supported by '
                                     'the PyTorch port yet')
                prompt = body.get('prompt')
                if isinstance(prompt, str) or (
                        isinstance(prompt, list) and prompt
                        and isinstance(prompt[0], str)):
                    raise ValueError('text prompts need a tokenizer, '
                                     'which this port does not load yet; '
                                     'send token ids')
                if body.get('stop') or body.get('logprobs') is not None:
                    raise ValueError('stop strings and logprobs need a '
                                     'tokenizer; not supported yet')
                prompts = _token_rows(prompt, 'prompt')
                n = int(body.get('n', 1))
                if not 1 <= n <= 16:
                    raise ValueError(f'n must be in [1, 16], got {n}')
                max_new = int(body.get('max_tokens', 16))
                t0 = time.monotonic()
                fanned = [p for p in prompts for _ in range(n)]
                rows, ttft = _run_rows(
                    rt, fanned, max_new=max_new,
                    temperature=float(body.get('temperature', 1.0)),
                    top_k=0, top_p=float(body.get('top_p', 1.0)),
                    stop_ids=[], deadline_s=rt.deadline_for(body),
                    adapter=adapter)
                choices = []
                n_gen = 0
                for i, (ids, row) in enumerate(zip(fanned, rows)):
                    gen = row[len(ids):]
                    n_gen += len(gen)
                    choices.append({'index': i, 'text': '', 'tokens': gen,
                                    'logprobs': None,
                                    'finish_reason': 'length'
                                    if len(gen) >= max_new else 'stop'})
                n_prompt = sum(len(p) for p in prompts)
                rt.metrics.record(time.monotonic() - t0, n_gen,
                                  sum(len(p) for p in fanned), ttft)
                self._json({'object': 'text_completion',
                            'model': body.get('model') or rt.model_name,
                            'choices': choices,
                            'usage': {'prompt_tokens': n_prompt,
                                      'completion_tokens': n_gen,
                                      'total_tokens': n_prompt + n_gen}})
            except Exception as e:  # pylint: disable=broad-except
                self._error(e, openai=True)

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
          f'device={rt.engine.device}', flush=True)
    server.serve_forever()
