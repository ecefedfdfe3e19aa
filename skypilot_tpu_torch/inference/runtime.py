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
from skypilot_tpu_torch.inference import quant
from skypilot_tpu_torch.inference.adapters import AdapterRegistry
from skypilot_tpu_torch.models import convert, registry
from skypilot_tpu_torch.models import generate as gen
from skypilot_tpu_torch.models.batching import ContinuousBatchingEngine


class ServingMetrics:
    """Request-path counters and rolling windows of latencies. TTFT is
    a request's first committed token; inter-token gaps (ITL) come from
    streamed rows, measured at engine commit time."""

    WINDOW = 1024

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.prompt_tokens = 0
        self.generated_tokens = 0
        self._e2e = collections.deque(maxlen=self.WINDOW)
        self._ttft = collections.deque(maxlen=self.WINDOW)
        self._itl_ms = collections.deque(maxlen=self.WINDOW)

    def record(self, e2e_s: float, n_generated: int, n_prompt: int,
               ttft_s: Optional[float]) -> None:
        with self._lock:
            self.requests += 1
            self.prompt_tokens += n_prompt
            self.generated_tokens += n_generated
            self._e2e.append(e2e_s)
            if ttft_s is not None:
                self._ttft.append(ttft_s)

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def record_inter_token(self, gap_s: float) -> None:
        """One gap between consecutive committed tokens of a streamed
        row, taken on the scheduler thread as the engine commits
        (`StreamHandle.on_token`), not at SSE delivery."""
        with self._lock:
            self._itl_ms.append(gap_s * 1000.0)

    @staticmethod
    def _pct_ms(values: List[float], q: float) -> Optional[float]:
        """Linear-interpolated percentile, rounded to 0.01 ms (the
        reference's `ServingMetrics._pct`)."""
        if not values:
            return None
        s = sorted(values)
        pos = q * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        frac = pos - lo
        return round(s[lo] * (1.0 - frac) + s[hi] * frac, 2)

    def snapshot(self) -> Dict[str, object]:
        def pct(xs, q):
            if not xs:
                return None
            xs = sorted(xs)
            return xs[min(len(xs) - 1, int(q * len(xs)))]
        with self._lock:
            itl = list(self._itl_ms)
            return {'requests': self.requests, 'errors': self.errors,
                    'prompt_tokens': self.prompt_tokens,
                    'generated_tokens': self.generated_tokens,
                    'window': len(self._e2e),
                    'e2e_p50_s': pct(self._e2e, 0.5),
                    'e2e_p99_s': pct(self._e2e, 0.99),
                    'ttft_p50_s': pct(self._ttft, 0.5),
                    'ttft_p99_s': pct(self._ttft, 0.99),
                    # Under the reference's names.
                    'itl_ms_n': len(itl),
                    'itl_ms_p50': self._pct_ms(itl, 0.50),
                    'itl_ms_p95': self._pct_ms(itl, 0.95),
                    'itl_ms_p99': self._pct_ms(itl, 0.99)}


class FirstTokenLatch:
    """TTFT of a non-streamed engine request: the engine's `on_token`
    callback, latching the time of the first committed token (any
    row); written only by the scheduler thread."""

    def __init__(self) -> None:
        self.t0 = time.monotonic()
        self.first_token_s: Optional[float] = None

    def __call__(self, _tok: int) -> None:
        if self.first_token_s is None:
            self.first_token_s = time.monotonic() - self.t0


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
                 cuda_graphs: bool = True) -> None:
        if engine is None and model is None:
            raise ValueError('pass the continuous engine or, for the '
                             'one-shot mode, the model')
        self.engine = engine
        self.adapters = adapters
        self.model = engine.model if engine is not None else model
        cfg = self.model.config
        self.model_name = model_name
        self.vocab_size = cfg.vocab_size
        self.kv_dtype = cfg.kv_dtype
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
                    return torch.log_softmax(model(tokens).float(), dim=-1)

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
                      adapter: Optional[str] = None) -> StreamHandle:
        eng = self.stream_engine()
        handle = StreamHandle(metrics=self.metrics)
        handle.future = eng.submit(
            ids, max_new_tokens=max_new, temperature=temperature,
            top_k=top_k, top_p=top_p, stop_token_ids=stop_token_ids,
            on_token=handle.on_token,
            deadline_s=(self.request_timeout if deadline_s is None
                        else deadline_s),
            adapter=adapter)
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
#: that means "not asked for". --fault-plan, --trace-sample /
#: --trace-seed and --slo wait for ROADMAP A6(e) (tracing, SLOs and
#: metrics), the others for A6(c) (KV chains), A8 (int8 weights) and
#: A10 (tensor x pipeline serving).
_UNSUPPORTED_DEFAULTS = (
    ('tensor', 1), ('stages', 1), ('weight_dtype', 'bf16'), ('role', ''),
    ('decode_peers', None), ('kv_spill_bytes', 0), ('kv_cold_dir', None),
    ('fault_plan', None), ('trace_sample', 0.0), ('trace_seed', None),
    ('slo', None),
)

#: The reference's refusal of int8 KV pages in the one-shot mode
#: (skypilot_tpu/inference/runtime.py:798-802), word for word.
INT8_NEEDS_CONTINUOUS = (
    '--kv-dtype int8 requires --continuous-batching: the '
    'one-shot engine decodes through the dense per-slot '
    'cache, which has no scale storage')


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
    compute dtype per use)."""
    param_dtype = torch.float32 if args.param_dtype == 'f32' else None
    tokenizer_dir = None
    if args.hf:
        if model is not None:
            raise ValueError('pass --hf or a model, not both')
        from skypilot_tpu_torch.models import hf_import
        cfg, model = hf_import.load_hf_checkpoint(
            args.hf, max_seq_len=args.max_total_len, device=device,
            param_dtype=param_dtype)
        print(f'loaded HF checkpoint from {args.hf} (Llama, '
              f'vocab={cfg.vocab_size})', flush=True)
        if any(os.path.exists(os.path.join(args.hf, f))
               for f in _TOKENIZER_FILES):
            tokenizer_dir = args.hf
    elif model is None:
        cfg = dataclasses.replace(
            registry.model_config(args.model, args.max_total_len),
            param_dtype=param_dtype)
        model = convert.init_params(cfg, seed=0, device=device)
    else:
        want = registry.model_config(args.model, args.max_total_len)
        widths = dataclasses.replace(model.config, kv_dtype=want.kv_dtype,
                                     kv_total_pages=want.kv_total_pages)
        if widths != want or model.device != device:
            raise ValueError(f'the given model does not match --model '
                             f'{args.model} on {device}')
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


def build_runtime(args, model=None,
                  cuda_graphs: bool = True) -> InferenceRuntime:
    """Construct the runtime from serve_lm CLI args: the weights
    (`_source_model`), the KV pool sized by --kv-dtype /
    --kv-pool-bytes, the adapter registry of --adapter-dir, and the
    continuous engine (--continuous-batching) or the one-shot mode.
    `model`'s weight tensors are shared when given (two runtimes that
    differ only in their KV pool need one copy of the weights).
    `cuda_graphs=False` runs the decode rounds eagerly on the card
    (serve_lm never sets it; the chip_smoke.py and profile_decode.py
    A/Bs do)."""
    bad = unsupported_flags(args)
    if bad:
        raise ValueError('not supported by the PyTorch port yet: '
                         + ', '.join(bad))
    if args.kv_dtype == 'int8' and not args.continuous_batching:
        raise SystemExit(INT8_NEEDS_CONTINUOUS)
    device = resolve_device(cpu=args.cpu)
    model, tokenizer_dir = _source_model(args, model, device)
    cfg = model.config
    pages = (quant.pool_pages_for_bytes(cfg, args.kv_dtype,
                                        args.kv_pool_bytes)
             if args.kv_pool_bytes else cfg.kv_total_pages)
    cfg = dataclasses.replace(cfg, kv_dtype=args.kv_dtype,
                              kv_total_pages=pages)
    # Serving never takes gradients, f32 masters included.
    model = convert.assemble(cfg, model.state_dict()).requires_grad_(False)
    print(f'kv cache: dtype={args.kv_dtype} pages={pages} '
          f'({quant.kv_page_bytes(cfg, args.kv_dtype)} bytes/page across '
          f'layers) on {device}', flush=True)
    # Multi-LoRA adapter registry: scanned at startup, hot-loaded on
    # demand; every engine of the runtime shares its store.
    adapters = None
    if args.adapter_dir:
        adapters = AdapterRegistry(args.adapter_dir, model,
                                   max_adapters=args.max_adapters,
                                   max_rank=args.max_lora_rank)
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
            pipeline_decode=pipeline_decode, cuda_graphs=cuda_graphs)
    return InferenceRuntime(
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
        adapters=adapters, cuda_graphs=cuda_graphs)
