"""Serving runtime: the model, its continuous-batching engine and the
request-path numbers the HTTP front reports (port of
skypilot_tpu/inference/runtime.py `InferenceRuntime` / `build_runtime`,
restricted to the flags this port supports).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, List, Optional

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.errors import AdapterNotFoundError
from skypilot_tpu_torch.inference import quant
from skypilot_tpu_torch.inference.adapters import AdapterRegistry
from skypilot_tpu_torch.models import convert, registry
from skypilot_tpu_torch.models.batching import ContinuousBatchingEngine


class ServingMetrics:
    """Request-path counters and a rolling window of latencies."""

    WINDOW = 1024

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.prompt_tokens = 0
        self.generated_tokens = 0
        self._e2e = collections.deque(maxlen=self.WINDOW)
        self._ttft = collections.deque(maxlen=self.WINDOW)

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

    def snapshot(self) -> Dict[str, object]:
        def pct(xs, q):
            if not xs:
                return None
            xs = sorted(xs)
            return xs[min(len(xs) - 1, int(q * len(xs)))]
        with self._lock:
            return {'requests': self.requests, 'errors': self.errors,
                    'prompt_tokens': self.prompt_tokens,
                    'generated_tokens': self.generated_tokens,
                    'window': len(self._e2e),
                    'e2e_p50_s': pct(self._e2e, 0.5),
                    'e2e_p99_s': pct(self._e2e, 0.99),
                    'ttft_p50_s': pct(self._ttft, 0.5),
                    'ttft_p99_s': pct(self._ttft, 0.99)}


class InferenceRuntime:
    """Everything needed to execute generation requests: the model (on
    its device), the continuous-batching engine, the adapter registry
    (None without --adapter-dir), and request metrics."""

    def __init__(self, *, engine: ContinuousBatchingEngine,
                 model_name: str, request_timeout: float = 600.0,
                 zone: str = '',
                 adapters: Optional[AdapterRegistry] = None) -> None:
        self.engine = engine
        self.adapters = adapters
        self.model = engine.model
        self.model_name = model_name
        self.vocab_size = engine.model.config.vocab_size
        self.kv_dtype = engine.kv_dtype
        self.request_timeout = float(request_timeout)
        self.zone = zone
        self.metrics = ServingMetrics()

    def limit_for(self) -> int:
        """Max total length (prompt + generated) a request runs at."""
        return self.engine.max_total_len

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

    def live_engines(self) -> List[ContinuousBatchingEngine]:
        return [self.engine]

    def stop(self) -> None:
        self.engine.stop()


#: serve_lm flags this port does not implement yet, with the value
#: that means "not asked for".
_UNSUPPORTED_DEFAULTS = (
    ('hf', None), ('ckpt_dir', None), ('tensor', 1), ('stages', 1),
    ('weight_dtype', 'bf16'),
    ('param_dtype', 'bf16'), ('role', ''), ('decode_peers', None),
    ('kv_spill_bytes', 0), ('kv_cold_dir', None), ('fault_plan', None),
    ('trace_sample', 0.0), ('trace_seed', None), ('slo', None),
)


def unsupported_flags(args) -> List[str]:
    """The `serve_lm` flags in `args` that this port cannot honor (as
    `--flag` names); empty when everything asked for is supported."""
    bad = [f'--{name.replace("_", "-")}'
           for name, default in _UNSUPPORTED_DEFAULTS
           if getattr(args, name, default) != default]
    if not getattr(args, 'continuous_batching', False):
        bad.insert(0, '--continuous-batching (required: the one-shot '
                      'engine is not ported)')
    return bad


def engine_total_len(args, max_seq_len: int) -> int:
    """The max total length the engine runs at (what `limit_for`
    advertises): --max-total-len, clamped at startup so a verify chunk
    (--speculative K) or a decode chunk (--decode-chunk N) has its
    headroom below the model's max_seq_len, with the reference's
    messages (skypilot_tpu/inference/runtime.py:836-856, :1005-1024)."""
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
    if args.decode_chunk > 1:
        clamped = min(total, max_seq_len - args.decode_chunk)
        if clamped < total:
            print(f'decode chunking: clamping max_total_len {total} -> '
                  f'{clamped} (chunk writes need N={args.decode_chunk} '
                  f'tokens of headroom below max_seq_len={max_seq_len})',
                  flush=True)
        total = clamped
    return total


def build_runtime(args, model=None,
                  cuda_graphs: bool = True) -> InferenceRuntime:
    """Construct the runtime from serve_lm CLI args: the registry
    config, the KV pool sized by --kv-dtype / --kv-pool-bytes, seeded
    weights initialized on the device (or `model`'s weight tensors,
    shared, when given: two runtimes that differ only in their KV pool
    need one copy of the weights), the adapter registry of
    --adapter-dir, and the continuous engine. `cuda_graphs=False` runs
    the decode rounds eagerly on the card (serve_lm never sets it; the
    chip_smoke.py and profile_decode.py A/Bs do)."""
    bad = unsupported_flags(args)
    if bad:
        raise ValueError('not supported by the PyTorch port yet: '
                         + ', '.join(bad))
    device = resolve_device(cpu=args.cpu)
    cfg = registry.model_config(args.model, args.max_total_len)
    pages = (quant.pool_pages_for_bytes(cfg, args.kv_dtype,
                                        args.kv_pool_bytes)
             if args.kv_pool_bytes else cfg.kv_total_pages)
    cfg = dataclasses.replace(cfg, kv_dtype=args.kv_dtype,
                              kv_total_pages=pages)
    if model is None:
        model = convert.init_params(cfg, seed=0, device=device)
    else:
        widths = dataclasses.replace(model.config, kv_dtype=cfg.kv_dtype,
                                     kv_total_pages=cfg.kv_total_pages)
        if widths != cfg or model.device != device:
            raise ValueError(f'the given model does not match --model '
                             f'{args.model} on {device}')
        model = convert.assemble(cfg, model.state_dict())
    print(f'kv cache: dtype={args.kv_dtype} pages={pages} '
          f'({quant.kv_page_bytes(cfg, args.kv_dtype)} bytes/page across '
          f'layers) on {device}', flush=True)
    # Multi-LoRA adapter registry: scanned at startup, hot-loaded on
    # demand.
    adapters = None
    if args.adapter_dir:
        adapters = AdapterRegistry(args.adapter_dir, model,
                                   max_adapters=args.max_adapters,
                                   max_rank=args.max_lora_rank)
        inv = adapters.inventory()
        print(f'adapter registry: {len(inv)} adapters in '
              f'{args.adapter_dir} (max {adapters.max_adapters} '
              f'device-resident): {inv}', flush=True)
    engine = ContinuousBatchingEngine(
        model, num_slots=args.num_slots,
        max_total_len=engine_total_len(args, cfg.max_seq_len),
        prefix_caching=not args.no_prefix_caching,
        prefill_chunk=args.prefill_chunk,
        prefill_budget=args.prefill_budget,
        max_queue_requests=args.max_queue_requests,
        max_queue_tokens=args.max_queue_tokens, adapter_store=adapters,
        speculative_k=args.speculative, decode_chunk=args.decode_chunk,
        pipeline_decode=False if args.no_pipeline_decode else None,
        cuda_graphs=cuda_graphs)
    return InferenceRuntime(engine=engine, model_name=args.model,
                            request_timeout=args.request_timeout,
                            zone=args.zone, adapters=adapters)
