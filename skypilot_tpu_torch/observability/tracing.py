"""Distributed request tracing for the serving plane.

The port's copy of skypilot_tpu/observability/tracing.py, pinned to it by
tests/test_torch_tracing_slo.py.

Dependency-free span layer: every sampled request gets a 16-hex
trace_id that travels LB -> prefill replica -> decode peer over the
`x-skypilot-trace` header, and every interesting stage (route
decision, queue wait, admission, prefill chunks, decode rounds,
device_get stalls, KV handoff export/POST/import, spill/restore)
becomes a complete ('X') Chrome trace event — the exact format
`utils/timeline.py` / `--trace-file` already emits, so a merged
trace loads in chrome://tracing or Perfetto unchanged.

Design constraints, in order:

  1. ZERO overhead when off. `new_ctx()` is one comparison when
     `--trace-sample 0` (the default); `span(name, None)` returns a
     shared no-op singleton — no allocation, no clock reads.
  2. BOUNDED memory. Completed spans land in a per-process LRU of at
     most `MAX_TRACES` traces x `MAX_SPANS_PER_TRACE` spans; an
     unscraped process can run forever.
  3. DETERMINISTIC sampling. The sample decision and the ids both
     come from one seeded `random.Random`, so `--trace-seed` makes a
     run's sampled set (and its ids) reproducible — the property the
     tier-1 determinism test pins.

Wall-clock anchors, monotonic durations: `ts` is `time.time()` (the
only clock comparable across processes — the `stpu trace` merge
sorts on it) while `dur` comes from a `perf_counter` pair, so a span
is never shrunk or stretched by NTP slew.

Header format (`HEADER`): `<trace_id>:<parent_span_id>:<flags>`,
flags bit 0 = sampled. Unsampled requests send no header at all.

Each process tags its spans with a `process` name (`configure`), and
any single span can override it — that is what lets the in-process
stub fleet (LB + N replicas in one interpreter, one shared module)
still produce per-role `pid` rows.

Span discipline: every span must be closed — use `with span(...)`
or put `.end()` in a `finally`. `stpu check` rule SKY007 enforces
this for non-test code.
"""
from __future__ import annotations

import collections
import random
import threading
import time
from typing import Any, Dict, List, Optional

#: The propagation header (lowercase: http.server title-cases on the
#: wire but compares case-insensitively).
HEADER = 'x-skypilot-trace'

#: Bounds on the per-process completed-span store.
MAX_TRACES = 256
MAX_SPANS_PER_TRACE = 512

_lock = threading.Lock()
_sample = 0.0
_rng = random.Random(0)
_process = 'skypilot'
_traces: 'collections.OrderedDict[str, List[dict]]' = \
    collections.OrderedDict()


class Ctx:
    """Propagation context: which trace, and which span is the
    parent of whatever starts next. Immutable by convention."""

    __slots__ = ('trace_id', 'span_id')

    def __init__(self, trace_id: str, span_id: str = '') -> None:
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f'Ctx({self.trace_id}:{self.span_id})'


def configure(sample: Optional[float] = None,
              seed: Optional[int] = None,
              process: Optional[str] = None) -> None:
    """Set the sampling rate / rng seed / process tag. Any argument
    left None keeps its current value (so the LB can set `process`
    without touching the replica-configured rate in tests)."""
    global _sample, _rng, _process
    with _lock:
        if sample is not None:
            _sample = max(0.0, min(1.0, float(sample)))
        if seed is not None:
            _rng = random.Random(seed)
        if process is not None:
            _process = str(process)


def enabled() -> bool:
    return _sample > 0.0


def new_ctx() -> Optional[Ctx]:
    """Head-based sampling decision for a request arriving with no
    trace header. Returns None (do nothing, forward nothing) for
    unsampled requests — the common case is one float compare."""
    if _sample <= 0.0:
        return None
    with _lock:
        if _rng.random() >= _sample:
            return None
        return Ctx('%016x' % _rng.getrandbits(64))


def _new_span_id() -> str:
    with _lock:
        return '%08x' % _rng.getrandbits(32)


def parse_header(value: Optional[str]) -> Optional[Ctx]:
    """`<trace_id>:<parent_span_id>:<flags>` -> Ctx, or None for a
    missing/malformed/unsampled header (all equivalent: no tracing)."""
    if not value:
        return None
    parts = value.strip().split(':')
    if len(parts) != 3:
        return None
    trace_id, span_id, flags = parts
    if not trace_id or not flags.isdigit() or not (int(flags) & 1):
        return None
    return Ctx(trace_id, span_id)


def format_header(ctx: Ctx) -> str:
    return f'{ctx.trace_id}:{ctx.span_id}:1'


class Span:
    """A live span. Started on construction; records one Chrome
    trace event on `end()` (idempotent). `ctx` is the context to
    hand to children / the wire."""

    __slots__ = ('name', 'ctx', '_parent', '_proc', '_args',
                 '_wall', '_t0', '_done')

    def __init__(self, name: str, ctx: Ctx,
                 process: Optional[str] = None,
                 **args: Any) -> None:
        self.name = name
        self._parent = ctx.span_id
        self.ctx = Ctx(ctx.trace_id, _new_span_id())
        self._proc = process
        self._args = dict(args)
        self._wall = time.time()
        self._t0 = time.perf_counter()
        self._done = False

    def add(self, **kv: Any) -> None:
        """Attach extra args to the span before it ends."""
        self._args.update(kv)

    def end(self, **kv: Any) -> None:
        if self._done:
            return
        self._done = True
        dur = time.perf_counter() - self._t0
        if kv:
            self._args.update(kv)
        args = {'trace_id': self.ctx.trace_id,
                'span_id': self.ctx.span_id,
                'parent_id': self._parent}
        args.update(self._args)
        event = {
            'name': self.name,
            'cat': 'skypilot_tpu',
            'ph': 'X',
            'ts': self._wall * 1e6,
            'dur': dur * 1e6,
            'pid': self._proc if self._proc is not None else _process,
            'tid': threading.get_ident() % 100000,
            'args': args,
        }
        with _lock:
            spans = _traces.get(self.ctx.trace_id)
            if spans is None:
                while len(_traces) >= MAX_TRACES:
                    _traces.popitem(last=False)
                spans = _traces[self.ctx.trace_id] = []
            if len(spans) < MAX_SPANS_PER_TRACE:
                spans.append(event)

    def __enter__(self) -> 'Span':
        return self

    def __exit__(self, *exc: Any) -> None:
        if exc and exc[0] is not None:
            self._args.setdefault('error', str(exc[0].__name__))
        self.end()


class _NoopSpan:
    """Shared do-nothing span for unsampled requests. `ctx` is None
    so children short-circuit the same way."""

    __slots__ = ()
    ctx: Optional[Ctx] = None
    name = ''

    def add(self, **kv: Any) -> None:
        pass

    def end(self, **kv: Any) -> None:
        pass

    def __enter__(self) -> '_NoopSpan':
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


NOOP = _NoopSpan()


def span(name: str, ctx: Optional[Ctx],
         process: Optional[str] = None, **args: Any):
    """Open a span under `ctx`. With `ctx=None` (unsampled) this is
    free: the shared no-op singleton comes back. Close it — context
    manager or `finally` — or SKY007 will flag the call site."""
    if ctx is None:
        return NOOP
    return Span(name, ctx, process=process, **args)


def start_span(name: str, ctx: Optional[Ctx],
               process: Optional[str] = None, **args: Any):
    """Manual-lifetime variant of `span` for spans that cross
    function boundaries (queue wait, decode-round occupancy). The
    caller owns `.end()` — put it in a `finally` (SKY007)."""
    if ctx is None:
        return NOOP
    return Span(name, ctx, process=process, **args)


def record_span(name: str, ctx: Optional[Ctx], dur_s: float,
                start: Optional[float] = None,
                process: Optional[str] = None, **args: Any) -> None:
    """Record an interval the caller already measured (a perf_counter
    pair around existing code) as one completed span. This is how the
    engine scheduler traces without restructuring its hot loop: no
    open span object lives across scheduler iterations, so there is
    nothing for SKY007 to leak. `start` is the wall-clock begin
    (time.time()); default anchors the span so it ENDS now."""
    if ctx is None:
        return
    sp = Span(name, ctx, process=process, **args)
    sp._wall = start if start is not None else time.time() - dur_s
    sp._t0 = time.perf_counter() - dur_s
    sp.end()


def get_trace(trace_id: str) -> Optional[Dict[str, Any]]:
    """Completed spans of one trace as a Chrome-trace JSON body, or
    None if this process recorded nothing for it."""
    with _lock:
        spans = _traces.get(trace_id)
        if spans is None:
            return None
        return {'traceEvents': list(spans)}


def trace_ids() -> List[str]:
    """Known trace ids, oldest first (bounded by MAX_TRACES)."""
    with _lock:
        return list(_traces)


def reset() -> None:
    """Test hook: drop all stored traces and disable sampling."""
    global _sample, _rng, _process
    with _lock:
        _traces.clear()
        _sample = 0.0
        _rng = random.Random(0)
        _process = 'skypilot'


def merge_traces(bodies: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stitch per-process `get_trace` bodies into one timeline:
    de-duplicate on span_id (an in-process fleet shares one store, so
    every node returns every span), then sort by wall-clock `ts`.
    Used by `stpu trace` and by anything replaying saved dumps."""
    seen = set()
    merged: List[dict] = []
    for body in bodies:
        for ev in (body or {}).get('traceEvents', []):
            key = (ev.get('args', {}).get('span_id'),
                   ev.get('name'), ev.get('ts'))
            if key in seen:
                continue
            seen.add(key)
            merged.append(ev)
    merged.sort(key=lambda e: e.get('ts', 0))
    return {'traceEvents': merged}
