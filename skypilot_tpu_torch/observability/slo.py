"""Declarative serving SLOs with multi-window burn-rate accounting.

The port's copy of skypilot_tpu/observability/slo.py, pinned to it by
tests/test_torch_tracing_slo.py.

An SLO spec is a comma list of `dimension=target` pairs:

    --slo p99_ttft_ms=500,p99_itl_ms=100,error_rate=0.01,shed_rate=0.05

Dimensions (all optional — declare only what you promise):

  p99_ttft_ms   99% of requests see their first token within N ms
  p99_itl_ms    99% of inter-token gaps within N ms
  error_rate    fraction of requests answered with an error
  shed_rate     fraction of offered requests shed (429) at admission

Burn-rate model (the standard SRE multi-window construction): each
dimension defines a "bad" predicate over its own sample stream —
requests for error/shed/ttft, inter-token GAPS for itl (one request
contributes as many itl samples as it streams gaps) — and an error
BUDGET, the fraction of samples allowed to be bad: the rate itself
for the rate dimensions, 1% for the p99 latency dimensions. Over a
window

    burn_rate = (bad / total) / budget

burn 1.0 = consuming budget exactly as fast as the SLO allows;
burn 10 on the fast window = page someone. `SloTracker` keeps
fixed-size time buckets (no per-request retention) and reports
burn over a fast and a slow window plus `budget_remaining`
(1 - slow burn, clamped to [0, 1]).

Clock discipline: buckets are keyed by ABSOLUTE bucket index from an
injectable monotonic clock. A stale bucket is reset on first write
after wraparound, and a clock that restarts at zero (process
restart; the "counter reset" case) simply makes old buckets
unreachable — window sums only accept indices inside
(now - window, now], so the math never goes negative.

The same target spec drives three consumers: the live tracker
(`/stats` + `/fleet/status` slo sections, `skypilot_serving_slo_*`
gauges), the LB fleet view, and `serve_bench --slo` pass/fail
scoring via `evaluate()`.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

DIMENSIONS = ('p99_ttft_ms', 'p99_itl_ms', 'error_rate', 'shed_rate')

#: Budget fraction per dimension: how many requests may be "bad"
#: while still meeting the SLO. p99 targets tolerate 1% by
#: definition; rate targets tolerate their own value.
_P99_BUDGET = 0.01

#: Default (fast, slow) burn-rate windows, seconds.
DEFAULT_WINDOWS = (60.0, 600.0)


def parse_slo(spec: str) -> Dict[str, float]:
    """Parse `dim=target,...`; raises ValueError on unknown
    dimensions, malformed pairs, or out-of-range targets."""
    targets: Dict[str, float] = {}
    for part in spec.split(','):
        part = part.strip()
        if not part:
            continue
        if '=' not in part:
            raise ValueError(
                f'bad SLO term {part!r}: expected dimension=target')
        key, _, raw = part.partition('=')
        key = key.strip()
        if key not in DIMENSIONS:
            raise ValueError(
                f'unknown SLO dimension {key!r} (choose from '
                f'{", ".join(DIMENSIONS)})')
        try:
            value = float(raw)
        except ValueError:
            raise ValueError(
                f'bad SLO target {raw!r} for {key}') from None
        if value <= 0:
            raise ValueError(f'SLO target for {key} must be > 0')
        if key.endswith('_rate') and value >= 1:
            raise ValueError(
                f'SLO target for {key} is a fraction; got {value}')
        targets[key] = value
    if not targets:
        raise ValueError(f'empty SLO spec {spec!r}')
    return targets


def budget_fraction(dimension: str, target: float) -> float:
    """Fraction of requests allowed to be bad for a dimension."""
    if dimension.endswith('_rate'):
        return target
    return _P99_BUDGET


class _Bucket:
    __slots__ = ('idx', 'total', 'offered', 'itl', 'bad')

    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.total = 0    # completed requests
        self.offered = 0  # completed + shed
        self.itl = 0      # inter-token gap samples
        self.bad: Dict[str, int] = {}


class SloTracker:
    """Windowed good/bad accounting against a target spec.

    `record_request` is called once per finished (or shed) request
    from the HTTP/LB layer; `snapshot` renders the slo section and
    refreshes the `skypilot_serving_slo_*` gauges. Thread-safe."""

    def __init__(self, targets: Dict[str, float],
                 windows: tuple = DEFAULT_WINDOWS,
                 bucket_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 publish: bool = True) -> None:
        for dim in targets:
            if dim not in DIMENSIONS:
                raise ValueError(f'unknown SLO dimension {dim!r}')
        self.targets = dict(targets)
        self.windows = tuple(sorted(float(w) for w in windows))
        self.bucket_s = float(bucket_s)
        if self.bucket_s <= 0:
            raise ValueError('bucket_s must be > 0')
        self._clock = clock
        self._lock = threading.Lock()
        n = int(self.windows[-1] / self.bucket_s) + 1
        self._buckets: List[Optional[_Bucket]] = [None] * n
        self._bad_totals = {dim: 0 for dim in self.targets}
        self._metrics = None
        if publish:
            self._metrics = _slo_metrics()
            for dim, target in self.targets.items():
                self._metrics['target'].labels(dimension=dim).set(
                    target)

    # -- recording ---------------------------------------------------
    def record_request(self, error: bool = False, shed: bool = False,
                       ttft_ms: Optional[float] = None,
                       now: Optional[float] = None) -> None:
        if now is None:
            now = self._clock()
        bad = []
        if 'shed_rate' in self.targets and shed:
            bad.append('shed_rate')
        if not shed:
            if 'error_rate' in self.targets and error:
                bad.append('error_rate')
            if ('p99_ttft_ms' in self.targets and ttft_ms is not None
                    and ttft_ms > self.targets['p99_ttft_ms']):
                bad.append('p99_ttft_ms')
        with self._lock:
            idx = int(now // self.bucket_s)
            slot = idx % len(self._buckets)
            b = self._buckets[slot]
            if b is None or b.idx != idx:
                b = _Bucket(idx)
                self._buckets[slot] = b
            b.offered += 1
            if not shed:
                b.total += 1
            for dim in bad:
                b.bad[dim] = b.bad.get(dim, 0) + 1
                self._bad_totals[dim] += 1
        if self._metrics is not None:
            for dim in bad:
                self._metrics['bad'].labels(dimension=dim).inc()

    def record_itl(self, gap_ms: float,
                   now: Optional[float] = None) -> None:
        """One inter-token gap sample (streamed requests, measured at
        engine commit). The itl dimension burns against GAP count,
        not request count — a 1000-token stream gets 999 chances to
        blow its p99, exactly like the percentile it models."""
        if 'p99_itl_ms' not in self.targets:
            return
        if now is None:
            now = self._clock()
        bad = gap_ms > self.targets['p99_itl_ms']
        with self._lock:
            idx = int(now // self.bucket_s)
            slot = idx % len(self._buckets)
            b = self._buckets[slot]
            if b is None or b.idx != idx:
                b = _Bucket(idx)
                self._buckets[slot] = b
            b.itl += 1
            if bad:
                b.bad['p99_itl_ms'] = b.bad.get('p99_itl_ms', 0) + 1
                self._bad_totals['p99_itl_ms'] += 1
        if bad and self._metrics is not None:
            self._metrics['bad'].labels(dimension='p99_itl_ms').inc()

    # -- window math -------------------------------------------------
    def _window_counts(self, window: float, now: float
                       ) -> Dict[str, Any]:
        hi = int(now // self.bucket_s)
        lo = hi - int(window / self.bucket_s)
        total = offered = itl = 0
        bad = {dim: 0 for dim in self.targets}
        for b in self._buckets:
            if b is None or not lo < b.idx <= hi:
                continue
            total += b.total
            offered += b.offered
            itl += b.itl
            for dim, n in b.bad.items():
                bad[dim] = bad.get(dim, 0) + n
        return {'total': total, 'offered': offered, 'itl': itl,
                'bad': bad}

    def burn_rate(self, dimension: str, window: float,
                  now: Optional[float] = None) -> float:
        if now is None:
            now = self._clock()
        with self._lock:
            counts = self._window_counts(window, now)
        return self._burn(dimension, counts)

    def _burn(self, dimension: str, counts: Dict[str, Any]) -> float:
        if dimension == 'shed_rate':
            denom = counts['offered']
        elif dimension == 'p99_itl_ms':
            denom = counts['itl']
        else:
            denom = counts['total']
        if denom <= 0:
            return 0.0
        frac = counts['bad'].get(dimension, 0) / denom
        return frac / budget_fraction(dimension,
                                      self.targets[dimension])

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The `slo` section for /stats and /fleet/status. Also
        refreshes the slo gauges (scrape piggybacks on render)."""
        if now is None:
            now = self._clock()
        with self._lock:
            per_window = {w: self._window_counts(w, now)
                          for w in self.windows}
            bad_totals = dict(self._bad_totals)
        windows_out: Dict[str, Any] = {}
        slow = self.windows[-1]
        ok = True
        budget_remaining: Dict[str, float] = {}
        for w, counts in per_window.items():
            label = f'{int(w)}s'
            dims = {}
            for dim in sorted(self.targets):
                burn = round(self._burn(dim, counts), 4)
                dims[dim] = {
                    'bad': counts['bad'].get(dim, 0),
                    'burn_rate': burn,
                }
                if self._metrics is not None:
                    self._metrics['burn'].labels(
                        dimension=dim, window=label).set(burn)
                if w == slow:
                    remaining = round(max(0.0, 1.0 - burn), 4)
                    budget_remaining[dim] = remaining
                    if self._metrics is not None:
                        self._metrics['remaining'].labels(
                            dimension=dim).set(remaining)
                    if burn > 1.0:
                        ok = False
            windows_out[label] = {
                'requests': counts['total'],
                'offered': counts['offered'],
                'itl_samples': counts['itl'],
                'dimensions': dims,
            }
        return {
            'targets': dict(self.targets),
            'windows': windows_out,
            'budget_remaining': budget_remaining,
            'bad_total': bad_totals,
            'ok': ok,
        }


def _slo_metrics() -> Dict[str, Any]:
    """The `skypilot_serving_slo_*` catalog rows, created lazily so
    importing this module never touches the registry."""
    from skypilot_tpu_torch.observability import catalog
    return {
        'target': catalog.gauge('skypilot_serving_slo_target'),
        'burn': catalog.gauge('skypilot_serving_slo_burn_rate'),
        'remaining': catalog.gauge(
            'skypilot_serving_slo_budget_remaining'),
        'bad': catalog.counter('skypilot_serving_slo_bad_total'),
    }


def evaluate(targets: Dict[str, float],
             observed: Dict[str, Optional[float]]) -> Dict[str, Any]:
    """Score one bench run against a target spec. `observed` maps
    dimension -> measured value (missing/None = not measured, which
    fails the dimension: an unmeasured promise is a broken one).
    Returns a machine-checkable block: per-dimension pass/fail plus
    overall `ok` and worst-case `budget_consumed` (observed/target,
    so 1.0 = budget exactly spent)."""
    results = []
    ok = True
    worst = 0.0
    for dim, target in sorted(targets.items()):
        obs = observed.get(dim)
        if obs is None:
            results.append({'dimension': dim, 'target': target,
                            'observed': None, 'ok': False,
                            'budget_consumed': None})
            ok = False
            continue
        consumed = round(float(obs) / target, 4)
        passed = float(obs) <= target
        results.append({'dimension': dim, 'target': target,
                        'observed': round(float(obs), 4),
                        'ok': passed,
                        'budget_consumed': consumed})
        worst = max(worst, consumed)
        ok = ok and passed
    return {'ok': ok, 'budget_consumed': round(worst, 4),
            'results': results}
