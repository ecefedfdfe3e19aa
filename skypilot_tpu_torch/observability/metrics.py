"""Dependency-free metrics registry + Prometheus text exposition.

The port's copy of skypilot_tpu/observability/metrics.py, pinned to it by
tests/test_torch_observability.py (its REGISTRY is this process's
port registry, apart from the reference's).

The single metrics layer shared by the API server, the inference
server, and the trainer (vLLM's /metrics idea without the
prometheus_client dependency — the container images stay stdlib-only).
Three primitive families, all thread-safe:

  Counter    monotonically increasing (`inc`)
  Gauge      set/inc/dec; can also expose under TYPE counter for
             values that are semantically running totals but are
             recomputed from a source of truth at scrape time (the
             API server's DB-derived request counts)
  Histogram  fixed buckets chosen at declaration; cumulative
             `_bucket{le=...}` + `_sum` + `_count` exposition

Metrics are process-global: a family is registered once (by name) in
the default REGISTRY and fans out into labeled children via
`.labels(**kv)`. Rendering (`REGISTRY.render()`) emits Prometheus
text exposition format 0.0.4 — parseable by any Prometheus scraper —
with label values escaped per the spec.

Declare families through `observability/catalog.py` (the single
source of metric names; the docs table and the CI name-checker key
off it) rather than instantiating these classes directly.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r'^[a-z_][a-z0-9_]*$')

# The histogram default: request-latency shaped, seconds.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0, 10.0)


def _format_value(v: float) -> str:
    """Prometheus sample value: integers render bare (the slow-tier
    tests substring-match `skypilot_clusters{status="up"} 1`)."""
    if v == math.inf:
        return '+Inf'
    if v == -math.inf:
        return '-Inf'
    if v != v:  # NaN
        return 'NaN'
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


def escape_label_value(value: str) -> str:
    return (str(value).replace('\\', '\\\\').replace('\n', '\\n')
            .replace('"', '\\"'))


def _escape_help(text: str) -> str:
    return text.replace('\\', '\\\\').replace('\n', '\\n')


class _Child:
    """One labeled series of a family. Holds a float value (Counter/
    Gauge) behind the family lock."""

    __slots__ = ('_family', '_value')

    def __init__(self, family: '_Metric') -> None:
        self._family = family
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._family._lock:
            return self._value


class _CounterChild(_Child):

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f'counters only go up (inc {amount})')
        with self._family._lock:
            self._value += amount


class _GaugeChild(_Child):

    def set(self, value: float) -> None:
        with self._family._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._family._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._family._lock:
            self._value -= amount


class _HistogramChild:

    __slots__ = ('_family', '_counts', '_sum', '_count')

    def __init__(self, family: 'Histogram') -> None:
        self._family = family
        self._counts = [0] * (len(family.buckets) + 1)  # + +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        family = self._family
        with family._lock:
            self._sum += value
            self._count += 1
            # Linear scan: bucket lists are ~a dozen entries and the
            # observe sites are host-side (ms-scale device steps).
            for i, bound in enumerate(family.buckets):
                if value <= bound:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        with self._family._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._family._lock:
            return self._sum


class _Metric:
    """A metric family: name + help + label names, fanning out into
    labeled children. The no-label family is its own single child."""

    typ = 'untyped'
    _child_cls = _Child

    def __init__(self, name: str, help: str,  # pylint: disable=redefined-builtin
                 labelnames: Sequence[str] = (),
                 expose_type: Optional[str] = None) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f'invalid metric name {name!r}')
        for ln in labelnames:
            if not _NAME_RE.match(ln):
                raise ValueError(f'invalid label name {ln!r}')
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.expose_type = expose_type or self.typ
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._child_cls(self)

    def labels(self, **labelvalues: str):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f'{self.name} takes labels {self.labelnames}, got '
                f'{tuple(labelvalues)}')
        key = tuple(str(labelvalues[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._child_cls(self)
                self._children[key] = child
            return child

    def clear(self) -> None:
        """Drop every labeled child (scrape-time rebuilt gauges: a
        status that disappeared must not linger at its last value)."""
        with self._lock:
            self._children.clear()
            if not self.labelnames:
                self._children[()] = self._child_cls(self)

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f'{self.name} is labeled {self.labelnames}; use '
                f'.labels(...)')
        return self._children[()]

    # -- exposition ---------------------------------------------------------
    def _label_str(self, key: Tuple[str, ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
        pairs = [(ln, lv) for ln, lv in zip(self.labelnames, key)]
        pairs.extend(extra)
        if not pairs:
            return ''
        inner = ','.join(f'{ln}="{escape_label_value(lv)}"'
                         for ln, lv in pairs)
        return '{' + inner + '}'

    def collect(self) -> List[str]:
        lines = [f'# HELP {self.name} {_escape_help(self.help)}',
                 f'# TYPE {self.name} {self.expose_type}']
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            lines.append(f'{self.name}{self._label_str(key)} '
                         f'{_format_value(child._value)}')
        return lines


class Counter(_Metric):
    typ = 'counter'
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Metric):
    typ = 'gauge'
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Metric):
    typ = 'histogram'
    _child_cls = _HistogramChild

    def __init__(self, name: str, help: str,  # pylint: disable=redefined-builtin
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError('histogram needs at least one bucket')
        self.buckets = buckets
        super().__init__(name, help, labelnames)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    @property
    def count(self) -> int:
        return self._default().count

    @property
    def sum(self) -> float:
        return self._default().sum

    def collect(self) -> List[str]:
        lines = [f'# HELP {self.name} {_escape_help(self.help)}',
                 f'# TYPE {self.name} histogram']
        with self._lock:
            items = sorted(self._children.items())
        for key, child in items:
            with self._lock:
                counts = list(child._counts)
                total = child._count
                vsum = child._sum
            cum = 0
            for bound, n in zip(self.buckets, counts):
                cum += n
                lab = self._label_str(key,
                                      (('le', _format_value(bound)),))
                lines.append(f'{self.name}_bucket{lab} {cum}')
            lab = self._label_str(key, (('le', '+Inf'),))
            lines.append(f'{self.name}_bucket{lab} {total}')
            lines.append(f'{self.name}_sum{self._label_str(key)} '
                         f'{_format_value(vsum)}')
            lines.append(f'{self.name}_count{self._label_str(key)} '
                         f'{total}')
        return lines


class Registry:
    """Name-keyed family registry. `get_or_create` is the idempotent
    declaration point (tests and reloads re-declare freely; a
    conflicting redeclaration — different type/labels — is a bug and
    raises)."""

    CONTENT_TYPE = 'text/plain; version=0.0.4; charset=utf-8'

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: 'Dict[str, _Metric]' = {}

    def get_or_create(self, cls, name: str, help: str,  # pylint: disable=redefined-builtin
                      labelnames: Sequence[str] = (), **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls or
                        existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f'metric {name!r} already registered as '
                        f'{type(existing).__name__}'
                        f'{existing.labelnames}')
                return existing
            metric = cls(name, help, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def render(self, names: Optional[Iterable[str]] = None) -> str:
        """Prometheus text exposition of every (or the named)
        registered family, name-sorted for stable scrapes."""
        with self._lock:
            if names is None:
                metrics = [self._metrics[n] for n in
                           sorted(self._metrics)]
            else:
                metrics = [self._metrics[n] for n in names
                           if n in self._metrics]
        lines: List[str] = []
        for metric in metrics:
            lines.extend(metric.collect())
        return '\n'.join(lines) + '\n'


REGISTRY = Registry()
