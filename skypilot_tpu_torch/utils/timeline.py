"""Chrome trace-event tracing (port of skypilot_tpu/utils/timeline.py).

A JSON trace is written when SKYPILOT_TIMELINE_FILE_PATH is set at
import, or after `enable(path)` (`train_lm --trace-file`); `Event`
spans and `@timeline.event` mark hot code. Load the output in
chrome://tracing or Perfetto.
"""
from __future__ import annotations

import atexit
import functools
import json
import os
import sys
import threading
import time
from typing import Any, Callable, List, Optional, Union

_events: List[dict] = []
_lock = threading.Lock()
_enabled_path: Optional[str] = None
_saved = False  # a save() happened and no event has landed since


def _init() -> None:
    global _enabled_path
    _enabled_path = os.environ.get('SKYPILOT_TIMELINE_FILE_PATH')
    if _enabled_path:
        atexit.register(save)


def enabled() -> bool:
    return _enabled_path is not None


def enable(path: str) -> None:
    """Programmatic enable (e.g. `train_lm --trace-file`): events
    collect from now on and flush to `path` at exit (or on save())."""
    global _enabled_path
    already = _enabled_path is not None
    _enabled_path = path
    if not already:
        atexit.register(save)


class Event:
    """Context manager emitting a complete ('X') trace event."""

    def __init__(self, name: str, message: Optional[str] = None) -> None:
        self._name = name
        self._message = message
        self._start = 0.0

    def __enter__(self) -> 'Event':
        self._start = time.perf_counter()
        return self

    def __exit__(self, *args) -> None:
        global _saved
        if _enabled_path is None:
            return
        end = time.perf_counter()
        with _lock:
            if _saved:
                # The buffer was flushed by an explicit save(): keep
                # collecting into a fresh trace (the next save()
                # rewrites the file), and say so once.
                _saved = False
                print(f'timeline: events recorded after save(); '
                      f'starting a fresh trace buffer for '
                      f'{_enabled_path} (the next save() overwrites it).',
                      file=sys.stderr, flush=True)
            _events.append({
                'name': self._name,
                'cat': 'skypilot_tpu',
                'ph': 'X',
                'ts': self._start * 1e6,
                'dur': (end - self._start) * 1e6,
                'pid': os.getpid(),
                'tid': threading.get_ident() % 100000,
                'args': {'message': self._message} if self._message else {},
            })


def event(fn_or_name: Union[Callable, str]) -> Callable:
    """Decorator form: @timeline.event or @timeline.event('name')."""

    def decorate(fn: Callable, name: str) -> Callable:

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if _enabled_path is None:
                return fn(*args, **kwargs)
            with Event(name):
                return fn(*args, **kwargs)

        return wrapper

    if callable(fn_or_name):
        return decorate(fn_or_name, getattr(fn_or_name, '__qualname__',
                                            fn_or_name.__name__))
    return lambda fn: decorate(fn, fn_or_name)


def save() -> None:
    """Flush collected events to the trace file and clear the buffer,
    so a second enable()/save() cycle writes a fresh trace."""
    global _saved
    if _enabled_path is None or not _events:
        return
    path = os.path.expanduser(_enabled_path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _lock:
        payload = {'traceEvents': list(_events)}
        _events.clear()
        _saved = True
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(payload, f)


_init()
